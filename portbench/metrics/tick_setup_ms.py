"""``tick_setup_ms``: host milliseconds a window call on the card spends
from building its captured loops' state to their first replay's launch
(state, warm-up ticks, capture: the ``tick.setup`` spans of captured
loops), the mean a call."""

from portbench import ticktrace


def read(run):
    return ticktrace.ms_a_call(run, "tick.setup", ticktrace.card_calls(run),
                               graph=True)
