"""``billing_ms``: host milliseconds a window call on the card spends
billing its results (the ``billing`` span), the mean a call."""

from portbench import ticktrace


def read(run):
    return ticktrace.ms_a_call(run, "billing", ticktrace.card_calls(run))
