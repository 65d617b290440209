"""``replay_gap_us``: device microseconds from a replayed tick's end stamp
to the next tick's start stamp, the mean over every window call's traced
loop."""

from portbench import ticktrace


def read(run):
    return ticktrace.replay_gap_us(run)
