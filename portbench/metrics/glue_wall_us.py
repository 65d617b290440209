"""``glue_wall_us``: device microseconds a replayed tick spends in its
tick-glue segments (begin, complete and link admission, migrate, the wait
selection), stamp to stamp, over every window call's traced loop."""

from portbench import ticktrace


def read(run):
    return ticktrace.segments_us(run, ticktrace.GLUE)
