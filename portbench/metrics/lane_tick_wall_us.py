"""``lane_tick_wall_us``: device microseconds a replayed tick spends from
the stamp before each lane-tick kernel to the stamp after it (transfer,
GCS admission, windows), over every window call's traced loop."""

from portbench import ticktrace


def read(run):
    return ticktrace.segments_us(run, ticktrace.LANE_TICK)
