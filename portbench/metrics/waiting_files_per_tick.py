"""``waiting_files_per_tick``: files in the disk window's queue at the
end of a counted tick, a lane, over every window call's traced loop. A
fact of the traffic."""

from portbench import ticktrace


def read(run):
    return ticktrace.per_lane_tick(run, "waiting_files")
