"""``active_transfers_per_tick``: transfers holding a link slot at the
end of a counted tick, a lane, over every window call's traced loop. A
fact of the traffic."""

from portbench import ticktrace


def read(run):
    return ticktrace.per_lane_tick(run, "active_transfers")
