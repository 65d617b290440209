"""``lane_tick_roofline_pct``: the bytes the transfer, GCS-admission and
window phases need (``rooflines.phase_bytes``) at the card's memory rate,
over the device time of the kernels of the port's ``lane_tick`` library
in the same ticks, summed over the sampled ticks of the profiled call;
bound by bytes. Silent when no such kernel ran."""

from portbench import rooflines


def read(run):
    return rooflines.library_share(run, "lane_tick",
                                   rooflines.LANE_TICK_PHASES)
