"""``glue_roofline_pct``: the bytes the five glue phases need
(``rooflines.phase_bytes``: begin, complete, link_admit, migrate,
wait_select) at the card's memory rate, over the device time of the
kernels of the port's ``tick_glue`` library in the same ticks, summed over
the sampled ticks of the profiled call; bound by bytes. Silent when no
such kernel ran."""

from portbench import rooflines


def read(run):
    return rooflines.library_share(run, "tick_glue", rooflines.GLUE_PHASES)
