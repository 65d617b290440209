"""``gcs_candidates_per_tick``: files a lane offers the GCS admission on
a counted tick (the tick's migration candidates), over every window
call's traced loop. A fact of the traffic: a correct change leaves it as
it was."""

from portbench import ticktrace


def read(run):
    return ticktrace.per_lane_tick(run, "gcs_candidates")
