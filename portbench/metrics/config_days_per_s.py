"""``config_days_per_s``: configurations simulated a second, each
weighted by its simulated days, over all the window's calls and all its
time (packing and billing included)."""


def read(run):
    if not run.calls or not run.window_s:
        return None
    days = run.cfg["days"]
    return sum(len(c["specs"]) for c in run.calls) * days / run.window_s
