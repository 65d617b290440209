"""``idle_pct``: the device's idle share of the profiled call's whole
time, its packing, capture, replays and billing included, in %."""

from portbench import devtrace


def read(run):
    red = run.record.get("devtrace")
    if not red:
        return None
    lo, hi = red["window"]
    return 100.0 * (1.0 - devtrace.busy_ns(red["kernels"], lo, hi)
                    / (hi - lo))
