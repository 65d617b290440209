"""``other_ops_us``: device microseconds a replayed tick spends in
operations that are in none of the port's kernel libraries (PyTorch's own
launches, copies and fills), the mean over the profiled call's replayed
ticks."""

from portbench.devtrace import OTHER


def read(run):
    ticks = list(run.record.get("ticks", {}).values())
    if not ticks:
        return None
    return sum(t[OTHER] for t in ticks) / len(ticks) / 1e3
