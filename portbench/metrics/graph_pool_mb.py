"""``graph_pool_mb``: the largest ``pool_bytes`` of the window's
``sweep.torch`` instants (the captured tick's private memory pool), in
MB."""


def read(run):
    pools = [e["args"]["pool_bytes"] for e in run.record.get("events", [])
             if e.get("name") == "sweep.torch"]
    if not pools or max(pools) <= 0:
        return None
    return max(pools) / 1e6
