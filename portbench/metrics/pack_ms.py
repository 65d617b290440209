"""``pack_ms``: the mean ``pack_s`` of the window's ``sweep.torch``
instants (the front door's packing of each call's specs), in ms."""


def read(run):
    packs = [e["args"]["pack_s"] for e in run.record.get("events", [])
             if e.get("name") == "sweep.torch"]
    if not packs:
        return None
    return 1e3 * sum(packs) / len(packs)
