"""``tick_roofline_pct``: the bytes the whole tick needs
(``rooflines.tick_bytes``) at the card's memory rate, over the tick's wall
time on the device, summed over the sampled ticks of the profiled call;
bound by bytes."""

from portbench import rooflines


def read(run):
    ticks = run.record.get("ticks")
    counts = run.record.get("tick_bytes")
    if not ticks or not counts:
        return None
    pairs = [(c["whole"], ticks[c["tick"]]["wall"]) for c in counts
             if c["tick"] in ticks]
    if not pairs:
        return None
    return rooflines.share(sum(b for b, _ in pairs),
                           sum(ns for _, ns in pairs) / 1e9)
