"""Three-term roofline of one rank's step, the port's counterpart of
``repro.roofline.analysis``:

    compute term    = FLOPs / peak_FLOP/s
    memory term     = bytes / HBM_bw
    collective term = collective wire bytes / link_bw

all three of the per-rank program (``roofline.op_cost`` counts them over
a traced step). Collective wire bytes weight each recorded collective's
buffer by the ring-algorithm factors of ``repro``'s:

    all-gather      (n-1)/n x output bytes
    reduce-scatter  (n-1)/n x input bytes
    all-reduce      2(n-1)/n x bytes        (RS + AG)
    all-to-all      (n-1)/n x bytes
    collective-permute 1 x bytes

:class:`HW` holds the NVIDIA H100 SXM5's datasheet figures at 700 W,
not measured: 989.4 TFLOP/s dense bf16, 3.35 TB/s HBM3, and 50 GB/s a GPU
for the link term, one 400 Gb/s NDR InfiniBand port a GPU, because both
16-wide axes of the production mesh span more than one 8-GPU NVLink node.
Within a node NVLink gives 450 GB/s a direction (``nvlink_bw``, not used
by the report).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping

#: Collective kinds, ``repro``'s HLO names.
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@dataclass(frozen=True)
class HW:
    """Datasheet figures of one H100 SXM5 at 700 W (not measured)."""

    peak_flops: float = 989.4e12  # dense bf16 FLOP/s a GPU
    hbm_bw: float = 3.35e12       # HBM3 bytes/s a GPU
    link_bw: float = 50e9         # bytes/s a GPU across nodes (400 Gb/s NDR)
    nvlink_bw: float = 450e9      # bytes/s a direction within a node


def wire_factor(kind: str, n: int) -> float:
    """Bytes on the wire per buffer byte of one ``kind`` collective over
    ``n`` ranks (a group of 1 or an unknown one counts as 2, as
    ``repro``'s parser does)."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    if not n or n <= 1:
        n = 2
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2 * frac
    if kind == "collective-permute":
        return 1.0
    return frac


def collective_bytes(records: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """Sum wire bytes per collective kind over ``records`` (each with
    ``kind``, ``bytes`` (its buffer, as the docstring's table says, summed
    over ``times`` runs of it, default 1) and ``group_size``)."""
    per_kind: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for r in records:
        kind = r["kind"]
        wire = wire_factor(kind, r["group_size"]) * float(r["bytes"])
        per_kind[kind] = per_kind.get(kind, 0.0) + wire
        count[kind] = count.get(kind, 0) + int(r.get("times", 1))
    return {"total_wire_bytes": sum(per_kind.values()), "per_kind": per_kind,
            "count": count}


def model_flops(kind: str, cfg, shape: Dict[str, Any]) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    n = cfg.active_param_count()
    batch, seq = shape["batch"], shape["seq"]
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch  # decode: one token per sequence


def roofline_report(kind: str, cfg, shape: Dict[str, Any], n_chips: int,
                    flops: float, bytes_accessed: float,
                    coll: Dict[str, Any], hw: HW = HW()) -> Dict[str, Any]:
    """The three terms of one rank's ``flops``, ``bytes_accessed`` and
    collective wire bytes, the dominant one, and the model-FLOPs bound.
    ``hlo_flops_per_chip`` keeps ``repro``'s key for the counted per-rank
    FLOPs."""
    t_compute = flops / hw.peak_flops
    t_memory = bytes_accessed / hw.hbm_bw
    t_coll = coll.get("total_wire_bytes", 0.0) / hw.link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(kind, cfg, shape)
    useful = mf / (flops * n_chips) if flops else 0.0
    bound = max(t_compute, t_memory, t_coll)
    mfu_bound = (mf / n_chips / hw.peak_flops) / bound if bound else 0.0
    return {
        **terms,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_per_chip": flops,
        "useful_flops_ratio": useful,
        "roofline_fraction": mfu_bound,  # model-FLOPs utilisation bound
    }
