"""§Perf hillclimb on the PyTorch port's dry run: hypothesis -> change ->
re-trace -> measure.

The port's counterpart of ``scripts/perf_iterations.py``: the same runs
(``RUNS``) through ``repro_torch.launch.dryrun.run_cell`` on the fake
256-rank backend (16x16), each a tagged plan override, the records under
results/dryrun/. Three cells:
  - hymba_1_5b  prefill_32k  (worst roofline fraction, memory-bound)
  - olmoe_1b_7b train_4k     (most collective-bound)
  - arctic_480b train_4k     (paper-representative: biggest data-intensive
                              training cell; memory + collective bound)

Two hypotheses are about ``repro``'s chunked attention and chunked scan.
The port's attention and scan kernels never build the score or state
tensors those chunks bound, so ``attn_chunk_threshold`` (a plan field the
port carries but nothing reads) and ``it1_ssmchunk`` (no override) measure
nothing different from the plain plan; each such run prints a note saying
so beside its record.

    python scripts/perf_iterations_torch.py [ONLY] [--device cpu]

``ONLY`` keeps the runs whose tag or arch contains it; ``--device cpu``
traces fake CPU tensors, for a machine without CUDA.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.dryrun import run_cell  # noqa: E402

OUT = "results/dryrun"

#: What the port's kernels make of an override or run that ``repro`` acts on.
ATTN_CHUNK_NOTE = (
    "attn_chunk_threshold is inert in the port: the attention kernel never "
    "builds the [B, H, T, S] score tensor that repro's chunked attention "
    "bounds, so this record measures nothing different from the plan "
    "without it")
SCAN_CHUNK_NOTE = (
    "the port has no chunked scan to switch on: the scan kernel never "
    "builds the [B, T, d_inner, N] states, so this record is the plain "
    "plan's")


def note_for(tag: str, overrides: dict) -> str:
    """The note a run prints beside its record, or ``""``."""
    notes = [SCAN_CHUNK_NOTE] if tag == "it1_ssmchunk" else []
    if "attn_chunk_threshold" in overrides:
        notes.append(ATTN_CHUNK_NOTE)
    return "; ".join(notes)


def show(rec) -> dict:
    """Print a record's roofline line; return its numbers (empty if the
    cell did not end ``ok``)."""
    if rec["status"] != "ok":
        print(f"  !! {rec['status']}: {rec.get('error', '')[:200]}")
        return {}
    r = rec["roofline"]
    mem = rec["memory"]
    temp = (mem["temp_bytes"] or 0) / 1e9
    peak = (mem["peak_bytes"] or 0) / 1e9
    coll = rec["collectives"]["per_kind"]
    ck = " ".join(f"{k}={v/1e9:.1f}GB" for k, v in sorted(coll.items()))
    print(f"  comp={r['compute_s']:8.3f}s mem={r['memory_s']:8.3f}s "
          f"coll={r['collective_s']:8.3f}s dom={r['dominant'][:-2]} "
          f"rf={r['roofline_fraction']:.4f} temp={temp:.1f}GB "
          f"peak={peak:.1f}GB torch={rec['torch']}\n"
          f"  wire: {ck}")
    return {"compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "dominant": r["dominant"],
            "roofline_fraction": r["roofline_fraction"], "temp_gb": temp,
            "peak_gb": peak, "wire_gb": {k: v / 1e9 for k, v in coll.items()},
            "torch": rec["torch"]}


RUNS = [
    # (arch, shape, tag, overrides, hypothesis-one-liner)
    ("hymba_1_5b", "prefill_32k", "it1_ssmchunk", {},
     "chunked SSM scan stops materializing [B,T,di,N]"),
    ("olmoe_1b_7b", "train_4k", "it1_micro4", {"microbatches": 4},
     "4x fewer grad-accum rounds -> grad all-reduce wire /4"),
    ("olmoe_1b_7b", "train_4k", "it2_micro4_bf16",
     {"microbatches": 4, "grad_accum_dtype": "bf16"},
     "bf16 accumulators halve remaining grad wire"),
    ("arctic_480b", "train_4k", "it1_micro4", {"microbatches": 4},
     "FSDP weight gathers amortize over 4x bigger microbatches"),
    ("arctic_480b", "train_4k", "it2_micro4_chunk",
     {"microbatches": 4, "attn_chunk_threshold": 2048},
     "chunked attention removes replicated 56-head score tensors"),
    ("arctic_480b", "train_4k", "it3_micro2_chunk_bf16",
     {"microbatches": 2, "attn_chunk_threshold": 2048,
      "grad_accum_dtype": "bf16"},
     "push further: 2 microbatches + bf16 accum"),
    ("hymba_1_5b", "prefill_32k", "it2_chunk2048",
     {"attn_chunk_threshold": 2048},
     "smaller attention chunks cut transient scores further"),
    ("olmoe_1b_7b", "train_4k", "it3_micro1_bf16",
     {"microbatches": 1, "grad_accum_dtype": "bf16"},
     "single batch: no accumulation at all (16 rows/device fit)"),
]


def main(argv=None) -> dict:
    """Run the selected iterations; return each one's numbers and note by
    ``"<arch> <tag>"``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("only", nargs="?", default=None,
                    help="run only iterations whose tag or arch contains it")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the fake tensors' device")
    args = ap.parse_args(argv)

    out = {}
    for arch, shape, tag, over, hyp in RUNS:
        if args.only and args.only not in tag and args.only not in arch:
            continue
        print(f"== {arch} {shape} [{tag}] — {hyp}")
        rec = run_cell(arch, shape, False, out_dir=OUT,
                       plan_overrides=over, tag=tag, device=args.device)
        nums = show(rec)
        note = note_for(tag, over)
        if note:
            print(f"  note: {note}")
        out[f"{arch} {tag}"] = {"status": rec["status"], **nums,
                                "note": note}
        sys.stdout.flush()
    return out


if __name__ == "__main__":
    main()
