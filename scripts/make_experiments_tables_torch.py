"""Generate the roofline/dry-run tables from the PyTorch port's dry-run
records (results/dryrun).

The port's counterpart of ``scripts/make_experiments_tables.py``, the same
tables from ``repro_torch.launch.dryrun``'s records: a trace-s column
(``lower_s``: the port traces one step with fake tensors where ``repro``
compiles it), one rank's peak GB beside its temp GB, and the torch version
the records were made with. The counts follow DTensor's version, so the
script refuses a directory whose records name two torch versions (exit 2,
one line on stderr).

    python scripts/make_experiments_tables_torch.py [RESULTS_DIR]
"""

import argparse
import glob
import json
import os
import sys


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/1e9:.2f}"


def _row(c, *keys):
    """The numbers a table row prints, by column."""
    r, m = c.get("roofline", {}), c.get("memory", {})
    vals = {"arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"],
            "tag": c.get("tag", ""), "status": c["status"],
            "trace_s": c.get("lower_s"),
            "temp_gb": m.get("temp_bytes") and m["temp_bytes"] / 1e9,
            "peak_gb": m.get("peak_bytes") and m["peak_bytes"] / 1e9,
            "args_gb": m.get("argument_bytes") and m["argument_bytes"] / 1e9}
    vals.update({k: r[k] for k in ("compute_s", "memory_s", "collective_s",
                                   "dominant", "model_flops",
                                   "useful_flops_ratio", "roofline_fraction")
                 if k in r})
    return {k: vals.get(k) for k in keys} if keys else vals


def main(argv=None) -> dict:
    """Print the tables; return their rows by table (``baseline``,
    ``roofline``, ``final``, ``iterations``) and the records' torch
    version. Exits 2 on records of two torch versions."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("results", nargs="?", default="results/dryrun")
    args = ap.parse_args(argv)

    cells = []
    for path in sorted(glob.glob(os.path.join(args.results, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    versions = sorted({str(c.get("torch")) for c in cells})
    if len(versions) > 1:
        print(f"ERROR: {args.results} holds records of torch "
              f"{', '.join(versions)}; the dry run's counts depend on "
              "DTensor's version, so one table takes one version's records",
              file=sys.stderr)
        raise SystemExit(2)
    out = {"torch": versions[0] if versions else None, "baseline": [],
           "roofline": [], "final": [], "iterations": []}
    print(f"Dry-run records of torch {out['torch']}\n")

    base = [c for c in cells if not c.get("tag")]
    print("### Dry-run grid (baseline)\n")
    print("| arch | shape | mesh | status | trace s | temp GB | peak GB |"
          " args GB | plan |")
    print("|---|---|---|---|---|---|---|---|---|")
    for c in sorted(base, key=lambda c: (c["arch"], c["shape"], c["mesh"])):
        if c["status"] == "ok":
            m = c["memory"]
            plan = c["plan"]
            pl = (f"fsdp={'T' if plan['fsdp'] else 'F'},"
                  f"micro={plan['microbatches']},{plan['optimizer']}")
            print(f"| {c['arch']} | {c['shape']} | {c['mesh']} | ok | "
                  f"{c['lower_s']} | {fmt_bytes(m['temp_bytes'])} | "
                  f"{fmt_bytes(m['peak_bytes'])} | "
                  f"{fmt_bytes(m['argument_bytes'])} | {pl} |")
        else:
            print(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                  f"{c['status']} | - | - | - | - | "
                  f"{c.get('reason', c.get('error', ''))[:60]} |")
        out["baseline"].append(_row(c, "arch", "shape", "mesh", "status",
                                    "trace_s", "temp_gb", "peak_gb",
                                    "args_gb"))

    print("\n### Roofline terms (single-pod 16x16 baseline)\n")
    print("| arch | shape | compute s | memory s | collective s | dominant |"
          " MODEL_FLOPS | useful ratio | roofline frac |")
    print("|---|---|---|---|---|---|---|---|---|")
    for c in sorted(base, key=lambda c: (c["arch"], c["shape"])):
        if c["status"] != "ok" or c["mesh"] != "16x16":
            continue
        r = c["roofline"]
        print(f"| {c['arch']} | {c['shape']} | {r['compute_s']:.4f} | "
              f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
              f"{r['dominant'].replace('_s','')} | {r['model_flops']:.3e} | "
              f"{r['useful_flops_ratio']:.3f} | "
              f"{r['roofline_fraction']:.4f} |")
        out["roofline"].append(_row(c, "arch", "shape", "compute_s",
                                    "memory_s", "collective_s", "dominant",
                                    "model_flops", "useful_flops_ratio",
                                    "roofline_fraction"))

    tagged = ("compute_s", "memory_s", "collective_s", "dominant",
              "roofline_fraction", "temp_gb", "peak_gb")
    finals = [c for c in cells if c.get("tag") == "final"]
    if finals:
        print("\n### Roofline terms — FINAL optimized framework\n")
        print("| arch | shape | mesh | compute s | memory s | collective s |"
              " dominant | roofline frac | temp GB | peak GB |")
        print("|---|---|---|---|---|---|---|---|---|---|")
        for c in sorted(finals,
                        key=lambda c: (c["arch"], c["shape"], c["mesh"])):
            if c["status"] != "ok":
                continue
            r = c["roofline"]
            print(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                  f"{r['compute_s']:.4f} | {r['memory_s']:.4f} | "
                  f"{r['collective_s']:.4f} | "
                  f"{r['dominant'].replace('_s','')} | "
                  f"{r['roofline_fraction']:.4f} | "
                  f"{fmt_bytes(c['memory']['temp_bytes'])} | "
                  f"{fmt_bytes(c['memory']['peak_bytes'])} |")
            out["final"].append(_row(c, "arch", "shape", "mesh", *tagged))

    tags = sorted({c.get("tag") for c in cells if c.get("tag")} - {"final"})
    if tags:
        print("\n### Perf iterations\n")
        print("| tag | arch | shape | compute s | memory s | collective s |"
              " dominant | roofline frac | temp GB | peak GB |")
        print("|---|---|---|---|---|---|---|---|---|---|")
        for c in sorted(cells, key=lambda c: (c.get("tag", ""), c["arch"])):
            if (not c.get("tag") or c.get("tag") == "final"
                    or c["status"] != "ok"):
                continue
            r = c["roofline"]
            print(f"| {c['tag']} | {c['arch']} | {c['shape']} | "
                  f"{r['compute_s']:.4f} | {r['memory_s']:.4f} | "
                  f"{r['collective_s']:.4f} | "
                  f"{r['dominant'].replace('_s','')} | "
                  f"{r['roofline_fraction']:.4f} | "
                  f"{fmt_bytes(c['memory']['temp_bytes'])} | "
                  f"{fmt_bytes(c['memory']['peak_bytes'])} |")
            out["iterations"].append(_row(c, "tag", "arch", "shape",
                                          *tagged))
    return out


if __name__ == "__main__":
    main()
