"""Scenario sweep CLI (paper §5.3 decision workflow), the port's copy of
``repro``'s ``scripts/run_sweep.py``.

Runs a grid of HCDC configurations and emits the cost vs. throughput
table, its Pareto front, and optional per-seed aggregates. ``--backend
torch`` (default) runs the grid on the batched program on the card
(``--device cpu`` runs its plain PyTorch path on the CPU);
``--backend process`` runs it on the event-driven reference engine, one
process per config.

Grid from inline axes (comma-separated values expand the grid)::

    python -m repro_torch.cli.run_sweep \\
        --cache-tb 20,50,100 --egress internet,direct,interconnect \\
        --seeds 2 --days 1 --files 10000 --out results/sweep.csv

Access-pattern (workload) models are an axis too — repeat ``--workload``
per model::

    python -m repro_torch.cli.run_sweep --backend process \\
        --workload steady --workload diurnal:amplitude=0.8 \\
        --cache-tb 20,50 --days 1 --out results/workloads.csv

or from a JSON (or, where PyYAML is installed, YAML) spec file::

    python -m repro_torch.cli.run_sweep --spec sweep.json

Spec-file shape: top-level fixed fields plus either ``axes`` (mapping of
spec field -> value or list, Cartesian product) or ``scenarios`` (explicit
list of spec mappings).

Long sweeps can run fault-tolerantly (``--retries``/``--job-timeout``),
checkpoint finished jobs into the result cache (``--resume``), and be
stress-tested under deterministic fault injection (``--faults`` /
``$REPRO_FAULTS``). Exit status 2 means a bad argument (one ``ERROR``
line), 3 that the sweep finished with a partial result (some jobs
abandoned).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from repro_torch.cli._common import load_spec_doc, prebuild_kernels
from repro_torch.core.scenarios import EGRESS_OPTIONS, specs_from_mapping
from repro_torch.obs.logs import LOG_LEVELS, setup_logging
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import device_profile, get_tracer
from repro_torch.sim.jobs import RetryPolicy
from repro_torch.sim.output import write_csv
from repro_torch.sim.sweep import run_sweep

log = logging.getLogger("run_sweep")


def _floats(text: str) -> list:
    """Comma list of floats; 'inf' = unlimited, 'base' = keep base config."""
    out = []
    for tok in text.split(","):
        tok = tok.strip().lower()
        out.append(None if tok == "base" else float(tok))
    return out


def _build_axes(args: argparse.Namespace) -> dict:
    axes: dict = {
        "base": args.base,
        "days": args.days,
        "n_files": args.files,
        "seed": list(range(args.first_seed, args.first_seed + args.seeds)),
        "curves": args.curves,
    }
    if args.cache_tb:
        axes["cache_tb"] = _floats(args.cache_tb)
    if args.gcs_tb:
        axes["gcs_limit_tb"] = _floats(args.gcs_tb)
    if args.egress:
        axes["egress"] = [e.strip() for e in args.egress.split(",")]
    if args.storage_price:
        axes["storage_price"] = _floats(args.storage_price)
    if args.egress_price:
        axes["egress_price"] = _floats(args.egress_price)
    if args.rate_scale:
        axes["job_rate_scale"] = _floats(args.rate_scale)
    if args.workload:
        # Repeated --workload flags each add one model; a flag without
        # ':' parameters may also carry a plain comma list. (Parameterized
        # models embed commas, so those need their own flag.)
        wl: list = []
        for tok in args.workload:
            tok = tok.strip()
            if ":" in tok:
                if "," in tok.partition(":")[0]:
                    raise ValueError(
                        f"--workload {tok!r}: comma lists cannot include "
                        "parameterized models (their parameters themselves "
                        "contain commas) — repeat --workload once per model")
                wl.append(tok)
            else:
                wl += [t.strip() for t in tok.split(",") if t.strip()]
        axes["workload"] = wl
    return axes


def build_parser() -> argparse.ArgumentParser:
    # torch is imported here and not with the module: the process
    # backend's spawned workers import the module that started them, and
    # need no torch
    from repro_torch.kernels.registry import TICK_IMPL_CHOICES

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cli.run_sweep",
        description="HCDC scenario sweep (cost/throughput frontier)")
    ap.add_argument("--spec", help="JSON (or YAML, where PyYAML is "
                                   "installed) sweep spec file (overrides "
                                   "axis flags)")
    ap.add_argument("--base", default="III", choices=["I", "II", "III"],
                    help="Table 5 base configuration (default III)")
    ap.add_argument("--days", type=float, default=1.0, help="simulated days")
    ap.add_argument("--files", type=int, default=10_000,
                    help="files per site (catalogue size)")
    ap.add_argument("--cache-tb", default="",
                    help="comma list of per-site disk cache limits in TB "
                         "('inf' unlimited, 'base' keep)")
    ap.add_argument("--gcs-tb", default="",
                    help="comma list of cold-tier limits in TB (0 disables)")
    ap.add_argument("--egress", default="",
                    help=f"comma list from {','.join(EGRESS_OPTIONS)}")
    ap.add_argument("--storage-price", default="",
                    help="comma list of USD/GB-month storage prices")
    ap.add_argument("--egress-price", default="",
                    help="comma list of flat USD/GiB egress prices "
                         "(overrides the egress option's price table; "
                         "billing-only, shares dynamics lanes)")
    ap.add_argument("--rate-scale", default="",
                    help="comma list of job-arrival-rate multipliers")
    ap.add_argument("--workload", action="append", metavar="MODEL",
                    help="access-pattern model axis; repeat per model "
                         "(steady | diurnal | campaign | zipf-drift | "
                         "trace:PATH, parameters as 'name:key=val,...'). "
                         "Default: steady")
    ap.add_argument("--seeds", type=int, default=1,
                    help="replica seeds per config (default 1)")
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--curves", action="store_true",
                    help="record Fig 6/8 time-series digests (JSON output; "
                         "--backend process)")
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "process"],
                    help="torch = the batched lane-per-scenario program "
                         "(default; the whole grid as one tick program on "
                         "the card, requires uniform --days/--files); "
                         "process = the event-driven reference engine "
                         "(one process per config)")
    ap.add_argument("--tick", type=float, default=10.0,
                    help="torch backend clock step in seconds (default 10, "
                         "the paper's generator interval). Distinct from "
                         "--tick-impl, which picks the kernels")
    ap.add_argument("--tick-impl", default="auto",
                    choices=TICK_IMPL_CHOICES,
                    help="torch backend implementation: cuda (the "
                         "hand-written kernels, on the card), torch (the "
                         "plain PyTorch tick, any device), or auto "
                         "(default: cuda on the card, torch on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch backend device (default: the card; "
                         "'cpu' runs the plain path on the CPU)")
    ap.add_argument("--lane-chunk", type=int, default=None, metavar="N",
                    help="torch backend: simulate at most N dynamics lanes "
                         "per device dispatch (bounded memory; per-lane "
                         "results are bitwise the unchunked run's)")
    ap.add_argument("--workers", type=int, default=None,
                    help="worker processes (default: all CPUs)")
    ap.add_argument("--transport", default=None,
                    choices=["subprocess", "local"],
                    help="run jobs on a persistent worker fleet "
                         "(repro_torch.sim.runners) instead of the "
                         "anonymous pool: 'subprocess' spawns --workers "
                         "local worker processes, 'local' executes inline "
                         "(testing). Works with both backends; composes "
                         "with --retries/--faults/--job-timeout")
    ap.add_argument("--shard", action="store_true",
                    help="run the lanes over the lane mesh of the local "
                         "devices (every visible CUDA device, one "
                         "contiguous block of lanes a device); bitwise "
                         "the unsharded results. Requires --backend torch")
    ap.add_argument("--cache-dir", default=os.environ.get("REPRO_CACHE_DIR"),
                    metavar="DIR",
                    help="persistent result-cache directory (default: "
                         "$REPRO_CACHE_DIR if set, else no cache): "
                         "already-simulated configurations are served "
                         "from disk, only the rest are simulated")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the result cache even if --cache-dir or "
                         "$REPRO_CACHE_DIR is set")
    ap.add_argument("--retries", type=int, default=None, metavar="N",
                    help="fault-tolerant execution: retry crashed/timed-"
                         "out/transiently-failing jobs up to N attempts "
                         "with exponential backoff, and return a partial "
                         "result (exit 3) instead of raising when a job "
                         "exhausts them")
    ap.add_argument("--job-timeout", type=float, default=None, metavar="S",
                    help="per-job wall-clock deadline in seconds; overdue "
                         "jobs are killed and retried (counts as a "
                         "retryable failure)")
    ap.add_argument("--faults", default=os.environ.get("REPRO_FAULTS"),
                    metavar="PLAN",
                    help="inject deterministic faults for resilience "
                         "testing, e.g. 'seed=7,crash=0.2,hang=0.1,"
                         "transient=0.2,corrupt=0.1' (default: "
                         "$REPRO_FAULTS if set)")
    ap.add_argument("--resume", action="store_true",
                    help="journal each finished job into --cache-dir as it "
                         "completes, so a killed run re-run with the same "
                         "flags recomputes only unfinished jobs (requires "
                         "--cache-dir; implies --retries 3)")
    ap.add_argument("--out", default="", help="write the full table as CSV")
    ap.add_argument("--json", dest="json_out", default="",
                    help="write table + series digests as JSON")
    ap.add_argument("--pareto", default="", help="write the Pareto front as CSV")
    ap.add_argument("--aggregate", default="",
                    help="write the across-seed aggregate table as CSV")
    ap.add_argument("--record-series", type=int, default=None, metavar="N",
                    help="torch backend: capture per-tick time series on "
                         "the device, sampled every N ticks (1 = every "
                         "tick); digests land in the JSON output's series "
                         "block")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="write the metrics-registry snapshot (Prometheus "
                         "text format, or JSON when PATH ends in .json)")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="enable span tracing and write Chrome trace-event "
                         "JSON (load in Perfetto / chrome://tracing)")
    ap.add_argument("--device-profile", "--jax-profile",
                    dest="device_profile", default="", metavar="DIR",
                    help="with --trace-out: bracket the sweep in "
                         "torch.profiler and write its Chrome trace under "
                         "DIR (--jax-profile is the JAX package's name)")
    ap.add_argument("--log-level", default="info", choices=LOG_LEVELS,
                    help="stderr logging verbosity (default info)")
    ap.add_argument("--quiet", action="store_true", help="no per-config progress")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    run_id = setup_logging(args.log_level)
    if args.trace_out:
        get_tracer().enable(run_id)

    try:
        if args.spec:
            specs = specs_from_mapping(load_spec_doc(args.spec))
        else:
            specs = specs_from_mapping({"axes": _build_axes(args)})
    except (ValueError, TypeError, OSError) as e:
        log.error("%s", e)
        return 2
    if not specs:
        log.error("the grid expanded to 0 configs")
        return 2

    torch_only = {"--lane-chunk": args.lane_chunk is not None,
                  "--tick-impl": args.tick_impl != "auto",
                  "--device": args.device is not None,
                  "--record-series": args.record_series is not None}
    if args.backend != "torch":
        for flag, given in torch_only.items():
            if given:
                log.error("%s requires --backend torch%s", flag,
                          " (use --curves for the process backend)"
                          if flag == "--record-series" else "")
                return 2
    if args.shard and args.backend != "torch":
        log.error("--shard requires --backend torch")
        return 2
    device = None
    if args.backend == "torch":
        try:
            from repro_torch.kernels.registry import resolve_device

            device = str(resolve_device(args.device))
            prebuild_kernels(args.tick_impl, device)
        except (RuntimeError, ValueError) as e:
            log.error("%s", e)
            return 2
        chunk = ("" if args.lane_chunk is None
                 else f", lane_chunk={args.lane_chunk}")
        log.info("sweep: %d configs, backend=torch (device=%s, tick=%gs, "
                 "tick_impl=%s%s)", len(specs), device, args.tick,
                 args.tick_impl, chunk)
    else:
        workers = (min(len(specs), os.cpu_count() or 1)
                   if args.workers is None else args.workers)
        log.info("sweep: %d configs, workers=%d",
                 len(specs), max(workers, 1))

    def progress(done, total, result):
        if not args.quiet:
            log.info("[%3d/%d] %-55s jobs=%8.0f cost=$%s",
                     done, total, result.spec.label, result.jobs_done,
                     f"{result.cost_usd:12,.2f}")

    cache_dir = None if args.no_cache else args.cache_dir
    if args.resume and not cache_dir:
        log.error("--resume needs a result cache (--cache-dir or "
                  "$REPRO_CACHE_DIR) to journal completed jobs into")
        return 2
    if args.retries is not None and args.retries < 1:
        log.error("--retries must be >= 1")
        return 2
    retry = None
    if args.retries is not None:
        retry = RetryPolicy(max_attempts=args.retries)
    elif args.resume:
        retry = RetryPolicy()  # engage the jobs layer so completions journal
    if cache_dir:
        log.info("cache: %s", cache_dir)
    if args.faults:
        log.info("fault injection: %s", args.faults)
    try:
        with device_profile(args.device_profile or None):
            result = run_sweep(specs, workers=args.workers,
                               progress=progress,
                               backend=args.backend, tick=args.tick,
                               tick_impl=args.tick_impl,
                               lane_chunk=args.lane_chunk, cache=cache_dir,
                               record_series=args.record_series,
                               retry=retry, faults=args.faults,
                               job_timeout=args.job_timeout,
                               transport=args.transport, device=device,
                               shard=args.shard)
    except ValueError as e:  # e.g. a non-uniform grid on the torch backend
        log.error("%s", e)
        return 2
    cps = result.configs_per_sec
    log.info("done in %.1fs%s", result.wall_s,
             "" if cps is None else f" ({cps:.2f} configs/sec)")
    if cache_dir:
        log.info("cache: %d of %d configs served from cache, "
                 "%d dynamics lane(s) simulated",
                 result.cache_hits, len(result), result.lanes_simulated)
    if result.failures:
        for f in result.failures:
            log.error("job %s abandoned after %d attempt(s): [%s] %s",
                      f.job_id, f.attempts, f.kind,
                      f.errors[-1] if f.errors else "")
        log.error("PARTIAL result: %d config(s) returned, %d job(s) "
                  "abandoned%s", len(result), len(result.failures),
                  " — re-run with --resume to retry only the missing jobs"
                  if cache_dir else "")

    front = result.pareto_front()
    print(f"\nPareto front (min cost, max jobs) — {len(front)} of "
          f"{len(result)} configs:")
    for r in front:
        print(f"  {r.spec.label:55s} jobs={r.jobs_done:8.0f} "
              f"cost=${r.cost_usd:12,.2f} (${1e3 * r.cost_usd / max(r.jobs_done, 1):,.2f}/kjob)")

    if args.out:
        result.to_csv(args.out)
        log.info("wrote %s (%d rows)", args.out, len(result))
    if args.json_out:
        result.to_json(args.json_out)
        log.info("wrote %s", args.json_out)
    if args.pareto:
        result.pareto_to_csv(args.pareto)
        log.info("wrote %s (%d rows)", args.pareto, len(front))
    if args.aggregate:
        rows = result.aggregate_seeds()
        write_csv(args.aggregate, rows)
        log.info("wrote %s (%d rows)", args.aggregate, len(rows))
    if args.metrics_out:
        get_registry().dump(args.metrics_out)
        log.info("wrote %s", args.metrics_out)
    if args.trace_out:
        get_tracer().dump(args.trace_out)
        log.info("wrote %s (%d spans)", args.trace_out,
                 len(get_tracer().events))
    return 3 if result.failures else 0


if __name__ == "__main__":
    sys.exit(main())
