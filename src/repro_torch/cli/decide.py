"""Decision-support CLI (paper §5.3): should you buy the cloud cache? The
port's copy of ``repro``'s ``scripts/decide.py``.

Drives ``repro_torch.sim.decide`` against a candidate grid: adaptive
frontier refinement, the displaced-disk headline solve, and the break-even
price solve, emitting a markdown/JSON decision report. ``--backend torch``
(default) runs the sweeps on the batched program on the card (``--device
cpu`` runs its plain PyTorch path on the CPU); ``--backend process`` on the
event-driven reference engine.

The default grid is the benchmark 216-config pricing grid (4 cache sizes
x 3 egress options x 9 storage prices x 2 seeds)::

    python -m repro_torch.cli.decide --days 0.25 --files 1000

Smoke-scale demo with a cross-backend check (the decision points re-run on
the event engine)::

    python -m repro_torch.cli.decide --days 0.1 --files 1000 \\
        --cache-tb 5,20,80 --storage-price '' --max-rounds 2 --cross-check

Exit status: 0, 2 with one ``ERROR`` line on a bad argument, 1 when the
cross-check disagrees, 3 when the report is degraded (jobs abandoned).
When ``$GITHUB_STEP_SUMMARY`` is set, the markdown report is appended to it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from repro_torch.cli._common import prebuild_kernels
from repro_torch.core.scenarios import EGRESS_OPTIONS, ScenarioSpec
from repro_torch.obs.logs import LOG_LEVELS, setup_logging
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer
from repro_torch.sim.decide import OnPremDisk, decide
from repro_torch.sim.jobs import RetryPolicy
from repro_torch.sim.sweep import SweepDriver, run_sweep

log = logging.getLogger("decide")

#: The benchmark pricing grid's storage-price axis (USD/GB-month), the
#: JAX package's bench grid (``benchmarks/bench_sweep.py``).
BENCH_PRICES = ",".join(f"{0.018 + 0.002 * i:.3f}" for i in range(9))


def _floats(text: str) -> list:
    """Comma list of floats, empty tokens skipped ('base' = keep the base
    configuration's value)."""
    out = []
    for tok in text.split(","):
        tok = tok.strip().lower()
        if tok:
            out.append(None if tok == "base" else float(tok))
    return out


def _build_axes(args: argparse.Namespace) -> dict:
    axes: dict = {"base": args.base, "days": args.days,
                  "n_files": args.files}
    axes["cache_tb"] = _floats(args.cache_tb)
    if args.gcs_tb:
        axes["gcs_limit_tb"] = _floats(args.gcs_tb)
    if args.egress:
        axes["egress"] = [e.strip() for e in args.egress.split(",")]
    prices = _floats(args.storage_price)
    if prices:
        axes["storage_price"] = prices
    if args.workload:
        axes["workload"] = args.workload
    return axes


def build_parser() -> argparse.ArgumentParser:
    # torch is imported here and not with the module: the process
    # backend's spawned workers import the module that started them, and
    # need no torch
    from repro_torch.kernels.registry import TICK_IMPL_CHOICES

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.cli.decide",
        description="Cloud-vs-on-prem decision report (adaptive frontier "
                    "refinement + break-even solvers)")
    ap.add_argument("--base", default="III", choices=["I", "II", "III"])
    ap.add_argument("--days", type=float, default=0.25)
    ap.add_argument("--files", type=int, default=1000)
    ap.add_argument("--cache-tb", default="10,20,40,80",
                    help="coarse cache-size axis in TB (refined adaptively)")
    ap.add_argument("--gcs-tb", default="",
                    help="optional cold-tier limit axis in TB")
    ap.add_argument("--egress", default="internet,direct,interconnect",
                    help=f"egress options from {','.join(EGRESS_OPTIONS)}")
    ap.add_argument("--storage-price", default=BENCH_PRICES,
                    help="storage-price axis, USD/GB-month ('' = none)")
    ap.add_argument("--workload", default="",
                    help="access-pattern model applied to grid and baseline")
    ap.add_argument("--seeds", type=int, default=2,
                    help="replica seeds per config; metrics carry mean ± CI")
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--refine", action="append", metavar="AXIS",
                    help="continuous axes to refine (default: cache_tb)")
    ap.add_argument("--rel-tol", type=float, default=0.05,
                    help="frontier tolerance: stop when frontier-adjacent "
                         "axis gaps are within this fraction of the span")
    ap.add_argument("--max-rounds", type=int, default=3)
    ap.add_argument("--lane-budget", type=int, default=None,
                    help="stop refining before exceeding this many "
                         "simulated dynamics lanes")
    ap.add_argument("--disk-usd-tb-month", type=float, default=15.0,
                    help="on-prem disk TCO (USD per TB-month)")
    ap.add_argument("--breakeven-axis", default="egress_price",
                    choices=["egress_price", "storage_price", "none"])
    ap.add_argument("--breakeven-lo", type=float, default=0.0)
    ap.add_argument("--breakeven-hi", type=float, default=0.12)
    ap.add_argument("--cache-floor", type=float, default=None,
                    help="lower bound (TB) for the displaced-disk bisection")
    ap.add_argument("--baseline-base", default="I",
                    choices=["I", "II", "III"],
                    help="disk-only baseline configuration (default I)")
    ap.add_argument("--z", type=float, default=1.96,
                    help="CI critical value (default 1.96 = 95%%)")
    ap.add_argument("--cache-dir", default=os.environ.get("REPRO_CACHE_DIR"),
                    metavar="DIR",
                    help="persistent result-cache directory (default: "
                         "$REPRO_CACHE_DIR if set, else no cache). Warm "
                         "re-runs of the same grid simulate zero lanes")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the result cache even if --cache-dir or "
                         "$REPRO_CACHE_DIR is set")
    ap.add_argument("--retries", type=int, default=None, metavar="N",
                    help="fault-tolerant sweeps: retry crashed/timed-out/"
                         "transiently-failing jobs up to N attempts; if a "
                         "job still fails the report is marked degraded "
                         "and the claim is refused")
    ap.add_argument("--job-timeout", type=float, default=None, metavar="S",
                    help="per-job wall-clock deadline in seconds")
    ap.add_argument("--faults", default=os.environ.get("REPRO_FAULTS"),
                    metavar="PLAN",
                    help="deterministic fault injection for resilience "
                         "testing, e.g. 'seed=7,crash=0.2,transient=0.2' "
                         "(default: $REPRO_FAULTS if set)")
    ap.add_argument("--resume", action="store_true",
                    help="journal each finished job into --cache-dir as it "
                         "completes so a killed invocation re-run with the "
                         "same flags recomputes only unfinished jobs "
                         "(requires --cache-dir; implies --retries 3)")
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "process"],
                    help="torch = the batched program (default, on the "
                         "card); process = the event-driven engine")
    ap.add_argument("--tick", type=float, default=60.0,
                    help="torch-backend clock step, seconds (default 60); "
                         "distinct from --tick-impl (kernel choice)")
    ap.add_argument("--tick-impl", default="auto",
                    choices=TICK_IMPL_CHOICES,
                    help="torch-backend implementation (auto = the "
                         "hand-written kernels on the card, the plain "
                         "PyTorch tick on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch backend device (default: the card; "
                         "'cpu' runs the plain path on the CPU); with "
                         "--backend process, the cross-check's")
    ap.add_argument("--lane-chunk", type=int, default=None)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--transport", default=None,
                    choices=["subprocess", "local"],
                    help="run sweep jobs on a persistent worker fleet "
                         "(repro_torch.sim.runners): 'subprocess' spawns "
                         "--workers local worker processes, 'local' "
                         "executes inline")
    ap.add_argument("--shard", action="store_true",
                    help="run the lanes over the lane mesh of the local "
                         "devices (every visible CUDA device, one "
                         "contiguous block of lanes a device); bitwise "
                         "the unsharded results. Requires --backend torch")
    ap.add_argument("--cross-check", action="store_true",
                    help="re-evaluate the baseline and final frontier on "
                         "the other backend; non-zero exit on disagreement")
    ap.add_argument("--check-tol-jobs", type=float, default=0.10,
                    help="cross-check jobs-done relative tolerance")
    ap.add_argument("--check-tol-cost", type=float, default=0.20,
                    help="cross-check cloud-cost relative tolerance")
    ap.add_argument("--json", dest="json_out", default="",
                    help="write the decision report as JSON")
    ap.add_argument("--report", default="",
                    help="write the markdown report to this path")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="write the metrics-registry snapshot (Prometheus "
                         "text format, or JSON when PATH ends in .json)")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="enable span tracing and write Chrome trace-event "
                         "JSON (load in Perfetto / chrome://tracing)")
    ap.add_argument("--log-level", default="info", choices=LOG_LEVELS,
                    help="stderr logging verbosity (default info)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def cross_check(args, report, driver, cache_dir, device) -> int:
    """Re-run the decision points on the other backend; 1 when any point
    is beyond the tolerances, else 0.

    Only the decision outputs are checked — baseline, chosen frontier
    config, trimmed displaced-disk candidate — not every probe the solvers
    visited: extreme bisection probes (sub-TB thrashing caches) sit where
    the fixed-tick and event-driven clocks legitimately diverge, and are
    not part of the recommendation.
    """
    other = "process" if args.backend == "torch" else "torch"
    points = [report.baseline]
    if report.chosen is not None:
        points.append(report.chosen)
    if report.displaced.candidate is not None:
        points.append(report.displaced.candidate)
    specs = list(dict.fromkeys(r.spec for p in points for r in p.results))
    if not args.quiet:
        log.info("cross-check: re-running %d configs on backend=%s ...",
                 len(specs), other)
    # The cross-check reads through the same cache (keys are
    # engine-fingerprinted, so the other backend's entries never collide
    # with this run's) — a warm re-check is free.
    kw = (dict(tick_impl=args.tick_impl, device=device)
          if other == "torch" else {})
    t0 = time.perf_counter()
    ref = run_sweep(specs, backend=other, tick=args.tick,
                    workers=args.workers, cache=cache_dir, **kw)
    log.info("cross-check: %d configs on backend=%s in %.2f s (%d served "
             "from the cache)", len(specs), other, time.perf_counter() - t0,
             ref.cache_hits)
    mine = driver.run(specs)  # memoized — no new simulation
    bad = []
    for a, b in zip(mine.results, ref.results):
        dj = abs(a.jobs_done - b.jobs_done) / max(b.jobs_done, 1.0)
        # absolute floor: a few-dollar bill shifts a lot relatively
        dc = abs(a.cost_usd - b.cost_usd) / max(b.cost_usd, 20.0)
        line = (f"  {a.spec.label:55s} jobs {a.jobs_done:8.0f} vs "
                f"{b.jobs_done:8.0f} ({dj:+.1%})  cost "
                f"${a.cost_usd:10,.2f} vs ${b.cost_usd:10,.2f} "
                f"({dc:+.1%})")
        if dj > args.check_tol_jobs or dc > args.check_tol_cost:
            bad.append(line)
        elif not args.quiet:
            log.info("%s", line)
    if bad:
        log.error("cross-check FAILED (%d/%d configs beyond jobs "
                  "%.0f%% / cost %.0f%%):", len(bad), len(specs),
                  100 * args.check_tol_jobs, 100 * args.check_tol_cost)
        for line in bad:
            log.error("%s", line)
        return 1
    log.info("cross-check OK: %d configs agree within jobs %.0f%% / "
             "cost %.0f%% on both backends", len(specs),
             100 * args.check_tol_jobs, 100 * args.check_tol_cost)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    run_id = setup_logging(args.log_level)
    if args.trace_out:
        get_tracer().enable(run_id)

    try:
        axes = _build_axes(args)
        if not axes["cache_tb"]:
            raise ValueError("--cache-tb needs at least one value")
        baseline = ScenarioSpec(
            base=args.baseline_base, days=args.days, n_files=args.files,
            gcs_limit_tb=0.0,
            workload=args.workload or "steady")
    except ValueError as e:
        log.error("%s", e)
        return 2

    if args.backend != "torch":
        # with --cross-check, --tick-impl and --device set its torch side
        for flag, given in (
                ("--tick-impl", args.tick_impl != "auto"
                 and not args.cross_check),
                ("--device", args.device is not None
                 and not args.cross_check),
                ("--lane-chunk", args.lane_chunk is not None)):
            if given:
                log.error("%s requires --backend torch (or, on "
                          "--backend process, --cross-check)"
                          if flag != "--lane-chunk" else
                          "%s requires --backend torch", flag)
                return 2
    if args.shard and args.backend != "torch":
        log.error("--shard requires --backend torch")
        return 2
    device = None
    if args.backend == "torch" or args.cross_check:
        # the card is needed by the torch backend, as the main engine or
        # as the cross-check's other side
        try:
            from repro_torch.kernels.registry import resolve_device

            device = str(resolve_device(args.device))
            prebuild_kernels(args.tick_impl, device)
        except (RuntimeError, ValueError) as e:
            log.error("%s", e)
            return 2
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
    try:
        driver = SweepDriver(backend=args.backend, tick=args.tick,
                             workers=args.workers,
                             tick_impl=(args.tick_impl
                                        if args.backend == "torch"
                                        else "auto"),
                             lane_chunk=args.lane_chunk, cache=cache_dir,
                             retry=retry, faults=args.faults,
                             job_timeout=args.job_timeout,
                             transport=args.transport, shard=args.shard,
                             device=device if args.backend == "torch"
                             else None)
    except ValueError as e:  # malformed --faults plan, tick_impl on the CPU
        log.error("%s", e)
        return 2
    if args.faults and not args.quiet:
        log.info("fault injection: %s", args.faults)
    if cache_dir and not args.quiet:
        log.info("result cache at %s", cache_dir)
    if not args.quiet:
        n0 = len(axes["cache_tb"]) * len(axes.get("egress", [1])) * \
            max(len(axes.get("storage_price", [1])), 1) * args.seeds
        log.info("coarse grid %d configs, backend=%s%s, %d seed(s), "
                 "refining %s to rel_tol=%g",
                 n0, args.backend,
                 f" ({driver.tick_impl} on {device})"
                 if args.backend == "torch" else "", args.seeds,
                 args.refine or ["cache_tb"], args.rel_tol)

    try:
        report = decide(
            axes, driver,
            baseline=baseline,
            refine=tuple(args.refine) if args.refine else ("cache_tb",),
            n_seeds=args.seeds, first_seed=args.first_seed,
            rel_tol=args.rel_tol, max_rounds=args.max_rounds,
            lane_budget=args.lane_budget,
            onprem=OnPremDisk(usd_per_tb_month=args.disk_usd_tb_month),
            breakeven_axis=(None if args.breakeven_axis == "none"
                            else args.breakeven_axis),
            breakeven_range=(args.breakeven_lo, args.breakeven_hi),
            cache_floor=args.cache_floor,
            z=args.z,
        )
    except ValueError as e:  # bad ranges/axes surface as CLI usage errors
        log.error("%s", e)
        return 2
    # decide() fills the driver accounting (sweep_calls, configs_run,
    # lanes_simulated, cache_hits, sweep_wall_s, cache hit/miss counters);
    # record only the CLI-level context on top.
    if cache_dir:
        report.stats["cache_dir"] = cache_dir

    md = report.to_markdown()
    print(md)
    if args.report:
        if os.path.dirname(args.report):
            os.makedirs(os.path.dirname(args.report), exist_ok=True)
        with open(args.report, "w") as f:
            f.write(md)
        log.info("wrote %s", args.report)
    summary = os.environ.get("GITHUB_STEP_SUMMARY")
    if summary:
        with open(summary, "a") as f:
            f.write(md + "\n")
    if args.json_out:
        if os.path.dirname(args.json_out):
            os.makedirs(os.path.dirname(args.json_out), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(report.to_json_dict(), f, indent=2)
        log.info("wrote %s", args.json_out)
    if args.metrics_out:
        get_registry().dump(args.metrics_out)
        log.info("wrote %s", args.metrics_out)
    if args.trace_out:
        get_tracer().dump(args.trace_out)
        log.info("wrote %s (%d spans)", args.trace_out,
                 len(get_tracer().events))

    if report.degraded:
        n = len(report.stats.get("failures", []))
        log.error("decision report is DEGRADED: %d job(s) abandoned after "
                  "retries — the claim verdict is refused; re-run%s to "
                  "complete the grid", n,
                  " with --resume" if cache_dir else "")
        return 3
    if args.cross_check:
        return cross_check(args, report, driver, cache_dir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
