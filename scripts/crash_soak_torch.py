"""Crash-soak harness for the PyTorch port's fault-tolerant sweep path.

The port's counterpart of ``scripts/crash_soak.py``. Exercises the two
resilience guarantees end-to-end through the port's real CLI
(``python -m repro_torch.cli.run_sweep``), not the library API, so process
spawning, signal handling, and the exit-code contract are all on the
hook:

1. **Kill + resume** — launch a checkpointed sweep (``--resume`` with a
   result cache), SIGKILL its whole process group mid-run, re-run the
   identical command, and assert the rerun completes with every config
   present while serving the journaled prefix from cache (``cache_hits``
   > 0 whenever the first run survived long enough to finish at least one
   job).
2. **Fault soak** — run a sweep to completion under deterministic fault
   injection (crashes, hangs, transient errors, corrupted cache reads
   via ``--faults``) with retries enabled, and assert a full,
   non-partial result (exit 0, no abandoned jobs).

The default backend is ``torch``: the batched program on the CUDA device
(``--tick-impl``, ``--device cpu`` for the plain tick on the CPU), in lane
chunks of 2 (``--lane-chunk 2``), each chunk a job journaled as it
finishes; ``--backend process`` journals per config on the event engine.

Usage::

    python scripts/crash_soak_torch.py
    python scripts/crash_soak_torch.py --device cpu --files 200 --days 0.25
    python scripts/crash_soak_torch.py --files 1000000 --kill-after 20 --keep

Exit status 0 when both phases pass, 1 otherwise. The last line of
standard output is one JSON object of the numbers the run logged.
See docs/resilience.md for the fault-injection matrix and the resume
semantics being soaked here.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
sys.path.insert(0, SRC)

from repro_torch.kernels.registry import (  # noqa: E402
    TICK_IMPL_CHOICES,
    resolve_device,
)

log = logging.getLogger("crash_soak")


def _sweep_cmd(args: argparse.Namespace, cache_dir: str, json_out: str,
               extra: list) -> list:
    cmd = [sys.executable, "-m", "repro_torch.cli.run_sweep",
           "--base", "III", "--days", str(args.days),
           "--files", str(args.files),
           "--cache-tb", args.cache_tb, "--seeds", str(args.seeds),
           "--backend", args.backend,
           "--workers", str(args.workers),
           "--cache-dir", cache_dir, "--resume",
           "--json", json_out, "--quiet"]
    if args.backend == "torch":
        cmd += ["--tick", "60", "--lane-chunk", "2",
                "--tick-impl", args.tick_impl]
        if args.device is not None:
            cmd += ["--device", args.device]
    return cmd + extra


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.pop("REPRO_FAULTS", None)  # phases control injection explicitly
    return env


def _run(cmd: list) -> tuple:
    """Run ``cmd`` to its end; returns its exit code and wall seconds."""
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, env=_env(), cwd=ROOT).returncode
    return rc, time.perf_counter() - t0


def phase_kill_resume(args: argparse.Namespace, tmp: str, out: dict) -> bool:
    """SIGKILL a checkpointed sweep mid-run, then resume it."""
    cache = os.path.join(tmp, "cache-kill")
    json_out = os.path.join(tmp, "resume.json")
    cmd = _sweep_cmd(args, cache, json_out, [])
    n_expected = len(args.cache_tb.split(",")) * args.seeds

    log.info("[kill+resume] launching: %s", " ".join(cmd))
    # Own session + own log file, and the kill takes out the whole
    # process group: worker processes die with the parent (the scenario
    # being simulated is the machine going away, not a tidy shutdown),
    # and no orphan can sit on an inherited stdout pipe blocking
    # whatever is consuming this script's output.
    with open(os.path.join(tmp, "victim.log"), "w") as victim_log:
        proc = subprocess.Popen(cmd, env=_env(), cwd=ROOT,
                                stdout=victim_log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        time.sleep(args.kill_after)
    if proc.poll() is None:
        log.info("[kill+resume] SIGKILL (whole process group) after %.1fs",
                 args.kill_after)
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        killed = True
    else:
        log.warning("[kill+resume] run finished in under %.1fs (rc=%d) — "
                    "increase the grid or lower --kill-after for a real "
                    "mid-run kill; resume check degrades to a warm re-run",
                    args.kill_after, proc.returncode)
        killed = proc.returncode != 0
    out.update(kill_after_s=args.kill_after, victim_rc=proc.returncode,
               killed=killed)

    log.info("[kill+resume] resuming with the identical command ...")
    rc, wall = _run(cmd)
    out.update(resume_rc=rc, resume_wall_s=wall)
    if rc != 0:
        log.error("[kill+resume] FAIL: resume exited %d", rc)
        return False
    with open(json_out) as f:
        doc = json.load(f)
    n_rows = len(doc["rows"])
    hits = doc.get("cache_hits", 0)
    lanes = doc.get("lanes_simulated")
    out.update(resume_rows=n_rows, expected_rows=n_expected,
               cache_hits=hits, lanes_simulated=lanes,
               resume_json=json_out)
    log.info("[kill+resume] resume: %d/%d configs, cache_hits=%d, "
             "lanes_simulated=%s, %.1fs wall", n_rows, n_expected, hits,
             lanes, wall)
    if n_rows != n_expected:
        log.error("[kill+resume] FAIL: %d of %d configs after resume",
                  n_rows, n_expected)
        return False
    if doc.get("failures"):
        log.error("[kill+resume] FAIL: abandoned jobs after resume: %s",
                  doc["failures"])
        return False
    if killed and hits == 0:
        # Not an error by itself (the kill may have landed before the
        # first job finished journaling) but the soak lost its point.
        log.warning("[kill+resume] kill landed before any job was "
                    "journaled (cache_hits=0) — raise --kill-after so "
                    "the resume actually skips work")
    log.info("[kill+resume] OK")
    return True


def phase_fault_soak(args: argparse.Namespace, tmp: str, out: dict) -> bool:
    """Run to completion under crash/hang/transient/corrupt injection."""
    cache = os.path.join(tmp, "cache-faults")
    json_out = os.path.join(tmp, "faults.json")
    plan = (f"seed={args.fault_seed},crash=0.15,hang=0.1,transient=0.2,"
            f"corrupt=0.2,hang_s=0.5,attempts=1")
    cmd = _sweep_cmd(args, cache, json_out,
                     ["--faults", plan, "--retries", "4",
                      "--job-timeout", "30"])
    n_expected = len(args.cache_tb.split(",")) * args.seeds

    log.info("[fault soak] plan: %s", plan)
    rc, wall = _run(cmd)
    out.update(fault_rc=rc, fault_wall_s=wall)
    if rc != 0:
        log.error("[fault soak] FAIL: exited %d (3 = partial result — a "
                  "job exhausted its retries)", rc)
        return False
    with open(json_out) as f:
        doc = json.load(f)
    n_rows = len(doc["rows"])
    out.update(fault_rows=n_rows)
    if n_rows != n_expected or doc.get("failures"):
        log.error("[fault soak] FAIL: %d of %d configs, failures=%s",
                  n_rows, n_expected, doc.get("failures"))
        return False
    log.info("[fault soak] OK: %d/%d configs under injection, %.1fs wall",
             n_rows, n_expected, wall)
    return True


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Kill/resume and fault-injection soak for the port's "
                    "run_sweep")
    ap.add_argument("--days", type=float, default=2.0,
                    help="horizon per config; sized so the kill+resume "
                         "run lasts well past --kill-after")
    ap.add_argument("--files", type=int, default=1000)
    ap.add_argument("--cache-tb", default="5,10,20,40,80,160",
                    help="cache-size axis (with --seeds sets grid size)")
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "process"],
                    help="torch journals per lane chunk of 2 (the "
                         "default); process journals per config as each "
                         "finishes")
    ap.add_argument("--tick-impl", default="auto", choices=TICK_IMPL_CHOICES,
                    help="torch backend: cuda (the kernels), torch (the "
                         "plain tick) or auto (cuda on the card, torch on "
                         "the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch backend: cuda (default) or cpu")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--kill-after", type=float, default=5.0,
                    help="seconds before the whole-process-group SIGKILL "
                         "in the kill+resume phase (late enough that "
                         "some jobs have journaled, early enough that "
                         "some have not)")
    ap.add_argument("--fault-seed", type=int, default=7)
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch directory (prints its path)")
    return ap


def main(argv=None) -> dict:
    """Run both phases; return the numbers they logged, with ``rc``: 0
    when both passed, 1 otherwise."""
    args = build_parser().parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    if args.backend == "torch":
        resolve_device(args.device)  # no CUDA: fail here, not after the kill
    tmp = tempfile.mkdtemp(prefix="crash_soak.")
    log.info("scratch: %s", tmp)
    out: dict = {"scratch": tmp if args.keep else None}
    try:
        ok = phase_kill_resume(args, tmp, out)
        ok = phase_fault_soak(args, tmp, out) and ok
    finally:
        if args.keep:
            log.info("kept scratch dir: %s", tmp)
        else:
            shutil.rmtree(tmp, ignore_errors=True)
    log.info("crash soak: %s", "PASS" if ok else "FAIL")
    out["rc"] = 0 if ok else 1
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    raise SystemExit(main()["rc"])
