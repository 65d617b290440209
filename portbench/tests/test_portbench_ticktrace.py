"""The traced tick's readers on synthetic records: the stamp segments by
layer, the gap between ticks, the counts a lane a counted tick, the host
spans a call on the card, and the replays' wait for the host's launch,
each silent where its events are absent (a program without the tracing,
or the CPU's host-clock stamps)."""

import importlib

import pytest

from portbench import ticktrace
from portbench.harness import Run

METRICS = ("lane_tick_wall_us", "glue_wall_us", "torch_ops_wall_us",
           "replay_gap_us", "replay_host_wait_us", "tick_setup_ms",
           "billing_ms", "gcs_candidates_per_tick",
           "active_transfers_per_tick", "waiting_files_per_tick")
SEGMENTS = (ticktrace.LANE_TICK + ticktrace.GLUE + ticktrace.TORCH_OPS
            + ("counters",))


def reader(name):
    return importlib.import_module(f"portbench.metrics.{name}").read


def run_of(events, devtrace=None):
    run = Run(cell={}, cfg={}, traffic={}, seed=1, seconds=1.0, trace=True,
              device="cuda", tick_impl="cuda")
    run.record["events"] = events
    if devtrace is not None:
        run.record["devtrace"] = devtrace
    return run


def tick_instant(ticks, ns, clock="globaltimer", root=1, counts=None,
                 lane_ticks=16, gap=(900, 5)):
    """A loop's ``sweep.torch.tick``: each segment ``ns[name]`` a tick."""
    return {"name": ticktrace.TICK, "ph": "i", "ts": 0, "args": {
        "clock": clock, "ticks": ticks, "lanes": 8, "root": root,
        "segments": {s: {"sum_ns": ns.get(s, 0) * ticks,
                         "max_ns": ns.get(s, 0)} for s in SEGMENTS},
        "replay_gap": {"sum_ns": gap[0], "max_ns": 400, "n": gap[1]},
        "counts": counts or {"gcs_candidates": 32, "migrations": 16,
                             "active_transfers": 160, "waiting_files": 48,
                             "queued_links": 0},
        "lane_ticks": lane_ticks, "count_stride": 128}}


def span(name, ts, dur, root, **args):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur,
            "args": {"root": root, **args}}


def sweep(root, tick_impl="cuda"):
    return {"name": "sweep.torch", "ph": "i", "ts": 0,
            "args": {"root": root, "tick_impl": tick_impl}}


def test_segments_by_layer_over_every_loop():
    ns = {"transfer": 90_000, "gcs_admit": 50_000, "windows_admit": 4_000,
          "begin": 20_000, "complete_link": 160_000, "migrate": 10_000,
          "wait_select": 15_000, "clock": 8_000, "plan_apply": 200_000,
          "job_window": 30_000}
    events = [tick_instant(10, ns), tick_instant(30, ns, root=2)]
    run = run_of(events)
    assert reader("lane_tick_wall_us")(run) == pytest.approx(144.0)
    assert reader("glue_wall_us")(run) == pytest.approx(205.0)
    assert reader("torch_ops_wall_us")(run) == pytest.approx(238.0)
    # a gap a tick boundary: both loops' gaps over both loops' count
    assert reader("replay_gap_us")(run) == pytest.approx(1800 / 10 / 1e3)


def test_counts_a_lane_a_counted_tick():
    events = [tick_instant(10, {}),
              tick_instant(10, {}, counts={
                  "gcs_candidates": 0, "migrations": 0,
                  "active_transfers": 80, "waiting_files": 16,
                  "queued_links": 3}, lane_ticks=16)]
    run = run_of(events)
    assert reader("gcs_candidates_per_tick")(run) == pytest.approx(1.0)
    assert reader("active_transfers_per_tick")(run) == pytest.approx(7.5)
    assert reader("waiting_files_per_tick")(run) == pytest.approx(2.0)


@pytest.mark.parametrize("events", [
    [],  # a program without the tracing
    [tick_instant(10, {"transfer": 5}, clock="perf_counter")],  # the CPU
    [sweep(1, "torch"), span("tick.setup", 0, 500, 1, graph=False),
     span("billing", 600, 50, 1)],
], ids=["none", "host clock", "plain tick"])
def test_silent_without_the_cards_records(events):
    run = run_of(events)
    for name in METRICS:
        assert reader(name)(run) is None, name


def test_setup_and_billing_a_call_on_the_card():
    events = [sweep(1), span("tick.setup", 0, 3_000, 1, graph=True),
              span("tick.setup", 5_000, 1_000, 1, graph=True),
              span("billing", 9_000, 400, 1),
              sweep(2), span("tick.setup", 0, 2_000, 2, graph=True),
              span("billing", 9_000, 600, 2),
              # another call's eager loop and a call on the CPU: not read
              span("tick.setup", 0, 9_000, 2, graph=False),
              sweep(3, "torch"), span("billing", 0, 90_000, 3)]
    run = run_of(events)
    assert reader("tick_setup_ms")(run) == pytest.approx(3.0)
    assert reader("billing_ms")(run) == pytest.approx(0.5)


def devtrace_of(starts, length=100, window=(0, 10 ** 9)):
    """Replays of one operation each, ``length`` ns long."""
    kernels = [("k", s, s + length) for s in starts]
    return {"kernels": kernels, "replays": [[i] for i in range(len(starts))],
            "window": window}


def test_host_wait_is_the_idle_before_each_launch():
    # device: replays at 1,000 ns steps from 2,000 (each 100 ns long)
    red = devtrace_of([2_000, 3_000, 4_000, 5_000])
    # host launches (profiler clock): replay 1 launched after replay 0 ended
    # at 2,100 (at 2,600: 500 ns of host wait), replay 2 before (0),
    # replay 3 at 4,900 (800 ns)
    launches = [1_500, 2_600, 2_900, 4_900]
    offset = 500  # profiler clock less perf_counter
    base = 1 * 1000 + offset  # the span's ts (1 us) on the profiler clock
    events = [{"name": "obs.clock", "ph": "i", "ts": 0,
               "args": {"offset_ns": offset}},
              span("tick.replays", 1, 5, 1,
                   launch_ns=[x - base for x in launches])]
    run = run_of(events, red)
    assert reader("replay_host_wait_us")(run) == pytest.approx(
        (500 + 0 + 800) / 3 / 1e3)
    # counts that differ, or no clock: silent
    red_short = devtrace_of([2_000, 3_000, 4_000])
    assert reader("replay_host_wait_us")(run_of(events, red_short)) is None
    assert reader("replay_host_wait_us")(run_of(events[1:], red)) is None
    # a span outside the profiled call's window is not read
    red_late = devtrace_of([2_000, 3_000, 4_000, 5_000],
                           window=(10 ** 8, 10 ** 9))
    assert reader("replay_host_wait_us")(run_of(events, red_late)) is None
