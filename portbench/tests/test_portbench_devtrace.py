"""The trace's reduction on a synthetic event list: ticks are cut at the
CUDA graph's launches and kernels grouped by the library that holds them,
so a tick whose first kernel has another name, or a library kernel under a
new name, is read the same."""

import pytest

from portbench import devtrace

#: Kernel libraries of the synthetic run, as ``devtrace.port_kernels``
#: gives them.
LIBS = {"tt_advance_kernel": "lane_tick", "tg_renamed_start_kernel":
        "tick_glue", "tg_complete_kernel": "tick_glue"}


class Event:
    def __init__(self, name, device, start, end, corr=0, annotation=False):
        self._v = (name, device, start, end, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return f"DeviceType.{self._v[1]}"

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {
            "events": lambda _self: events})()


def synthetic(n_replays=4, warm=2):
    """Eager warm-up ticks, then ``n_replays`` graph launches of a tick
    whose first kernel is ``tg_renamed_start_kernel`` (40 ns), then
    ``tt_advance_kernel`` (100 ns), a PyTorch launch (30 ns) and
    ``tg_complete_kernel`` (60 ns), a tick every 1,000 ns."""
    ev = [Event(devtrace.CALL_SPAN, "CPU", 0, 100_000, annotation=True),
          Event(devtrace.CALL_SPAN, "CUDA", 10, 99_000, annotation=True)]
    t = 1_000
    for k in range(warm):  # eager: each kernel its own launch
        for j, (name, d) in enumerate((("tt_advance_kernel", 100),
                                       ("void at::native::fill_kernel", 5))):
            ev.append(Event(name, "CUDA", t + 200 * j, t + 200 * j + d,
                            corr=100 + 10 * k + j))
        t += 1_000
    for r in range(n_replays):
        cid = 500 + r
        ev.append(Event("cudaGraphLaunch", "CPU", t - 50, t - 40, corr=cid))
        at = t
        for name, d in (("tg_renamed_start_kernel(int*)", 40),
                        ("(anonymous namespace)::tt_advance_kernel(float "
                         "const*)", 100),
                        ("void at::native::vectorized_elementwise_kernel"
                         "<4, float>(int)", 30),
                        ("void tg_complete_kernel<4>(float*)", 60)):
            ev.append(Event(name, "CUDA", at, at + d, corr=cid))
            at += d + 10
        t += 1_000
    return ev


def test_ticks_are_cut_at_graph_launches_whatever_the_kernels_are_named():
    red = devtrace.reduce(Prof(synthetic()), host_ns=0)
    assert red["window"] == (0, 100_000)
    assert len(red["replays"]) == 4
    ticks = devtrace.ticks(red["kernels"], red["replays"], LIBS, n_ticks=6)
    # the last replay is tick 5, so the replays are ticks 2-5; the last
    # has no successor to end its wall time
    assert sorted(ticks) == [2, 3, 4]
    for t in ticks.values():
        assert t == {"wall": 1_000, "tick_glue": 100, "lane_tick": 100,
                     devtrace.OTHER: 30}


def test_a_kernel_outside_the_port_libraries_is_other():
    red = devtrace.reduce(Prof(synthetic()), host_ns=0)
    libs = {k: v for k, v in LIBS.items() if k != "tg_complete_kernel"}
    ticks = devtrace.ticks(red["kernels"], red["replays"], libs, n_ticks=6)
    assert ticks[2]["tick_glue"] == 40 and ticks[2][devtrace.OTHER] == 90


def test_the_call_annotation_is_no_device_operation():
    red = devtrace.reduce(Prof(synthetic()), host_ns=0)
    assert all(name != devtrace.CALL_SPAN for name, _, _ in red["kernels"])
    assert devtrace.busy_ns(red["kernels"], *red["window"]) == \
        2 * 105 + 4 * 230


def test_breakdown_places_idle_by_replays():
    red = devtrace.reduce(Prof(synthetic()), host_ns=0)
    spans = [("simulate_packed", 500, 9_000)]
    out = devtrace.breakdown(red, spans)
    gaps = dict(out["idle_gaps"])
    assert gaps["simulate_packed: replays"] > 0
    assert gaps["simulate_packed: state, warm-up, capture"] > 0
    assert out["device_ops"][0][0].startswith("(anonymous namespace)::")


@pytest.mark.parametrize("name, ident", [
    ("tt_count_kernel(float const*, int)", "tt_count_kernel"),
    ("(anonymous namespace)::wa_fused_kernel(int)", "wa_fused_kernel"),
    ("void tg_wait_select_kernel<4>(float*)", "tg_wait_select_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, float>(int)",
     "vectorized_elementwise_kernel"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy")])
def test_kernel_id(name, ident):
    assert devtrace.kernel_id(name) == ident


def test_port_kernels_come_from_the_build(monkeypatch):
    from repro_torch.kernels import _build

    def usage(lib):
        if lib == "tick_glue":
            return {"tg_new_kernel": {}, "tg_wait_select_kernel<4>": {}}
        raise FileNotFoundError(lib)  # not built

    monkeypatch.setattr(_build, "ptxas_usage", usage)
    assert devtrace.port_kernels() == {"tg_new_kernel": "tick_glue",
                                       "tg_wait_select_kernel": "tick_glue"}
