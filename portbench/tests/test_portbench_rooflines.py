"""The byte counts read the state alone: a state reached by the port's
plain tick and the same state reached by the reference count the same
bytes, and (on the card) a state reached by the port's kernels counts as
the plain tick's does."""

import pytest
import torch

from portbench import rooflines
from portbench.reference import packer, tick
from test_portbench_reference import tiny


def counts(loop_state, grid, device):
    """The probed counts of one tick from ``loop_state`` (a state dict
    with the reference's keys), through the reference's tick."""
    loop = tick.Loop(grid, device)
    for k, v in loop_state.items():
        loop.st[k].copy_(v)
    loop.t = int(loop.st["tick"])
    probe = {}
    loop.step(probe)
    out = rooflines.phase_bytes(probe, grid.n_months)
    out["whole"] = rooflines.tick_bytes(probe, probe["pre"], probe["post"])
    return out


def port_state(cfg, specs, impl, device, n):
    from repro_torch.core.scenarios import ScenarioSpec, pack_specs
    from repro_torch.kernels.registry import resolve_tick_impl
    from repro_torch.sim.batched import TickLoop

    ps = [ScenarioSpec(base=cfg["base"], days=cfg["days"],
                       n_files=cfg["files_per_site"], seed=s["seed"],
                       cache_tb=s["cache_tb"], egress=s["egress"],
                       storage_price=s["storage_price"]) for s in specs]
    dev = torch.device(device)
    loop = TickLoop(pack_specs(ps, tick=cfg["tick_s"]),
                    resolve_tick_impl(impl, dev), dev,
                    graph=impl == "cuda")
    loop.advance(n)
    return {k: v.clone() for k, v in loop.st.items()}


@pytest.mark.parametrize("at", [40, 300])
def test_a_state_counts_the_same_bytes_however_it_was_reached(at):
    cfg, specs = tiny("hcdc-cfg3-1m")
    grid = packer.pack(cfg, specs, cfg["days"], cfg["tick_s"])
    ref = tick.Loop(grid, "cpu")
    ref.advance(at)
    mine = {k: v.clone() for k, v in ref.st.items()}
    theirs = port_state(cfg, specs, "torch", "cpu", at)
    for k, v in mine.items():
        assert torch.equal(v, theirs[k]), k
    a, b = counts(mine, grid, "cpu"), counts(theirs, grid, "cpu")
    assert a == b
    assert set(a) == set(rooflines.LANE_TICK_PHASES) | set(
        rooflines.GLUE_PHASES) | {"whole"}
    assert all(v > 0 for v in a.values())


def test_sector_bytes():
    m = torch.zeros(64, dtype=torch.bool)
    assert rooflines.sector_bytes(m, 4) == 0
    m[0] = m[7] = True
    assert rooflines.sector_bytes(m, 4) == 32
    m[8] = True
    assert rooflines.sector_bytes(m, 4) == 64
    assert rooflines.sector_bytes(m, 1) == 32


@pytest.mark.cuda
def test_kernel_and_plain_states_count_alike_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    cfg, specs = tiny("hcdc-cfg3-1m")
    grid = packer.pack(cfg, specs, cfg["days"], cfg["tick_s"])
    plain = port_state(cfg, specs, "torch", "cuda", 300)
    kern = port_state(cfg, specs, "cuda", "cuda", 300)
    keys = [k for k in plain if not k.startswith("ser_")]
    assert counts({k: kern[k] for k in keys}, grid, "cuda") == counts(
        {k: plain[k] for k in keys}, grid, "cuda")
