"""The port's lane-tick kernels: plain versions against the JAX package's
Pallas kernels, and the wrapper and registry contract.

On the CPU the plain PyTorch versions (``repro_torch.kernels.lane_tick.
ref``) run lane by lane against ``repro.kernels.lane_tick`` in Pallas
interpret mode on the inputs ``tests/test_kernels.py`` builds:

- transfer: completion mask exact, ``new_done`` at rtol 1e-6 (the Pallas
  trace may fuse a multiply-add), billing at rtol 1e-5 (reduction order);
- shared-GCS admission: the mask exact against the global-cumsum numpy
  oracle (and the interpret kernel), occupancy at rtol 1e-5, the
  migration rank exact (the per-site cumsum of that mask, ``-1`` off it);
- candidate windows: bitwise.

The CUDA kernels themselves are held against the plain versions on a card
by ``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import lane_tick as jx_lane_tick
from repro_torch.kernels import registry
from repro_torch.kernels.lane_tick import ops, ref

from torch_lane_inputs import (
    MONTH,
    N_MONTHS,
    gcs_inputs,
    scalars,
    stack_transfer,
    transfer_inputs,
    window_inputs,
)


def _gcs_numpy_oracle(want, sizes, used0, limit, n_passes):
    """``GCS_ADMIT_PASSES`` passes of one global cumsum over a lane's
    site-major flattened candidate vector (the jnp program's loop)."""
    admitted = np.zeros(want.shape, bool)
    used = np.float32(used0)
    for _ in range(n_passes):
        rem = want & ~admitted
        csum = np.cumsum((sizes * rem).ravel()).reshape(want.shape)
        new = rem & (used + csum <= limit)
        admitted |= new
        used = used + (sizes * new).sum(dtype=np.float64).astype(np.float32)
    return admitted, used


# ----------------------------------------------------- plain vs Pallas (CPU)
def test_transfer_tick_plain_matches_pallas_per_lane():
    lanes = [transfer_inputs(seed=s) for s in range(3)]
    dt, month = scalars()
    got = ref.transfer_tick(*stack_transfer(lanes), dt, month, N_MONTHS)
    onehot = np.zeros(N_MONTHS, np.float32)
    onehot[MONTH] = 1.0
    for li, (link_id, active, done, total, sizes, bw, mode) in \
            enumerate(lanes):
        want = jx_lane_tick.transfer_tick(
            jnp.asarray(link_id), jnp.asarray(active), jnp.asarray(done),
            jnp.asarray(total), jnp.asarray(sizes), jnp.asarray(bw),
            jnp.asarray(mode), 50.0, jnp.asarray(onehot), interpret=True)
        np.testing.assert_array_equal(got[1][li].numpy(),
                                      np.asarray(want[1]) > 0.5)
        np.testing.assert_allclose(got[0][li].numpy(), np.asarray(want[0]),
                                   rtol=1e-6)
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g[li].numpy(), np.asarray(w),
                                       rtol=1e-5)
        assert got[1][li].any() and (~got[1][li]).any()


def test_gcs_admit_plain_matches_global_cumsum_oracle():
    want, sizes, used0, limit = gcs_inputs()
    dt, month = scalars(dt=60.0)
    adm, used, gbsec, _ = ref.gcs_admit(
        torch.as_tensor(want), torch.as_tensor(sizes),
        torch.as_tensor(used0), torch.as_tensor(limit), dt, month, N_MONTHS,
        n_passes=ref.GCS_ADMIT_PASSES)
    onehot = np.zeros(N_MONTHS, np.float32)
    onehot[MONTH] = 1.0
    for li in range(want.shape[0]):
        oracle, used_o = _gcs_numpy_oracle(want[li], sizes[li], used0[li],
                                           limit[li], ref.GCS_ADMIT_PASSES)
        np.testing.assert_array_equal(adm[li].numpy(), oracle)
        np.testing.assert_allclose(float(used[li]), used_o, rtol=1e-5)
        np.testing.assert_allclose(gbsec[li].numpy(),
                                   onehot * (used_o / 1e9 * 60.0), rtol=1e-5)
        pallas = jx_lane_tick.gcs_admit(
            jnp.asarray(want[li]), jnp.asarray(sizes[li]), used0[li],
            limit[li], 60.0, jnp.asarray(onehot),
            n_passes=ref.GCS_ADMIT_PASSES, interpret=True)
        np.testing.assert_array_equal(adm[li].numpy(),
                                      np.asarray(pallas[0]) > 0.5)
    # the finite limits bind, the infinite one admits every candidate
    assert not np.array_equal(adm[0].numpy(), want[0])
    np.testing.assert_array_equal(adm[-1].numpy(), want[-1])


def _site_rank(mask):
    """The jnp tick's migration rank (``repro/sim/batched.py:337``): the
    per-site cumsum of the admitted mask, minus one, ``-1`` off the mask."""
    return np.where(mask, np.cumsum(mask, axis=-1) - 1, -1).astype(np.int32)


@pytest.mark.parametrize("seed", [7, 8])
def test_gcs_admit_rank_is_site_cumsum_of_jnp_admissions(seed):
    want, sizes, used0, limit = gcs_inputs(seed=seed)
    dt, month = scalars(dt=60.0)
    adm, _, _, rank = ref.gcs_admit(
        torch.as_tensor(want), torch.as_tensor(sizes),
        torch.as_tensor(used0), torch.as_tensor(limit), dt, month, N_MONTHS)
    assert rank.dtype == torch.int32 and rank.shape == adm.shape
    onehot = np.zeros(N_MONTHS, np.float32)
    onehot[MONTH] = 1.0
    for li in range(want.shape[0]):
        oracle, _ = _gcs_numpy_oracle(want[li], sizes[li], used0[li],
                                      limit[li], ref.GCS_ADMIT_PASSES)
        np.testing.assert_array_equal(rank[li].numpy(), _site_rank(oracle))
        pallas = jx_lane_tick.gcs_admit(
            jnp.asarray(want[li]), jnp.asarray(sizes[li]), used0[li],
            limit[li], 60.0, jnp.asarray(onehot),
            n_passes=ref.GCS_ADMIT_PASSES, interpret=True)
        np.testing.assert_array_equal(
            rank[li].numpy(), _site_rank(np.asarray(pallas[0]) > 0.5))
    # every site of the unlimited lane ranks 0..n-1 over its candidates
    for s in range(want.shape[1]):
        got = rank[-1, s].numpy()
        np.testing.assert_array_equal(np.sort(got[want[-1, s]]),
                                      np.arange(want[-1, s].sum()))


def test_admission_rank_restarts_per_site_row():
    T, F = True, False
    mask = torch.tensor([[[T, F, T, T], [F, T, F, T]],
                         [[F, F, F, F], [T, T, F, F]]])
    assert ref.admission_rank(mask).tolist() == [
        [[0, -1, 1, 2], [-1, 0, -1, 1]],
        [[-1, -1, -1, -1], [0, 1, -1, -1]]]


@pytest.mark.parametrize("fifo", [False, True])
def test_window_admit_plain_bitwise_vs_pallas(fifo):
    live, size, used, limit = window_inputs(fifo)
    adm, extra = ref.window_admit(torch.as_tensor(live),
                                  torch.as_tensor(size),
                                  torch.as_tensor(used),
                                  torch.as_tensor(limit), fifo)
    for li in range(live.shape[0]):
        want_adm, want_extra = jx_lane_tick.window_admit(
            jnp.asarray(live[li]), jnp.asarray(size[li]),
            jnp.asarray(used[li]), jnp.asarray(limit[li]), fifo=fifo,
            interpret=True)
        np.testing.assert_array_equal(adm[li].numpy(),
                                      np.asarray(want_adm) > 0.5)
        np.testing.assert_array_equal(extra[li].numpy(),
                                      np.asarray(want_extra))


# ------------------------------------------------ wrapper/registry contract
def test_cpu_tensors_go_to_the_plain_versions_without_launching():
    ops.reset_launch_counts()
    lanes = [transfer_inputs(seed=s) for s in range(2)]
    dt, month = scalars()
    args = stack_transfer(lanes)
    for a, b in zip(ops.transfer_tick(*args, dt, month, N_MONTHS),
                    ref.transfer_tick(*args, dt, month, N_MONTHS)):
        assert torch.equal(a, b)
    want, sizes, used0, limit = (torch.as_tensor(a) for a in gcs_inputs())
    for a, b in zip(ops.gcs_admit(want, sizes, used0, limit, dt, month,
                                  N_MONTHS),
                    ref.gcs_admit(want, sizes, used0, limit, dt, month,
                                  N_MONTHS)):
        assert torch.equal(a, b)
    win = [torch.as_tensor(a) for a in window_inputs(True)]
    for a, b in zip(ops.window_admit(*win, True),
                    ref.window_admit(*win, True)):
        assert torch.equal(a, b)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_registry_resolution():
    assert registry.resolve_tick_impl("auto", "cpu").name == "torch"
    assert registry.resolve_tick_impl("torch", "cpu").name == "torch"
    assert not registry.resolve_tick_impl("torch", "cpu").use_kernel
    with pytest.raises(ValueError, match="CUDA device"):
        registry.resolve_tick_impl("cuda", "cpu")
    for bad in ("jnp", "pallas", "fortran", True):
        with pytest.raises(ValueError, match="tick_impl"):
            registry.resolve_tick_impl(bad, "cpu")
    assert registry.TICK_IMPL_CHOICES == ("auto", "torch", "cuda")


def test_no_device_means_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.core.scenarios import ScenarioSpec, pack_specs
    from repro_torch.sim.batched import run_sweep_torch, simulate_packed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.resolve_tick_impl("auto")
    grid = pack_specs([ScenarioSpec(days=0.01, n_files=50)], tick=60.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_packed(grid)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_packed(grid, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_sweep_torch([ScenarioSpec(days=0.01, n_files=50)])
