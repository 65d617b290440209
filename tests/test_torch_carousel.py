"""The port's carousel tick against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.kernels.carousel_update`` (its jnp
reference and its Pallas kernel in interpret mode) and through
``repro_torch.kernels.carousel_update``'s plain version. Bars: completion
mask equal, counts exact, ``new_done`` at rtol 1e-6 (XLA may fuse the
advance into one multiply-add; the port rounds each op). The CUDA kernel
is held against the plain version on a card by
``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.carousel_update import ops as jx_ops
from repro_torch.kernels.carousel_update import ops


def carousel_inputs(n, m, seed=None):
    """``tests/test_kernels.py``'s transfer set: ``n`` transfers on ``m``
    links, 60% active, mixed link modes."""
    rng = np.random.default_rng(n + m if seed is None else seed)
    link_id = rng.integers(0, m, n).astype(np.int32)
    active = rng.random(n) < 0.6
    total = rng.exponential(1e9, n).astype(np.float32) + 1e6
    done = rng.random(n).astype(np.float32) * total
    bw = rng.uniform(1e6, 1e8, m).astype(np.float32)
    mode = rng.integers(0, 2, m).astype(np.int32)
    return link_id, active, done, total, bw, mode


@pytest.mark.parametrize("tick_impl", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("n,m", [(64, 3), (1000, 17), (2049, 33)])
@pytest.mark.parametrize("dt", [1.0, 10.0])
def test_carousel_tick_matches_repro(n, m, dt, tick_impl):
    arrays = carousel_inputs(n, m)
    want = jx_ops.carousel_tick(*map(jnp.asarray, arrays), dt,
                                tick_impl=tick_impl)
    got = ops.carousel_tick(*map(torch.as_tensor, arrays), dt)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bool


def test_carousel_tick_property_matches_repro():
    """``tests/test_property.py:117``'s property, the port's plain version
    against ``repro``'s jnp reference on random transfer sets."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=30, deadline=None)
    @hypothesis.given(st.integers(1, 400), st.integers(1, 12),
                      st.integers(0, 2**31 - 1), st.floats(0.5, 20.0))
    def prop(n, m, seed, dt):
        rng = np.random.default_rng(seed)
        total = rng.exponential(1e8, n).astype(np.float32) + 1e3
        arrays = (rng.integers(0, m, n).astype(np.int32),
                  rng.random(n) < 0.5,
                  rng.random(n).astype(np.float32) * total, total,
                  rng.uniform(1e3, 1e7, m).astype(np.float32),
                  rng.integers(0, 2, m).astype(np.int32))
        want = jx_ops.carousel_tick(*map(jnp.asarray, arrays), dt,
                                    tick_impl="jnp")
        got = ops.carousel_tick(*map(torch.as_tensor, arrays), dt)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))

    prop()


def test_carousel_tick_scalar_semantics():
    """The Python event engine's per-transfer rate
    (``test_kernels.py:32``): a shared link splits its bandwidth."""
    link_id = torch.tensor([0, 0, 1], dtype=torch.int32)
    active = torch.tensor([True, True, True])
    done = torch.zeros(3)
    total = torch.full((3,), 100.0)
    bw = torch.tensor([10.0, 8.0])
    mode = torch.tensor([0, 1], dtype=torch.int32)  # shared, throughput
    nd, comp, counts = ops.carousel_tick(link_id, active, done, total, bw,
                                         mode, 2.0)
    # link 0 shared: 10/2 x 2 s = 10 bytes each; link 1: 8 x 2 = 16
    assert nd.tolist() == [10.0, 10.0, 16.0]
    assert not bool(comp.any())
    assert counts.tolist() == [2.0, 1.0]


def test_carousel_tick_inactive_transfers_hold():
    """An inactive transfer neither advances, completes nor counts on its
    link, even when it is already complete."""
    link_id, active, done, total, bw, mode = (
        torch.as_tensor(a) for a in carousel_inputs(500, 7, seed=3))
    done = torch.where(torch.arange(500) % 5 == 0, total, done)
    nd, comp, counts = ops.carousel_tick(link_id, active, done, total, bw,
                                         mode, 10.0)
    assert torch.equal(nd[~active], done[~active])
    assert not bool(comp[~active].any())
    want = torch.bincount(link_id[active].long(), minlength=7)
    assert torch.equal(counts, want.to(torch.float32))
    assert bool(comp[active].any())


def test_simulate_ticks_matches_repro():
    arrays = carousel_inputs(1000, 17, seed=11)
    act_j, done_j, comp_j = jx_ops.simulate_ticks(
        *map(jnp.asarray, arrays), 10.0, n_ticks=50)
    act, done, comp = ops.simulate_ticks(
        *map(torch.as_tensor, arrays), 10.0, 50, device="cpu")
    np.testing.assert_array_equal(act.numpy(), np.asarray(act_j))
    np.testing.assert_array_equal(comp.numpy(), np.asarray(comp_j))
    assert comp.dtype == torch.int32 and comp.shape == (50,)
    assert int(comp.sum()) > 0
    np.testing.assert_allclose(done.numpy(), np.asarray(done_j), rtol=1e-6,
                               atol=0)


def test_simulate_ticks_zero_ticks():
    arrays = [torch.as_tensor(a) for a in carousel_inputs(64, 3)]
    act, done, comp = ops.simulate_ticks(*arrays, 1.0, 0, device="cpu")
    assert torch.equal(act, arrays[1]) and torch.equal(done, arrays[2])
    assert comp.shape == (0,)


# ------------------------------------------------------------ device rule
def test_simulate_ticks_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = [torch.as_tensor(a) for a in carousel_inputs(64, 3)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.simulate_ticks(*arrays, 1.0, 2)


@pytest.mark.parametrize("entry", ["carousel_tick", "simulate_ticks"])
def test_cuda_impl_on_cpu_tensors_raises(entry):
    arrays = [torch.as_tensor(a) for a in carousel_inputs(64, 3)]
    with pytest.raises(ValueError, match="CUDA"):
        if entry == "carousel_tick":
            ops.carousel_tick(*arrays, 1.0, tick_impl="cuda")
        else:
            ops.simulate_ticks(*arrays, 1.0, 2, tick_impl="cuda",
                               device="cpu")
    assert ops.launch_counts() == {"carousel_tick": 0}


def test_cpu_calls_count_no_launch():
    ops.reset_launch_counts()
    arrays = [torch.as_tensor(a) for a in carousel_inputs(64, 3)]
    ops.carousel_tick(*arrays, 1.0)
    ops.simulate_ticks(*arrays, 1.0, 3, device="cpu")
    assert ops.launch_counts() == {"carousel_tick": 0}
