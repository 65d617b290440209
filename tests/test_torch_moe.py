"""The port's MoE layer against the JAX package's, on the CPU.

The same numpy inputs, and ``repro``'s own weights (carried over by
``repro_torch.models.convert``), go through ``repro.models.moe`` and
``repro_torch.models.moe``. Bars: the router's gates and auxiliary loss
at 1e-6 with equal expert indices (both take a float32 softmax and the
larger probability first); dispatch bitwise on given indices (pure data
movement: every live ``(expert, slot)`` holds one token; the dead column,
where ``repro`` sums the dropped tokens and the port writes zeros, is
discarded by both combines); combine bitwise on inputs whose products
and sums are exact in float32 (small integers times dyadic gates), so the
order of the sum over k cannot show; the whole layer in float32 at 1e-5
at olmoe's and arctic's smoke widths, at the default capacity factor
where tokens drop, and dropless.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jx_configs
from repro.models import moe as jx_moe
from repro_torch import configs
from repro_torch.models import moe
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def f32_configs(arch: str, **kw):
    return (jx_configs.get_smoke_config(arch).replace(dtype=jnp.float32, **kw),
            configs.get_smoke_config(arch).replace(dtype=torch.float32, **kw))


def assignments(rng, T: int, k: int, E: int, hot: int = 0) -> np.ndarray:
    """[T, k] distinct experts a token; every token's first choice is
    ``hot`` half the time, so that expert overflows a small capacity."""
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    for t in np.flatnonzero(rng.random(T) < 0.5):
        j = int(np.flatnonzero(idx[t] == hot)[0]) if hot in idx[t] else 0
        idx[t, [0, j]] = hot, idx[t, 0]
    return idx


@pytest.mark.parametrize("T,E,k", [(40, 8, 2), (33, 64, 8), (7, 128, 2)])
def test_router_topk_matches_repro(T, E, k):
    rng = np.random.default_rng(T)
    logits = (rng.normal(size=(T, E)) * 3).astype(np.float32)
    want = jx_moe.router_topk(jnp.asarray(logits), k)
    got = moe.router_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("T,E,k,cap", [(40, 8, 2, 6), (24, 8, 2, 16),
                                       (30, 64, 8, 3)])
def test_dispatch_and_combine_bitwise_on_given_indices(T, E, k, cap, dtype):
    """Given indices with an overflowing expert (0): the same slots, the
    same live buffer and the same combined output, bit for bit."""
    rng = np.random.default_rng(T * k)
    idx = assignments(rng, T, k, E)
    x = rng.integers(-8, 9, size=(T, 16)).astype(np.float32)
    jx_x = jnp.asarray(x, dtype)
    t_x = torch.from_numpy(x).to(torch.bfloat16 if dtype is jnp.bfloat16
                                 else torch.float32)
    want_buf, _, want_p = jx_moe.moe_dispatch(jx_x, jnp.asarray(idx), cap, E)
    buf, e_sel, p_sel = moe.moe_dispatch(t_x, torch.from_numpy(idx), cap, E)
    np.testing.assert_array_equal(p_sel.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(e_sel.numpy(), idx)
    dropped = int((p_sel == cap).sum())
    assert (dropped > 0) == (cap < np.bincount(idx.ravel()).max())
    assert buf.shape == (E, cap + 1, 16) and buf.dtype == t_x.dtype
    np.testing.assert_array_equal(buf[:, :cap].float().numpy(),
                                  np.asarray(want_buf, np.float32)[:, :cap])
    assert not buf[:, cap].any()
    # expert outputs with a nonzero dead column, dyadic gates
    eo = rng.integers(-8, 9, size=(E, cap + 1, 16)).astype(np.float32)
    gates = (rng.integers(1, 5, size=(T, k)) / 8).astype(np.float32)
    want = jx_moe.moe_combine(jnp.asarray(eo, dtype), jnp.asarray(gates),
                              jnp.asarray(idx), want_p)
    got = moe.moe_combine(torch.from_numpy(eo).to(t_x.dtype),
                          torch.from_numpy(gates), e_sel, p_sel)
    assert got.dtype == t_x.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("cf", [1.25, 8.0], ids=["drops", "dropless"])
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "arctic_480b"])
def test_moe_layer_matches_repro(arch, cf):
    """The layer at the smoke widths (arctic with its dense residual MLP),
    64 tokens that share a direction, so some experts are hot: at the
    default capacity factor their late assignments drop, the same ones
    in both."""
    jcfg, cfg = f32_configs(arch, capacity_factor=cf)
    p = jx_moe.init_moe(jax.random.PRNGKey(9), jcfg)
    assert ("dense_mlp" in p) == (arch == "arctic_480b")
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(2, 32, cfg.d_model))
         + rng.normal(size=cfg.d_model)).astype(np.float32)
    want, want_aux = jx_moe.moe_layer(p, jcfg, jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    got, aux = moe.moe_layer(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6,
                               rtol=1e-6)
    # the capacity formula, and whether it drops here
    n = 2 * 32
    cap = moe.expert_capacity(cfg, n)
    assert cap == max(int((n * cfg.top_k / cfg.n_experts) * cf) + 1, 16)
    xt = torch.from_numpy(x).reshape(n, -1)
    _, idx, _ = moe.router_topk(xt @ tp["router"], cfg.top_k)
    most = int(torch.bincount(idx.reshape(-1)).max())
    assert (most > cap) == (cf == 1.25)


def test_expert_capacity_is_dropless_at_decode():
    cfg = configs.get_config("olmoe_1b_7b")
    assert moe.expert_capacity(cfg, 4) == 4  # min(B, 16): B tokens fit
    assert moe.expert_capacity(cfg, 4096) == int(4096 * 8 / 64 * 1.25) + 1
