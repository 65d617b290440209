"""The port's training path against the JAX package's, on the CPU.

Loss and gradients: the same numpy batch and float32 weights drawn
with numpy in ``repro``'s tree (carried to the port by
``repro_torch.models.convert``) through
``jax.value_and_grad(repro.models.loss_fn)`` and the port's
``train.train_step.value_and_grad`` on six families' smoke configs (the
MoE aux loss, the vision prefix and the encoder's frames included). The
port's attention and scan are the kernels' plain versions here; the
scan walks T in order where ``repro`` combines in a tree, so the bar on
each gradient leaf is ``1e-4 x max(1, max |g_ref|)`` (the scan tests'
bar), on the loss rtol 1e-5. The optimizers over three steps against
``repro``'s: float32 within 1e-6; bf16 parameters equal but for one-ulp
flips where the two round a float32 update on either side of a bf16
boundary, their count asserted small. The port's own invariants: remat
on and off, two microbatches and one, the kernel route's autograd
wrapper (the plain version standing in for the launch) against plain
autograd, and a kernel entry refusing inputs that require grad. The
train driver on the CPU against a loop of ``jax.value_and_grad`` and
``repro``'s AdamW on the same pipeline batches. Each JAX function is
jitted once per config and shape for the module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jx_configs
from repro.data.pipeline import SyntheticCorpus as JxCorpus
from repro.data.pipeline import TokenPipeline as JxPipeline
from repro.launch.train import make_store as jx_make_store
from repro.models import model as jx_model
from repro.models import modules as jx_mod
from repro.train import optimizer as jx_opt
from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.mamba_scan import ref as ms_ref
from repro_torch.launch import train as train_mod
from repro_torch.models import init_params, modules
from repro_torch.models.convert import (
    params_from_numpy,
    params_to_numpy,
    stack_layers,
    tree_leaves,
    tree_map,
    unstack_layers,
)
from repro_torch.parallel.sharding import ParallelPlan, plan_for
from repro_torch.train import optimizer
from repro_torch.train.train_step import make_train_step, value_and_grad
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("qwen3_4b", "hymba_1_5b", "falcon_mamba_7b", "olmoe_1b_7b",
         "phi_3_vision_4_2b", "seamless_m4t_large_v2")
B, T, ENC_FRAMES = 2, 12, 6  # T past hymba's smoke window of 8


def f32_configs(arch: str):
    return (jx_configs.get_smoke_config(arch).replace(dtype=jnp.float32),
            configs.get_smoke_config(arch).replace(dtype=torch.float32))


def np_batch(jcfg, seed: int = 0, t: int = T):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, t + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.frontend == "vision":
        batch["frontend"] = rng.standard_normal(
            (B, jcfg.frontend_tokens, jcfg.frontend_dim)).astype(np.float32)
    if jcfg.is_enc_dec:
        batch["enc_input"] = rng.standard_normal(
            (B, ENC_FRAMES, jcfg.frontend_dim)).astype(np.float32)
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def np_params(jcfg, seed: int = 0):
    """Weights for ``repro``'s tree of ``jcfg`` (its shapes and dtypes from
    ``jax.eval_shape`` of its init, nothing compiled) drawn with numpy:
    N(0, 0.1) everywhere, norms and biases included, so every leaf has a
    gradient of its own; numpy arrays (bf16 as ``ml_dtypes``')."""
    shapes = jax.eval_shape(
        lambda: jx_model.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: np.asarray(jnp.asarray(
            0.1 * rng.standard_normal(s.shape), np.float32).astype(s.dtype)),
        shapes)


_JX_GRAD = {}


def jx_value_and_grad(jcfg):
    """``jax.value_and_grad(repro.models.loss_fn)``, jitted once a config."""
    if jcfg not in _JX_GRAD:
        _JX_GRAD[jcfg] = jax.jit(jax.value_and_grad(
            lambda p, b: jx_model.loss_fn(jcfg, p, b), has_aux=True))
    return _JX_GRAD[jcfg]


@pytest.fixture(scope="module")
def reference():
    """Per arch: ``repro``'s float32 weights as numpy, the batch, and its
    loss, parts and gradients (computed once for the module)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, _ = f32_configs(arch)
            params = np_params(jcfg)
            batch = np_batch(jcfg)
            (loss, parts), grads = jx_value_and_grad(jcfg)(params, batch)
            cache[arch] = (params, batch, float(loss),
                           jax.tree.map(float, parts),
                           jax.tree.map(np.asarray, grads))
        return cache[arch]

    return get


def assert_grads_close(got_np, want_np):
    """Each leaf's max abs difference within 1e-4 x max(1, max |g_ref|)."""
    flat_w = jax.tree_util.tree_flatten_with_path(want_np)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got_np)[0])
    assert len(flat_g) == len(flat_w)
    for path, want in flat_w:
        got = flat_g[path]
        assert got.shape == want.shape, path
        bar = 1e-4 * max(1.0, float(np.abs(want).max()))
        diff = float(np.abs(got - want).max())
        assert diff <= bar, (jax.tree_util.keystr(path), diff, bar)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_repro(reference, arch):
    params_np, batch, loss, parts, grads = reference(arch)
    _, cfg = f32_configs(arch)
    params = params_from_numpy(cfg, params_np, "cpu")
    got, got_parts, got_grads = value_and_grad(cfg, params, to_torch(batch))
    np.testing.assert_allclose(float(got), loss, rtol=1e-5)
    np.testing.assert_allclose(float(got_parts["ce"]), parts["ce"], rtol=1e-5)
    np.testing.assert_allclose(float(got_parts["aux"]), parts["aux"],
                               rtol=1e-5, atol=1e-7)
    if cfg.family == "moe":
        assert parts["aux"] > 0
    assert_grads_close(params_to_numpy(got_grads), grads)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_repro(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    want = jx_mod.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                     None if mask is None else jnp.asarray(mask))
    got = modules.cross_entropy_loss(
        torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    want_bf = jx_mod.cross_entropy_loss(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want_bf), rtol=1e-6)
    got32 = modules.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got32), float(want), rtol=1e-6)


# ------------------------------------------------------------ optimizers
_JX_OPT = {}


def jx_update(name):
    """``repro``'s optimizer ``name``: (init, its update jitted once)."""
    if name not in _JX_OPT:
        fn = (jx_opt.compress_gradients if name == "compress" else
              jx_opt.make_optimizer(name).update)
        _JX_OPT[name] = jax.jit(fn)
    return _JX_OPT[name]


def _opt_trees(dtype, seed=7):
    """hymba's smoke weights in ``dtype`` (stacked ``[L, d]`` norms among
    them, which Adafactor factors over their layers) and three steps of
    seeded gradients of scales 1e-4 to 1, as ``repro``'s trees and the
    port's."""
    jcfg = jx_configs.get_smoke_config("hymba_1_5b").replace(dtype=dtype)
    cfg = configs.get_smoke_config("hymba_1_5b").replace(
        dtype={jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype])
    params_np = np_params(jcfg, seed)
    rng = np.random.default_rng(seed)
    grads_np = [jax.tree.map(lambda p: np.asarray(jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)
        * 10.0 ** rng.integers(-4, 1)).astype(p.dtype)), params_np)
        for _ in range(3)]
    params = params_from_numpy(cfg, params_np, "cpu")
    grads = [params_from_numpy(cfg, g, "cpu") for g in grads_np]
    return (jax.tree.map(jnp.asarray, params_np),
            [jax.tree.map(jnp.asarray, g) for g in grads_np], params, grads)


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def assert_f32_trees(got, want):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_repro_f32(name):
    jparams, jgrads, params, grads = _opt_trees(jnp.float32)
    po = optimizer.make_optimizer(name)
    jst, pst = jx_opt.make_optimizer(name).init(jparams), po.init(params)
    for jg, g in zip(jgrads, grads):
        jparams, jst = jx_update(name)(jg, jst, jparams)
        params, pst = po.update(g, pst, params)
    assert_f32_trees(params_to_numpy(params), _np32(jparams))
    if name == "adamw":
        for k in ("m", "v"):
            assert_f32_trees(params_to_numpy(pst[k]), _np32(jst[k]))
    else:
        assert_f32_trees(tree_map(lambda t: t.numpy(), pst["stats"]),
                         _np32(jst["stats"]))
    assert int(pst["step"]) == int(jst["step"]) == 3
    assert pst["step"].dtype == torch.int32


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_repro_bf16(name):
    """bf16 weights after three steps: equal but for one-ulp flips (the
    float32 update rounded on either side of a bf16 boundary)."""
    jparams, jgrads, params, grads = _opt_trees(jnp.bfloat16)
    po = optimizer.make_optimizer(name)
    jst, pst = jx_opt.make_optimizer(name).init(jparams), po.init(params)
    for jg, g in zip(jgrads, grads):
        jparams, jst = jx_update(name)(jg, jst, jparams)
        params, pst = po.update(g, pst, params)
    flips = total = 0
    for (path, w), p in zip(
            jax.tree_util.tree_flatten_with_path(jparams)[0],
            jax.tree.leaves(stack_layers(params))):
        assert p.dtype == {jnp.bfloat16: torch.bfloat16,
                           jnp.float32: torch.float32}[w.dtype.type]
        want = torch.from_numpy(np.array(w, np.float32)).to(p.dtype)
        if p.dtype == torch.bfloat16:
            bits = (p.view(torch.int16).int() - want.view(torch.int16).int())
            assert int(bits.abs().max()) <= 1, jax.tree_util.keystr(path)
            flips += int((bits != 0).sum())
            total += bits.numel()
        else:
            torch.testing.assert_close(p, want, rtol=1e-6, atol=1e-6)
    assert total > 0 and flips <= 0.01 * total, (flips, total)


def test_compress_gradients_match_repro():
    """Three steps of error feedback on a small tree with stacked layers
    (one scale a stacked leaf); ``repro``'s run eagerly: under ``jax.jit``
    XLA divides by the scale otherwise and flips a few exact halves."""
    rng = np.random.default_rng(11)
    shapes = {"embed": (5, 3), "layers": {"w": (3, 4, 6), "n": (3, 6)}}
    jgrads = [jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s).astype(np.float32)
                              * 10.0 ** rng.integers(-3, 1)),
        shapes, is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    grads = [unstack_layers(tree_map(lambda a: torch.from_numpy(np.array(a)),
                                     g)) for g in jgrads]
    assert len(grads[0]["layers"]) == 3
    jerr = err = None
    for jg, g in zip(jgrads, grads):
        jq, jerr = jx_opt.compress_gradients(jg, jerr)
        q, err = optimizer.compress_gradients(g, err)
        assert_f32_trees(params_to_numpy(q), _np32(jq))
        assert_f32_trees(params_to_numpy(err), _np32(jerr))


def test_stack_layers_roundtrip():
    _, cfg = f32_configs("seamless_m4t_large_v2")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    stacked = stack_layers(params)
    assert stacked["layers"]["attn"]["wq"].shape[0] == cfg.n_layers
    assert stacked["encoder"]["layers"]["mlp"]["w_up"].shape[0] == \
        cfg.encoder_layers
    back = unstack_layers(stacked)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)


def test_plan_for_single_card_rules():
    for arch in configs.ARCHITECTURES:
        cfg = configs.get_config(arch)
        plan = plan_for(cfg)
        big = cfg.param_count() > 200e9
        assert plan.optimizer == ("adafactor" if big else "adamw"), arch
        assert (plan.microbatches, plan.grad_accum_dtype) == (1, "bf16")
    assert plan_for(configs.get_config("arctic_480b")).optimizer == "adafactor"


# ---------------------------------------------------- the port's own rules
def _hymba_state(remat: bool):
    _, cfg = f32_configs("hymba_1_5b")
    cfg = cfg.replace(remat=remat)
    jcfg, _ = f32_configs("hymba_1_5b")
    params = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    return cfg, params, to_torch(np_batch(jcfg, seed=4))


def test_remat_gives_the_same_gradients():
    cfg, params, batch = _hymba_state(remat=False)
    loss, _, grads = value_and_grad(cfg, params, batch)
    loss_r, _, grads_r = value_and_grad(cfg.replace(remat=True), params, batch)
    assert torch.equal(loss, loss_r)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads_r)):
        assert torch.equal(a, b)


def test_microbatches_match_one_batch():
    """Two microbatches (float32 sums) against one: the loss, the grad
    norm, and AdamW's first moment after one step (0.1 x the gradients)."""
    cfg, params, batch = _hymba_state(remat=False)
    out = {}
    for n in (1, 2):
        plan = ParallelPlan(microbatches=n, grad_accum_dtype="f32")
        step = make_train_step(cfg, plan)
        state = optimizer.make_optimizer("adamw").init(params)
        out[n] = step(params, state, batch)
    (_, s1, m1), (_, s2, m2) = out[1], out[2]
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(m2["grad_norm"], m1["grad_norm"], rtol=1e-5,
                               atol=0)
    assert_grads_close(params_to_numpy(s2["m"]), params_to_numpy(s1["m"]))


def test_kernel_route_backward_is_plain_autograd():
    """The kernel routes' autograd wrapper, with the plain version standing
    in for the launch: outputs and gradients bitwise plain autograd's,
    B and C as strided column slices of one projection."""
    g = torch.Generator().manual_seed(9)

    def leaf(*shape):
        return torch.randn(shape, generator=g).requires_grad_(True)

    q, k, v = leaf(2, 4, 10, 8), leaf(2, 2, 10, 8), leaf(2, 2, 10, 8)
    w = torch.randn(2, 4, 10, 8, generator=g)
    for causal, window in ((True, 3), (False, 0)):
        got = fa_ops._kernel_route(
            q, k, v, causal, window,
            launch=lambda *a: fa_ref.attention(*a[:3], causal=a[3],
                                               window=a[4]))
        assert got.grad_fn is not None
        want = fa_ref.attention(q, k, v, causal=causal, window=window)
        assert torch.equal(got, want)
        ga = torch.autograd.grad((got * w).sum(), (q, k, v))
        gb = torch.autograd.grad((want * w).sum(), (q, k, v))
        for a, b in zip(ga, gb):
            assert torch.equal(a, b)

    u, dt = leaf(2, 7, 6), torch.rand(2, 7, 6, generator=g).requires_grad_()
    A = (-torch.rand(6, 4, generator=g)).requires_grad_()
    dbc = leaf(2, 7, 3 + 2 * 4)
    Bm, Cm = dbc[..., 3:7], dbc[..., 7:]
    assert Bm.stride(1) != Bm.shape[2]
    inputs = (u, dt, A, dbc)
    for return_state in (False, True):
        got = ms_ops._selective_route(
            u, dt, A, Bm, Cm, return_state,
            launch=lambda *a: ms_ref.selective_scan(*a[:5],
                                                    return_state=a[5]))
        want = ms_ref.selective_scan(u, dt, A, Bm, Cm,
                                     return_state=return_state)
        got = got if return_state else (got,)
        want = want if return_state else (want,)
        assert all(o.grad_fn is not None for o in got)
        loss_a = sum((o * (i + 1)).sum() for i, o in enumerate(got))
        loss_b = sum((o * (i + 1)).sum() for i, o in enumerate(want))
        for a, b in zip(torch.autograd.grad(loss_a, inputs),
                        torch.autograd.grad(loss_b, inputs)):
            assert torch.equal(a, b)
    # a grad that reaches only the final state
    _, h = ms_ops._selective_route(
        u, dt, A, Bm, Cm, True,
        launch=lambda *a: ms_ref.selective_scan(*a[:5], return_state=a[5]))
    _, h_ref = ms_ref.selective_scan(u, dt, A, Bm, Cm, return_state=True)
    for a, b in zip(torch.autograd.grad(h.sum(), inputs),
                    torch.autograd.grad(h_ref.sum(), inputs)):
        assert torch.equal(a, b)


def test_kernel_launch_refuses_inputs_that_require_grad():
    t = torch.zeros(3, requires_grad=True)
    cpu = torch.device("cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        _build.check_tensor("x", t, torch.float32, (3,), cpu)
    with torch.no_grad():
        _build.check_tensor("x", t, torch.float32, (3,), cpu)
    _build.check_tensor("x", t.detach(), torch.float32, (3,), cpu)


# ----------------------------------------------------------- the driver
def test_train_driver_matches_repro_loop(monkeypatch):
    """``launch.train.train(..., device="cpu")`` on hymba_1_5b's smoke
    config (float32, ``repro``'s weights) gives the losses of a loop of
    ``jax.value_and_grad`` and ``repro``'s AdamW on the same pipeline's
    batches (``repro``'s own ``TokenPipeline`` and store)."""
    steps = 3
    jcfg, cfg = f32_configs("hymba_1_5b")
    params_np = np_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, params_np)
    monkeypatch.setattr(train_mod, "get_smoke_config", lambda arch: cfg)
    monkeypatch.setattr(train_mod, "init_params",
                        lambda c, gen, dev: params_from_numpy(c, params_np,
                                                              dev))
    out = train_mod.train("hymba_1_5b", steps=steps, batch=B, seq=T,
                          log_every=100, device="cpu")

    grad_fn = jx_value_and_grad(jcfg)
    state = jx_opt.adamw().init(jparams)
    corpus = JxCorpus(jcfg.vocab_size, T, B, n_shards=4 * steps)
    pipeline = JxPipeline(corpus, store=jx_make_store(), epochs=4)
    want = []
    for _ in range(steps):
        batch = {k: jnp.asarray(v) for k, v in next(pipeline).items()}
        (loss, _), grads = grad_fn(jparams, batch)
        jparams, state = jx_update("adamw")(grads, state, jparams)
        want.append(float(loss))
    np.testing.assert_allclose(out["losses"], want, rtol=1e-5)
    assert out["store_stats"] == pipeline.store.stats
