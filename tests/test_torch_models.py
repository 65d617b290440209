"""The port's model building blocks against the JAX package's, on the CPU.

Configs: every field of the ten published and smoke configs equal to
``repro``'s (``dtype`` mapped), and the analytic parameter counts equal.
Modules in float32: the same numpy inputs and ``repro``'s own weights
(carried over by ``repro_torch.models.convert``) go through ``repro``'s
function and the port's. The port's attention runs the kernel's plain
version on the CPU, which masks by index; ``repro``'s the masked
full-score path. Both compute in float32 in other orders, so the bar is
1e-4 (atol and rtol). The same for the encoder's bidirectional
attention, cross-attention (prefill and decode's one query) and the
vision prefix of ``embed_inputs``; ``repro``'s bf16 weights, the encoder,
MoE, cross-attention and front-end projection included, carried over
exactly; every family builds, and an enc-dec batch without its encoder
input is refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jx_configs
from repro.models import attention as jx_attn
from repro.models import model as jx_model
from repro.models import modules as jx_mod
from repro.models import ssm as jx_ssm
from repro.models.model import init_params as jx_init_params
from repro_torch import configs
from repro_torch.models import attention, modules, multimodal, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import (
    FAMILIES,
    check_family,
    decode_step,
    embed_inputs,
    forward,
    init_cache,
    init_params,
    layer_windows,
    prefill,
)
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def to_torch(tree):
    """A tree of float32 jax arrays as CPU tensors."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def f32_configs(arch: str):
    return (jx_configs.get_smoke_config(arch).replace(dtype=jnp.float32),
            configs.get_smoke_config(arch).replace(dtype=torch.float32))


@pytest.mark.parametrize("arch", jx_configs.ARCHITECTURES)
def test_configs_equal_repro(arch):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(jx_configs, get)(arch)
        got = getattr(configs, get)(arch)
        assert isinstance(got, ModelConfig)
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got, f.name)
            if f.name == "dtype":
                assert DTYPES[a] is b, arch
            else:
                assert a == b, (arch, f.name)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (got.hd, got.d_inner, got.dtr) == (want.hd, want.d_inner,
                                                 want.dtr)
        assert got.layer_globals() == want.layer_globals()


def test_registry_names():
    assert configs.ARCHITECTURES == jx_configs.ARCHITECTURES
    assert configs.canonical("hymba-1.5b") == "hymba_1_5b"
    assert set(configs.all_configs()) == set(jx_configs.ARCHITECTURES)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.canonical("llama")


def test_layer_windows_follow_repro():
    for arch in ("gemma3_27b", "hymba_1_5b", "qwen3_4b"):
        cfg = configs.get_config(arch)
        want = np.asarray(jx_init_params.__globals__["layer_windows"](
            jx_configs.get_config(arch)))
        got = np.asarray(layer_windows(cfg))
        glob = np.asarray(cfg.layer_globals())
        assert (got[glob] == 0).all()
        np.testing.assert_array_equal(got[~glob], want[~glob])


def test_rms_norm_swiglu_rope_match_repro():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32) * 0.1
    close(modules.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5),
          jx_mod.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    pos = np.broadcast_to(np.arange(5) + 7, (2, 5)).astype(np.int32)
    close(modules.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
          jx_mod.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    w = [rng.normal(size=s).astype(np.float32) * 0.2
         for s in ((16, 24), (16, 24), (24, 16))]
    close(modules.swiglu(torch.from_numpy(x), *map(torch.from_numpy, w)),
          jx_mod.swiglu(jnp.asarray(x), *map(jnp.asarray, w)))


def test_rope_promotes_bf16_like_jnp():
    """bf16 ``x1 * cos`` is float32 in both frameworks, cast back once:
    the results round alike. Products rounded to bf16 before the sum
    differ from ``repro``'s on 34 of these 144 elements; the two libraries'
    float32 ``sin``/``cos`` may differ in a last bit, so up to 2 elements
    may land one bf16 ulp apart."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(1, 9, 2, 8)), jnp.bfloat16)
    pos = np.arange(100, 109, dtype=np.int32)[None]
    want = jx_mod.apply_rope(x, jnp.asarray(pos), 1e6)
    got = modules.apply_rope(
        torch.from_numpy(np.asarray(x, np.float32)).bfloat16(),
        torch.from_numpy(pos), 1e6)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert int((got != want).sum()) <= 2
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=2 ** -8)


@pytest.mark.parametrize("arch,bias", [("qwen3_4b", False),
                                       ("command_r_35b", True)])
def test_project_qkv_matches_repro(arch, bias):
    jcfg, cfg = f32_configs(arch)
    jcfg, cfg = jcfg.replace(attn_bias=bias), cfg.replace(attn_bias=bias)
    p = jx_attn.init_attention(jax.random.PRNGKey(3), jcfg)
    if bias:  # zeros at init: give the bias values that show
        p = {k: (v + 0.3 if k.startswith("b") else v) for k, v in p.items()}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    want = jx_attn._project_qkv(p, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = attention._project_qkv(to_torch(p), cfg, torch.from_numpy(x),
                                 torch.from_numpy(pos))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("window", [None, 8])
def test_prefill_attention_matches_repro(window):
    """Global and windowed prefill attention (gemma3's smoke widths, GQA
    2:1) through the kernel's plain version against ``repro``'s masked
    path."""
    jcfg, cfg = f32_configs("gemma3_27b")
    p = jx_attn.init_attention(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(3)
    T = 20
    x = rng.normal(size=(2, T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (2, T)).astype(np.int32)
    want = jx_attn.attention(p, jcfg, jnp.asarray(x), jnp.asarray(pos),
                             window=window)
    got = attention.attention(to_torch(p), cfg, torch.from_numpy(x),
                              torch.from_numpy(pos), window=window)
    assert got.shape == (2, T, cfg.d_model)
    close(got, want)


@pytest.mark.parametrize("t", [5, 13, 30])
def test_decode_attention_ring_buffer_matches_repro(t):
    """One decode step against a ring buffer of the window's length, half
    full (t 5) and wrapped (t 13, 30), new key written at slot t mod S."""
    jcfg, cfg = f32_configs("gemma3_27b")
    S = cfg.sliding_window
    p = jx_attn.init_attention(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(t)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    kv = {n: rng.normal(size=(2, S, cfg.n_kv_heads, cfg.hd)).astype(
        np.float32) for n in ("k", "v")}
    want, want_cache = jx_attn.decode_attention(
        p, jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, kv),
        jnp.int32(t), window=S)
    cache = {n: torch.from_numpy(a.copy()) for n, a in kv.items()}
    got, got_cache = attention.decode_attention(
        to_torch(p), cfg, torch.from_numpy(x), cache, t, window=S)
    close(got, want)
    for n in ("k", "v"):
        close(got_cache[n], want_cache[n])
    assert got_cache["k"] is cache["k"]  # written in place


def test_attention_softcap_raises_in_prefill():
    cfg = configs.get_smoke_config("gemma3_27b").replace(
        dtype=torch.float32, attn_logit_softcap=30.0)
    p = attention.init_attention(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="softcap"):
        attention.attention(p, cfg, x, torch.arange(4)[None])


def test_ssm_block_and_decode_step_match_repro():
    jcfg, cfg = f32_configs("falcon_mamba_7b")
    p = jx_ssm.init_ssm(jax.random.PRNGKey(6), jcfg)
    tp = to_torch(p)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 19, cfg.d_model)).astype(np.float32)
    close(ssm.ssm_block(tp, cfg, torch.from_numpy(x)),
          jax.jit(jx_ssm.ssm_block, static_argnums=1)(p, jcfg, jnp.asarray(x)))
    cache = {"h": rng.normal(size=(2, cfg.d_inner, cfg.ssm_state)).astype(
                 np.float32),
             "conv": rng.normal(size=(2, cfg.ssm_conv - 1, cfg.d_inner))
                 .astype(np.float32)}
    x1 = x[:, :1]
    want, want_cache = jax.jit(jx_ssm.ssm_decode_step, static_argnums=1)(
        p, jcfg, jnp.asarray(x1), jax.tree.map(jnp.asarray, cache))
    got, got_cache = ssm.ssm_decode_step(
        tp, cfg, torch.from_numpy(x1),
        {k: torch.from_numpy(v) for k, v in cache.items()})
    close(got, want)
    for k in ("h", "conv"):
        close(got_cache[k], want_cache[k])


def test_params_from_numpy_carries_bf16_exactly():
    jcfg = jx_configs.get_smoke_config("hymba_1_5b")
    cfg = configs.get_smoke_config("hymba_1_5b")
    tree = jax.tree.map(np.asarray, jax.jit(jx_init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(cfg, tree, device="cpu")
    assert len(params["layers"]) == cfg.n_layers
    want = tree["layers"]["attn"]["wq"][2]
    got = params["layers"][2]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    assert params["layers"][1]["ssm"]["A_log"].dtype == torch.float32
    mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), mine["layers"][0])
    assert shapes == jax.tree.map(lambda t: tuple(t.shape),
                                  params["layers"][0])


def test_encoder_attention_is_bidirectional_like_repro():
    """The encoder's self-attention (``causal=False``, RoPE on q and k, GQA
    2:1 at gemma3's smoke widths) against ``repro``'s unmasked path."""
    jcfg, cfg = f32_configs("gemma3_27b")
    p = jx_attn.init_attention(jax.random.PRNGKey(7), jcfg)
    rng = np.random.default_rng(6)
    S = 19
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    want = jx_attn.attention(p, jcfg, jnp.asarray(x), jnp.asarray(pos),
                             causal=False)
    got = attention.attention(to_torch(p), cfg, torch.from_numpy(x),
                              torch.from_numpy(pos), causal=False)
    close(got, want)
    causal = attention.attention(to_torch(p), cfg, torch.from_numpy(x),
                                 torch.from_numpy(pos))
    assert not torch.allclose(causal[:, :-1], got[:, :-1], atol=1e-3)


@pytest.mark.parametrize("T,S", [(7, 19), (21, 5), (1, 11)])
def test_cross_attention_matches_repro(T, S):
    """``encode_cross_kv`` (no RoPE) and cross-attention, T decoder
    queries against S encoder keys both ways and decode's one query (the
    plain ``decode_cross_attention`` too), at seamless's smoke widths."""
    jcfg, cfg = f32_configs("seamless_m4t_large_v2")
    p = jx_attn.init_cross_attention(jax.random.PRNGKey(8), jcfg)
    tp = to_torch(p)
    rng = np.random.default_rng(T * S)
    x = rng.normal(size=(2, T, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    want_kv = jx_attn.encode_cross_kv(p, jcfg, jnp.asarray(enc))
    got_kv = attention.encode_cross_kv(tp, cfg, torch.from_numpy(enc))
    for g, w in zip(got_kv, want_kv):
        assert g.shape == (2, S, cfg.n_kv_heads, cfg.hd)
        close(g, w)
    want = jx_attn.cross_attention(p, jcfg, jnp.asarray(x), want_kv)
    close(attention.cross_attention(tp, cfg, torch.from_numpy(x), got_kv),
          want)
    if T == 1:
        close(attention.decode_cross_attention(tp, cfg, torch.from_numpy(x),
                                                got_kv), want)


def test_vision_embed_inputs_matches_repro():
    """Patch embeddings projected ahead of the text, positions over both."""
    jcfg, cfg = f32_configs("phi_3_vision_4_2b")
    rng = np.random.default_rng(9)
    fe = rng.normal(size=(2, cfg.frontend_tokens, cfg.frontend_dim)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    params = {"embed": rng.normal(size=(cfg.vocab_size, cfg.d_model)),
              "frontend_proj": rng.normal(size=(cfg.frontend_dim,
                                                cfg.d_model)) * 0.1}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    want_x, want_pos = jx_model.embed_inputs(
        jcfg, jax.tree.map(jnp.asarray, params),
        {"tokens": jnp.asarray(tokens), "frontend": jnp.asarray(fe)})
    x, pos = embed_inputs(
        cfg, {k: torch.from_numpy(v) for k, v in params.items()},
        {"tokens": torch.from_numpy(tokens), "frontend": torch.from_numpy(fe)})
    assert x.shape == (2, cfg.frontend_tokens + 5, cfg.d_model)
    close(x, want_x)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    # text alone (ServeLoop feeds tokens only): no prefix
    x, pos = embed_inputs(cfg, {k: torch.from_numpy(v)
                                for k, v in params.items()},
                          {"tokens": torch.from_numpy(tokens)})
    assert x.shape == (2, 5, cfg.d_model) and int(pos.max()) == 4


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "arctic_480b",
                                  "phi_3_vision_4_2b",
                                  "seamless_m4t_large_v2"])
def test_params_from_numpy_carries_every_family_bf16_exactly(arch):
    """``repro``'s bf16 tree of each new family: the encoder's layers
    split like the decoder's, the MoE experts, router (float32) and
    arctic's dense residual MLP, cross-attention and the front-end
    projection, each leaf bit for bit and of the port's own init's
    shapes."""
    jcfg = jx_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    tree = jax.tree.map(np.asarray, jax.jit(jx_init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(cfg, tree, device="cpu")
    mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree.map(lambda a: (tuple(a.shape), a.dtype), t)  # noqa: E731
    assert shapes(params) == shapes(mine)
    stacks = [(params["layers"], tree["layers"])]
    if cfg.is_enc_dec:
        assert "cross" in params["layers"][0]
        stacks.append((params["encoder"]["layers"],
                       tree["encoder"]["layers"]))
    for layers, stacked in stacks:
        for i, layer in enumerate(layers):
            for path, leaf in jax.tree_util.tree_flatten_with_path(layer)[0]:
                want = stacked
                for key in path:
                    want = want[key.key]
                np.testing.assert_array_equal(leaf.float().numpy(),
                                              want[i].astype(np.float32))
    if cfg.frontend is not None:
        np.testing.assert_array_equal(
            params["frontend_proj"].float().numpy(),
            tree["frontend_proj"].astype(np.float32))
    if cfg.family == "moe":
        moe_p = params["layers"][0]["moe"]
        assert moe_p["router"].dtype == torch.float32
        assert moe_p["w_gate"].dtype == torch.bfloat16
        assert ("dense_mlp" in moe_p) == bool(cfg.moe_dense_ff)


@pytest.mark.parametrize("arch", jx_configs.ARCHITECTURES)
def test_every_family_builds_on_the_cpu(arch):
    """Weights, a cache, prefill and a decode step for every config's
    smoke widths (the front ends' inputs from ``models.multimodal``)."""
    cfg = configs.get_smoke_config(arch).replace(dtype=torch.float32)
    check_family(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 6),
                                     generator=gen)}
    fe = 0
    if cfg.frontend == "vision":
        batch["frontend"] = multimodal.synthetic_frontend(cfg, gen, 2)
        fe = cfg.frontend_tokens
        shape, dtype = multimodal.frontend_spec(cfg, 2, fe)
        assert batch["frontend"].shape == shape
        assert batch["frontend"].dtype == dtype
    if cfg.is_enc_dec:
        batch["enc_input"] = multimodal.synthetic_frames(cfg, gen, 2, 5)
    cache = init_cache(cfg, 2, 8 + fe, device="cpu")
    assert ("cross_kv" in cache) == cfg.is_enc_dec
    logits, cache = prefill(cfg, params, batch, cache)
    assert logits.shape == (2, cfg.vocab_size)
    if cfg.is_enc_dec:
        assert len(cache["cross_kv"]) == cfg.n_layers
        assert cache["cross_kv"][0][0].shape == (2, 5, cfg.n_kv_heads, cfg.hd)
    step, _ = decode_step(cfg, params, logits.argmax(-1)[:, None], cache,
                          6 + fe)
    assert bool(torch.isfinite(step).all())


def test_unknown_family_and_missing_inputs_raise():
    cfg = configs.get_smoke_config("seamless_m4t_large_v2").replace(
        dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = {"tokens": torch.zeros(1, 3, dtype=torch.long)}
    for fn in (lambda: prefill(cfg, params, tokens,
                               init_cache(cfg, 1, 8, device="cpu")),
               lambda: forward(cfg, params, tokens)):
        with pytest.raises(ValueError, match="enc_input"):
            fn()
    with pytest.raises(ValueError, match="prefill"):
        decode_step(cfg, params, tokens["tokens"][:, :1],
                    init_cache(cfg, 1, 8, device="cpu"), 0)
    with pytest.raises(ValueError, match="unknown family"):
        init_params(cfg.replace(family="moe-ish"), device="cpu")
    with pytest.raises(ValueError, match="vision"):
        multimodal.synthetic_frontend(cfg, torch.Generator(), 1)
    assert set(FAMILIES) == {c.family for c in configs.all_configs().values()}


def test_entry_points_default_to_cuda():
    """Without a device the model runs on ``cuda``, and raises here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = configs.get_smoke_config("hymba_1_5b")
    for fn in (lambda: init_params(cfg), lambda: init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
