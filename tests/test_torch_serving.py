"""The port's serving path against the JAX package's, on the CPU.

``repro``'s weights (``init_params``, carried over by
``repro_torch.models.convert``) and the same numpy prompts go through
``repro``'s ``prefill`` and four greedy ``decode_step``s and through the
port's, on the smoke configs of qwen3_4b (dense, qk-norm), gemma3_27b
(ring buffers shorter than the prompt), falcon_mamba_7b (ssm), hymba_1_5b
(hybrid), olmoe_1b_7b and arctic_480b (MoE at the default capacity
factor; arctic with its dense residual MLP), phi_3_vision_4_2b (seeded
patch embeddings ahead of the prompt, decode from position T plus the
prefix) and seamless_m4t_large_v2 (the encoder over seeded frames, and
cross-attention), as ``tests/test_serving.py`` feeds them. The port's
prefill runs the attention and scan kernels' plain versions here. Bars:
in float32 the logits and each layer's cache (an enc-dec layer's cross
keys and values too) at 1e-4 (atol and rtol; sums in other orders) and
the greedy tokens equal; in bfloat16 the logits within ``repro``'s own
serving bar, 0.15 (``tests/test_serving.py``): ``repro`` rounds the
attention weights to bfloat16 before the values, the port keeps them in
float32. Then the port's ``ServeLoop`` against ``repro``'s (tokens
equal), and the launch command on the CPU. ``repro``'s runs are made
once per arch (a module-scoped fixture) and shared by the float32 and
bfloat16 tests.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jx_configs
from repro.models import decode_step as jx_decode_step
from repro.models import init_cache as jx_init_cache
from repro.models import init_params as jx_init_params
from repro.models import prefill as jx_prefill
from repro.serve.engine import Request as JxRequest
from repro.serve.engine import ServeLoop as JxServeLoop
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import decode_step, forward, init_cache, prefill
from repro_torch.models.convert import cache_to_numpy, params_from_numpy
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.serve.engine import Request, ServeLoop
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["qwen3_4b", "gemma3_27b", "falcon_mamba_7b", "hymba_1_5b",
         "olmoe_1b_7b", "arctic_480b", "phi_3_vision_4_2b",
         "seamless_m4t_large_v2"]
B, T, STEPS, MAX_LEN = 2, 16, 4, 24
#: Encoder frames of the enc-dec config.
ENC_FRAMES = 16
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_BAR = 0.15
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def repro_layers(cfg, cache):
    """``repro``'s cache as one numpy dictionary a layer (its uniform
    archs stack the layers on a leading axis), an enc-dec layer's with its
    cross ``(k, v)`` under ``"cross_kv"``, as ``cache_to_numpy`` gives
    the port's."""
    layers = jax.tree.map(f32, cache["layers"])
    if not isinstance(layers, list):
        layers = [jax.tree.map(lambda a, i=i: a[i], layers)
                  for i in range(cfg.n_layers)]
    if cfg.is_enc_dec:
        k, v = cache["cross_kv"]
        for i, entry in enumerate(layers):
            entry["cross_kv"] = (f32(k[i]), f32(v[i]))
    return layers


def front_inputs(cfg) -> dict:
    """The stub front ends' inputs as ``tests/test_serving.py`` gives them
    (seeded float32 numpy arrays; each model casts them): patch
    embeddings for a vision config, encoder frames for an enc-dec one."""
    rng = np.random.default_rng(cfg.frontend_dim)
    out = {}
    if cfg.frontend == "vision":
        out["frontend"] = rng.normal(
            size=(B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.is_enc_dec:
        out["enc_input"] = rng.normal(
            size=(B, ENC_FRAMES, cfg.frontend_dim)).astype(np.float32)
    return out


def prefix(cfg) -> int:
    """Positions the vision prefix takes ahead of the prompt."""
    return cfg.frontend_tokens if cfg.frontend == "vision" else 0


def repro_params(jcfg, f32_params):
    """``repro``'s weights for ``jcfg`` from the float32 config's: each
    leaf cast to the type ``init_params`` gives it (its inits draw in
    float32 and cast, so this is the same tree), one compile fewer."""
    dtypes = jax.eval_shape(functools.partial(jx_init_params, jcfg),
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda a, s: a.astype(s.dtype), f32_params, dtypes)


def repro_run(arch: str, dtype: str, f32_params=None):
    """``repro``'s prefill and STEPS greedy decode steps, with its weights
    and prompt as numpy arrays."""
    jcfg = jx_configs.get_smoke_config(arch).replace(dtype=DTYPES[dtype][0])
    params = (jax.jit(jx_init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)) if f32_params is None else
        repro_params(jcfg, f32_params))
    tokens = np.random.default_rng(len(arch)).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)
    front = front_inputs(jcfg)
    logits, cache = jax.jit(functools.partial(jx_prefill, jcfg))(
        params, {"tokens": jnp.asarray(tokens),
                 **jax.tree.map(jnp.asarray, front)},
        jx_init_cache(jcfg, B, MAX_LEN + prefix(jcfg)))
    out = {"jax_params": params,
           "params": jax.tree.map(np.asarray, params), "tokens": tokens,
           "front": front,
           "logits": [f32(logits)], "caches": [repro_layers(jcfg, cache)],
           "greedy": []}
    step = jax.jit(functools.partial(jx_decode_step, jcfg))
    for i in range(STEPS):
        nt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        out["greedy"].append(np.asarray(nt))
        logits, cache = step(params, nt, cache,
                             jnp.int32(T + prefix(jcfg) + i))
        out["logits"].append(f32(logits))
    out["caches"].append(repro_layers(jcfg, cache))
    return out


def port_run(arch: str, dtype: str, want: dict):
    """The port's prefill and decode steps on ``repro``'s weights, prompt
    and greedy tokens; returns logits, caches and its own greedy picks."""
    cfg = configs.get_smoke_config(arch).replace(dtype=DTYPES[dtype][1])
    params = params_from_numpy(cfg, want["params"], device="cpu")
    cache = init_cache(cfg, B, MAX_LEN + prefix(cfg), device="cpu")
    batch = {"tokens": torch.from_numpy(want["tokens"]),
             **{k: torch.from_numpy(a) for k, a in want["front"].items()}}
    logits, cache = prefill(cfg, params, batch, cache)
    out = {"logits": [logits], "caches": [cache_to_numpy(cache)],
           "greedy": []}
    for i, nt in enumerate(want["greedy"]):
        out["greedy"].append(logits.argmax(-1)[:, None].numpy())
        logits, cache = decode_step(cfg, params, torch.tensor(nt), cache,
                                    T + prefix(cfg) + i)
        out["logits"].append(logits)
    out["caches"].append(cache_to_numpy(cache))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    arch = request.param
    f32_run = repro_run(arch, "float32")
    return arch, {"float32": f32_run,
                  "bfloat16": repro_run(arch, "bfloat16",
                                        f32_run["jax_params"])}


def test_serving_matches_repro_in_float32(runs):
    arch, want = runs[0], runs[1]["float32"]
    got = port_run(arch, "float32", want)
    for g, w in zip(got["logits"], want["logits"]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **F32_TOL)
    for g, w in zip(got["greedy"], want["greedy"]):
        np.testing.assert_array_equal(g, w)
    for got_layers, want_layers in zip(got["caches"], want["caches"]):
        assert len(got_layers) == len(want_layers)
        for i, (g, w) in enumerate(zip(got_layers, want_layers)):
            assert jax.tree.structure(g) == jax.tree.structure(w), i
            for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
                np.testing.assert_allclose(a, b, **F32_TOL)


def test_serving_matches_repro_in_bfloat16(runs):
    arch, want = runs[0], runs[1]["bfloat16"]
    got = port_run(arch, "bfloat16", want)
    for g, w in zip(got["logits"], want["logits"]):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        err = float(np.abs(g.float().numpy() - w).max())
        assert err < BF16_BAR, f"{arch}: logits {err} from repro's"


def test_bf16_weights_are_repro_init():
    """The cast in ``repro_params`` gives ``init_params``' own bf16 tree."""
    jcfg = jx_configs.get_smoke_config("hymba_1_5b")
    key = jax.random.PRNGKey(0)
    want = jax.jit(jx_init_params, static_argnums=0)(jcfg, key)
    f32_params = jax.jit(jx_init_params, static_argnums=0)(
        jcfg.replace(dtype=jnp.float32), key)
    got = repro_params(jcfg, f32_params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(f32(a), f32(b))


@pytest.mark.parametrize("arch", ["gemma3_27b", "hymba_1_5b", "olmoe_1b_7b",
                                  "arctic_480b", "phi_3_vision_4_2b",
                                  "seamless_m4t_large_v2"])
def test_prefill_and_decode_match_forward(arch):
    """Within the port: prefill's last logits and a decode step against
    ``forward`` over the whole sequence, the prompt longer than the ring
    buffers (float32, random weights of the port's own init; MoE dropless,
    since forward's T + 1 tokens have another capacity than prefill's T,
    as in ``tests/test_serving.py``; the vision prefix and the encoder's
    frames from ``models.multimodal``)."""
    from repro_torch.models import init_params, multimodal

    cfg = configs.get_smoke_config(arch).replace(dtype=torch.float32)
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=8.0)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen)
    batch = {"tokens": tokens[:, :T]}
    if cfg.frontend == "vision":
        batch["frontend"] = multimodal.synthetic_frontend(cfg, gen, B)
    if cfg.is_enc_dec:
        batch["enc_input"] = multimodal.synthetic_frames(cfg, gen, B,
                                                         ENC_FRAMES)
    fe = prefix(cfg)
    logits, cache = prefill(cfg, params, batch,
                            init_cache(cfg, B, MAX_LEN + fe, device="cpu"))
    step, _ = decode_step(cfg, params, tokens[:, T:], cache, T + fe)
    full, _ = forward(cfg, params, {**batch, "tokens": tokens})
    assert full.shape == (B, fe + T + 1, cfg.vocab_size)
    torch.testing.assert_close(logits, full[:, fe + T - 1], **F32_TOL)
    torch.testing.assert_close(step, full[:, fe + T], **F32_TOL)


def test_serve_loop_matches_repro():
    """hymba_1_5b's smoke config in float32: three requests of unequal
    prompts and lengths on two slots (one wave left-padded, one with an
    empty slot), tokens equal to ``repro``'s."""
    jcfg = jx_configs.get_smoke_config("hymba_1_5b").replace(
        dtype=jnp.float32)
    cfg = configs.get_smoke_config("hymba_1_5b").replace(dtype=torch.float32)
    params = jax.jit(jx_init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (12, 9, 14)]
    max_new = (4, 3, 5)
    want = JxServeLoop(jcfg, params, batch_slots=2, max_len=32).run(
        [JxRequest(rid=i, prompt=jnp.asarray(p), max_new=m)
         for i, (p, m) in enumerate(zip(prompts, max_new))])
    loop = ServeLoop(cfg, params_from_numpy(cfg, jax.tree.map(
        np.asarray, params), device="cpu"), batch_slots=2, max_len=32)
    got = loop.run([Request(rid=i, prompt=torch.from_numpy(p), max_new=m)
                    for i, (p, m) in enumerate(zip(prompts, max_new))])
    assert got == want
    assert [len(got[i]) for i in range(3)] == list(max_new)


def test_step_functions():
    cfg = configs.get_smoke_config("qwen3_4b").replace(dtype=torch.float32)
    from repro_torch.models import init_params

    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, 6),
                           generator=torch.Generator().manual_seed(1))
    logits, cache = make_prefill_step(cfg, impl="torch")(
        params, {"tokens": tokens}, init_cache(cfg, B, 8, device="cpu"))
    nxt, step_logits, _ = make_decode_step(cfg)(
        params, logits.argmax(-1)[:, None], cache, 6)
    assert nxt.shape == (B, 1)
    assert torch.equal(nxt[:, 0], step_logits.argmax(-1))
    with pytest.raises(ValueError, match="CUDA"):
        make_prefill_step(cfg, impl="cuda")(
            params, {"tokens": tokens}, init_cache(cfg, B, 8, device="cpu"))


def test_launch_serve_on_the_cpu(capsys):
    rc = launch_serve.main(["--arch", "hymba-1.5b", "--requests", "3",
                            "--max-new", "4", "--slots", "2",
                            "--device", "cpu"])
    assert rc == 0
    assert "served 3 requests / 12 tokens in" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi-3-vision-4.2b"])
def test_launch_serve_new_families_on_the_cpu(capsys, arch):
    """The MoE and the vision config through the launch command (the
    vision one on its text alone); the enc-dec one is refused, naming
    the input it lacks."""
    rc = launch_serve.main(["--arch", arch, "--requests", "3",
                            "--max-new", "4", "--slots", "2",
                            "--device", "cpu"])
    assert rc == 0
    assert "served 3 requests / 12 tokens in" in capsys.readouterr().out
    with pytest.raises(ValueError, match="enc_input"):
        launch_serve.main(["--arch", "seamless-m4t-large-v2", "--requests",
                           "1", "--device", "cpu"])
