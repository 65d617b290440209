"""The port's Mamba-1 selective scan against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.kernels.mamba_scan`` (its
associative-scan reference and its Pallas kernel, which always runs in
interpret mode: ``repro``'s wrapper never passes ``interpret``) and through
``repro_torch.kernels.mamba_scan``'s plain version, a loop over T. The two
sum in different orders, so the bar is 1e-4 (atol and rtol), as in
``tests/test_kernels.py``. The fused entry, ``selective_scan`` (dA and dBu
formed from u, dt, A and B), is held to ``repro``'s ``_ssm_inputs``
followed by its scan on the same weights, and bitwise to the port's own
``_ssm_inputs`` followed by the plain scan. The launch geometry that sizes
the kernel to the card is checked here too. The CUDA kernel is held
against the plain versions on a card by ``test_torch_kernels_cuda.py``.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jx_configs
from repro.kernels.mamba_scan.ops import mamba_scan as jx_scan
from repro.models import ssm as jx_ssm
from repro.models.model import init_params as jx_init_params
from repro.models.ssm import ssm_scan_y
from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import ops, ref
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401


def scan_inputs(B, T, D, N, seed):
    rng = np.random.default_rng(seed)
    dA = np.exp(-rng.random((B, T, D, N))).astype(np.float32)
    dBu = rng.normal(size=(B, T, D, N)).astype(np.float32) * 0.1
    C = rng.normal(size=(B, T, N)).astype(np.float32)
    return dA, dBu, C


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("B,T,D,N", [
    (1, 64, 128, 8),
    (2, 300, 130, 16),   # unaligned to the Pallas chunk and block
    (1, 512, 256, 16),
])
def test_scan_matches_repro(B, T, D, N, use_pallas):
    arrays = scan_inputs(B, T, D, N, T + D)
    want = jx_scan(*map(jnp.asarray, arrays), use_pallas=use_pallas)
    got = ops.mamba_scan(*map(torch.as_tensor, arrays))
    assert got.dtype == torch.float32 and got.shape == (B, T, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("B,T,D,N", [(2, 300, 130, 16), (1, 2048, 16, 4)])
def test_final_state_matches_repro(B, T, D, N):
    """``return_state`` gives the state after the last step, ``repro``'s
    ``ssm_scan_y(...)[1]`` (the prefill's SSM cache): by its associative
    scan, and at T = 2048 by its chunked scan (``force_chunk``)."""
    arrays = scan_inputs(B, T, D, N, 11 * T)
    want_y, want_h = ssm_scan_y(*map(jnp.asarray, arrays),
                                force_chunk=T >= 2048)
    got_y, got_h = ref.mamba_scan(*map(torch.as_tensor, arrays),
                                  return_state=True)
    assert got_h.shape == (B, D, N) and got_h.dtype == torch.float32
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-4,
                               rtol=1e-4)
    y, h = ops.mamba_scan(*map(torch.as_tensor, arrays), return_state=True)
    assert torch.equal(y, got_y) and torch.equal(h, got_h)
    assert torch.equal(ops.mamba_scan(*map(torch.as_tensor, arrays)), got_y)


def test_scan_carry_across_chunks():
    """The state persists past the Pallas kernel's 256-step chunk: a
    constant decay and input accumulate monotonically through t = 256."""
    B, T, D, N = 1, 512, 128, 4
    dA = np.full((B, T, D, N), 0.999, np.float32)
    dBu = np.full((B, T, D, N), 0.01, np.float32)
    C = np.ones((B, T, N), np.float32)
    y = ops.mamba_scan(*map(torch.as_tensor, (dA, dBu, C)))
    assert float(y[0, 256, 0]) > float(y[0, 255, 0]) > float(y[0, 0, 0])
    for use_pallas in (False, True):
        want = jx_scan(*map(jnp.asarray, (dA, dBu, C)),
                       use_pallas=use_pallas)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4)


def test_cuda_impl_on_cpu_tensors_raises():
    arrays = [torch.as_tensor(a) for a in scan_inputs(1, 4, 8, 4, 0)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.mamba_scan(*arrays, impl="cuda")
    assert ops.launch_counts() == {"mamba_scan": 0, "selective_scan": 0}


def ssm_layer(N: int, d_model: int, dtype):
    """``repro``'s and the port's configs of a one-layer falcon_mamba_7b
    cut to ``d_model`` (d_inner twice that) and state ``N``, and layer 0's
    SSM weights of one ``repro`` init carried to the port as numpy
    (``models.convert``)."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jcfg = jx_configs.get_smoke_config("falcon_mamba_7b").replace(
        n_layers=1, d_model=d_model, ssm_state=N, dtype=jdt)
    cfg = configs.get_smoke_config("falcon_mamba_7b").replace(
        n_layers=1, d_model=d_model, ssm_state=N, dtype=dtype)
    tree = jax.tree.map(np.asarray, jax.jit(
        jx_init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(N)))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["ssm"])
    tp = params_from_numpy(cfg, tree, device="cpu")["layers"][0]["ssm"]
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("B,T,d_model,N", [
    (2, 300, 33, 16),   # T and d_inner (66) unaligned to the Pallas blocks
    (1, 77, 40, 5),
])
def test_selective_scan_matches_repro(B, T, d_model, N, use_pallas):
    """``selective_scan``'s plain version on u and the weights' dt, A, B
    and C against ``repro``'s ``_ssm_inputs`` followed by its scan, at
    1e-4."""
    jcfg, cfg, jp, tp = ssm_layer(N, d_model, torch.float32)
    rng = np.random.default_rng(T + N)
    u = rng.normal(size=(B, T, cfg.d_inner)).astype(np.float32)
    dA, dBu, Cm = jx_ssm._ssm_inputs(jp, jcfg, jnp.asarray(u))
    want = jx_scan(dA, dBu, Cm, use_pallas=use_pallas)
    dt, A, Bm, Cm = ssm._scan_params(tp, cfg, torch.from_numpy(u))
    got = ops.selective_scan(torch.from_numpy(u), dt, A, Bm, Cm)
    assert got.dtype == torch.float32 and got.shape == (B, T, cfg.d_inner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_equals_the_inputs_then_the_scan(dtype):
    """The fused entry's plain version is the port's ``_ssm_inputs`` (what
    decode uses) followed by ``ref.mamba_scan``, bitwise, y and h_T; and
    ``gated_scan`` is the D skip and the gate on it."""
    _, cfg, _, tp = ssm_layer(16, 40, dtype)
    g = torch.Generator().manual_seed(3)
    u = torch.randn(2, 57, cfg.d_inner, generator=g).to(dtype)
    z = torch.randn(2, 57, cfg.d_inner, generator=g).to(dtype)
    dA, dBu, Cm = ssm._ssm_inputs(tp, cfg, u)
    want_y, want_h = ref.mamba_scan(dA, dBu, Cm.float().contiguous(),
                                    return_state=True)
    dt, A, Bm, Cm = ssm._scan_params(tp, cfg, u)
    assert Bm.stride(-1) == 1 and not Bm.is_contiguous()  # column slices
    y, h = ops.selective_scan(u, dt, A, Bm, Cm, return_state=True)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert torch.equal(ops.selective_scan(u, dt, A, Bm, Cm), want_y)
    gated, h_gated = ssm.gated_scan(u, z, tp, cfg, dtype)
    want = ((want_y + tp["D"] * u.float())
            * torch.nn.functional.silu(z.float())).to(dtype)
    assert torch.equal(gated, want) and torch.equal(h_gated, want_h)


def test_selective_scan_cuda_impl_on_cpu_tensors_raises():
    _, cfg, _, tp = ssm_layer(5, 16, torch.float32)
    u = torch.randn(1, 4, cfg.d_inner)
    args = (u, *ssm._scan_params(tp, cfg, u))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ops.selective_scan(*args, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.selective_scan(*args, return_state=True, impl="cuda")
    assert ops.launch_counts() == {"mamba_scan": 0, "selective_scan": 0}


def _kernel_constants():
    text = (_build._KERNELS_DIR / _build.SOURCES["mamba_scan"]).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_geometry_constants_match_the_kernel():
    c = _kernel_constants()
    assert (c["kV"], c["kStages"], c["kMaxWarps"], c["kMaxSmem"],
            c["kMaxState"]) == (ops.STATES_PER_THREAD, ops.STAGES,
                                ops.MAX_WARPS, ops.MAX_SMEM, 32)


@pytest.mark.parametrize("fused,esz,want", [
    (False, 4, (13, 4)), (True, 2, (13, ops.MAX_STEPS))])
def test_geometry_at_the_served_shape(fused, esz, want):
    """hymba_1_5b's served layer (B 4, D 3200, N 16) on 132 SMs: 124
    blocks of 13 warps, one wave, no SM above ceil(1,600 / 132) = 13
    warps; the contract's ring takes 4 steps a stage (53.5 KB)."""
    assert ops.scan_geometry(4, 3200, 16, 132, fused, esz) == want
    assert ops.step_bytes(False, 104, 16, 4) == 13376


@pytest.mark.parametrize("fused", [False, True])
def test_geometry_at_falcon_widths(fused):
    assert ops.scan_geometry(1, 8192, 16, 132, fused, 2) == (
        8, 7 if not fused else ops.MAX_STEPS)


@pytest.mark.parametrize("B,D,N,sms", [
    (4, 3200, 16, 132), (1, 8192, 16, 132), (2, 130, 16, 132),
    (1, 64, 5, 132), (3, 33, 32, 132), (1, 8, 1, 132), (1, 1000, 16, 132),
    (8, 3200, 16, 132), (64, 8192, 32, 132), (1, 1, 17, 1), (5, 777, 3, 7),
])
@pytest.mark.parametrize("fused,esz", [(False, 4), (True, 2), (True, 4)])
def test_geometry_covers_every_state_and_fits(B, D, N, sms, fused, esz):
    """Each (b, d) has G = 2^group_log2(N) threads holding N states; the
    blocks' tiles cover D; the ring fits a block's shared memory; where
    blocks of at most 16 warps can hold every state at one block an SM,
    they do, with the fewest warps a block that can."""
    warps, steps = ops.scan_geometry(B, D, N, sms, fused, esz)
    g = 1 << ops.group_log2(N)
    assert g * ops.STATES_PER_THREAD >= N > (g // 2) * ops.STATES_PER_THREAD
    assert 1 <= warps <= ops.MAX_WARPS and 1 <= steps <= ops.MAX_STEPS
    tile = warps * 32 // g
    blocks = B * -(-D // tile)
    assert blocks * tile >= B * D > (blocks - B) * tile
    assert ops.STAGES * steps * ops.step_bytes(fused, tile, N, esz) \
        <= ops.MAX_SMEM
    warps_b = -(-D // (32 // g))  # warps over one b's (b, d)
    if B * -(-warps_b // ops.MAX_WARPS) <= sms:
        assert blocks <= sms
        assert warps == 1 or B * -(-warps_b // (warps - 1)) > sms


SASS = """
\t\tFunction : _ZN12_GLOBAL__N_114ms_scan_kernelILb1E13__nv_bfloat16Li2EEEvNS_8ScanArgsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
.L_x_1:
        /*0010*/                   FMUL R2, R3, R4 ;
.L_x_2:
        /*0020*/                   MUFU.EX2 R5, R2 ;
        /*0030*/                   MUFU.EX2 R6, R2 ;
        /*0040*/              @P1 BRA `(.L_x_2) ;
.L_x_3:
        /*0050*/                   MUFU.EX2 R7, R2 ;
        /*0060*/              @P2 BRA `(.L_x_3) ;
        /*0070*/              @!P0 BRA `(.L_x_1) ;
        /*0080*/                   EXIT ;
\t\tFunction : _Z3foov
        /*0000*/                   FFMA R1, R2, R3, R4 ;
        /*0010*/                   BRA 0x0 ;
"""


def test_hot_loop_reads_the_sass():
    """``_build.sass_functions`` names each function as the build log
    does, and ``hot_loop`` counts, of the innermost loops that hold an
    opcode (branches by label or by address), the one that holds it most:
    not the outer loop around them."""
    funcs = _build.sass_functions(SASS)
    assert set(funcs) == {"ms_scan_kernel<1,__nv_bfloat16,2>", "foo"}
    loop = _build.hot_loop(funcs["ms_scan_kernel<1,__nv_bfloat16,2>"],
                           "MUFU.EX2")
    assert loop == {"MUFU.EX2": 2, "BRA .L_x_2": 1}
    assert _build.hot_loop(funcs["foo"], "FFMA") == {"FFMA": 1, "BRA 0x0": 1}
    assert _build.hot_loop(funcs["foo"], "MUFU.EX2") == {}
