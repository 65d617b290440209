"""Mamba-1 selective SSM block (falcon-mamba; hymba's SSM heads), the
port's counterpart of ``repro.models.ssm``.

Structure: in_proj -> (x, z); causal depthwise conv1d + silu on x;
x -> (dt_low, B, C); dt = softplus(dt_proj(dt_low)); A = -exp(A_log);
recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t; y_t = C_t . h_t + D x_t;
out = (y * silu(z)) @ out_proj.

The recurrence over the prompt runs in
``repro_torch.kernels.mamba_scan.selective_scan`` (the hand-written Hopper
kernel on the card, which forms dA and dBu in registers from dt, A, B and
u; its plain version on the CPU or with ``impl="torch"``), which also
returns the final state that prefill keeps as the cache (what ``repro``'s
``ssm_scan_y`` returns beside y). Decode keeps h as explicit state ([B,
d_inner, N]) and applies one recurrence step in plain PyTorch, as
``repro`` does, on dA and dBu from ``mamba_scan.ref.scan_inputs``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.mamba_scan import selective_scan
from repro_torch.kernels.mamba_scan.ref import scan_inputs
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import dense_init
from repro_torch.parallel.ctx import reduce_partial

Params = Dict[str, torch.Tensor]


def init_ssm(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d, di, n, dtr, kc = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dtr, cfg.ssm_conv
    dev = generator.device
    # S4D-real initialisation for A: A[d, n] = -(1..n)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)[None, :].repeat(di, 1)
    return {
        "in_proj": dense_init(generator, (d, 2 * di), in_axis_size=d, dtype=cfg.dtype),
        "conv_w": dense_init(generator, (kc, di), in_axis_size=kc, dtype=cfg.dtype),
        "conv_b": torch.zeros((di,), dtype=cfg.dtype, device=dev),
        "x_proj": dense_init(generator, (di, dtr + 2 * n), in_axis_size=di, dtype=cfg.dtype),
        "dt_proj_w": dense_init(generator, (dtr, di), in_axis_size=dtr, dtype=cfg.dtype),
        "dt_proj_b": torch.full((di,), -4.6, dtype=torch.float32, device=dev),  # softplus ~= 0.01
        "A_log": torch.log(a),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(generator, (di, d), in_axis_size=di, dtype=cfg.dtype),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B, T, di]; w: [K, di]. On DTensors each
    rank convolves its own rows and channels (:func:`_sharded_conv`)."""
    if isinstance(x, DTensor):
        return _sharded_conv(x, w, b)
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for k in range(K):  # K is tiny (4): unrolled taps
        out = out + xp[:, k: k + x.shape[1], :] * w[k]
    return out + b


def _sharded_conv(x, w, b):
    """:func:`_causal_conv1d` through ``local_map``: x's batch and channel
    shards kept, its time dim gathered where sharded (the conv reads K - 1
    earlier steps), w and b sharded with the channels."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    xp, wp, bp = [], [], []
    for p in x.placements:
        chan = isinstance(p, Shard) and p.dim in (2, -1)
        xp.append(p if isinstance(p, Shard) and p.dim in (0, 2, -1)
                  else Replicate())
        wp.append(Shard(1) if chan else Replicate())
        bp.append(Shard(0) if chan else Replicate())
    x = x.redistribute(mesh, xp)
    w, b = w.redistribute(mesh, wp), b.redistribute(mesh, bp)
    return local_map(_causal_conv1d, out_placements=xp,
                     in_placements=(xp, wp, bp), device_mesh=mesh)(x, w, b)


def _scan_params(p: Params, cfg: ModelConfig, u: torch.Tensor):
    """u: [B, T, di] (post conv+silu). Returns dt [B, T, di] f32, A [di, N]
    f32 and B, C [B, T, N] (column slices of the projection, u's type)."""
    n = cfg.ssm_state
    # on a mesh, u's channels sharded leave the projection a partial sum:
    # reduced before it is split (the all-reduce of Mamba's x_proj)
    dbc = reduce_partial(u @ p["x_proj"])
    dt_low, Bm, Cm = torch.split(dbc, [cfg.dtr, n, n], dim=-1)
    dt = F.softplus((dt_low @ p["dt_proj_w"]).float() + p["dt_proj_b"])  # [B, T, di] f32
    A = -torch.exp(p["A_log"])  # [di, N] f32
    return dt, A, Bm, Cm


def _ssm_inputs(p: Params, cfg: ModelConfig, u: torch.Tensor):
    """u: [B, T, di] (post conv+silu). Returns dA [B,T,di,N] decay, dBu, C."""
    dt, A, Bm, Cm = _scan_params(p, cfg, u)
    dA, dBu = scan_inputs(u, dt, A, Bm)
    return dA, dBu, Cm


def gated_scan(u: torch.Tensor, z: torch.Tensor, p: Params, cfg: ModelConfig,
               dtype, impl: str = "auto"):
    """The block from the conv's output on: ``u`` [B, T, di] (post
    conv+silu), ``z`` the gate. Returns the gated ``y`` [B, T, di] in
    ``dtype`` and the final state ``h`` [B, di, N] (float32)."""
    dt, A, Bm, Cm = _scan_params(p, cfg, u)
    y, h = selective_scan(u.contiguous(), dt, A, Bm, Cm, return_state=True,
                          impl=impl)
    y = y + p["D"] * u.float()
    return (y * F.silu(z.float())).to(dtype), h


def ssm_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
              impl: str = "auto") -> torch.Tensor:
    """x: [B, T, d] -> [B, T, d]."""
    u, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    u = F.silu(_causal_conv1d(u, p["conv_w"], p["conv_b"]))
    y, _ = gated_scan(u, z, p, cfg, x.dtype, impl)
    return y @ p["out_proj"]


# ----------------------------------------------------------------- decode
def init_ssm_cache(cfg: ModelConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=cfg.dtype,
                            device=device),
    }


def ssm_decode_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    cache: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """x: [B, 1, d]; cache h: [B, di, N], conv: [B, K-1, di]."""
    u, z = (x @ p["in_proj"]).chunk(2, dim=-1)  # [B, 1, di]
    # conv over the last K inputs
    hist = torch.cat([cache["conv"], u], dim=1)  # [B, K, di]
    u_c = (hist * p["conv_w"]).sum(1) + p["conv_b"]
    u_c = F.silu(u_c)[:, None, :]  # [B, 1, di]
    new_conv = hist[:, 1:, :]
    dA, dBu, Cm = _ssm_inputs(p, cfg, u_c)
    h = dA[:, 0] * cache["h"] + dBu[:, 0]  # [B, di, N]
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())
    y = y + p["D"] * u_c[:, 0].float()
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"h": h, "conv": new_conv}
