"""Plain PyTorch Mamba-1 selective scan, on any device.

``h_t = dA_t * h_{t-1} + dBu_t`` from ``h_{-1} = 0``, and
``y_t = sum_n C_{t,n} * h_{t,n}``; on request also the final state
``h_{T-1}``, which prefill keeps as the SSM cache. The oracle of
``csrc/mamba_scan.cu``: the CPU tests hold it against
``repro.kernels.mamba_scan.ref:10`` ``mamba_scan_ref`` (and the final
state against ``repro.models.ssm.ssm_scan_y``), and ``chip_smoke.py``
holds the kernel against it on the card. PyTorch has no associative
scan, so this walks T in order (two launches a step, every ``h_t`` kept
and read out against C at the end); the reference combines in a tree, so
the two round differently (the tests' bar is 1e-4). Under autograd
(training's backward of the kernel, ``kernels.autograd``) the loop is
T steps of autograd nodes: slow, but it is the plain version.

:func:`scan_inputs` forms dA and dBu from the recurrence's own inputs
(``repro.models.ssm._ssm_inputs``' last three lines, which the port's
``models.ssm`` calls here); :func:`selective_scan`, the plain version of
the kernel's fused entry, is it followed by :func:`mamba_scan`.
"""

from __future__ import annotations

import torch


def scan_inputs(u, dt, A, Bm):
    """``u [B, T, D]``, ``dt [B, T, D] float32``, ``A [D, N] float32``,
    ``Bm [B, T, N]`` -> ``dA = exp(dt A)`` and ``dBu = (dt u) B``, both
    ``[B, T, D, N] float32``."""
    dA = torch.exp(dt[..., None] * A)
    dBu = (dt * u.float())[..., None] * Bm.float()[..., None, :]
    return dA, dBu


def mamba_scan(dA, dBu, C, return_state: bool = False):
    """``dA, dBu [B, T, D, N] float32``, ``C [B, T, N] float32`` ->
    ``y [B, T, D] float32``, or ``(y, h [B, D, N])`` with
    ``return_state``."""
    B, T, D, N = dA.shape
    h = torch.zeros((B, D, N), dtype=torch.float32, device=dA.device)
    hs = []
    # unbind, not dA[:, t]: under autograd a step's slice would backprop
    # through a zero tensor of dA's whole shape; unbind's backward stacks
    for a, b in zip(dA.unbind(1), dBu.unbind(1)):
        h = a * h + b
        hs.append(h)
    y = ((torch.stack(hs, 1) * C[:, :, None, :]).sum(-1) if hs else
         torch.zeros((B, T, D), dtype=torch.float32, device=dA.device))
    return (y, h) if return_state else y


def selective_scan(u, dt, A, Bm, Cm, return_state: bool = False):
    """The scan of :func:`scan_inputs`' dA and dBu against ``Cm [B, T,
    N]``: ``y [B, T, D] float32``, or ``(y, h [B, D, N])`` with
    ``return_state``."""
    dA, dBu = scan_inputs(u, dt, A, Bm)
    return mamba_scan(dA, dBu, Cm.float(), return_state=return_state)
