"""Attention forward (blocked online softmax, causal and sliding-window
masks, grouped-query heads), with a hand-written CUDA kernel for Hopper.

Counterpart of ``repro.kernels.flash_attention``: :func:`flash_attention`
is ``repro``'s ``ops.py:21`` (Pallas ``_attn_kernel``,
``flash_attention.py:28``). ``ops`` holds the entry point, its choice of
kernel and the kernels' launch counts, ``ref`` the plain version
(``attention_ref``), and ``csrc/`` the two kernels (float32 on split
TF32 tensor-core products, bfloat16 on ``wgmma`` fed by TMA or, at head
widths TMA cannot take, by ``cp.async`` from its producer's threads),
each built by ``nvcc`` at its first launch.
"""

from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    KERNELS,
    flash_attention,
    launch_counts,
    reset_launch_counts,
)
