"""Attention forward (blocked online softmax, causal and sliding-window
masks, grouped-query heads), with a hand-written CUDA kernel for Hopper.

Counterpart of ``repro.kernels.flash_attention``: :func:`flash_attention`
is ``repro``'s ``ops.py:21`` (Pallas ``_attn_kernel``,
``flash_attention.py:28``). ``ops`` holds the entry point and the kernel's
launch count, ``ref`` the plain version (``attention_ref``), and
``csrc/flash_attention.cu`` the kernel, built by ``nvcc`` at its first
launch.
"""

from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    KERNELS,
    flash_attention,
    launch_counts,
    reset_launch_counts,
)
