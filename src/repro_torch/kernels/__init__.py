"""Kernels of the port: the ``tick_impl`` registry, the nvcc build and
loader (``_build``), and four kernel packages, each with its plain PyTorch
version (``ref``), its entry points and launch counts (``ops``) and its
CUDA source (``csrc``), built at the first launch:

- ``lane_tick`` — the batched sweep tick's three kernels
  (``repro.kernels.lane_tick``);
- ``carousel_update`` — the standalone carousel tick and tick engine
  (``repro.kernels.carousel_update``);
- ``flash_attention`` — the attention forward
  (``repro.kernels.flash_attention``);
- ``mamba_scan`` — the Mamba-1 selective scan
  (``repro.kernels.mamba_scan``).
"""
