"""Kernels of the port: the ``tick_impl`` registry, the nvcc build and
loader (``_build``), and the lane-tick kernels with their plain versions
(``lane_tick``)."""
