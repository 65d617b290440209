"""Roofline analysis of the dry run's traced steps: the three terms
(``analysis``) and the per-rank cost of a traced step (``op_cost``)."""

from repro_torch.roofline.analysis import HW, collective_bytes, roofline_report

__all__ = ["HW", "collective_bytes", "roofline_report"]
