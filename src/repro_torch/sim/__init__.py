"""Simulation layers of the port: the batched tick program (``batched``),
its results and front door (``sweep``), and the numpy-only pieces it needs
(``cloud``, ``distributions``, ``infrastructure``, ``transfer``,
``workload``), copied from ``repro.sim``."""
