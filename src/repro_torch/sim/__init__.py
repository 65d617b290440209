"""Simulation layers of the port: the batched tick program (``batched``),
its results and front door (``sweep``), the persistent result cache
(``cache``), the decision layer (``decide``), and the numpy-only pieces
they need (``cloud``, ``distributions``, ``infrastructure``, ``output``,
``transfer``, ``workload``), copied from ``repro.sim``."""
