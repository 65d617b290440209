"""Simulation layers of the port: the batched tick program (``batched``),
the event-driven reference engine (``engine``, with ``infrastructure``,
``transfer``, ``cloud``'s bucket and ``output``'s collector), the front
door over both (``sweep``), the persistent result cache (``cache``), the
execution layer (``jobs``, ``faults``, ``runners``), the decision layer
(``decide``), and the numpy-only pieces they share (``distributions``,
``workload``), copied from ``repro.sim``."""
