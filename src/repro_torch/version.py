"""Version of the port, recorded in result-cache provenance manifests
(``repro_torch.sim.cache``) so a cached result can be traced back to the
code that produced it. The cache key does not include it: invalidation is
driven by ``repro_torch.core.scenarios.RESULT_SCHEMA_VERSION``, which
changes only when simulation outputs change meaning.
"""

__version__ = "0.1.0"
