"""Scenario configuration and grid packing of the port (copies of
``repro.core``'s config half and ``repro.core.scenarios``)."""
