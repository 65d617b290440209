"""The HCDC model of the port (copies of ``repro.core``): scenario
configuration and the event-driven scenario (``hcdc``), the carousel
window (``carousel``), hot/cold policies (``hotcold``), the §4.2
validation scenario (``validation``), the §6 planner (``planner``), and
scenario specs with grid packing (``scenarios``)."""
