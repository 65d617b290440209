"""Unit constants of the infrastructure module (``repro.sim.infrastructure``).

Only the byte units are carried over; the object-graph sites, storage
elements and links belong to the event engine, which this port does not
include.
"""

KB = 1000.0
MB = 1000.0**2
GB = 1000.0**3
TB = 1000.0**4
PB = 1000.0**5

KiB = 1024.0
MiB = 1024.0**2
GiB = 1024.0**3
TiB = 1024.0**4
