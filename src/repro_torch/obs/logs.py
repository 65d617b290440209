"""Logging setup with run-id correlation, copied from ``repro.obs.logs``.

Operational chatter (sweep headers, cache status) goes through stdlib
``logging`` so it carries a timestamp, a level, and the run id that also
tags every trace span. ``setup_logging`` is the one entry point: it
configures the root handler once, returns the run id it correlated, and
aligns the global tracer's ``run_id`` so trace events and log lines
cross-reference.
"""

from __future__ import annotations

import logging
import sys
import uuid
from typing import Optional

from repro_torch.obs.trace import get_tracer

#: ``--log-level`` choices, lowercase (argparse-friendly).
LOG_LEVELS = ("debug", "info", "warning", "error")


def setup_logging(level: str = "info",
                  run_id: Optional[str] = None) -> str:
    """Configure root logging for a run; returns the run id.

    The format embeds the run id, so piped/teed logs from several runs
    stay attributable; the same id is pushed into the global tracer for
    span correlation. Idempotent per process (reconfigures handlers on
    repeat calls rather than stacking them).
    """
    rid = run_id or uuid.uuid4().hex[:8]
    logging.basicConfig(
        level=getattr(logging, level.upper()),
        format=f"%(asctime)s %(levelname)s [{rid}] %(name)s: %(message)s",
        datefmt="%H:%M:%S",
        stream=sys.stderr,
        force=True,
    )
    get_tracer().run_id = rid
    return rid


__all__ = ["LOG_LEVELS", "setup_logging"]
