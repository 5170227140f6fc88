"""Minimal structured logging (no external deps), the reference's
``repro/utils/logging.py``.

``get_logger(name)`` returns a ``StructuredLogger``, a stdlib
``LoggerAdapter`` with one addition: ``bind(**ctx)`` returns a child
logger whose every record carries the bound context as a ``[k=v ...]``
suffix, so a grep over the logs joins with the trace-event dumps on the
same ``trace_id``::

    log = get_logger("repro_torch.serve").bind(trace_id="p0.t17")
    log.warning("deadline expired after %d epochs", 3)
    # 12:00:01 W repro_torch.serve] deadline expired after 3 epochs
    #                               [trace_id=p0.t17]

``REPRO_LOGLEVEL`` is read again on every ``get_logger`` call, so a
long-lived process, or a test, can change the level by setting the
variable and making its logger again.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FMT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"


class StructuredLogger(logging.LoggerAdapter):
    """A LoggerAdapter whose bound context renders as a ``[k=v ...]``
    record suffix. ``bind`` returns a new adapter, so one module-level
    logger can be specialised per ticket or trace without cross-talk."""

    def bind(self, **ctx) -> "StructuredLogger":
        merged = dict(self.extra or {})
        merged.update({k: v for k, v in ctx.items() if v is not None})
        return StructuredLogger(self.logger, merged)

    def process(self, msg, kwargs):
        if self.extra:
            suffix = " ".join(f"{k}={v}" for k, v in self.extra.items())
            msg = f"{msg} [{suffix}]"
        return msg, kwargs


def _level() -> int:
    raw = os.environ.get("REPRO_LOGLEVEL", "INFO").upper()
    got = getattr(logging, raw, None)
    return got if isinstance(got, int) else logging.INFO


def get_logger(name: str,
               trace_id: Optional[str] = None) -> StructuredLogger:
    """A structured logger for ``name``, optionally bound to a trace id;
    its level is ``REPRO_LOGLEVEL``'s at this call (default INFO)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(_level())
    out = StructuredLogger(logger, {})
    return out.bind(trace_id=trace_id) if trace_id is not None else out
