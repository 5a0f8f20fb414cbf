"""Structured logging: JSONL records with a subsystem field (the part
of the reference's ``runtime/logging.py`` the serving path uses).

``get_logger("serveloop")`` returns a logger whose records carry
``subsys``; :func:`setup` installs the JSONL handler (one JSON object
per line: ``ts``, ``level``, ``subsys``, ``msg``, ``trace_id`` under
an active trace, plus ``extra={"fields": {...}}``). Until then records
propagate to whatever the host process configured.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Optional

ROOT = "cilium_tpu_torch"

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "warn": logging.WARNING,
           "error": logging.ERROR, "critical": logging.CRITICAL,
           "fatal": logging.CRITICAL}


class JSONLFormatter(logging.Formatter):
    """One JSON object per record; ``extra={"fields": {...}}`` merges in."""

    def format(self, record: logging.LogRecord) -> str:
        from cilium_tpu_torch.runtime.tracing import TRACER

        out = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "subsys": getattr(record, "subsys",
                              record.name.rsplit(".", 1)[-1]),
            "msg": record.getMessage(),
        }
        tid = TRACER.current_trace_id()
        if tid:
            out["trace_id"] = tid
        fields = getattr(record, "fields", None)
        if fields:
            for k, v in fields.items():
                if k not in out:
                    out[k] = v
        if record.exc_info and record.exc_info[0] is not None:
            out["error"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class _SubsysAdapter(logging.LoggerAdapter):
    """Stamps ``subsys`` on every record."""

    def process(self, msg, kwargs):
        extra = kwargs.setdefault("extra", {})
        extra.setdefault("subsys", self.extra["subsys"])
        return msg, kwargs


def get_logger(subsys: str) -> logging.LoggerAdapter:
    """Per-subsystem structured logger (``subsys`` on every record)."""
    return _SubsysAdapter(logging.getLogger(f"{ROOT}.{subsys}"),
                          {"subsys": subsys})


def setup(level: str = "info", stream=None,
          path: Optional[str] = None) -> logging.Logger:
    """Install the JSONL handler on the package root logger (to a file
    when ``path`` is given, else the stream); idempotent."""
    root = logging.getLogger(ROOT)
    resolved = _LEVELS.get(level.lower())
    root.setLevel(logging.INFO if resolved is None else resolved)
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    if path is not None:
        handler: logging.Handler = logging.FileHandler(path)
    else:
        handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JSONLFormatter())
    root.addHandler(handler)
    root.propagate = False
    if resolved is None:
        root.warning("unknown log level %r, using info", level,
                     extra={"subsys": "logging"})
    return root
