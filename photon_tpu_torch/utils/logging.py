"""Logging and stage timing.

Port of ``photon_tpu/utils/logging.py`` (``PhotonLogger``, ``Timed`` and
``write_metrics_jsonl`` without its size-bounded rotation; the latency
histogram comes with the serving slice): a logger that writes a log file
into the job's output directory alongside stderr, a ``Timed`` block that
logs wall-clock per driver stage, and an append-only JSON-lines writer.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Iterable, Mapping, Optional

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


class PhotonLogger:
    """Logger bound to an output directory: ``<dir>/photon.log`` + stderr.

    Use as a context manager so file handlers are released deterministically.
    """

    def __init__(
        self,
        output_dir: Optional[str] = None,
        name: str = "photon_tpu_torch",
        level: int = logging.INFO,
    ):
        self.logger = logging.getLogger(name)
        self.logger.setLevel(level)
        self._handlers: list[logging.Handler] = []

        have_stream = any(
            isinstance(h, logging.StreamHandler)
            and not isinstance(h, logging.FileHandler)
            for h in self.logger.handlers
        )
        if not have_stream:
            sh = logging.StreamHandler()
            sh.setFormatter(logging.Formatter(_FORMAT))
            self.logger.addHandler(sh)
            self._handlers.append(sh)
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(output_dir, "photon.log"))
            fh.setFormatter(logging.Formatter(_FORMAT))
            self.logger.addHandler(fh)
            self._handlers.append(fh)

    def __enter__(self) -> logging.Logger:
        return self.logger

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for h in self._handlers:
            self.logger.removeHandler(h)
            h.close()
        self._handlers.clear()


class Timed:
    """``with Timed("read data", logger): ...`` — logs elapsed wall-clock,
    and records it in ``seconds`` for programmatic use."""

    def __init__(self, stage: str, logger: Optional[logging.Logger] = None):
        self.stage = stage
        self.logger = logger or logging.getLogger("photon_tpu_torch")
        self.seconds: float = 0.0

    def __enter__(self) -> "Timed":
        self._t0 = time.perf_counter()
        self.logger.info("%s: started", self.stage)
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        status = "failed" if exc_type else "done"
        self.logger.info("%s: %s in %.3fs", self.stage, status, self.seconds)


def write_metrics_jsonl(path: str, records: Iterable[Mapping[str, Any]]) -> None:
    """Append metric records as JSON lines, one object per line, each line
    one unbuffered ``write()`` on an append-mode file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "ab", buffering=0) as f:
        for rec in records:
            f.write((json.dumps(dict(rec)) + "\n").encode("utf-8"))
