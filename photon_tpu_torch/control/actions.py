"""Lever bindings: the control plane's hands (docs/control.md §levers).

A copy of the JAX package's ``control/actions.py`` (it imports neither
torch nor JAX); ``tests/test_torch_control.py`` compares the code, so edit
both or neither.

Every actuator the policy engine can fire is a small, synchronous HTTP
call against machinery that already exists — the control plane adds NO new
failure-handling mechanism, it only pulls levers the serving tier already built
and hardened:

==================  ====================================================
lever               binding
==================  ====================================================
``standby_swap``    ``POST /admin/standby`` then ``POST /admin/swap``
                    (warm off the hot path, then a pointer move)
``shed_cache``      ``POST /admin/memory/shed`` (the memory guard's
                    sweep, invoked proactively on a watermark ramp)
``restart_tailer``  ``POST /admin/replication/restart`` (the tailer's
                    ``start()`` restart contract, within budget)
``scale_batcher``   ``POST /admin/tune`` (micro-batcher reconfigure)
``promote_wave``    append canary-log deltas to the MAIN delta log
                    (``replication/log.DeltaLogWriter`` — non-canary
                    replicas only ever see promoted waves)
``rollback``        ``standby``+``swap`` back to the base model dir (the
                    versioned overlay makes this a pointer move), then
                    resync: re-feed the promoted mainline deltas
==================  ====================================================

All calls raise :class:`LeverError` on transport/HTTP failure; the
controller journals the outcome either way — an actuation that failed is
MORE important evidence than one that worked.
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Optional, Sequence

from photon_tpu_torch.replication.log import DeltaLogRecord, DeltaLogWriter

__all__ = ["LeverError", "Levers", "promote_wave"]


class LeverError(RuntimeError):
    """An actuation failed (transport error or non-2xx reply)."""


def _request(url: str, payload: Optional[dict], timeout_s: float,
             headers: Optional[dict] = None) -> dict:
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        **({"Content-Type": "application/json"} if data else {}),
        **(headers or {}),
    })
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            body = resp.read().decode("utf-8", "replace")
    except urllib.error.HTTPError as e:
        detail = e.read().decode("utf-8", "replace")[:200]
        raise LeverError(f"{url}: HTTP {e.code}: {detail}") from None
    except (urllib.error.URLError, TimeoutError, OSError) as e:
        raise LeverError(f"{url}: {type(e).__name__}: {e}") from None
    try:
        return json.loads(body) if body else {}
    except json.JSONDecodeError:
        raise LeverError(f"{url}: non-JSON reply: {body[:120]!r}") from None


class Levers:
    """HTTP actuators against one fleet. Stateless; per-call timeout."""

    def __init__(self, timeout_s: float = 10.0):
        self.timeout_s = timeout_s

    # -- observation calls (GET) ----------------------------------------
    def healthz(self, base_url: str) -> dict:
        return _request(base_url.rstrip("/") + "/healthz", None,
                        self.timeout_s)

    def metrics(self, base_url: str) -> dict:
        return _request(base_url.rstrip("/") + "/metrics", None,
                        self.timeout_s)

    def score(self, base_url: str, rows: Sequence[dict]) -> tuple[float, dict]:
        """POST each probe row to /score (the server scores one row per
        request); returns (mean per-row round-trip ms, {"scores": [...]}).
        The round-trip is the controller's per-tick latency sample —
        windowed by construction, unlike the server's lifetime histogram."""
        url = base_url.rstrip("/") + "/score"
        scores = []
        t0 = time.monotonic()
        for row in rows:
            out = _request(url, dict(row), self.timeout_s)
            scores.append(out.get("score"))
        elapsed_ms = (time.monotonic() - t0) * 1e3
        return elapsed_ms / max(1, len(scores)), {"scores": scores}

    # -- actuators (POST) ------------------------------------------------
    def prepare_standby(self, base_url: str, model_dir: str) -> dict:
        return _request(base_url.rstrip("/") + "/admin/standby",
                        {"model_dir": model_dir}, self.timeout_s)

    def swap(self, base_url: str, model_dir: str) -> dict:
        return _request(base_url.rstrip("/") + "/admin/swap",
                        {"model_dir": model_dir}, self.timeout_s)

    def standby_swap(self, base_url: str, model_dir: str) -> dict:
        """The standby two-step: warm off the hot path, then pointer-move.
        A swap without the standby warm-up would trade a latency shift for
        a retrace stall — exactly the wrong remediation."""
        prepared = self.prepare_standby(base_url, model_dir)
        swapped = self.swap(base_url, model_dir)
        return {"prepared": prepared, "swapped": swapped}

    def shed_cache(self, base_url: str) -> dict:
        return _request(base_url.rstrip("/") + "/admin/memory/shed",
                        {}, self.timeout_s)

    def restart_tailer(self, base_url: str) -> dict:
        return _request(base_url.rstrip("/") + "/admin/replication/restart",
                        {}, self.timeout_s)

    def tune_batcher(self, base_url: str, max_batch: int,
                     max_queue: Optional[int] = None) -> dict:
        payload: dict = {"max_batch": int(max_batch)}
        if max_queue is not None:
            payload["max_queue"] = int(max_queue)
        return _request(base_url.rstrip("/") + "/admin/tune",
                        payload, self.timeout_s)

    def post_patch(self, base_url: str, wire_delta: dict,
                   idempotency_key: Optional[str] = None,
                   trace_id: Optional[str] = None) -> dict:
        headers = {}
        if idempotency_key:
            headers["X-Photon-Idempotency-Key"] = idempotency_key
        if trace_id:
            headers["X-Photon-Trace-Id"] = trace_id
        return _request(base_url.rstrip("/") + "/admin/patch",
                        wire_delta, self.timeout_s, headers=headers)


def promote_wave(writer: DeltaLogWriter,
                 records: Sequence[DeltaLogRecord]) -> list[int]:
    """Append a soaked canary wave's delta records to the main log.

    Each log is dense in its OWN seq space — the writer assigns fresh
    mainline seqs, so the canary side channel and the main log never need
    coordinated numbering (and a rolled-back wave simply never shows up
    here). Snapshot markers are not promoted: the main log carries its own
    base marker. Returns the assigned mainline seqs."""
    seqs: list[int] = []
    for rec in records:
        if rec.delta is None:
            continue
        seqs.append(writer.append(rec.delta, trace_id=rec.trace_id))
    return seqs
