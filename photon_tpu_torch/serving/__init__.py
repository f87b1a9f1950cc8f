"""Online GAME scoring (port of ``photon_tpu/serving``).

* ``registry`` — versioned model registry with atomic hot-swap and a warm
  standby, on one explicit device;
* ``coefficient_store`` — the host per-entity random-effect coefficient
  table (flat, mmap-friendly; both packages' format) + the LRU device
  hot-set;
* ``scorer`` — request parsing and padded micro-batches through the shared
  scoring program (``estimators.game_transformer.additive_score_rows``,
  whose fixed parts are the ``ell_matvec`` kernel on CUDA);
* ``batcher`` — the micro-batcher: bounded admission, deadlines, one worker
  thread that owns the device;
* ``server`` — the stdlib ``ThreadingHTTPServer`` JSON front end with the
  admin routes, latency waterfall and JSONL metrics.

The front line — ``wire`` (binary row frames), ``ipc`` (shm ring + socket
channel), ``async_frontend`` (the worker processes), ``frontline`` (the
scorer-side service and worker supervisor) and ``autotune`` — and
``circuit`` are copies of the JAX package's modules (they import neither
JAX nor torch).

CLI entry point: ``photon_tpu_torch/cli/serving_driver.py``.

Exports resolve lazily (PEP 562): the front-line workers import ``wire``,
``ipc`` and ``coefficient_store`` and must load neither torch nor jax.
"""
_EXPORTS = {
    "DeadlineExceeded": "photon_tpu_torch.serving.batcher",
    "MicroBatcher": "photon_tpu_torch.serving.batcher",
    "Overloaded": "photon_tpu_torch.serving.batcher",
    "ScoreResult": "photon_tpu_torch.serving.batcher",
    "CircuitBreaker": "photon_tpu_torch.serving.circuit",
    "CoefficientStore": "photon_tpu_torch.serving.coefficient_store",
    "DeviceCoefficientCache": "photon_tpu_torch.serving.coefficient_store",
    "ModelRegistry": "photon_tpu_torch.serving.registry",
    "ModelVersion": "photon_tpu_torch.serving.registry",
    "ServingConfig": "photon_tpu_torch.serving.registry",
    "ParsedRow": "photon_tpu_torch.serving.scorer",
    "RowScorer": "photon_tpu_torch.serving.scorer",
    "ScoringServer": "photon_tpu_torch.serving.server",
    "BatchAutotuner": "photon_tpu_torch.serving.autotune",
    "FrontLine": "photon_tpu_torch.serving.frontline",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = [
    "BatchAutotuner",
    "FrontLine",
    "CircuitBreaker",
    "CoefficientStore",
    "DeadlineExceeded",
    "DeviceCoefficientCache",
    "MicroBatcher",
    "ModelRegistry",
    "ModelVersion",
    "Overloaded",
    "ParsedRow",
    "RowScorer",
    "ScoreResult",
    "ScoringServer",
    "ServingConfig",
]
