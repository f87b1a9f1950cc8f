"""Data-pass counting for the feature-matrix operations.

Port of ``photon_tpu/ops/pass_counter.py``. Every ``matvec`` / ``rmatvec`` /
``sq_rmatvec`` of ``SparseFeatures`` calls :func:`record`; inside a
:func:`counting` block that bumps a host counter per call. PyTorch runs
eagerly, so a call is an execution and no callback needs to be embedded in
a traced program. Outside the block ``record`` does nothing.

One "data pass" is one touch of all N·K feature entries: one matvec OR one
rmatvec.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

_counts: dict[str, int] = {"matvec": 0, "rmatvec": 0, "sq_rmatvec": 0}
_enabled: bool = False


def record(kind: str) -> None:
    """Count one data pass of the given kind (inside ``counting()``)."""
    if _enabled:
        _counts[kind] += 1


@contextlib.contextmanager
def counting() -> Iterator[dict[str, int]]:
    """Enable pass counting from zero; yields the live counter dict."""
    global _enabled
    for k in _counts:
        _counts[k] = 0
    _enabled = True
    try:
        yield _counts
    finally:
        _enabled = False


def total_passes() -> int:
    return sum(_counts.values())
