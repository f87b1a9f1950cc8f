"""On-disk corruption helpers for the chaos tests (a copy of
``photon_tpu/faults/chaos.py``).

Exception-type faults (:mod:`photon_tpu_torch.faults.plan`) cover what
arrives through a ``raise``; these helpers cover the faults that arrive
through the filesystem instead — a checkpoint torn by a hard kill, a
bit-flipped snapshot from bad hardware — where the failure is only visible
when the file is read back. Both are deterministic (seeded) so a chaos run
reproduces exactly.
"""
from __future__ import annotations

import os
import random

__all__ = ["torn_write", "bit_flip"]


def torn_write(path: str, keep_fraction: float = 0.5) -> int:
    """Truncate ``path`` to ``keep_fraction`` of its size — the on-disk
    signature of a writer killed mid-write without the atomic tmp+rename
    dance. Returns the new size."""
    size = os.path.getsize(path)
    keep = max(0, int(size * keep_fraction))
    with open(path, "rb+") as f:
        f.truncate(keep)
    return keep


def bit_flip(
    path: str, n_flips: int = 1, seed: int = 0, min_offset: int = 0
) -> list[int]:
    """Flip ``n_flips`` seeded-random bits of ``path`` in place (at byte
    offsets >= ``min_offset``, so tests can aim past a header). The file
    keeps its size and framing — the corruption only a checksum catches.
    Returns the flipped byte offsets."""
    size = os.path.getsize(path)
    if size <= min_offset:
        raise ValueError(
            f"{path}: {size} bytes, nothing to flip past offset {min_offset}"
        )
    rng = random.Random(seed)
    offsets = []
    with open(path, "rb+") as f:
        for _ in range(n_flips):
            off = rng.randrange(min_offset, size)
            f.seek(off)
            byte = f.read(1)[0]
            f.seek(off)
            f.write(bytes([byte ^ (1 << rng.randrange(8))]))
            offsets.append(off)
    return offsets
