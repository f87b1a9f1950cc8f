"""Device resolution for the port's entry points.

The port runs on the card. ``resolve_device()`` with no name gives ``cuda``
and raises when no GPU is visible; it never falls back to the CPU. The CPU is
used only when a caller names it (the tests do, and the scoring driver's
``--device cpu``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(name: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"``/``"cuda"``/``"cuda:N"`` as named.
    Raises ``RuntimeError`` for a CUDA device when none is available."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
