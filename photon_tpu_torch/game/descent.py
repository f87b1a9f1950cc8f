"""The GAME composite model.

Port of ``photon_tpu/game/descent.py`` (``GameModel``; coordinate descent
comes with the training slice).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from photon_tpu_torch.game.coordinates import DatumScoringModel


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Composite model keyed by coordinate id."""

    models: Mapping[str, DatumScoringModel]

    def __getitem__(self, cid: str) -> DatumScoringModel:
        return self.models[cid]

    def keys(self):
        return self.models.keys()
