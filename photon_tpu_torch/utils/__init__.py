"""Cross-cutting utilities (port of ``photon_tpu/utils``)."""
from photon_tpu_torch.utils.logging import PhotonLogger, Timed

__all__ = ["PhotonLogger", "Timed"]
