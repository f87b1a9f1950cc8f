"""Cross-cutting utilities (port of ``photon_tpu/utils``)."""
from photon_tpu_torch.utils.logging import PhotonLogger, Timed, write_metrics_jsonl

__all__ = ["PhotonLogger", "Timed", "write_metrics_jsonl"]
