"""Cross-cutting utilities (port of ``photon_tpu/utils``)."""
from photon_tpu_torch.utils.logging import (
    LatencyHistogram,
    PhotonLogger,
    Timed,
    write_metrics_jsonl,
)

__all__ = ["LatencyHistogram", "PhotonLogger", "Timed", "write_metrics_jsonl"]
