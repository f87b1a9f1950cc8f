"""Feature index maps (port of ``photon_tpu/index``)."""
