"""Batched data as tensors (port of ``photon_tpu/data``)."""
