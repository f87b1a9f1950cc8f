"""Generalized linear models (port of ``photon_tpu/models``)."""
