"""Sparse kernels and their plain versions (port of ``photon_tpu/ops``)."""
