"""Command-line drivers (port of ``photon_tpu/cli``)."""
