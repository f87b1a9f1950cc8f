"""Objective functions and optimization problems (port of ``photon_tpu/functions``)."""
