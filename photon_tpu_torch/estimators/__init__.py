"""Scoring-side estimator pieces (port of ``photon_tpu/estimators``)."""
