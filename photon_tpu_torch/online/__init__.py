"""Online learning (port of ``photon_tpu/online``): so far ``delta``, the
model-delta wire format that the serving ``/admin/patch`` route reads (a
copy of the JAX package's module). The event log, the per-entity state and
the online trainer come with the online-learning slice; this package
re-exports nothing, so importing ``delta`` loads no torch."""
