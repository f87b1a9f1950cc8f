"""I/O: Avro codec, data reading, model persistence (port of ``photon_tpu/io``)."""
