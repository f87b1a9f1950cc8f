"""GAME model pieces (port of ``photon_tpu/game``)."""
