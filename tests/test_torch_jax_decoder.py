"""The JAX package's native Avro decoder, built once and safely for the
port's parity tests.

``photon_tpu/native`` compiles ``avro_block.cc`` into one shared
``<so>.tmp`` and renames it into place with no lock between processes, and
a worker whose build fails keeps no decoder for the rest of its life. Every
port test file that reaches the JAX package's streaming reader, prefetch or
drivers uses the module fixture ``jax_decoder`` (import it into the test
module): under an ``fcntl`` lock in the temp directory it builds the
library, if it is missing or older than its source, with the JAX package's
own g++ command line into a file named for this process, renames it into
place and loads it through ``photon_tpu.native.get_lib``. Only the JAX
package's gitignored build product is written, never its sources.
"""
from __future__ import annotations

import fcntl
import os
import subprocess
import tempfile

import pytest

LOCK_NAME = "photon_tpu_avro_block.build.lock"


def _stale(so: str, src: str) -> bool:
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


def ensure_jax_decoder():
    """Build (if needed) and load the JAX package's decoder library; raise
    with the compiler's message when it cannot be had."""
    from photon_tpu import native

    lock = os.path.join(tempfile.gettempdir(), LOCK_NAME)
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if _stale(native._SO, native._SRC):
                tmp = f"{native._SO}.{os.getpid()}.build"
                cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                       "-std=c++17", "-o", tmp, native._SRC]
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(
                        "building the JAX package's Avro decoder failed:\n"
                        f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, native._SO)
            # A build that failed earlier in this process left the JAX
            # loader's "failed" flag set: the library now exists, retry.
            native._failed = False
            lib = native.get_lib()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    if lib is None:
        raise RuntimeError(
            "photon_tpu.native.get_lib() returned None after the build: the "
            "JAX package's streaming reader would fall back to its per-record "
            "path in this process (is PHOTON_TPU_NO_NATIVE set?)")
    return lib


@pytest.fixture(scope="module", autouse=True)
def jax_decoder():
    return ensure_jax_decoder()


def test_jax_decoder_loads_and_is_fresh(jax_decoder):
    from photon_tpu import native

    assert jax_decoder is native.get_lib()
    assert not _stale(native._SO, native._SRC)
    # A second call under the lock finds the library built and loads it.
    assert ensure_jax_decoder() is jax_decoder
