"""Native (C++) components, compiled on demand with the system toolchain.

Port of ``photon_tpu/native/__init__.py``. The one native component is the
Avro block decoder (``avro_block.cc``, a verbatim copy of the JAX package's
source) used by :mod:`photon_tpu_torch.io.streaming`. It is compiled once per
source change with ``g++ -O3 -shared`` into this directory and loaded with
ctypes. The build writes a file named for this process, then renames it into
place, so concurrent test workers never load a half-written library. Without
a compiler (or with ``PHOTON_TPU_NO_NATIVE=1``) ``get_lib`` returns None and
the readers take the per-record path, with the same results.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "avro_block.cc")


def _isa_tag() -> str:
    """Short tag of this host's vector ISA, so a ``-march=native`` build left
    in a checkout shared between hosts is never loaded by a host with
    another instruction set."""
    import platform
    import zlib

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return f"{zlib.crc32(line.encode()) & 0xFFFFFFFF:08x}"
    except OSError:
        pass
    return platform.machine() or "unknown"


_SO = os.path.join(_HERE, f"_avro_block.{_isa_tag()}.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False
# Seconds of the last g++ build in this process (0.0 when a built library
# was loaded as it was).
BUILD_SECONDS = 0.0


def _compile() -> bool:
    global BUILD_SECONDS
    import time

    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, _SRC]
    t0 = time.perf_counter()
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False
    os.replace(tmp, _SO)
    BUILD_SECONDS = time.perf_counter() - t0
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32, u64, f64, u8 = (
        ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64, ctypes.c_double,
        ctypes.c_uint8,
    )
    P = ctypes.POINTER
    lib.ph_hash_keys.argtypes = [P(u8), P(i64), i64, P(u64)]
    lib.ph_hash_keys.restype = None
    lib.ph_create.argtypes = [
        P(i32), i64, P(i32), i64, P(i64), i64,
        i32, P(f64), i32,
        P(u8), P(i64), i64,
        i32, P(P(u64)), P(P(i32)), P(i64),
    ]
    lib.ph_create.restype = ctypes.c_void_p
    lib.ph_destroy.argtypes = [ctypes.c_void_p]
    lib.ph_destroy.restype = None
    lib.ph_decode_block.argtypes = [ctypes.c_void_p, P(u8), i64, i64]
    lib.ph_decode_block.restype = i64
    lib.ph_chunk_rows.argtypes = [ctypes.c_void_p]
    lib.ph_chunk_rows.restype = i64
    lib.ph_get_num_col.argtypes = [ctypes.c_void_p, i32, P(f64)]
    lib.ph_get_num_col.restype = None
    lib.ph_get_str_codes.argtypes = [ctypes.c_void_p, i32, P(i32)]
    lib.ph_get_str_codes.restype = None
    lib.ph_shard_nnz.argtypes = [ctypes.c_void_p, i32]
    lib.ph_shard_nnz.restype = i64
    lib.ph_get_shard_triples.argtypes = [ctypes.c_void_p, i32, P(i32), P(i32), P(f64)]
    lib.ph_get_shard_triples.restype = None
    lib.ph_dict_size.argtypes = [ctypes.c_void_p, i32]
    lib.ph_dict_size.restype = i64
    lib.ph_dict_heap_bytes_from.argtypes = [ctypes.c_void_p, i32, i64]
    lib.ph_dict_heap_bytes_from.restype = i64
    lib.ph_get_dict_range.argtypes = [ctypes.c_void_p, i32, i64, P(u8), P(i64)]
    lib.ph_get_dict_range.restype = None
    lib.ph_shard_dict_size.argtypes = [ctypes.c_void_p, i32]
    lib.ph_shard_dict_size.restype = i64
    lib.ph_shard_dict_heap_bytes_from.argtypes = [ctypes.c_void_p, i32, i64]
    lib.ph_shard_dict_heap_bytes_from.restype = i64
    lib.ph_shard_dict_range.argtypes = [ctypes.c_void_p, i32, i64, P(u8), P(i64)]
    lib.ph_shard_dict_range.restype = None
    lib.ph_reset_chunk.argtypes = [ctypes.c_void_p]
    lib.ph_reset_chunk.restype = None
    f32 = ctypes.c_float
    lib.ph_ell_scatter_f32.argtypes = [
        P(i32), P(i32), P(f64), i64, i64, i64, P(i32), P(f32)
    ]
    lib.ph_ell_scatter_f32.restype = None
    lib.ph_ell_scatter_f64.argtypes = [
        P(i32), P(i32), P(f64), i64, i64, i64, P(i32), P(f64)
    ]
    lib.ph_ell_scatter_f64.restype = None
    lib.ph_shard_max_run.argtypes = [ctypes.c_void_p, i32]
    lib.ph_shard_max_run.restype = i64
    lib.ph_shard_ell_f32.argtypes = [
        ctypes.c_void_p, i32, i64, i64, i64, i64, P(i32), P(f32)
    ]
    lib.ph_shard_ell_f32.restype = None
    lib.ph_shard_ell_f64.argtypes = [
        ctypes.c_void_p, i32, i64, i64, i64, i64, P(i32), P(f64)
    ]
    lib.ph_shard_ell_f64.restype = None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled decoder library, or None if native is unavailable."""
    global _lib, _failed
    if _lib is not None:
        return _lib
    if _failed or os.environ.get("PHOTON_TPU_NO_NATIVE") == "1":
        return None
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            stale = (not os.path.exists(_SO)
                     or os.path.getmtime(_SO) < os.path.getmtime(_SRC))
            if stale and not _compile():
                _failed = True
                return None
            try:
                _lib = _bind(ctypes.CDLL(_SO))
            except AttributeError:
                # A library left from an older source that lacks a symbol:
                # rebuild once.
                if not _compile():
                    _failed = True
                    return None
                _lib = _bind(ctypes.CDLL(_SO))
        except (OSError, AttributeError):
            _failed = True
            return None
    return _lib
