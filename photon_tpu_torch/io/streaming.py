"""Streaming sharded Avro ingest: block-level decode, columnar assembly.

Port of ``photon_tpu/io/streaming.py``. The Avro container framing (block
headers, sync markers, deflate) is handled here in Python, per block; each
block payload goes to the native decoder (``photon_tpu_torch/native``) as one
ctypes call, which parses the records by a compiled schema program straight
into columnar buffers: numeric columns, dictionary-encoded string columns,
and per-shard padded-ELL feature arrays looked up through a MurmurHash64A
table built from the shard's ``IndexMap``. Every ``chunk_rows`` rows the
buffers are snapshotted into a :class:`GameDataChunk` of numpy arrays (no
per-row Python objects, no tensors). :func:`chunks_to_bundle` and
:meth:`GameDataChunk.to_bundle` are where tensors are made, on the caller's
device. :meth:`StreamingAvroReader.read` gives the same ``GameDataBundle``
as the per-record reader, bit for bit.

Schemas the compiler cannot express (a non-record top level, feature bags
that are not arrays of (name, term?, value) records) and a missing native
library raise :class:`Unsupported`; ``AvroDataReader.read`` catches it and
takes the per-record path, with the same results. Fault points and trace
spans of the JAX module belong to the observability slice and are not
ported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import logging
import os
import time
from typing import Callable, Iterator, Mapping, Optional, Sequence

import numpy as np

from photon_tpu_torch import native
from photon_tpu_torch.index.index_map import (
    INTERCEPT_NAME,
    INTERCEPT_TERM,
    IndexMap,
    feature_key,
)
from photon_tpu_torch.io import avro
from photon_tpu_torch.io.avro import SchemaError

logger = logging.getLogger("photon_tpu_torch.io")

# Type-tree node kinds — must match avro_block.cc.
K_NULL, K_BOOL, K_INT, K_LONG, K_FLOAT, K_DOUBLE = 0, 1, 2, 3, 4, 5
K_BYTES, K_STRING, K_FIXED, K_ENUM, K_ARRAY, K_MAP = 6, 7, 8, 9, 10, 11
K_RECORD, K_UNION = 12, 13

OP_SKIP, OP_NUM, OP_STR, OP_BAG, OP_META = 0, 1, 2, 3, 4

_PRIM_KINDS = {
    "null": K_NULL, "boolean": K_BOOL, "int": K_INT, "long": K_LONG,
    "float": K_FLOAT, "double": K_DOUBLE, "bytes": K_BYTES, "string": K_STRING,
}

_ERRORS = {
    -1: "truncated block payload",
    -2: "malformed varint",
    -3: "union branch out of range",
    -4: "unexpected type in data",
    -5: "missing id tag",
    -6: "nesting too deep",
    -7: "native allocation failed (host out of memory?)",
}


class Unsupported(Exception):
    """Schema/config shape the streaming compiler cannot express; callers
    fall back to the per-record Python reader."""


# ---------------------------------------------------------------------------
# schema -> type tree + program


def _build_ttree(schema, names: dict, out: list, depth: int = 0) -> int:
    """Flatten a (resolved) schema into the pre-order int32 type tree;
    returns the node offset."""
    if depth > 32:
        raise Unsupported("schema nesting too deep")
    schema = avro._resolve(schema, names)
    if isinstance(schema, list):  # union
        off = len(out)
        out.extend([K_UNION, len(schema)])
        slots = len(out)
        out.extend([0] * len(schema))
        for i, br in enumerate(schema):
            out[slots + i] = _build_ttree(br, names, out, depth + 1)
        return off
    t = schema if isinstance(schema, str) else schema["type"]
    if t in _PRIM_KINDS:
        off = len(out)
        out.append(_PRIM_KINDS[t])
        return off
    if t == "fixed":
        off = len(out)
        out.extend([K_FIXED, int(schema["size"])])
        return off
    if t == "enum":
        off = len(out)
        out.append(K_ENUM)
        return off
    if t in ("array", "map"):
        off = len(out)
        out.extend([K_ARRAY if t == "array" else K_MAP, 0])
        child_key = "items" if t == "array" else "values"
        out[off + 1] = _build_ttree(schema[child_key], names, out, depth + 1)
        return off
    if t == "record":
        fields = schema.get("fields", ())
        off = len(out)
        out.extend([K_RECORD, len(fields)])
        slots = len(out)
        out.extend([0] * len(fields))
        for i, f in enumerate(fields):
            out[slots + i] = _build_ttree(f["type"], names, out, depth + 1)
        return off
    raise Unsupported(f"unsupported avro type {t!r}")


def _static_branches(schema, names: dict):
    """Yield the concrete (non-union) branches of a possibly-union schema."""
    schema = avro._resolve(schema, names)
    if isinstance(schema, list):
        for br in schema:
            yield from _static_branches(br, names)
    else:
        yield schema


def _find_bag_record(field_schema, names: dict):
    """For a feature-bag field: the array-of-record branch's record schema."""
    recs = []
    for br in _static_branches(field_schema, names):
        t = br if isinstance(br, str) else br["type"]
        if t == "array":
            item = avro._resolve(br["items"], names)
            it = item if isinstance(item, str) else item.get("type")
            if it == "record":
                recs.append(item)
    if len(recs) != 1:
        raise Unsupported("feature bag is not a unique array-of-record field")
    return recs[0]


def _is_fast_bag(rec, names: dict) -> bool:
    """True for the exact reference NameTermValueAvro layout —
    [name: string, term: [null, string], value: double] — which the native
    decoder parses with a straight-line fast path."""
    fields = rec.get("fields", ())
    if len(fields) != 3:
        return False
    if [f["name"] for f in fields] != ["name", "term", "value"]:
        return False
    def prim(s):
        s = avro._resolve(s, names)
        return s.get("type") if isinstance(s, dict) else s

    t_t = avro._resolve(fields[1]["type"], names)
    if prim(fields[0]["type"]) != "string" or prim(fields[2]["type"]) != "double":
        return False
    if not (isinstance(t_t, list) and len(t_t) == 2):
        return False
    return prim(t_t[0]) == "null" and prim(t_t[1]) == "string"


def _is_map_like(field_schema, names: dict) -> bool:
    return any(
        (br if isinstance(br, str) else br["type"]) == "map"
        for br in _static_branches(field_schema, names)
    )


@dataclasses.dataclass
class Program:
    """Compiled decode program + column layout for one (schema, config)."""

    ttree: np.ndarray          # int32
    ops: np.ndarray            # int32, flattened
    op_starts: np.ndarray      # int64
    num_names: list            # numeric column names (response/offset/...)
    null_defaults: np.ndarray  # float64 per numeric column
    str_names: list            # string column names (uid + tags)
    tag_names: list            # names referenced by OP_META
    shard_order: list          # shard ids in table order
    tables: list               # (hashes u64[2^k], vals int32[2^k]) per shard
    n_label_cols: int          # response + aliases occupy num cols [0, n)


def _hash_key_blob(blob: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """Hashes of the keys ``blob[offs[i]:offs[i + 1]]`` by the native
    ``hash64`` (MurmurHash64A), the function the decoder applies to decoded
    feature keys, so table and probe always agree."""
    lib = native.get_lib()
    if lib is None:
        raise Unsupported("native decoder unavailable")
    n = len(offs) - 1
    out = np.zeros(n, np.uint64)
    if n:
        arr = blob if len(blob) else np.zeros(1, np.uint8)
        offs = np.ascontiguousarray(offs, np.int64)
        lib.ph_hash_keys(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
    return out


def _key_blob(index_map: IndexMap) -> tuple[np.ndarray, np.ndarray]:
    """``(utf-8 key bytes, offsets)`` of every ``name\\x01term`` key in
    column order: in bulk from a map that stores them so
    (``MmapIndexMap.key_blob``), else key by key."""
    bulk = getattr(index_map, "key_blob", None)
    if bulk is not None:
        return bulk()
    try:
        keys = [k.encode("utf-8") for k in index_map.keys_in_order]
    except AttributeError:
        keys = [feature_key(*index_map.get_feature(i)).encode("utf-8")
                for i in range(len(index_map))]
    offs = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(k) for k in keys], out=offs[1:])
    return np.frombuffer(b"".join(keys), np.uint8), offs


def _build_table(index_map: IndexMap) -> tuple[np.ndarray, np.ndarray]:
    """Open-addressing (hash, value) arrays for one shard's feature index.

    64-bit MurmurHash64A over the full ``name\\x01term`` key; distinct keys
    colliding on the full 64-bit hash (probability ~n²/2⁶⁵) are detected and
    rejected — the caller falls back to the exact-string reader rather than
    silently merging features.
    """
    hashes = _hash_key_blob(*_key_blob(index_map))
    if len(np.unique(hashes)) != len(hashes):
        raise Unsupported("64-bit feature-key hash collision")
    size = 1
    while size < 2 * max(len(hashes), 1):
        size *= 2
    t_hash = np.zeros(size, np.uint64)
    t_val = np.full(size, -1, np.int32)
    mask = size - 1
    # Vectorized first placement: the first key hashing to each slot lands
    # without probing; only slot-colliding keys take the Python probe loop.
    home = (hashes & np.uint64(mask)).astype(np.int64)
    order = np.argsort(home, kind="stable")
    first = np.ones(len(hashes), bool)
    first[order[1:]] = home[order[1:]] != home[order[:-1]]
    t_hash[home[first]] = hashes[first]
    t_val[home[first]] = np.flatnonzero(first).astype(np.int32)
    for i in np.flatnonzero(~first):
        j = int(home[i])
        while t_hash[j] != 0:
            j = (j + 1) & mask
        t_hash[j] = hashes[i]
        t_val[j] = i
    return t_hash, t_val


def compile_program(
    schema,
    columns,
    shard_configs: Mapping[str, object],
    index_maps: Mapping[str, IndexMap],
    id_tag_columns: Sequence[str],
    capture_uids: bool = True,
) -> Program:
    """Compile (writer schema, reader config) into a native decode program."""
    schema = avro.parse_schema(schema)
    names: dict = {}
    avro._collect_names(schema, names)
    top = avro._resolve(schema, names)
    if not isinstance(top, dict) or top.get("type") != "record":
        raise Unsupported("top-level schema is not a record")

    # Column layout.
    from photon_tpu_torch.io.data_reader import response_columns

    response_cols = list(response_columns(columns))
    field_names = [f["name"] for f in top["fields"]]
    present_resp = [c for c in response_cols if c in field_names]
    num_names = (present_resp or [columns.response]) + [
        columns.offset, columns.weight
    ]
    n_label = max(len(present_resp), 1)
    null_defaults = np.array([np.nan] * n_label + [0.0, 1.0], np.float64)
    str_names = ["__uid__"] + list(id_tag_columns)
    tag_names = list(id_tag_columns)

    # bag -> shards feeding from it.
    bag_shards: dict[str, list[int]] = {}
    shard_order = list(index_maps)
    for si, shard in enumerate(shard_order):
        for bag in shard_configs[shard].feature_bags:
            bag_shards.setdefault(bag, []).append(si)

    ttree: list[int] = []
    ops: list[int] = []
    op_starts: list[int] = []

    def emit(*vals):
        op_starts.append(len(ops))
        ops.extend(int(v) for v in vals)

    for fpos, f in enumerate(top["fields"]):
        name = f["name"]
        toff = _build_ttree(f["type"], names, ttree)
        if name in present_resp:
            emit(OP_NUM, toff, present_resp.index(name), 1)
        elif name == columns.offset:
            emit(OP_NUM, toff, n_label, 1)
        elif name == columns.weight:
            emit(OP_NUM, toff, n_label + 1, 1)
        elif name == columns.uid and capture_uids:
            emit(OP_STR, toff, 0, 1)
        elif name in tag_names:
            emit(OP_STR, toff, 1 + tag_names.index(name), 0)
        elif name == "metadataMap" and tag_names and _is_map_like(f["type"], names):
            args = [OP_META, toff, len(tag_names)]
            for ti in range(len(tag_names)):
                args += [1 + ti, ti]
            emit(*args)
        elif name in bag_shards:
            rec = _find_bag_record(f["type"], names)
            rfields = [rf["name"] for rf in rec.get("fields", ())]
            if "name" not in rfields or "value" not in rfields:
                raise Unsupported(
                    f"feature bag {name!r} items lack name/value fields"
                )
            npos = rfields.index("name")
            tpos = rfields.index("term") if "term" in rfields else -1
            vpos = rfields.index("value")
            fast = 1 if _is_fast_bag(rec, names) else 0
            shards = bag_shards[name]
            emit(OP_BAG, toff, npos, tpos, vpos, fast, len(shards), *shards)
        else:
            emit(OP_SKIP, toff)

    # An index map of None marks a COLLECT shard (index build): the decoder
    # interns every decoded feature key instead of probing a table.
    tables = [
        None if index_maps[s] is None else _build_table(index_maps[s])
        for s in shard_order
    ]
    return Program(
        ttree=np.asarray(ttree, np.int32),
        ops=np.asarray(ops, np.int32),
        op_starts=np.asarray(op_starts, np.int64),
        num_names=num_names,
        null_defaults=null_defaults,
        str_names=str_names,
        tag_names=tag_names,
        shard_order=shard_order,
        tables=tables,
        n_label_cols=n_label,
    )


# ---------------------------------------------------------------------------
# chunks


class DictColumn:
    """Dictionary-encoded string column: ``values[codes[i]]``; code -1 means
    unset (maps to the materialize default).

    ``values`` is LAZY: unique strings decode from the native dictionary only
    when first accessed, so flows that never read uids/tags as strings (bulk
    training) pay nothing for them. Codes always index a prefix of the final
    dictionary (it grows monotonically across the stream), so resolving late
    is safe."""

    def __init__(self, codes: np.ndarray, values):
        self.codes = codes
        self._values = values      # np.ndarray | zero-arg callable

    @property
    def values(self) -> np.ndarray:
        if callable(self._values):
            self._values = self._values()
        return self._values

    def materialize(self, default: str = "") -> np.ndarray:
        ext = np.concatenate([self.values, np.array([default], object)])
        return ext[self.codes]


@dataclasses.dataclass(frozen=True)
class HostEll:
    """One shard's padded-ELL arrays on the host (numpy): ``idx[N, K]``
    int32 with ghost ``dim``, ``val[N, K]``."""

    idx: np.ndarray
    val: np.ndarray
    dim: int


@dataclasses.dataclass
class GameDataChunk:
    """One streamed chunk: columnar numpy + padded-ELL features per shard."""

    labels: np.ndarray           # float64 [n] (NaN = missing)
    offsets: np.ndarray          # float64 [n]
    weights: np.ndarray          # float64 [n]
    uids: DictColumn
    id_tags: dict                # tag -> DictColumn
    features: dict               # shard -> HostEll

    @property
    def n_rows(self) -> int:
        return len(self.labels)

    def to_bundle(
        self,
        device,
        dtype=None,
        pad_rows_to: int = 0,
        pad_nnz_to: Optional[Mapping[str, int]] = None,
    ):
        """This chunk as a ``GameDataBundle`` on ``device`` (materialized
        string columns): the unit of chunked scoring. ``dtype`` (a torch
        floating dtype) defaults to the chunk's value dtype.

        ``pad_rows_to`` / ``pad_nnz_to`` give every chunk the same shape, as
        the JAX package pads its chunks: padded rows carry weight 0, ghost
        features and empty uid / tags; callers slice outputs back to
        ``n_rows``.
        """
        import torch

        from photon_tpu_torch.data.batch import SparseFeatures
        from photon_tpu_torch.io.data_reader import GameDataBundle

        n = self.n_rows
        n_pad = max(pad_rows_to, n)

        def pad1(a, fill=0.0):
            return np.pad(a, (0, n_pad - n), constant_values=fill) \
                if n_pad > n else a

        features = {}
        for s, sf in self.features.items():
            k_pad = max((pad_nnz_to or {}).get(s, 0), sf.idx.shape[1])
            iarr, varr = sf.idx, sf.val
            if n_pad > n or k_pad > iarr.shape[1]:
                grown_i = np.full((n_pad, k_pad), sf.dim, np.int32)
                grown_v = np.zeros((n_pad, k_pad), varr.dtype)
                grown_i[:n, : iarr.shape[1]] = iarr
                grown_v[:n, : varr.shape[1]] = varr
                iarr, varr = grown_i, grown_v
            val = torch.from_numpy(np.ascontiguousarray(varr))
            features[s] = SparseFeatures(
                idx=torch.from_numpy(np.ascontiguousarray(iarr)).to(device),
                val=val.to(device=device, dtype=dtype or val.dtype),
                dim=sf.dim)
        weights = self.weights
        if n_pad > n:
            weights = np.pad(weights, (0, n_pad - n))  # padded rows weight 0
        return GameDataBundle(
            features=features,
            labels=pad1(self.labels, np.nan),
            offsets=pad1(self.offsets),
            weights=weights,
            uids=np.concatenate([
                self.uids.materialize(""),
                np.full(n_pad - n, "", object),
            ]) if n_pad > n else self.uids.materialize("").astype(object),
            id_tags={
                t: np.concatenate([
                    c.materialize(), np.full(n_pad - n, "", object)
                ]) if n_pad > n else c.materialize().astype(object)
                for t, c in self.id_tags.items()
            },
        )

    def split(self, n_parts: int) -> list["GameDataChunk"]:
        """Contiguous row split into ``n_parts`` chunks."""
        bounds = np.linspace(0, self.n_rows, n_parts + 1).astype(int)
        return [GameDataChunk(
            labels=self.labels[a:b],
            offsets=self.offsets[a:b],
            weights=self.weights[a:b],
            uids=DictColumn(self.uids.codes[a:b], self.uids.values),
            id_tags={t: DictColumn(c.codes[a:b], c.values)
                     for t, c in self.id_tags.items()},
            features={s: HostEll(idx=sf.idx[a:b], val=sf.val[a:b], dim=sf.dim)
                      for s, sf in self.features.items()},
        ) for a, b in zip(bounds, bounds[1:])]


def ell_from_triples(
    rows: np.ndarray,
    idx: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    dim: int,
    dtype=np.float32,
    intercept_index: Optional[int] = None,
) -> HostEll:
    """Vectorized (row, col, value) triples -> padded ELL. ``rows`` must be
    row-major ordered (the decoder emits them that way)."""
    base = 1 if intercept_index is not None and intercept_index >= 0 else 0
    counts = np.bincount(rows, minlength=n_rows) if len(rows) else np.zeros(
        n_rows, np.int64
    )
    k = int(counts.max()) + base if n_rows else base
    k = max(k, 1)
    iarr = np.full((n_rows, k), dim, np.int32)
    varr = np.zeros((n_rows, k), np.dtype(dtype))
    if len(rows):
        scatter = _ell_scatter_fn(varr.dtype)
        if scatter is not None:
            fn, out_ctype = scatter
            rows32 = np.ascontiguousarray(rows, np.int32)
            idx32 = np.ascontiguousarray(idx, np.int32)
            vals64 = np.ascontiguousarray(vals, np.float64)
            fn(
                _np_ptr(rows32, ctypes.c_int32),
                _np_ptr(idx32, ctypes.c_int32),
                _np_ptr(vals64, ctypes.c_double),
                len(rows32), k, base,
                _np_ptr(iarr, ctypes.c_int32),
                _np_ptr(varr, out_ctype),
            )
        else:
            starts = np.zeros(n_rows + 1, np.int64)
            np.cumsum(counts, out=starts[1:])
            pos = np.arange(len(rows), dtype=np.int64) - starts[rows] + base
            iarr[rows, pos] = idx
            varr[rows, pos] = vals.astype(varr.dtype)
    if base:
        iarr[:, 0] = intercept_index
        varr[:, 0] = 1.0
    return HostEll(idx=iarr, val=varr, dim=dim)


def _ell_scatter_fn(dtype: np.dtype):
    """(native scatter fn, output ctype) for float32/float64 outputs, None
    otherwise (fallback to the numpy fancy-index path — e.g. no compiler,
    or exotic dtypes)."""
    lib = native.get_lib()
    if lib is None:
        return None
    if dtype == np.float32:
        return lib.ph_ell_scatter_f32, ctypes.c_float
    if dtype == np.float64:
        return lib.ph_ell_scatter_f64, ctypes.c_double
    return None


# ---------------------------------------------------------------------------
# the reader


def _np_ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _read_dict_range(state, index, start, size_fn, bytes_fn, range_fn):
    """Fetch entries [start, size) of one native StrDict (string column or
    collect-mode shard keys) as utf-8 strings — the one Python side of the
    incremental dict-range protocol."""
    n = size_fn(state, index)
    if n <= start:
        return n, []
    hb = bytes_fn(state, index, start)
    heap = np.empty(max(hb, 1), np.uint8)
    offs = np.empty(n - start + 1, np.int64)
    range_fn(state, index, start, _np_ptr(heap, ctypes.c_uint8),
             _np_ptr(offs, ctypes.c_int64))
    raw = heap.tobytes()
    return n, [
        raw[offs[i]:offs[i + 1]].decode("utf-8") for i in range(n - start)
    ]


class NativeDecoder:
    """ctypes wrapper around one avro_block.cc State."""

    def __init__(self, lib, program: Program):
        self.lib = lib
        self.program = program
        self._dict_cache: dict = {}
        p = program
        tag_blob = b"".join(t.encode() for t in p.tag_names)
        tag_offs = np.zeros(len(p.tag_names) + 1, np.int64)
        np.cumsum([len(t.encode()) for t in p.tag_names], out=tag_offs[1:])
        tag_arr = (
            np.frombuffer(tag_blob, np.uint8)
            if tag_blob
            else np.zeros(1, np.uint8)
        )
        n_shards = len(p.tables)
        hash_ptrs = (ctypes.POINTER(ctypes.c_uint64) * max(n_shards, 1))()
        val_ptrs = (ctypes.POINTER(ctypes.c_int32) * max(n_shards, 1))()
        sizes = np.zeros(max(n_shards, 1), np.int64)
        self._keepalive = [tag_offs, tag_arr, sizes]
        for i, table in enumerate(p.tables):
            if table is None:  # collect (index-build) shard
                sizes[i] = -1
                continue
            th, tv = table
            hash_ptrs[i] = _np_ptr(th, ctypes.c_uint64)
            val_ptrs[i] = _np_ptr(tv, ctypes.c_int32)
            sizes[i] = len(th)
            self._keepalive += [th, tv]
        self.state = lib.ph_create(
            _np_ptr(p.ttree, ctypes.c_int32), len(p.ttree),
            _np_ptr(p.ops, ctypes.c_int32), len(p.ops),
            _np_ptr(p.op_starts, ctypes.c_int64), len(p.op_starts),
            len(p.num_names), _np_ptr(p.null_defaults, ctypes.c_double),
            len(p.str_names),
            _np_ptr(tag_arr, ctypes.c_uint8),
            _np_ptr(tag_offs, ctypes.c_int64), len(p.tag_names),
            n_shards, hash_ptrs, val_ptrs, _np_ptr(sizes, ctypes.c_int64),
        )
        if not self.state:
            raise MemoryError("ph_create failed")

    def decode_block(self, payload: bytes, count: int) -> int:
        arr = np.frombuffer(payload, np.uint8) if payload else np.zeros(1, np.uint8)
        r = self.lib.ph_decode_block(
            self.state, _np_ptr(arr, ctypes.c_uint8), len(payload), count
        )
        if r == -7:
            # bad_alloc caught at the native ABI boundary (the alternative
            # was std::terminate -> a fatal interpreter abort). The chunk
            # state is incoherent; the stream must abort, not continue.
            raise MemoryError("native avro decode: allocation failed "
                              "(host out of memory?)")
        if r < 0:
            raise SchemaError(
                f"native avro decode failed: {_ERRORS.get(r, r)}"
            )
        return r

    def take_chunk(self, ell: Optional[dict] = None,
                   ell_dtype=np.float32) -> dict:
        """Snapshot current buffers as numpy arrays and reset row state.

        ``ell`` maps shard name -> ``(dim, intercept_index_or_None)``: those
        shards come back as ASSEMBLED ELL arrays (``"ell"`` key, built by
        one native pass that writes entries and ghost padding directly —
        no triples copy, no bincount, no fill pass). Shards not in ``ell``
        come back as triples, as before.
        """
        lib, st = self.lib, self.state
        n = lib.ph_chunk_rows(st)
        p = self.program
        num = {}
        for c, name in enumerate(p.num_names):
            a = np.empty(n, np.float64)
            if n:
                lib.ph_get_num_col(st, c, _np_ptr(a, ctypes.c_double))
            num[name] = a
        codes = {}
        for c, name in enumerate(p.str_names):
            a = np.empty(n, np.int32)
            if n:
                lib.ph_get_str_codes(st, c, _np_ptr(a, ctypes.c_int32))
            codes[name] = a
        if ell is not None:
            dt = np.dtype(ell_dtype)
            fill = (lib.ph_shard_ell_f32 if dt == np.float32
                    else lib.ph_shard_ell_f64 if dt == np.float64 else None)
            if fill is None:
                ell = None  # exotic dtype: triples fallback below
        triples = {}
        ells = {}
        for si, shard in enumerate(p.shard_order):
            if ell is not None and shard in ell:
                dim, icol = ell[shard]
                base = 1 if (icol is not None and icol >= 0) else 0
                k = max(int(lib.ph_shard_max_run(st, si)) + base, 1)
                iarr = np.empty((n, k), np.int32)
                varr = np.empty((n, k), dt)
                out_ct = (ctypes.c_float if dt == np.float32
                          else ctypes.c_double)
                if n:
                    fill(st, si, n, k,
                         icol if base else -1, dim,
                         _np_ptr(iarr, ctypes.c_int32),
                         _np_ptr(varr, out_ct))
                ells[shard] = HostEll(idx=iarr, val=varr, dim=dim)
                continue
            m = lib.ph_shard_nnz(st, si)
            rows = np.empty(m, np.int32)
            idx = np.empty(m, np.int32)
            val = np.empty(m, np.float64)
            if m:
                lib.ph_get_shard_triples(
                    st, si, _np_ptr(rows, ctypes.c_int32),
                    _np_ptr(idx, ctypes.c_int32), _np_ptr(val, ctypes.c_double),
                )
            triples[shard] = (rows, idx, val)
        lib.ph_reset_chunk(st)
        return {"n": n, "num": num, "codes": codes, "triples": triples,
                "ell": ells}

    def dictionaries(self) -> dict:
        """Current per-column unique-string arrays. Dictionaries only grow,
        so each call decodes just the entries added since the last one."""
        out = {}
        for c, name in enumerate(self.program.str_names):
            cache = self._dict_cache.setdefault(name, [])
            _, new_entries = _read_dict_range(
                self.state, c, len(cache),
                self.lib.ph_dict_size,
                self.lib.ph_dict_heap_bytes_from,
                self.lib.ph_get_dict_range,
            )
            cache.extend(new_entries)
            out[name] = np.array(cache, object)
        return out

    def __del__(self):
        if getattr(self, "state", None):
            self.lib.ph_destroy(self.state)
            self.state = None


def iter_container_blocks(path: str):
    """(schema, codec, iterator of (payload_bytes, record_count)) — the
    container framing from io/avro.py, without record decode."""
    import json
    import zlib

    with open(path, "rb") as f:
        if f.read(4) != avro.MAGIC:
            raise SchemaError(f"{path}: not an Avro object container file")
        head = f.read(1 << 16)
        mdec = avro.Decoder({"type": "map", "values": "bytes"})
        while True:
            try:
                meta, pos = mdec.decode(head)
                break
            except IndexError:
                more = f.read(1 << 16)
                if not more:
                    raise SchemaError(f"{path}: truncated container header") from None
                head += more
        schema = json.loads(meta["avro.schema"])
        codec = meta.get("avro.codec", b"null").decode()
        if codec not in ("null", "deflate"):
            raise SchemaError(f"unsupported codec {codec!r}")
        f.seek(4 + pos)
        sync = f.read(avro.SYNC_SIZE)
        data_start = 4 + pos + avro.SYNC_SIZE

    def _mm_varint(mm, pos, end):
        # Shared wire-format decode (avro._read_long) with container-level
        # error mapping; bounds violations surface as IndexError there.
        try:
            v, pos = avro._read_long(mm, pos)
        except IndexError:
            raise SchemaError(f"{path}: truncated avro container") from None
        if pos > end:
            raise SchemaError(f"{path}: truncated avro container")
        return v, pos

    def blocks():
        import zlib

        if codec == "null":
            # Zero-copy: the payload slices are memoryviews over the mmap
            # (the native decoder reads them in place via np.frombuffer) —
            # no kernel read()+copy per block. The mmap stays alive through
            # each yielded slice's refcount.
            import mmap as _mmap

            with open(path, "rb") as f:
                try:
                    mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
                except (ValueError, OSError):
                    mm = None  # empty file / no-mmap fs: buffered fallback
            if mm is not None:
                # No explicit close: a consumer may legitimately hold the
                # last yielded slice past exhaustion, and mmap.close() with
                # exported buffers raises BufferError — refcounting closes
                # the map once every slice drops.
                view = memoryview(mm)
                pos, end = data_start, len(mm)
                while pos < end:
                    count, pos = _mm_varint(mm, pos, end)
                    size, pos = _mm_varint(mm, pos, end)
                    # Negative zigzag decodes would slice from the END of
                    # the map and walk pos backward (hang/garbage) — corrupt
                    # input must fail loud instead.
                    if count < 0 or size < 0 or pos + size > end:
                        raise SchemaError(
                            f"{path}: corrupt avro block header "
                            f"(count={count}, size={size})"
                        )
                    yield view[pos:pos + size], count
                    pos += size
                    if bytes(mm[pos:pos + avro.SYNC_SIZE]) != sync:
                        raise SchemaError(f"{path}: sync marker mismatch")
                    pos += avro.SYNC_SIZE
                return
        with open(path, "rb") as f:
            f.seek(data_start)
            while True:
                hdr = f.read(1)
                if not hdr:
                    return
                count = avro._stream_varint(f, hdr)
                hdr = f.read(1)
                if not hdr:
                    raise SchemaError("truncated avro container")
                size = avro._stream_varint(f, hdr)
                payload = f.read(size)
                if len(payload) < size:
                    raise SchemaError(f"{path}: truncated block payload")
                if codec == "deflate":
                    payload = zlib.decompress(payload, wbits=-15)
                yield payload, count
                if f.read(avro.SYNC_SIZE) != sync:
                    raise SchemaError(f"{path}: sync marker mismatch")

    return schema, codec, blocks()


def iter_blocks_with_retry(
    path: str,
    retries: int = 2,
    backoff_s: float = 0.05,
    sleep: Callable[[float], None] = time.sleep,
):
    """``iter_container_blocks`` with bounded retry of transient IO errors.

    A single flaky read (network filesystem hiccup, object-store 5xx
    surfaced as ``OSError``) used to kill the whole ingest. Here each
    transient ``OSError`` — during the header open or mid-stream — reopens
    the container after an exponential backoff and SKIPS the blocks already
    yielded (block framing is positional, so re-reading and discarding the
    prefix is exact; rows already decoded downstream stay valid). After
    ``retries`` reopens the error propagates. ``FileNotFoundError`` never
    retries: a missing input is a config bug, not a hiccup.

    """
    attempt = 0
    while True:
        try:
            schema, codec, blocks = iter_container_blocks(path)
            break
        except FileNotFoundError:
            raise
        except OSError as e:
            attempt += 1
            if attempt > retries:
                raise
            logger.warning(
                "transient open error on %s (%s); retry %d/%d",
                path, e, attempt, retries,
            )
            sleep(backoff_s * (2 ** (attempt - 1)))

    def gen():
        nonlocal blocks
        attempts = attempt
        yielded = 0
        while True:
            try:
                if blocks is None:
                    # Reopen INSIDE the protected region: during a real
                    # outage the reopen is the call most likely to fail,
                    # and it must draw on the same retry budget.
                    _, _, blocks = iter_container_blocks(path)
                skip = yielded
                for payload, count in blocks:
                    if skip:
                        skip -= 1
                        continue
                    yield payload, count
                    yielded += 1
                return
            except FileNotFoundError:
                raise
            except OSError as e:
                blocks = None
                attempts += 1
                if attempts > retries:
                    raise
                logger.warning(
                    "transient read error on %s block %d (%s); retry %d/%d",
                    path, yielded, e, attempts, retries,
                )
                sleep(backoff_s * (2 ** (attempts - 1)))

    return schema, codec, gen()


def collect_feature_keys(
    paths,
    shard_configs: Mapping[str, object],
    columns=None,
    file_shard: Optional[tuple[int, int]] = None,
    reset_every_rows: int = 1 << 20,
) -> dict:
    """Native-speed feature-index build: one streaming pass that interns
    every decoded ``(name, term)`` into per-shard first-seen-order key sets
    (the reference's distributed ⟦FeatureIndexingDriver⟧ scan, SURVEY.md
    §2.3, at block-decoder throughput instead of per-record Python).

    Returns ``{shard: [(name, term), ...]}`` in first-seen order. Raises
    :class:`Unsupported` when the native decoder or schema dialect is
    unavailable — callers fall back to the per-record scan.
    """
    import json

    from photon_tpu_torch.io.data_reader import InputColumnNames, _expand_paths

    lib = native.get_lib()
    if lib is None:
        raise Unsupported("native decoder unavailable")
    columns = columns or InputColumnNames()
    shard_order = sorted(shard_configs)
    files = _expand_paths(paths)
    if file_shard is not None:
        i, n = file_shard
        files = files[i::n]

    out: dict = {s: [] for s in shard_order}
    seen: dict = {s: set() for s in shard_order}

    def drain(dec) -> None:
        # Pull the keys this decoder added since its last drain. Draining
        # after EVERY file keeps the merged output in record-stream
        # first-seen order even when the schema (hence decoder) alternates
        # between files; keys another decoder saw earlier dedupe here.
        for si, shard in enumerate(dec.program.shard_order):
            dec._drained[si], new_keys = _read_dict_range(
                dec.state, si, dec._drained[si],
                lib.ph_shard_dict_size,
                lib.ph_shard_dict_heap_bytes_from,
                lib.ph_shard_dict_range,
            )
            for k in new_keys:
                if k not in seen[shard]:
                    seen[shard].add(k)
                    name, _, term = k.partition("\x01")
                    out[shard].append((name, term))

    decoders: dict = {}
    for path in files:
        schema, _, blocks = iter_container_blocks(path)
        key = json.dumps(schema, sort_keys=True)
        if key not in decoders:
            prog = compile_program(
                schema, columns, shard_configs,
                {s: None for s in shard_order},   # all shards collect
                id_tag_columns=(), capture_uids=False,
            )
            decoders[key] = NativeDecoder(lib, prog)
            decoders[key]._drained = [0] * len(shard_order)
        dec = decoders[key]
        for payload, count in blocks:
            if dec.decode_block(payload, count) >= reset_every_rows:
                # Row buffers are unused here; drop them so host memory is
                # bounded by unique keys, not rows. Key dicts persist.
                lib.ph_reset_chunk(dec.state)
        drain(dec)
    return out


class StreamingAvroReader:
    """Chunked columnar Avro reader sharing AvroDataReader's configuration.

    ``chunk_rows`` bounds host memory: each yielded chunk holds about that
    many rows regardless of dataset size (block boundaries round it up).
    """

    def __init__(
        self,
        index_maps: Mapping[str, IndexMap],
        shard_configs: Optional[Mapping[str, object]] = None,
        columns=None,
        id_tag_columns: Sequence[str] = (),
        chunk_rows: int = 1 << 20,
        capture_uids: bool = True,
        io_retries: int = 2,
        io_retry_backoff_s: float = 0.05,
    ):
        from photon_tpu_torch.io.data_reader import FeatureShardConfig, InputColumnNames

        self.columns = columns or InputColumnNames()
        # Bounded retry of transient OSErrors per input file (see
        # iter_blocks_with_retry); 0 disables.
        self.io_retries = int(io_retries)
        self.io_retry_backoff_s = float(io_retry_backoff_s)
        self.index_maps = dict(index_maps)
        self.shard_configs = dict(shard_configs) if shard_configs else {
            s: FeatureShardConfig(feature_bags=(self.columns.features,))
            for s in self.index_maps
        }
        self.id_tag_columns = tuple(id_tag_columns)
        self.chunk_rows = int(chunk_rows)
        # uid capture costs one dictionary entry per (typically unique) row;
        # bulk training flows that never write scores back can disable it.
        self.capture_uids = bool(capture_uids)
        self._uid_rows_seen = 0
        self._uid_growth_warned = False
        self._intercepts = {
            shard: self.index_maps[shard].get_index(INTERCEPT_NAME, INTERCEPT_TERM)
            for shard, cfg in self.shard_configs.items()
            if cfg.add_intercept
        }
        self._programs: dict = {}   # schema json -> (Program, NativeDecoder)

    # -- core ---------------------------------------------------------------

    def _decoder_for(self, schema) -> NativeDecoder:
        import json

        lib = native.get_lib()
        if lib is None:
            raise Unsupported("native decoder unavailable")
        key = json.dumps(schema, sort_keys=True)
        if key not in self._programs:
            prog = compile_program(
                schema, self.columns, self.shard_configs, self.index_maps,
                self.id_tag_columns, capture_uids=self.capture_uids,
            )
            self._programs[key] = NativeDecoder(lib, prog)
        return self._programs[key]

    def iter_chunks(
        self,
        paths,
        dtype=np.float32,
        require_labels: bool = True,
        file_shard: Optional[tuple[int, int]] = None,
    ) -> Iterator[GameDataChunk]:
        """Stream chunks. ``file_shard=(i, n)`` reads only every n-th file
        starting at i — the host-parallel ingest model (one reader process
        per core, each owning a file subset, exactly how the reference
        spreads file splits over Spark executors; SURVEY.md §2.6)."""
        from photon_tpu_torch.io.data_reader import _expand_paths

        files = _expand_paths(paths)
        if file_shard is not None:
            i, n = file_shard
            files = files[i::n]
        dec: Optional[NativeDecoder] = None
        pending = 0
        for path in files:
            schema, _, blocks = iter_blocks_with_retry(
                path, retries=self.io_retries,
                backoff_s=self.io_retry_backoff_s,
            )
            d = self._decoder_for(schema)
            if dec is not None and d is not dec and pending:
                yield self._finish_chunk(dec, dtype, require_labels)
                pending = 0
            dec = d
            for payload, count in blocks:
                pending = dec.decode_block(payload, count)
                if pending >= self.chunk_rows:
                    yield self._finish_chunk(dec, dtype, require_labels)
                    pending = 0
        if dec is not None and pending:
            yield self._finish_chunk(dec, dtype, require_labels)

    def _finish_chunk(self, dec: NativeDecoder, dtype, require_labels) -> GameDataChunk:
        chunk = self._assemble_chunk(dec, dtype, require_labels)
        self._note_uid_growth(dec, chunk.n_rows)
        return chunk

    def _note_uid_growth(self, dec: NativeDecoder, n_rows: int) -> None:
        """One-time warning when ``capture_uids=True`` has interned enough
        rows that the uid dictionary plausibly dominates host memory (it
        grows with UNIQUE uids, i.e. ~every row on training data — the
        caveat that used to live only in the module docstring). Threshold
        via ``PHOTON_UID_WARN_ROWS`` (rows; 0 disables)."""
        if not self.capture_uids or self._uid_growth_warned:
            return
        self._uid_rows_seen += int(n_rows)
        try:
            threshold = int(os.environ.get("PHOTON_UID_WARN_ROWS",
                                           str(10_000_000)))
        except ValueError:
            threshold = 10_000_000
        if threshold <= 0 or self._uid_rows_seen < threshold:
            return
        self._uid_growth_warned = True
        try:  # "__uid__" is string column 0 by construction (compile_program)
            dict_entries = int(dec.lib.ph_dict_size(dec.state, 0))
        except Exception:  # noqa: BLE001 - the warning must never kill ingest
            dict_entries = -1
        logger.warning(
            "capture_uids=True has streamed %d rows; the uid dictionary "
            "holds %s unique entries and grows with unique uids for the "
            "whole read — pass capture_uids=False on bulk training flows "
            "that never read uids back (PHOTON_UID_WARN_ROWS tunes or "
            "disables this warning)",
            self._uid_rows_seen,
            dict_entries if dict_entries >= 0 else "unknown",
        )

    def _assemble_chunk(self, dec: NativeDecoder, dtype, require_labels) -> GameDataChunk:
        raw = dec.take_chunk(
            ell={
                shard: (len(self.index_maps[shard]),
                        self._intercepts.get(shard))
                for shard in dec.program.shard_order
            },
            ell_dtype=dtype,
        )
        p = dec.program
        n = raw["n"]
        labels = raw["num"][p.num_names[0]]
        # Alias resolution: configured response first, then aliases in order.
        for alias_col in range(1, p.n_label_cols):
            alias = raw["num"][p.num_names[alias_col]]
            missing = np.isnan(labels)
            labels[missing] = alias[missing]
        if require_labels and np.isnan(labels).any():
            bad = int(np.flatnonzero(np.isnan(labels))[0])
            raise ValueError(
                f"record missing required column (response, chunk row {bad}; "
                f"set require_labels=False to admit unlabeled records)"
            )

        def resolver(name):
            return lambda: dec.dictionaries()[name]

        tag_cols = {}
        for t in self.id_tag_columns:
            codes = raw["codes"][t]
            if (codes < 0).any():
                raise ValueError(
                    f"id tag column {t!r} missing from record and metadataMap"
                )
            tag_cols[t] = DictColumn(codes, resolver(t))
        features = {}
        for shard in p.shard_order:
            if shard in raw["ell"]:  # native direct assembly
                features[shard] = raw["ell"][shard]
                continue
            rows, idx, val = raw["triples"][shard]
            features[shard] = ell_from_triples(
                rows, idx, val, n, dim=len(self.index_maps[shard]),
                dtype=dtype, intercept_index=self._intercepts.get(shard),
            )
        return GameDataChunk(
            labels=labels,
            offsets=raw["num"][p.num_names[p.n_label_cols]],
            weights=raw["num"][p.num_names[p.n_label_cols + 1]],
            uids=DictColumn(raw["codes"]["__uid__"], resolver("__uid__")),
            id_tags=tag_cols,
            features=features,
        )

    # -- full-dataset assembly ---------------------------------------------

    def read(self, paths, device, dtype=np.float32,
             require_labels: bool = True):
        """Concatenate all chunks into a GameDataBundle on ``device``
        (``AvroDataReader``'s output, at the block decoder's speed).
        ``dtype`` is the numpy value dtype (float32 / float64)."""
        return chunks_to_bundle(
            list(self.iter_chunks(paths, dtype, require_labels)),
            self.index_maps, self.id_tag_columns, device, dtype,
        )


def _torch_dtype(dtype):
    import torch

    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def chunks_to_bundle(
    chunks: Sequence[GameDataChunk],
    index_maps: Mapping[str, IndexMap],
    id_tag_columns: Sequence[str],
    device,
    dtype=np.float32,
    staging=None,
):
    """Concatenate streamed chunks (in order) into one GameDataBundle with
    its features on ``device``: shared by in-process, pipelined and
    parallel reads. On CUDA each assembled array is copied through
    ``staging`` (an ``io/prefetch.py`` ``PinnedStaging``, made here if not
    given)."""
    import torch

    from photon_tpu_torch.data.batch import SparseFeatures
    from photon_tpu_torch.io.data_reader import GameDataBundle

    device = torch.device(device)
    if device.type == "cuda":
        if staging is None:
            from photon_tpu_torch.io.prefetch import PinnedStaging

            staging = PinnedStaging(device, slots=2)
        put = staging.put
    else:
        def put(a):
            return torch.from_numpy(a).to(device)

    if not chunks:
        # A valid zero-record dataset (an empty scoring partition, say):
        # an empty bundle, like the per-record reader's.
        empty = np.zeros(0, np.float64)
        return GameDataBundle(
            features={
                s: SparseFeatures(
                    idx=torch.full((0, 1), len(m), dtype=torch.int32,
                                   device=device),
                    val=torch.zeros((0, 1), dtype=_torch_dtype(dtype),
                                    device=device),
                    dim=len(m),
                )
                for s, m in index_maps.items()
            },
            labels=empty, offsets=empty, weights=empty,
            uids=np.zeros(0, object),
            id_tags={t: np.zeros(0, object) for t in id_tag_columns},
        )
    n = sum(c.n_rows for c in chunks)
    labels = np.concatenate([c.labels for c in chunks])
    offsets = np.concatenate([c.offsets for c in chunks])
    weights = np.concatenate([c.weights for c in chunks])
    uids = np.concatenate([c.uids.materialize("") for c in chunks])
    id_tags = {
        t: np.concatenate([c.id_tags[t].materialize() for c in chunks])
        for t in id_tag_columns
    }
    features = {}
    for shard in index_maps:
        dim = len(index_maps[shard])
        k = max(c.features[shard].idx.shape[1] for c in chunks)
        iarr = np.full((n, k), dim, np.int32)
        varr = np.zeros((n, k), np.dtype(dtype))
        at = 0
        for c in chunks:
            sf = c.features[shard]
            m, kk = sf.idx.shape
            iarr[at:at + m, :kk] = sf.idx
            varr[at:at + m, :kk] = sf.val
            at += m
        features[shard] = SparseFeatures(idx=put(iarr), val=put(varr), dim=dim)
    if staging is not None:
        staging.ready([t for sf in features.values() for t in (sf.idx, sf.val)])
    return GameDataBundle(
        features=features,
        labels=labels,
        offsets=offsets,
        weights=weights,
        uids=uids.astype(object),
        id_tags=id_tags,
    )
