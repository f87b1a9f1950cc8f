"""(name, term) → feature-column index maps, in-memory and mmap-backed.

Port of ``photon_tpu/index/index_map.py``, copied because the port imports
nothing of the JAX package. The store layout is byte-compatible: a store
either package writes, the other opens.

Parity: reference ⟦photon-api/.../index/IndexMap.scala, DefaultIndexMap,
PalDBIndexMap + loaders⟧ (SURVEY.md §2.2 "Feature index"): photon feature
spaces are string ``(name, term)`` pairs joined by the \\x01 delimiter, mapped
to dense column ids; at 10M+ features the map is held **off-heap** in
partitioned memory-mapped PalDB stores so every Spark executor can share one
copy.

Accelerator-side equivalent: the training hot path never touches strings — batches
carry int32 ELL ids — so the index map is a host-side structure used at data
ingest and model export. ``DefaultIndexMap`` is a plain dict; ``MmapIndexMap``
is the PalDB replacement: hash-partitioned, binary-searched, memory-mapped
numpy arrays (sorted u64 key hashes + key-byte blob for collision
verification + a reverse blob ordered by index), so a 10M-feature index costs
~zero resident memory per process and loads in O(1) — same property PalDB
gave the reference.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Iterable, Optional, Sequence

import numpy as np

# Reference convention: feature key = name + "\x01" + term; the intercept is
# a regular feature named "(INTERCEPT)" with empty term.
DELIMITER = "\x01"
INTERCEPT_NAME = "(INTERCEPT)"
INTERCEPT_TERM = ""


def feature_key(name: str, term: Optional[str]) -> str:
    return f"{name}{DELIMITER}{term or ''}"


def _hash64(key: bytes) -> int:
    # Stable across processes/pythons (unlike hash()); 8 bytes of blake2b.
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "little")


class IndexMap:
    """Interface: get_index / get_feature / size / intercept lookup."""

    def get_index(self, name: str, term: Optional[str] = None) -> int:
        """Column id for (name, term), or -1 if absent (reference returns
        IndexMap.NULL_KEY = -1 for unindexed features)."""
        return self.index_of(feature_key(name, term))

    def index_of(self, key: str) -> int:
        raise NotImplementedError

    def get_feature(self, index: int) -> tuple[str, str]:
        """(name, term) for a column id — used at model export."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    @property
    def intercept_index(self) -> Optional[int]:
        i = self.get_index(INTERCEPT_NAME, INTERCEPT_TERM)
        return None if i < 0 else i


class DefaultIndexMap(IndexMap):
    """In-memory dict index — reference ⟦DefaultIndexMap⟧."""

    def __init__(self, keys_in_order: Sequence[str]):
        self._keys = list(keys_in_order)
        self._map = {k: i for i, k in enumerate(self._keys)}
        if len(self._map) != len(self._keys):
            raise ValueError("duplicate feature keys in index")

    def index_of(self, key: str) -> int:
        return self._map.get(key, -1)

    def get_feature(self, index: int) -> tuple[str, str]:
        name, _, term = self._keys[index].partition(DELIMITER)
        return name, term

    def __len__(self) -> int:
        return len(self._keys)

    @property
    def keys_in_order(self) -> list[str]:
        return self._keys


def build_index_from_features(
    name_term_pairs: Iterable[tuple[str, Optional[str]]],
    add_intercept: bool = True,
) -> DefaultIndexMap:
    """Index features in first-seen order (intercept first, as the reference's
    indexing job seeds it)."""
    seen: dict[str, None] = {}
    if add_intercept:
        seen[feature_key(INTERCEPT_NAME, INTERCEPT_TERM)] = None
    for name, term in name_term_pairs:
        seen.setdefault(feature_key(name, term), None)
    return DefaultIndexMap(list(seen.keys()))


# ---------------------------------------------------------------------------
# mmap-backed store (the PalDB replacement)

_META = "index-meta.json"


def build_mmap_index(
    index: DefaultIndexMap, out_dir: str, num_partitions: int = 1
) -> None:
    """Write a DefaultIndexMap as a partitioned mmap store.

    Layout (reference ⟦PalDBIndexMap⟧ partitioning: key → hash % P):
      partition-{p}.hash.npy   sorted u64 key hashes           [M_p]
      partition-{p}.idx.npy    global column ids, hash order   [M_p]
      partition-{p}.off.npy    key-blob offsets, hash order    [M_p + 1]
      partition-{p}.keys.bin   utf-8 key bytes
      reverse.off.npy / reverse.keys.bin   key blob ordered by column id
      index-meta.json          {size, num_partitions}
    """
    os.makedirs(out_dir, exist_ok=True)
    keys = index.keys_in_order
    kb = [k.encode("utf-8") for k in keys]
    hashes = np.fromiter((_hash64(b) for b in kb), np.uint64, len(kb))
    parts = (hashes % np.uint64(num_partitions)).astype(np.int64)

    for p in range(num_partitions):
        members = np.nonzero(parts == p)[0]
        order = members[np.argsort(hashes[members], kind="stable")]
        np.save(os.path.join(out_dir, f"partition-{p}.hash.npy"), hashes[order])
        np.save(
            os.path.join(out_dir, f"partition-{p}.idx.npy"),
            order.astype(np.int64),
        )
        blob = b"".join(kb[i] for i in order)
        off = np.zeros(len(order) + 1, np.int64)
        np.cumsum([len(kb[i]) for i in order], out=off[1:])
        np.save(os.path.join(out_dir, f"partition-{p}.off.npy"), off)
        with open(os.path.join(out_dir, f"partition-{p}.keys.bin"), "wb") as f:
            f.write(blob)

    rev_off = np.zeros(len(kb) + 1, np.int64)
    np.cumsum([len(b) for b in kb], out=rev_off[1:])
    np.save(os.path.join(out_dir, "reverse.off.npy"), rev_off)
    with open(os.path.join(out_dir, "reverse.keys.bin"), "wb") as f:
        f.write(b"".join(kb))
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump({"size": len(kb), "num_partitions": num_partitions}, f)


_KEYS_MAX = 1 << 21        # maps this small hold every key once preloaded


class MmapIndexMap(IndexMap):
    """Memory-mapped partitioned index — loads lazily, shares page cache
    across processes (the PalDB property the reference relied on)."""

    def __init__(self, store_dir: str):
        with open(os.path.join(store_dir, _META)) as f:
            meta = json.load(f)
        self._dir = store_dir
        self._size = int(meta["size"])
        self._nparts = int(meta["num_partitions"])
        self._parts: dict[int, tuple] = {}
        self._rev: Optional[tuple] = None
        # (name, term) -> column of every key, built by ``preload`` for a
        # map of at most _KEYS_MAX keys: the online trainer and the serving
        # parser resolve features one at a time
        self._keys: Optional[dict] = None

    @property
    def store_dir(self) -> str:
        """On-disk store directory — the public handle for reopening this
        map in another process (io/parallel_ingest ships it to workers)."""
        return self._dir

    def _partition(self, p: int):
        if p not in self._parts:
            d = self._dir
            # Plain ndarray views of the maps: a point lookup indexes single
            # elements, which through the np.memmap subclass costs a Python
            # __getitem__ and __array_finalize__ each.
            self._parts[p] = tuple(a.view(np.ndarray) for a in (
                np.load(os.path.join(d, f"partition-{p}.hash.npy"), mmap_mode="r"),
                np.load(os.path.join(d, f"partition-{p}.idx.npy"), mmap_mode="r"),
                np.load(os.path.join(d, f"partition-{p}.off.npy"), mmap_mode="r"),
                np.memmap(
                    os.path.join(d, f"partition-{p}.keys.bin"), np.uint8, "r"
                )
                if os.path.getsize(os.path.join(d, f"partition-{p}.keys.bin"))
                else np.zeros(0, np.uint8),
            ))
        return self._parts[p]

    def preload(self) -> None:
        """Open every partition now (serve-path warmup): point lookups on a
        hot request path must not pay the lazy mmap open + first-touch page
        faults of a cold partition. A map of at most ``_KEYS_MAX`` keys also
        reads every key into one dict, so each later lookup is a dict hit."""
        for p in range(self._nparts):
            self._partition(p)
        if self._keys is None and self._size <= _KEYS_MAX:
            blob, off = self.key_blob()
            raw, bounds = blob.tobytes(), off.tolist()
            keys = {}
            for i in range(self._size):
                name, _, term = raw[bounds[i]:bounds[i + 1]].decode(
                    "utf-8").partition(DELIMITER)
                keys[(name, term)] = i
            self._keys = keys

    def get_index(self, name: str, term: Optional[str] = None) -> int:
        if self._keys is not None:
            return self._keys.get((name, term or ""), -1)
        return self.index_of(feature_key(name, term))

    def index_of(self, key: str) -> int:
        kb = key.encode("utf-8")
        h = _hash64(kb)
        hashes, idx, off, blob = self._partition(h % self._nparts)
        lo = int(hashes.searchsorted(np.uint64(h), side="left"))
        while lo < len(hashes) and int(hashes[lo]) == h:
            s, e = int(off[lo]), int(off[lo + 1])
            if blob[s:e].tobytes() == kb:
                return int(idx[lo])
            lo += 1  # u64-hash collision: scan the run
        return -1

    def get_feature(self, index: int) -> tuple[str, str]:
        if self._rev is None:
            # plain ndarray views, as in _partition
            self._rev = tuple(a.view(np.ndarray) for a in (
                np.load(os.path.join(self._dir, "reverse.off.npy"), mmap_mode="r"),
                np.memmap(
                    os.path.join(self._dir, "reverse.keys.bin"), np.uint8, "r"
                ),
            ))
        off, blob = self._rev
        s, e = int(off[index]), int(off[index + 1])
        name, _, term = blob[s:e].tobytes().decode("utf-8").partition(DELIMITER)
        return name, term

    def key_blob(self) -> tuple[np.ndarray, np.ndarray]:
        """Every key's utf-8 bytes in column order, in bulk: ``(blob uint8,
        offsets int64 [size + 1])`` of the reverse store (key ``i`` is
        ``blob[offsets[i]:offsets[i + 1]]``)."""
        off = np.load(os.path.join(self._dir, "reverse.off.npy"))
        blob = np.fromfile(os.path.join(self._dir, "reverse.keys.bin"), np.uint8)
        return blob, off.astype(np.int64)

    def __len__(self) -> int:
        return self._size
