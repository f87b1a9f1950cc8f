"""Avro training data → ELL feature tensors per feature shard.

Port of ``photon_tpu/io/data_reader.py``: ``InputColumnNames``,
``FeatureShardConfig``, ``GameDataBundle``, ``AvroDataReader`` and
``build_index_from_avro``. ``read()`` decodes through the streaming block
engine and the native decoder (``io/streaming.py``); only a schema that
engine cannot express (``Unsupported``) falls back, logged, to the
per-record path ``read_per_record``, which gives the same bundle and is
the oracle the streaming reader is tested against. The index scan of
``build_index_from_avro`` likewise runs through the decoder's collect mode.

Records are ``TrainingExampleAvro``-shaped: every ``(name, term)`` feature is
looked up in the shard's index map and one sparse row is assembled per shard,
with response / offset / weight / uid / entity-id columns alongside. Entity
ids come from the record's ``metadataMap`` or a top-level field of that name.
"""
from __future__ import annotations

import dataclasses
import glob as globlib
import logging
import os
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.data.batch import LabeledBatch, ell_from_rows
from photon_tpu_torch.data.random_effect import numpy_dtype
from photon_tpu_torch.index.index_map import (
    INTERCEPT_NAME,
    INTERCEPT_TERM,
    DefaultIndexMap,
    IndexMap,
    build_index_from_features,
)
from photon_tpu_torch.io.avro import read_container

logger = logging.getLogger("photon_tpu_torch.io")


@dataclasses.dataclass(frozen=True)
class InputColumnNames:
    """Input column names (reference ``InputColumnsNames`` defaults)."""

    uid: str = "uid"
    response: str = "response"
    offset: str = "offset"
    weight: str = "weight"
    features: str = "features"
    # Reference data often uses "label" instead of "response".
    response_aliases: tuple = ("response", "label")


def response_columns(columns: "InputColumnNames") -> tuple:
    """Label-column lookup order: an explicitly configured response column is
    authoritative; the conventional aliases only apply to the default
    configuration."""
    if columns.response in columns.response_aliases:
        return (columns.response,) + tuple(
            a for a in columns.response_aliases if a != columns.response
        )
    return (columns.response,)


@dataclasses.dataclass(frozen=True)
class FeatureShardConfig:
    """Which feature bags make up one shard, plus its intercept switch."""

    feature_bags: tuple = ("features",)
    add_intercept: bool = True


@dataclasses.dataclass
class GameDataBundle:
    """All rows of a dataset in one fixed global order.

    ``features[shard]`` are ELL ``SparseFeatures`` on one device;
    ``id_tags[column]`` are numpy string arrays (entity ids for random
    effects). Labels, offsets, weights and uids stay host numpy.
    """

    features: dict
    labels: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray
    uids: np.ndarray
    id_tags: dict

    @property
    def n_rows(self) -> int:
        return len(self.labels)

    @property
    def device(self) -> torch.device:
        devices = {f.device for f in self.features.values()}
        if len(devices) != 1:
            raise ValueError(f"features span devices {devices}; expected one")
        return devices.pop()

    def batch(self, shard: str) -> LabeledBatch:
        """One shard's batch, row columns in the feature values' dtype."""
        feats = self.features[shard]

        def col(a):
            return torch.as_tensor(np.asarray(a), dtype=feats.dtype, device=feats.device)

        return LabeledBatch(
            features=feats,
            labels=col(self.labels),
            offsets=col(self.offsets),
            weights=col(self.weights),
        )


def _expand_paths(paths) -> list[str]:
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            out.extend(sorted(globlib.glob(os.path.join(p, "*.avro"))))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(globlib.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no avro files under {paths}")
    return out


class AvroDataReader:
    """Read avro records into a GameDataBundle through per-shard index maps."""

    def __init__(
        self,
        index_maps: Mapping[str, IndexMap],
        shard_configs: Optional[Mapping[str, FeatureShardConfig]] = None,
        columns: InputColumnNames = InputColumnNames(),
        id_tag_columns: Sequence[str] = (),
    ):
        self.index_maps = dict(index_maps)
        self.shard_configs = dict(shard_configs) if shard_configs else {
            s: FeatureShardConfig(feature_bags=(columns.features,))
            for s in self.index_maps
        }
        if set(self.shard_configs) != set(self.index_maps):
            raise ValueError(
                f"shard configs {set(self.shard_configs)} != index maps "
                f"{set(self.index_maps)}"
            )
        self.columns = columns
        self.id_tag_columns = tuple(id_tag_columns)
        self._streaming = None
        self.last_reader: Optional[str] = None

    def read(
        self, paths, *, dtype: torch.dtype, device: torch.device,
        require_labels: bool = True, capture_uids: bool = True,
        depth: Optional[int] = 0, workers: int = 0, feed_dtype=None,
    ) -> GameDataBundle:
        """Read Avro files into a bundle with its features on ``device``.
        ``require_labels=False`` admits unlabeled records (label → NaN), as
        scoring does; ``capture_uids=False`` leaves the uid column empty
        (training never reads it).

        Decodes through the streaming block engine (``io/prefetch.py``'s
        ``read_bundle_pipelined``: ``depth`` chunks decoded ahead on a
        thread, None for ``PHOTON_PREFETCH_DEPTH``; ``workers > 1`` decodes
        on the worker pool of ``io/parallel_ingest.py``); a schema it
        cannot express falls back to ``read_per_record``, with the same
        results. ``last_reader`` names the reader that ran (``"native"`` or
        ``"per_record"``). ``feed_dtype`` (``"bfloat16"``) narrows the
        feature values on the host before their copy, on the streaming read
        only (the per-record fallback keeps ``dtype``, as the JAX driver's
        does)."""
        from photon_tpu_torch.io.prefetch import read_bundle_pipelined
        from photon_tpu_torch.io.streaming import StreamingAvroReader, Unsupported

        try:
            if self._streaming is None or (
                    self._streaming.capture_uids != capture_uids):
                # Cached: the per-shard hash tables and compiled programs are
                # fixed by the configuration and reused across reads.
                self._streaming = StreamingAvroReader(
                    self.index_maps, self.shard_configs, self.columns,
                    self.id_tag_columns, capture_uids=capture_uids)
            bundle = read_bundle_pipelined(
                self.index_maps, self.shard_configs, self.columns,
                self.id_tag_columns, paths, device, dtype=numpy_dtype(dtype),
                require_labels=require_labels, depth=depth, workers=workers,
                reader=self._streaming, feed_dtype=feed_dtype)
            self.last_reader = "native"
            return bundle
        except Unsupported as e:
            return self.fall_back(e, paths, dtype=dtype, device=device,
                                  require_labels=require_labels,
                                  capture_uids=capture_uids)

    def fall_back(self, reason, paths, **kw) -> GameDataBundle:
        """``read_per_record`` in place of a streaming read that raised
        ``Unsupported`` (``reason``): logged, and named in
        ``last_reader``."""
        logger.info("streaming ingest unavailable (%s); per-record read", reason)
        self.last_reader = "per_record"
        return self.read_per_record(paths, **kw)

    def read_per_record(
        self, paths, *, dtype: torch.dtype, device: torch.device,
        require_labels: bool = True, capture_uids: bool = True,
    ) -> GameDataBundle:
        """Per-record pure-Python decode, as the JAX ``read_per_record``:
        the oracle of the streaming engine and the fallback for schemas its
        compiler cannot express."""
        cols = self.columns
        labels, offsets, weights, uids = [], [], [], []
        tags: dict[str, list] = {t: [] for t in self.id_tag_columns}
        shard_rows: dict[str, list] = {s: [] for s in self.index_maps}
        response_cols = response_columns(cols)
        intercepts = {
            shard: self.index_maps[shard].get_index(INTERCEPT_NAME, INTERCEPT_TERM)
            for shard, cfg in self.shard_configs.items()
            if cfg.add_intercept
        }
        # (name, term) -> column per shard: a feature recurs across records,
        # and a store lookup hashes and searches each time.
        seen: dict[str, dict] = {s: {} for s in self.index_maps}

        for rec in _iter_records(_expand_paths(paths)):
            lab = _first(rec, response_cols, required=require_labels)
            labels.append(float("nan") if lab is None else lab)
            offsets.append(rec.get(cols.offset) or 0.0)
            w = rec.get(cols.weight)
            weights.append(1.0 if w is None else w)
            if capture_uids:
                uids.append(rec.get(cols.uid) or "")
            meta = rec.get("metadataMap") or {}
            for t in self.id_tag_columns:
                v = rec.get(t)
                if v is None:  # absent OR null top-level field → metadataMap
                    v = meta.get(t)
                if v is None:
                    raise ValueError(
                        f"id tag column {t!r} missing from record and metadataMap"
                    )
                tags[t].append(str(v))

            for shard, cfg in self.shard_configs.items():
                imap, memo = self.index_maps[shard], seen[shard]
                idxs, vals = [], []
                if cfg.add_intercept:
                    ii = intercepts[shard]
                    if ii >= 0:
                        idxs.append(ii)
                        vals.append(1.0)
                for bag in cfg.feature_bags:
                    for feat in rec.get(bag) or ():
                        key = (feat["name"], feat.get("term"))
                        i = memo.get(key)
                        if i is None:
                            i = memo[key] = imap.get_index(*key)
                        if i >= 0:  # unindexed features dropped, as reference
                            idxs.append(i)
                            vals.append(feat["value"])
                shard_rows[shard].append((idxs, vals))

        features = {
            shard: ell_from_rows(
                rows, dim=len(self.index_maps[shard]), dtype=dtype, device=device
            )
            for shard, rows in shard_rows.items()
        }
        return GameDataBundle(
            features=features,
            labels=np.asarray(labels, np.float64),
            offsets=np.asarray(offsets, np.float64),
            weights=np.asarray(weights, np.float64),
            uids=(np.asarray(uids, object) if capture_uids
                  else np.full(len(labels), "", object)),
            id_tags={t: np.asarray(v, object) for t, v in tags.items()},
        )


def _iter_records(files: list[str]) -> Iterable[dict]:
    for path in files:
        _, it = read_container(path)
        yield from it


def _first(rec: dict, names, required: bool = False):
    for n in names:
        v = rec.get(n)
        if v is not None:
            return v
    if required:
        raise ValueError(f"record missing required column (any of {names}): {rec}")
    return None


def build_index_from_avro(
    paths,
    feature_bags: Sequence[str] = ("features",),
    add_intercept: bool = True,
) -> DefaultIndexMap:
    """Scan Avro files and index every (name, term) seen, in first-seen
    order with the intercept first: through the native decoder's collect
    mode, else (``Unsupported``) the per-record scan, which indexes in the
    same order. Bags are read in record field order."""
    from photon_tpu_torch.io.streaming import Unsupported, collect_feature_keys

    try:
        keys = collect_feature_keys(
            paths, {"__index__": FeatureShardConfig(tuple(feature_bags))})
        return build_index_from_features(keys["__index__"],
                                         add_intercept=add_intercept)
    except Unsupported:
        pass
    bags = set(feature_bags)

    def pairs():
        for rec in _iter_records(_expand_paths(paths)):
            for field, items in rec.items():
                if field in bags:
                    for feat in items or ():
                        yield feat["name"], feat.get("term")

    return build_index_from_features(pairs(), add_intercept=add_intercept)
