"""GAME model directory save/load in the reference's Avro layout.

Port of ``photon_tpu/io/model_io.py`` (``save_game_model``,
``load_game_model``, ``_synthetic_random_effect_model``, ``ScoresWriter``,
``save_scores``, ``save_feature_summary`` and ``default_index_root``). The
on-disk layout is the same, so either package reads what the other writes:

    model-dir/
      game-metadata.json                      (coordinate → type/shard/task)
      fixed-effect/<coord>/coefficients.avro  1 BayesianLinearModelAvro
      random-effect/<coord>/part-00000.avro   1 record per entity
      scores .avro via save_scores            ScoringResultAvro
      summary .avro via save_feature_summary  FeatureSummarizationResultAvro

Coefficients are stored as (name, term, value) lists resolved through the
shard's IndexMap. Loading a random-effect coordinate packs the per-entity
sparse vectors into size-bucketed stacks (power-of-two widths), the same
shapes the JAX loader builds.
"""
from __future__ import annotations

import json
import math
import os
from typing import Mapping, Optional

import numpy as np
import torch

from photon_tpu_torch.data.random_effect import numpy_dtype
from photon_tpu_torch.game.coordinates import FixedEffectModel
from photon_tpu_torch.game.descent import GameModel
from photon_tpu_torch.game.random_effect import RandomEffectModel
from photon_tpu_torch.index.index_map import IndexMap, feature_key
from photon_tpu_torch.io.avro import ContainerWriter, read_records, write_container
from photon_tpu_torch.io.schemas import (
    BAYESIAN_LINEAR_MODEL_AVRO,
    FEATURE_SUMMARIZATION_RESULT_AVRO,
    SCORING_RESULT_AVRO,
)
from photon_tpu_torch.models.coefficients import Coefficients
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.types import TaskType

_MODEL_CLASS = {
    TaskType.LOGISTIC_REGRESSION:
        "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel",
    TaskType.LINEAR_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel",
    TaskType.POISSON_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.PoissonRegressionModel",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        "com.linkedin.photon.ml.supervised.classification.SmoothedHingeLossLinearSVMModel",
}

_META = "game-metadata.json"


def default_index_root(model_dir: str) -> str:
    """Index-store root for a training-driver model directory: indexes live
    at ``<out>/index`` while models live at ``<out>/best`` or
    ``<out>/models/<i>`` — walk up past "models", but only for true
    ``models/<i>`` children."""
    norm = os.path.normpath(model_dir)
    parent = os.path.dirname(norm)
    if (os.path.basename(parent) == "models"
            and os.path.basename(norm).isdigit()):
        parent = os.path.dirname(parent)
    return os.path.join(parent, "index")


def _nt_list(imap: IndexMap, indices, values) -> list[dict]:
    out = []
    for i, v in zip(indices, values):
        v = float(v)
        if v == 0.0 or math.isnan(v):
            continue
        name, term = imap.get_feature(int(i))
        out.append({"name": name, "term": term, "value": v})
    return out


def _key_lookup(imap: IndexMap):
    """``(name, term) -> column`` (-1 if absent) for one load: a dict of the
    whole index where the map stores its keys in bulk (``key_blob``), else
    the map's own lookups, memoized (a model names most columns many
    times)."""
    bulk = getattr(imap, "key_blob", None)
    if bulk is not None:
        blob, off = bulk()
        raw = blob.tobytes()
        table = {raw[off[i]:off[i + 1]].decode("utf-8"): i
                 for i in range(len(off) - 1)}
        return lambda name, term: table.get(feature_key(name, term), -1)
    memo: dict = {}

    def lookup(name, term):
        i = memo.get((name, term))
        if i is None:
            i = memo[(name, term)] = imap.get_index(name, term)
        return i

    return lookup


def _from_nt_list(lookup, items) -> tuple[np.ndarray, np.ndarray]:
    idx, val = [], []
    for it in items:
        i = lookup(it["name"], it.get("term"))
        if i >= 0:
            idx.append(i)
            val.append(it["value"])
    return np.asarray(idx, np.int64), np.asarray(val, np.float64)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_game_model(
    model_dir: str,
    model: GameModel,
    index_maps: Mapping[str, IndexMap],
    shard_by_coordinate: Optional[Mapping[str, str]] = None,
    shard_configs: Optional[Mapping[str, object]] = None,
) -> None:
    """Write every coordinate of a GameModel in the reference layout.

    ``shard_configs`` (shard → FeatureShardConfig-like with ``feature_bags``
    and ``add_intercept``) is persisted in the metadata so the scoring driver
    reconstructs the exact feature assembly.
    """
    os.makedirs(model_dir, exist_ok=True)
    meta: dict = {"coordinates": {}}
    if shard_configs:
        meta["feature_shards"] = {
            shard: {
                "feature_bags": list(cfg.feature_bags),
                "add_intercept": bool(cfg.add_intercept),
            }
            for shard, cfg in shard_configs.items()
        }
    shard_by_coordinate = dict(shard_by_coordinate or {})

    for cid in model.keys():
        m = model[cid]
        if isinstance(m, FixedEffectModel):
            shard = shard_by_coordinate.get(cid, m.feature_shard)
            imap = index_maps[shard]
            cdir = os.path.join(model_dir, "fixed-effect", cid)
            os.makedirs(cdir, exist_ok=True)
            coefs = _host(m.model.coefficients.means)
            nz = np.nonzero(coefs)[0]
            rec = {
                "modelId": cid,
                "modelClass": _MODEL_CLASS[m.model.task],
                "lossFunction": m.model.task.value,
                "means": _nt_list(imap, nz, coefs[nz]),
                "variances": None,
            }
            if m.model.coefficients.variances is not None:
                var = _host(m.model.coefficients.variances)
                vnz = np.nonzero(var)[0]
                rec["variances"] = _nt_list(imap, vnz, var[vnz])
            write_container(
                os.path.join(cdir, "coefficients.avro"),
                BAYESIAN_LINEAR_MODEL_AVRO,
                [rec],
            )
            meta["coordinates"][cid] = {
                "type": "fixed",
                "feature_shard": shard,
                "task": m.model.task.value,
            }
        elif isinstance(m, RandomEffectModel):
            shard = shard_by_coordinate.get(cid, "global")
            imap = index_maps[shard]
            cdir = os.path.join(model_dir, "random-effect", cid)
            os.makedirs(cdir, exist_ok=True)

            def entity_records(m=m, imap=imap):
                for key in m.entity_keys:
                    gi, gv, vv = m.export_for(key)
                    yield {
                        "modelId": str(key),
                        "modelClass": _MODEL_CLASS[m.task],
                        "lossFunction": m.task.value,
                        "means": _nt_list(imap, gi, gv),
                        "variances": (
                            _nt_list(imap, gi, vv) if vv is not None else None
                        ),
                    }

            write_container(
                os.path.join(cdir, "part-00000.avro"),
                BAYESIAN_LINEAR_MODEL_AVRO,
                entity_records(),
            )
            meta["coordinates"][cid] = {
                "type": "random",
                "feature_shard": shard,
                "task": m.task.value,
                "re_type": m.re_type,
            }
        else:
            raise TypeError(f"coordinate {cid}: unknown model type {type(m)}")

    with open(os.path.join(model_dir, _META), "w") as f:
        json.dump(meta, f, indent=2)


def load_game_model(
    model_dir: str,
    index_maps: Mapping[str, IndexMap],
    *,
    dtype: torch.dtype,
    device: torch.device,
) -> tuple[GameModel, dict]:
    """Load a model directory → (GameModel, metadata dict), coefficients in
    ``dtype`` on ``device`` (the Avro layout is double either way)."""
    with open(os.path.join(model_dir, _META)) as f:
        meta = json.load(f)

    def put(a: np.ndarray, torch_dtype: torch.dtype = dtype) -> torch.Tensor:
        return torch.as_tensor(a).to(device=device, dtype=torch_dtype)

    models: dict = {}
    lookups: dict = {}
    for cid, info in meta["coordinates"].items():
        shard = info["feature_shard"]
        imap = index_maps[shard]
        if shard not in lookups:
            lookups[shard] = _key_lookup(imap)
        lookup = lookups[shard]
        task = TaskType(info["task"])
        if info["type"] == "fixed":
            recs = read_records(
                os.path.join(model_dir, "fixed-effect", cid, "coefficients.avro")
            )
            if len(recs) != 1:
                raise ValueError(f"{cid}: expected 1 model record, got {len(recs)}")
            gi, gv = _from_nt_list(lookup, recs[0]["means"])
            w = np.zeros(len(imap), np.float64)
            w[gi] = gv
            variances = None
            if recs[0].get("variances"):
                vi, vv = _from_nt_list(lookup, recs[0]["variances"])
                variances = np.zeros(len(imap), np.float64)
                variances[vi] = vv
                variances = put(variances)
            glm = GeneralizedLinearModel(
                Coefficients(means=put(w), variances=variances), task
            )
            models[cid] = FixedEffectModel(glm, info["feature_shard"])
        elif info["type"] == "random":
            cdir = os.path.join(model_dir, "random-effect", cid)
            parts = sorted(
                os.path.join(cdir, p)
                for p in os.listdir(cdir)
                if p.endswith(".avro")
            )
            entity_keys, sparse, sparse_var = [], [], []
            for part in parts:
                for rec in read_records(part):
                    entity_keys.append(rec["modelId"])
                    sparse.append(_from_nt_list(lookup, rec["means"]))
                    # null = variances not computed; [] = entity with no
                    # active features (still "has variances" as a coordinate)
                    sparse_var.append(
                        _from_nt_list(lookup, rec["variances"])
                        if rec.get("variances") is not None
                        else None
                    )
            if any(v is None for v in sparse_var):
                sparse_var = None
            models[cid] = _synthetic_random_effect_model(
                info.get("re_type", cid), task, entity_keys, sparse, len(imap),
                sparse_var, dtype=dtype, device=device,
            )
        else:
            raise ValueError(f"{cid}: unknown coordinate type {info['type']}")
    return GameModel(models), meta


def _synthetic_random_effect_model(
    re_type: str,
    task: TaskType,
    entity_keys: list,
    sparse: list,
    global_dim: int,
    sparse_var: Optional[list] = None,
    *,
    dtype: torch.dtype,
    device: torch.device,
) -> RandomEffectModel:
    """Pack loaded per-entity sparse vectors into SIZE-BUCKETED padded stacks:
    entities group by the next power of two of their active-feature count,
    so a skewed coordinate costs O(Σ 2·nnz_e) memory, not O(E × P_max)."""
    np_dt = numpy_dtype(dtype)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if not entity_keys:
        return RandomEffectModel(
            re_type=re_type, task=task,
            bucket_coefs=[put(np.zeros((1, 1), np_dt))],
            bucket_proj=[put(np.full((1, 1), global_dim, np.int32))],
            bucket_entity_ids=[put(np.zeros((1,), np.int32))],
            entity_keys=[], entity_to_slot={}, global_dim=global_dim,
            bucket_variances=(
                [put(np.zeros((1, 1), np_dt))] if sparse_var is not None else None
            ),
        )

    def pow2(w: int) -> int:
        return 1 if w <= 1 else 1 << (w - 1).bit_length()

    groups: dict = {}
    for i, (gi, _) in enumerate(sparse):
        groups.setdefault(pow2(len(gi)), []).append(i)

    bucket_coefs, bucket_proj, bucket_ids, bucket_var = [], [], [], []
    entity_to_slot: dict = {}
    for b, (p, members) in enumerate(sorted(groups.items())):
        e = len(members)
        proj = np.full((e, p), global_dim, np.int32)
        coefs = np.zeros((e, p), np_dt)
        var = np.zeros((e, p), np_dt) if sparse_var is not None else None
        for slot, i in enumerate(members):
            gi, gv = sparse[i]
            order = np.argsort(gi)  # projection maps sorted by global column
            proj[slot, : len(gi)] = gi[order]
            coefs[slot, : len(gi)] = gv[order]
            if var is not None:
                vi, vv = sparse_var[i]
                vorder = np.argsort(vi)
                if len(vi) != len(gi) or np.any(vi[vorder] != gi[order]):
                    raise ValueError(
                        f"{re_type}: variance indices differ from mean "
                        f"indices for entity {entity_keys[i]!r}"
                    )
                var[slot, : len(vi)] = vv[vorder]
            entity_to_slot[i] = (b, slot)
        bucket_coefs.append(put(coefs))
        bucket_proj.append(put(proj))
        bucket_ids.append(put(np.asarray(members, np.int32)))
        if var is not None:
            bucket_var.append(put(var))
    return RandomEffectModel(
        re_type=re_type,
        task=task,
        bucket_coefs=bucket_coefs,
        bucket_proj=bucket_proj,
        bucket_entity_ids=bucket_ids,
        entity_keys=list(entity_keys),
        entity_to_slot=entity_to_slot,
        global_dim=global_dim,
        bucket_variances=bucket_var if sparse_var is not None else None,
    )


class ScoresWriter:
    """Streaming ScoringResultAvro writer: append per-chunk score arrays as
    they are computed. ``save_scores`` is the one-shot form."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._w = ContainerWriter(path, SCORING_RESULT_AVRO)

    def append(self, scores, uids=None, labels=None) -> None:
        if isinstance(scores, torch.Tensor):
            scores = _host(scores)
        scores = np.asarray(scores, np.float64)
        n = len(scores)
        uids = (
            [None] * n
            if uids is None
            else [None if u is None else str(u) for u in uids]
        )
        labels = (
            [None] * n
            if labels is None
            else [
                None if l is None or l != l  # NaN of any float-like type
                else float(l)
                for l in labels
            ]
        )
        for i in range(n):
            self._w.write({
                "uid": uids[i],
                "predictionScore": float(scores[i]),
                "label": labels[i],
                "metadataMap": None,
            })

    def close(self) -> None:
        self._w.close()

    def __enter__(self) -> "ScoresWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # Unwinding on an exception must not leave a well-formed partial
        # scores file under the final name (see ContainerWriter.abort).
        self._w.__exit__(exc_type, exc, tb)


def save_scores(path: str, scores, uids=None, labels=None) -> None:
    """Write per-row scores as ScoringResultAvro."""
    with ScoresWriter(path) as w:
        w.append(scores, uids=uids, labels=labels)


def save_feature_summary(path: str, imap: IndexMap, stats) -> None:
    """Write a shard's per-feature summary (``data/statistics.py``'s
    ``FeatureDataStatistics``): one FeatureSummarizationResultAvro record a
    feature, in index order."""
    cols = [_host(t).astype(np.float64) for t in (
        stats.mean, stats.variance, stats.min, stats.max, stats.num_nonzeros)]

    def recs():
        for i, (mean, var, mn, mx, nnz) in enumerate(zip(*cols)):
            name, term = imap.get_feature(i)
            yield {"featureName": name, "featureTerm": term,
                   "metrics": {"mean": float(mean), "variance": float(var),
                               "min": float(mn), "max": float(mx),
                               "numNonzeros": float(nnz)}}

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_container(path, FEATURE_SUMMARIZATION_RESULT_AVRO, recs())
