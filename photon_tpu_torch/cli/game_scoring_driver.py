"""GAME scoring driver: load a model directory + data → scores Avro.

Port of ``photon_tpu/cli/game_scoring_driver.py``: the whole-dataset path
and the streamed one (``--chunk-rows``).
Reads data through the SAME index maps the model was trained with, loads the
GAME model, scores additively per coordinate (unseen entities → zero model)
and writes ``scores.avro`` (``ScoringResultAvro`` records) and
``scoring-summary.json`` into ``--output-dir``.

The model directory written by either package's training driver carries its
index maps (``<output>/index/<shard>``) and per-coordinate metadata, so only
``--model-dir`` and data paths are required.

Runs on the card by default (``--device cuda``, which fails when no GPU is
visible); ``--device cpu`` runs the plain versions of the kernels.
``--evaluators`` evaluates the scores against the data's labels (grouped
evaluators read their id-tag columns) into the summary. ``--chunk-rows N``
streams the data through the block decoder N rows at a time (each chunk
padded to a multiple of N rows and to the widest K seen, as the JAX driver
pads it), scores each chunk and appends its scores; the whole-dataset path
(0) reads through the same decoder. ``--devices`` other than 1 belongs to
the multi-GPU slice and is refused.

    python -m photon_tpu_torch.cli.game_scoring_driver --data DATA.avro \\
        --model-dir OUT/best --output-dir SCORES [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.estimators.config import (
    FixedEffectDataConfig,
    RandomEffectDataConfig,
)
from photon_tpu_torch.estimators.game_transformer import GameTransformer
from photon_tpu_torch.evaluation import EvaluationSuite
from photon_tpu_torch.index.index_map import MmapIndexMap
from photon_tpu_torch.io.data_reader import (
    AvroDataReader,
    FeatureShardConfig,
    InputColumnNames,
)
from photon_tpu_torch.io.model_io import (
    default_index_root,
    load_game_model,
    save_scores,
)
from photon_tpu_torch.utils import PhotonLogger, Timed

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="game-scoring-driver",
        description="Score data with a trained GAME model (PyTorch/CUDA).",
    )
    p.add_argument("--data", nargs="+", required=True)
    p.add_argument("--model-dir", required=True,
                   help="a 'best' or 'models/<i>' directory from the training driver")
    p.add_argument("--index-dir", default=None,
                   help="per-shard index stores (default: <model-dir>/../index)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--evaluators", nargs="+", default=None,
                   help="evaluator specs over the scored data (AUC, RMSE, "
                        "AUC:col, PRECISION@k:col, ...)")
    p.add_argument("--feature-bags", nargs="+", default=["features"],
                   help="record fields holding feature lists (per training config)")
    p.add_argument("--response-column", default="response")
    p.add_argument("--uid-column", default="uid")
    p.add_argument("--dtype", default="float32", choices=sorted(_DTYPES),
                   help="scoring precision")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where scoring runs (default cuda; no fallback)")
    p.add_argument("--devices", type=int, default=1,
                   help="only 1: multi-device scoring is a later slice")
    p.add_argument("--chunk-rows", type=int, default=0,
                   help="stream and score this many rows at a time (0: the "
                        "whole dataset at once)")
    return p


def _parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = build_arg_parser()
    args = p.parse_args(argv)
    if args.chunk_rows < 0:
        p.error("--chunk-rows must be >= 0")
    if args.devices != 1:
        p.error("--devices: multi-device scoring is not in the port yet "
                "(it comes with the multi-GPU slice); use 1")
    return args


def run(argv: Optional[Sequence[str]] = None) -> dict:
    args = _parse(argv)
    device = resolve_device(args.device)
    dtype = _DTYPES[args.dtype]
    os.makedirs(args.output_dir, exist_ok=True)
    with PhotonLogger(args.output_dir) as logger:
        with open(os.path.join(args.model_dir, "game-metadata.json")) as f:
            meta = json.load(f)
        shards = {info["feature_shard"] for info in meta["coordinates"].values()}

        index_root = args.index_dir or default_index_root(args.model_dir)
        index_maps = {
            s: MmapIndexMap(os.path.join(index_root, s)) for s in sorted(shards)
        }
        with Timed("load model", logger):
            model, meta = load_game_model(
                args.model_dir, index_maps, dtype=dtype, device=device
            )

        # Reconstruct per-coordinate data configs from model metadata.
        data_configs = {}
        id_tags = set()
        for cid, info in meta["coordinates"].items():
            if info["type"] == "fixed":
                data_configs[cid] = FixedEffectDataConfig(info["feature_shard"])
            else:
                data_configs[cid] = RandomEffectDataConfig(
                    re_type=info["re_type"], feature_shard=info["feature_shard"]
                )
                id_tags.add(info["re_type"])
        suite = EvaluationSuite.parse(args.evaluators) if args.evaluators else None
        if suite:
            id_tags |= {ev.group_column for ev in suite.evaluators
                        if ev.group_column}

        # Shard configs persisted at training time are authoritative; the
        # --feature-bags flag is only a fallback for pre-metadata models.
        saved_shards = meta.get("feature_shards", {})
        shard_cfgs = {
            s: (
                FeatureShardConfig(
                    feature_bags=tuple(saved_shards[s]["feature_bags"]),
                    add_intercept=saved_shards[s]["add_intercept"],
                )
                if s in saved_shards
                else FeatureShardConfig(feature_bags=tuple(args.feature_bags))
            )
            for s in index_maps
        }
        reader = AvroDataReader(
            index_maps,
            shard_cfgs,
            columns=InputColumnNames(
                uid=args.uid_column, response=args.response_column
            ),
            id_tag_columns=sorted(id_tags),
        )
        transformer = GameTransformer(
            model,
            data_configs,
            intercept_indices={
                s: im.intercept_index for s, im in index_maps.items()
            },
        )
        scores_path = os.path.join(args.output_dir, "scores.avro")
        if args.chunk_rows > 0:
            n_rows, evaluation, reader_used = _score_chunked(
                args, reader, transformer, suite, scores_path, logger, dtype,
                device)
        else:
            with Timed("read data", logger) as t_read:
                # Labels are required only when evaluators are requested.
                bundle = reader.read(args.data, dtype=dtype, device=device,
                                     require_labels=suite is not None)
            reader_used = reader.last_reader
            logger.info("scoring %d rows on %s (%s reader)", bundle.n_rows,
                        device, reader_used)
            evaluation = None
            with Timed("score", logger) as t_score:
                if suite:
                    scores, evaluation = transformer.transform_and_evaluate(
                        bundle, suite)
                else:
                    scores = transformer.transform(bundle)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            with Timed("save scores", logger):
                save_scores(
                    scores_path, scores, uids=bundle.uids, labels=bundle.labels
                )
            n_rows = bundle.n_rows
            logger.info("read %.3fs, score %.3fs", t_read.seconds,
                        t_score.seconds)
        summary = {
            "n_rows": int(n_rows),
            "evaluation": dict(evaluation.values) if evaluation else None,
            "reader": reader_used,
        }
        with open(os.path.join(args.output_dir, "scoring-summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        logger.info("done: %s", summary)
        return summary


def _score_chunked(args, reader, transformer, suite, scores_path, logger,
                   dtype, device):
    """Stream, score and append, chunk by chunk: ``(n_rows, evaluation,
    reader)``. Rows and each shard's K are padded to stable shapes (rows to
    the next ``--chunk-rows`` multiple: chunks end on Avro block
    boundaries). A schema outside the streaming engine's dialect falls back
    to the whole-dataset per-record path."""
    from photon_tpu_torch.estimators.game_transformer import evaluate_scored_arrays
    from photon_tpu_torch.data.random_effect import numpy_dtype
    from photon_tpu_torch.io.model_io import ScoresWriter
    from photon_tpu_torch.io.streaming import StreamingAvroReader, Unsupported

    sr = StreamingAvroReader(reader.index_maps, reader.shard_configs,
                             reader.columns, reader.id_tag_columns,
                             chunk_rows=args.chunk_rows)
    n_rows = 0
    k_targets: dict = {}
    acc_scores, acc_labels, acc_weights = [], [], []
    # Grouped evaluators need every row's group id: dictionary-encoded per
    # chunk, so what accumulates is int32 codes and one entry per group.
    group_cols = ({ev.group_column for ev in suite.evaluators if ev.group_column}
                  if suite else set())
    tag_codes: dict = {col: {} for col in group_cols}
    acc_tags: dict = {col: [] for col in group_cols}

    def encode_tags(col, values):
        cmap = tag_codes[col]
        uniq, inv = np.unique(np.asarray(values, object), return_inverse=True)
        lut = np.fromiter((cmap.setdefault(u, len(cmap)) for u in uniq),
                          np.int32, len(uniq))
        return lut[inv.reshape(-1).astype(np.int64)]

    with Timed("score chunked", logger), ScoresWriter(scores_path) as writer:
        try:
            for chunk in sr.iter_chunks(args.data, dtype=numpy_dtype(dtype),
                                        require_labels=suite is not None):
                for s, sf in chunk.features.items():
                    k_targets[s] = max(k_targets.get(s, 0), sf.idx.shape[1])
                n_pad = -(-chunk.n_rows // args.chunk_rows) * args.chunk_rows
                bundle = chunk.to_bundle(device, dtype, pad_rows_to=n_pad,
                                         pad_nnz_to=k_targets)
                scores = transformer.transform(bundle)[: chunk.n_rows]
                writer.append(scores, uids=bundle.uids[: chunk.n_rows],
                              labels=chunk.labels)
                if suite:
                    acc_scores.append(scores)
                    acc_labels.append(chunk.labels)
                    acc_weights.append(chunk.weights)
                    for col in group_cols:
                        acc_tags[col].append(encode_tags(
                            col, bundle.id_tags[col][: chunk.n_rows]))
                n_rows += chunk.n_rows
                logger.info("scored %d rows", n_rows)
        except Unsupported as e:
            if n_rows:
                # Chunks were written already: a per-record restart would
                # duplicate them.
                raise
            bundle = reader.fall_back(e, args.data, dtype=dtype, device=device,
                                      require_labels=suite is not None)
            evaluation = None
            if suite:
                scores, evaluation = transformer.transform_and_evaluate(
                    bundle, suite)
            else:
                scores = transformer.transform(bundle)
            writer.append(scores, uids=bundle.uids, labels=bundle.labels)
            return bundle.n_rows, evaluation, reader.last_reader
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    evaluation = None
    if suite and n_rows:
        evaluation = evaluate_scored_arrays(
            suite, torch.cat(acc_scores), np.concatenate(acc_labels),
            np.concatenate(acc_weights), {},
            factorized={col: (np.concatenate(parts), len(tag_codes[col]))
                        for col, parts in acc_tags.items()})
    return n_rows, evaluation, "native"


def main() -> None:  # pragma: no cover - console entry
    run()


if __name__ == "__main__":  # pragma: no cover
    main()
