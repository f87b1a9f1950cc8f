"""GAME scoring driver: load a model directory + data → scores Avro.

Port of ``photon_tpu/cli/game_scoring_driver.py`` (the whole-dataset path).
Reads data through the SAME index maps the model was trained with, loads the
GAME model, scores additively per coordinate (unseen entities → zero model)
and writes ``scores.avro`` (``ScoringResultAvro`` records) and
``scoring-summary.json`` into ``--output-dir``.

The model directory written by either package's training driver carries its
index maps (``<output>/index/<shard>``) and per-coordinate metadata, so only
``--model-dir`` and data paths are required.

Runs on the card by default (``--device cuda``, which fails when no GPU is
visible); ``--device cpu`` runs the plain versions of the kernels.
``--evaluators``, ``--chunk-rows`` other than 0 and ``--devices`` other than
1 belong to later slices of the port and are refused.

    python -m photon_tpu_torch.cli.game_scoring_driver --data DATA.avro \\
        --model-dir OUT/best --output-dir SCORES [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch

from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.estimators.config import (
    FixedEffectDataConfig,
    RandomEffectDataConfig,
)
from photon_tpu_torch.estimators.game_transformer import GameTransformer
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
                   help="not in this slice of the port (evaluation slice)")
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
                   help="only 0 (whole dataset): streamed scoring is a later slice")
    return p


def _parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = build_arg_parser()
    args = p.parse_args(argv)
    if args.evaluators:
        p.error("--evaluators: evaluation is not in the port yet "
                "(it comes with the evaluation slice)")
    if args.chunk_rows != 0:
        p.error("--chunk-rows: streamed scoring is not in the port yet "
                "(it comes with the streaming ingest slice); use 0")
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
        with Timed("read data", logger) as t_read:
            bundle = reader.read(args.data, dtype=dtype, device=device,
                                 require_labels=False)
        logger.info("scoring %d rows on %s", bundle.n_rows, device)
        with Timed("score", logger) as t_score:
            scores = transformer.transform(bundle)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        with Timed("save scores", logger):
            save_scores(
                scores_path, scores, uids=bundle.uids, labels=bundle.labels
            )
        summary = {"n_rows": int(bundle.n_rows), "evaluation": None}
        with open(os.path.join(args.output_dir, "scoring-summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        logger.info("done: %s (read %.3fs, score %.3fs)", summary,
                    t_read.seconds, t_score.seconds)
        return summary


def main() -> None:  # pragma: no cover - console entry
    run()


if __name__ == "__main__":  # pragma: no cover
    main()
