"""Feature indexing driver: build per-shard mmap index stores from Avro data.

Port of ``photon_tpu/cli/feature_indexing_driver.py``: one scan of the data
per feature shard assigns every ``(name, term)`` pair a dense column id, in
first-seen order, and writes the partitioned mmap store of
``index/index_map.py`` (the same files the JAX driver writes), which the
training and scoring drivers load with ``--index-dir``. Host work only: the
driver never touches the card, so ``--backend-policy`` (taken, as in the
JAX driver) probes nothing and records the CPU. The JAX driver's
``--telemetry-dir`` and ``--trace-out`` come with the observability slice
and are refused when set.

    python -m photon_tpu_torch.cli.feature_indexing_driver \\
        --data data/train --output-dir index --feature-shard global:features
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from photon_tpu_torch.cli.params import (
    OBSERVABILITY_SLICE,
    add_backend_policy_flag,
    console_main,
    enable_backend_guard,
    parse_feature_shard,
    refuse_unported,
)
from photon_tpu_torch.index.index_map import build_mmap_index
from photon_tpu_torch.io.data_reader import build_index_from_avro
from photon_tpu_torch.utils import PhotonLogger, Timed

# (flag, is it set, why): refused when set, never ignored.
_LATER_SLICES = (
    ("--telemetry-dir", lambda a: a.telemetry_dir is not None,
     f"fleet telemetry {OBSERVABILITY_SLICE}"),
    ("--trace-out", lambda a: a.trace_out is not None,
     f"tracing {OBSERVABILITY_SLICE}"),
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="feature-indexing-driver",
        description="Build per-shard feature index stores from Avro data.",
    )
    p.add_argument("--data", nargs="+", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--feature-shard", action="append", default=None,
                   metavar="SHARD[:BAG+BAG][:no-intercept]",
                   help="shard spec (repeatable); default 'global:features'")
    p.add_argument("--num-partitions", type=int, default=1,
                   help="hash partitions per store")
    add_backend_policy_flag(p)
    p.add_argument("--telemetry-dir", default=None)
    p.add_argument("--trace-out", default=None)
    return p


def run(argv: Optional[Sequence[str]] = None) -> dict:
    p = build_arg_parser()
    args = p.parse_args(argv)
    refuse_unported(p, args, _LATER_SLICES)
    enable_backend_guard(args, device="cpu")    # host work only
    os.makedirs(args.output_dir, exist_ok=True)
    with PhotonLogger(args.output_dir) as logger:
        sizes = {}
        for spec in args.feature_shard or ["global:features"]:
            s = parse_feature_shard(spec)
            with Timed(f"index shard {s.shard}", logger):
                imap = build_index_from_avro(
                    args.data, feature_bags=s.feature_bags,
                    add_intercept=s.add_intercept)
                build_mmap_index(imap, os.path.join(args.output_dir, s.shard),
                                 num_partitions=args.num_partitions)
            sizes[s.shard] = len(imap)
            logger.info("shard %s: %d features", s.shard, len(imap))
        return {"features_per_shard": sizes}


def main() -> None:  # pragma: no cover - console entry
    console_main(run)


if __name__ == "__main__":  # pragma: no cover
    main()
