"""Feature indexing driver: build per-shard mmap index stores from Avro data.

Port of ``photon_tpu/cli/feature_indexing_driver.py``: one scan of the data
per feature shard assigns every ``(name, term)`` pair a dense column id, in
first-seen order, and writes the partitioned mmap store of
``index/index_map.py`` (the same files the JAX driver writes), which the
training and scoring drivers load with ``--index-dir``. Host work only.

The JAX driver's ``--backend-policy``, ``--telemetry-dir`` and
``--trace-out`` belong to the runtime-guards slice (M13) and are refused
when set.

    python -m photon_tpu_torch.cli.feature_indexing_driver \\
        --data data/train --output-dir index --feature-shard global:features
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from photon_tpu_torch.cli.params import parse_feature_shard
from photon_tpu_torch.index.index_map import build_mmap_index
from photon_tpu_torch.io.data_reader import build_index_from_avro
from photon_tpu_torch.utils import PhotonLogger, Timed

# (flag, is it set, the slice it comes with): refused when set.
_LATER_SLICES = (
    ("--backend-policy", lambda a: a.backend_policy is not None,
     "backend policies come with the runtime-guards slice (M13)"),
    ("--telemetry-dir", lambda a: a.telemetry_dir is not None,
     "fleet telemetry comes with the observability part of the runtime-guards "
     "slice (M13)"),
    ("--trace-out", lambda a: a.trace_out is not None,
     "tracing comes with the observability part of the runtime-guards slice "
     "(M13)"),
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
    p.add_argument("--backend-policy", default=None)
    p.add_argument("--telemetry-dir", default=None)
    p.add_argument("--trace-out", default=None)
    return p


def run(argv: Optional[Sequence[str]] = None) -> dict:
    p = build_arg_parser()
    args = p.parse_args(argv)
    for flag, is_set, later in _LATER_SLICES:
        if is_set(args):
            p.error(f"{flag}: not in the port yet; {later}")
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
    run()


if __name__ == "__main__":  # pragma: no cover
    main()
