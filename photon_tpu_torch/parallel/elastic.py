"""Elastic multi-host GAME training over :class:`MeshMembership`.

Port of ``photon_tpu/parallel/elastic.py``. Upstream photon-ml broadcasts
the coefficients every L-BFGS iteration and ``treeAggregate``s
per-partition (value, gradient) partials across Spark executors, and
survives the loss of an executor because the partials are keyed by
partition, not by executor. This module is that design over explicit
collectives in host space:

* **Fixed-effect coordinate**: every host runs the same deterministic
  host-space L-BFGS (:func:`_host_lbfgs`, numpy f64) in lockstep. Each
  (value, gradient) evaluation is the data-only
  ``GLMObjective.value_and_grad`` over each owned part's ``LabeledBatch`` on
  the worker's device (the hand-written matvec and ``csc_rmatvec`` kernels
  on a card; each part's layouts built once, when the part is first owned),
  or, with a local mesh, over the part's row shards folded by
  ``parallel/mesh.fold`` in f64 and in shard order; then one
  :meth:`MeshMembership.reduce_parts` round. Partials are keyed by part id
  and folded in part order, so the global (value, gradient), and with it
  the whole trajectory, is bit-identical under any assignment of parts to
  hosts: a shrink changes who computes which part, not what is summed. L2
  is added once, globally.
* **Random-effect coordinate**: entities hash to hosts over the current
  members (``owner_of_entity``); hosts exchange rows so each owns all rows
  of its entities (:meth:`MeshMembership.exchange`), then run the port's
  ``train_random_effects`` on a host-local dataset, warm-started from the
  last committed per-entity coefficients. Buckets are padded to a fixed
  entity capacity (``_pad_bucket`` to ``e_cap``), so bucket shapes do not
  depend on the membership. Per-entity coefficients and per-row scores are
  published every step and every host folds all publications: the state is
  replicated, and any host can take over a dead host's entities from the
  last commit.
* **Commit and redo**: after every coordinate step the coordinator writes
  ``commits/commit-<n>`` (fixed w, the global random-effect score vector,
  every entity's coefficients). On :class:`HostLostError` the survivors run
  the coordinated shrink (``handle_loss``) and redo the step in flight
  from the last commit under the new epoch; a rejoining host is admitted
  at the next step boundary (``maybe_grow``) and resumes from the same
  commit.

No ``torch.distributed`` on this path: a gloo or NCCL group cannot shrink
or re-form after a peer dies, so elasticity needs host-space collectives.
The process group of ``parallel/distributed.initialize_distributed`` stays
the static bring-up for healthy fleets.

The JAX module's retrace sentinel guards against recompiles after a
membership change; here nothing compiles per shape, and ``final.json``
reports what it protects instead: ``new_shapes_after_warmup``, the part or
bucket shapes first seen after the first sweep (0 across a shrink and a
regrow, because the padding keeps them membership-invariant).

Drill: ``scripts/multihost_smoke_torch.py`` (SIGKILL and rejoin).
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.parallel.distributed import HostLostError, MeshMembership

__all__ = [
    "ElasticConfig",
    "ElasticTrainer",
    "load_manifest",
    "make_synthetic_parts",
    "merge_mesh_cost_tables",
    "worker_main",
]


# ---------------------------------------------------------------------------
# Synthetic part files (drill, tests and chip_smoke fixture)
# ---------------------------------------------------------------------------


def make_synthetic_parts(
    out_dir: str,
    n_parts: int = 6,
    rows_per_part: int = 48,
    dim: int = 10,
    n_entities: int = 18,
    seed: int = 7,
    task: str = "LOGISTIC_REGRESSION",
) -> str:
    """Write ``n_parts`` npz part files + a manifest; returns the manifest
    path. Rows are dense ELL (K == dim) and entities interleave across
    parts (``entity = global_row % n_entities``), so every host's file
    shard holds rows of every entity — the row exchange is genuinely
    exercised. Keep ``(n_parts * rows_per_part) % n_entities == 0`` so
    every entity has the same global row count (membership-invariant RE
    bucket shapes; see module docstring)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_rows = n_parts * rows_per_part
    w_fix = rng.normal(0.0, 0.7, dim)
    w_ent = rng.normal(0.0, 0.4, (n_entities, dim))
    parts = []
    for p in range(n_parts):
        rows = np.arange(p * rows_per_part, (p + 1) * rows_per_part)
        ent = rows % n_entities
        val = rng.normal(0.0, 1.0, (rows_per_part, dim))
        z = val @ w_fix + np.einsum("rd,rd->r", val, w_ent[ent])
        if task == "LINEAR_REGRESSION":
            labels = z + rng.normal(0.0, 0.1, rows_per_part)
        else:
            labels = (rng.random(rows_per_part)
                      < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
        pid = f"p{p:03d}"
        path = os.path.join(out_dir, f"{pid}.npz")
        np.savez(
            path,
            idx=np.tile(np.arange(dim, dtype=np.int32), (rows_per_part, 1)),
            val=val.astype(np.float64),
            labels=labels.astype(np.float64),
            weights=np.ones(rows_per_part),
            entity=ent.astype(np.int64),
            row_id=rows.astype(np.int64),
        )
        parts.append({"id": pid, "path": f"{pid}.npz",
                      "rows": int(rows_per_part)})
    manifest = {
        "schema": "photon-elastic-manifest/1",
        "task": task,
        "dim": int(dim),
        "n_rows": int(n_rows),
        "n_entities": int(n_entities),
        "rows_per_part": int(rows_per_part),
        "parts": parts,
    }
    mpath = os.path.join(out_dir, "manifest.json")
    tmp = f"{mpath}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, mpath)
    return mpath


def load_manifest(path: str) -> dict:
    with open(path) as f:
        m = json.load(f)
    if m.get("schema") != "photon-elastic-manifest/1":
        raise ValueError(f"not an elastic manifest: {path}")
    base = os.path.dirname(os.path.abspath(path))
    for p in m["parts"]:
        if not os.path.isabs(p["path"]):
            p["path"] = os.path.join(base, p["path"])
    return m


# ---------------------------------------------------------------------------
# Deterministic host-space L-BFGS (replicated identically on every host)
# ---------------------------------------------------------------------------


def _host_lbfgs(vg, w0: np.ndarray, max_iterations: int = 40,
                memory: int = 10, gtol: float = 1e-10):
    """Two-loop-recursion L-BFGS with Armijo backtracking, pure numpy f64.

    Every host runs this identical deterministic loop on identical reduced
    (value, grad) pairs, so the iterates stay bit-equal across hosts — the
    property the elastic protocol leans on (no coefficient broadcast is
    ever needed; the "broadcast" is replicated computation). ``vg`` may
    raise :class:`HostLostError`; no state is mutated on the way out."""
    w = np.asarray(w0, np.float64).copy()
    f, g = vg(w)
    S: list = []
    Y: list = []
    rho: list = []
    evals = 1
    it = 0
    for it in range(max_iterations):
        if float(np.max(np.abs(g))) <= gtol:
            break
        q = g.copy()
        alphas = []
        for s, y, r in zip(reversed(S), reversed(Y), reversed(rho)):
            a = r * float(np.dot(s, q))
            alphas.append(a)
            q -= a * y
        if Y:
            q *= float(np.dot(S[-1], Y[-1])) / float(np.dot(Y[-1], Y[-1]))
        for (s, y, r), a in zip(zip(S, Y, rho), reversed(alphas)):
            b = r * float(np.dot(y, q))
            q += (a - b) * s
        d = -q
        dg = float(np.dot(d, g))
        if dg >= 0.0:  # stale curvature turned d uphill; steepest descent
            d = -g
            dg = -float(np.dot(g, g))
        t = 1.0 if S else min(1.0, 1.0 / max(1e-12, float(np.sum(np.abs(g)))))
        w_try, f_try, g_try = w, f, g
        for _ in range(30):
            w_try = w + t * d
            f_try, g_try = vg(w_try)
            evals += 1
            if f_try <= f + 1e-4 * t * dg:
                break
            t *= 0.5
        s = w_try - w
        y = g_try - g
        sy = float(np.dot(s, y))
        w, f, g = w_try, f_try, g_try
        if sy > 1e-12:
            S.append(s)
            Y.append(y)
            rho.append(1.0 / sy)
            if len(S) > memory:
                S.pop(0)
                Y.pop(0)
                rho.pop(0)
    return w, f, it, evals


# ---------------------------------------------------------------------------
# The elastic trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ElasticConfig:
    sweeps: int = 2
    fixed_l2: float = 1e-3
    re_l2: float = 1.0
    max_iterations: int = 40
    re_max_iterations: int = 40
    gtol: float = 1e-10
    lbfgs_memory: int = 10
    min_step_seconds: float = 0.0  # drill knob: widens the rejoin window


class ElasticTrainer:
    """One host's view of an elastic multi-host GAME run (see the module
    docstring).

    ``run()`` executes ``2 * sweeps`` coordinate steps (fixed, random,
    fixed, ...), surviving host loss by shrink and redo and admitting
    rejoining hosts at step boundaries. The coordinator also writes the
    commits, the final model and the merged per-host ``SolverCostTable``.
    ``device`` is where the parts and buckets are solved; ``local_mesh``
    (a port ``Mesh``) row-shards each part over its ``data_axis``."""

    def __init__(self, membership: MeshMembership, manifest: dict,
                 config: Optional[ElasticConfig] = None, local_mesh=None,
                 data_axis: str = "data", device=None):
        from photon_tpu_torch.device import resolve_device

        self.mem = membership
        self.man = manifest
        self.cfg = config or ElasticConfig()
        self.local_mesh = local_mesh
        self.data_axis = data_axis
        self.device = (local_mesh.local_devices[0] if local_mesh is not None
                       else resolve_device(device))
        self.task = manifest["task"]
        self.dim = int(manifest["dim"])
        self.n_rows = int(manifest["n_rows"])
        self.part_ids = [p["id"] for p in manifest["parts"]]
        self.part_paths = {p["id"]: p["path"] for p in manifest["parts"]}
        # Fixed entity capacity: bucket shapes must not depend on how many
        # entities THIS host owns this epoch (a multiple of 8, so that any
        # local mesh axis up to 8 divides it).
        self.e_cap = -(-int(manifest["n_entities"]) // 8) * 8
        if local_mesh is not None:
            from photon_tpu_torch.parallel.mesh import axes_size

            self._axis_mult = axes_size(local_mesh, data_axis)
        else:
            self._axis_mult = 1
        self.s_pad = -(-int(manifest["rows_per_part"])
                       // self._axis_mult) * self._axis_mult
        # Replicated model state (identical on every host at every commit)
        self.w = np.zeros(self.dim)
        self.re_scores = np.zeros(self.n_rows)
        self.re_coefs: dict = {}  # entity id -> (global idx, values)
        # Parts loaded on the device (layouts built once, when first owned)
        self._loaded: dict = {}
        # Per-epoch caches
        self._cache_epoch = -1
        self._parts: dict = {}
        self._re_cache = None
        self._round = 0
        self._warm_marked = False
        self._shapes: set = set()
        self.new_shapes_after_warmup = 0
        self.step_seconds: list = []

    def _note_shape(self, shape: tuple) -> None:
        """Record a part or bucket shape; one first seen after warmup
        counts in ``new_shapes_after_warmup``."""
        if shape not in self._shapes:
            self._shapes.add(shape)
            if self._warm_marked:
                self.new_shapes_after_warmup += 1

    # -- per-epoch data ----------------------------------------------------

    def _load_part(self, pid: str) -> dict:
        """Part ``pid`` padded to ``s_pad`` rows, its host arrays and its
        device batch with the kernels' layouts (or, with a local mesh, its
        row shards), built at its first use on this host."""
        got = self._loaded.get(pid)
        if got is not None:
            return got
        from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures

        with np.load(self.part_paths[pid]) as z:
            d = {k: z[k] for k in z.files}
        pad = self.s_pad - d["labels"].shape[0]
        if pad:
            d["idx"] = np.pad(d["idx"], ((0, pad), (0, 0)),
                              constant_values=self.dim)
            d["val"] = np.pad(d["val"], ((0, pad), (0, 0)))
            d["labels"] = np.pad(d["labels"], (0, pad))
            d["weights"] = np.pad(d["weights"], (0, pad))
            d["entity"] = np.pad(d["entity"], (0, pad), constant_values=-1)
            d["row_id"] = np.pad(d["row_id"], (0, pad),
                                 constant_values=self.n_rows)
        dev = self.device

        def put(a, dt):
            return torch.as_tensor(a, dtype=dt).to(dev)

        batch = LabeledBatch(
            features=SparseFeatures(idx=put(d["idx"], torch.int32),
                                    val=put(d["val"], torch.float64),
                                    dim=self.dim),
            labels=put(d["labels"], torch.float64),
            offsets=torch.zeros(self.s_pad, dtype=torch.float64, device=dev),
            weights=put(d["weights"], torch.float64))
        if self.local_mesh is None:
            d["_batch"] = batch.with_accelerator_paths()
        else:
            from photon_tpu_torch.parallel.mesh import pad_and_shard_batch

            d["_batch"] = pad_and_shard_batch(batch, self.local_mesh,
                                              self.data_axis)
        self._loaded[pid] = d
        return d

    def _ensure_epoch_caches(self) -> None:
        if self._cache_epoch == self.mem.epoch:
            return
        self._parts = {pid: self._load_part(pid) for pid in self.mem.my_files()}
        self._re_cache = None
        self._cache_epoch = self.mem.epoch

    # -- fixed-effect coordinate ------------------------------------------

    def _part_value_and_grad(self, w, d: dict, offs: np.ndarray):
        """The data term's (value, gradient) over one part, on the device:
        one matvec and one ``csc_rmatvec`` (a shard each under a local
        mesh, folded in f64 in shard order)."""
        from photon_tpu_torch.functions.objective import GLMObjective
        from photon_tpu_torch.ops.losses import loss_for_task
        from photon_tpu_torch.types import TaskType

        obj = GLMObjective(loss=loss_for_task(TaskType[self.task]))
        offs_t = torch.as_tensor(offs, dtype=torch.float64).to(self.device)
        if self.local_mesh is None:
            return obj.value_and_grad(w, d["_batch"].with_offsets(offs_t))
        from photon_tpu_torch.parallel.spmd_objective import SpmdGLMObjective

        spmd = SpmdGLMObjective(obj=obj, shards=d["_batch"].with_offsets(offs_t))
        return spmd.data_value_and_grad(w)

    def _fixed_step(self, n: int) -> None:
        self._round = 0
        re_ext = np.concatenate([self.re_scores, [0.0]])
        l2 = self.cfg.fixed_l2

        def vg(w):
            payloads = {}
            wt = torch.as_tensor(w, dtype=torch.float64).to(self.device)
            for pid, d in self._parts.items():
                self._note_shape(("part",) + tuple(d["idx"].shape))
                v, g = self._part_value_and_grad(wt, d, re_ext[d["row_id"]])
                payloads[pid] = {
                    "v": np.asarray(v.cpu(), np.float64).reshape(1),
                    "g": np.asarray(g.cpu(), np.float64)}
            tag = f"s{n}-r{self._round}"
            self._round += 1
            parts = self.mem.reduce_parts(tag, payloads)
            val = 0.0
            grad = np.zeros(self.dim)
            for pid in self.part_ids:  # canonical fold order: part id, not host
                val += float(parts[pid]["v"][0])
                grad += np.asarray(parts[pid]["g"], np.float64)
            return (val + 0.5 * l2 * float(np.dot(w, w)), grad + l2 * w)

        self.w, _, _, _ = _host_lbfgs(
            vg, self.w, self.cfg.max_iterations, self.cfg.lbfgs_memory,
            self.cfg.gtol)

    # -- random-effect coordinate -----------------------------------------

    def _re_rows(self) -> dict:
        """This epoch's exchanged row set for entities we own: canonical
        (sorted by global row id) arrays idx/val/labels/weights/entity/
        row_id. Cached per epoch (the shuffle is membership-dependent,
        not step-dependent)."""
        if self._re_cache is not None:
            return self._re_cache
        names = ("idx", "val", "labels", "weights", "entity", "row_id")
        keep: dict = {m: {k: [] for k in names} for m in self.mem.members}
        for pid, d in self._parts.items():
            ent = d["entity"]
            real = ent >= 0  # drop part padding rows
            owner = np.array([self.mem.owner_of_entity(e) if e >= 0 else -1
                              for e in ent])
            for m in self.mem.members:
                sel = real & (owner == m)
                for k in names:
                    keep[m][k].append(d[k][sel])

        def cat(chunks, k):
            if chunks:
                return np.concatenate(chunks)
            width = self.dim if k in ("idx", "val") else None
            shape = (0, width) if width else (0,)
            dt = (np.int32 if k == "idx"
                  else np.int64 if k in ("entity", "row_id") else np.float64)
            return np.zeros(shape, dt)

        outbound = {
            m: {k: cat(keep[m][k], k) for k in names}
            for m in self.mem.members if m != self.mem.host_id
        }
        inbound = self.mem.exchange("re-rows", outbound)
        mine = [{k: cat(keep[self.mem.host_id][k], k) for k in names}]
        mine.extend(inbound.values())
        rows = {k: np.concatenate([c[k] for c in mine])
                if mine else cat([], k) for k in names}
        order = np.argsort(rows["row_id"], kind="stable")
        rows = {k: v[order] for k, v in rows.items()}
        self._re_cache = rows
        return rows

    def _re_step(self, n: int) -> None:
        from photon_tpu_torch.data.random_effect import build_random_effect_dataset
        from photon_tpu_torch.functions.problem import GLMOptimizationProblem
        from photon_tpu_torch.game.random_effect import (
            _pad_bucket,
            train_random_effects,
        )
        from photon_tpu_torch.optim import (
            OptimizerConfig,
            RegularizationContext,
            RegularizationType,
        )
        from photon_tpu_torch.types import TaskType

        rows = self._re_rows()
        n_local = rows["labels"].shape[0]
        if n_local:
            ds = build_random_effect_dataset(
                "per-entity", rows["entity"], rows["idx"], rows["val"],
                rows["labels"], self.dim, weights=rows["weights"],
                min_entity_rows=1, dtype=torch.float64, device=self.device,
            )
            ds = dataclasses.replace(ds, buckets=tuple(
                _pad_bucket(b, self.e_cap, ds.n_rows, self.dim)
                for b in ds.buckets))
            for b in ds.buckets:
                self._note_shape(("bucket",) + tuple(b.idx.shape)
                                 + (b.local_dim,))
            # Offsets: the fixed coordinate's scores for OUR rows, in the
            # dataset's (canonical) local row order.
            w_ext = np.concatenate([self.w, [0.0]])
            fixed_scores = np.einsum("rk,rk->r", w_ext[rows["idx"]],
                                     rows["val"])
            init = self._warm_start(ds)
            problem = GLMOptimizationProblem(
                task=TaskType[self.task],
                optimizer_config=OptimizerConfig(
                    max_iterations=self.cfg.re_max_iterations),
                regularization=RegularizationContext(RegularizationType.L2),
                reg_weight=self.cfg.re_l2,
            )
            model, _ = train_random_effects(
                problem, ds,
                torch.as_tensor(fixed_scores, dtype=torch.float64).to(self.device),
                mesh=self.local_mesh, entity_axis=self.data_axis,
                init_coefs=init,
            )
            scores_local = np.asarray(model.score_dataset(ds).cpu(), np.float64)
            ents, indptr, cols, vals = [], [0], [], []
            for key in model.entity_keys:
                gi, gv = model.coefficients_for(key)
                ents.append(int(key))
                cols.append(np.asarray(gi, np.int64))
                vals.append(np.asarray(gv, np.float64))
                indptr.append(indptr[-1] + len(gi))
            pub = {
                "row_id": rows["row_id"],
                "scores": scores_local,
                "ents": np.asarray(ents, np.int64),
                "indptr": np.asarray(indptr, np.int64),
                "cols": (np.concatenate(cols) if cols
                         else np.zeros(0, np.int64)),
                "vals": (np.concatenate(vals) if vals
                         else np.zeros(0, np.float64)),
            }
        else:  # empty entity shard: publish an empty, still participate
            z = np.zeros(0)
            pub = {"row_id": np.zeros(0, np.int64), "scores": z,
                   "ents": np.zeros(0, np.int64),
                   "indptr": np.zeros(1, np.int64),
                   "cols": np.zeros(0, np.int64), "vals": z}
        d = os.path.join(self.mem.mesh_dir, "scores",
                         f"e{self.mem.epoch}", f"s{n}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"host-{self.mem.host_id}.npz")
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **pub)
        os.replace(tmp, path)
        self.mem.barrier(f"re-pub-{n}")
        # Fold every member's publication (all present: the barrier passed)
        for m in self.mem.members:
            p = os.path.join(d, f"host-{m}.npz")
            with np.load(p) as z:
                rid = z["row_id"]
                self.re_scores[rid] = z["scores"]
                ents, indptr = z["ents"], z["indptr"]
                cols, vals = z["cols"], z["vals"]
            for i, e in enumerate(ents):
                lo, hi = int(indptr[i]), int(indptr[i + 1])
                self.re_coefs[int(e)] = (cols[lo:hi].copy(),
                                         vals[lo:hi].copy())

    def _warm_start(self, ds) -> Optional[list]:
        if not self.re_coefs:
            return None
        inits = [np.zeros((b.n_entities, b.local_dim)) for b in ds.buckets]
        projs = [b.proj.cpu().numpy() for b in ds.buckets]
        for dense, (bi, lane) in ds.entity_to_slot.items():
            got = self.re_coefs.get(int(ds.entity_keys[dense]))
            if got is None:
                continue
            gi, gv = got
            ext = np.zeros(self.dim + 1)
            ext[gi] = gv
            inits[bi][lane] = ext[projs[bi][lane]]
        return [torch.as_tensor(a, dtype=torch.float64).to(self.device)
                for a in inits]

    # -- commit / resume ---------------------------------------------------

    def _commit_dir(self) -> str:
        return os.path.join(self.mem.mesh_dir, "commits")

    def _commit(self, n: int) -> None:
        d = self._commit_dir()
        os.makedirs(d, exist_ok=True)
        meta_path = os.path.join(d, f"commit-{n}.json")
        if self.mem.is_coordinator:
            ents = sorted(self.re_coefs)
            indptr, cols, vals = [0], [], []
            for e in ents:
                gi, gv = self.re_coefs[e]
                cols.append(gi)
                vals.append(gv)
                indptr.append(indptr[-1] + len(gi))
            path = os.path.join(d, f"commit-{n}.npz")
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez(
                    f, w=self.w, re_scores=self.re_scores,
                    ents=np.asarray(ents, np.int64),
                    indptr=np.asarray(indptr, np.int64),
                    cols=(np.concatenate(cols) if cols
                          else np.zeros(0, np.int64)),
                    vals=(np.concatenate(vals) if vals
                          else np.zeros(0, np.float64)),
                )
            os.replace(tmp, path)
            tmpj = f"{meta_path}.tmp{os.getpid()}"
            with open(tmpj, "w") as f:
                json.dump({"n": n, "epoch": self.mem.epoch,
                           "members": self.mem.members,
                           "time": time.time()}, f)
            os.replace(tmpj, meta_path)
            return
        deadline = time.monotonic() + self.mem.wait_timeout
        while not os.path.exists(meta_path):
            self.mem._check_members(f"commit {n}")
            if time.monotonic() > deadline:
                raise HostLostError([self.mem.coordinator],
                                    f"commit {n} never appeared")
            time.sleep(self.mem.poll_seconds)

    def _latest_commit(self) -> int:
        best = -1
        for p in glob.glob(os.path.join(self._commit_dir(), "commit-*.json")):
            try:
                best = max(best, int(os.path.basename(p)[7:-5]))
            except ValueError:
                continue
        return best

    def _load_commit(self, n: int) -> None:
        if n < 0:
            self.w = np.zeros(self.dim)
            self.re_scores = np.zeros(self.n_rows)
            self.re_coefs = {}
            return
        with np.load(os.path.join(self._commit_dir(),
                                  f"commit-{n}.npz")) as z:
            self.w = np.asarray(z["w"], np.float64)
            self.re_scores = np.asarray(z["re_scores"], np.float64)
            ents, indptr = z["ents"], z["indptr"]
            cols, vals = z["cols"], z["vals"]
        self.re_coefs = {
            int(e): (cols[int(indptr[i]):int(indptr[i + 1])].copy(),
                     vals[int(indptr[i]):int(indptr[i + 1])].copy())
            for i, e in enumerate(ents)
        }

    def _resume(self) -> int:
        """After a shrink (or on rejoin): reload the last committed state —
        a partially-executed step may have mutated replicated state, and
        redoing it MUST start from exactly the committed inputs."""
        n = self._latest_commit()
        self._load_commit(n)
        self._cache_epoch = -1  # assignment changed: reload parts, re-shuffle
        return n + 1

    def _boundary(self, n: int) -> None:
        """Synchronize (epoch, membership) before step ``n``: the
        coordinator admits rejoiners and announces the step's epoch in a
        single-writer marker; everyone else adopts it. The marker breaks
        the race between a grow row landing and a peer reading the ledger
        a poll earlier — a host never waits in the wrong epoch's barrier."""
        mem = self.mem
        if mem.is_coordinator:
            mem.maybe_grow()
        changed = mem.sync_epoch()
        marker = os.path.join(mem.mesh_dir, "boundary", f"step-{n}.json")
        if mem.is_coordinator:
            os.makedirs(os.path.dirname(marker), exist_ok=True)
            tmp = f"{marker}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"epoch": mem.epoch, "members": mem.members}, f)
            os.replace(tmp, marker)
        else:
            deadline = time.monotonic() + mem.wait_timeout
            while True:
                try:
                    with open(marker) as f:
                        ep = int(json.load(f).get("epoch", -1))
                except (OSError, ValueError):
                    ep = -1
                if ep >= mem.epoch and ep >= 0:
                    if ep > mem.epoch:
                        changed = mem.sync_epoch() or changed
                    break
                mem._check_members(f"boundary marker step {n}")
                if time.monotonic() > deadline:
                    raise HostLostError([mem.coordinator],
                                        f"no boundary marker for step {n}")
                time.sleep(mem.poll_seconds)
        if changed:
            self._cache_epoch = -1
        self._ensure_epoch_caches()
        from photon_tpu_torch.obs.metrics import REGISTRY

        REGISTRY.gauge(
            "mesh_epoch", "Current elastic mesh epoch on this host",
        ).set(float(mem.epoch))
        mem.barrier(f"step-{n}")

    # -- run ---------------------------------------------------------------

    def run(self) -> dict:
        total = 2 * self.cfg.sweeps
        n = self._resume() if self.mem.rejoined else 0
        if n == 0:
            self._ensure_epoch_caches()
        while n < total:
            t0 = time.perf_counter()
            try:
                self._boundary(n)
                if self.cfg.min_step_seconds:
                    time.sleep(self.cfg.min_step_seconds)
                if n % 2 == 0:
                    self._fixed_step(n)
                else:
                    self._re_step(n)
                self._commit(n)
            except HostLostError as e:
                self.mem.log.warning("host loss during step %d: %s", n, e)
                self.mem.handle_loss(e.dead)
                n = self._resume()
                continue
            self.step_seconds.append(time.perf_counter() - t0)
            if n == 1 and not self._warm_marked and not self.mem.rejoined:
                # The first sweep saw every part and bucket shape; a shape
                # first seen after this is a membership-dependent shape.
                self._warm_marked = True
            n += 1
        return self._finalize(total)

    def _finalize(self, total: int) -> dict:
        from photon_tpu_torch.game.solver_routing import process_table
        from photon_tpu_torch.obs import fleet
        from photon_tpu_torch.ops import cuda_sparse

        mem = self.mem
        table = process_table()
        if table.to_json()["entries"]:
            table.save(os.path.join(
                mem.mesh_dir, f"solver_costs.host-{mem.host_id}.json"))
        mem.hb.export_peer_gauges()
        fleet.write_registry_shard(
            os.path.join(mem.mesh_dir,
                         f"registry.mesh-host-{mem.host_id}.json"),
            role="mesh-host",
            extra={"host_id": mem.host_id, "mesh_epoch": mem.epoch},
        )
        mem.barrier("done")
        summary = {
            "steps": total,
            "epoch": mem.epoch,
            "members": mem.members,
            "shrinks": mem.shrinks,
            "rejoined": mem.rejoined,
            "host_id": mem.host_id,
            "device": str(self.device),
            "new_shapes_after_warmup": self.new_shapes_after_warmup,
            "step_seconds_mean": (float(np.mean(self.step_seconds))
                                  if self.step_seconds else None),
            "step_seconds": [float(s) for s in self.step_seconds],
            # this process's launches of each hand-written kernel
            "kernel_launches": cuda_sparse.launch_counts(),
        }
        if mem.is_coordinator:
            merged = merge_mesh_cost_tables(mem.mesh_dir)
            summary["merged_cost_table"] = merged
            path = os.path.join(mem.mesh_dir, "final-model.npz")
            tmp = f"{path}.tmp{os.getpid()}"
            ents = sorted(self.re_coefs)
            with open(tmp, "wb") as f:
                np.savez(f, w=self.w, re_scores=self.re_scores,
                         ents=np.asarray(ents, np.int64))
            os.replace(tmp, path)
            fpath = os.path.join(mem.mesh_dir, "final.json")
            tmpj = f"{fpath}.tmp{os.getpid()}"
            with open(tmpj, "w") as f:
                json.dump(summary, f, indent=1)
            os.replace(tmpj, fpath)
        return summary


def merge_mesh_cost_tables(mesh_dir: str) -> Optional[str]:
    """Coordinator: fold every ``solver_costs.host-*.json`` into ONE
    ``solver_costs.merged.json`` (``SolverCostTable.merge`` — mean where
    two hosts measured the same candidate). A warm restart of ANY host
    then points ``PHOTON_RE_COST_TABLE`` at the merged file and skips
    calibration; the ``@devN`` suffix in the shape keys keeps tables from
    a different local-mesh topology inert (the existing refusal
    contract)."""
    from photon_tpu_torch.game.solver_routing import merge_host_tables

    paths = sorted(glob.glob(os.path.join(mesh_dir,
                                          "solver_costs.host-*.json")))
    if not paths:
        return None
    out = os.path.join(mesh_dir, "solver_costs.merged.json")
    merge_host_tables(paths, out)
    return out


# ---------------------------------------------------------------------------
# Worker entry (python -m photon_tpu_torch.parallel.elastic)
# ---------------------------------------------------------------------------


def worker_main(argv: Optional[Sequence[str]] = None) -> int:
    """One elastic host process: joins the mesh, trains on ``--device``
    (``cuda`` unless the caller names the CPU), and prints the summary JSON
    on the last line of stdout."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m photon_tpu_torch.parallel.elastic")
    p.add_argument("--mesh-dir", required=True)
    p.add_argument("--host-id", type=int, required=True)
    p.add_argument("--hosts", type=int, required=True)
    p.add_argument("--manifest", required=True)
    p.add_argument("--device", default="cuda",
                   help="where the parts and buckets are solved: cuda "
                        "(default) or cpu")
    p.add_argument("--sweeps", type=int, default=2)
    p.add_argument("--local-devices", type=int, default=1,
                   help="row-shard each part over this many shards of a "
                        "local mesh on --device")
    p.add_argument("--fixed-l2", type=float, default=1e-3)
    p.add_argument("--re-l2", type=float, default=1.0)
    p.add_argument("--max-iterations", type=int, default=40)
    p.add_argument("--min-step-seconds", type=float, default=0.0)
    p.add_argument("--beat-seconds", type=float, default=0.4)
    # Staleness window = beat * factor. On an oversubscribed box (N python
    # processes timesharing the cores) the beat thread can starve for
    # whole seconds, so drills pass a LARGE factor: a false host_lost
    # heals itself but splits the ledger's story.
    p.add_argument("--stale-factor", type=float, default=3.0)
    p.add_argument("--wait-timeout", type=float, default=120.0)
    args = p.parse_args(argv)

    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.game.solver_routing import TABLE_ENV

    device = resolve_device(args.device)
    os.environ.setdefault(TABLE_ENV, os.path.join(
        args.mesh_dir, f"solver_costs.host-{args.host_id}.json"))

    manifest = load_manifest(args.manifest)
    mem = MeshMembership(
        args.mesh_dir, args.host_id, args.hosts,
        [q["id"] for q in manifest["parts"]],
        beat_seconds=args.beat_seconds, stale_factor=args.stale_factor,
        wait_timeout=args.wait_timeout,
    )
    local_mesh = None
    if args.local_devices > 1:
        from photon_tpu_torch.parallel.mesh import make_mesh

        local_mesh = make_mesh({"data": args.local_devices},
                               devices=[device] * args.local_devices)
    trainer = ElasticTrainer(
        mem.start(), manifest,
        ElasticConfig(sweeps=args.sweeps, fixed_l2=args.fixed_l2,
                      re_l2=args.re_l2,
                      max_iterations=args.max_iterations,
                      min_step_seconds=args.min_step_seconds),
        local_mesh=local_mesh, device=device,
    )
    try:
        summary = trainer.run()
    finally:
        mem.stop()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(worker_main())
