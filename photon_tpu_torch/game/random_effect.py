"""Random-effect models and their training: batched per-entity solves.

Port of ``photon_tpu/game/random_effect.py`` on one device:
``RandomEffectModel`` (scoring, export, projection into another dataset's
subspaces and the incremental-training priors) and ``train_random_effects``
with the static solver plan of ``_solve_bucket``: full-bucket primal Newton,
full-bucket dual Newton, chunked primal, chunked dual (``game/newton_re.py``),
else the vmapped fallback (L1 / OWL-QN, a normalization context, or rows
too wide for every Newton tier): ``problem.run_lanes`` over the whole bucket
as masked batched lanes (``optim/lanes.py``) of L-BFGS, OWL-QN or TRON, by
the problem's optimizer (the plan keeps the JAX name ``vmapped_lbfgs``), on
the bucket's block-diagonal layout (``RandomEffectDataset.lane_features``).
A shard-level normalization context is gathered into each bucket's lanes
with ``project_context``.

Under ``PHOTON_RE_ROUTING=measured`` the plan comes from the measured cost
table of ``game/solver_routing.py`` instead (its vmapped baseline runs in
chunks over entity slices of the lane layout).

The OOM ladder (``runtime/memory_guard``): a dispatch that fails with an
``oom``-classified error (a real ``torch.cuda.OutOfMemoryError``, or an
injected ``device_oom`` at the ``re.solve`` fault point) retries one blessed
chunk tier down (``_oom_next_tier``), then on the vmapped lanes; bounded,
journaled and sticky for the run (``_apply_sticky_plan`` clamps every later
bucket's plan). A measured plan that runs out of memory is demoted to one
tier below the static plan, sticky too. A downshifted solve sums chunks in
another order than the tier above, so it equals a solve started at its own
tier, bit for bit, not the tier above. Meshes (``multiple_of``, the
entity-sharded placement, ``re.shard``) come with the multi-GPU slice.

``LAST_BUCKET_TIMINGS`` keeps one record per bucket of the most recent
``train_random_effects`` call (bucket, entities, S, P, solver, chunk and the
per-lane solver iterations); ``bucket_records()`` gives it with the
iterations summarized, at one device fetch per bucket, so training itself
fetches nothing for it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch.data.batch import LabeledBatch, LaneFeatures
from photon_tpu_torch.data.normalization import project_context
from photon_tpu_torch.data.random_effect import RandomEffectDataset
from photon_tpu_torch.faults import fault_point
from photon_tpu_torch.functions.prior import PriorDistribution
from photon_tpu_torch.game import newton_re, solver_routing
from photon_tpu_torch.optim.base import OptimizerResult
from photon_tpu_torch.runtime import memory_guard as _mg
from photon_tpu_torch.types import TaskType

Tensor = torch.Tensor

LAST_BUCKET_TIMINGS: list = []


def _host(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """Per-entity GLMs for one random-effect coordinate: a list of
    per-bucket coefficient stacks ``[E, P]`` in each entity's local feature
    subspace, plus the projection/slot structure to interpret them. Unseen
    entities score 0 (the zero-model fallback)."""

    re_type: str
    task: TaskType
    bucket_coefs: Sequence[Tensor]              # per bucket: [E, P]
    bucket_proj: Sequence[Tensor]               # per bucket: [E, P] -> global col
    bucket_entity_ids: Sequence[Tensor]         # per bucket: [E] dense REId
    entity_keys: Sequence                       # dense REId -> original key
    entity_to_slot: dict                        # dense REId -> (bucket, lane)
    global_dim: int
    bucket_variances: Optional[Sequence[Tensor]] = None

    @property
    def n_entities(self) -> int:
        return len(self.entity_keys)

    @functools.cached_property
    def _key_to_dense(self) -> dict:
        return {k: i for i, k in enumerate(self.entity_keys)}

    @functools.cached_property
    def _slots(self) -> tuple[np.ndarray, np.ndarray]:
        """(bucket, lane) of every dense entity id, as two arrays."""
        slot_b = np.full(self.n_entities, -1, np.int64)
        slot_l = np.full(self.n_entities, -1, np.int64)
        for dense, (b, lane) in self.entity_to_slot.items():
            slot_b[dense], slot_l[dense] = b, lane
        return slot_b, slot_l

    def _sparse_for(
        self, entity_key, stacks: Sequence[Sequence[Tensor]]
    ) -> tuple[np.ndarray, list[np.ndarray]]:
        """(global_indices, [values per stack]) for one entity."""
        dense = self._key_to_dense.get(entity_key)
        if dense is None:
            return np.zeros(0, np.int64), [
                np.zeros(0, np.float32) for _ in stacks
            ]
        b, lane = self.entity_to_slot[dense]
        proj = _host(self.bucket_proj[b][lane])
        valid = proj < self.global_dim
        return proj[valid].astype(np.int64), [
            _host(s[b][lane])[valid] for s in stacks
        ]

    def export_for(
        self, entity_key
    ) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """(indices, means, variances-or-None) in one slot lookup — the model
        export path's per-entity gather."""
        if self.bucket_variances is None:
            gi, (gv,) = self._sparse_for(entity_key, [self.bucket_coefs])
            return gi, gv, None
        gi, (gv, vv) = self._sparse_for(
            entity_key, [self.bucket_coefs, self.bucket_variances]
        )
        return gi, gv, vv

    def score_dataset(self, dataset: RandomEffectDataset) -> Tensor:
        """Scores for every row of the dataset this model was trained on
        (or any dataset with identical bucket structure)."""
        per_bucket = [
            dataset.bucket(i).scores(c) for i, c in enumerate(self.bucket_coefs)
        ]
        dtype = per_bucket[0].dtype if per_bucket else torch.float32
        return dataset.scatter_scores(per_bucket, dtype)

    def _project_stacks(
        self,
        dataset: RandomEffectDataset,
        sources: Sequence[Sequence[Tensor]],
        fills: Sequence[float],
    ) -> list[list[Tensor]]:
        """Project per-entity [E, P] stacks (aligned with this model's
        buckets) into ``dataset``'s local subspaces, several value sets at
        once, on the dataset's device: a host-side remap (the model-RDD join
        by REId of the reference), vectorized over the lanes of each pair of
        (new bucket, trained bucket). Entities and columns absent from this
        model get the per-source fill."""
        g = self.global_dim
        slot_b, slot_l = self._slots
        key_to_dense = self._key_to_dense
        # the dataset's dense ids -> this model's (-1: unseen)
        to_old = np.fromiter((key_to_dense.get(k, -1) for k in dataset.entity_keys),
                             np.int64, len(dataset.entity_keys))
        old_proj = [_host(p).astype(np.int64) for p in self.bucket_proj]
        old_vals = [[_host(c) for c in src] for src in sources]
        out: list[list[Tensor]] = [[] for _ in sources]
        for b in dataset.buckets:
            proj = _host(b.proj).astype(np.int64)
            eids = _host(b.entity_ids).astype(np.int64)
            vals = [np.full(proj.shape, fill, src[0].dtype)
                    for src, fill in zip(old_vals, fills)]
            old = np.where(eids >= 0, to_old[np.maximum(eids, 0)], -1)
            old_b = np.where(old >= 0, slot_b[np.maximum(old, 0)], -1)
            for bo in np.unique(old_b[old_b >= 0]):
                lanes = np.flatnonzero(old_b == bo)
                lo = slot_l[old[lanes]]
                # Each trained row of global columns is sorted with its
                # ghosts (== g) last, so offsetting row i by i*(g+1) sorts
                # them all into one key array: one search matches every
                # lane's new columns against its trained ones.
                base = np.arange(len(lanes))[:, None] * (g + 1)
                keys = (base + old_proj[bo][lo]).ravel()
                cols = proj[lanes]
                want = base + cols
                pos = np.minimum(np.searchsorted(keys, want), keys.size - 1)
                rows, at = np.nonzero((keys[pos] == want) & (cols < g))
                for s, src in enumerate(old_vals):
                    vals[s][lanes[rows], at] = src[bo][lo].ravel()[pos[rows, at]]
            for s, v in enumerate(vals):
                out[s].append(torch.from_numpy(v).to(dataset.device))
        return out

    def project_to(self, dataset: RandomEffectDataset) -> list[Tensor]:
        """Coefficient stacks re-projected into a *different* dataset's local
        subspaces (validation / scoring data); entities and columns unseen
        at training time get the zero model."""
        return self._project_stacks(dataset, [self.bucket_coefs], [0.0])[0]

    def project_posteriors_to(
        self, dataset: RandomEffectDataset
    ) -> tuple[list[Tensor], list[Tensor]]:
        """(means, variances) per-bucket stacks projected into ``dataset`` in
        one entity pass — the raw material for incremental-training priors.
        Unseen entities and columns get the N(0, 1) default posterior."""
        if self.bucket_variances is not None:
            means, variances = self._project_stacks(
                dataset, [self.bucket_coefs, self.bucket_variances], [0.0, 1.0])
        else:
            means = self.project_to(dataset)
            variances = [torch.ones_like(m) for m in means]
        return means, variances

    def project_prior_to(
        self, dataset: RandomEffectDataset, incremental_weight: float = 1.0
    ) -> list[PriorDistribution]:
        """Per-bucket priors ([E, P] leaves) for incremental training on
        ``dataset``."""
        means, variances = self.project_posteriors_to(dataset)
        return [PriorDistribution.from_model(m, v, incremental_weight)
                for m, v in zip(means, variances)]

    def score_new_dataset(self, dataset: RandomEffectDataset) -> Tensor:
        """Scores for a dataset built from different rows (e.g. validation)."""
        coef_stacks = self.project_to(dataset)
        per_bucket = [
            dataset.bucket(i).scores(c) for i, c in enumerate(coef_stacks)
        ]
        dtype = per_bucket[0].dtype if per_bucket else self.bucket_coefs[0].dtype
        return dataset.scatter_scores(per_bucket, dtype)


def plan_bucket(problem, bucket, local_mask: Tensor,
                local_prior: Optional[PriorDistribution],
                normalization=None) -> tuple[str, Optional[int], int]:
    """The static plan of one bucket: ``(solver, chunk, u_max)``, in the
    JAX order — full primal, full dual, chunked primal, chunked dual, else
    the vmapped fallback (``chunk`` None = the whole bucket at once;
    ``u_max`` -1 when no dual gate was consulted). ``u_max`` costs one
    device fetch and is computed only when a dual gate asks for it."""
    if newton_re.newton_eligible(problem, bucket, normalization):
        return "newton_primal", None, -1
    u_max = _u_max(problem, bucket, local_mask, local_prior, normalization)
    if u_max >= 0 and newton_re.dual_eligible(problem, bucket, normalization,
                                              u_max):
        return "newton_dual", None, u_max
    chunk = newton_re.newton_chunk_size(problem, bucket, normalization)
    if chunk:
        return "newton_primal", chunk, u_max
    chunk = (newton_re.dual_chunk_size(problem, bucket, normalization, u_max)
             if u_max >= 0 else None)
    if chunk:
        return "newton_dual", chunk, u_max
    return "vmapped_lbfgs", None, u_max


def _u_max(problem, bucket, local_mask, local_prior, normalization) -> int:
    """The dual gates' count of unpenalized columns (one device fetch), or
    -1 when the dual precheck refuses the bucket."""
    if not newton_re.dual_precheck(problem, bucket, normalization):
        return -1
    return newton_re.bucket_u_max(problem, local_mask, local_prior)


def lane_batch(dataset: RandomEffectDataset, b: int, batches,
               bucket=None) -> LabeledBatch:
    """Bucket ``b``'s local batches over its block-diagonal lane layout
    (``bucket``: bucket ``b`` on the device, for a host-resident
    dataset)."""
    return LabeledBatch(features=dataset.lane_features(b, bucket),
                        labels=batches.labels, offsets=batches.offsets,
                        weights=batches.weights)


def _chunk_lanes(dataset: RandomEffectDataset, b: int, bucket, chunk_batch,
                 lo: int) -> LabeledBatch:
    """The lane layout of lanes [lo, lo + chunk) of bucket ``b`` (the
    padded entity slice ``chunk_batch`` of the measured routing's chunked
    vmapped baseline): built once per (bucket, lo, chunk) of the prepared
    data, beside the whole bucket's layout."""
    f = chunk_batch.features
    key = ("chunk", b, lo, f.idx.shape[0])
    hit = dataset.lane_layouts.get(key)
    if hit is None or hit[0] is not bucket.idx:
        hit = (bucket.idx, LaneFeatures.from_bucket(
            f.idx, f.val, f.dim).with_accelerator_paths())
        if bucket is dataset.buckets[b]:
            dataset.lane_layouts[key] = hit
    return LabeledBatch(features=hit[1], labels=chunk_batch.labels,
                        offsets=chunk_batch.offsets, weights=chunk_batch.weights)


def bucket_inputs(dataset: RandomEffectDataset, b: int, offsets: Tensor,
                  global_reg_mask: Optional[Tensor] = None, normalization=None,
                  bucket=None):
    """Bucket ``b``'s solve inputs: its local regularization mask ``[E, P]``
    (``global_reg_mask`` projected, ghost slots at 1), its local batches at
    ``offsets`` and its local normalization context (or None). ``bucket``
    is bucket ``b`` on the device (default ``dataset.bucket(b)``)."""
    bucket = dataset.bucket(b) if bucket is None else bucket
    dev, dt = bucket.val.device, bucket.val.dtype
    if global_reg_mask is not None:
        ext = torch.cat([global_reg_mask.to(device=dev, dtype=dt),
                         torch.ones(1, dtype=dt, device=dev)])
        local_mask = ext[bucket.proj.long()]
    else:
        local_mask = torch.ones((bucket.n_entities, bucket.local_dim), dtype=dt,
                                device=dev)
    local_norm = (project_context(normalization, bucket.proj, dataset.global_dim)
                  if normalization is not None else None)
    return local_mask, bucket.local_batches(offsets), local_norm


def _plan_desc(solver: str, chunk) -> str:
    return f"{solver}@{'full' if chunk is None else chunk}"


def _oom_next_tier(solver: str, chunk, e: int, vmapped_chunkable: bool = True):
    """The next-cheaper (solver, chunk) plan below ``(solver, chunk)`` for
    an E-entity bucket, or None when the ladder is exhausted (``chunk``
    None is the whole bucket). The same solver one blessed chunk tier down,
    to the smallest tier; then the vmapped lanes (chunked when the bucket
    outgrows the smallest size); then nothing. ``vmapped_chunkable=False``
    (a normalization context, which the chunked lanes do not slice) keeps
    the lanes to the whole bucket. (The JAX function's ``multiple_of``, a
    mesh's entity axis, comes with the multi-GPU slice.)"""
    ladder = list(newton_re.chunk_ladder())
    eff = e if chunk is None else chunk
    smaller = [c for c in ladder if c < eff]
    if solver != "vmapped_lbfgs":
        if smaller:
            return solver, max(smaller)
        if vmapped_chunkable and ladder and e > ladder[0]:
            return "vmapped_lbfgs", ladder[0]
        return "vmapped_lbfgs", None
    if smaller and vmapped_chunkable:
        return "vmapped_lbfgs", max(smaller)
    return None


def _apply_sticky_plan(plan, sticky, e: int, vmapped_chunkable: bool = True):
    """Clamp a static plan to the run's sticky OOM downshift (the tiers that
    proved too big are skipped instead of running out of memory on every
    sweep)."""
    if not sticky:
        return plan
    solver, chunk = plan
    if sticky.get("solver"):
        solver = sticky["solver"]
    cap = sticky.get("chunk")
    if cap and (e if chunk is None else chunk) > cap:
        chunk = cap
    if solver == "vmapped_lbfgs" and not vmapped_chunkable:
        chunk = None
    return solver, chunk


def _downshift(err, solver: str, chunk, e: int, vmapped_chunkable: bool,
               before: Optional[str] = None):
    """The plan to retry after ``err`` at ``(solver, chunk)``, absorbed by
    the ``re.solve`` downshifter and made sticky; None when ``err`` is no
    OOM, the ladder is exhausted, or the bound is spent (journaled)."""
    if not _mg.is_oom(err):
        return None
    nxt = _oom_next_tier(solver, chunk, e, vmapped_chunkable=vmapped_chunkable)
    before = before or _plan_desc(solver, chunk)
    if nxt is None:
        _mg.journal_event("oom_exhausted", site="re.solve", cause="oom",
                          plan=before, reason=f"no cheaper plan below {before}")
        return None
    if not _mg.downshifter("re.solve").absorb(err, before=before,
                                              after=_plan_desc(*nxt)):
        return None
    _mg.set_sticky_plan("re.solve", {
        "chunk": nxt[1],
        "solver": nxt[0] if nxt[0] == "vmapped_lbfgs" else None,
    })
    return nxt


def _solve_bucket(problem, dataset: RandomEffectDataset, b: int, batches,
                  w0, local_mask, local_prior, normalization=None,
                  local_norm=None, bucket=None):
    """Pick and run the solver of bucket ``b``: ``(model, result, info)``
    with ``info`` = {solver, chunk, u_max, routing, calibrated,
    calibration_seconds}. Under ``PHOTON_RE_ROUTING=measured`` (and no
    sticky downshift) the cost table of ``game/solver_routing.py`` picks the
    plan, else the static gates do, clamped to the run's sticky plan; the
    dispatch runs under the OOM ladder. The vmapped plan runs on the
    bucket's device, whatever it is: never moved elsewhere."""
    bucket = dataset.buckets[b] if bucket is None else bucket
    e = int(w0.shape[0])
    vm_chunkable = local_norm is None
    u_max_cell: list = []

    def u_max() -> int:
        if not u_max_cell:
            u_max_cell.append(_u_max(problem, bucket, local_mask, local_prior,
                                     normalization))
        return u_max_cell[0]

    def fit_primal(bb, w, m, pr, lo=0):
        return newton_re.fit_bucket_newton(problem, bb, w, m, pr)

    def fit_dual(bb, w, m, pr, lo=0):
        return newton_re.fit_bucket_newton_dual(problem, bb, w, m, pr, u_max())

    def fit_vmapped(bb, w, m, pr, lo=None):
        if lo is None:      # the whole bucket
            return problem.run_lanes(lane_batch(dataset, b, bb, bucket), w, m,
                                     local_norm, pr)
        return problem.run_lanes(_chunk_lanes(dataset, b, bucket, bb, lo),
                                 w, m, None, pr)

    fits = {"newton_primal": fit_primal, "newton_dual": fit_dual,
            "vmapped_lbfgs": fit_vmapped}

    def dispatch(solver, chunk):
        fit = fits[solver]
        if chunk is None:
            return fit(batches, w0, local_mask, local_prior)
        return newton_re.fit_bucket_in_chunks(
            fit, chunk, batches, w0, local_mask, local_prior, with_lo=True)

    def run_ladder(solver, chunk):
        while True:
            try:
                # Chaos hook: error="device_oom" drives this ladder on the CPU.
                fault_point("re.solve", solver=solver,
                            chunk=0 if chunk is None else chunk)
                model, result = dispatch(solver, chunk)
                return model, result, solver, chunk
            except Exception as err:  # noqa: BLE001 - classified below
                nxt = _downshift(err, solver, chunk, e, vm_chunkable)
                if nxt is None:
                    raise
            # Retried outside the handler: the failed attempt's tensors,
            # held by the traceback, are already freed.
            solver, chunk = nxt

    sticky = _mg.sticky_plan("re.solve")
    measured_oom = None
    if solver_routing.routing_mode() == "measured" and sticky is None:
        dev = bucket.val.device

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        try:
            # Chaos hook: a device_oom here drives the demotion below.
            fault_point("re.solve", routing="measured")
            model, result, info = solver_routing.solve_measured(
                problem, bucket, batches, w0, local_mask, local_prior,
                normalization, u_max(), fits.__getitem__, sync)
            info["u_max"] = u_max()
            return model, result, info
        except Exception as err:  # noqa: BLE001 - classified below
            if not _mg.is_oom(err):
                raise
            # Kept without its traceback, which holds the failed tensors.
            measured_oom = err.with_traceback(None)

    solver, chunk, u = plan_bucket(problem, bucket, local_mask, local_prior,
                                   normalization)
    if u >= 0 and not u_max_cell:
        u_max_cell.append(u)
    plan = _apply_sticky_plan((solver, chunk), sticky, e,
                              vmapped_chunkable=vm_chunkable)
    if measured_oom is not None:
        # One tier below the static plan (the plan that runs next), sticky,
        # so later buckets skip the measured winner that cannot fit.
        nxt = _downshift(measured_oom, *plan, e, vm_chunkable,
                         before=f"measured({_plan_desc(*plan)})")
        if nxt is None:
            raise measured_oom
        plan = nxt
    model, result, solver, chunk = run_ladder(*plan)
    info = {"solver": solver, "chunk": chunk, "u_max": u_max_cell[0] if u_max_cell
            else u, "routing": "static", "calibrated": False,
            "calibration_seconds": 0.0}
    return model, result, info


def train_random_effects(
    problem,
    dataset: RandomEffectDataset,
    offsets: Tensor,
    global_reg_mask: Optional[Tensor] = None,
    init_coefs: Optional[Sequence[Tensor]] = None,
    normalization=None,
    priors: Optional[Sequence[PriorDistribution]] = None,
) -> tuple[RandomEffectModel, list[OptimizerResult]]:
    """Fit one GLM per entity; returns the model and the per-bucket solver
    results (per-lane tensors).

    ``offsets`` is the global per-sample residual score from the other GAME
    coordinates. ``global_reg_mask`` (0 on the intercept column) is
    projected into each entity's local subspace, ghost slots at 1.
    ``init_coefs`` warm-starts each bucket (the primal path; the dual path
    starts from θ = 0 by design). ``priors`` is an optional per-bucket list
    of priors with [E, P] leaves (``RandomEffectModel.project_prior_to``).
    ``normalization`` is the shard's ``NormalizationContext`` (None without
    one): it turns the Newton tiers off and is gathered into each bucket's
    lanes. A host-resident dataset's buckets are uploaded one at a time.
    """
    coefs_out, var_out, results = [], [], []
    want_var = problem.variance_type.name != "NONE"
    LAST_BUCKET_TIMINGS.clear()
    for b_i in range(len(dataset.buckets)):
        bucket = dataset.bucket(b_i)
        e, p = bucket.n_entities, bucket.local_dim
        dt = bucket.val.dtype
        if init_coefs is not None:
            w0 = init_coefs[b_i].to(dt)
        else:
            w0 = torch.zeros((e, p), dtype=dt, device=bucket.val.device)
        local_mask, batches, local_norm = bucket_inputs(
            dataset, b_i, offsets, global_reg_mask, normalization, bucket)
        local_prior = priors[b_i] if priors is not None else None

        model, result, info = _solve_bucket(
            problem, dataset, b_i, batches, w0, local_mask, local_prior,
            normalization, local_norm, bucket)
        coefs_out.append(model.coefficients.means)
        if want_var:
            var_out.append(model.coefficients.variances)
        results.append(result)
        LAST_BUCKET_TIMINGS.append({
            "bucket": b_i, "entities": e, "S": bucket.max_samples, "P": p,
            "solver": info["solver"], "chunk": info["chunk"],
            "u_max": info["u_max"], "routing": info["routing"],
            "calibrated": info["calibrated"],
            "calibration_seconds": info["calibration_seconds"],
            "_iterations": result.iterations,
        })

    model = RandomEffectModel(
        re_type=dataset.re_type,
        task=problem.task,
        bucket_coefs=coefs_out,
        bucket_proj=[b.proj for b in dataset.buckets],
        bucket_entity_ids=[b.entity_ids for b in dataset.buckets],
        entity_keys=dataset.entity_keys,
        entity_to_slot=dataset.entity_to_slot,
        global_dim=dataset.global_dim,
        bucket_variances=var_out if want_var else None,
    )
    return model, results


def bucket_records() -> list[dict]:
    """``LAST_BUCKET_TIMINGS`` with each bucket's solver iterations (Newton
    or lane) summarized over its lanes (max and median; one fetch per
    bucket)."""
    out = []
    for rec in LAST_BUCKET_TIMINGS:
        it = _host(rec["_iterations"])
        out.append({**{k: v for k, v in rec.items() if not k.startswith("_")},
                    "newton_iterations_max": int(it.max()) if it.size else 0,
                    "newton_iterations_median":
                        float(np.median(it)) if it.size else 0.0})
    return out
