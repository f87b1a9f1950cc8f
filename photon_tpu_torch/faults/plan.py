"""Deterministic, seed-driven fault injection.

Port of ``photon_tpu/faults/plan.py`` (no JAX in it: the code is the JAX
package's, the docstrings name the port's sites). Production code paths
carry near-free :func:`fault_point` hooks (one module-global ``is None``
check when no plan is active), and a :class:`FaultPlan` schedules which
hooks misbehave, how, and when, from a seed, so every chaos run repeats
exactly.

Hook sites in the port (grep for ``fault_point(``):

==========================  ================================================
site                        where / what a fired fault simulates
==========================  ================================================
``io.block_read``           per Avro block in the streaming ingest
                            (transient/permanent read errors)
``checkpoint.write``        background checkpoint writer, before the write
                            (disk-full / fs hiccup mid-snapshot)
``checkpoint.load``         checkpoint file open on resume
``descent.step``            top of each coordinate-descent step
                            (host preemption delivered as an exception)
``descent.device``          inside each coordinate-descent step, before
                            the solve (``error="device_lost"`` here drives
                            the in-run recovery: checkpoint → cache
                            release → re-run the step, not a restart)
``optim.ooc_iteration``     top of each out-of-core optimizer iteration
                            (the same in-run device-loss recovery, resuming
                            from the solver's own checkpoint)
``optim.ooc_chunk``         per streamed ELL chunk of an out-of-core pass
                            (``error="device_oom"`` here drives the OOM
                            ladder: the solver halves ``chunk_rows`` and
                            re-enters — ``runtime/memory_guard``)
``re.solve``                random-effect bucket-solver dispatch
                            (``game/random_effect.py``;
                            ``error="device_oom"`` drives the chunk-tier
                            downshift ladder instead of a restart)
``heartbeat.beat``          heartbeat file write (a stale beacon)
==========================  ================================================

The JAX package's serving, online and prefetch sites come with the slices
that port those modules.

A plan is a list of :class:`FaultSpec`; each spec independently counts the
hits at its site and decides — after an ``after`` warmup, at most ``count``
times, every ``every``-th eligible hit, with seeded ``probability`` — to
sleep ``delay_s`` and/or raise ``error``. Decisions and their outcomes are
recorded in ``FaultInjector.events`` so tests can assert the fault actually
fired. Plans round-trip through JSON (``to_json``/``from_file``) so the CLI
drivers can run under a plan via ``--fault-plan``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import random
import threading
import time
from typing import Callable, Optional, Sequence

__all__ = [
    "PreemptionError",
    "DeviceLostError",
    "DeviceOomError",
    "FaultSpec",
    "FaultPlan",
    "FaultInjector",
    "fault_point",
    "install",
    "deactivate",
    "active_plan",
    "install_from_file",
]


class PreemptionError(RuntimeError):
    """A host preemption notice delivered as an exception mid-solve.

    Subclasses ``RuntimeError`` on purpose: the supervisor's default
    retryable set treats it as transient, exactly how a real preemption
    surfaced by the runtime should be handled (restart + checkpoint
    resume)."""


class DeviceLostError(RuntimeError):
    """A lost accelerator device surfaced as an exception mid-computation.

    Subclasses ``RuntimeError`` (as CUDA runtime errors surface in torch)
    so the supervisor's retryable set treats it as transient. Distinct from
    :class:`PreemptionError` because it takes a DIFFERENT recovery path:
    the in-run handler (descent / out-of-core / scorer) checkpoints,
    clears the executable caches, and resumes WITHOUT killing the attempt
    (``runtime/backend_guard.recover_from_device_loss``); only repeated
    losses escalate to the supervisor restart."""


class DeviceOomError(RuntimeError):
    """A device out-of-memory failure surfaced mid-computation.

    Subclasses ``RuntimeError`` like ``torch.cuda.OutOfMemoryError``
    (whose text is ``CUDA out of memory``), so the supervisor's retryable set
    admits it — but it classifies ``oom`` by TYPE
    (``runtime/backend_guard.classify_backend_error``), which routes it to
    the DEGRADATION LADDER, not a same-shapes retry: the failing site
    downshifts to a cheaper plan (``runtime/memory_guard``) because
    re-running the identical allocation deterministically re-OOMs."""


# JSON-able error names -> exception types raised by a firing spec.
_ERROR_TYPES = {
    "os": OSError,
    "io": OSError,
    "runtime": RuntimeError,
    "connection": ConnectionError,
    "preemption": PreemptionError,
    "device_lost": DeviceLostError,
    "device_oom": DeviceOomError,
    "memory": MemoryError,
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault at one hook site.

    ``after``: skip the first N hits (let the system warm up / make
    progress first). ``count``: fire at most this many times (None =
    unlimited). ``every``: fire only on every k-th eligible hit (None =
    every eligible hit). ``probability``: seeded Bernoulli per eligible
    hit. ``delay_s``: sleep this long when firing (latency injection);
    ``error``: also raise this error (by name, see ``_ERROR_TYPES``), or
    ``error_factory`` for programmatic plans (not JSON-serializable).
    ``match``: substring filters on the hook's context kwargs, e.g.
    ``{"path": "part-0003"}`` targets one input file.
    """

    site: str
    error: Optional[str] = None
    error_factory: Optional[Callable[[str], BaseException]] = None
    delay_s: float = 0.0
    probability: float = 1.0
    after: int = 0
    count: Optional[int] = None
    every: Optional[int] = None
    match: Optional[dict] = None

    def __post_init__(self):
        if self.error is not None and self.error not in _ERROR_TYPES:
            raise ValueError(
                f"unknown fault error {self.error!r}; "
                f"known: {sorted(_ERROR_TYPES)}"
            )

    def build_error(self, message: str) -> Optional[BaseException]:
        if self.error_factory is not None:
            return self.error_factory(message)
        if self.error is not None:
            return _ERROR_TYPES[self.error](message)
        return None

    def to_dict(self) -> dict:
        if self.error_factory is not None:
            raise ValueError("error_factory specs are not JSON-serializable")
        out = dataclasses.asdict(self)
        out.pop("error_factory")
        return {k: v for k, v in out.items() if v not in (None, {})}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded schedule of faults; install with :func:`install` or
    :func:`active_plan`."""

    specs: Sequence[FaultSpec] = ()
    seed: int = 0

    def __post_init__(self):
        # Normalize so plans compare equal regardless of list/tuple input
        # (JSON round-trips produce tuples).
        object.__setattr__(self, "specs", tuple(self.specs))

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "specs": [s.to_dict() for s in self.specs]},
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(
            seed=int(d.get("seed", 0)),
            specs=tuple(FaultSpec.from_dict(s) for s in d.get("specs", ())),
        )

    @classmethod
    def from_file(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())


class _SpecState:
    __slots__ = ("spec", "index", "hits", "eligible", "fired", "rng")

    def __init__(self, spec: FaultSpec, index: int, seed: int):
        self.spec = spec
        self.index = index
        self.hits = 0
        self.eligible = 0
        self.fired = 0
        # Per-spec stream: decisions do not shift when another spec's site
        # sees a different number of hits.
        self.rng = random.Random(f"{seed}:{index}")


class FaultInjector:
    """Live counters + decisions for one installed :class:`FaultPlan`.

    Thread-safe: serving hook sites fire from handler and worker threads.
    ``events`` records every fired fault (site, hit number, action) for
    test assertions and postmortems."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._by_site: dict[str, list[_SpecState]] = {}
        for i, spec in enumerate(plan.specs):
            self._by_site.setdefault(spec.site, []).append(
                _SpecState(spec, i, plan.seed)
            )

    def fired(self, site: Optional[str] = None) -> int:
        with self._lock:
            return sum(
                1 for e in self.events if site is None or e["site"] == site
            )

    def check(self, site: str, ctx: dict) -> None:
        states = self._by_site.get(site)
        if not states:
            return
        to_fire: list[tuple[_SpecState, str]] = []
        with self._lock:
            for st in states:
                spec = st.spec
                if spec.match and not all(
                    str(v) in str(ctx.get(k, ""))
                    for k, v in spec.match.items()
                ):
                    continue
                st.hits += 1
                if st.hits <= spec.after:
                    continue
                if spec.count is not None and st.fired >= spec.count:
                    continue
                st.eligible += 1
                if spec.every is not None and (
                    (st.eligible - 1) % spec.every != 0
                ):
                    continue
                if spec.probability < 1.0 and (
                    st.rng.random() >= spec.probability
                ):
                    continue
                st.fired += 1
                msg = (
                    f"injected fault at {site!r} (spec {st.index}, "
                    f"hit {st.hits})"
                )
                self.events.append({
                    "site": site,
                    "spec": st.index,
                    "hit": st.hits,
                    "error": spec.error,
                    "delay_s": spec.delay_s,
                })
                to_fire.append((st, msg))
        # Sleep/raise OUTSIDE the lock: a latency injection must not
        # serialize unrelated sites behind it. All fired delays execute
        # BEFORE any error raises, so a plan combining latency and error
        # specs on one site actually delivers both (events stay accurate).
        if to_fire:
            # Observability correlation (docs/observability.md): every fired
            # fault lands as a tagged instant event in the active trace, so
            # a chaos run replays as a timeline — the injected fault sits
            # next to the spans that absorbed it (same trace id when the
            # firing thread carries request context).
            from photon_tpu_torch.obs.trace import instant as _trace_instant

            for st, _ in to_fire:
                _trace_instant(
                    f"fault:{site}", cat="fault",
                    site=site, spec=st.index, hit=st.hits,
                    error=st.spec.error, delay_s=st.spec.delay_s,
                )
        first_error: Optional[BaseException] = None
        for st, msg in to_fire:
            if st.spec.delay_s > 0:
                time.sleep(st.spec.delay_s)
            err = st.spec.build_error(msg)
            if err is not None and first_error is None:
                first_error = err
        if first_error is not None:
            raise first_error


_ACTIVE: Optional[FaultInjector] = None


def fault_point(site: str, **ctx) -> None:
    """Near-zero-cost hook: a no-op (one global read + None check) unless a
    plan is installed. Production code calls this at injectable sites."""
    inj = _ACTIVE
    if inj is not None:
        inj.check(site, ctx)


def install(plan: FaultPlan) -> FaultInjector:
    """Install ``plan`` process-wide; returns the live injector."""
    global _ACTIVE
    _ACTIVE = FaultInjector(plan)
    return _ACTIVE


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def active_plan(plan: FaultPlan):
    """``with active_plan(plan) as injector:`` — scoped install/uninstall
    (restores whatever was active before, so plans can nest in tests)."""
    global _ACTIVE
    prev = _ACTIVE
    inj = FaultInjector(plan)
    _ACTIVE = inj
    try:
        yield inj
    finally:
        _ACTIVE = prev


def install_from_file(path: Optional[str]) -> Optional[FaultInjector]:
    """CLI support: install a JSON plan file (``--fault-plan``); no-op on
    None/empty so drivers can pass the flag straight through."""
    if not path:
        return None
    return install(FaultPlan.from_file(path))
