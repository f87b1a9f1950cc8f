"""Online incremental learning (port of ``photon_tpu/online``): streaming
per-entity refresh → serving delta.

* **events** — the durable JSONL event log (one labeled observation per
  line, monotone ``seq``), the replay cursor for restart-exact resume, and
  the feature resolver that turns an event's (bag, name, term, value)
  lists into fixed-width ELL rows through the index maps training used.
* **state** — per-entity sliding windows (the data each refresh re-solves
  on), the dirty set (oldest pending event first), and the trainer's
  posterior state (the anchor of the next refresh's prior).
* **trainer** — :class:`OnlineTrainer`: consumes the stream, marks
  entities dirty, and re-solves them in micro-batches on its device (the
  card unless the caller names the CPU) through the batch tiers of
  ``game/newton_re.py`` and the masked batched lanes; publishes through
  :class:`RegistryPublisher`, :class:`HttpPublisher` or the delta log.
* **delta** — the model-delta wire format (changed-entity patches applied
  through ``ModelRegistry.apply_delta``) and the patch journal.

``events``, ``state`` and ``delta`` are copies of the JAX package's modules
(``tests/test_torch_online.py`` and ``tests/test_torch_frontline.py``
compare the code) and import neither torch nor JAX; this package's code is
the JAX package's too. The trainer's names resolve lazily (PEP 562), so
importing ``online`` loads no torch: the replication and control processes
depend on that.
"""
from photon_tpu_torch.online.delta import (
    EntityPatch,
    ModelDelta,
    PatchJournal,
)
from photon_tpu_torch.online.events import (
    EventCursor,
    EventError,
    EventWriter,
    OnlineEvent,
    append_events,
    iter_events,
    resolve_event_features,
)
from photon_tpu_torch.online.state import EntityWindows, OnlineModelState

# trainer names resolve lazily (PEP 562): importing the trainer module
# builds an OnlineTrainerConfig default, which reaches the torch-backed
# Newton solvers — an import cost (and a hard torch dependency) that the
# torch-free consumers of this package (replication/log's ModelDelta use,
# the router and control drivers) must not pay.
_TRAINER_EXPORTS = (
    "HttpPublisher",
    "OnlineCoordinate",
    "OnlineTrainer",
    "OnlineTrainerConfig",
    "RegistryPublisher",
)


def __getattr__(name: str):
    if name in _TRAINER_EXPORTS:
        from photon_tpu_torch.online import trainer

        return getattr(trainer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "EntityPatch",
    "ModelDelta",
    "PatchJournal",
    "EventCursor",
    "EventError",
    "EventWriter",
    "OnlineEvent",
    "append_events",
    "iter_events",
    "resolve_event_features",
    "EntityWindows",
    "OnlineModelState",
    "HttpPublisher",
    "OnlineCoordinate",
    "OnlineTrainer",
    "OnlineTrainerConfig",
    "RegistryPublisher",
]
