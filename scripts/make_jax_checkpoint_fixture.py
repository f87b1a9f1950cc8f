"""Write ``tests/data/jax_checkpoint/step-0``: one GAME-fit snapshot written by
the JAX package's ``CheckpointManager`` on the CPU (a fixed-effect step of a
tiny fit, with its tracker record). ``tests/test_torch_checkpoint.py`` and
``chip_smoke.py`` check that the port's checkpoint directory refuses it by
its magic, before unpickling anything.

    JAX_PLATFORMS=cpu python scripts/make_jax_checkpoint_fixture.py
"""
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from photon_tpu.checkpoint import CheckpointManager  # noqa: E402
from photon_tpu.game.descent import CoordinateStepRecord  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "data", "jax_checkpoint")


def main() -> None:
    shutil.rmtree(OUT, ignore_errors=True)
    mgr = CheckpointManager(OUT, keep=1)
    state = {"models": {}, "scores": {"fixed": jnp.arange(4.0)},
             "total": jnp.arange(4.0), "v_cache": {}, "best_metric": None,
             "best_models": None,
             "tracker": [CoordinateStepRecord(0, "fixed", 0.0)]}
    mgr.save(0, state, {"phase": "step", "sweep": 0, "coord_index": 0,
                        "config_index": 0, "kind": "game_fit",
                        "fingerprint": "jax"})
    mgr.close()
    print(sorted(os.listdir(OUT)))


if __name__ == "__main__":
    main()
