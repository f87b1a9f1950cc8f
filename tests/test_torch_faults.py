"""The port's fault injection (``photon_tpu_torch/faults``) against the JAX
package's (``photon_tpu/faults``).

* The modules are copies: their code, without docstrings, equals the JAX
  package's with the package name renamed.
* The same plan JSON and seed fire the same sequence of (site, call, error
  type) in both packages, for the semantics ``tests/test_faults.py`` covers
  (``after``, ``count``, ``every``, seeded ``probability``, ``match``,
  several specs on a site, delays), and record the same events.
* An inactive hook is a no-op: no raise, no record, no sleep.
* ``torn_write`` and ``bit_flip`` leave equal bytes in both packages.
"""
import ast
import os
import time

import pytest

from photon_tpu import faults as jf
from photon_tpu_torch import faults as tf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _code(path: str, rename: bool) -> str:
    """The module's code with every docstring dropped (and the port's
    package name renamed to the JAX package's)."""
    src = open(path).read()
    if rename:
        src = src.replace("photon_tpu_torch", "photon_tpu")
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.unparse(tree)


@pytest.mark.parametrize("name", ["plan", "chaos"])
def test_fault_modules_are_copies(name):
    port = os.path.join(REPO, "photon_tpu_torch", "faults", f"{name}.py")
    jax = os.path.join(REPO, "photon_tpu", "faults", f"{name}.py")
    assert _code(port, rename=True) == _code(jax, rename=False)


PLANS = {
    "after_count": {"seed": 0, "specs": [
        {"site": "s", "error": "os", "after": 3, "count": 2}]},
    "every": {"seed": 0, "specs": [{"site": "s", "error": "runtime", "every": 3}]},
    "probability": {"seed": 11, "specs": [
        {"site": "s", "error": "device_lost", "probability": 0.4}]},
    "probability_other_seed": {"seed": 12, "specs": [
        {"site": "s", "error": "device_lost", "probability": 0.4}]},
    "match": {"seed": 3, "specs": [
        {"site": "s", "error": "preemption", "match": {"path": "part-3"}},
        {"site": "t", "error": "device_oom", "after": 1, "every": 2}]},
    "stacked": {"seed": 5, "specs": [
        {"site": "s", "error": "memory", "probability": 0.5, "count": 4},
        {"site": "s", "error": "connection", "after": 5, "every": 4},
        {"site": "s", "delay_s": 0.0, "probability": 0.3}]},
}


def _fire(pkg, plan_json: str, n: int = 40) -> tuple:
    """Hit sites ``s`` and ``t`` n times each under the plan; the (site,
    call, error type) of every raise, and the injector's events."""
    fired = []
    with pkg.active_plan(pkg.FaultPlan.from_json(plan_json)) as inj:
        for i in range(n):
            for site in ("s", "t"):
                try:
                    pkg.fault_point(site, i=i, path=f"/data/part-{i % 5}.avro")
                except Exception as e:  # noqa: BLE001 - the injected fault
                    fired.append((site, i, type(e).__name__))
    return fired, inj.events


@pytest.mark.parametrize("name", list(PLANS))
def test_same_plan_same_firing_sequence(name, tmp_path):
    import json

    text = json.dumps(PLANS[name])
    jax_fired, jax_events = _fire(jf, text)
    port_fired, port_events = _fire(tf, text)
    assert port_fired == jax_fired and port_events == jax_events
    assert jax_fired or name == "stacked" and jax_events
    # the plan file round-trips to the same plan in both packages
    path = tmp_path / "plan.json"
    path.write_text(text)
    port_plan = tf.FaultPlan.from_file(str(path))
    assert port_plan.to_json() == jf.FaultPlan.from_file(str(path)).to_json()
    assert tf.FaultPlan.from_json(port_plan.to_json()) == port_plan


def test_error_names_map_to_the_ported_types():
    assert set(tf.plan._ERROR_TYPES) == set(jf.plan._ERROR_TYPES)
    for name, jax_type in jf.plan._ERROR_TYPES.items():
        port_type = tf.plan._ERROR_TYPES[name]
        assert [c.__name__ for c in port_type.__mro__] == \
            [c.__name__ for c in jax_type.__mro__]
    with pytest.raises(ValueError, match="unknown fault error"):
        tf.FaultSpec(site="s", error="nope")


def test_inactive_hook_is_a_noop():
    tf.deactivate()
    t0 = time.perf_counter()
    for i in range(100_000):
        tf.fault_point("descent.step", i=i)
    # one global read a call: far below a microsecond each on any host
    assert time.perf_counter() - t0 < 2.0
    assert tf.plan._ACTIVE is None


def test_install_from_file_and_nesting(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(tf.FaultPlan(seed=0, specs=[tf.FaultSpec(site="o", error="os")]).to_json())
    assert tf.install_from_file(None) is None
    inj = tf.install_from_file(str(path))
    try:
        with tf.active_plan(tf.FaultPlan()):
            tf.fault_point("o")             # the inner plan has no spec for "o"
        with pytest.raises(OSError):
            tf.fault_point("o")             # the outer plan is back
        assert inj.fired("o") == 1
    finally:
        tf.deactivate()


def test_torn_write_and_bit_flip_equal_bytes(tmp_path):
    blob = bytes(range(256)) * 16
    out = {}
    for name, pkg in (("jax", jf), ("port", tf)):
        p = tmp_path / f"{name}.bin"
        p.write_bytes(blob)
        offs = pkg.bit_flip(str(p), n_flips=5, seed=7, min_offset=16)
        kept = pkg.torn_write(str(p), keep_fraction=0.6)
        out[name] = (offs, kept, p.read_bytes())
    assert out["port"] == out["jax"]
    assert out["port"][2] != blob[: out["port"][1]]


def test_fired_faults_land_as_trace_events(tmp_path):
    """A fired fault lands as a ``fault:<site>`` instant in the installed
    collector (as the JAX package's does), beside the spans around it."""
    import json

    from photon_tpu_torch.obs import trace_span, tracing

    path = tmp_path / "trace.json"
    plan = tf.FaultPlan(specs=[tf.FaultSpec(site="s", error="os", count=1)])
    with tracing(str(path)) as col, tf.active_plan(plan):
        with trace_span("step", cat="descent", sweep=0) as sp:
            with pytest.raises(OSError):
                tf.fault_point("s", i=0)
    fault, span = col.events
    assert fault["name"] == "fault:s" and fault["ph"] == "i"
    assert fault["args"]["error"] == "os" and fault["args"]["hit"] == 1
    assert span["name"] == "step" and span["ph"] == "X" and sp.seconds > 0
    assert json.loads(path.read_text())["traceEvents"] == col.events
