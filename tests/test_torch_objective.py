"""The PyTorch port's GLM objective against the JAX package's, on the CPU.

``value_and_grad``, ``value``, ``hessian_vector``, ``hessian_diagonal``, the
score-space methods and ``bind_hvp_at`` of ``GLMObjective``, for every loss,
on the sparse shapes of ``tests/test_pallas_sparse.py`` (ghost entries, and
its hot-and-duplicate-column case), with an intercept mask and a Gaussian
prior, on the same numpy-made inputs: float64 ``rtol 1e-12``, with an
absolute floor of 1e-12 times the vector's largest entry (the two packages
sum a column's entries in different orders, so an entry that nearly cancels
keeps only an absolute agreement). Both
packages' pass counters must count the same passes of each kind. Also: the
transposes of ``SparseFeatures`` against the JAX package's, and a batch off
the CPU without its CSC layout refusing to compute.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.data.batch import LabeledBatch as JaxBatch
from photon_tpu.data.batch import SparseFeatures as JaxFeatures
from photon_tpu.functions.objective import GLMObjective as JaxObjective
from photon_tpu.functions.objective import intercept_reg_mask as jax_mask
from photon_tpu.functions.prior import PriorDistribution as JaxPrior
from photon_tpu.ops import losses as jax_losses
from photon_tpu.ops import pass_counter as jax_passes
from photon_tpu_torch.data.batch import LabeledBatch, SparseFeatures
from photon_tpu_torch.functions.objective import GLMObjective, intercept_reg_mask
from photon_tpu_torch.functions.prior import PriorDistribution
from photon_tpu_torch.ops import losses
from photon_tpu_torch.ops import pass_counter

RTOL = 1e-12
SHAPES = [(300, 200, 4), (1000, 700, 6), (257, 129, 3), "hot_dup"]
LOSSES = ["logistic", "squared", "poisson", "smoothed_hinge"]


def _ell(rng, shape):
    """``tests/test_pallas_sparse.py``'s ``_random_ell`` (20% ghosts), or
    its duplicate-and-skewed case: column 7 in every row, duplicates."""
    if shape == "hot_dup":
        n, d, k = 400, 100, 5
        idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
        idx[:, 0] = 7
        idx[:, 1] = idx[:, 2]
    else:
        n, d, k = shape
        idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
        idx = np.where(rng.random((n, k)) < 0.2, d, idx).astype(np.int32)
    val = np.where(idx < d, rng.normal(size=(n, k)), 0.0)
    return idx, val, d


def _inputs(shape, loss, seed):
    rng = np.random.default_rng(seed)
    idx, val, d = _ell(rng, shape)
    n = idx.shape[0]
    if loss in ("logistic", "smoothed_hinge"):
        y = rng.integers(0, 2, size=n).astype(np.float64)
    elif loss == "poisson":
        y = rng.poisson(1.5, size=n).astype(np.float64)
    else:
        y = rng.normal(size=n)
    return {
        "idx": idx, "val": val, "d": d, "y": y,
        "off": rng.normal(size=n) * 0.1,
        "wt": np.where(rng.random(n) < 0.1, 0.0, rng.uniform(0.5, 2.0, size=n)),
        "w": rng.normal(size=d) * 0.3, "v": rng.normal(size=d),
        "z": rng.normal(size=n),
        "prior_means": rng.normal(size=d) * 0.1,
        "prior_vars": rng.uniform(0.5, 2.0, size=d),
    }


def _pair(inp, loss, with_prior):
    """The same objective and batch in both packages."""
    jb = JaxBatch(JaxFeatures(jnp.asarray(inp["idx"]), jnp.asarray(inp["val"]), inp["d"]),
                  jnp.asarray(inp["y"]), jnp.asarray(inp["off"]), jnp.asarray(inp["wt"]))
    tb = LabeledBatch(SparseFeatures(torch.from_numpy(inp["idx"]),
                                     torch.from_numpy(inp["val"]), inp["d"]),
                      torch.from_numpy(inp["y"]), torch.from_numpy(inp["off"]),
                      torch.from_numpy(inp["wt"]))
    jprior = tprior = None
    if with_prior:
        jprior = JaxPrior.from_model(jnp.asarray(inp["prior_means"]),
                                     jnp.asarray(inp["prior_vars"]), 0.7)
        tprior = PriorDistribution.from_model(torch.from_numpy(inp["prior_means"]),
                                              torch.from_numpy(inp["prior_vars"]), 0.7)
    jo = JaxObjective(jax_losses.get_loss(loss), 0.8, jax_mask(inp["d"], 0), jprior)
    to = GLMObjective(losses.get_loss(loss), 0.8, intercept_reg_mask(inp["d"], 0), tprior)
    return jo, jb, to, tb


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(initial=0.0),
                               err_msg=what)


@pytest.mark.parametrize("with_prior", [False, True], ids=["plain", "prior"])
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_objective_matches_jax(shape, loss, with_prior):
    inp = _inputs(shape, loss, seed=SHAPES.index(shape) * 10 + LOSSES.index(loss))
    jo, jb, to, tb = _pair(inp, loss, with_prior)
    jw, tw = jnp.asarray(inp["w"]), torch.from_numpy(inp["w"])
    jv, tv = jnp.asarray(inp["v"]), torch.from_numpy(inp["v"])
    jz, tz = jnp.asarray(inp["z"]), torch.from_numpy(inp["z"])

    with jax_passes.counting() as jc:
        jvg = jo.value_and_grad(jw, jb)
        jval = jo.value(jw, jb)
        jhv = jo.hessian_vector(jw, jv, jb)
        jdiag = jo.hessian_diagonal(jw, jb)
        jvs = jo.value_from_scores(jz, jw, jb)
        jgs = jo.grad_from_scores(jz, jw, jb)
        jso = jo.score_space(jb)
        jss = (jso.score(jw), jso.score_delta(jv))
        jat = jo.bind_hvp_at(jb)(jw)
        jhv2 = (jat(jv), jat(jw))
        jbound = jo.bind(jb)(jv)
    jcounts = dict(jc)
    with pass_counter.counting() as tc:
        tvg = to.value_and_grad(tw, tb)
        tval = to.value(tw, tb)
        thv = to.hessian_vector(tw, tv, tb)
        tdiag = to.hessian_diagonal(tw, tb)
        tvs = to.value_from_scores(tz, tw, tb)
        tgs = to.grad_from_scores(tz, tw, tb)
        tso = to.score_space(tb)
        tss = (tso.score(tw), tso.score_delta(tv))
        tat = to.bind_hvp_at(tb)(tw)
        thv2 = (tat(tv), tat(tw))
        tbound = to.bind(tb)(tv)
    tcounts = dict(tc)

    _close(tvg[0], jvg[0], "value_and_grad value")
    _close(tvg[1], jvg[1], "value_and_grad grad")
    _close(tval, jval, "value")
    _close(thv, jhv, "hessian_vector")
    _close(tdiag, jdiag, "hessian_diagonal")
    _close(tvs, jvs, "value_from_scores")
    _close(tgs, jgs, "grad_from_scores")
    _close(tss[0], jss[0], "score")
    _close(tss[1], jss[1], "score_delta")
    _close(thv2[0], jhv2[0], "bind_hvp_at(w)(v)")
    _close(thv2[1], jhv2[1], "bind_hvp_at(w)(w)")
    _close(tbound[0], jbound[0], "bind value")
    _close(tbound[1], jbound[1], "bind grad")
    assert tcounts == jcounts
    # bind_hvp_at hoists the margins: 1 pass at w, then 2 per H·v.
    assert tcounts == {"matvec": 11, "rmatvec": 6, "sq_rmatvec": 1}
    assert pass_counter.total_passes() == jax_passes.total_passes() == 18


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_transposes_match_jax(shape):
    inp = _inputs(shape, "squared", seed=99)
    jf = JaxFeatures(jnp.asarray(inp["idx"]), jnp.asarray(inp["val"]), inp["d"])
    tf = SparseFeatures(torch.from_numpy(inp["idx"]), torch.from_numpy(inp["val"]),
                        inp["d"])
    jz, tz = jnp.asarray(inp["z"]), torch.from_numpy(inp["z"])
    assert tf.n_rows == inp["idx"].shape[0]
    _close(tf.rmatvec(tz), jf.rmatvec(jz), "rmatvec")
    _close(tf.sq_rmatvec(tz), jf.sq_rmatvec(jz), "sq_rmatvec")
    _close(tf.matvec(torch.from_numpy(inp["w"])), jf.matvec(jnp.asarray(inp["w"])),
           "matvec")


def test_batch_off_cpu_without_layout_refuses_transposes():
    """A batch that is not on the CPU computes its transposes only through
    the attached CSC layout: without it, rmatvec and sq_rmatvec raise and
    name ``with_accelerator_paths`` (no layout is built on the fly, no plain
    version runs). The meta device stands in for CUDA here."""
    sf = SparseFeatures(torch.zeros((4, 2), dtype=torch.int32, device="meta"),
                        torch.zeros((4, 2), device="meta"), 3)
    v = torch.zeros(4, device="meta")
    for fn in (sf.rmatvec, sf.sq_rmatvec):
        with pytest.raises(RuntimeError, match="with_accelerator_paths"):
            fn(v)
    assert sf.with_accelerator_paths() is sf      # attaches on cuda only


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "POISSON_REGRESSION",
                                  "LINEAR_REGRESSION"])
def test_glm_compute_mean_matches_jax(task):
    from photon_tpu.models.coefficients import Coefficients as JaxCoefficients
    from photon_tpu.models.glm import GeneralizedLinearModel as JaxGLM
    from photon_tpu.types import TaskType as JaxTask
    from photon_tpu_torch.models.coefficients import Coefficients
    from photon_tpu_torch.models.glm import GeneralizedLinearModel
    from photon_tpu_torch.types import TaskType

    inp = _inputs((300, 200, 4), "squared", seed=8)
    jf = JaxFeatures(jnp.asarray(inp["idx"]), jnp.asarray(inp["val"]), inp["d"])
    tf = SparseFeatures(torch.from_numpy(inp["idx"]), torch.from_numpy(inp["val"]),
                        inp["d"])
    jm = JaxGLM(JaxCoefficients(jnp.asarray(inp["w"])), JaxTask[task])
    tm = GeneralizedLinearModel(Coefficients(torch.from_numpy(inp["w"])), TaskType[task])
    _close(tm.compute_mean(tf, torch.from_numpy(inp["off"])),
           jm.compute_mean(jf, jnp.asarray(inp["off"])), "compute_mean")
    zero = GeneralizedLinearModel.zeros(inp["d"], TaskType[task], torch.float64)
    assert zero.dim == inp["d"] and not zero.coefficients.means.any()
    assert zero.coefficients.variances is None


def test_labeled_batch_attach_cache_and_offsets():
    inp = _inputs((30, 20, 3), "squared", seed=5)
    _, _, _, tb = _pair(inp, "squared", False)
    cache = {}
    assert tb.with_accelerator_paths(cache) is tb
    assert cache == {id(tb.features): tb.features}
    assert tb.n_rows == 30 and tb.dim == 20
    off = torch.ones(30, dtype=torch.float64)
    assert torch.equal(tb.with_offsets(off).offsets, off)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_objective_on_card_matches_cpu(shape, cuda_device):
    """On the card the passes are the kernels over the attached layouts; in
    float64 they agree with the CPU's plain versions to the same
    tolerance. Without the CSC layout the card's batch refuses rmatvec."""
    from photon_tpu_torch.ops import cuda_sparse as cs

    inp = _inputs(shape, "logistic", seed=7)
    _, _, to, tb = _pair(inp, "logistic", True)

    def on(dev, t):
        return t.to(dev) if t is not None else None

    prior = PriorDistribution(on(cuda_device, to.prior.means),
                              on(cuda_device, to.prior.precisions))
    to_d = GLMObjective(to.loss, to.l2_weight, on(cuda_device, to.reg_mask), prior)
    raw = LabeledBatch(SparseFeatures(on(cuda_device, tb.features.idx),
                                      on(cuda_device, tb.features.val), tb.dim),
                       on(cuda_device, tb.labels), on(cuda_device, tb.offsets),
                       on(cuda_device, tb.weights))
    with pytest.raises(RuntimeError, match="with_accelerator_paths"):
        raw.features.rmatvec(on(cuda_device, tb.labels))
    tb_d = raw.with_accelerator_paths()
    w = torch.from_numpy(inp["w"])
    v = torch.from_numpy(inp["v"])
    cs.reset_launch_counts()
    got = (*to_d.value_and_grad(w.to(cuda_device), tb_d),
           to_d.hessian_diagonal(w.to(cuda_device), tb_d),
           to_d.bind_hvp_at(tb_d)(w.to(cuda_device))(v.to(cuda_device)))
    torch.cuda.synchronize()
    launches = cs.launch_counts()
    want = (*to.value_and_grad(w, tb), to.hessian_diagonal(w, tb),
            to.bind_hvp_at(tb)(w)(v))
    for g, x, what in zip(got, want, ("value", "grad", "diag", "hvp")):
        _close(g.cpu(), x, what)
    assert launches["csc_rmatvec"] == 2 and launches["csc_sq_rmatvec"] == 1
    assert launches["ell_panel_matvec"] + launches["ell_matvec"] == 4
