"""Model optimization in the port (libpll2_tpu_torch.optimize, the
differentiable eigendecomposition of ops/eigen.py and the model-trial
evaluator `TreeEngine._trial_loglikelihoods`) against libpll2_tpu on the
CPU.

Both packages build the same problem from one seed (the alignment simulated
once, each package's own tree of the same seed) and start their optimizers
from the same point. Tolerances:
  * float64, the port against JAX's `pallas=False` engine: values to 1e-12
    relative, gradients to 1e-9 relative of the largest entry, the
    optimizers' histories (JAX's length; the first entries) and the applied
    parameters to 1e-8 relative: the two differ in summation order only;
  * float32, `make_fused_loglikelihood_fn` on the port's fused path (its
    plain version on the CPU) against JAX's fused kernel in interpret mode:
    TOL_LOGL 5e-5 relative (bench_validate.py:61-63);
  * the Brent pair: alpha and p-inv to 1e-6, logL to 1e-10 relative.
Every construction passes device="cpu"; the kernels' wrappers run their
plain versions for CPU tensors."""
import inspect
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu import compute_gamma_cats as j_gamma_cats
from libpll2_tpu import constants as JC
from libpll2_tpu import modelselect as jmodelselect
from libpll2_tpu import optimize as jopt
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.ops import eigen as jeigen
from libpll2_tpu.trees import random_utree as j_random_utree

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import constants as C
from libpll2_tpu_torch import convert
from libpll2_tpu_torch import modelselect as tmodelselect
from libpll2_tpu_torch import optimize as topt
from libpll2_tpu_torch.io import maps
from libpll2_tpu_torch.ops import eigen as teigen
from libpll2_tpu_torch.ops import likelihood as tlikelihood
from libpll2_tpu_torch.ops import pmatrix as tpmatrix
from libpll2_tpu_torch.trees import random_utree
from libpll2_tpu_torch.utils import simulate_alignment

CPU = "cpu"
F64 = torch.float64
TOL_LOGL = 5e-5                                # bench_validate.py:61-63
N_TAXA, N_SITES = 10, 200
TRUE_FREQS = [0.35, 0.15, 0.2, 0.3]
TRUE_SUBST = [1.0, 3.0, 0.7, 1.1, 2.5, 1.0]
START_FREQS = [0.26, 0.24, 0.25, 0.25]
START_SUBST = [1.0, 1.1, 0.9, 1.05, 0.95, 1.0]
HKY = [0, 1, 0, 0, 1, 0]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small problems: the test workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _alignment(n=N_TAXA, sites=N_SITES, seed=55, freqs=TRUE_FREQS,
               subst=TRUE_SUBST, invariant=0):
    labels = [f"t{i}" for i in range(n)]
    headers, seqs = simulate_alignment(random_utree(labels, seed=seed),
                                       sites, freqs, subst, alpha=0.9,
                                       seed=seed)
    if invariant:
        seqs = ["A" * invariant + s[invariant:] for s in seqs]
    return labels, dict(zip(headers, seqs))


def _pair(labels, by, seed=55, freqs=START_FREQS, subst=START_SUBST,
          dtype=F64, pallas=False, jpallas=False, rate_cats=4, pinv=0.0,
          site_repeats=False):
    """The same problem as a JAX and a port engine: (JAX engine and tree,
    port engine and tree)."""
    n, sites = len(labels), len(next(iter(by.values())))
    out = []
    for jax_side in (True, False):
        if jax_side:
            tree = j_random_utree(labels, seed=seed)
            part = JPartition(n, n - 2, 4, sites, 1, 2 * n - 3, rate_cats,
                              n - 2, site_repeats=site_repeats,
                              dtype="float64" if dtype == F64 else "float32")
            cm, gamma = jmaps.map_nt, j_gamma_cats
        else:
            tree = random_utree(labels, seed=seed)
            part = tp.Partition(n, n - 2, 4, sites, 1, 2 * n - 3, rate_cats,
                                n - 2, device=CPU, dtype=dtype,
                                site_repeats=site_repeats)
            cm, gamma = maps.map_nt, tp.compute_gamma_cats
        for tip in tree.tips():
            part.set_tip_states(tip.clv_index, cm, by[tip.label])
        part.set_frequencies(0, freqs)
        part.set_subst_params(0, subst)
        part.set_category_rates(gamma(0.9, rate_cats))
        if pinv:
            part.update_invariant_sites_proportion(0, pinv)
        engine = (JTreeEngine(part, tree, pallas=jpallas) if jax_side
                  else tp.TreeEngine(part, tree, pallas=pallas))
        out += [engine, tree]
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-300))


# -------------------------------------------------------- the eigensolver
@pytest.mark.parametrize("n", [4, 20])
def test_eigh_degenerate_safe_gradcheck(n):
    """The backward of _EighDegenerateSafe against finite differences on
    random symmetric matrices (eigh reads one triangle, so the input is
    symmetrised first), through quantities that do not depend on the
    eigenvectors' signs."""
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.standard_normal((2, n, n)), dtype=F64,
                     requires_grad=True)
    h = torch.tensor(rng.standard_normal(n), dtype=F64)

    def f(x):
        w, v = teigen.eigh_degenerate_safe((x + x.transpose(-1, -2)) / 2)
        return w, (v * h) @ v.transpose(-1, -2), v * v

    assert torch.autograd.gradcheck(f, (x,))


def _p_sum(update, subst, freqs, t, weights, xp):
    """A weighted sum over P(t) = I + inv_evecs diag(expm1(w t)) evecs."""
    w, evecs, inv_evecs = update(subst, freqs)
    p = inv_evecs @ (xp.expm1(w * t)[..., None] * evecs)
    return xp.sum(p * weights)


def _p_sum_sym(subst, freqs, t, weights):
    """The same sum through the gradient route's P builder."""
    p = tpmatrix.update_prob_matrices_sym(
        teigen.rate_matrix_sym_torch(subst, freqs), freqs,
        torch.zeros(1, dtype=F64), torch.ones(1, dtype=F64),
        torch.zeros(1, dtype=torch.long), t)
    return torch.sum((p[0, 0] - torch.eye(4, dtype=F64)) * weights)


def _p_sum_fd(subst, freqs, t, weights, eps=1e-6):
    """Central differences of the sum on the host eigensystem (float64):
    the true gradient, P being a smooth function of the model."""
    def f(s, fr):
        es = teigen.update_eigen(s, fr)
        p = es.inv_evecs @ (np.expm1(es.eigenvals * t)[:, None] * es.evecs)
        return np.sum(p * weights)

    out = []
    for arr, other_first in ((subst, True), (freqs, False)):
        g = np.zeros(arr.size)
        for i in range(arr.size):
            e = np.zeros(arr.size)
            e[i] = eps
            hi, lo = ((f(arr + e, freqs), f(arr - e, freqs)) if other_first
                      else (f(subst, arr + e), f(subst, arr - e)))
            g[i] = (hi - lo) / (2 * eps)
        out.append(g)
    return out


MODELS = {"JC": ([1.0] * 6, [0.25] * 4),
          "K80": ([1.0, 4.0, 1.0, 1.0, 4.0, 1.0], [0.25] * 4),
          "GTR": (TRUE_SUBST, TRUE_FREQS)}


@pytest.mark.parametrize("model", ["K80", "GTR"])
def test_update_eigen_gradient_matches_jax(model):
    """The gradient of a P(t) sum through update_eigen_torch against
    jax.grad through update_eigen_jax: 1e-9 at GTR; at K80 (equal
    frequencies: a repeated eigenvalue by construction) in the direction
    of kappa, which keeps the degeneracy, where the masked derivative of
    both is exact (the test below shows the other directions)."""
    subst, freqs = (np.asarray([a], np.float64) for a in MODELS[model])
    weights = np.random.default_rng(7).standard_normal((1, 4, 4))
    jg = jax.grad(lambda s, f: _p_sum(jeigen.update_eigen_jax, s, f, 0.3,
                                      jnp.asarray(weights), jnp),
                  argnums=(0, 1))(jnp.asarray(subst), jnp.asarray(freqs))
    ts = torch.tensor(subst, requires_grad=True)
    tf = torch.tensor(freqs, requires_grad=True)
    _p_sum(teigen.update_eigen_torch, ts, tf, 0.3, torch.tensor(weights),
           torch).backward()
    if model == "GTR":
        for got, want in ((ts.grad, jg[0]), (tf.grad, jg[1])):
            assert _rel(got.numpy(), want) < 1e-9
    else:
        kappa = np.array([0, 1, 0, 0, 1, 0.0])
        got = float(ts.grad.numpy()[0] @ kappa)
        want = float(np.asarray(jg[0])[0] @ kappa)
        assert got == pytest.approx(want, rel=1e-9)
        assert got == pytest.approx(float(_p_sum_fd(
            subst[0], freqs[0], 0.3, weights[0])[0] @ kappa), rel=1e-6)
    w = teigen.update_eigen_torch(ts, tf)[0]
    np.testing.assert_allclose(w.detach().numpy()[0], teigen.update_eigen(
        subst[0], freqs[0]).eigenvals, atol=1e-14)


@pytest.mark.parametrize("model", ["JC", "K80", "GTR"])
def test_sym_pmatrix_gradient_is_exact(model):
    """The gradient route's P-matrices (update_prob_matrices_sym, the
    Daleckii-Krein derivative) against central differences of the host
    eigensystem in subst and freqs, 1e-7 relative, at degenerate spectra
    too; their values against update_prob_matrices at 1e-14; at GTR the
    gradient equals JAX's to 1e-9. JAX's masked eigh derivative misses the
    directions that split JC's and K80's repeated eigenvalues by more than
    10 % (ROADMAP C); gradcheck holds the branch-length derivative."""
    subst, freqs = (np.asarray([a], np.float64) for a in MODELS[model])
    weights = np.random.default_rng(7).standard_normal((1, 4, 4))
    ts = torch.tensor(subst, requires_grad=True)
    tf = torch.tensor(freqs, requires_grad=True)
    t = torch.tensor([0.3], dtype=F64)
    _p_sum_sym(ts, tf, t, torch.tensor(weights[0])).backward()
    fd = _p_sum_fd(subst[0], freqs[0], 0.3, weights[0])
    assert _rel(ts.grad.numpy()[0], fd[0]) < 1e-7
    # the frequencies enter normalised: compare the projected gradients
    proj = np.eye(4) - 0.25
    assert _rel(tf.grad.numpy()[0] @ proj, fd[1] @ proj) < 1e-7
    jg = jax.grad(lambda s: _p_sum(jeigen.update_eigen_jax, s,
                                   jnp.asarray(freqs), 0.3,
                                   jnp.asarray(weights), jnp))(
        jnp.asarray(subst))
    if model == "GTR":
        assert _rel(ts.grad.numpy(), jg) < 1e-9
    else:
        assert _rel(np.asarray(jg)[0], fd[0]) > 0.1
    es = teigen.update_eigen(subst[0], freqs[0])
    args = [torch.tensor(a[None]) for a in (es.eigenvals, es.inv_evecs,
                                            es.evecs)]
    want = tpmatrix.update_prob_matrices(
        *args, torch.zeros(1, dtype=F64), torch.tensor([1.0, 0.5]),
        torch.zeros(2, dtype=torch.long), torch.tensor([0.0, 0.3, 2.0]))
    got = tpmatrix.update_prob_matrices_sym(
        teigen.rate_matrix_sym_torch(torch.tensor(subst),
                                     torch.tensor(freqs)),
        torch.tensor(freqs), torch.zeros(1, dtype=F64),
        torch.tensor([1.0, 0.5]), torch.zeros(2, dtype=torch.long),
        torch.tensor([0.0, 0.3, 2.0]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-14)
    sym = teigen.rate_matrix_sym_torch(torch.tensor(subst),
                                       torch.tensor(freqs))
    blen = torch.tensor([0.05, 0.7], dtype=F64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda b: tpmatrix.update_prob_matrices_sym(
            sym, torch.tensor(freqs), torch.zeros(1, dtype=F64),
            torch.tensor([0.4, 1.6]), torch.zeros(2, dtype=torch.long), b),
        (blen,))


# --------------------------------------------------------- gradient route
@pytest.mark.parametrize("case", ["all_groups", "template", "pinv", "scan",
                                  "branches_only"])
def test_make_loglikelihood_fn_matches_jax(case):
    """Value to 1e-12 and every gradient to 1e-9 relative of JAX's:
    branches + subst + freqs, with an HKY template, with p-inv, on the
    one-op-at-a-time path, and branches alone."""
    labels, by = _alignment(invariant=40 if case == "pinv" else 0)
    groups = ("branches",) if case == "branches_only" else (
        "branches", "subst", "freqs")
    tmpl = HKY if case == "template" else None
    je, _, te, _ = _pair(labels, by, pinv=0.2 if case == "pinv" else 0.0)
    if case == "scan":
        te = tp.TreeEngine(te.partition, random_utree(labels, seed=55),
                           pallas=False, level_schedule=False)
        assert te.execution_path == "scan"
    jfn, jp0 = jopt.make_loglikelihood_fn(je, groups, subst_template=tmpl)
    tfn, tp0 = topt.make_loglikelihood_fn(te, groups, subst_template=tmpl)
    assert sorted(jp0) == sorted(tp0)
    for k in jp0:
        np.testing.assert_allclose(tp0[k].numpy(), np.asarray(jp0[k]),
                                   rtol=1e-14, atol=1e-14)
    jv, jg = jax.value_and_grad(jfn)(jp0)
    at_jax = tfn(convert.params_from_jax(
        {k: np.asarray(v) for k, v in jp0.items()}, device=CPU, dtype=F64))
    assert float(at_jax) == pytest.approx(float(jv), rel=1e-12)
    q = {k: v.clone().requires_grad_(True) for k, v in tp0.items()}
    before = te.partition.clv.clone()
    tv = tfn(q)
    tg = dict(zip(q, torch.autograd.grad(tv, list(q.values()))))
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-12)
    for k in jg:
        assert np.all(np.isfinite(tg[k].numpy())), k
        assert _rel(tg[k].numpy(), jg[k]) < 1e-9, k
    assert torch.equal(te.partition.clv, before)


@pytest.mark.parametrize("start", ["JC", "HKY"])
def test_gradient_route_exact_at_degenerate_start(start):
    """At a start whose spectrum repeats an eigenvalue (every rate equal:
    JC; modelselect's HKY start, kappa e^0.08 at equal frequencies) the
    gradient of `make_loglikelihood_fn` equals central differences of its
    own value, 1e-6 relative of the largest entry (JAX's masked eigh
    derivative misses there)."""
    labels, by = _alignment(n=8, sites=150)
    subst = [1.0] * 6
    _, _, te, _ = _pair(labels, by, freqs=[0.25] * 4, subst=subst)
    tmpl = HKY if start == "HKY" else None
    fn, p0 = topt.make_loglikelihood_fn(te, ("subst", "freqs"),
                                        subst_template=tmpl)
    q = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    grads = torch.autograd.grad(fn(q), list(q.values()))
    eps = 1e-5
    for (k, v), g in zip(p0.items(), grads):
        fd = np.zeros(v.numel())
        for i in range(v.numel()):
            e = torch.zeros(v.numel(), dtype=F64)
            e[i] = eps
            hi = {**p0, k: v + e.view(v.shape)}
            lo = {**p0, k: v - e.view(v.shape)}
            with torch.no_grad():
                fd[i] = float(fn(hi) - fn(lo)) / (2 * eps)
        assert _rel(g.numpy().ravel(), fd) < 1e-6, k


def test_make_loglikelihood_fn_refusals():
    """A kernel engine raises ValueError (as in JAX), a template of the
    wrong width PllError."""
    labels, by = _alignment()
    _, _, te, tree = _pair(labels, by)
    fused = tp.TreeEngine(te.partition, tree)
    assert fused.execution_path == "fused"
    with pytest.raises(ValueError):
        topt.make_loglikelihood_fn(fused, ("branches",))
    with pytest.raises(C.PllError):
        topt.make_loglikelihood_fn(te, ("subst",), subst_template=[0, 1])
    with pytest.raises(C.PllError):
        topt.maximize_loglikelihood(fused, ("branches",))
    with pytest.raises(C.PllError):
        topt.make_fused_loglikelihood_fn(fused, ("branches",))


def _same_run(jout, tout, engines, n_hist):
    """The same history length, its first entries to 1e-8 relative, the
    final logL and the applied parameters to 1e-8."""
    (jl, jparams, jh), (tl, tparams, th) = jout, tout
    assert len(th) == len(jh)
    np.testing.assert_allclose(th[:n_hist], jh[:n_hist], rtol=1e-8)
    assert tl == pytest.approx(jl, rel=1e-8)
    for k in jparams:
        np.testing.assert_allclose(tparams[k].numpy(),
                                   np.asarray(jparams[k]), rtol=1e-8,
                                   atol=1e-10)
    je, te = engines
    jp, tpart = je.partition, te.partition
    np.testing.assert_allclose(tpart.subst_params, jp.subst_params,
                               rtol=1e-8)
    np.testing.assert_allclose(tpart.frequencies, jp.frequencies, rtol=1e-8)
    np.testing.assert_allclose(te.branches.numpy(), np.asarray(je.branches),
                               rtol=1e-8)


def test_maximize_loglikelihood_matches_jax():
    """Adam on the gradient route from one start: JAX's history length (the
    early stop between chunks), its entries and the applied parameters."""
    labels, by = _alignment()
    je, _, te, _ = _pair(labels, by)
    groups = ("branches", "subst", "freqs")
    kw = dict(steps=40, learning_rate=0.05, chunk=10, patience=15)
    jout = jopt.maximize_loglikelihood(je, groups, **kw)
    tout = topt.maximize_loglikelihood(te, groups, **kw)
    _same_run(jout, tout, (je, te), 40)
    assert tout[0] > tout[2][0] + 5.0


def test_maximize_fused_matches_jax():
    """The central-difference Adam on float64 plain paths, from one start:
    histories, the final logL and the applied parameters. Its HKY template
    run keeps the tied rates tied."""
    labels, by = _alignment()
    je, _, te, _ = _pair(labels, by)
    kw = dict(steps=24, chunk=8, patience=10)
    jout = jopt.maximize_fused(je, ("subst", "freqs"), **kw)
    tout = topt.maximize_fused(te, ("subst", "freqs"), **kw)
    _same_run(jout, tout, (je, te), 24)
    jout = jopt.maximize_fused(je, ("subst",), subst_template=HKY, **kw)
    tout = topt.maximize_fused(te, ("subst",), subst_template=HKY, **kw)
    _same_run(jout, tout, (je, te), 24)
    s = te.partition.subst_params[0]
    np.testing.assert_allclose(s[[0, 2, 3, 5]], s[0], rtol=1e-12)
    np.testing.assert_allclose(s[1], s[4], rtol=1e-12)


def test_maximize_fused_on_a_pooled_engine():
    """maximize_fused on the port's 'pool' engine (20 states at 8 x 65 with
    site repeats, the frequencies, 2 steps) against JAX's on a dense twin:
    histories, the final logL and the frequencies to 1e-10. JAX's own run on
    the pooled engine raises NameError: libpll2_tpu/optimize.py:298 calls
    `_repeats_loglikelihood`, which :35 does not import (ROADMAP C)."""
    from libpll2_tpu.models import load_aa_model as j_load_aa_model
    from libpll2_tpu_torch.models import load_aa_model

    n, sites = 8, 65
    labels = [f"t{i}" for i in range(n)]
    rng = np.random.default_rng(31)
    freqs = rng.dirichlet(np.ones(20) * 5)
    headers, seqs = simulate_alignment(
        random_utree(labels, seed=31), sites, freqs,
        rng.uniform(0.5, 2.0, 190), alpha=0.9, seed=31)
    by = dict(zip(headers, seqs))

    def build(jax_side, repeats):
        tree = (j_random_utree if jax_side else random_utree)(labels,
                                                               seed=31)
        if jax_side:
            part = JPartition(n, n - 2, 20, sites, 1, 2 * n - 3, 4, n - 2,
                              site_repeats=repeats, dtype="float64")
            cm, gamma, load = jmaps.map_aa, j_gamma_cats, j_load_aa_model
        else:
            part = tp.Partition(n, n - 2, 20, sites, 1, 2 * n - 3, 4, n - 2,
                                device=CPU, dtype=F64, site_repeats=repeats)
            cm, gamma, load = maps.map_aa, tp.compute_gamma_cats, \
                load_aa_model
        for tip in tree.tips():
            part.set_tip_states(tip.clv_index, cm, by[tip.label])
        load(part, "lg")
        part.set_category_rates(gamma(0.9, 4))
        return ((JTreeEngine if jax_side else tp.TreeEngine)(
            part, tree, pallas="pool" if repeats else False))

    kw = dict(steps=2, chunk=2, patience=10)
    pooled = build(False, True)
    assert pooled.execution_path == "pool-pallas"
    assert pooled.partition.repeats is not None
    jdense = build(True, False)
    jout = jopt.maximize_fused(jdense, ("freqs",), **kw)
    tout = topt.maximize_fused(pooled, ("freqs",), **kw)
    assert len(tout[2]) == len(jout[2]) == 2
    np.testing.assert_allclose(tout[2], jout[2], rtol=1e-10)
    assert tout[0] == pytest.approx(jout[0], rel=1e-10)
    np.testing.assert_allclose(pooled.partition.frequencies,
                               jdense.partition.frequencies, rtol=1e-10)
    jpooled = build(True, True)
    assert jpooled.repeats_mode
    with pytest.raises(NameError, match="_repeats_loglikelihood"):
        jopt.maximize_fused(jpooled, ("freqs",), **kw)


def test_maximize_routes_to_fused_on_a_kernel_engine():
    """maximize_loglikelihood on the port's fused engine takes the trial
    route: the same run as maximize_fused's."""
    labels, by = _alignment()
    _, _, te, tree = _pair(labels, by)
    fused = tp.TreeEngine(te.partition, tree)
    a = topt.maximize_loglikelihood(fused, ("freqs",), steps=6, chunk=3)
    te.partition.set_frequencies(0, START_FREQS)
    b = topt.maximize_fused(fused, ("freqs",), steps=6, chunk=3,
                            learning_rate=0.02, tol=1e-6)
    assert a[2] == b[2] and a[0] == b[0]


def test_fused_fn_float32_matches_jax_interpret():
    """make_fused_loglikelihood_fn in float32 on the fused path, 8 taxa x 64
    sites and K = 3 trials, against JAX's fused kernel in interpret mode,
    from the same flat vectors (convert.flat_from_jax): TOL_LOGL."""
    labels, by = _alignment(n=8, sites=64)
    je, _, te, _ = _pair(labels, by, dtype=torch.float32,
                         pallas="auto", jpallas="interpret")
    assert je.execution_path == te.execution_path == "fused"
    jfn, jx0, _ = jopt.make_fused_loglikelihood_fn(je, ("subst", "freqs"))
    tfn, tx0, unravel = topt.make_fused_loglikelihood_fn(
        te, ("subst", "freqs"))
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), rtol=1e-6)
    steps = np.random.default_rng(3).normal(0, 0.1, (3, jx0.size))
    X = np.asarray(jx0)[None] + steps
    want = np.asarray(jfn(jnp.asarray(X, jnp.float32)), np.float64)
    got = tfn(convert.flat_from_jax(X, device=CPU, dtype=torch.float32))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_LOGL)
    assert sorted(unravel(tx0)) == ["freq_logits", "log_subst"]


@pytest.mark.parametrize("per_edge", [False, True])
def test_trial_pmatrices_and_epilogue(per_edge):
    """update_prob_matrices_trials (K eigensystems, per-trial p-inv, one rate
    matrix a category or per edge) and edge_loglikelihood_candidates with
    per-trial frequencies and p-inv, each trial against the one-model
    functions: 1e-14 and 1e-12."""
    rng = np.random.default_rng(11)
    k, m, e, r = 3, 2, 5, 4
    subst = torch.tensor(rng.uniform(0.5, 3.0, (k * m, 6)))
    freqs = torch.tensor(rng.dirichlet([5.0] * 4, k * m))
    w, evecs, ivecs = (a.view(k, m, *a.shape[1:])
                       for a in teigen.update_eigen_torch(subst, freqs))
    pinv = torch.tensor(rng.uniform(0.0, 0.3, (k, m)))
    rates = torch.tensor([0.2, 0.7, 1.2, 1.9], dtype=F64)
    blen = torch.tensor(rng.uniform(0.0, 0.5, e))
    pidx = (torch.tensor(rng.integers(0, m, (e, r))) if per_edge
            else torch.tensor([0, 1, 1, 0]))
    got = tpmatrix.update_prob_matrices_trials(w, ivecs, evecs, pinv, rates,
                                               pidx, blen)
    one = (tpmatrix.update_prob_matrices_per_edge if per_edge
           else tpmatrix.update_prob_matrices)
    for i in range(k):
        want = one(w[i], ivecs[i], evecs[i], pinv[i], rates, pidx, blen)
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), atol=1e-14)
    s_sites = 30
    clv = torch.tensor(rng.uniform(0.0, 1.0, (2, k, r, 4, s_sites)))
    sc = torch.zeros((k, s_sites), dtype=torch.int32)
    pw = torch.ones(s_sites, dtype=torch.long)
    inv = torch.tensor(rng.integers(-1, 4, s_sites))
    rw = torch.full((r,), 0.25, dtype=F64)
    fk = freqs.view(k, m, 4)
    root_pidx = torch.tensor([0, 1, 1, 0])
    tot = tlikelihood.edge_loglikelihood_candidates(
        clv[0], clv[1], sc, sc, got[:, 0], fk, pinv, rw, root_pidx, pw, inv, 2.0 ** -256)
    for i in range(k):
        want = tlikelihood.edge_loglikelihood(
            clv[0, i], clv[1, i], sc[i], sc[i], got[i, 0], fk[i], pinv[i],
            rw, root_pidx, pw, inv, 2.0 ** -256)[0]
        assert float(tot[i]) == pytest.approx(float(want), rel=1e-12)


def test_trial_chunks(monkeypatch):
    """More trials than a chunk: the fused path scores them chunk by chunk
    (one candidate-form call each), and the values do not depend on the
    chunking."""
    from libpll2_tpu_torch import engine as tengine

    labels, by = _alignment(n=8, sites=120)
    _, _, te, tree = _pair(labels, by)
    eng = tp.TreeEngine(te.partition, tree)
    fnb, x0, _ = topt.make_fused_loglikelihood_fn(eng, ("subst", "freqs"))
    X = x0[None] + torch.tensor(
        np.random.default_rng(2).normal(0, 0.05, (5, x0.numel())))
    whole = fnb(X)
    calls = []
    orig = tengine._fused_trials
    monkeypatch.setattr(tengine, "CANDIDATE_CHUNK", 2)
    monkeypatch.setattr(tengine, "_fused_trials",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    chunked = fnb(X)
    assert len(calls) == 3 and chunked.shape == (5,)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-13)


def _set_model(part, subst, freqs):
    part.set_subst_params(0, subst)
    part.set_frequencies(0, freqs)


@pytest.mark.parametrize("path", ["fused", "levels-kernel", "levels",
                                  "scan", "repeats-dense-fused",
                                  "pool-pallas", "pool"])
def test_trial_loglikelihoods_every_path(path):
    """The trial evaluator on each execution path: each of K = 3 trials
    against setting its model on the partition and `loglikelihood()` (1e-12
    in float64), the partition's buffers left as they were."""
    labels, by = _alignment(n=8, sites=160)
    repeats = path in ("repeats-dense-fused", "pool-pallas", "pool")
    pallas = {"fused": "auto", "repeats-dense-fused": "auto",
              "pool-pallas": "pool", "levels": False, "pool": False,
              "levels-kernel": "levels-kernel", "scan": False}[path]
    _, _, te, tree = _pair(labels, by, site_repeats=repeats)
    eng = tp.TreeEngine(te.partition, tree, pallas=pallas,
                        level_schedule=path != "scan")
    assert eng.execution_path == path
    part = eng.partition
    base = eng.loglikelihood()
    rng = np.random.default_rng(5)
    subst = rng.uniform(0.5, 3.0, (3, 6))
    freqs = rng.dirichlet([5.0] * 4, 3)
    eigen = teigen.update_eigen_torch(torch.tensor(subst),
                                      torch.tensor(freqs))
    bufs = ((part.clv_flat, part.sc_flat) if repeats
            else (part.clv, part.scale_buffer))
    before = [b.clone() for b in bufs]
    got = eng._trial_loglikelihoods(
        tuple(a[:, None] for a in eigen), torch.tensor(freqs)[:, None])
    for b, b0 in zip(bufs, before):
        assert torch.equal(b, b0)
    want = []
    for s, f in zip(subst, freqs):
        _set_model(part, s, f)
        want.append(eng.loglikelihood())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    _set_model(part, START_SUBST, START_FREQS)
    assert eng.loglikelihood() == pytest.approx(base, rel=1e-12)


# ------------------------------------------------------------------ Brent
def test_brent_pair_matches_jax():
    """optimize_gamma_shape then optimize_pinv from one start: alpha and
    p-inv to 1e-6, logL to 1e-10, and the applied optimum reproduces."""
    labels, by = _alignment(n=8, sites=300, invariant=60)
    je, _, te, _ = _pair(labels, by, freqs=TRUE_FREQS, subst=TRUE_SUBST)
    ja, jl = jopt.optimize_gamma_shape(je)
    ta, tl = topt.optimize_gamma_shape(te)
    assert ta == pytest.approx(ja, rel=1e-6)
    assert tl == pytest.approx(jl, rel=1e-10)
    jp, jl = jopt.optimize_pinv(je)
    tpv, tl = topt.optimize_pinv(te)
    assert tpv == pytest.approx(jp, rel=1e-6)
    assert tl == pytest.approx(jl, rel=1e-10)
    assert te.loglikelihood() == pytest.approx(tl, rel=1e-10)
    with pytest.raises(C.PllError):
        one = tp.Partition(8, 6, 4, 300, 1, 13, 1, 6, device=CPU, dtype=F64)
        topt.optimize_gamma_shape(tp.TreeEngine(one, random_utree(labels,
                                                                  seed=55)))


# ------------------------------------------------------------------ guards
def test_pooled_partition_guards():
    """Dense-buffer consumers reject pooled site-repeats partitions with
    JAX's PllError (tests/test_optimize.py:test_pooled_partition_guards)."""
    labels, by = _alignment(n=8, sites=128)
    _, _, te, tree = _pair(labels, by, site_repeats=True)
    assert te.execution_path == "pool"
    with pytest.raises(C.PllError):
        topt.make_loglikelihood_fn(te, ("branches",))
    with pytest.raises(C.PllError):
        topt.newton_smooth_all(te, tree)


def test_public_names_and_params_from_jax():
    """Every public function of libpll2_tpu's optimize and modelselect is in
    the port under its name; convert.params_from_jax carries JAX's params
    across."""
    for jmod, tmod in ((jopt, topt), (jmodelselect, tmodelselect)):
        names = {n for n, v in vars(jmod).items()
                 if inspect.isfunction(v) and v.__module__ == jmod.__name__
                 and not n.startswith("_")}
        missing = [n for n in names if not hasattr(tmod, n)]
        assert not missing, (jmod.__name__, missing)
    assert set(tmodelselect.DNA_MODELS) == set(jmodelselect.DNA_MODELS)
    params = convert.params_from_jax(
        {"log_branches": jnp.zeros(3), "freq_logits": np.ones((1, 4))},
        device=CPU, dtype=F64)
    assert params["freq_logits"].dtype == F64
    assert params["log_branches"].shape == (3,)
    x = convert.flat_from_jax(jnp.arange(4.0), device=CPU, dtype=F64)
    np.testing.assert_array_equal(x.numpy(), np.arange(4.0))


def test_optimize_and_modelselect_import_no_jax():
    """`import libpll2_tpu_torch.optimize` and `.modelselect` leave no jax*
    module loaded."""
    code = ("import sys, libpll2_tpu_torch, libpll2_tpu_torch.optimize, "
            "libpll2_tpu_torch.modelselect, "
            "libpll2_tpu_torch.ops.branch_sweep; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'libpll2_tpu.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert JC.OPT_MIN_BRANCH_LEN == C.OPT_MIN_BRANCH_LEN
