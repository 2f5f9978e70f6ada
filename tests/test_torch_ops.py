"""Tensor ops of the PyTorch port against libpll2_tpu, float64 on the CPU.

Each test makes its inputs with numpy from a seed and hands the same arrays
to the JAX function and to its counterpart in libpll2_tpu_torch. The two
differ only in summation order, so float64 results agree to ~1e-15; the
tolerances below leave room for cancellation in the derivative sums."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import constants as JC
from libpll2_tpu.ops import derivatives as jder
from libpll2_tpu.ops import eigen as jeigen
from libpll2_tpu.ops import gamma as jgamma
from libpll2_tpu.ops import likelihood as jlik
from libpll2_tpu.ops import pmatrix as jpm

from libpll2_tpu_torch.ops import derivatives as tder
from libpll2_tpu_torch.ops import likelihood as tlik
from libpll2_tpu_torch.ops import pmatrix as tpm

F64 = torch.float64
THRESHOLD = JC.SCALE_THRESHOLD


def _model(seed, m=2, states=4, rates=4, pinv=(0.0, 0.0)):
    rng = np.random.default_rng(seed)
    freqs = rng.dirichlet(np.ones(states) * 4, size=m)
    subst = rng.uniform(0.3, 3.0, size=(m, states * (states - 1) // 2))
    es = jeigen.update_eigen_batch(subst, freqs)
    return dict(eigenvals=es.eigenvals, inv_evecs=es.inv_evecs,
                evecs=es.evecs, freqs=freqs, prop_invar=np.asarray(pinv),
                rates=jgamma.compute_gamma_cats(0.7, rates),
                weights=rng.dirichlet(np.ones(rates)),
                params_idx=np.array([0, 1, 1, 0][:rates], dtype=np.int32))


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _ti(a):
    return torch.tensor(np.asarray(a), dtype=torch.long)


@pytest.mark.parametrize("pinv", [(0.0, 0.0), (0.3, 0.0), (0.2, 0.45)])
def test_update_prob_matrices_matches(pinv):
    md = _model(1, pinv=pinv)
    blen = np.array([0.0, 1e-7, 0.01, 0.1, 0.5, 2.5, -1.0, 7.0])
    want = np.asarray(jpm.update_prob_matrices(
        jnp.asarray(md["eigenvals"]), jnp.asarray(md["inv_evecs"]),
        jnp.asarray(md["evecs"]), jnp.asarray(md["prop_invar"]),
        jnp.asarray(md["rates"]), jnp.asarray(md["params_idx"]),
        jnp.asarray(blen)))
    got = tpm.update_prob_matrices(
        _t(md["eigenvals"]), _t(md["inv_evecs"]), _t(md["evecs"]),
        _t(md["prop_invar"]), _t(md["rates"]), _ti(md["params_idx"]),
        _t(blen))
    assert got.dtype == F64 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-300)
    # zero (and negative) lengths give the identity exactly
    for e in (0, 6):
        assert np.array_equal(got[e].numpy(),
                              np.broadcast_to(np.eye(4), (4, 4, 4)))


def _edge_inputs(seed, sites=300, scalers=True, pinv=(0.0, 0.0),
                 invariant=False):
    rng = np.random.default_rng(seed)
    md = _model(seed, pinv=pinv)
    R, s = 4, 4
    clv_p = rng.uniform(0.0, 1.0, size=(R, s, sites))
    clv_c = rng.uniform(0.0, 1.0, size=(R, s, sites))
    if scalers:
        sc_p = rng.integers(0, 3, size=sites).astype(np.int32)
        sc_c = rng.integers(0, 4, size=sites).astype(np.int32)
        # a scaled site's CLV entries sit in the rescaled window
        clv_p *= np.where(sc_p > 0, 0.5, 1.0)[None, None, :]
    else:
        sc_p = np.zeros(sites, np.int32)
        sc_c = np.zeros(sites, np.int32)
    pm = np.asarray(jpm.update_prob_matrices(
        jnp.asarray(md["eigenvals"]), jnp.asarray(md["inv_evecs"]),
        jnp.asarray(md["evecs"]), jnp.asarray(md["prop_invar"]),
        jnp.asarray(md["rates"]), jnp.asarray(md["params_idx"]),
        jnp.asarray([0.3])))[0]
    pw = rng.integers(0, 5, size=sites).astype(np.int64)
    inv = np.full(sites, -1, np.int32)
    if invariant:
        idx = rng.choice(sites, size=sites // 3, replace=False)
        inv[idx] = rng.integers(0, 4, size=idx.size)
    return md, clv_p, clv_c, sc_p, sc_c, pm, pw, inv


@pytest.mark.parametrize("case", ["plain", "scalers", "pinv", "pinv+scalers"])
def test_edge_loglikelihood_matches(case):
    pinv = (0.25, 0.1) if "pinv" in case else (0.0, 0.0)
    md, cp, cc, sp, sc, pm, pw, inv = _edge_inputs(
        3, scalers="scalers" in case, pinv=pinv, invariant="pinv" in case)
    want_total, want_per = jlik.edge_loglikelihood(
        jnp.asarray(cp), jnp.asarray(cc), jnp.asarray(sp), jnp.asarray(sc),
        jnp.asarray(pm), jnp.asarray(md["freqs"]),
        jnp.asarray(md["prop_invar"]), jnp.asarray(md["weights"]),
        jnp.asarray(md["params_idx"]), jnp.asarray(pw), jnp.asarray(inv),
        THRESHOLD)
    got_total, got_per = tlik.edge_loglikelihood(
        _t(cp), _t(cc), _t(sp, torch.int32), _t(sc, torch.int32), _t(pm),
        _t(md["freqs"]), _t(md["prop_invar"]), _t(md["weights"]),
        _ti(md["params_idx"]), _t(pw, torch.int64), _ti(inv), THRESHOLD)
    np.testing.assert_allclose(float(got_total), float(want_total),
                               rtol=1e-12)
    np.testing.assert_allclose(got_per.numpy(), np.asarray(want_per),
                               rtol=1e-12, atol=0)
    if "scalers" in case:
        assert (sp + sc).max() > 0


@pytest.mark.parametrize("pinv,invariant", [((0.0, 0.0), False),
                                            ((0.2, 0.35), True)])
@pytest.mark.parametrize("blen", [1e-4, 0.3])
def test_sumtable_and_derivatives_match(pinv, invariant, blen):
    md, cp, cc, sp, sc, _, pw, inv = _edge_inputs(
        5, pinv=pinv, invariant=invariant)
    want_st = jder.update_sumtable(
        jnp.asarray(cp), jnp.asarray(cc), jnp.asarray(sp), jnp.asarray(sc),
        jnp.asarray(md["inv_evecs"]), jnp.asarray(md["evecs"]),
        jnp.asarray(md["freqs"]), jnp.asarray(md["params_idx"]), THRESHOLD,
        has_pscaler=True, has_cscaler=True)
    got_st = tder.update_sumtable(
        _t(cp), _t(cc), _t(sp, torch.int32), _t(sc, torch.int32),
        _t(md["inv_evecs"]), _t(md["evecs"]), _t(md["freqs"]),
        _ti(md["params_idx"]), THRESHOLD, has_pscaler=True,
        has_cscaler=True)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st),
                               rtol=1e-11, atol=1e-13)
    want = jder.likelihood_derivatives(
        want_st, jnp.asarray(md["eigenvals"]), jnp.asarray(md["prop_invar"]),
        jnp.asarray(md["freqs"]), jnp.asarray(md["rates"]),
        jnp.asarray(md["weights"]), jnp.asarray(md["params_idx"]),
        jnp.asarray(pw), jnp.asarray(inv), jnp.asarray(blen),
        scale_threshold=THRESHOLD)
    got = tder.likelihood_derivatives(
        _t(np.asarray(want_st)), _t(md["eigenvals"]), _t(md["prop_invar"]),
        _t(md["freqs"]), _t(md["rates"]), _t(md["weights"]),
        _ti(md["params_idx"]), _t(pw, torch.int64), _ti(inv),
        _t(blen), scale_threshold=THRESHOLD)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-11)


@pytest.mark.parametrize("length,d1,d2", [
    (0.1, -3.0, 50.0),        # plain Newton step inside the bracket
    (0.1, 8.0, 20.0),         # Newton step below xmin: d1 > 0 halves
    (0.1, -4000.0, 10.0),     # Newton step above xmax: d1 < 0 doubles
    (0.1, 2.0, -5.0),         # d2 <= 0, d1 > 0: halve
    (60.0, -2.0, -5.0),       # d2 <= 0, d1 < 0: double, capped at xmax
    (0.3, 1.5, 0.0),          # d2 == 0
    (2e-6, 1.0, 1e-3),        # halving clipped at xmin
])
def test_newton_step_matches(length, d1, d2):
    xmin, xmax = JC.OPT_MIN_BRANCH_LEN, JC.OPT_MAX_BRANCH_LEN
    want = jder.newton_step(jnp.asarray(length), jnp.asarray(d1),
                            jnp.asarray(d2), xmin, xmax)
    got = tder.newton_step(_t(length), _t(d1), _t(d2), xmin, xmax)
    assert float(got) == float(want)
