"""Per-rate scalers, raw tip CLVs and ascertainment-bias corrections in the
PyTorch port against libpll2_tpu on the CPU.

The same alignments, simulated from a seed, go through the JAX package and
the port; the port's partition is built from the JAX partition's state
through libpll2_tpu_torch.convert, or through its own setters where the
setters are what is tested. Tolerances (ROADMAP.md's budgets):
  * float64: the port's paths against JAX's XLA paths, 1e-12 relative in
    logL and 1e-10 in d1/d2 (the two differ only in summation order);
  * float32: the port's fused path (its kernels' plain versions on the CPU)
    against JAX's fused Pallas kernels in interpret mode: root scaler counts
    equal (per rate), root CLVs within 1e-5 of each site's largest entry,
    logL within TOL_LOGL 5e-5, d1/d2 within TOL_D1 5e-3 with an ATOL_D1
    5e-2 floor (bench_validate.py:61-63).
Every construction passes device="cpu": the port's entry points default to
the CUDA device."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu import compute_gamma_cats as j_gamma_cats
from libpll2_tpu import constants as JC
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.ops import pallas_fused as jfused
from libpll2_tpu.trees import parse_newick, random_utree

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import convert
from libpll2_tpu_torch.io import maps as tmaps
from libpll2_tpu_torch.ops import fused as tfused
from libpll2_tpu_torch.trees import create_operations, traverse
from libpll2_tpu_torch.utils import simulate_alignment

CPU = "cpu"
TOL_LOGL, TOL_D1, ATOL_D1 = 5e-5, 5e-3, 5e-2      # bench_validate.py:61-63
TOL_CLV = 1e-5
FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1.0, 2.0, 1.0, 1.0, 2.0, 1.0]
ASC_WEIGHTS = [50, 40, 60, 20]
ASC = ("LEWIS", "FELSENSTEIN", "STAMATAKIS")


def _caterpillar(n, length=0.1):
    text = f"t{n - 1}:{length}"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:{length},{text}):{length}"
    return parse_newick(f"(t0:{length},t1:{length},{text});")


def _data(tree, sites, states=4, alpha=0.9, seed=3, variable=False):
    """{label: sequence} simulated on `tree`; with `variable`, only
    columns that are not constant (a SNP-style alignment)."""
    freqs = FREQS if states == 4 else [1.0 / states] * states
    subst = SUBST if states == 4 else [1.0] * (states * (states - 1) // 2)
    n = sites * 4 if variable else sites
    headers, seqs = simulate_alignment(tree, n, freqs, subst, alpha=alpha,
                                       seed=seed)
    if variable:
        cols = np.array([list(s) for s in seqs])
        keep = np.flatnonzero((cols != cols[:1]).any(axis=0))[:sites]
        assert keep.size == sites
        seqs = ["".join(r) for r in cols[:, keep]]
    return dict(zip(headers, seqs))


def _jax_partition(tree, by, sites, dtype, states=4, rates=4, alpha=0.9,
                   rate_scalers=False, asc=None, weights=False,
                   site_repeats=False):
    jp = JPartition(tree.tip_count, tree.inner_count, states, sites, 1,
                    tree.edge_count, rates, tree.inner_count, dtype=dtype,
                    rate_scalers=rate_scalers,
                    asc_bias=getattr(JC.AscBias, asc or "NONE"),
                    site_repeats=site_repeats)
    cm = jmaps.map_nt if states == 4 else jmaps.map_aa
    for tip in tree.tips():
        jp.set_tip_states(tip.clv_index, cm, by[tip.label])
    jp.set_frequencies(0, FREQS if states == 4 else [1.0 / states] * states)
    jp.set_subst_params(0, SUBST if states == 4
                        else [1.0] * (states * (states - 1) // 2))
    jp.set_category_rates(j_gamma_cats(alpha, rates))
    if weights:
        jp.set_asc_state_weights(ASC_WEIGHTS)
    return jp


def _state(jp):
    state = {k: getattr(jp, k) for k in convert.STATE_KEYS}
    state["_invariant_valid"] = jp._invariant_valid
    if jp.repeats is not None:
        state.update({k: getattr(jp, k, None) for k in convert.REPEATS_KEYS})
    return state


def _port(jp, dtype):
    return convert.partition_from_numpy(_state(jp), device=CPU, dtype=dtype)


def _d_err(got, want):
    return abs(got - want) / max(abs(want), ATOL_D1 / TOL_D1)


def _root_rows_close(part, jp, root):
    """The root edge's scaler rows equal and CLV rows within TOL_CLV of each
    site's largest entry, between the port's and JAX's partitions."""
    for clv_i, sc_i in ((root.clv_index, root.scaler_index),
                        (root.back.clv_index, root.back.scaler_index)):
        if sc_i >= 0:
            np.testing.assert_array_equal(part.scale_buffer[sc_i].numpy(),
                                          np.asarray(jp.scale_buffer[sc_i]))
        want = np.asarray(jp.clv[clv_i])
        site_max = np.maximum(np.abs(want).max(axis=(0, 1)), 1e-30)
        err = np.abs(part.clv[clv_i].numpy() - want) / site_max
        assert err.max() <= TOL_CLV, err.max()


def _hold_f32(te, je):
    """loglikelihood() and three newton_step()s within the float32
    budgets."""
    got, want = te.loglikelihood(), je.loglikelihood()
    assert abs(got - want) / abs(want) < TOL_LOGL
    for _ in range(3):
        (gl, g1, g2), (wl, w1, w2) = te.newton_step(), je.newton_step()
        assert abs(gl - wl) / abs(wl) < TOL_LOGL
        assert _d_err(g1, w1) < TOL_D1 and _d_err(g2, w2) < TOL_D1


def _hold_f64(te, je, steps=3):
    np.testing.assert_allclose(te.loglikelihood(), je.loglikelihood(),
                               rtol=1e-12)
    for _ in range(steps):
        np.testing.assert_allclose(te.newton_step(), je.newton_step(),
                                   rtol=1e-10)


# ------------------------------------------------------- per-rate scalers
# (tree, sites, states, rates, alpha): the caterpillars are deep enough
# for float32 CLVs to underflow, at different depths in different rates
RATE_CASES = {
    "dna_r4_caterpillar": (lambda: _caterpillar(60), 128, 4, 4, 0.9),
    "dna_r16_caterpillar": (lambda: _caterpillar(40), 96, 4, 16, 0.5),
    "aa_r4_caterpillar": (lambda: _caterpillar(40), 64, 20, 4, 0.9),
    "dna_r4_random": (lambda: random_utree([f"t{i}" for i in range(12)],
                                           seed=5), 200, 4, 4, 0.9),
}


def _rate_case(name, dtype):
    make, sites, states, rates, alpha = RATE_CASES[name]
    tree = make()
    by = _data(tree, sites, states, alpha=alpha, seed=11)
    jp = _jax_partition(tree, by, sites, dtype, states, rates, alpha,
                        rate_scalers=True)
    return tree, jp


@pytest.mark.parametrize("case", sorted(RATE_CASES))
def test_rate_scalers_fused_f32_matches_jax_interpret(case):
    """The port's fused path against JAX's fused Pallas kernel (plane
    layout below 16 states, rows layout with mxu='highest' above; the port's
    'split' is exact float32) in per-rate mode."""
    tree, jp = _rate_case(case, jnp.float32)
    mxu = "highest" if jp.states >= 16 else "split"
    je = JTreeEngine(jp, tree, pallas="interpret", mxu=mxu)
    assert je.execution_path == "fused"
    part = _port(jp, torch.float32)
    assert part.scale_buffer.shape == (part.scale_buffers + 2,
                                       part.rate_cats, part.sites)
    te = tp.TreeEngine(part, tree)
    assert te.execution_path == "fused"
    got, want = te.loglikelihood(), je.loglikelihood()
    assert abs(got - want) / abs(want) < TOL_LOGL
    _root_rows_close(part, jp, tree.vroot)
    if "caterpillar" in case:
        sc = part.scale_buffer[tree.vroot.scaler_index].numpy()
        assert sc.max() > 0 and (sc.max(axis=0) != sc.min(axis=0)).any()
    for _ in range(2):
        (gl, g1, g2), (wl, w1, w2) = te.newton_step(), je.newton_step()
        assert abs(gl - wl) / abs(wl) < TOL_LOGL
        assert _d_err(g1, w1) < TOL_D1 and _d_err(g2, w2) < TOL_D1


@pytest.mark.parametrize("case", ["dna_r4_caterpillar",
                                  "dna_r16_caterpillar"])
@pytest.mark.parametrize("pallas", ["auto", "levels-kernel", False])
def test_rate_scalers_f64_paths_match_jax_xla(case, pallas):
    """Every dense path of the port in float64 against JAX's XLA path."""
    tree, jp = _rate_case(case, jnp.float64)
    je = JTreeEngine(jp, tree, pallas=False)
    te = tp.TreeEngine(_port(jp, torch.float64), tree, pallas=pallas)
    assert te.execution_path == {"auto": "fused",
                                 "levels-kernel": "levels-kernel",
                                 False: "levels"}[pallas]
    _hold_f64(te, je)


def test_rate_scalers_step_by_step_f64_matches_jax():
    """update_partials (the level kernel's per-rate plain version), edge
    and root logL, ancestral states, sumtable and derivatives."""
    tree, jp = _rate_case("dna_r4_caterpillar", jnp.float64)
    part = _port(jp, torch.float64)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    r = tree.vroot
    params = [0] * 4
    for p in (jp, part):
        p.update_prob_matrices(params, pidx, br)
        p.update_partials(ops)
    np.testing.assert_array_equal(part.scale_buffer.numpy(),
                                  np.asarray(jp.scale_buffer))
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index, params)
    got = part.compute_edge_loglikelihood(*edge, persite=True)
    want = jp.compute_edge_loglikelihood(*edge, persite=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(part.compute_node_ancestral(*edge),
                               jp.compute_node_ancestral(*edge), rtol=1e-10,
                               atol=1e-14)
    sums = [p.update_sumtable(r.clv_index, r.back.clv_index, r.scaler_index,
                              r.back.scaler_index, params)
            for p in (part, jp)]
    blen = br[pidx.index(r.pmatrix_index)]
    np.testing.assert_allclose(
        part.compute_likelihood_derivatives(sums[0], params, blen),
        jp.compute_likelihood_derivatives(sums[1], params, blen), rtol=1e-10)
    np.testing.assert_array_equal(part.get_scaler(r.scaler_index),
                                  jp.get_scaler(r.scaler_index))


def test_rate_scalers_rows_route_above_8_categories():
    """The rows route refuses per-rate scalers above 8 categories as JAX's
    row-layout kernel does (ValueError); the engine then takes the level
    kernel's per-rate mode where JAX runs XLA ('levels'), to the same
    logL."""
    tree = random_utree([f"t{i}" for i in range(8)], seed=4)
    by = _data(tree, 40, 20, seed=4)
    jp = _jax_partition(tree, by, 40, jnp.float64, 20, rates=9,
                        rate_scalers=True)
    je = JTreeEngine(jp, tree, pallas=True)
    part = _port(jp, torch.float64)
    te = tp.TreeEngine(part, tree)
    assert je.execution_path == "levels"
    assert te.execution_path == "levels-kernel"
    _hold_f64(te, je, steps=1)
    ops, _, _ = create_operations(traverse(tree.vroot))
    table, n_slots = tfused.pack_fused_schedule(
        ops, part.tips, (tree.vroot.clv_index, tree.vroot.back.clv_index))
    args = (torch.tensor(tfused.tip_code_matrix(part)),
            torch.zeros(part.prob_matrices, 9, 20, 20), torch.tensor(table))
    kw = dict(rates=9, states=20, n_slots=n_slots, threshold=0.5,
              factor=2.0, rate_scalers=True)
    for fn in (tfused.fused_traversal, tfused.fused_traversal_rows):
        with pytest.raises(ValueError, match="8 rate categories"):
            fn(*args, **kw)
    with pytest.raises(ValueError):
        jfused.fused_traversal(jnp.asarray(args[0].numpy()),
                               jnp.zeros((part.prob_matrices, 9, 20, 20)),
                               jnp.asarray(table), interpret=True,
                               planes=False, **kw)


# ----------------------------------------------------------- raw tip CLVs
def _raw_values(sites, states, seed):
    return np.random.default_rng(seed).uniform(0.05, 1.0, (sites, states))


def test_tip_clv_one_tip_f32_matches_jax_interpret():
    tree = random_utree([f"t{i}" for i in range(8)], seed=7)
    by = _data(tree, 128, seed=7)
    tip = sorted(tree.tips(), key=lambda t: t.clv_index)[2]
    jp = _jax_partition(tree, by, 128, jnp.float32)
    jp.set_tip_clv(tip.clv_index, _raw_values(128, 4, 0))
    je = JTreeEngine(jp, tree, pallas="interpret")
    part = _port(jp, torch.float32)
    te = tp.TreeEngine(part, tree)
    assert je.execution_path == te.execution_path == "fused"
    np.testing.assert_array_equal(te.table.numpy(), np.asarray(je.ops[0]))
    assert int((te.table[:-1, [1, 4]] == 2).sum()) == 1
    got, want = te.loglikelihood_persite(), je.loglikelihood_persite()
    assert abs(got[0] - want[0]) / abs(want[0]) < TOL_LOGL
    np.testing.assert_allclose(got[1], want[1], rtol=2e-5, atol=1e-4)
    _root_rows_close(part, jp, tree.vroot)
    _hold_f32(te, je)


def test_tip_clv_aa_two_tips_f32_matches_jax_interpret():
    """The rows route with two raw tips at an unaligned site count."""
    tree = random_utree([f"t{i}" for i in range(8)], seed=3)
    by = _data(tree, 200, 20, alpha=1.0, seed=3)
    tips = sorted(tree.tips(), key=lambda t: t.clv_index)
    jp = _jax_partition(tree, by, 200, jnp.float32, 20, alpha=1.0)
    jp.set_tip_clv(tips[1].clv_index, _raw_values(200, 20, 1))
    jp.set_tip_clv(tips[5].clv_index, _raw_values(200, 20, 2))
    je = JTreeEngine(jp, tree, pallas="interpret", mxu="highest")
    te = tp.TreeEngine(_port(jp, torch.float32), tree)
    assert je.execution_path == te.execution_path == "fused"
    _hold_f32(te, je)


def test_tip_clv_with_rate_scalers_f32_matches_jax_interpret():
    tree = _caterpillar(48)
    by = _data(tree, 128, seed=13)
    tip = next(iter(tree.tips()))
    jp = _jax_partition(tree, by, 128, jnp.float32, rate_scalers=True)
    jp.set_tip_clv(tip.clv_index, _raw_values(128, 4, 2))
    je = JTreeEngine(jp, tree, pallas="interpret")
    part = _port(jp, torch.float32)
    te = tp.TreeEngine(part, tree)
    assert je.execution_path == te.execution_path == "fused"
    _hold_f32(te, je)
    _root_rows_close(part, jp, tree.vroot)


def test_tip_clv_bf16_rounds_raw_tips_to_nearest_even():
    """mxu='bf16' rounds raw tip values as JAX's kernel does
    (astype(bfloat16): to nearest, ties to even), unlike the half-up
    rounding of P and inner CLVs; the port's bf16 logL stays within the
    bf16 budget of JAX's."""
    x = np.random.default_rng(0).uniform(0, 1, 4096).astype(np.float32)
    bits = x.view(np.uint32)
    bits[:64] = (bits[:64] & 0xFFFF0000) | 0x8000          # exact ties
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))
    got = tfused.round_bf16_rne(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:64] != tfused.round_bf16(torch.tensor(x[:64])).numpy()
            ).any()
    tree = random_utree([f"t{i}" for i in range(8)], seed=3)
    by = _data(tree, 128, 20, alpha=1.0, seed=3)
    tips = sorted(tree.tips(), key=lambda t: t.clv_index)
    jp = _jax_partition(tree, by, 128, jnp.float32, 20, alpha=1.0)
    jp.set_tip_clv(tips[0].clv_index, _raw_values(128, 20, 3))
    je = JTreeEngine(jp, tree, pallas="interpret", mxu="bf16")
    te = tp.TreeEngine(_port(jp, torch.float32), tree, mxu="bf16")
    got, want = te.loglikelihood(), je.loglikelihood()
    assert abs(got - want) / abs(want) < 1e-4


@pytest.mark.parametrize("pallas", ["auto", "levels-kernel", False])
def test_tip_clv_f64_paths_match_jax_xla(pallas):
    """set_tip_clv through the port's own setter: the dense rows equal
    JAX's, and every dense path matches JAX's XLA path."""
    tree = random_utree([f"t{i}" for i in range(10)], seed=9)
    by = _data(tree, 150, seed=9)
    tips = sorted(tree.tips(), key=lambda t: t.clv_index)
    jp = _jax_partition(tree, by, 150, jnp.float64)
    part = _port(jp, torch.float64)
    for k, tip in enumerate(tips[::3]):
        vals = _raw_values(150, 4, 10 + k)
        jp.set_tip_clv(tip.clv_index, vals)
        part.set_tip_clv(tip.clv_index, vals)
    for key in ("_tips_set", "_tips_clv_set"):
        np.testing.assert_array_equal(getattr(part, key), getattr(jp, key))
    np.testing.assert_array_equal(part.clv[:part.tips].numpy(),
                                  np.asarray(jp.clv[:jp.tips]))
    te = tp.TreeEngine(part, tree, pallas=pallas)
    assert te.execution_path == {"auto": "fused",
                                 "levels-kernel": "levels-kernel",
                                 False: "levels"}[pallas]
    _hold_f64(te, JTreeEngine(jp, tree, pallas=False))


def test_tip_clv_membership_change_raises():
    """A new raw tip after packing raises (the op table says which tips are
    raw rows); new values for a packed raw tip are read; a rebuilt engine
    takes the new set."""
    tree = random_utree([f"t{i}" for i in range(8)], seed=9)
    by = _data(tree, 128, seed=9)
    tips = sorted(tree.tips(), key=lambda t: t.clv_index)
    jp = _jax_partition(tree, by, 128, jnp.float32)
    part = _port(jp, torch.float32)
    rng = np.random.default_rng(3)
    part.set_tip_clv(tips[0].clv_index, rng.uniform(0.1, 1, (128, 4)))
    eng = tp.TreeEngine(part, tree)
    assert eng.execution_path == "fused"
    lk1 = eng.loglikelihood()
    part.set_tip_clv(tips[0].clv_index, rng.uniform(0.1, 1, (128, 4)))
    assert eng.loglikelihood() != lk1
    part.set_tip_clv(tips[3].clv_index, rng.uniform(0.1, 1, (128, 4)))
    with pytest.raises(tp.PllError, match="raw-probability tips"):
        eng.loglikelihood()
    eng.set_topology(tree)
    assert np.isfinite(eng.loglikelihood())
    assert np.isfinite(tp.TreeEngine(part, tree).loglikelihood())


# ---------------------------------------------------- ascertainment bias
def _asc_case(asc, dtype, sites=160, site_repeats=False, seed=23):
    tree = random_utree([f"t{i}" for i in range(12)], seed=seed)
    by = _data(tree, sites, seed=seed, variable=True)
    jp = _jax_partition(tree, by, sites, dtype, asc=asc,
                        weights=asc != "LEWIS", site_repeats=site_repeats)
    return tree, jp


@pytest.mark.parametrize("asc", ASC)
@pytest.mark.parametrize("pallas", ["auto", "levels-kernel"])
def test_asc_f64_paths_match_jax_xla(asc, pallas):
    tree, jp = _asc_case(asc, jnp.float64)
    part = _port(jp, torch.float64)
    assert part.sites_padded == part.sites + 4
    np.testing.assert_array_equal(part.clv[:part.tips].numpy(),
                                  np.asarray(jp.clv[:jp.tips]))
    np.testing.assert_array_equal(tfused.tip_code_matrix(part),
                                  jfused.tip_code_matrix(jp))
    te = tp.TreeEngine(part, tree, pallas=pallas)
    je = JTreeEngine(jp, tree, pallas=False)
    t_total, t_per = te.loglikelihood_persite()
    j_total, j_per = je.loglikelihood_persite()
    np.testing.assert_allclose(t_total, j_total, rtol=1e-12)
    np.testing.assert_allclose(t_per, j_per, rtol=1e-11,
                               atol=1e-12 * np.abs(j_per).max())
    _hold_f64(te, je)


@pytest.mark.parametrize("asc", ASC)
def test_asc_fused_f32_matches_jax_interpret(asc):
    tree, jp = _asc_case(asc, jnp.float32)
    je = JTreeEngine(jp, tree, pallas="interpret")
    te = tp.TreeEngine(_port(jp, torch.float32), tree)
    assert je.execution_path == te.execution_path == "fused"
    _hold_f32(te, je)


@pytest.mark.parametrize("asc", ASC)
def test_asc_step_by_step_f64_matches_jax(asc):
    """The port's own setters (set_asc_state_weights), then the
    step-by-step chain; Lewis and Felsenstein read the edge's scalers in
    compute_likelihood_derivatives."""
    tree, jp = _asc_case(asc, jnp.float64)
    part = tp.Partition(jp.tips, jp.clv_buffers, 4, jp.sites, 1,
                        jp.prob_matrices, 4, jp.scale_buffers, device=CPU,
                        dtype=torch.float64, asc_bias=getattr(tp.AscBias, asc))
    by = _data(tree, jp.sites, seed=23, variable=True)
    tips = list(tree.tips())
    part.set_tip_states_batch(tmaps.map_nt, [by[t.label] for t in tips],
                              [t.clv_index for t in tips])
    part.set_frequencies(0, FREQS)
    part.set_subst_params(0, SUBST)
    part.set_category_rates(tp.compute_gamma_cats(0.9, 4))
    if asc != "LEWIS":
        part.set_asc_state_weights(ASC_WEIGHTS)
    for key in convert.MIRROR_KEYS:
        np.testing.assert_array_equal(getattr(part, key), getattr(jp, key))
    ops, br, pidx = create_operations(traverse(tree.vroot))
    r = tree.vroot
    params = [0] * 4
    for p in (jp, part):
        p.update_prob_matrices(params, pidx, br)
        p.update_partials(ops)
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index, params)
    np.testing.assert_allclose(part.compute_edge_loglikelihood(*edge),
                               jp.compute_edge_loglikelihood(*edge),
                               rtol=1e-12)
    sums = [p.update_sumtable(r.clv_index, r.back.clv_index, r.scaler_index,
                              r.back.scaler_index, params)
            for p in (part, jp)]
    blen = br[pidx.index(r.pmatrix_index)]
    for length in (blen, 2.5 * blen):
        np.testing.assert_allclose(
            part.compute_likelihood_derivatives(
                sums[0], params, length, r.scaler_index,
                r.back.scaler_index),
            jp.compute_likelihood_derivatives(
                sums[1], params, length, r.scaler_index,
                r.back.scaler_index), rtol=1e-10)
    # switching the type on the same partition
    for p in (jp, part):
        p.set_asc_bias_type(type(p.asc_bias).STAMATAKIS)
    np.testing.assert_allclose(part.compute_edge_loglikelihood(*edge),
                               jp.compute_edge_loglikelihood(*edge),
                               rtol=1e-12)


def test_asc_scaled_synthetic_columns_f32():
    """A deep caterpillar with long branches and little rate variation
    (a slow Gamma category would keep the constant columns above the
    threshold) scales the synthetic columns too in float32: the
    corrections' un-scaling of them is exercised in logL and derivatives
    (the port's fused path against JAX's XLA path)."""
    tree = _caterpillar(70, length=0.5)
    by = _data(tree, 96, alpha=20.0, seed=5, variable=True)
    for asc in ("LEWIS", "STAMATAKIS"):
        jp = _jax_partition(tree, by, 96, jnp.float32, alpha=20.0, asc=asc,
                            weights=asc != "LEWIS")
        je = JTreeEngine(jp, tree, pallas=False)
        je.loglikelihood()
        root = tree.vroot
        assert int(np.asarray(jp.scale_buffer[root.scaler_index])
                   [96:].max()) > 0, "synthetic columns never scaled"
        te = tp.TreeEngine(_port(jp, torch.float32), tree)
        _hold_f32(te, je)


# --------------------------------------------------------- site repeats
@pytest.mark.parametrize("asc", ASC)
def test_repeats_asc_matches_jax(asc):
    """Site repeats with the synthetic columns in the class domain
    (tests/test_repeats_m4.py:236): float64 step-by-step and the pooled
    engine against JAX's pooled XLA path; the default engine
    ('repeats-dense-fused') in float32 against JAX's dense fused kernel."""
    tree, jp = _asc_case(asc, jnp.float64, sites=200, site_repeats=True)
    part = _port(jp, torch.float64)
    assert part.repeats is not None
    np.testing.assert_array_equal(part.repeats.site_id, jp.repeats.site_id)
    for t in range(part.tips):
        np.testing.assert_array_equal(part._tip_cols[t], jp._tip_cols[t])
    ops, br, pidx = create_operations(traverse(tree.vroot))
    r = tree.vroot
    params = [0] * 4
    for p in (jp, part):
        p.update_prob_matrices(params, pidx, br)
        p.update_partials(ops)
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index, params)
    np.testing.assert_allclose(part.compute_edge_loglikelihood(*edge),
                               jp.compute_edge_loglikelihood(*edge),
                               rtol=1e-12)
    te = tp.TreeEngine(_port(jp, torch.float64), tree, pallas="pool")
    assert te.execution_path == "pool-pallas"
    _hold_f64(te, JTreeEngine(jp, tree, pallas=False), steps=2)
    tree32, jp32 = _asc_case(asc, jnp.float32, sites=200, site_repeats=True)
    te = tp.TreeEngine(_port(jp32, torch.float32), tree32)
    assert te.execution_path == "repeats-dense-fused"
    je = JTreeEngine(jp32, tree32, pallas="interpret")
    assert je.execution_path == "repeats-dense-fused"
    _hold_f32(te, je)


@pytest.mark.parametrize("asc", ["LEWIS", "FELSENSTEIN"])
def test_repeats_asc_step_by_step_derivatives(asc):
    """compute_likelihood_derivatives with the Lewis or Felsenstein
    correction on a repeats partition reads the edge's scalers through the
    classes of the nodes that wrote them. On a float32 caterpillar whose
    synthetic columns rescale (once: threshold**2 is the deepest that
    float32 holds, so the corrections' un-scaling stays exact) it equals
    the port's dense partition and JAX's dense one within the float32
    budgets; JAX's repeats partition fails here (it reads the dense scaler
    buffer it does not have: ROADMAP C)."""
    tree = _caterpillar(60, length=0.3)
    by = _data(tree, 96, alpha=20.0, seed=5, variable=True)
    kw = dict(alpha=20.0, asc=asc, weights=asc != "LEWIS")
    jdense = _jax_partition(tree, by, 96, jnp.float32, **kw)
    jrep = _jax_partition(tree, by, 96, jnp.float32, site_repeats=True,
                          **kw)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    r = tree.vroot
    params = [0] * 4
    sc_idx = (r.scaler_index, r.back.scaler_index)
    blen = br[pidx.index(r.pmatrix_index)]
    res = []
    for p in (jdense, jrep, _port(jdense, torch.float32),
              _port(jrep, torch.float32)):
        p.update_prob_matrices(params, pidx, br)
        p.update_partials(ops)
        st = p.update_sumtable(r.clv_index, r.back.clv_index, *sc_idx,
                               params)
        if p is jrep:
            with pytest.raises(TypeError):
                p.compute_likelihood_derivatives(st, params, blen, *sc_idx)
            continue
        res.append(p.compute_likelihood_derivatives(st, params, blen,
                                                    *sc_idx))
    assert int(np.asarray(jdense.scale_buffer[r.scaler_index])[96:].max()) \
        > 0, "synthetic columns never scaled"
    for got in res[1:]:
        assert _d_err(got[0], res[0][0]) < TOL_D1
        assert _d_err(got[1], res[0][1]) < TOL_D1


def test_repeats_rate_scalers_match_jax():
    """tests/test_repeats_m4.py:398: a 120-taxon caterpillar at alpha 0.3,
    where per-rate counts diverge between categories. float64: the port's
    pooled step-by-step and its 'pool-pallas' engine (JAX: 'pool', XLA)
    against JAX's pooled XLA path; float32: 'repeats-dense-fused' against
    JAX's dense fused kernel in interpret mode."""
    tree = _caterpillar(120)
    by = _data(tree, 300, alpha=0.3, seed=17)
    jp = _jax_partition(tree, by, 300, jnp.float64, alpha=0.3,
                        rate_scalers=True, site_repeats=True)
    part = _port(jp, torch.float64)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    r = tree.vroot
    params = [0] * 4
    for p in (jp, part):
        p.update_prob_matrices(params, pidx, br)
        p.update_partials(ops)
    assert part.sc_flat.shape[0] == 4
    sc = part.sc_flat.numpy()
    assert sc.max() > 0 and (sc.max(axis=0) != sc.min(axis=0)).any()
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index, params)
    np.testing.assert_allclose(part.compute_edge_loglikelihood(*edge),
                               jp.compute_edge_loglikelihood(*edge),
                               rtol=1e-12)
    jpool = JTreeEngine(jp, tree, pallas="pool")
    te = tp.TreeEngine(part, tree, pallas="pool")
    assert jpool.execution_path == "pool"
    assert te.execution_path == "pool-pallas"
    _hold_f64(te, jpool, steps=1)
    jp32 = _jax_partition(tree, by, 300, jnp.float32, alpha=0.3,
                          rate_scalers=True, site_repeats=True)
    je = JTreeEngine(jp32, tree, pallas="interpret")
    te = tp.TreeEngine(_port(jp32, torch.float32), tree)
    assert je.execution_path == te.execution_path == "repeats-dense-fused"
    _hold_f32(te, je)


@pytest.mark.parametrize("asc", [None, "LEWIS"])
def test_repeats_tip_clv_identity_mapping(asc):
    """set_tip_clv on a repeats partition: the tip takes the identity
    mapping and per-site columns (sites + asc wide), as in JAX; logL of the
    pooled path (float64) and of 'repeats-dense-fused' (float32) against
    JAX's."""
    tree = random_utree([f"t{i}" for i in range(10)], seed=31)
    sites = 160
    by = _data(tree, sites, seed=31, variable=asc is not None)
    tips = sorted(tree.tips(), key=lambda t: t.clv_index)
    results = []
    for dtype, tdtype, pallas in ((jnp.float64, torch.float64, "pool"),
                                  (jnp.float32, torch.float32, "auto")):
        jp = _jax_partition(tree, by, sites, dtype, asc=asc,
                            site_repeats=True)
        part = _port(jp, tdtype)
        for k, tip in enumerate(tips[1::4]):
            vals = _raw_values(sites, 4, 40 + k)
            jp.set_tip_clv(tip.clv_index, vals)
            part.set_tip_clv(tip.clv_index, vals)
            assert part.repeats.ids[tip.clv_index] == 0
            np.testing.assert_array_equal(part._tip_cols[tip.clv_index],
                                          jp._tip_cols[tip.clv_index])
        te = tp.TreeEngine(part, tree, pallas=pallas)
        je = JTreeEngine(jp, tree, pallas=False if pallas == "pool"
                         else "interpret")
        results.append((te.execution_path, te, je))
    (path64, te64, je64), (path32, te32, je32) = results
    assert path64 == "pool-pallas" and path32 == "repeats-dense-fused"
    _hold_f64(te64, je64, steps=1)
    _hold_f32(te32, je32)


# ---------------------------------------------------------------- convert
CONVERT_CASES = ("rate_scalers", "asc_stamatakis", "tip_clv",
                 "repeats_asc_tip_clv", "repeats_rate_scalers")


@pytest.mark.parametrize("case", CONVERT_CASES)
def test_convert_carries_features(case):
    """A JAX partition carrying the features, after its own update_partials,
    converted with its buffers: the port's step-by-step edge logL from the
    JAX partition's rows equals JAX's, and its engine's logL too."""
    tree = random_utree([f"t{i}" for i in range(10)], seed=37)
    sites = 180
    asc = "STAMATAKIS" if "asc" in case else None
    by = _data(tree, sites, seed=37, variable=asc is not None)
    jp = _jax_partition(tree, by, sites, jnp.float64, asc=asc,
                        weights=asc is not None,
                        rate_scalers="rate_scalers" in case,
                        site_repeats=case.startswith("repeats"))
    if "tip_clv" in case:
        tip = sorted(tree.tips(), key=lambda t: t.clv_index)[4]
        jp.set_tip_clv(tip.clv_index, _raw_values(sites, 4, 5))
    ops, br, pidx = create_operations(traverse(tree.vroot))
    r = tree.vroot
    params = [0] * 4
    jp.update_prob_matrices(params, pidx, br)
    jp.update_partials(ops)
    part = _port(jp, torch.float64)
    assert part.rate_scalers == jp.rate_scalers
    assert part.asc_bias.value == jp.asc_bias.value
    assert part.sites_padded == jp.sites_padded
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index, params)
    if part.repeats is None:
        np.testing.assert_allclose(part.compute_edge_loglikelihood(*edge),
                                   jp.compute_edge_loglikelihood(*edge),
                                   rtol=1e-12)
    je = JTreeEngine(jp, tree, pallas=False)
    te = tp.TreeEngine(part, tree, pallas=False)
    np.testing.assert_allclose(te.loglikelihood(), je.loglikelihood(),
                               rtol=1e-12)
