"""The port's main path as a whole against libpll2_tpu: 24 taxa x 1000
sites, GTR+G4 DNA, on the CPU.

float64: the port's TreeEngine (plain traversal) against the JAX XLA path,
`TreeEngine(..., pallas=False)`, to 1e-12 in logL and 1e-10 through three
Newton steps (the two differ only in summation order).

float32: against the JAX fused path with its Pallas kernel in interpret
mode, within bench_validate.py's float32 budgets (TOL_LOGL 5e-5, TOL_D1
5e-3 with an ATOL_D1 5e-2 floor): the float32 summation orders differ.

The port's partition is built from the JAX partition's state through
libpll2_tpu_torch.convert. Features outside the port must raise
NotImplementedError, and what JAX refuses the port refuses with JAX's
error."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu import compute_gamma_cats as j_gamma_cats
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.trees import random_alignment, random_utree

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import convert
from libpll2_tpu_torch.io import maps as tmaps
from libpll2_tpu_torch.ops import fused as tfused
from libpll2_tpu_torch.trees import UTree

N_TAXA, SITES, SEED = 24, 1000, 7
TOL_LOGL, TOL_D1, ATOL_D1 = 5e-5, 5e-3, 5e-2      # bench_validate.py:61-63


def _alignment():
    """Random columns, the first 200 of them constant (invariant sites)."""
    headers, seqs = random_alignment(N_TAXA, SITES, alphabet="ACGTACGTN-R",
                                     seed=SEED)
    return headers, [seqs[0][:200] + s[200:] for s in seqs]


def _jax_partition(dtype, pinv=0.0):
    headers, seqs = _alignment()
    tree = random_utree(headers, seed=SEED)
    jp = JPartition(tree.tip_count, tree.inner_count, 4, SITES, 1,
                    tree.edge_count, 4, tree.inner_count, dtype=dtype)
    by = dict(zip(headers, seqs))
    for tip in tree.tips():
        jp.set_tip_states(tip.clv_index, jmaps.map_nt, by[tip.label])
    rng = np.random.default_rng(SEED)
    jp.set_frequencies(0, rng.dirichlet(np.ones(4) * 10))
    jp.set_subst_params(0, rng.uniform(0.5, 2.0, size=6))
    jp.set_category_rates(j_gamma_cats(0.8, 4))
    jp.set_pattern_weights(rng.integers(1, 4, size=SITES))
    if pinv:
        jp.update_invariant_sites_proportion(0, pinv)
    return jp, tree


def _state(jp):
    state = {k: getattr(jp, k) for k in convert.STATE_KEYS}
    state["_invariant_valid"] = jp._invariant_valid
    return state


def _d_err(got, want):
    return abs(got - want) / max(abs(want), ATOL_D1 / TOL_D1)


@pytest.mark.parametrize("pinv", [0.0, 0.15])
def test_engine_f64_matches_jax_xla(pinv):
    jp, tree = _jax_partition(jnp.float64, pinv)
    je = JTreeEngine(jp, tree, pallas=False)
    part = convert.partition_from_numpy(_state(jp), device="cpu",
                                        dtype=torch.float64)
    te = tp.TreeEngine(part, tree)
    assert te.execution_path == "fused"
    np.testing.assert_allclose(te.loglikelihood(), je.loglikelihood(),
                               rtol=1e-12)
    t_total, t_per = te.loglikelihood_persite()
    j_total, j_per = je.loglikelihood_persite()
    np.testing.assert_allclose(t_total, j_total, rtol=1e-12)
    # all-gap columns have a site likelihood of 1: log ~ 1e-16, so their
    # rounding is held to the scale of the largest term
    np.testing.assert_allclose(t_per, j_per, rtol=1e-12,
                               atol=1e-12 * np.abs(j_per).max())
    root_mat = tree.vroot.pmatrix_index
    for _ in range(3):
        got, want = te.newton_step(), je.newton_step()
        np.testing.assert_allclose(got, want, rtol=1e-10)
        np.testing.assert_allclose(float(te.branches[root_mat]),
                                   float(je.branches[root_mat]), rtol=1e-10)
    # the JAX engine's branch vector carried across gives the same logL
    b = convert.engine_branches_from_numpy(np.asarray(je.branches),
                                           device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(te.loglikelihood(branches=b),
                               je.loglikelihood(), rtol=1e-12)


def test_engine_f32_matches_jax_pallas_interpret():
    jp, tree = _jax_partition(jnp.float32)
    je = JTreeEngine(jp, tree, pallas="interpret")
    assert je.execution_path == "fused"
    part = convert.partition_from_numpy(_state(jp), device="cpu",
                                        dtype=torch.float32)
    te = tp.TreeEngine(part, tree)
    got, want = te.loglikelihood(), je.loglikelihood()
    assert abs(got - want) / abs(want) < TOL_LOGL
    for _ in range(3):
        (gl, g1, g2), (wl, w1, w2) = te.newton_step(), je.newton_step()
        assert abs(gl - wl) / abs(wl) < TOL_LOGL
        assert _d_err(g1, w1) < TOL_D1 and _d_err(g2, w2) < TOL_D1


def test_engine_set_topology_reroots_to_same_logl():
    """Rerooting at another inner node keeps the logL (reversible model)
    and exercises set_topology's repack."""
    jp, tree = _jax_partition(jnp.float64)
    part = convert.partition_from_numpy(_state(jp), device="cpu",
                                        dtype=torch.float64)
    te = tp.TreeEngine(part, tree)
    want = te.loglikelihood()
    inner = [n for n in tree.nodes() if not n.is_tip()]
    other = UTree(vroot=inner[len(inner) // 2].next, tip_count=tree.tip_count,
                  inner_count=tree.inner_count, edge_count=tree.edge_count)
    old_table = te.table.clone()
    te.set_topology(other)
    assert not torch.equal(te.table, old_table)
    np.testing.assert_allclose(te.loglikelihood(), want, rtol=1e-12)


def test_partition_setters_match_jax_mirrors():
    """Building the port's partition through its own setters gives the
    mirrors the JAX partition holds."""
    jp, tree = _jax_partition(jnp.float64, pinv=0.2)
    headers, seqs = _alignment()
    part = tp.Partition(tree.tip_count, tree.inner_count, 4, SITES, 1,
                        tree.edge_count, 4, tree.inner_count,
                        device="cpu", dtype=torch.float64)
    by = dict(zip(headers, seqs))
    tips = tree.tips()
    part.set_tip_states_batch(tmaps.map_nt, [by[t.label] for t in tips],
                              [t.clv_index for t in tips])
    rng = np.random.default_rng(SEED)
    part.set_frequencies(0, rng.dirichlet(np.ones(4) * 10))
    part.set_subst_params(0, rng.uniform(0.5, 2.0, size=6))
    part.set_category_rates(tp.compute_gamma_cats(0.8, 4))
    part.set_pattern_weights(rng.integers(1, 4, size=SITES))
    part.update_invariant_sites_proportion(0, 0.2)
    for key in convert.MIRROR_KEYS:
        np.testing.assert_array_equal(getattr(part, key), getattr(jp, key))
    np.testing.assert_allclose(
        tp.TreeEngine(part, tree).loglikelihood(),
        JTreeEngine(jp, tree, pallas=False).loglikelihood(), rtol=1e-12)


def test_engine_rejects_branch_vector_of_wrong_size():
    jp, tree = _jax_partition(jnp.float64)
    te = tp.TreeEngine(convert.partition_from_numpy(_state(jp), device="cpu",
                                                    dtype=torch.float64),
                       tree)
    with pytest.raises(tp.PllError, match="branches"):
        te.loglikelihood(branches=np.ones(tree.edge_count - 1))


def test_partition_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.Partition(4, 2, 4, 10, 1, 5, 4, 2, device="cuda")


def test_partition_dtype_is_explicit():
    part = tp.Partition(4, 2, 4, 10, 1, 5, 4, 2, device="cpu")
    assert part.dtype == torch.float32
    assert part.scale_threshold == tp.constants.SCALE_THRESHOLD_F32
    with pytest.raises(tp.PllError):
        tp.Partition(4, 2, 4, 10, 1, 5, 4, 2, device="cpu", dtype=np.float64)


def _fp64_on_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    tp.Partition(4, 2, 4, 10, 1, 5, 4, 2, device="cuda",
                 dtype=torch.float64)


def _rows_rate_scalers_above_8(mp):
    """The rows route (20 states) with per-rate scalers at 9 categories."""
    table = torch.tensor([[0, 1, 0, 0, 1, 1, 0, 1], [0, 0, 1, 2, 0, 0, 0, 0]],
                         dtype=torch.int32)
    tfused.fused_traversal(torch.ones((3, 8), dtype=torch.int32),
                           torch.zeros(1, 9, 20, 20), table, rates=9,
                           states=20, n_slots=1, threshold=0.5, factor=2.0,
                           rate_scalers=True)


def _asc_with_pinv(mp):
    part = tp.Partition(*SIZES, **CPU, asc_bias=tp.AscBias.LEWIS)
    part.update_invariant_sites_proportion(0, 0.2)


def _asc_type_after_pinv(mp):
    """tests/test_asc_m3.py:164: a correction switched on over p-inv."""
    part = tp.Partition(*SIZES, **CPU, asc_bias=tp.AscBias.LEWIS)
    part.set_asc_bias_type(tp.AscBias.NONE)
    part.prop_invar[0] = 0.2
    part.set_asc_bias_type(tp.AscBias.LEWIS)


SIZES = (4, 2, 4, 10, 1, 5, 4, 2)
CPU = {"device": "cpu"}
# feature -> (call, the exception it raises: NotImplementedError where the
# port lacks the feature, JAX's own error where JAX refuses it as well)
OUT_OF_SLICE = {
    "mesh": (lambda mp: tp.Partition(*SIZES, **CPU, mesh=object()),
             NotImplementedError),
    "states_33": (lambda mp: tp.Partition(4, 2, 33, 10, 1, 5, 4, 2, **CPU),
                  NotImplementedError),
    "fp64_cuda": (_fp64_on_cuda, NotImplementedError),
    "rate_scalers_with_asc": (lambda mp: tp.Partition(
        *SIZES, **CPU, rate_scalers=True, asc_bias=tp.AscBias.LEWIS),
        tp.PllError),
    "asc_with_pinv": (_asc_with_pinv, tp.PllError),
    "asc_type_after_pinv": (_asc_type_after_pinv, tp.PllError),
    # tests/test_asc_m3.py:247: no synthetic columns were allocated
    "asc_type_without_columns": (lambda mp: tp.Partition(
        *SIZES, **CPU).set_asc_bias_type(tp.AscBias.LEWIS), tp.PllError),
    "rows_rate_scalers_above_8": (_rows_rate_scalers_above_8, ValueError),
}


@pytest.mark.parametrize("feature", sorted(OUT_OF_SLICE))
def test_out_of_slice_features_raise(feature, monkeypatch):
    call, exc = OUT_OF_SLICE[feature]
    with pytest.raises(exc):
        call(monkeypatch)
