"""Site repeats in the PyTorch port against libpll2_tpu on the CPU.

The same alignments, simulated from a seed on conserved trees (branches
shortened as tools/benchmarks.py:236-241 and bench_validate.py:224-232 do,
so that the class tables compress), go through the JAX package and the
port. Tolerances:
  * host code (class tables, tip columns, pooled layouts, bucket
    schedules): `==`;
  * float32 pools, the port's pool levels (ops/pool.py, plain on the CPU)
    against JAX's Pallas pool kernel in interpret mode and against JAX's
    XLA pool path, from the same pools: scaler counts equal, class columns
    to rtol 2e-6 (tests/test_pallas_repeats.py:54-56);
  * float64: pools to 1e-12; repeats against dense partitions (logL,
    per-site logL, d1/d2, ancestral states, get_clv) to 1e-12, as
    tests/test_repeats_m4.py holds them;
  * float32 engines against JAX's: TOL_LOGL 5e-5, TOL_D1 5e-3 with an
    ATOL_D1 5e-2 floor (bench_validate.py:61-63).
One semantic difference is tested as such: the port rescales a pooled op
only when it has a scaler buffer (as JAX's dense paths and the reference
do); JAX's pooled paths rescale every op and drop the count. Every
construction passes device="cpu": the port's entry points default to the
CUDA device."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu import compute_gamma_cats as j_gamma_cats
from libpll2_tpu import models as jmodels
from libpll2_tpu import repeats as jrepeats
from libpll2_tpu.constants import UTREE_MOVE_NNI_LEFT
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.ops import pallas_repeats as jpool
from libpll2_tpu.ops import partials as jpartials
from libpll2_tpu.trees import moves as jmoves
from libpll2_tpu.trees import parse_newick, random_utree

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import convert
from libpll2_tpu_torch import models as tmodels
from libpll2_tpu_torch import repeats as trepeats
from libpll2_tpu_torch.io import maps as tmaps
from libpll2_tpu_torch.ops import levels as tlevels
from libpll2_tpu_torch.ops import pool as tpool
from libpll2_tpu_torch.trees import create_operations, traverse
from libpll2_tpu_torch.utils import simulate_alignment

SEED = 13
CPU = "cpu"
TOL_LOGL, TOL_D1, ATOL_D1 = 5e-5, 5e-3, 5e-2      # bench_validate.py:61-63
SUBST = [1.0, 2.0, 1.0, 1.0, 2.0, 1.0]
FREQS1 = [0.2, 0.3, 0.3, 0.2]
SUBST1 = [0.7, 1.1, 2.4, 0.9, 1.6, 1.0]
LAYOUT_FIELDS = convert.LAYOUT_FIELDS


def _caterpillar(n):
    """tests/test_repeats_m4.py:124-128: deep enough that CLVs underflow."""
    text = f"t{n - 1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    return parse_newick(f"(t0:0.1,t1:0.1,{text});")


def _conserve(tree, scale, floor, clamp=False):
    """Shorten every branch to scale * len + floor (or max(scale * len,
    floor) with `clamp`)."""
    seen = set()
    for nd in tree.nodes():
        for h in ([nd] if nd.is_tip() else list(nd.ring())):
            if h.back is not None and id(h) not in seen:
                seen.update((id(h), id(h.back)))
                length = (max(h.length * scale, floor) if clamp
                          else h.length * scale + floor)
                h.length = h.back.length = length
    return tree


# kind -> (taxa, sites, states, rates)
PROBLEMS = {"dna": (12, 320, 4, 4), "rates3": (12, 320, 4, 3),
            "aa20": (10, 200, 20, 4), "caterpillar": (40, 200, 4, 4),
            "deep": (40, 200, 4, 4)}


def _problem(kind, seed=SEED):
    """(tree, {label: sequence}, sites, states, rates)."""
    taxa, sites, states, rates = PROBLEMS[kind]
    if kind == "caterpillar":
        tree = _caterpillar(taxa)
    else:
        tree = random_utree([f"t{i}" for i in range(taxa)], seed=seed)
        if kind == "deep":
            pass                  # full-length branches: float32 rescales
        elif states == 20:
            _conserve(tree, 0.3, 0.02, clamp=True)
        else:
            _conserve(tree, 0.15, 0.001)
    if states == 20:
        headers, seqs = simulate_alignment(tree, sites, [1 / 20] * 20,
                                           [1.0] * 190, alpha=0.9, seed=seed)
    else:
        headers, seqs = simulate_alignment(tree, sites, [0.25] * 4, SUBST,
                                           alpha=0.7, seed=seed)
    return tree, dict(zip(headers, seqs)), sites, states, rates


def _fill(p, states, rates, rate_matrices=1):
    if states == 20:
        (jmodels if isinstance(p, JPartition) else tmodels).load_aa_model(
            p, "lg")
    else:
        p.set_frequencies(0, [0.3, 0.25, 0.2, 0.25])
        p.set_subst_params(0, SUBST)
        if rate_matrices == 2:
            p.set_frequencies(1, FREQS1)
            p.set_subst_params(1, SUBST1)
    p.set_category_rates(j_gamma_cats(0.7, rates))


def _jax(tree, by, sites, states, rates, f64=True, repeats=True,
         rate_matrices=1):
    jp = JPartition(tree.tip_count, tree.inner_count, states, sites,
                    rate_matrices, tree.edge_count, rates, tree.inner_count,
                    dtype=jnp.float64 if f64 else jnp.float32,
                    site_repeats=repeats)
    cm = jmaps.map_aa if states == 20 else jmaps.map_nt
    for tip in tree.tips():
        jp.set_tip_states(tip.clv_index, cm, by[tip.label])
    _fill(jp, states, rates, rate_matrices)
    return jp


def _port(tree, by, sites, states, rates, f64=True, repeats=True,
          rate_matrices=1):
    part = tp.Partition(tree.tip_count, tree.inner_count, states, sites,
                        rate_matrices, tree.edge_count, rates,
                        tree.inner_count, device=CPU,
                        dtype=torch.float64 if f64 else torch.float32,
                        site_repeats=repeats)
    tips = list(tree.tips())
    part.set_tip_states_batch(tmaps.map_aa if states == 20 else tmaps.map_nt,
                              [by[t.label] for t in tips],
                              [t.clv_index for t in tips])
    _fill(part, states, rates, rate_matrices)
    return part


def _edge(tree, rates):
    r = tree.vroot
    return (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index, [0] * rates)


def _layouts_equal(got, want):
    for f in LAYOUT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def _rel(got, want):
    return abs(got - want) / abs(want)


def _d_err(got, want):
    return abs(got - want) / max(abs(want), ATOL_D1 / TOL_D1)


# ---------------------------------------------------------------- host code
@pytest.mark.parametrize("kind", ["dna", "aa20"])
def test_host_tables_identical(kind):
    tree, by, sites, states, rates = _problem(kind)
    jp = _jax(tree, by, sites, states, rates)
    part = _port(tree, by, sites, states, rates)
    for name in ("site_id", "id_site", "ids"):
        np.testing.assert_array_equal(getattr(part.repeats, name),
                                      getattr(jp.repeats, name))
    assert sorted(part._tip_cols) == sorted(jp._tip_cols)
    for t, cols in jp._tip_cols.items():
        np.testing.assert_array_equal(part._tip_cols[t], cols)
    assert 0 < part.repeats.ids[:tree.tip_count].max() <= states + 4
    for c in (1, 127, 128, 129, 300, sites):
        assert trepeats.bucket_width(c, sites) == \
            jrepeats.bucket_width(c, sites)

    ops, _, _ = create_operations(traverse(tree.vroot))
    k = tree.inner_count
    jt, tt = copy.deepcopy(jp.repeats), copy.deepcopy(part.repeats)
    jlay, jb = jrepeats.schedule_buckets_flat(jt, ops, sites, k)
    tlay, tb = trepeats.schedule_buckets_flat(tt, ops, sites, k)
    _layouts_equal(tlay, jlay)
    for name in ("site_id", "id_site", "ids"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    assert tt.ids[tree.tip_count:].min() > 0, "inner classes never compress"
    assert [(w, il, ir) for w, _, _, _, il, ir in tb] == \
        [(w, il, ir) for w, _, _, _, il, ir in jb]
    for t, j in zip(tb, jb):
        for g, w in zip(t[1:4], j[1:4]):
            np.testing.assert_array_equal(g, w)
    got = trepeats.schedule_buckets(copy.deepcopy(part.repeats), ops, sites)
    want = jrepeats.schedule_buckets(copy.deepcopy(jp.repeats), ops, sites)
    assert [(w, [o.parent_clv_index for o in o_]) for w, o_, _, _ in got] \
        == [(w, [o.parent_clv_index for o in o_]) for w, o_, _, _ in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3], w[3])
    # a partial list: the scalers it reads keep their columns in the port's
    # layout (the JAX layout gives them none)
    part_ops = ops[len(ops) // 2:]
    lay, _ = trepeats.classify_operations(copy.deepcopy(tt), part_ops, sites,
                                          k)
    read = {s for o in part_ops for s in (o.child1_scaler_index,
                                          o.child2_scaler_index) if s >= 0}
    assert read and all(lay.sc_caps[s] > 0 for s in read)


def _jax_pools(jp, ops, sites):
    """JAX's layout of `ops` installed on `jp` (fresh pools); returns the
    layout, the pools as numpy, and the bucket schedule."""
    lay, buckets = jrepeats.schedule_buckets_flat(jp.repeats, ops, sites,
                                                  jp.scale_buffers)
    jp._install_flat(lay)
    sched = tuple((jnp.asarray(f), jnp.asarray(gl), jnp.asarray(gr))
                  for _, f, gl, gr, _, _ in buckets)
    profiles = tuple((il, ir) for *_, il, ir in buckets)
    return lay, np.asarray(jp.clv_flat), np.asarray(jp.sc_flat), sched, \
        profiles


def _port_pools(part, ops, clv0, sc0, pm, jlay):
    """The port's level plan over copies of the same pools, through the
    dispatching wrapper (the 'pool-pallas' path) and through the plain
    version the 'pool' path runs: returns ((clv, sc) after the wrapper,
    (clv, sc) after the plain version)."""
    k, thr, fac = part.scale_buffers, part.scale_threshold, part.scale_factor
    layout, levels = tpool.schedule_pool_levels(
        copy.deepcopy(part.repeats), ops, part.tips, part.sites, k)
    _layouts_equal(layout, jlay)
    plan = tpool.plan_to_device(*tpool.pack_pool_levels(layout, levels), CPU,
                                part.rate_cats, part.states)
    lv = (torch.tensor(clv0), torch.tensor(sc0))
    before = tpool.pool_update.launches
    tpool.update_partials_pool(*lv, pm, plan, thr, fac)
    assert tpool.pool_update.launches == before    # CPU: the plain version
    plain = (torch.tensor(clv0), torch.tensor(sc0))
    tpool.update_partials_pool(*plain, pm, plan, thr, fac,
                               level=tpool.pool_update_reference)
    assert len(plan.tables) == len(tlevels.schedule_levels(ops, part.tips))
    return lv, plain


# ------------------------------------------------------------ pool levels
@pytest.mark.parametrize("kind", ["dna", "rates3", "aa20", "caterpillar"])
def test_pool_paths_match_jax_f32(kind):
    """The port's pool levels through the wrapper ('pool-pallas' on the
    CPU) against JAX's Pallas pool kernel (interpret mode), and through the
    plain version ('pool') against JAX's XLA pool path, from the same
    pools."""
    tree, by, sites, states, rates = _problem(kind)
    jp = _jax(tree, by, sites, states, rates, f64=False)
    part = _port(tree, by, sites, states, rates, f64=False)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    jp.update_prob_matrices([0] * rates, pidx, br)
    jlay, clv0, sc0, sched, profiles = _jax_pools(jp, ops, sites)
    kw = dict(scale_threshold=jp.scale_threshold,
              scale_factor=jp.scale_factor)
    jk_clv, jk_sc = jpool.update_partials_repeats_pool_pallas(
        jp.clv_flat, jp.sc_flat, jp.pmatrix, sched, rates=rates,
        states=states, profiles=profiles, interpret=True, **kw)
    jx_clv, jx_sc = jpartials.update_partials_repeats_pool(
        jp.clv_flat, jp.sc_flat, jp.pmatrix, sched, profiles=profiles, **kw)
    pm = torch.tensor(np.asarray(jp.pmatrix))
    (lv_clv, lv_sc), (se_clv, se_sc) = _port_pools(part, ops, clv0, sc0, pm,
                                                   jlay)
    for (clv, sc), (jclv, jsc) in (((lv_clv, lv_sc), (jk_clv, jk_sc)),
                                   ((se_clv, se_sc), (jx_clv, jx_sc))):
        np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
        np.testing.assert_allclose(clv.numpy(), np.asarray(jclv), rtol=2e-6,
                                   atol=1e-30)
    if kind == "caterpillar":
        assert int(np.asarray(jk_sc).max()) > 0, "scaling never triggered"


@pytest.mark.parametrize("kind", ["dna", "aa20"])
def test_pool_paths_match_jax_xla_f64(kind):
    tree, by, sites, states, rates = _problem(kind)
    jp = _jax(tree, by, sites, states, rates)
    part = _port(tree, by, sites, states, rates)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    jp.update_prob_matrices([0] * rates, pidx, br)
    jlay, clv0, sc0, sched, profiles = _jax_pools(jp, ops, sites)
    jclv, jsc = jpartials.update_partials_repeats_pool(
        jp.clv_flat, jp.sc_flat, jp.pmatrix, sched, jp.scale_threshold,
        jp.scale_factor, profiles=profiles)
    pm = torch.tensor(np.asarray(jp.pmatrix))
    for clv, sc in _port_pools(part, ops, clv0, sc0, pm, jlay):
        np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
        np.testing.assert_allclose(clv.numpy(), np.asarray(jclv),
                                   rtol=1e-12, atol=1e-300)


def test_pool_packer_refuses_an_op_writing_its_own_child():
    tree, by, sites, states, rates = _problem("dna")
    part = _port(tree, by, sites, states, rates)
    t = tree.tip_count
    bad = tp.Operation(t, 0, t, 0, -1, 1, 1, -1)     # parent is child 1
    with pytest.raises(tp.PllError, match="own child"):
        part.update_partials([bad])


# ------------------------------------------------ the step-by-step API
def _traverse(parts, ops, br, pidx, rates, params=None):
    for p in parts:
        p.update_prob_matrices(params or [0] * rates, pidx, br)
        p.update_partials(ops)


@pytest.mark.parametrize("kind", ["dna", "aa20"])
def test_step_by_step_repeats_matches_dense_and_jax_f64(kind):
    tree, by, sites, states, rates = _problem(kind)
    jp = _jax(tree, by, sites, states, rates)
    rep = _port(tree, by, sites, states, rates)
    dense = _port(tree, by, sites, states, rates, repeats=False)
    assert rep.repeats is not None and rep.clv is None
    ops, br, pidx = create_operations(traverse(tree.vroot))
    _traverse((jp, rep, dense), ops, br, pidx, rates)
    edge = _edge(tree, rates)
    got = rep.compute_edge_loglikelihood(*edge, persite=True)
    want = dense.compute_edge_loglikelihood(*edge, persite=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12,
                               atol=1e-12 * np.abs(want[1]).max())
    np.testing.assert_allclose(got[0], jp.compute_edge_loglikelihood(*edge),
                               rtol=1e-12)
    np.testing.assert_allclose(rep.compute_node_ancestral(*edge),
                               dense.compute_node_ancestral(*edge),
                               rtol=1e-12, atol=1e-14)
    r = tree.vroot
    st_args = (r.clv_index, r.back.clv_index, r.scaler_index,
               r.back.scaler_index, [0] * rates)
    st, dst = rep.update_sumtable(*st_args), dense.update_sumtable(*st_args)
    for length in (0.01, 0.1, 1.0):
        np.testing.assert_allclose(
            rep.compute_likelihood_derivatives(st, [0] * rates, length),
            dense.compute_likelihood_derivatives(dst, [0] * rates, length),
            rtol=1e-12)
    for idx in (0, tree.tip_count, r.clv_index, tree.node_count - 1):
        np.testing.assert_allclose(rep.get_clv(idx), dense.get_clv(idx),
                                   rtol=1e-12, atol=1e-300)
        np.testing.assert_allclose(rep.get_clv(idx), jp.get_clv(idx),
                                   rtol=1e-12, atol=1e-300)
    for idx in range(rep.scale_buffers):
        np.testing.assert_array_equal(rep.get_scaler(idx), jp.get_scaler(idx))
    assert rep.clv_bytes() == jp.clv_bytes() < dense.clv_bytes()
    # update_repeats=False with the cached op list: the same schedule
    rep.update_partials(ops, update_repeats=False)
    np.testing.assert_allclose(rep.compute_edge_loglikelihood(*edge),
                               got[0], rtol=1e-12)


def _invalidated(ops, matrix_index):
    bad = set()
    for op in ops:
        if (matrix_index in (op.child1_matrix_index, op.child2_matrix_index)
                or op.child1_clv_index in bad
                or op.child2_clv_index in bad):
            bad.add(op.parent_clv_index)
    return bad


@pytest.mark.parametrize("kind", ["dna", "deep"])
def test_partial_traversal_on_repeats_equals_full(kind):
    """A partial traversal on a repeats partition finds the class columns and
    the scaler counts of the nodes it does not recompute (the port carries
    the pools over to the partial list's layout; JAX's step-by-step repeats
    path starts it from zeros and gives -inf here). On the 40-taxon tree in
    float32 the root edge's untouched side carries rescale counts."""
    tree, by, sites, states, rates = _problem(kind)
    f64 = kind == "dna"
    jp = _jax(tree, by, sites, states, rates, f64=f64)
    rep = _port(tree, by, sites, states, rates, f64=f64)
    dense = _port(tree, by, sites, states, rates, f64=f64, repeats=False)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    _traverse((jp, rep, dense), ops, br, pidx, rates)
    edge = _edge(tree, rates)
    # a tip branch whose change leaves one side of the root edge as it is
    for mat in (m for o in ops
                for c, m in ((o.child1_clv_index, o.child1_matrix_index),
                             (o.child2_clv_index, o.child2_matrix_index))
                if c < tree.tip_count):
        bad = _invalidated(ops, mat)
        kept = [edge[i + 1] for i in (0, 2) if edge[i] not in bad
                and edge[i] >= tree.tip_count]
        if kept:
            break
    partial, _, _ = create_operations(traverse(
        tree.vroot, cbtrav=lambda n: not n.is_tip() and n.clv_index in bad))
    assert 0 < len(partial) < len(ops)
    if not f64:
        assert kept and rep.get_scaler(kept[0]).max() > 0
    new_len = br[pidx.index(mat)] * 3.0
    for p in (jp, rep, dense):
        p.update_prob_matrices([0] * rates, [mat], [new_len])
        p.update_partials(partial)
    want = dense.compute_edge_loglikelihood(*edge)
    rtol = 1e-12 if f64 else 1e-6
    np.testing.assert_allclose(rep.compute_edge_loglikelihood(*edge), want,
                               rtol=rtol)
    assert jp.compute_edge_loglikelihood(*edge) == -np.inf
    rep.update_partials(ops)
    np.testing.assert_allclose(rep.compute_edge_loglikelihood(*edge), want,
                               rtol=rtol)


def test_caterpillar_scaling_matches_dense_f64():
    """tests/test_repeats_m4.py:119-142: the 150-taxon caterpillar x 300
    sites, where float64 scaling triggers."""
    tree = _caterpillar(150)
    headers, seqs = simulate_alignment(tree, 300, [0.3, 0.25, 0.2, 0.25],
                                       SUBST, alpha=0.8, seed=SEED)
    by = dict(zip(headers, seqs))
    rep = _port(tree, by, 300, 4, 4)
    dense = _port(tree, by, 300, 4, 4, repeats=False)
    jp = _jax(tree, by, 300, 4, 4)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    _traverse((rep, dense, jp), ops, br, pidx, 4)
    edge = _edge(tree, 4)
    assert int(rep.sc_flat.max()) > 0, "scaling never triggered"
    want = dense.compute_edge_loglikelihood(*edge)
    np.testing.assert_allclose(rep.compute_edge_loglikelihood(*edge), want,
                               rtol=1e-12)
    np.testing.assert_allclose(jp.compute_edge_loglikelihood(*edge), want,
                               rtol=1e-12)
    np.testing.assert_array_equal(rep.sc_flat.numpy(),
                                  np.asarray(jp.sc_flat))


@pytest.mark.parametrize("case", ["none", "every_third"])
def test_scalerless_ops_follow_dense_semantics(case):
    """Ops without a scaler buffer are not rescaled on the port's pooled
    paths, as on every dense path. The 120-taxon caterpillar x 300 sites in
    float32 with no scaler at all underflows to -inf on the dense paths of
    both packages and on the port's pooled ones, while JAX's pooled path
    rescales anyway and returns a finite logL without the dropped counts.
    With every third op scaler-less the logL is finite everywhere and the
    port's pooled paths equal the dense ones."""
    tree = _caterpillar(120 if case == "none" else 40)
    sites = 300 if case == "none" else 200
    headers, seqs = simulate_alignment(tree, sites, [0.3, 0.25, 0.2, 0.25],
                                       SUBST, alpha=0.8, seed=17)
    by = dict(zip(headers, seqs))
    ops, br, pidx = create_operations(traverse(tree.vroot))
    for op in (ops if case == "none" else ops[::3]):
        op.parent_scaler_index = -1
    r = tree.vroot
    root = dict(operations=ops, branches=br, pmatrix_indices=pidx, root=r)
    edge = _edge(tree, 4)
    jd, jr = (_jax(tree, by, sites, 4, 4, f64=False, repeats=rp)
              for rp in (False, True))
    td, tr = (_port(tree, by, sites, 4, 4, f64=False, repeats=rp)
              for rp in (False, True))
    _traverse((jd, jr, td, tr), ops, br, pidx, 4)
    j_dense, j_rep = (p.compute_edge_loglikelihood(*edge) for p in (jd, jr))
    t_dense, t_rep = (p.compute_edge_loglikelihood(*edge) for p in (td, tr))
    t_pool = tp.TreeEngine(_port(tree, by, sites, 4, 4, f64=False),
                           pallas=False, **root)
    assert t_pool.execution_path == "pool"
    t_plain = t_pool.loglikelihood()
    if case == "none":
        assert j_dense == t_dense == t_rep == t_plain == -np.inf
        assert np.isfinite(j_rep)
    else:
        for got in (t_rep, t_plain, t_dense):
            assert np.isfinite(got) and _rel(got, j_dense) < TOL_LOGL
        assert _rel(t_rep, t_dense) < 1e-6


# ------------------------------------------------------------- engines
PALLAS = ["auto", True, "interpret", "levels-kernel", "levels-interpret",
          "pool", "pool-interpret", False]


@pytest.mark.parametrize("repeats", [False, True])
@pytest.mark.parametrize("pallas", PALLAS, ids=str)
def test_execution_path_matches_jax(repeats, pallas):
    """float32 (JAX's kernel paths are float32), sites a multiple of 128
    (JAX's level kernel asks for it); the port treats 'auto' as on target,
    JAX only on a TPU, so the port's 'auto' is held to JAX's True."""
    tree, by, _, states, rates = _problem("dna")
    sites = 256
    by = {k: v[:sites] for k, v in by.items()}
    jp = _jax(tree, by, sites, states, rates, f64=False, repeats=repeats)
    part = _port(tree, by, sites, states, rates, f64=False, repeats=repeats)
    je = JTreeEngine(jp, tree, pallas=True if pallas == "auto" else pallas)
    te = tp.TreeEngine(part, tree, pallas=pallas)
    assert te.execution_path == je.execution_path


ENGINE_PATHS = {"repeats-dense-fused": ("interpret", "auto"),
                "pool-pallas": ("pool-interpret", "pool"),
                "pool": (False, False)}


@pytest.mark.parametrize("path", sorted(ENGINE_PATHS))
def test_repeats_engines_match_jax_f32(path):
    tree, by, sites, states, rates = _problem("dna")
    jp = _jax(tree, by, sites, states, rates, f64=False)
    part = _port(tree, by, sites, states, rates, f64=False)
    jpal, tpal = ENGINE_PATHS[path]
    je, te = JTreeEngine(jp, tree, pallas=jpal), tp.TreeEngine(part, tree,
                                                               pallas=tpal)
    assert te.execution_path == je.execution_path == path
    got, want = te.loglikelihood_persite(), je.loglikelihood_persite()
    assert _rel(got[0], want[0]) < TOL_LOGL
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4,
                               atol=1e-4 * np.abs(want[1]).max())
    for _ in range(2):
        (gl, g1, g2), (wl, w1, w2) = te.newton_step(), je.newton_step()
        assert _rel(gl, wl) < TOL_LOGL
        assert _d_err(g1, w1) < TOL_D1 and _d_err(g2, w2) < TOL_D1
    if path == "repeats-dense-fused":
        assert part.clv is None and part.clv_flat is None
    else:
        assert part.clv is None and part.clv_flat is not None


def _nni_edge(tree):
    return next(h for n in tree.nodes() if not n.is_tip() for h in n.ring()
                if h.back is not None and not h.back.is_tip())


@pytest.mark.parametrize("pallas", ["auto", "pool", False])
def test_set_topology_after_nni_f64(pallas):
    tree, by, sites, states, rates = _problem("dna")
    part = _port(tree, by, sites, states, rates)
    te = tp.TreeEngine(part, tree, pallas=pallas)
    jp = _jax(tree, by, sites, states, rates)
    je = JTreeEngine(jp, tree, pallas=False)
    base = te.loglikelihood()
    np.testing.assert_allclose(base, je.loglikelihood(), rtol=1e-12)
    rb = jmoves.Rollback()
    jmoves.nni(_nni_edge(tree), UTREE_MOVE_NNI_LEFT, rb)
    te.set_topology(tree)
    je.set_topology(tree)
    fresh = tp.TreeEngine(_port(tree, by, sites, states, rates), tree,
                          pallas=False).loglikelihood()
    moved = te.loglikelihood()
    assert abs(moved - base) > 1e-6
    np.testing.assert_allclose(moved, fresh, rtol=1e-12)
    np.testing.assert_allclose(moved, je.loglikelihood(), rtol=1e-12)
    jmoves.rollback_move(rb)
    te.set_topology(tree)
    np.testing.assert_allclose(te.loglikelihood(), base, rtol=1e-12)


def test_pooled_engine_follows_tip_and_layout_changes():
    """The pooled engine repacks when a tip changes or the step-by-step API
    installs another layout on its partition."""
    tree, by, sites, states, rates = _problem("dna")
    part = _port(tree, by, sites, states, rates)
    te = tp.TreeEngine(part, tree, pallas="pool")
    base = te.loglikelihood()
    ops, br, pidx = create_operations(traverse(tree.vroot))
    part.update_prob_matrices([0] * rates, pidx, br)
    part.update_partials(ops[len(ops) // 2:])       # another layout
    np.testing.assert_allclose(te.loglikelihood(), base, rtol=1e-12)
    tip = next(iter(tree.tips()))
    seq = "A" * sites
    part.set_tip_states(tip.clv_index, tmaps.map_nt, seq)
    by2 = dict(by, **{tip.label: seq})
    want = tp.TreeEngine(_port(tree, by2, sites, states, rates), tree,
                         pallas=False).loglikelihood()
    np.testing.assert_allclose(te.loglikelihood(), want, rtol=1e-12)


@pytest.mark.parametrize("pallas", ["auto", "pool"])
def test_site_rate_posteriors_repeats_match_jax(pallas):
    tree, by, sites, states, rates = _problem("dna")
    te = tp.TreeEngine(_port(tree, by, sites, states, rates), tree,
                       pallas=pallas)
    post, rate = te.site_rate_posteriors()
    jpost, jrate = JTreeEngine(_jax(tree, by, sites, states, rates), tree,
                               pallas=False).site_rate_posteriors()
    np.testing.assert_allclose(post, jpost, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(rate, jrate, rtol=1e-10, atol=1e-14)


# ------------------------------------------------------------ edge_params
def _heterotachy_stepwise(jp, tree, ops, br, pidx, ep):
    """tests/test_heterotachy.py:47-70: one update_prob_matrices call per
    branch class, then the root edge under its own class's model."""
    for model in (0, 1):
        sel = [i for i, m in enumerate(pidx) if ep[m] == model]
        jp.update_prob_matrices([model] * 4, [pidx[i] for i in sel],
                                [br[i] for i in sel])
    jp.update_partials(ops)
    r = tree.vroot
    rm = int(ep[r.pmatrix_index])
    return jp.compute_edge_loglikelihood(
        r.clv_index, r.scaler_index, r.back.clv_index, r.back.scaler_index,
        r.pmatrix_index, [rm] * 4)


EDGE_PATHS = {"fused": (False, "auto"), "levels-kernel": (False,
                                                          "levels-kernel"),
              "levels": (False, False), "scan": (False, "scan"),
              "repeats-dense-fused": (True, "auto"),
              "pool-pallas": (True, "pool"), "pool": (True, False)}


@pytest.mark.parametrize("path", sorted(EDGE_PATHS))
def test_edge_params_match_jax_f64(path):
    """tests/test_heterotachy.py:102-168 on every path: two rate matrices,
    edges alternating by pmatrix index."""
    tree, by, sites, states, rates = _problem("dna")
    ops, br, pidx = create_operations(traverse(tree.vroot))
    ep = np.arange(tree.edge_count) % 2
    want = _heterotachy_stepwise(_jax(tree, by, sites, 4, 4, repeats=False,
                                      rate_matrices=2), tree, ops, br, pidx,
                                 ep)
    repeats, pallas = EDGE_PATHS[path]
    kw = dict(pallas=pallas)
    if pallas == "scan":
        kw = dict(pallas=False, level_schedule=False)
    part = _port(tree, by, sites, 4, 4, repeats=repeats, rate_matrices=2)
    te = tp.TreeEngine(part, tree, edge_params=ep, **kw)
    assert te.execution_path == path
    np.testing.assert_allclose(te.loglikelihood(), want, rtol=1e-10)
    je = JTreeEngine(_jax(tree, by, sites, 4, 4, repeats=repeats,
                          rate_matrices=2), tree, edge_params=ep,
                     pallas=False)
    np.testing.assert_allclose(te.newton_step(), je.newton_step(),
                               rtol=1e-10)
    single = tp.TreeEngine(_port(tree, by, sites, 4, 4, repeats=repeats,
                                 rate_matrices=2), tree, **kw)
    assert abs(single.loglikelihood() - want) > 0.1


def test_edge_params_rejected_when_malformed():
    tree, by, sites, states, rates = _problem("dna")
    part = _port(tree, by, sites, 4, 4, rate_matrices=2)
    with pytest.raises(tp.PllError, match="edge_params"):
        tp.TreeEngine(part, tree, edge_params=np.zeros(3, int))
    with pytest.raises(tp.PllError, match="edge_params"):
        tp.TreeEngine(part, tree,
                      edge_params=np.full(tree.edge_count, 2))


# ---------------------------------------------------------------- convert
def test_convert_repeats_partition_gives_jax_logl():
    tree, by, sites, states, rates = _problem("dna")
    jp = _jax(tree, by, sites, states, rates)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    _traverse((jp,), ops, br, pidx, rates)
    state = {k: getattr(jp, k) for k in convert.STATE_KEYS
             + convert.REPEATS_KEYS}
    part = convert.partition_from_numpy(state, device=CPU,
                                        dtype=torch.float64)
    assert part.repeats is not None and part._flat is not None
    edge = _edge(tree, rates)
    np.testing.assert_allclose(part.compute_edge_loglikelihood(*edge),
                               jp.compute_edge_loglikelihood(*edge),
                               rtol=1e-12)
    for name in ("site_id", "id_site", "ids"):
        np.testing.assert_array_equal(getattr(part.repeats, name),
                                      getattr(jp.repeats, name))
    # and it runs its own traversal from there to the same logL
    part.update_partials(ops)
    np.testing.assert_allclose(part.compute_edge_loglikelihood(*edge),
                               jp.compute_edge_loglikelihood(*edge),
                               rtol=1e-12)
    # before any traversal: classes and tip columns only
    fresh = _jax(tree, by, sites, states, rates)
    state = {k: getattr(fresh, k) for k in convert.STATE_KEYS
             + convert.REPEATS_KEYS}
    p2 = convert.partition_from_numpy(state, device=CPU, dtype=torch.float64)
    _traverse((p2,), ops, br, pidx, rates)
    np.testing.assert_allclose(p2.compute_edge_loglikelihood(*edge),
                               jp.compute_edge_loglikelihood(*edge),
                               rtol=1e-12)
