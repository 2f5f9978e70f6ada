"""The step-by-step Partition API, partial traversals and the per-level
kernel's plain version in the PyTorch port, against libpll2_tpu on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port. Tolerances:
  * host code (compile_levels, the level tables): `==`;
  * one level, float32, the port's plain level function against the JAX
    Pallas level kernel in interpret mode: scaler rows equal, CLV rows to
    1e-5 of each site's largest entry (einsum vs unrolled FMA order);
  * float64 (the port's plain versions against JAX's XLA paths): 1e-12 in
    CLVs and logL, 1e-10 in d1/d2 (summation order only);
  * float32 engines against JAX's: TOL_LOGL 5e-5, TOL_D1 5e-3 with an
    ATOL_D1 5e-2 floor (bench_validate.py:61-63), scaler buffers equal.
The tests pass device="cpu" explicitly: the port's entry points default to
the CUDA device."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu import compute_gamma_cats as j_gamma_cats
from libpll2_tpu import models as jmodels
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.ops import pallas_partials as jpallas
from libpll2_tpu.ops import partials as jpartials
from libpll2_tpu.partition import pack_level_operations as j_pack_levels
from libpll2_tpu.trees import parse_newick, random_alignment, random_utree
from libpll2_tpu.trees import utree as jutree

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import convert
from libpll2_tpu_torch import models as tmodels
from libpll2_tpu_torch.io import maps as tmaps
from libpll2_tpu_torch.ops import levels as tlevels
from libpll2_tpu_torch.ops import partials as tpartials
from libpll2_tpu_torch.partition import pack_level_operations
from libpll2_tpu_torch.trees import (compile_levels, create_operations,
                                     export_newick, parse_newick_rooted,
                                     traverse)
from libpll2_tpu_torch.trees import rtree as trtree
from torch_level_ops import self_child_op

SEED = 7
TOL_LOGL, TOL_D1, ATOL_D1 = 5e-5, 5e-3, 5e-2      # bench_validate.py:61-63
TOL_CLV = 1e-5
CPU = "cpu"
LETTERS32 = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdef"


def _caterpillar(n):
    """tests/test_pallas.py:52-58: deep enough that float32 CLVs underflow
    the 2^-32 window."""
    text = f"t{n - 1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    return parse_newick(f"(t0:0.1,t1:0.1,{text});")


def _charmaps(states):
    if states == 4:
        return jmaps.map_nt, tmaps.map_nt, "ACGT-NRY"
    if states == 20:
        return jmaps.map_aa, tmaps.map_aa, "ARNDCQEGHILKMFPSTWYVBZX-"
    cm = np.zeros(256, np.uint64)
    for i, ch in enumerate(LETTERS32[:states]):
        cm[ord(ch)] = 1 << i
    cm[ord("-")] = (1 << states) - 1
    return cm, cm, LETTERS32[:states] + "-"


def _partitions(tree, sites, states=4, rates=4, f64=True, pinv=0.0,
                rate_matrices=1, seed=SEED):
    """The same alignment and model in a JAX and a port partition."""
    jcm, tcm, alphabet = _charmaps(states)
    headers, seqs = random_alignment(tree.tip_count, sites,
                                     alphabet=alphabet, seed=seed)
    # the first 40 columns constant, so that +I has invariant sites
    seqs = [seqs[0][:40] + s[40:] for s in seqs]
    by = dict(zip(headers, seqs))
    args = (tree.tip_count, tree.inner_count, states, sites, rate_matrices,
            tree.edge_count, rates, tree.inner_count)
    jp = JPartition(*args, dtype=jnp.float64 if f64 else jnp.float32)
    part = tp.Partition(*args, device=CPU,
                        dtype=torch.float64 if f64 else torch.float32)
    for tip in tree.tips():
        jp.set_tip_states(tip.clv_index, jcm, by[tip.label])
        part.set_tip_states(tip.clv_index, tcm, by[tip.label])
    rng = np.random.default_rng(seed)
    if rate_matrices == 4:
        jmodels.load_mixture_model(jp, "lg4x")
        tmodels.load_mixture_model(part, "lg4x")
    elif states == 20:
        jmodels.load_aa_model(jp, "lg")
        tmodels.load_aa_model(part, "lg")
    else:
        freqs = rng.dirichlet(np.ones(states) * 10)
        subst = rng.uniform(0.5, 2.0, size=states * (states - 1) // 2)
        for p in (jp, part):
            p.set_frequencies(0, freqs)
            p.set_subst_params(0, subst)
    weights = rng.integers(1, 4, size=sites)
    for p in (jp, part):
        p.set_category_rates(j_gamma_cats(0.8, rates))
        p.set_pattern_weights(weights)
        if pinv:
            p.update_invariant_sites_proportion(0, pinv)
    return jp, part


def _tree(kind):
    if kind == "caterpillar":
        return _caterpillar(40)
    n = 10 if kind == "aa20" else 12
    return random_utree([f"t{i}" for i in range(n)], seed=SEED)


# kind -> (sites, states, rates)
LEVEL_CASES = {"dna": (256, 4, 4), "aa20": (128, 20, 4),
               "rates3": (256, 4, 3), "caterpillar": (128, 4, 4)}


def _k(p):
    return p.scale_buffers


def _site_rel(got, want):
    """Largest |got - want| relative to each (op, site)'s largest |want|
    over its rates and states ([W, RS, S] arrays)."""
    site_max = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-30)
    return float((np.abs(got - want) / site_max).max())


# ---------------------------------------------------------------- host code
@pytest.mark.parametrize("kind", ["random", "caterpillar", "partial"])
def test_compile_levels_and_tables_identical(kind):
    tree = _tree("caterpillar" if kind == "caterpillar" else "dna")
    ops, _, _ = create_operations(traverse(tree.vroot))
    if kind == "partial":
        ops = ops[len(ops) // 2:]
    key = [[(o.parent_clv_index, o.child1_clv_index, o.child2_clv_index)
            for o in lv] for lv in compile_levels(ops, tree.tip_count)]
    jkey = [[(o.parent_clv_index, o.child1_clv_index, o.child2_clv_index)
             for o in lv] for lv in jutree.compile_levels(ops,
                                                          tree.tip_count)]
    assert key == jkey
    k = tree.inner_count
    got = tlevels.pack_pallas_levels(ops, tree.tip_count, k + 1, k)
    want = jpallas.pack_pallas_levels(ops, tree.tip_count,
                                      tree.node_count, k + 1, k)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # JAX pads each level to a power of two; the port's are exact
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w)[:, :g.shape[1]])
    tops, tvalid = pack_level_operations(ops, tree.tip_count,
                                         tree.node_count, device=CPU)
    jops, jvalid = j_pack_levels(ops, tree.tip_count, tree.node_count)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    for g, w in zip(tops, jops):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------ one level
@pytest.mark.parametrize("kind", sorted(LEVEL_CASES))
def test_level_function_matches_pallas_interpret_f32(kind):
    """Each level of a traversal through the port's plain level function
    and JAX's Pallas level kernel (interpret mode) from the same state."""
    sites, states, rates = LEVEL_CASES[kind]
    tree = _tree(kind)
    jp, part = _partitions(tree, sites, states, rates, f64=False)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    jp.update_prob_matrices([0] * rates, pidx, br)
    k, n, rs = _k(jp), jp.nodes + 1, rates * states
    thr, fac = jp.scale_threshold, jp.scale_factor
    jtabs = jpallas.pack_pallas_levels(ops, jp.tips, jp.nodes, k + 1, k)
    ttabs = tlevels.pack_pallas_levels(ops, jp.tips, k + 1, k)
    clv2d, scaler = jp.clv.reshape(n, rs, sites), jp.scale_buffer
    pm = torch.tensor(np.asarray(jp.pmatrix))
    scaled = 0
    for jt, tt in zip(jtabs, ttabs):
        w = tt.shape[1]
        t_clv = torch.tensor(np.asarray(clv2d))
        t_sc = torch.tensor(np.asarray(scaler))
        tlevels.level_update_reference(t_clv, t_sc, pm, tt, rates, states,
                                       thr, fac)
        rows, srows = jpallas.level_update_pallas(
            clv2d, scaler, jp.pmatrix, jt, rates, states, thr, fac,
            interpret=True)
        has = tt[8] > 0
        np.testing.assert_array_equal(
            t_sc[tt[7][has].astype(np.int64)].numpy(),
            np.asarray(srows)[:w][has])
        assert _site_rel(t_clv[tt[0].astype(np.int64)].numpy(),
                         np.asarray(rows)[:w]) <= TOL_CLV
        scaled += int(np.asarray(srows)[:w][has].sum())
        clv2d = clv2d.at[jt[0]].set(rows)
        scaler = scaler.at[jt[7]].set(srows)
    if kind == "caterpillar":
        assert scaled > 0, "scaling never triggered"


@pytest.mark.parametrize("kind", ["dna", "aa20"])
def test_self_child_level_matches_pallas_interpret_f32(kind):
    """A level of one op that writes its own child1 in place (CLV and
    scaler row), after a full traversal: the port's plain level function
    against JAX's Pallas level kernel (interpret mode). It pins what the
    CUDA kernel must keep: the parent is computed from the child rows as
    they were before the level."""
    sites, states, rates = LEVEL_CASES[kind]
    tree = _tree(kind)
    jp, _ = _partitions(tree, sites, states, rates, f64=False)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    jp.update_prob_matrices([0] * rates, pidx, br)
    jp.update_partials(ops)
    op = self_child_op(ops, jp.tips)
    k, n, rs = _k(jp), jp.nodes + 1, rates * states
    thr, fac = jp.scale_threshold, jp.scale_factor
    (tt,) = tlevels.pack_pallas_levels([op], jp.tips, k + 1, k)
    (jt,) = jpallas.pack_pallas_levels([op], jp.tips, jp.nodes, k + 1, k)
    clv2d = jp.clv.reshape(n, rs, sites)
    t_clv = torch.tensor(np.asarray(clv2d))
    t_sc = torch.tensor(np.asarray(jp.scale_buffer))
    child = t_clv[op.child1_clv_index].clone()
    tlevels.level_update_reference(t_clv, t_sc,
                                   torch.tensor(np.asarray(jp.pmatrix)), tt,
                                   rates, states, thr, fac)
    rows, srows = jpallas.level_update_pallas(
        clv2d, jp.scale_buffer, jp.pmatrix, jt, rates, states, thr, fac,
        interpret=True)
    np.testing.assert_array_equal(t_sc[op.parent_scaler_index].numpy(),
                                  np.asarray(srows)[0])
    got = t_clv[op.parent_clv_index]
    assert not torch.equal(got, child)
    assert _site_rel(got[None].numpy(), np.asarray(rows)[:1]) <= TOL_CLV


@pytest.mark.parametrize("kind", ["dna", "aa20", "caterpillar"])
def test_level_traversal_matches_xla_levels_f64(kind):
    sites, states, rates = LEVEL_CASES[kind]
    tree = _tree(kind)
    jp, _ = _partitions(tree, sites, states, rates)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    jp.update_prob_matrices([0] * rates, pidx, br)
    k = _k(jp)
    t_clv = torch.tensor(np.asarray(jp.clv))
    t_sc = torch.tensor(np.asarray(jp.scale_buffer))
    tables = tlevels.pack_pallas_levels(ops, jp.tips, k + 1, k)
    tlevels.update_partials_kernel(t_clv, t_sc,
                                   torch.tensor(np.asarray(jp.pmatrix)),
                                   tables, jp.scale_threshold,
                                   jp.scale_factor)
    jops, valid = j_pack_levels(ops, jp.tips, scratch_clv=jp.nodes)
    clv, sc = jpartials.update_partials_levels(
        jp.clv, jp.scale_buffer, jp.pmatrix, jops, valid,
        jp.scale_threshold, jp.scale_factor)
    want = np.asarray(clv)[:jp.nodes]
    np.testing.assert_allclose(t_clv[:jp.nodes].numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(t_sc[:k].numpy(), np.asarray(sc)[:k])
    assert not t_sc[k + 1].any()


# ------------------------------------------------- the step-by-step API
def _full_traversal(tree, parts, rates, params=None):
    ops, br, pidx = create_operations(traverse(tree.vroot))
    for p in parts:
        p.update_prob_matrices(params or [0] * rates, pidx, br)
        p.update_partials(ops)
    return ops, br, pidx


@pytest.mark.parametrize("states", [4, 20])
def test_step_by_step_api_matches_jax_f64(states):
    tree = _tree("aa20" if states == 20 else "dna")
    sites = 128
    jp, part = _partitions(tree, sites, states, pinv=0.2)
    _full_traversal(tree, (jp, part), 4)
    r = tree.vroot
    pidx = [0] * 4
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index, pidx)
    got = part.compute_edge_loglikelihood(*edge, persite=True)
    want = jp.compute_edge_loglikelihood(*edge, persite=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12,
                               atol=1e-12 * np.abs(want[1]).max())
    np.testing.assert_allclose(part.compute_node_ancestral(*edge),
                               jp.compute_node_ancestral(*edge), rtol=1e-12,
                               atol=1e-14)
    st_args = (r.clv_index, r.back.clv_index, r.scaler_index,
               r.back.scaler_index, pidx)
    st, jst = part.update_sumtable(*st_args), jp.update_sumtable(*st_args)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jst)).max())
    for length in (0.01, 0.1, 0.7):
        np.testing.assert_allclose(
            part.compute_likelihood_derivatives(st, pidx, length),
            jp.compute_likelihood_derivatives(jst, pidx, length),
            rtol=1e-10)
    for idx in (r.clv_index, r.back.clv_index, 0):
        np.testing.assert_allclose(part.get_clv(idx), jp.get_clv(idx),
                                   rtol=1e-12, atol=1e-300)
    for idx in range(_k(jp)):
        np.testing.assert_array_equal(part.get_scaler(idx),
                                      jp.get_scaler(idx))
    np.testing.assert_allclose(part.get_pmatrix(r.pmatrix_index),
                               jp.get_pmatrix(r.pmatrix_index), rtol=1e-13,
                               atol=1e-15)
    assert part.clv_bytes() == jp.clv_bytes()


def test_root_loglikelihood_rooted_tree_matches_jax_f64():
    utree = random_utree([f"t{i}" for i in range(11)], seed=SEED)
    tree = parse_newick_rooted(export_newick(utree.vroot, rooted=True,
                                             root_brlen=0.3))
    jp, part = _partitions(tree, 128, pinv=0.1)
    ops, br, pidx = trtree.create_operations(trtree.traverse(tree.root))
    for p in (jp, part):
        p.update_prob_matrices([0] * 4, pidx, br)
        p.update_partials(ops)
    root = tree.root
    got = part.compute_root_loglikelihood(root.clv_index, root.scaler_index,
                                          [0] * 4, persite=True)
    want = jp.compute_root_loglikelihood(root.clv_index, root.scaler_index,
                                         [0] * 4, persite=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12,
                               atol=1e-12 * np.abs(want[1]).max())


def test_lg4x_through_update_prob_matrices_matches_jax():
    tree = _tree("aa20")
    jp, part = _partitions(tree, 128, states=20, rate_matrices=4)
    params = [0, 1, 2, 3]
    _full_traversal(tree, (jp, part), 4, params=params)
    r = tree.vroot
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index)
    got = part.compute_edge_loglikelihood(*edge, params)
    np.testing.assert_allclose(got, jp.compute_edge_loglikelihood(
        *edge, params), rtol=1e-12)
    # a mixture differs from its first matrix alone
    assert abs(got - part.compute_edge_loglikelihood(*edge, [0] * 4)) > 1.0


# ------------------------------------------------------------- engines
@pytest.mark.parametrize("f64", [False, True])
@pytest.mark.parametrize("path", ["levels-kernel", "levels", "scan"])
def test_engine_paths_match_jax(path, f64):
    tree = _tree("dna")
    jp, part = _partitions(tree, 256, f64=f64, pinv=0.1)
    jkw, tkw = {"levels-kernel": (dict(pallas="levels-interpret"),
                                  dict(pallas="levels-kernel")),
                "levels": (dict(pallas=False), dict(pallas=False)),
                "scan": (dict(pallas=False, level_schedule=False),
                         dict(pallas=False, level_schedule=False))}[path]
    je, te = JTreeEngine(jp, tree, **jkw), tp.TreeEngine(part, tree, **tkw)
    assert te.execution_path == path
    if not f64:
        assert je.execution_path == path
    got, want = te.loglikelihood(), je.loglikelihood()
    k = _k(jp)
    steps = [(te.newton_step(), je.newton_step()) for _ in range(3)]
    if f64:
        np.testing.assert_allclose(got, want, rtol=1e-12)
        for g, w in steps:
            np.testing.assert_allclose(g, w, rtol=1e-10)
    else:
        assert abs(got - want) / abs(want) < TOL_LOGL
        for (gl, g1, g2), (wl, w1, w2) in steps:
            assert abs(gl - wl) / abs(wl) < TOL_LOGL
            for g, w in ((g1, w1), (g2, w2)):
                assert abs(g - w) / max(abs(w), ATOL_D1 / TOL_D1) < TOL_D1
    np.testing.assert_array_equal(part.scale_buffer[:k].numpy(),
                                  np.asarray(jp.scale_buffer)[:k])


@pytest.mark.parametrize("pallas", ["auto", "levels-kernel"])
def test_site_rate_posteriors_match_jax(pallas):
    tree = _tree("dna")
    jp, part = _partitions(tree, 128, pinv=0.2)
    te = tp.TreeEngine(part, tree, pallas=pallas)
    assert te.execution_path == ("fused" if pallas == "auto"
                                 else "levels-kernel")
    post, rate = te.site_rate_posteriors()
    jpost, jrate = JTreeEngine(jp, tree, pallas=False).site_rate_posteriors()
    np.testing.assert_allclose(post, jpost, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(rate, jrate, rtol=1e-10, atol=1e-14)
    assert post[-1].max() > 0.5            # invariant columns
    # the fused path, too, refreshed the root rows of the dense buffer
    r = tree.vroot
    np.testing.assert_allclose(part.get_clv(r.clv_index),
                               jp.get_clv(r.clv_index), rtol=1e-12,
                               atol=1e-300)


def test_apply_branches_to_tree_after_newton():
    tree = _tree("dna")
    _, part = _partitions(tree, 128)
    te = tp.TreeEngine(part, tree, pallas="levels-kernel")
    te.newton_step()
    root_len = float(te.branches[tree.vroot.pmatrix_index])
    assert root_len != tree.vroot.length
    te.apply_branches_to_tree(tree)
    blen = te.branches.numpy()
    assert tree.vroot.length == tree.vroot.back.length == root_len
    for node in tree.nodes():
        for h in ([node] if node.is_tip() else node.ring()):
            assert h.length == h.back.length == blen[h.pmatrix_index]


# ---------------------------------------------------- partial traversals
def _invalidated(ops, matrix_index):
    """Parents whose CLV depends on the edge `matrix_index`, in list
    order."""
    bad = set()
    for op in ops:
        if (matrix_index in (op.child1_matrix_index, op.child2_matrix_index)
                or op.child1_clv_index in bad
                or op.child2_clv_index in bad):
            bad.add(op.parent_clv_index)
    return bad


def test_partial_traversal_equals_full_and_jax():
    tree = _tree("dna")
    jp, part = _partitions(tree, 128)
    ops, br, pidx = _full_traversal(tree, (jp, part), 4)
    # carried across before the change: the port starts from JAX's buffers
    state = {k: getattr(jp, k) for k in convert.STATE_KEYS}
    from_jax = convert.partition_from_numpy(state, device=CPU,
                                            dtype=torch.float64)
    deep = [o for o in ops if o.child1_clv_index < tree.tip_count][0]
    mat = deep.child1_matrix_index
    bad = _invalidated(ops, mat)
    partial, _, _ = create_operations(traverse(
        tree.vroot, cbtrav=lambda n: not n.is_tip() and n.clv_index in bad))
    assert [o.parent_clv_index for o in partial] == \
        [o.parent_clv_index for o in ops if o.parent_clv_index in bad]
    assert 0 < len(partial) < len(ops)
    new_len = br[pidx.index(mat)] * 3.0
    for p in (jp, part, from_jax):
        p.update_prob_matrices([0] * 4, [mat], [new_len])
        p.update_partials(partial)
    br2 = list(br)
    br2[pidx.index(mat)] = new_len
    _, fresh = _partitions(tree, 128)
    for p in (fresh,):
        p.update_prob_matrices([0] * 4, pidx, br2)
        p.update_partials(ops)
    r = tree.vroot
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index, [0] * 4)
    want = fresh.compute_edge_loglikelihood(*edge)
    for p in (part, from_jax):
        np.testing.assert_allclose(p.compute_edge_loglikelihood(*edge),
                                   want, rtol=1e-12)
        np.testing.assert_allclose(p.clv[:p.nodes].numpy(),
                                   fresh.clv[:p.nodes].numpy(), rtol=1e-12,
                                   atol=1e-300)
    np.testing.assert_allclose(jp.compute_edge_loglikelihood(*edge), want,
                               rtol=1e-12)
    # an engine over the partial list, after a dense traversal, with the
    # full branch vector
    te = tp.TreeEngine(part, operations=partial, branches=br2,
                       pmatrix_indices=pidx, root=r)
    assert te.execution_path == "levels-kernel"
    np.testing.assert_allclose(te.loglikelihood(), want, rtol=1e-12)


def _hazard_ops(kind):
    op = tp.Operation
    if kind == "write_after_read":
        # both at level 0: the first reads row 6 (and scaler 0), which the
        # second rewrites
        return [op(7, 1, 6, 6, 0, 2, 2, -1), op(6, 0, 0, 0, -1, 1, 1, -1)]
    # both at level 0, the same parent: the second must win
    return [op(6, 0, 0, 0, -1, 1, 1, -1), op(6, 0, 2, 2, -1, 3, 3, -1)]


@pytest.mark.parametrize("kind", ["write_after_read", "same_parent"])
def test_hazardous_op_lists_run_serially(kind):
    tree = random_utree([f"t{i}" for i in range(6)], seed=SEED)
    jp, part = _partitions(tree, 64)
    _full_traversal(tree, (jp, part), 4)
    ops = _hazard_ops(kind)
    assert len(compile_levels(ops, tree.tip_count)) == 1
    assert tlevels.schedule_levels(ops, tree.tip_count) == [[o] for o in ops]
    clv, sc = part.clv.clone(), part.scale_buffer.clone()
    tpartials.update_partials(clv, sc, part.pmatrix,
                              tp.partition.pack_operations(ops,
                                                           device=CPU),
                              part.scale_threshold, part.scale_factor)
    part.update_partials(ops)
    jp.update_partials(ops)
    k = _k(jp)
    for got in (part.clv.numpy(), np.asarray(jp.clv)):
        np.testing.assert_allclose(got[:jp.nodes], clv[:jp.nodes].numpy(),
                                   rtol=1e-13, atol=1e-300)
    np.testing.assert_array_equal(part.scale_buffer[:k].numpy(),
                                  sc[:k].numpy())


# ------------------------------------------------------- entry points
def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    sizes = (4, 2, 4, 10, 1, 5, 4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.Partition(*sizes)
    state = {k: getattr(tp.Partition(*sizes, device=CPU), k)
             for k in convert.SIZE_KEYS + convert.MIRROR_KEYS}
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.partition_from_numpy(state)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.engine_branches_from_numpy(np.ones(5))
    assert convert.partition_from_numpy(state, device=CPU).device.type \
        == "cpu"


def test_engine_rejects_unknown_pallas_mode():
    tree = _tree("dna")
    _, part = _partitions(tree, 32)
    with pytest.raises(tp.PllError, match="pallas"):
        tp.TreeEngine(part, tree, pallas="bogus")
    bad = create_operations(traverse(tree.vroot))[0]
    bad[0].child1_matrix_index = tree.edge_count
    with pytest.raises(tp.PllError, match="matrix index"):
        part.update_partials(bad)
