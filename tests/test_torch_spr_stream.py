"""The port's streamed scorer (`libpll2_tpu_torch.ops.spr_stream`), its
native builders (`libpll2_tpu_torch.native`), `trees/utils.py` and
`Partition.dense_tip_rows` against libpll2_tpu on the CPU.

Both packages build the same random tree from one seed; the port's
partitions are JAX's carried over with libpll2_tpu_torch.convert.
Tolerances:
  * host code (wave packing, the three builders, the native library, the
    tree utilities, the dense tip rows): `==`;
  * float64 streamed scores, port against JAX (JAX's XLA passes and
    scoring program, computed once per problem): 1e-12 relative a
    candidate (summation order only); JAX holds its own against full
    evaluations at 1e-9;
  * float32 under scaling stress against the float64 scores: 5e-4, JAX's
    budget (tests/test_spr_stream.py);
  * the passes' level tables against JAX's update_partials_levels over the
    padded tables: 1e-12.
Every construction passes device="cpu"; the level kernel's wrapper runs
its plain version for CPU tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu import compute_gamma_cats as j_gamma_cats
from libpll2_tpu import constants as JC
from libpll2_tpu import native as jnative
from libpll2_tpu import search as jsearch
from libpll2_tpu import trees as jtrees
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.ops import pallas_fused as jfused
from libpll2_tpu.ops import partials as jpartials
from libpll2_tpu.ops import spr_stream as jss

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import constants as C
from libpll2_tpu_torch import convert, native
from libpll2_tpu_torch import search as tsearch
from libpll2_tpu_torch import trees as ttrees
from libpll2_tpu_torch.io import maps as tmaps
from libpll2_tpu_torch.ops import levels
from libpll2_tpu_torch.ops import spr_stream as tss

CPU = "cpu"
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small problems: the test workers share
    the cores, and torch's default thread pool a worker then spends most of
    its time waiting (measured 20x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- problems
def _problem(n_taxa, n_sites, seed=3, states=4, alpha=0.8, pinv=0.0,
             scale_stress=False, rate_scalers=False, site_repeats=False,
             conserved=False, asc=None):
    """tests/test_spr_stream.py's problems: a float64 JAX partition and
    the same tree in both packages."""
    alphabet = "ACGT" if states == 4 else "ARNDCQEGHILKMFPSTWYV"
    headers, seqs = jtrees.random_alignment(n_taxa, n_sites,
                                            alphabet=alphabet, seed=seed)
    if conserved:
        src = np.random.default_rng(seed + 100).integers(
            0, max(n_sites // 4, 1), size=n_sites)
        seqs = ["".join(s[j] for j in src) for s in seqs]
    if pinv:
        seqs = [s[:-8] + alphabet[0] * 4 + alphabet[1] * 4 for s in seqs]
    jtree = jtrees.random_utree(headers, seed=seed)
    ttree = ttrees.random_utree(headers, seed=seed)
    if scale_stress:
        # long branches drive per-site underflow scalings
        for tree in (jtree, ttree):
            for node in tree.nodes():
                for h in ([node] if node.is_tip() else list(node.ring())):
                    if h.back is not None:
                        h.length = h.back.length = (h.length or 0.1) * 40.0
    kw = {}
    if asc is not None:
        kw["asc_bias"] = getattr(JC.AscBias, asc.upper())
    jp = JPartition(jtree.tip_count, jtree.inner_count, states, n_sites, 1,
                    jtree.edge_count, 4, jtree.inner_count,
                    rate_scalers=rate_scalers, site_repeats=site_repeats,
                    **kw)
    by = dict(zip(headers, seqs))
    cm = jmaps.map_nt if states == 4 else jmaps.map_aa
    for tip in jtree.tips():
        jp.set_tip_states(tip.clv_index, cm, by[tip.label])
    rng = np.random.default_rng(seed)
    jp.set_frequencies(0, rng.dirichlet(np.ones(states) * 10))
    jp.set_subst_params(0, rng.uniform(0.5, 2.0,
                                       size=states * (states - 1) // 2))
    jp.set_category_rates(j_gamma_cats(alpha, 4))
    if pinv:
        jp.update_invariant_sites_proportion(0, pinv)
    if asc is not None:
        jp.set_asc_state_weights([2, 3, 1, 2])
    return jp, jtree, ttree


def _port(jp, dtype=F64):
    state = {k: getattr(jp, k) for k in convert.STATE_KEYS}
    state["_invariant_valid"] = jp._invariant_valid
    if jp.repeats is not None:
        state.update({k: getattr(jp, k, None) for k in convert.REPEATS_KEYS})
    return convert.partition_from_numpy(state, device=CPU, dtype=dtype)


def _key(h):
    """A half-edge the same in both packages' trees: its ring (CLV index)
    and its edge (P-matrix index)."""
    return h.clv_index, h.pmatrix_index


def _pair_keys(pairs):
    return [tuple(_key(x) if hasattr(x, "clv_index") else x for x in pr)
            for pr in pairs]


FIELDS = ("post_table", "post_valid", "up_table", "up_valid", "a_table",
          "a_valid", "cand_rows", "half_len", "blen_full", "merged_len")


def _assert_sched_equal(got, want, what=""):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{f} {what}")
    assert (got.n_candidates, got.n_aux, got.n_arows) == \
        (want.n_candidates, want.n_aux, want.n_arows)
    assert _pair_keys(list(got.pairs)) == _pair_keys(list(want.pairs))


def _sig(part):
    return (part.clv.shape[0] if part.clv is not None else part.nodes + 1,
            part.scale_buffers, part.prob_matrices)


def _groups(mod_search, mod_ss, tree, radius, maxc=None, seed=5):
    """(prune, targets, kept) groups with the batched rounds' rng use."""
    rng = np.random.default_rng(seed)
    out = []
    for pr in mod_search._internal_edges(tree):
        ts = mod_ss.enumerate_targets(pr, radius)
        kept = None
        if maxc and len(ts) > maxc:
            kept = list(rng.permutation(len(ts))[:maxc])
        out.append((pr, ts, kept))
    return out


# -------------------------------------------------------------- host tables
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_waves_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 700
    rows = rng.integers(0, 50, size=(n, 8)).tolist()
    deps = [[int(rng.integers(-1, i)) if i else -1
             for _ in range(int(rng.integers(1, 3)))] for i in range(n)]
    for width, mw in ((256, 0), (7, 0), (64, 40)):
        got = tss.pack_waves(rows, deps, 99, width, min_waves=mw)
        want = jss.pack_waves(rows, deps, 99, width, min_waves=mw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_taxa,seed,radius,maxc", [
    (16, 3, 4, None), (16, 7, 3, 2), (40, 5, 5, 3), (7, 2, 2, None)])
def test_spr_builders_equal_jax(n_taxa, seed, radius, maxc):
    """JAX's pinned cases (tests/test_spr_stream.py): the port's Python
    builder and its native one equal JAX's Python and native builders,
    tables, waves, candidate rows and order, rng use."""
    jp, jtree, ttree = _problem(n_taxa, 16, seed=seed)
    args = _sig(jp)
    want = jss.build_spr_stream(
        jtree, _groups(jsearch, jss, jtree, radius, maxc), *args)
    got = tss.build_spr_stream(
        ttree, _groups(tsearch, tss, ttree, radius, maxc), *args)
    _assert_sched_equal(got, want, "python")
    got_n = tss.build_spr_stream_native(
        ttree, radius, *args, max_candidates=maxc,
        rng=np.random.default_rng(5))
    assert got_n is not None
    _assert_sched_equal(got_n, want, "native vs JAX python")
    if jnative.load() is not None:
        want_n = jss.build_spr_stream_native(
            jtree, radius, *args, max_candidates=maxc,
            rng=np.random.default_rng(5))
        _assert_sched_equal(got_n, want_n, "native vs JAX native")


@pytest.mark.parametrize("n_taxa,seed", [(16, 3), (9, 11)])
def test_nni_builder_and_targets_equal_jax(n_taxa, seed):
    jp, jtree, ttree = _problem(n_taxa, 16, seed=seed)
    args = _sig(jp)
    for jpr, tpr in zip(jsearch._internal_edges(jtree),
                        tsearch._internal_edges(ttree)):
        assert _key(jpr) == _key(tpr)
        for radius in (2, 4):
            want = [(_key(t), _key(s)) for t, _, s in
                    jss.enumerate_targets(jpr, radius)]
            got = [(_key(t), _key(s)) for t, _, s in
                   tss.enumerate_targets(tpr, radius)]
            assert got == want
            assert [_key(t) for t in tsearch._radius_targets(tpr, radius)] \
                == [_key(t) for t in jsearch._radius_targets(jpr, radius)]
    want = jss.build_nni_stream(jtree, jsearch._internal_edges(jtree),
                                *args)
    got = tss.build_nni_stream(ttree, tsearch._internal_edges(ttree), *args)
    _assert_sched_equal(got, want)


def _move_list(mod_search, tree):
    """SPR pairs within radius 3 and both NNIs of every internal edge, in
    the search's (kind, a, b) form."""
    out = []
    for p in mod_search._internal_edges(tree):
        out += [(0, p, r) for r in mod_search._radius_targets(p, 3)]
        out += [(k, p, None) for k in (1, 2)]
    return out


@pytest.mark.parametrize("n_taxa,seed,raw", [(16, 3, False), (16, 7, True),
                                             (40, 5, False)])
def test_move_candidates_equal_jax(n_taxa, seed, raw):
    """The batched rounds' native builder (pll_tpu_move_candidates) equals
    JAX's native builder and JAX's Python walk (apply, pack with
    fused_candidate_from_tree, roll back) move for move, with raw tips
    (is_tip 2 rows) too."""
    jp, jtree, ttree = _problem(n_taxa, 24, seed=seed)
    if raw:
        vals = np.random.default_rng(seed).uniform(0.1, 1, (24, 4))
        for i in (1, 4):
            jp.set_tip_clv(i, vals)
    tpart = _port(jp)
    ts = tsearch.TreeSearch(tpart, ttree)
    ts._ensure_engine()
    got = ts._native_candidates(_move_list(tsearch, ttree))
    assert got is not None
    jmoves = _move_list(jsearch, jtree)
    ctips = None
    if raw:
        ctips = np.full(jp.tips, -1, np.int32)
        idx = np.flatnonzero(jp._tips_clv_set)
        ctips[idx] = np.arange(len(idx))
    if jnative.load() is not None:
        # JAX's builder called directly: its float64 engine is off the
        # fused path and would pack raw tips as state codes
        back, nxt, clv, sc, pmat, length, _, ids = \
            jsearch._flatten_tree(jtree)
        mv = np.asarray([[k, ids[id(a)], ids[id(b)] if k == 0 else 0]
                         for k, a, b in jmoves], np.int32)
        want = jnative.move_candidates(
            back, nxt, clv, sc, pmat, length, jtree.tip_count,
            int(clv.max()) + 1, ctips, mv, ids[id(jtree.vroot)],
            jp.prob_matrices)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
    py, kept = [], []
    for kind, a, b in jmoves:
        rb = jtrees.moves.Rollback()
        try:
            if kind == 0:
                jtrees.moves.spr(a, b, rb, safe=True)
            else:
                jtrees.moves.nni(a, kind, rb)
        except JC.PllError:
            continue
        py.append(jfused.fused_candidate_from_tree(
            jtree.vroot, jp.tips, jp.prob_matrices, clv_tip_rows=ctips))
        kept.append((kind, _key(a), None if b is None else _key(b)))
        jtrees.moves.rollback_move(rb)
    tables, blens, roots, slots, kept_moves = got
    assert [(k, _key(a), None if b is None else _key(b))
            for k, a, b in kept_moves] == kept
    np.testing.assert_array_equal(tables, np.stack([q[0] for q in py]))
    np.testing.assert_array_equal(blens, np.stack([q[1] for q in py]))
    np.testing.assert_array_equal(roots, np.asarray([q[2] for q in py]))
    np.testing.assert_array_equal(slots, [q[3] for q in py])


def test_native_library_builds_into_build_dir():
    """The library is built by g++ from the package's own source into
    libpll2_tpu_torch/_build/, keyed on a hash, and loads."""
    assert native.load() is not None
    path = native.library_path()
    assert path.parent == native.BUILD
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "libpll2_tpu_torch"
    assert path.name.startswith("libpllnative_") and path.exists()
    assert native.SRC.parent.name == "native"


def test_native_unavailable_returns_none_and_says_why(monkeypatch, capsys):
    """Without g++ the loader returns None and prints the reason to
    stderr; the builders then return None and the rounds take the Python
    builders, with the same moves."""
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.library_path()
    assert native.load.__wrapped__() is None
    assert "Python builders" in capsys.readouterr().err
    res = []
    for loaded in (True, False):
        jp, _, tree = _problem(14, 48, seed=9)
        tpart = _port(jp)
        if not loaded:
            monkeypatch.setattr(native, "load", lambda: None)
            assert tss.build_spr_stream_native(
                tree, 3, *_sig(tpart)) is None
        s = tsearch.TreeSearch(tpart, tree)
        res.append((s.spr_round_streamed(radius=3, max_candidates=4,
                                         seed=1),
                    s.nni_round_batched()))
    assert res[0] == res[1]


# ----------------------------------------------------------- trees/utils.py
def test_tree_utils_equal_jax():
    labels = [f"t{i}" for i in range(14)]
    ja, ta = jtrees.random_utree(labels, seed=1), \
        ttrees.random_utree(labels, seed=1)
    jb, tb = jtrees.random_utree(labels, seed=2), \
        ttrees.random_utree(labels, seed=2)
    assert ttrees.check_integrity(ta) and jtrees.check_integrity(ja)
    tc = ttrees.utree_clone(ta)
    assert tc.vroot is not ta.vroot
    assert ttrees.export_newick(tc.vroot) == ttrees.export_newick(ta.vroot) \
        == jtrees.export_newick(jtrees.utree_clone(ja).vroot)
    assert ttrees.tree_bipartitions(ta) == jtrees.tree_bipartitions(ja)
    assert ttrees.rf_distance(ta, tb) == jtrees.rf_distance(ja, jb)
    assert ttrees.rf_distance(ta, tb, normalized=True) == \
        jtrees.rf_distance(ja, jb, normalized=True)
    reps_t = [ttrees.random_utree(labels, seed=s) for s in range(3, 9)]
    reps_j = [jtrees.random_utree(labels, seed=s) for s in range(3, 9)]
    assert ttrees.edge_support(ta, reps_t) == jtrees.edge_support(ja, reps_j)
    assert ttrees.majority_rule_consensus(reps_t + [ta] * 4) == \
        jtrees.majority_rule_consensus(reps_j + [ja] * 4)
    rooted = "((a:0.1,b:0.2):0.05,(c:0.3,(d:0.1,e:0.2):0.1):0.15);"
    assert ttrees.export_newick(ttrees.rtree_unroot(
        ttrees.parse_newick_rooted(rooted)).vroot) == jtrees.export_newick(
        jtrees.rtree_unroot(jtrees.parse_newick_rooted(rooted)).vroot)
    keep_t = ttrees.prune_tip(tc, "t3")
    keep_j = jtrees.prune_tip(jtrees.utree_clone(ja), "t3")
    assert ttrees.export_newick(keep_t) == jtrees.export_newick(keep_j)
    with pytest.raises(C.PllError):
        ttrees.prune_tip(tc, "nope")
    tc.vroot.back.length += 1.0
    with pytest.raises(C.PllError):
        ttrees.check_integrity(tc)


# ---------------------------------------------------------- dense_tip_rows
@pytest.mark.parametrize("kind", ["dense", "raw", "repeats", "repeats_raw",
                                  "asc"])
def test_dense_tip_rows_equal_jax(kind):
    jp, _, _ = _problem(12, 80, seed=4, conserved="repeats" in kind,
                        site_repeats="repeats" in kind,
                        asc="lewis" if kind == "asc" else None)
    if kind.endswith("raw"):
        vals = np.random.default_rng(4).uniform(0.1, 1, (80, 4))
        jp.set_tip_clv(3, vals)
    tpart = _port(jp)
    got = tpart.dense_tip_rows()
    assert got.dtype == F64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp.dense_tip_rows()))
    assert tpart.dense_tip_rows() is got                # cached
    tpart.set_tip_states(0, tmaps.map_nt, "A" * 80)
    jp.set_tip_states(0, jmaps.map_nt, "A" * 80)
    again = tpart.dense_tip_rows()
    assert again is not got
    np.testing.assert_array_equal(again.numpy(), np.asarray(
        jp.dense_tip_rows()))


def test_dense_tip_rows_needs_every_tip():
    part = tp.Partition(4, 2, 4, 20, 1, 5, 4, 2, device=CPU, dtype=F64)
    part.set_tip_states(0, tmaps.map_nt, "A" * 20)
    with pytest.raises(C.PllError, match="every tip"):
        part.dense_tip_rows()


# ------------------------------------------------------------------ scores
# name -> _problem keywords
SCORE_CASES = {
    "dna": dict(n_taxa=13, n_sites=64, seed=5),
    "pinv": dict(n_taxa=13, n_sites=64, seed=5, pinv=0.3),
    "protein": dict(n_taxa=10, n_sites=48, seed=5, states=20),
    "rate_scalers": dict(n_taxa=13, n_sites=64, seed=5, rate_scalers=True),
    "repeats": dict(n_taxa=13, n_sites=64, seed=5, site_repeats=True,
                    conserved=True),
    "repeats_rate_scalers": dict(n_taxa=13, n_sites=64, seed=5,
                                 site_repeats=True, conserved=True,
                                 rate_scalers=True),
    "lewis": dict(n_taxa=12, n_sites=96, seed=7, asc="lewis"),
    "felsenstein": dict(n_taxa=12, n_sites=96, seed=7, asc="felsenstein"),
    "stamatakis": dict(n_taxa=12, n_sites=96, seed=7, asc="stamatakis"),
}


def _jax_scores(jp, jtree, kind, radius=4):
    eng = JTreeEngine(jp, jtree, level_schedule=True, pallas=False)
    JTS = jsearch.TreeSearch
    clv, sc, base = JTS._stream_base(jp)
    margs, (pw, inv) = eng._model_args(), eng._site_args()
    kw = dict(rate_scalers=jp.rate_scalers, base=base,
              asc_type=eng.asc_type, n_real=eng.n_real)
    if kind == "nni":
        sched = jss.build_nni_stream(jtree, jsearch._internal_edges(jtree),
                                     *_sig(jp))
        tot = jss.nni_stream_scores(
            clv, sc, *margs, jss.ops_from_table(sched.post_table),
            jnp.asarray(sched.post_valid),
            jss.ops_from_table(sched.up_table), jnp.asarray(sched.up_valid),
            jnp.asarray(sched.blen_full, jp.dtype),
            jnp.asarray(sched.cand_rows), pw, inv, jp.scale_threshold,
            jp.scale_factor, n_aux=sched.n_aux, n_arows=sched.n_arows,
            chunk=64, **kw)
    else:
        sched = jss.build_spr_stream(
            jtree, _groups(jsearch, jss, jtree, radius), *_sig(jp))
        tot = jss.spr_stream_scores(
            clv, sc, *margs, jss.ops_from_table(sched.post_table),
            jnp.asarray(sched.post_valid),
            jss.ops_from_table(sched.up_table), jnp.asarray(sched.up_valid),
            jss.ops_from_table(sched.a_table), jnp.asarray(sched.a_valid),
            jnp.asarray(sched.blen_full, jp.dtype),
            jnp.asarray(sched.merged_len, jp.dtype),
            jnp.asarray(sched.half_len, jp.dtype),
            jnp.asarray(sched.cand_rows), pw, inv, jp.scale_threshold,
            jp.scale_factor, n_aux=sched.n_aux, n_arows=sched.n_arows,
            chunk=64, **kw)
    return np.asarray(tot)[:sched.n_candidates]


def _port_scores(tpart, ttree, kind, radius=4, chunk=64):
    eng = tp.TreeEngine(tpart, ttree, pallas=False)
    TS = tsearch.TreeSearch
    clv, sc, base = TS._stream_base(tpart)
    margs, (pw, inv) = eng._model_args(), eng._site_args()
    kw = dict(rate_scalers=tpart.rate_scalers, base=base,
              asc_type=eng.asc_type, n_real=eng.n_real)
    if kind == "nni":
        sched = tss.build_nni_stream(ttree, tsearch._internal_edges(ttree),
                                     *_sig(tpart))
        tot = tss.nni_stream_scores(
            clv, sc, *margs, tss.ops_from_table(sched.post_table),
            sched.post_valid, tss.ops_from_table(sched.up_table),
            sched.up_valid, sched.blen_full, sched.cand_rows, pw, inv,
            tpart.scale_threshold, tpart.scale_factor, n_aux=sched.n_aux,
            n_arows=sched.n_arows, chunk=chunk,
            n_candidates=sched.n_candidates, **kw)
    else:
        sched = tss.build_spr_stream_native(ttree, radius, *_sig(tpart))
        tot = tss.spr_stream_scores(
            clv, sc, *margs, tss.ops_from_table(sched.post_table),
            sched.post_valid, tss.ops_from_table(sched.up_table),
            sched.up_valid, tss.ops_from_table(sched.a_table),
            sched.a_valid, sched.blen_full, sched.merged_len,
            sched.half_len, sched.cand_rows, pw, inv,
            tpart.scale_threshold, tpart.scale_factor, n_aux=sched.n_aux,
            n_arows=sched.n_arows, chunk=chunk,
            n_candidates=sched.n_candidates, **kw)
    assert tot.shape == (sched.n_candidates,)
    return tot.numpy()


@pytest.fixture(scope="module", params=sorted(SCORE_CASES))
def scored(request):
    """(case, JAX partition, port tree, JAX's NNI and SPR scores)."""
    jp, jtree, ttree = _problem(**SCORE_CASES[request.param])
    return (request.param, jp, ttree,
            {k: _jax_scores(jp, jtree, k) for k in ("nni", "spr")})


@pytest.mark.parametrize("kind", ["nni", "spr"])
def test_streamed_scores_equal_jax_f64(scored, kind):
    """nni_stream_scores / spr_stream_scores against JAX's in float64, at
    4 and 20 states, p-inv, per-rate scalers, the repeats base and the
    three asc corrections; chunks of 64 over more candidates."""
    name, jp, ttree, want = scored
    got = _port_scores(_port(jp), ttree, kind)
    assert len(got) == len(want[kind]) >= 14
    np.testing.assert_allclose(got, want[kind], rtol=1e-12, atol=0)


def test_streamed_scores_from_garbage_inner_rows():
    """The post pass rebuilds every inner row before the up and A passes
    read them: a partition whose inner CLV and scaler rows hold garbage
    (as the fused path leaves them) scores the same, and equals JAX."""
    jp, jtree, ttree = _problem(13, 64, seed=5)
    clean = _port(jp)
    dirty = _port(jp)
    g = torch.Generator().manual_seed(1)
    dirty.clv[dirty.tips:] = torch.rand(dirty.clv[dirty.tips:].shape,
                                        generator=g, dtype=F64) * 1e3
    dirty.scale_buffer[:dirty.scale_buffers] = 7
    for kind in ("nni", "spr"):
        a = _port_scores(clean, ttree, kind)
        b = _port_scores(dirty, ttree, kind)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(b, _jax_scores(jp, jtree, kind),
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("rate_scalers,alpha", [(False, 0.8), (True, 0.45)])
def test_streamed_scores_f32_scaling_stress(rate_scalers, alpha):
    """float32 (threshold 2^-32) at 40 taxa with long branches underflows
    without the scalers; agreement with float64 at JAX's 5e-4 shows the
    counts propagate through the three passes and the compose."""
    jp, _, ttree = _problem(40, 64, seed=7, scale_stress=True, alpha=alpha,
                            rate_scalers=rate_scalers)
    s32 = _port_scores(_port(jp, torch.float32), ttree, "spr")
    s64 = _port_scores(_port(jp), ttree, "spr")
    assert float(np.max(s64) / 64) < -30       # far below float32's range
    assert np.all(np.isfinite(s32))
    np.testing.assert_allclose(s32, s64, rtol=5e-4)


def test_chunks_and_real_candidates_only():
    """Scores do not depend on `chunk`, and only the real candidates are
    scored (the pow2 padding rows are not)."""
    jp, _, ttree = _problem(13, 64, seed=5)
    tpart = _port(jp)
    a = _port_scores(tpart, ttree, "spr", chunk=7)
    b = _port_scores(tpart, ttree, "spr", chunk=1024)
    np.testing.assert_allclose(a, b, rtol=1e-13, atol=0)
    sched = tss.build_spr_stream_native(ttree, 4, *_sig(tpart))
    assert sched.cand_rows.shape[0] > sched.n_candidates == len(a)


# ------------------------------------------------- passes and level tables
def test_pass_tables_equal_update_partials_levels():
    """Every wave's valid slots as one level table, run through the level
    kernel's wrapper (its plain version here), give JAX's
    update_partials_levels over the padded tables: the written rows of
    all three passes at 1e-12, scaler rows equal."""
    from libpll2_tpu.ops import pmatrix as jpm

    jp, jtree, ttree = _problem(16, 40, seed=11, rate_scalers=True)
    tpart = _port(jp)
    sched = tss.build_spr_stream_native(ttree, 4, *_sig(tpart))
    jeng = JTreeEngine(jp, jtree, pallas=False)
    m = jeng._model_args()
    pm_full = jpm.update_prob_matrices(m[0], m[1], m[2], m[3], m[4], m[7],
                                       jnp.asarray(sched.blen_full))
    pm_ext = jnp.concatenate([pm_full, jpm.update_prob_matrices(
        m[0], m[1], m[2], m[3], m[4], m[7], jnp.asarray(sched.merged_len))])
    clv, sc = jss._extend_buffers(jp.clv, jp.scale_buffer, sched.n_aux,
                                  sched.n_arows, rate_cats=4,
                                  rate_scalers=True)
    passes = [(sched.post_table, sched.post_valid),
              (sched.up_table, sched.up_valid),
              (sched.a_table, sched.a_valid)]
    for table, valid in passes:
        clv, sc = jpartials.update_partials_levels(
            clv, sc, pm_ext, jss.ops_from_table(table), jnp.asarray(valid),
            jp.scale_threshold, jp.scale_factor, rate_scalers=True)
    clv, sc = np.asarray(clv), np.asarray(sc)
    got = tss.stream_passes(
        tpart.clv, tpart.scale_buffer, torch.as_tensor(np.array(pm_ext)),
        passes, sched.n_aux, sched.n_arows, tpart.scale_threshold,
        tpart.scale_factor, rate_scalers=True)
    n_rows = got.clv.shape[0]
    assert n_rows == tpart.clv.shape[0] + sched.n_aux + int(
        sched.a_valid.sum()) < clv.shape[0]
    written = np.concatenate([t[v][:, 0] for t, v in passes])
    np.testing.assert_allclose(got.clv.numpy()[written], clv[written],
                               rtol=1e-12, atol=0)
    sc_rows = np.concatenate([t[v][:, 1] for t, v in passes])
    sc_rows = sc_rows[sc_rows >= 0]
    np.testing.assert_array_equal(got.scaler.numpy()[sc_rows], sc[sc_rows])
    assert not got.scaler[got.zero].any()
    # each table a wave's valid slots, no padded slot, no empty wave
    n_valid = sum(int(v.sum()) for _, v in passes)
    assert sum(t.shape[1] for t in got.tables) == n_valid
    assert len(got.tables) == sum(int(v.any(axis=1).sum())
                                  for _, v in passes)


@pytest.mark.parametrize("case", ["read_after_write", "write_write"])
def test_conflicting_wave_is_refused(case):
    """A wave in which one op reads a row that another op of the wave
    writes, or two ops write one row (which the builders never emit), would
    race in the in-place level kernel: `wave_conflicts` names the pair and
    `pass_tables`, so `stream_passes`, raises before anything launches."""
    tpart = _port(_problem(8, 24, seed=2)[0])
    n, K = tpart.clv.shape[0], tpart.scale_buffers
    zero_pad = K + 2 + 1 + 1               # n_aux 2, n_arows 1
    if case == "read_after_write":
        # op 0 writes aux row n (scaler K); op 1 reads row n and scaler K
        rows = [[n, K, 0, 0, zero_pad, 1, 1, zero_pad],
                [n + 1, K + 1, n, 2, K, 2, 3, zero_pad]]
        want = ([(0, 1)], [])
    else:
        # both ops write aux row n and scaler K from tips
        rows = [[n, K, 0, 0, zero_pad, 1, 1, zero_pad],
                [n, K, 2, 0, zero_pad, 3, 1, zero_pad]]
        want = ([], [(0, 1)])
    rows = np.array(rows, np.int32)
    assert tss.wave_conflicts(tss._level_table(rows, 99)) == want
    table = np.zeros((1, 4, 8), np.int32)
    table[0, :2] = rows
    valid = np.array([[True, True, False, False]])
    with pytest.raises(C.PllError, match="wave 0"):
        tss.pass_tables(table, valid, K + 2, zero_pad, K + 3)
    pm = torch.full((tpart.prob_matrices, 4, 4, 4), 0.25, dtype=F64)
    n0 = levels.level_update.launches
    with pytest.raises(C.PllError, match="wave 0"):
        tss.stream_passes(tpart.clv, tpart.scale_buffer, pm,
                          [(table, valid)], 2, 1, tpart.scale_threshold,
                          tpart.scale_factor)
    assert levels.level_update.launches == n0


@pytest.mark.parametrize("seed", [203, 206, 210, 217, 225, 228])
def test_builder_waves_never_conflict(seed):
    """The check that no row is read and written within one wave, over all
    three passes of fuzzed schedules (JAX's fuzz seeds' trees, every
    radius 2-5, full and subsampled, and the NNI schedule): it never
    fires."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 40))
    tree = ttrees.random_utree([f"t{i}" for i in range(n)], seed=seed)
    part_sig = (2 * n - 1, n - 2, 2 * n - 3)
    scheds = [tss.build_nni_stream(tree, tsearch._internal_edges(tree),
                                   *part_sig)]
    for radius in (2, 3, 4, 5):
        for maxc in (None, 3):
            scheds.append(tss.build_spr_stream_native(
                tree, radius, *part_sig, max_candidates=maxc,
                rng=np.random.default_rng(seed)))
    for sched in scheds:
        for table, valid in ((sched.post_table, sched.post_valid),
                             (sched.up_table, sched.up_valid),
                             (sched.a_table, sched.a_valid)):
            for lv in range(table.shape[0]):
                rows = table[lv][valid[lv]]
                if len(rows):
                    assert tss.wave_conflicts(
                        tss._level_table(rows, -5)) == ([], [])


def test_out_of_range_schedule_raises():
    jp, _, ttree = _problem(10, 24, seed=3)
    tpart = _port(jp)
    sched = tss.build_spr_stream_native(ttree, 3, *_sig(tpart))
    pm = torch.zeros((tpart.prob_matrices, 4, 4, 4), dtype=F64)
    with pytest.raises(C.PllError, match="matrix index"):
        tss.stream_passes(tpart.clv, tpart.scale_buffer, pm,
                          [(sched.a_table, sched.a_valid)], sched.n_aux,
                          sched.n_arows, tpart.scale_threshold,
                          tpart.scale_factor)
    # under a site mesh the passes run once a shard, and each shard checks
    # the schedule's indices as one device does (here P-matrices for too
    # few edges)
    from libpll2_tpu_torch.parallel import make_mesh, shard_partition

    mesh = make_mesh(devices=["cpu"] * 2)
    shard_partition(tpart, mesh)
    eng = tp.TreeEngine(tpart, ttree)
    site = [e._site_args() for e in eng._shards.engines]
    with pytest.raises(C.PllError, match="matrix index"):
        tss.spr_stream_scores(
            [sh.clv for sh in tpart.shards],
            [sh.scale_buffer for sh in tpart.shards], *eng._model_args(),
            tss.ops_from_table(sched.post_table), sched.post_valid,
            tss.ops_from_table(sched.up_table), sched.up_valid,
            tss.ops_from_table(sched.a_table), sched.a_valid,
            sched.blen_full[:2], sched.merged_len, sched.half_len,
            sched.cand_rows, [pw for pw, _ in site], [inv for _, inv in site],
            tpart.scale_threshold, tpart.scale_factor, n_aux=sched.n_aux,
            n_arows=sched.n_arows, n_candidates=sched.n_candidates,
            mesh=mesh)
