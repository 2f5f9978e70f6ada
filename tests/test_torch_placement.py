"""The port's placement (`libpll2_tpu_torch.EdgePlacer`, `to_jplace`, the
fused traversal's query form) against libpll2_tpu's on the CPU:
tests/test_placement.py's cases carried over, each held against JAX, and
the query form's plain version against single walks.

Both placers are built from the same reference newick, the same reference
dict and the same `set_model` arguments (the alignment simulated once).
Tolerances:
  * host code (`_graft_candidates`, `_index_for_placement`, the edge list,
    ranked rows, `to_jplace`): `==`;
  * float64: the port's `place`, `place_batch`, `place_stream` and
    `prepare_stream` against JAX's (`pallas` "auto", which JAX runs on XLA
    in float64) at 1e-12 relative a logL, ranks `==`;
  * float32: the port's plain version against JAX's Pallas kernel in
    interpret mode at TOL_LOGL 5e-5 (bench_validate.py:61-63);
  * the port against itself: `place_batch` against `place` (float64
    1e-12), `place_stream` against `place` 2e-5 (tests/test_placement.py:
    201,253), the query form against Q x E single walks 1e-12 with counts
    equal, an edge-split chunk against the unsplit one `==`.
Sizes stay at 16 taxa and 600 sites at most: JAX's cases at 768 and 1200
sites, and its 40-taxon scaling case, are cut to that (the scaling case
then narrows both packages' scaling window, so that 16 taxa rescale).
JAX's oracle case skips as JAX's does when the reference library is
absent."""
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import placement as jplacement
from libpll2_tpu.trees import parse_newick as j_parse_newick

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import constants as C
from libpll2_tpu_torch import placement
from libpll2_tpu_torch.engine import _pmatrices
from libpll2_tpu_torch.ops import fused as tfused
from libpll2_tpu_torch.trees import (export_newick, parse_newick, prune_tip,
                                     random_utree)
from libpll2_tpu_torch.utils import simulate_alignment

CPU = "cpu"
F64, F32 = torch.float64, torch.float32
TOL_LOGL = 5e-5                                # bench_validate.py:61-63
TOL_STREAM = 2e-5                              # tests/test_placement.py:201
FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1, 2.5, 0.8, 1.1, 2.5, 1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small problems: the test workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n, sites, seed, victim, alpha=0.9, full=None, **sim):
    """A tree of `n` taxa (or `full`), an alignment simulated on it, and
    the taxon `victim` pruned: (reference newick, full dict, reference
    dict, the pruned taxon's neighbours' labels)."""
    full = full or random_utree([f"t{i}" for i in range(n)], seed=seed)
    headers, seqs = simulate_alignment(full, sites, sim.get("freqs", FREQS),
                                       sim.get("subst", SUBST), alpha=alpha,
                                       seed=seed)
    by = dict(zip(headers, seqs))
    a = prune_tip(full, victim)
    b = a.back
    nwk = export_newick(a if not a.is_tip() else b)
    ref_by = {k: v for k, v in by.items() if k != victim}
    return nwk, by, ref_by, {x.label for x in (a, b) if x.label}


def _placers(nwk, ref_by, alpha=0.9, dtype=F64, jkw=None, set_model=True,
             **kw):
    """(JAX placer, port placer) over one newick and reference dict."""
    jp = jplacement.EdgePlacer(j_parse_newick(nwk), ref_by, **(jkw or {}),
                               **kw)
    p = tp.EdgePlacer(parse_newick(nwk), ref_by, dtype=dtype, device=CPU,
                      **kw)
    if set_model:
        for x in (jp, p):
            x.set_model(FREQS, SUBST, alpha=alpha)
    return jp, p


def _by_edge(rows):
    return np.array([r["logL"] for r in sorted(rows, key=lambda r:
                                               r["edge"])])


def _same_rows(got, want, rtol=1e-12):
    """Ranked rows of both packages: the same edges in the same order, the
    logL to `rtol`, the LWR to 1e-10."""
    assert [r["edge"] for r in got] == [r["edge"] for r in want]
    assert [r["edge_nodes"] for r in got] == [r["edge_nodes"] for r in want]
    np.testing.assert_allclose([r["logL"] for r in got],
                               [r["logL"] for r in want], rtol=rtol)
    np.testing.assert_allclose([r["lwr"] for r in got],
                               [r["lwr"] for r in want], rtol=1e-10,
                               atol=1e-12)


# ------------------------------------------- tests/test_placement.py, ported
def test_place_recovers_pruned_taxon():
    nwk, by, ref_by, sides = _problem(14, 600, 17, "t5")
    jp, p = _placers(nwk, ref_by)
    rows = p.place(by["t5"])
    _same_rows(rows, jp.place(by["t5"]))
    assert len(rows) == 2 * 13 - 3
    assert abs(sum(r["lwr"] for r in rows) - 1.0) < 1e-9
    best = rows[0]
    assert best["lwr"] > 0.25, rows[:3]
    assert best["logL"] > rows[-1]["logL"] + 2.0
    assert sides & set(best["edge_nodes"]) or best["lwr"] > 0.5


def test_place_two_queries_reuse_engine():
    nwk, by, ref_by, _ = _problem(10, 600, 23, "t3", alpha=1.0)
    jp, p = _placers(nwk, ref_by, alpha=1.0)
    r1 = p.place(by["t3"], top_k=3)
    _same_rows(r1, jp.place(by["t3"], top_k=3))
    # a copy of a reference taxon lands on that taxon's pendant edge
    r2 = p.place(ref_by["t7"], top_k=3)
    _same_rows(r2, jp.place(ref_by["t7"], top_k=3))
    assert "t7" in set(r2[0]["edge_nodes"]), r2
    assert len(r1) == 3 and r1[0]["lwr"] >= r1[1]["lwr"]


def test_placement_logl_matches_oracle():
    """JAX's oracle case: the reference library on the same grafted
    trees; it skips, as JAX's, without the reference."""
    import oracle
    if not oracle.available():
        pytest.skip("reference not available")
    nwk, by, ref_by, _ = _problem(9, 400, 29, "t2", alpha=0.8)
    jp, p = _placers(nwk, ref_by, alpha=0.8, pendant_length=0.07)
    _same_rows(p.place(by["t2"]), jp.place(by["t2"]))


@pytest.mark.parametrize("mode", ["fallback", "fused64", "fused32"])
def test_place_batch_matches_place(mode):
    """place_batch against place and against JAX's: off the fused route
    ('fallback', pallas=False: place a query at a time), through the query
    form in float64 (JAX's float64 runs its fallback loop; 1e-12) and in
    float32 (JAX's Pallas kernel in interpret mode; TOL_LOGL)."""
    nwk, by, ref_by, _ = _problem(10, 512, 43, "t6")
    if mode == "fused32":
        jp, p = _placers(nwk, ref_by, dtype=F32,
                         jkw=dict(dtype=jnp.float32, pallas="interpret"))
    else:
        jp, p = _placers(nwk, ref_by, pallas="auto" if mode == "fused64"
                         else False)
    single = p.place(by["t6"])
    assert p._engine.use_fused == (mode != "fallback")
    queries = {"t6": by["t6"], "t6b": by["t6"], "t2": ref_by["t2"]}
    batch = p.place_batch(queries, chunk=2)
    jbatch = jp.place_batch(queries, chunk=2)
    tol = TOL_LOGL if mode == "fused32" else 1e-12
    np.testing.assert_allclose(_by_edge(batch["t6"]), _by_edge(single),
                               rtol=1e-6 if mode == "fused32" else 1e-12)
    assert batch["t6"][0]["edge"] == single[0]["edge"]
    np.testing.assert_allclose(_by_edge(batch["t6b"]), _by_edge(batch["t6"]),
                               rtol=1e-12)
    for q in queries:
        np.testing.assert_allclose(_by_edge(batch[q]), _by_edge(jbatch[q]),
                                   rtol=tol)
        if mode != "fused32":
            _same_rows(batch[q], jbatch[q])


def test_jplace_export():
    """jplace v3: every edge annotated once with its candidate index, valid
    placements, a json round trip, and the dict `==` JAX's writer on the
    same scores."""
    nwk, by, ref_by, _ = _problem(8, 256, 3, "t1")
    jp, p = _placers(nwk, ref_by)
    res = {"t1": p.place(by["t1"])}
    jres = {"t1": jp.place(by["t1"])}
    _same_rows(res["t1"], jres["t1"])
    jpl = json.loads(json.dumps(placement.to_jplace(p, res, top_k=3)))
    edges = [int(x) for x in re.findall(r"\{(\d+)\}", jpl["tree"])]
    n_edges = len(p.edges)
    assert sorted(edges) == list(range(n_edges))
    assert jpl["version"] == 3 and len(jpl["placements"]) == 1
    rows = jpl["placements"][0]["p"]
    assert len(rows) == 3
    for edge_num, lnl, lwr, distal, pendant in rows:
        assert 0 <= edge_num < n_edges
        assert np.isfinite(lnl) and 0 <= lwr <= 1
        assert distal >= 0 and pendant == p.pendant_length
    # both writers on one score matrix: equal dicts (the fast path and the
    # dict path)
    scores = np.stack([_by_edge(res["t1"]), _by_edge(res["t1"]) - 0.5])
    mine = dict(zip(("a", "b"), p._rank_rows_batch(scores)))
    theirs = dict(zip(("a", "b"), jp._rank_rows_batch(scores)))
    for k in (3, 7):
        assert placement.to_jplace(p, mine, top_k=k) == \
            jplacement.to_jplace(jp, theirs, top_k=k)
    mixed = {"a": mine["a"][:5], "b": mine["b"]}
    jmixed = {"a": theirs["a"][:5], "b": theirs["b"]}
    assert placement.to_jplace(p, mixed) == jplacement.to_jplace(jp, jmixed)


def test_place_stream_matches_place():
    """The streaming scorer's per-edge logL against place() (2e-5) and
    against JAX's streaming scorer (1e-12), for a query, a gappy one and a
    reference copy."""
    nwk, by, ref_by, _ = _problem(16, 600, 41, "t2", alpha=0.7)
    jp, p = _placers(nwk, ref_by, alpha=0.7)
    single = p.place(by["t2"])
    gappy = by["t2"][:250] + "-" * 150 + by["t2"][400:]
    queries = {"q": by["t2"], "g": gappy, "c": ref_by["t7"]}
    res = p.place_stream(queries, chunk=4)
    jres = jp.place_stream(queries, chunk=4)
    np.testing.assert_allclose(_by_edge(res["q"]), _by_edge(single),
                               rtol=TOL_STREAM)
    for q in queries:
        _same_rows(res[q], jres[q])
    assert res["q"][0]["edge"] == single[0]["edge"]
    assert "t7" in set(res["c"][0]["edge_nodes"])


def test_place_stream_scaling_events():
    """Per-site rescaling in the streaming scorer: its scaler-count
    correction reproduces place()'s logL (2e-5) and JAX's streaming scorer
    (1e-12). JAX's case stretches a 40-taxon caterpillar; at 16 taxa both
    packages' partitions take a scaling window of 2^-10 (factor 2^10)
    instead, so that sites rescale."""
    n = 16
    text = "t2:0.9"
    for i in range(3, n):
        text = f"({text},t{i}:0.9):0.9"
    full = parse_newick(f"(t0:0.4,t1:0.4,{text});")
    nwk, by, ref_by, _ = _problem(n, 384, 43, "t9", alpha=0.6, full=full)
    jp, p = _placers(nwk, ref_by, alpha=0.6)
    for x in (jp, p):
        x.partition.scale_threshold = 2.0 ** -10
        x.partition.scale_factor = 2.0 ** 10
    single = p.place(by["t9"])
    _same_rows(single, jp.place(by["t9"]))
    stream = p.place_stream({"q": by["t9"]})["q"]
    assert int(p._stream[1].max()) > 0, "no site was rescaled"
    np.testing.assert_allclose(_by_edge(stream), _by_edge(single),
                               rtol=TOL_STREAM)
    _same_rows(stream, jp.place_stream({"q": by["t9"]})["q"])
    batch = p.place_batch({"q": by["t9"]})["q"]
    np.testing.assert_allclose(_by_edge(batch), _by_edge(single),
                               rtol=1e-12)


def test_place_stream_aa():
    from libpll2_tpu.models import load_aa_model as j_load_aa_model
    from libpll2_tpu_torch.models import load_aa_model

    nwk, by, ref_by, _ = _problem(10, 320, 47, "t4", alpha=1.0,
                                  freqs=[1 / 20] * 20, subst=[1.0] * 190)
    jp, p = _placers(nwk, ref_by, states=20, set_model=False)
    for x, load in ((jp, j_load_aa_model), (p, load_aa_model)):
        load(x.partition, "lg")
        x.partition.set_category_rates(tp.compute_gamma_cats(1.0, 4))
        x._engine = None
        x._stream = None
    single = p.place(by["t4"])
    _same_rows(single, jp.place(by["t4"]))
    stream = p.place_stream({"q": by["t4"]})["q"]
    np.testing.assert_allclose(_by_edge(stream), _by_edge(single),
                               rtol=TOL_STREAM)
    _same_rows(stream, jp.place_stream({"q": by["t4"]})["q"])
    batch = p.place_batch({"q": by["t4"], "r": ref_by["t1"]})
    np.testing.assert_allclose(_by_edge(batch["q"]), _by_edge(single),
                               rtol=1e-12)


def test_place_stream_rejects_pinv():
    full = random_utree([f"t{i}" for i in range(8)], seed=51)
    headers, seqs = simulate_alignment(full, 256, FREQS, SUBST, alpha=0.9,
                                       seed=51)
    by = dict(zip(headers, seqs))
    p = tp.EdgePlacer(full, by, dtype=F64, device=CPU)
    p.set_model(FREQS, SUBST, alpha=0.9)
    p.partition.update_invariant_sites()
    p.partition.update_invariant_sites_proportion(0, 0.2)
    with pytest.raises(C.PllError):
        p.place_stream({"q": by["t0"]})


def test_place_stream_jplace():
    """place_stream rows feed to_jplace unchanged, as JAX's."""
    nwk, by, ref_by, _ = _problem(8, 256, 3, "t1")
    jp, p = _placers(nwk, ref_by)
    res = p.place_stream({"t1": by["t1"]}, top_k=3)
    jres = jp.place_stream({"t1": by["t1"]}, top_k=3)
    _same_rows(res["t1"], jres["t1"])
    jpl = json.loads(json.dumps(placement.to_jplace(p, res, top_k=3)))
    assert len(jpl["placements"][0]["p"]) == 3
    assert jpl["tree"] == jplacement.to_jplace(jp, jres, top_k=3)["tree"]


def test_place_stream_invalidates_on_branch_change():
    """Changing reference branch lengths re-prepares the attachment tensors
    instead of scoring against stale ones."""
    nwk, by, ref_by, _ = _problem(10, 256, 59, "t3")
    _, p = _placers(nwk, ref_by)
    before = p.place_stream({"q": by["t3"]})["q"]
    for h in p.edges:
        h.length = h.back.length = h.length * 3.0
    after = p.place_stream({"q": by["t3"]})["q"]
    fresh = p.place(by["t3"])
    np.testing.assert_allclose(_by_edge(after), _by_edge(fresh),
                               rtol=TOL_STREAM)
    assert np.max(np.abs(_by_edge(before) - _by_edge(after))) > 1.0


def test_to_jplace_mixed_length_rows():
    """Merged results with different row counts (place_stream calls with
    different top_k) emit min(len(rows), top_k) rows per query."""
    tree = random_utree([f"t{i}" for i in range(8)], seed=4)
    headers, seqs = simulate_alignment(tree, 128, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=0.9, seed=4)
    by = dict(zip(headers, seqs))
    p = tp.EdgePlacer(tree, by, dtype=F64, device=CPU)
    p.set_model([0.25] * 4, [1, 2, 1, 1, 2, 1], alpha=0.9)
    p.prepare_stream()
    long_rows = p.place_stream({"qA": by["t1"]})
    short_rows = p.place_stream({"qB": by["t2"]}, top_k=3)
    merged = {"qA": long_rows["qA"], "qB": short_rows["qB"]}
    jpl = placement.to_jplace(p, merged, top_k=7)
    counts = {q["n"][0]: len(q["p"]) for q in jpl["placements"]}
    assert counts == {"qA": 7, "qB": 3}
    json.dumps(jpl)


# ------------------------------------------------------ the port's own cases
def test_host_tables_equal_jax():
    """The edge list, `_index_for_placement`'s indices and
    `_graft_candidates`' op lists, branches and roots `==` JAX's."""
    nwk, by, ref_by, _ = _problem(12, 100, 5, "t4")
    jp, p = _placers(nwk, ref_by)

    def node_key(h):
        return (h.label, h.clv_index, h.node_index, h.scaler_index,
                h.pmatrix_index, h.length)

    assert [node_key(h) for h in p.tree.nodes()] == \
        [node_key(h) for h in jp.tree.nodes()]
    assert [(node_key(h), node_key(h.back)) for h in p.edges] == \
        [(node_key(h), node_key(h.back)) for h in jp.edges]
    assert p._edge_names == jp._edge_names
    p._ensure_engine()
    jp._ensure_engine()

    def op_key(o):
        return (o.parent_clv_index, o.parent_scaler_index,
                o.child1_clv_index, o.child1_matrix_index,
                o.child1_scaler_index, o.child2_clv_index,
                o.child2_matrix_index, o.child2_scaler_index)

    assert len(p._candidates) == len(jp._candidates) == len(p.edges)
    for (ops, br, pidx, ri), (jops, jbr, jpidx, jri) in zip(
            p._candidates, jp._candidates):
        assert [op_key(o) for o in ops] == [op_key(o) for o in jops]
        assert list(br) == list(jbr) and list(pidx) == list(jpidx)
        assert tuple(ri) == tuple(jri)
    assert np.array_equal(p._query_codes_batch([by["t4"]]),
                          jp._query_codes_batch([by["t4"]]))


def test_prepare_stream_equals_jax():
    """The attachment tensors on a 16-taxon tree whose smoothing schedule
    reuses its aux rows (fewer aux rows than attaching steps: a product
    taken after the walk would read overwritten rows) against JAX's
    `_edge_attach_tensors` at 1e-12, the counts `==`; the pendant matrix
    too."""
    from libpll2_tpu_torch.ops import branch_sweep

    nwk, by, ref_by, _ = _problem(16, 300, 13, "t11")
    jp, p = _placers(nwk, ref_by)
    p.prepare_stream()
    jp.prepare_stream()
    _, n_aux = branch_sweep.build_smoothing_schedule(
        p.tree, p.partition.nodes, p.partition.scale_buffers, len(p.edges))
    assert 0 < n_aux < len(p.edges) // 2
    got, want = p._stream, jp._stream
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-12, atol=1e-300)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-12)
    assert got[4] == want[4]


def _query_inputs(states, n=9, sites=200, seed=7, q_n=3):
    """A placer's candidate tables and P-matrices, the shared tip codes
    and `q_n` query code rows, each differing from every reference row
    (ambiguity codes and gaps among them)."""
    labels = [f"t{i}" for i in range(n)]
    tree = random_utree(labels, seed=seed)
    freqs = [1 / states] * states
    subst = [1.0] * (states * (states - 1) // 2)
    headers, seqs = simulate_alignment(tree, sites, freqs, subst, alpha=0.8,
                                       seed=seed)
    p = tp.EdgePlacer(tree, dict(zip(headers, seqs)), states=states,
                      dtype=F64, device=CPU)
    p.set_model(freqs, subst, alpha=0.8)
    eng = p._ensure_engine()
    tables, blens, _, n_slots = p._fused_batch_inputs()
    m = eng._model_args()
    pmat = torch.stack([_pmatrices(*m[:5], m[7], b) for b in blens])
    tip_codes = eng._tip_codes()
    rng = np.random.default_rng(seed)
    q = rng.integers(1, 1 << states, size=(q_n, sites)).astype(np.int32)
    q[:, :20] = (1 << states) - 1                     # gaps
    qc = torch.as_tensor(q)
    for row in range(p.n_ref):
        assert not any(torch.equal(qc[i], tip_codes[row])
                       for i in range(q_n))
    return p, tables, pmat, tip_codes, qc, n_slots


@pytest.mark.parametrize("states,rate_scalers",
                         [(4, False), (4, True), (20, False), (20, True)])
def test_query_form_plain_equals_single_walks(states, rate_scalers):
    """The query form's plain version, the Q x E walks op by op at once,
    against Q x E single `fused_traversal_reference` walks, each with the
    query's codes in tip row `query_row`: CLVs 1e-12, counts `==`. A
    threshold of 1e-3 makes sites rescale."""
    p, tables, pmat, tips, qc, n_slots = _query_inputs(states)
    R = p.partition.rate_cats
    kw = dict(rates=R, states=states, n_slots=n_slots, threshold=1e-3,
              factor=2.0 ** 10, rate_scalers=rate_scalers)
    got = tfused.fused_traversal(tips, pmat, tables, query_codes=qc,
                                 query_row=p.query_row, **kw)
    assert got[0].shape == (qc.shape[0], tables.shape[0], R, states,
                            tips.shape[1])
    assert int(got[2].max()) > 0
    for qi in range(qc.shape[0]):
        codes = tips.clone()
        codes[p.query_row] = qc[qi]
        for e in range(tables.shape[0]):
            want = tfused.fused_traversal_reference(codes, pmat[e],
                                                    tables[e], **kw)
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_allclose(g[qi, e].numpy(), w.numpy(),
                                           rtol=1e-12, atol=1e-300)
            for g, w in zip(got[2:], want[2:]):
                assert torch.equal(g[qi, e], w)


def test_query_form_edge_split_equals_unsplit():
    """A chunk split along its edges (a budget of one edge a launch) gives
    the unsplit chunk's scores, `==`; `query_edge_split` at the budget's
    boundaries."""
    nwk, by, ref_by, _ = _problem(10, 300, 19, "t6")
    _, p = _placers(nwk, ref_by)
    queries = {"a": by["t6"], "b": ref_by["t1"], "c": ref_by["t8"]}
    whole = p.place_batch(queries)
    calls = []

    def traversal(*a, **k):
        calls.append(a[2].shape[0])
        return tfused.fused_traversal(*a, **k)

    p._traversal = traversal
    assert p._launch_bytes == tfused.QUERY_LAUNCH_BYTES
    p.place_batch(queries)
    assert calls == [len(p.edges)]
    walk = 2 * 4 * 300 * (4 * 4 + 1)          # a walk's root rows, bytes
    p._launch_bytes = 3 * walk
    calls.clear()
    split = p.place_batch(queries)
    assert calls == [1] * len(p.edges)
    for q in queries:
        assert split[q] == whole[q]
    assert tfused.query_edge_split(3, 17, 4, 4, 300, False, 3 * walk) == 1
    assert tfused.query_edge_split(3, 17, 4, 4, 300, False,
                                   3 * 5 * walk) == 5
    assert tfused.query_edge_split(3, 17, 4, 4, 300, False) == 17
    assert tfused.query_edge_split(3, 17, 4, 4, 300, False, 1) == 1


def test_query_edge_split_counts_spill_slots(monkeypatch):
    """On a spill plan a launch's walks also hold their slots in device
    memory: `ops/_kernels.py:spill_slots` of each kernel's plans, and a
    chunk whose walks spill split into fewer edges a launch, with the
    unsplit chunk's scores `==`."""
    from libpll2_tpu_torch.ops import _kernels

    smem, sms = 227 * 1024, 132
    fixed = _kernels.fused_plan(4, 4, 250, False, smem, 1000, sms)
    generic = _kernels.fused_plan(3, 4, 2000, False, smem, 1000, sms)
    onchip = _kernels.fused_plan(4, 4, 12, False, smem, 1000, sms)
    generic_onchip = _kernels.fused_plan(3, 4, 12, False, smem, 1000, sms)
    rows = _kernels.rows_plan(16, 32, 12, False, smem, 300, sms)
    rows_onchip = _kernels.rows_plan(4, 20, 12, False, smem, 300, sms)
    assert [pl.plan for pl in (fixed, generic, onchip, generic_onchip, rows,
                               rows_onchip)] \
        == ["spill", "spill", "on-chip", "on-chip", "spill", "on-chip"]
    assert _kernels.spill_slots(fixed, 250) == 250
    assert _kernels.spill_slots(generic, 2000) == 2000
    assert _kernels.spill_slots(rows, 12) == 12
    assert _kernels.spill_slots(onchip, 12) == 0
    assert _kernels.spill_slots(generic_onchip, 12) == 0
    assert _kernels.spill_slots(rows_onchip, 12) == 0
    # the CPU's plain version bounds its own slots
    assert tfused.query_spill_slots("cpu", 3, 4, 12, False, 300) == 0
    walk = 2 * 4 * 300 * (4 * 4 + 1)          # a walk's root rows, bytes
    assert tfused.query_edge_split(3, 17, 4, 4, 300, False, 18 * walk) == 6
    assert tfused.query_edge_split(3, 17, 4, 4, 300, False, 18 * walk,
                                   slots=4) == 2
    nwk, by, ref_by, _ = _problem(10, 300, 19, "t6")
    _, p = _placers(nwk, ref_by)
    queries = {"a": by["t6"], "b": ref_by["t1"], "c": ref_by["t8"]}
    whole = p.place_batch(queries)
    calls = []

    def traversal(*a, **k):
        calls.append(a[2].shape[0])
        return tfused.fused_traversal(*a, **k)

    def launches(step):
        e = len(p.edges)
        return [min(step, e - e0) for e0 in range(0, e, step)]

    p._traversal = traversal
    p._launch_bytes = 18 * walk
    p.place_batch(queries)
    assert calls == launches(6)
    monkeypatch.setattr(tfused, "query_spill_slots", lambda *a: 4)
    calls.clear()
    split = p.place_batch(queries)
    assert calls == launches(2)
    for q in queries:
        assert split[q] == whole[q]


def test_query_form_refuses_a_single_table():
    p, tables, pmat, tips, qc, n_slots = _query_inputs(4, q_n=1)
    with pytest.raises(ValueError, match="query form"):
        tfused.fused_traversal(tips, pmat[0], tables[0], rates=4, states=4,
                               n_slots=n_slots, threshold=1e-3, factor=2.0,
                               query_codes=qc, query_row=p.query_row)
