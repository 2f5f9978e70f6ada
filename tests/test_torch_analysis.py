"""An analysis from an alignment file on the port, against libpll2_tpu on
the CPU: the native site-repeats classer (native/pllnative.cpp through
repeats.py), bootstrap (bootstrap.py), checkpoint (checkpoint.py), and a
small-size rehearsal of chip_smoke.py's phase 22 end to end.

Tolerances: classes `==` (native, the numpy fallback and JAX's native
classer); bootstrap replicates, reloaded logLs and the rehearsal's logLs in
float64 against JAX's `pallas=False` engine to 1e-12 relative (the two
differ in summation order only); a checkpoint's stored arrays `==`. Every
construction passes device="cpu"."""
import os

import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu import checkpoint as jcheckpoint
from libpll2_tpu import compute_gamma_cats as j_gamma_cats
from libpll2_tpu import constants as JC
from libpll2_tpu import io as jio
from libpll2_tpu import native as jnative
from libpll2_tpu.bootstrap import bootstrap_loglikelihoods as j_boot
from libpll2_tpu.bootstrap import bootstrap_weights as j_weights
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.parsimony import FastParsimony as JFast
from libpll2_tpu.parsimony.stepwise import fastparsimony_stepwise as j_step
from libpll2_tpu.trees import export_newick as j_newick
from libpll2_tpu.trees import parse_newick as j_parse_newick
from libpll2_tpu.trees import random_utree as j_random_utree
from libpll2_tpu.trees.utree import \
    reset_template_indices as j_reset_template_indices

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import checkpoint, native
from libpll2_tpu_torch import constants as C
from libpll2_tpu_torch import io as tio
from libpll2_tpu_torch.bootstrap import bootstrap_weights, persite_lnl
from libpll2_tpu_torch.io import maps
from libpll2_tpu_torch.parsimony import FastParsimony
from libpll2_tpu_torch.parsimony.stepwise import fastparsimony_stepwise
from libpll2_tpu_torch.repeats import _first_occurrence_classes
from libpll2_tpu_torch.trees import export_newick, parse_newick, random_utree
from libpll2_tpu_torch.trees.utree import reset_template_indices
from libpll2_tpu_torch.utils import simulate_alignment

CPU = "cpu"
F64 = torch.float64
FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1, 2.2, 0.8, 1.1, 2.6, 1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=16, sites=384, seed=55, scale=1.0):
    """tests/test_bootstrap.py's problem: labels and {label: sequence}."""
    labels = [f"t{i}" for i in range(n)]
    tree = random_utree(labels, seed=seed)
    if scale != 1.0:
        for nd in tree.nodes():
            for h in ([nd] if nd.is_tip() else list(nd.ring())):
                if h.back is not None:
                    h.length = h.back.length = h.length * scale
    headers, seqs = simulate_alignment(tree, sites, FREQS, SUBST,
                                       alpha=0.9, seed=seed)
    return labels, dict(zip(headers, seqs))


def _partition(jax_side, tree, by, asc=None, repeats=False, sites=None,
               weights=None, dtype="float64"):
    """The same partition in either package, float64 on the CPU."""
    sites = sites or len(next(iter(by.values())))
    kw = {}
    if asc is not None:
        kw["asc_bias"] = asc
    if jax_side:
        P, cm, gamma = JPartition, jmaps.map_nt, j_gamma_cats
        kw["dtype"] = dtype
    else:
        P, cm, gamma = tp.Partition, maps.map_nt, tp.compute_gamma_cats
        kw.update(device=CPU, dtype=getattr(torch, dtype))
    part = P(tree.tip_count, tree.inner_count, 4, sites, 1, tree.edge_count,
             4, tree.inner_count, site_repeats=repeats, **kw)
    for t in tree.tips():
        part.set_tip_states(t.clv_index, cm, by[t.label])
    part.set_frequencies(0, FREQS)
    part.set_subst_params(0, SUBST)
    part.set_category_rates(gamma(0.9, 4))
    if weights is not None:
        part.set_pattern_weights(weights)
    if asc is not None:
        part.set_asc_state_weights([3, 2, 2, 3])
    return part


def _pair(labels, by, seed=55, **kw):
    """(JAX engine, JAX tree, port engine, port tree), pallas=False."""
    jt, tt = j_random_utree(labels, seed=seed), random_utree(labels,
                                                             seed=seed)
    je = JTreeEngine(_partition(True, jt, by, **kw), jt, pallas=False)
    te = tp.TreeEngine(_partition(False, tt, by, **kw), tt, pallas=False)
    return je, jt, te, tt


# ------------------------------------------------------------- the classer
def test_native_classer_equals_numpy_and_jax():
    """repeats_tips / repeats_update: the port's native classes `==` its
    numpy fallback and JAX's native classer, on random codes with few and
    with many classes; the caller's lookup buffer is left all -1."""
    assert native.load() is not None and jnative.load() is not None
    r = np.random.default_rng(4)
    for sites, k in ((5000, 3), (4465, 60), (300, 1000)):
        codes = r.integers(1, k + 1, sites).astype(np.uint64)
        got = native.repeats_tips(codes)
        for want in (_first_occurrence_classes(codes),
                     jnative.repeats_tips(codes)):
            assert got[2] == want[2]
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        li, ri = int(got[2]), k
        right = r.integers(0, ri, sites).astype(np.int32)
        lookup = np.full(li * ri, -1, np.int32)
        got = native.repeats_update(got[0], right, li, li * ri, lookup)
        assert np.all(lookup == -1)
        left = native.repeats_tips(codes)[0]
        want_np = _first_occurrence_classes(
            left.astype(np.int64) + right.astype(np.int64) * li)
        want_jax = jnative.repeats_update(left, right, li, li * ri)
        for want in (want_np, want_jax):
            assert got[2] == want[2]
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        native.repeats_update(left, right, li, li * ri,
                              np.full(3, -1, np.int32))


@pytest.mark.parametrize("use_native", [True, False])
def test_repeats_tables_equal_jax(monkeypatch, use_native):
    """A repeats partition's class tables after an evaluation (every tip
    and op) `==` JAX's, through the native classer and through the numpy
    fallback it takes without the library; the logLs agree to 1e-12."""
    labels, by = _data(24, 600, 8, scale=0.15)
    if not use_native:
        monkeypatch.setattr(native, "load", lambda: None)
    je, _, te, _ = _pair(labels, by, repeats=True)
    assert te.partition.repeats is not None and je.repeats_mode
    tl, jl = te.loglikelihood(), je.loglikelihood()
    assert tl == pytest.approx(jl, rel=1e-12)
    jt, tt = je.partition.repeats, te.partition.repeats
    np.testing.assert_array_equal(tt.ids, jt.ids)
    np.testing.assert_array_equal(tt.site_id, jt.site_id)
    for node in range(tt.nodes):
        n = int(tt.ids[node]) or tt.sites
        np.testing.assert_array_equal(tt.id_site[node, :n],
                                      jt.id_site[node, :n])
    assert int((tt.ids > 0).sum()) > tt.nodes // 2


# --------------------------------------------------------------- bootstrap
@pytest.mark.parametrize("case", ["plain", "lewis", "repeats",
                                  "compressed"])
def test_bootstrap_equals_jax(case):
    """bootstrap_loglikelihoods in float64 `==` JAX's weights and its
    replicates to 1e-12, each replicate also against a re-evaluation
    through set_pattern_weights (after tests/test_bootstrap.py:45-70)."""
    labels, by = _data()
    kw = {"lewis": dict(asc=C.AscBias.LEWIS),
          "repeats": dict(repeats=True)}.get(case, {})
    if case == "compressed":
        seqs, weights, _ = tio.compress_site_patterns(list(by.values()),
                                                      maps.map_nt)
        by = dict(zip(by, seqs))
        kw = dict(weights=weights)
    je, _, te, tt = _pair(labels, by, **kw)
    jl, jw = j_boot(je, 6, seed=3)
    tl, tw = tp.bootstrap_loglikelihoods(te, 6, seed=3)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_allclose(tl, jl, rtol=1e-12)
    lnl, base = persite_lnl(te)
    assert (base != 0.0) == (case == "lewis")
    part = te.partition
    orig = part.pattern_weights[:part.sites].copy()
    for r in range(3):
        part.set_pattern_weights(tw[r].astype(np.int64))
        assert te.loglikelihood() == pytest.approx(tl[r], rel=1e-12)
    part.set_pattern_weights(orig)
    np.testing.assert_array_equal(
        bootstrap_weights(orig, 4, seed=9), j_weights(orig, 4, seed=9))
    given = tp.bootstrap_loglikelihoods(te, 0, weights=tw[:2])
    np.testing.assert_allclose(given[0], tl[:2], rtol=1e-12)


@pytest.mark.parametrize("asc", [C.AscBias.FELSENSTEIN,
                                 C.AscBias.STAMATAKIS])
def test_bootstrap_refuses_nonlinear_asc_like_jax(asc):
    labels, by = _data()
    je, _, te, _ = _pair(labels, by, asc=asc)
    with pytest.raises(JC.PllError) as jerr:
        j_boot(je, 2)
    with pytest.raises(C.PllError) as terr:
        tp.bootstrap_loglikelihoods(te, 2)
    assert terr.value.errno == jerr.value.errno == C.ERROR_PARAM_INVALID
    assert str(terr.value) == str(jerr.value)


# -------------------------------------------------------------- checkpoint
@pytest.mark.parametrize("case", ["plain", "clvs", "lewis", "repeats",
                                  "raw_tips"])
def test_checkpoint_crosses_packages(tmp_path, case):
    """A JAX-written file loads in the port and a port-written file loads
    in JAX: the same logL to 1e-12 in float64, the stored arrays `==`, the
    extras kept (after tests/test_checkpoint.py)."""
    labels, by = _data(12, 200, 5)
    kw = {"lewis": dict(asc=C.AscBias.LEWIS),
          "repeats": dict(repeats=True)}.get(case, {})
    je, jt, te, tt = _pair(labels, by, seed=5, **kw)
    if case == "raw_tips":
        probs = np.random.default_rng(2).dirichlet(np.ones(4), 200)
        for eng in (je, te):
            eng.partition.set_tip_clv(3, probs)
        je = JTreeEngine(je.partition, jt, pallas=False)
        te = tp.TreeEngine(te.partition, tt, pallas=False)
    jl, tl = je.loglikelihood(), te.loglikelihood()
    assert tl == pytest.approx(jl, rel=1e-12)
    clvs = case == "clvs"
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jcheckpoint.save(jpath, je.partition, jt, include_clvs=clvs, step=3,
                     best=jl)
    checkpoint.save(tpath, te.partition, tt, include_clvs=clvs, step=3,
                    best=tl)
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for k in jz.files:
            if k not in ("newick", "x_best", "clv", "scale_buffer"):
                np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
        assert tz["dtype"].item() == b"float64"
    p2, t2, ex = checkpoint.load(jpath, device=CPU)
    assert int(ex["step"]) == 3 and float(ex["best"]) == jl
    assert p2.device.type == "cpu" and p2.dtype == F64
    if clvs:
        np.testing.assert_array_equal(p2.clv.numpy(),
                                      np.asarray(je.partition.clv))
        np.testing.assert_array_equal(p2.scale_buffer.numpy(),
                                      np.asarray(je.partition.scale_buffer))
    assert tp.TreeEngine(p2, t2, pallas=False).loglikelihood() == \
        pytest.approx(jl, rel=1e-12)
    jp2, jt2, jex = jcheckpoint.load(tpath)
    assert float(jex["best"]) == tl
    if clvs:
        np.testing.assert_array_equal(np.asarray(jp2.clv),
                                      te.partition.clv.numpy())
        np.testing.assert_array_equal(np.asarray(jp2.scale_buffer),
                                      te.partition.scale_buffer.numpy())
    assert JTreeEngine(jp2, jt2, pallas=False).loglikelihood() == \
        pytest.approx(tl, rel=1e-12)


def test_checkpoint_rebinds_tips_by_label(tmp_path):
    """A tree whose tip rows do not follow newick parse order (a stepwise
    tree) restores to the same logL; duplicate labels keep the parse-order
    binding (after tests/test_checkpoint.py:68-136)."""
    labels, by = _data(12, 200, 5)
    tree = random_utree(labels, seed=5)
    perm = np.random.default_rng(3).permutation(tree.tip_count)
    for i, tip in enumerate(tree.tips()):
        tip.clv_index = tip.node_index = int(perm[i])
    eng = tp.TreeEngine(_partition(False, tree, by), tree, pallas=False)
    lk = eng.loglikelihood()
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, eng.partition, tree)
    p2, t2, _ = checkpoint.load(path, device=CPU)
    assert tp.TreeEngine(p2, t2, pallas=False).loglikelihood() == \
        pytest.approx(lk, rel=1e-12)
    jp2, jt2, _ = jcheckpoint.load(path)
    assert JTreeEngine(jp2, jt2, pallas=False).loglikelihood() == \
        pytest.approx(lk, rel=1e-12)
    tips = list(tree.tips())
    tips[1].label = tips[0].label
    checkpoint.save(path, eng.partition, tree)
    with np.load(path) as z:
        assert "tip_labels" not in z.files


def test_checkpoint_save_is_atomic_and_loads_float32(tmp_path,
                                                    monkeypatch):
    """The save leaves no temporary files, even when it fails; a float32
    file reloads as float64 with its CLVs dropped; a bad version is
    refused."""
    labels, by = _data(10, 120, 6)
    tree = random_utree(labels, seed=6)
    part = _partition(False, tree, by, dtype="float32")
    lk = tp.TreeEngine(part, tree).loglikelihood()
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, part, tree, include_clvs=True)
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
    def broken(fh, **payload):
        fh.write(b"partial")
        raise OSError("disk full")

    with monkeypatch.context() as m:
        m.setattr(checkpoint.np, "savez_compressed", broken)
        with pytest.raises(OSError):
            checkpoint.save(str(tmp_path / "bad.npz"), part, tree)
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]
    p32, t32, _ = checkpoint.load(path, device=CPU)
    assert p32.dtype == torch.float32 and torch.equal(p32.clv, part.clv)
    assert bool(p32.clv[part.tips:].any())
    p64, t64, _ = checkpoint.load(path, dtype=F64, device=CPU)
    assert p64.dtype == F64 and not bool(p64.clv[part.tips:].any())
    assert tp.TreeEngine(p64, t64, pallas=False).loglikelihood() == \
        pytest.approx(lk, rel=5e-5)
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    data["version"] = np.int64(2)
    np.savez(path, **data)
    with pytest.raises(ValueError):
        checkpoint.load(path, device=CPU)


# --------------------------------------------- phase 22 at a small size
def test_analysis_path_equals_jax(tmp_path):
    """chip_smoke.py's phase 22 at 24 taxa x 400 sites against JAX's
    pipeline (examples/full_analysis.py's first steps): the files read
    back equal, the patterns and weights `==`, the stepwise tree and cost
    `==` (native and Python), the dense and the site-repeats logL, the
    invariant-site count, the bootstrap replicates and the reloaded logL
    against JAX's float64 engine at 1e-12."""
    n, sites, seed = 24, 400, 7
    labels = [f"t{i}" for i in range(n)]
    tree = random_utree(labels, seed=seed)
    for nd in tree.nodes():
        for h in ([nd] if nd.is_tip() else list(nd.ring())):
            if h.back is not None:
                h.length = h.back.length = max(h.length * 0.3, 0.004)
    headers, seqs = simulate_alignment(tree, sites, FREQS, SUBST,
                                       alpha=0.8, seed=seed)
    fas, phy = str(tmp_path / "a.fas"), str(tmp_path / "a.phy")
    with open(fas, "w") as fh:
        fh.writelines(f">{h}\n{s[:70]}\n{s[70:]}\n"
                      for h, s in zip(headers, seqs))
    with open(phy, "w") as fh:
        fh.write(f"{n} {sites}\n")
        for i in range(0, sites, 60):
            fh.writelines((f"{h:<10}" if i == 0 else "") + s[i:i + 60]
                          + "\n" for h, s in zip(headers, seqs))
    for read in (lambda m: m.load_fasta(fas),
                 lambda m: m.parse_phylip(phy, interleaved=True)):
        assert read(tio) == read(jio) == (headers, seqs)

    comp, w, _ = tio.compress_site_patterns(seqs, maps.map_nt)
    jcomp, jw, _ = jio.compress_site_patterns(seqs, jmaps.map_nt)
    assert comp == jcomp and np.array_equal(w, jw) and len(comp[0]) < sites

    trees = []
    for jax_side in (True, False):
        P = JPartition if jax_side else tp.Partition
        kw = {} if jax_side else {"device": CPU}
        pars = P(n, n - 2, 4, len(comp[0]), 1, 2 * n - 3, 1, n - 2, **kw)
        pars.set_tip_states_batch(jmaps.map_nt if jax_side else maps.map_nt,
                                  comp)
        pars.set_pattern_weights(w)
        if jax_side:
            trees.append(j_step([JFast(pars)], headers, seed))
        else:
            fp = FastParsimony(pars)
            trees.append(fastparsimony_stepwise([fp], headers, seed))
            loop = fastparsimony_stepwise([fp], headers, seed,
                                          use_native=False)
            assert loop[1] == trees[-1][1]
            assert export_newick(loop[0].vroot) == \
                export_newick(trees[-1][0].vroot)
    (jtree, jcost), (ttree, tcost) = trees
    assert tcost == jcost and export_newick(ttree.vroot) == \
        j_newick(jtree.vroot)

    engines = []
    for jax_side, t in ((True, jtree), (False, ttree)):
        seen = set()
        for nd in t.nodes():
            for h in ([nd] if nd.is_tip() else list(nd.ring())):
                if h.back is not None and id(h) not in seen:
                    seen.update((id(h), id(h.back)))
                    h.length = h.back.length = 0.1
        (j_reset_template_indices if jax_side
         else reset_template_indices)(t.vroot, t.tip_count)
        by = dict(zip(headers, comp))
        dense = _partition(jax_side, t, by, weights=w)
        rep = _partition(jax_side, t, by, weights=w, repeats=True)
        E = JTreeEngine if jax_side else tp.TreeEngine
        engines.append((E(dense, t, pallas=False),
                        E(rep, t, pallas="pool" if not jax_side else False),
                        t))
    (jd, jr, jt), (td, tr, tt) = engines
    jl = jd.loglikelihood()
    assert td.loglikelihood() == pytest.approx(jl, rel=1e-12)
    assert tr.execution_path == "pool-pallas"
    assert tr.loglikelihood() == pytest.approx(jr.loglikelihood(),
                                               rel=1e-12)
    assert tr.loglikelihood() == pytest.approx(jl, rel=1e-12)
    assert td.partition.count_invariant_sites() == \
        jd.partition.count_invariant_sites() > 0

    jb, jwb = j_boot(jd, 50, seed=seed)
    tb, twb = tp.bootstrap_loglikelihoods(td, 50, seed=seed)
    np.testing.assert_array_equal(twb, jwb)
    np.testing.assert_allclose(tb, jb, rtol=1e-12)

    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, td.partition, tt, include_clvs=True,
                    logl=td.loglikelihood())
    p2, t2, ex = checkpoint.load(path, device=CPU)
    jp2, jt2, _ = jcheckpoint.load(path)
    assert float(ex["logl"]) == pytest.approx(jl, rel=1e-12)
    assert tp.TreeEngine(p2, t2, pallas=False).loglikelihood() == \
        pytest.approx(jl, rel=1e-12)
    assert JTreeEngine(jp2, jt2, pallas=False).loglikelihood() == \
        pytest.approx(jl, rel=1e-12)
    assert export_newick(t2.vroot) == j_newick(
        j_parse_newick(export_newick(tt.vroot), unroot=True).vroot)
    assert parse_newick(export_newick(tt.vroot), unroot=True).tip_count == n
