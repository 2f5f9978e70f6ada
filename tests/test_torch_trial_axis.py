"""The trial axis of the level and pool kernels (ROADMAP B-3b) in the
PyTorch port, on the CPU: the trial forms' plain versions, and the model
trials of `TreeEngine._trial_loglikelihoods` on 'levels-kernel' and
'pool-pallas', which run them.

libpll2_tpu/optimize.py:366 vmaps `eval_one` over the trials, which wraps
the Pallas level kernel (pallas_partials.py:48) on a 'levels-kernel' engine
and would wrap the pool kernel (pallas_repeats.py:45) on a pooled one. The
port's trial forms give each trial its own P-matrices, rows and scaler rows
in one launch (the tips shared on the level kernel), and their plain
versions batch over the trials in PyTorch. Tolerances:
  * a trial form's plain version against a loop over the trials of the
    one-topology plain version, float64: equal (the same einsum per trial,
    batched), scaler rows equal;
  * the engine's 'levels-kernel' trials in float32 against JAX's
    `make_fused_loglikelihood_fn` on a `pallas="levels-interpret"` engine
    (JAX's vmapped level kernel in interpret mode): TOL_LOGL 5e-5
    (bench_validate.py:61-63);
  * in float64 against JAX's `pallas=False` engine: 1e-12 (summation order
    only);
  * 'pool-pallas' in float64 against JAX's dense twin: 1e-10 (JAX's pooled
    engine raises NameError, ROADMAP C);
  * chunked against whole: 1e-13.
Every construction passes device="cpu": the wrappers run their plain
versions for CPU tensors."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu import compute_gamma_cats as j_gamma_cats
from libpll2_tpu import optimize as jopt
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.models import load_aa_model as j_load_aa_model
from libpll2_tpu.trees import random_utree as j_random_utree

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import convert
from libpll2_tpu_torch import engine as tengine
from libpll2_tpu_torch import optimize as topt
from libpll2_tpu_torch.io import maps
from libpll2_tpu_torch.models import load_aa_model
from libpll2_tpu_torch.ops import eigen as teigen
from libpll2_tpu_torch.ops import levels as tlevels
from libpll2_tpu_torch.ops import pmatrix as tpmatrix
from libpll2_tpu_torch.ops import pool as tpool
from libpll2_tpu_torch.trees import (create_operations, parse_newick,
                                     random_utree, traverse)
from libpll2_tpu_torch.utils import simulate_alignment

CPU = "cpu"
F64, F32 = torch.float64, torch.float32
TOL_LOGL = 5e-5                                # bench_validate.py:61-63
SEED = 29
FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1.0, 2.5, 0.8, 1.2, 3.0, 1.0]
ASC_WEIGHTS = [50, 40, 60, 20]
# the float32 window (scale threshold and factor): 2^-32 and 2^32
F32_WINDOW = (2.0 ** -32, 2.0 ** 32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small problems: the test workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _caterpillar(n, length=0.1):
    text = f"t{n - 1}:{length}"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:{length},{text}):{length}"
    return parse_newick(f"(t0:{length},t1:{length},{text});")


def _alignment(tree, sites, states, seed=SEED, variable=False):
    """{label: sequence} simulated on `tree` (only non-constant columns
    with `variable`, as an asc-corrected alignment holds)."""
    rng = np.random.default_rng(seed)
    freqs = FREQS if states == 4 else rng.dirichlet(np.ones(20) * 5)
    subst = (SUBST if states == 4
             else rng.uniform(0.5, 2.0, states * (states - 1) // 2))
    n = sites * 4 if variable else sites
    headers, seqs = simulate_alignment(tree, n, freqs, subst, alpha=0.9,
                                       seed=seed)
    if variable:
        cols = np.array([list(s) for s in seqs])
        keep = np.flatnonzero((cols != cols[:1]).any(axis=0))[:sites]
        seqs = ["".join(r) for r in cols[:, keep]]
    return dict(zip(headers, seqs))


# case -> (tree, sites, states, rates, partition options)
CASES = {
    "dna": ("random", 96, 4, 4, {}),
    "aa20": ("random", 48, 20, 4, {}),
    "per_rate": ("random", 96, 4, 4, {"rate_scalers": True}),
    "no_scaler": ("random", 96, 4, 4, {}),
    "caterpillar": ("caterpillar", 64, 4, 4, {}),
    "raw_tips": ("random", 96, 4, 4, {}),
    "asc": ("random", 64, 4, 4, {"asc": "STAMATAKIS"}),
}


def _problem(case, repeats=False, dtype=F64):
    """A port partition of `case` on the CPU, its tree and op list. 'raw_tips'
    sets two tips from raw values (set_tip_clv); 'no_scaler' drops the
    scaler buffers of every other inner node (ops without a scaler, and
    children read through the zero row)."""
    kind, sites, states, rates, opts = CASES[case]
    n = 40 if kind == "caterpillar" else 12
    tree = (_caterpillar(n) if kind == "caterpillar"
            else random_utree([f"t{i}" for i in range(n)], seed=SEED))
    by = _alignment(tree, sites, states, variable="asc" in opts)
    asc = opts.get("asc")
    part = tp.Partition(
        tree.tip_count, tree.inner_count, states, sites, 1, tree.edge_count,
        rates, tree.inner_count, device=CPU, dtype=dtype,
        rate_scalers=opts.get("rate_scalers", False),
        site_repeats=repeats,
        asc_bias=getattr(tp.AscBias, asc or "NONE"))
    cm = maps.map_nt if states == 4 else maps.map_aa
    tips = list(tree.tips())
    for tip in tips:
        part.set_tip_states(tip.clv_index, cm, by[tip.label])
    if case == "raw_tips":
        rng = np.random.default_rng(3)
        for tip in tips[1:3]:
            part.set_tip_clv(tip.clv_index,
                             rng.uniform(0.05, 1.0, (sites, states)))
    if asc:
        part.set_asc_state_weights(ASC_WEIGHTS)
    part.set_category_rates(tp.compute_gamma_cats(0.9, rates))
    ops, branches, pidx = create_operations(traverse(tree.vroot))
    if case == "no_scaler":
        dropped = {op.parent_clv_index for op in ops[::2]}
        for op in ops:
            if op.parent_clv_index in dropped:
                op.parent_scaler_index = -1
            if op.child1_clv_index in dropped:
                op.child1_scaler_index = -1
            if op.child2_clv_index in dropped:
                op.child2_scaler_index = -1
    return tree, part, ops, branches, pidx


def _models(states, k, seed):
    """K random models as (eigenvals [K, 1, s], inv_evecs, evecs) and
    frequencies [K, 1, s], float64."""
    rng = np.random.default_rng(seed)
    subst = torch.tensor(rng.uniform(0.5, 3.0,
                                     (k, states * (states - 1) // 2)))
    freqs = torch.tensor(rng.dirichlet([5.0] * states, k))
    w, evecs, ivecs = teigen.update_eigen_torch(subst, freqs)
    return (w[:, None], ivecs[:, None], evecs[:, None]), freqs[:, None]


def _trial_pmatrices(part, branches, pidx, k, seed=5):
    """P [K, E, R, s, s] of K random models on the op list's branches."""
    (w, ivecs, evecs), _ = _models(part.states, k, seed)
    blen = torch.zeros(part.prob_matrices, dtype=F64)
    blen[torch.as_tensor(pidx)] = torch.as_tensor(branches, dtype=F64)
    rates = torch.as_tensor(part.rates, dtype=F64)
    return tpmatrix.update_prob_matrices_trials(
        w, ivecs, evecs, torch.zeros(1, dtype=F64), rates,
        torch.zeros(part.rate_cats, dtype=torch.long), blen)


def _window(part, case):
    """(threshold, factor): the float32 window on the caterpillar, where it
    makes the float64 rows rescale, else the partition's own."""
    if case == "caterpillar":
        return F32_WINDOW
    return part.scale_threshold, part.scale_factor


# ------------------------------------------------- the plain trial forms
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_level_trial_form_equals_a_loop(case, k):
    """update_partials_kernel's trial form (the level kernel's plain
    version, one call a level for all K trials, the tips shared) equals K
    one-topology traversals of the plain version, each on a copy of the
    partition's buffers: every parent row and scaler row equal in float64.
    The trial buffers start as NaN and -7 but for the rows `trial_rows`
    names: no other row is read before it is written."""
    _, part, ops, branches, pidx = _problem(case)
    pmat = _trial_pmatrices(part, branches, pidx, k)
    thr, fac = _window(part, case)
    tables = tlevels.pack_pallas_levels(ops, part.tips,
                                        part.scale_buffers + 1,
                                        part.scale_buffers)
    base, rows, sc_rows = tlevels.trial_rows(tables, part.tips)
    assert base == part.tips and rows.size == 0
    assert list(sc_rows) == [part.scale_buffers + 1]  # the zero row
    clv = torch.full((k, part.clv.shape[0] - base) + part.clv.shape[1:],
                     float("nan"), dtype=F64)
    sc = torch.full((k,) + part.scale_buffer.shape, -7, dtype=torch.int32)
    sc[:, sc_rows] = part.scale_buffer[sc_rows]
    tlevels.update_partials_kernel(clv, sc, pmat, tables, thr, fac,
                                   tips=part.clv[:base])
    parents = sorted({op.parent_clv_index for op in ops})
    # the trash row, which scaler-less ops write, is never read
    trash = part.scale_buffers
    written = sorted({t for tb in tables for t in tb[7]} - {trash})
    rescaled = 0
    for i in range(k):
        c, s = part.clv.clone(), part.scale_buffer.clone()
        tlevels.update_partials_kernel(c, s, pmat[i], tables, thr, fac)
        for p in parents:
            assert torch.equal(clv[i, p - base], c[p]), (i, p)
        assert torch.equal(sc[i, written], s[written])
        rescaled += int(s[written].sum())
    if case == "caterpillar":
        assert rescaled > 0
    if case == "no_scaler":
        assert any(trash in tb[7] for tb in tables)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pool_trial_form_equals_a_loop(case, k):
    """update_partials_pool's trial form on a site-repeats partition (the
    pool kernel's plain version, one call a level for all K trials, each
    trial its own copy of the pools) equals K one-topology traversals of
    the plain version: pools and scaler pools equal in float64."""
    _, part, ops, branches, pidx = _problem(case, repeats=True)
    assert part.repeats is not None
    plan = part._pool_plan(ops, True)
    pmat = _trial_pmatrices(part, branches, pidx, k)
    thr, fac = _window(part, case)
    pool = part.clv_flat.expand(k, *part.clv_flat.shape).contiguous()
    sc = part.sc_flat.expand(k, *part.sc_flat.shape).contiguous()
    tpool.update_partials_pool(pool, sc, pmat, plan, thr, fac)
    rescaled = 0
    for i in range(k):
        c, s = part.clv_flat.clone(), part.sc_flat.clone()
        tpool.update_partials_pool(c, s, pmat[i], plan, thr, fac)
        assert torch.equal(pool[i], c), i
        assert torch.equal(sc[i], s), i
        rescaled += int(s.sum())
    if case == "caterpillar":
        assert rescaled > 0


def test_trial_rows_of_a_partial_traversal():
    """A partial op list reads inner rows and scaler rows that it does not
    write: `trial_rows` names them (and the root edge's), so that the
    trial buffers start from the partition's; a parent below the tips
    lowers the base."""
    tree = random_utree([f"t{i}" for i in range(10)], seed=SEED)
    ops, _, _ = create_operations(traverse(tree.vroot))
    n_tips, k = tree.tip_count, tree.inner_count
    tables = tlevels.pack_pallas_levels(ops[-3:], n_tips, k + 1, k)
    base, rows, sc_rows = tlevels.trial_rows(tables, n_tips,
                                             root_rows=(n_tips + k,),
                                             root_scalers=(k + 1,))
    writes = {op.parent_clv_index for op in ops[-3:]}
    reads = {c for op in ops[-3:] for c in (op.child1_clv_index,
                                            op.child2_clv_index)
             if c >= n_tips and c not in writes}
    assert base == n_tips
    assert set(rows.tolist()) == reads | {n_tips + k}
    assert (k + 1) in sc_rows.tolist()
    low = copy.copy(ops[0])
    low.parent_clv_index = 2
    base, _, _ = tlevels.trial_rows(
        tlevels.pack_pallas_levels([low], n_tips, k + 1, k), n_tips)
    assert base == 2


def test_level_trial_form_refuses_a_shared_parent():
    """The trial form writes only the trials' own rows: a parent below the
    shared rows is refused."""
    _, part, ops, branches, pidx = _problem("dna")
    pmat = _trial_pmatrices(part, branches, pidx, 2)
    tables = tlevels.pack_pallas_levels(ops, part.tips,
                                        part.scale_buffers + 1,
                                        part.scale_buffers)
    clv = torch.zeros((2, part.clv.shape[0] - 4) + part.clv.shape[1:],
                      dtype=F64)
    sc = torch.zeros((2,) + part.scale_buffer.shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared"):
        tlevels.update_partials_kernel(
            clv, sc, pmat, tables[-1:], part.scale_threshold,
            part.scale_factor, tips=part.clv[:part.clv.shape[0] - 1])


# ------------------------------------------------- the engine's trials
def _pair(states, sites, dtype, jpallas, tpallas, n=8, repeats=False,
          seed=SEED):
    """The same problem as a JAX and a port engine: (JAX engine, port
    engine). The JAX engine holds dense buffers (its pooled engine cannot
    run the trial route: ROADMAP C)."""
    labels = [f"t{i}" for i in range(n)]
    by = _alignment(random_utree(labels, seed=seed), sites, states,
                    seed=seed)
    out = []
    for jax_side in (True, False):
        tree = (j_random_utree if jax_side else random_utree)(labels,
                                                               seed=seed)
        if jax_side:
            part = JPartition(n, n - 2, states, sites, 1, 2 * n - 3, 4,
                              n - 2, dtype="float64" if dtype == F64
                              else "float32")
            cm, gamma, load = jmaps.map_nt, j_gamma_cats, j_load_aa_model
        else:
            part = tp.Partition(n, n - 2, states, sites, 1, 2 * n - 3, 4,
                                n - 2, device=CPU, dtype=dtype,
                                site_repeats=repeats)
            cm, gamma, load = maps.map_nt, tp.compute_gamma_cats, \
                load_aa_model
        if states == 20:
            cm = jmaps.map_aa if jax_side else maps.map_aa
        for tip in tree.tips():
            part.set_tip_states(tip.clv_index, cm, by[tip.label])
        if states == 20:
            load(part, "lg")
        else:
            part.set_frequencies(0, [0.26, 0.24, 0.25, 0.25])
            part.set_subst_params(0, [1.0, 1.1, 0.9, 1.05, 0.95, 1.0])
        part.set_category_rates(gamma(0.9, 4))
        out.append((JTreeEngine if jax_side else tp.TreeEngine)(
            part, tree, pallas=jpallas if jax_side else tpallas))
    return out


def _groups(states):
    return ("subst", "freqs") if states == 4 else ("freqs",)


def _rows(x0, k, seed=3, scale=0.1):
    """K flat parameter vectors around x0 (numpy)."""
    x0 = np.asarray(x0, np.float64)
    return x0[None] + np.random.default_rng(seed).normal(0, scale,
                                                         (k, x0.size))


@pytest.mark.parametrize("states", [4, 20])
def test_levels_kernel_trials_f32_match_jax_interpret(states):
    """make_fused_loglikelihood_fn in float32 on 'levels-kernel' (the level
    kernel's trial form, its plain version on the CPU), 8 taxa x 256 sites
    and K = 3 trials, against JAX's on a pallas="levels-interpret" engine,
    whose vmap runs its Pallas level kernel in interpret mode: TOL_LOGL."""
    je, te = _pair(states, 256, F32, "levels-interpret", "levels-kernel")
    assert je.execution_path == te.execution_path == "levels-kernel"
    groups = _groups(states)
    jfn, jx0, _ = jopt.make_fused_loglikelihood_fn(je, groups)
    tfn, tx0, _ = topt.make_fused_loglikelihood_fn(te, groups)
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), rtol=1e-6)
    X = _rows(jx0, 3)
    want = np.asarray(jfn(jnp.asarray(X, jnp.float32)), np.float64)
    got = tfn(convert.flat_from_jax(X, device=CPU, dtype=F32))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_LOGL)


@pytest.mark.parametrize("states", [4, 20])
def test_levels_kernel_trials_f64_match_jax(states):
    """The same trials in float64 on 'levels-kernel' against JAX's
    pallas=False engine: 1e-12."""
    je, te = _pair(states, 160, F64, False, "levels-kernel")
    assert te.execution_path == "levels-kernel"
    groups = _groups(states)
    jfn, jx0, _ = jopt.make_fused_loglikelihood_fn(je, groups)
    tfn, _, _ = topt.make_fused_loglikelihood_fn(te, groups)
    X = _rows(jx0, 5)
    want = np.asarray(jfn(jnp.asarray(X)), np.float64)
    got = tfn(convert.flat_from_jax(X, device=CPU, dtype=F64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("states", [4, 20])
def test_pool_pallas_trials_match_jax_dense_twin(states):
    """make_fused_loglikelihood_fn in float64 on the port's 'pool-pallas'
    engine (the pool kernel's trial form, its plain version on the CPU)
    against JAX's on a dense pallas=False twin: 1e-10. JAX's own trials on
    its pooled engine raise NameError: libpll2_tpu/optimize.py:298 calls
    `_repeats_loglikelihood`, which :35 does not import (ROADMAP C)."""
    je, te = _pair(states, 130, F64, False, "pool", repeats=True)
    assert te.execution_path == "pool-pallas"
    groups = _groups(states)
    jfn, jx0, _ = jopt.make_fused_loglikelihood_fn(je, groups)
    tfn, _, _ = topt.make_fused_loglikelihood_fn(te, groups)
    X = _rows(jx0, 4)
    want = np.asarray(jfn(jnp.asarray(X)), np.float64)
    got = tfn(convert.flat_from_jax(X, device=CPU, dtype=F64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    labels = [f"t{i}" for i in range(8)]
    tree = j_random_utree(labels, seed=SEED)
    jp = JPartition(8, 6, 4, 130, 1, 13, 4, 6, site_repeats=True,
                    dtype="float64")
    by = _alignment(random_utree(labels, seed=SEED), 130, 4)
    for tip in tree.tips():
        jp.set_tip_states(tip.clv_index, jmaps.map_nt, by[tip.label])
    jpooled = JTreeEngine(jp, tree, pallas="pool")
    assert jpooled.repeats_mode
    with pytest.raises(NameError, match="_repeats_loglikelihood"):
        jopt.maximize_fused(jpooled, ("freqs",), steps=1, chunk=1)


def _count(monkeypatch, module, name, trial_dim, calls):
    """Wrap module.name so that each call records the trials of its first
    argument (its leading size in the trial form, `trial_dim` dimensions;
    None for a one-topology call)."""
    orig = getattr(module, name)

    def counted(x, *a, **kw):
        calls.append(x.shape[0] if x.dim() == trial_dim else None)
        return orig(x, *a, **kw)
    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("path", ["levels-kernel", "pool-pallas", "pool"])
def test_one_trial_form_call_a_level_a_chunk(monkeypatch, path):
    """5 trials on 'levels-kernel', 'pool-pallas' and the plain pooled path
    'pool': one call of the trial form's plain version a level for the
    whole chunk (K = 5); under a byte budget that holds two trials, three
    chunks (2, 2, 1) and a call a level each, and the values do not depend
    on the chunking (1e-13)."""
    repeats = path != "levels-kernel"
    _, te = _pair(4, 160, F64, False,
                  {"levels-kernel": "levels-kernel", "pool-pallas": "pool",
                   "pool": False}[path], repeats=repeats)
    assert te.execution_path == path
    calls = []
    if repeats:
        n_levels = len(te._ops.tables)
        _count(monkeypatch, tpool, "pool_update_reference", 3, calls)
    else:
        n_levels = len(te._ops)
        _count(monkeypatch, tlevels, "level_update_reference", 4, calls)
    fnb, x0, _ = topt.make_fused_loglikelihood_fn(te, ("subst", "freqs"))
    X = torch.as_tensor(_rows(x0.numpy(), 5, scale=0.05))
    calls.clear()
    assert te.trial_chunk() >= 5
    whole = fnb(X)
    assert calls == [5] * n_levels
    monkeypatch.setattr(tengine, "TRIAL_LAUNCH_BYTES",
                        2 * te.trial_bytes() + 1)
    assert te.trial_chunk() == 2
    calls.clear()
    chunked = fnb(X)
    assert calls == [2] * n_levels + [2] * n_levels + [1] * n_levels
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-13)


@pytest.mark.parametrize("path", ["levels-kernel", "pool-pallas"])
@pytest.mark.parametrize("mode", ["edge_params", "asc", "per_rate"])
def test_trials_per_trial_modes(path, mode):
    """Per-edge P (`edge_params`, two rate matrices alternating by edge,
    through update_prob_matrices_trials' per-edge table), asc-corrected
    synthetic columns and per-rate scalers on the trial forms: each of
    K = 3 trials against its model set on the partition and
    `loglikelihood()` (1e-12, float64), the buffers left as they were."""
    repeats = path == "pool-pallas"
    tree = random_utree([f"t{i}" for i in range(10)], seed=SEED)
    asc = mode == "asc"
    by = _alignment(tree, 120, 4, variable=asc)
    m = 2 if mode == "edge_params" else 1
    part = tp.Partition(10, 8, 4, 120, m, tree.edge_count, 4, 8, device=CPU,
                        dtype=F64, site_repeats=repeats,
                        rate_scalers=mode == "per_rate",
                        asc_bias=tp.AscBias.LEWIS if asc
                        else tp.AscBias.NONE)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
    for i in range(m):
        part.set_frequencies(i, FREQS)
        part.set_subst_params(i, SUBST)
    part.set_category_rates(tp.compute_gamma_cats(0.9, 4))
    kw = {}
    if mode == "edge_params":
        kw["edge_params"] = np.arange(tree.edge_count) % 2
    eng = tp.TreeEngine(part, tree, pallas="pool" if repeats
                        else "levels-kernel", **kw)
    assert eng.execution_path == path
    (w, ivecs, evecs), freqs = _models(4, 3 * m, 8)
    eigen = tuple(a.reshape(3, m, *a.shape[2:]) for a in (w, evecs, ivecs))
    freqs = freqs.reshape(3, m, 4)
    bufs = ((part.clv_flat, part.sc_flat) if repeats
            else (part.clv, part.scale_buffer))
    before = [b.clone() for b in bufs]
    got = eng._trial_loglikelihoods(eigen, freqs)
    for b, b0 in zip(bufs, before):
        assert torch.equal(b, b0)
    rng = np.random.default_rng(8)
    subst = rng.uniform(0.5, 3.0, (3 * m, 6))
    fr = rng.dirichlet([5.0] * 4, 3 * m)
    want = []
    for i in range(3):
        for j in range(m):
            part.set_subst_params(j, subst[i * m + j])
            part.set_frequencies(j, fr[i * m + j])
        want.append(eng.loglikelihood())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("asc", [None, "LEWIS"])
def test_levels_kernel_trials_under_a_mesh(monkeypatch, asc):
    """'levels-kernel' trials on a partition sharded over 3 CPU shards
    (sites_alignment 3; Lewis's synthetic columns in the last shard's
    block): one call of the trial form's plain version a level a shard,
    and the reduced [K] against the unsharded engine's at 1e-12."""
    from libpll2_tpu_torch.parallel import make_mesh, shard_partition

    tree = random_utree([f"t{i}" for i in range(10)], seed=SEED)
    by = _alignment(tree, 150, 4, variable=asc is not None)
    engines = []
    for n in (3, None):
        part = tp.Partition(10, 8, 4, 150, 1, tree.edge_count, 4, 8,
                            device=CPU, dtype=F64, sites_alignment=n or 1,
                            asc_bias=getattr(tp.AscBias, asc or "NONE"))
        for tip in tree.tips():
            part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
        part.set_frequencies(0, FREQS)
        part.set_subst_params(0, SUBST)
        part.set_category_rates(tp.compute_gamma_cats(0.9, 4))
        if n:
            shard_partition(part, make_mesh(devices=[CPU] * n))
        engines.append(tp.TreeEngine(part, tree, pallas="levels-kernel"))
    sharded, single = engines
    assert sharded.execution_path == single.execution_path == \
        "levels-kernel"
    (w, ivecs, evecs), freqs = _models(4, 4, 12)
    eigen = (w, evecs, ivecs)
    calls = []
    _count(monkeypatch, tlevels, "level_update_reference", 4, calls)
    got = sharded._trial_loglikelihoods(eigen, freqs)
    assert calls == [4] * (3 * len(single._ops))
    want = single._trial_loglikelihoods(eigen, freqs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
