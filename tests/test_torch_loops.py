"""The k-chained loops, `loglikelihood_loop(k)` and `newton_loop(k)`, of
the port's TreeEngine and ShardedRepeatsEngine against libpll2_tpu's on the
CPU.

Partitions are built in JAX from seeded random or simulated DNA (and a
20-state protein) and carried over with libpll2_tpu_torch.convert, so both
packages loop over the same inputs. In float64 every route of the port
('fused', 'levels-kernel', 'levels', 'scan'; over site repeats
'repeats-dense-fused', 'pool-pallas', 'pool') is held against JAX's
pallas=False engine at 1e-12 relative in logL, 1e-10 in d1/d2 and 1e-12 in
the branches; in float32 one case a kernel (#1, #2, #3, #5: the port's
plain versions on the CPU) against JAX's Pallas kernels in interpret mode
at TOL_LOGL / TOL_D1 / ATOL_D1 (bench_validate.py:61-63). Sharded engines
run on CPU meshes: ShardedRepeatsEngine's pooled shards against JAX's
sharded loops, a sharded TreeEngine and the dense-fused shards against the
port's unsharded loop. k = 0 must leave every buffer bit for bit as it was
(JAX's `_scatter_if_ran`, and tests/test_heterotachy.py's
test_loop_k0_preserves_root_rows mirrored). On the card the loops capture
one iteration in a CUDA graph: `choose_loop` is pinned here, the graph in
the gpu tests (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu as jx
from libpll2_tpu import parallel as jpar
from libpll2_tpu import models as jmodels
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.trees import random_alignment, random_utree
from libpll2_tpu.utils.simulate import simulate_alignment

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import convert
from libpll2_tpu_torch.engine import choose_loop
from libpll2_tpu_torch.parallel import (ShardedRepeatsEngine, make_mesh,
                                        shard_partition)

TOL_LOGL, TOL_D1, ATOL_D1 = 5e-5, 5e-3, 5e-2
K = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small problems (the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_partition(tree, by, sites, dtype, states=4, repeats=False, lo=0):
    jp = jx.Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                      tree.edge_count, 4, tree.inner_count, dtype=dtype,
                      site_repeats=repeats)
    cm = jmaps.map_nt if states == 4 else jmaps.map_aa
    for tip in tree.tips():
        jp.set_tip_states(tip.clv_index, cm, by[tip.label][lo:lo + sites])
    if states == 20:
        jmodels.load_aa_model(jp, "lg")
    else:
        jp.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
        jp.set_subst_params(0, [1.0, 2.0, 1.0, 1.0, 2.0, 1.0])
    jp.set_category_rates(jx.compute_gamma_cats(0.8, 4))
    return jp


def _port(jp):
    state = {k: getattr(jp, k) for k in convert.STATE_KEYS}
    state["_invariant_valid"] = jp._invariant_valid
    if jp.repeats is not None:
        state.update({k: getattr(jp, k, None) for k in convert.REPEATS_KEYS})
    dtype = torch.float64 if jp.dtype == jnp.float64 else torch.float32
    return convert.partition_from_numpy(state, device="cpu", dtype=dtype)


def _problem(repeats=False, states=4, sites=160, seed=23):
    """(tree, alignment by label): 12 taxa of random columns, or of columns
    simulated on the tree with short branches (site repeats)."""
    if repeats:
        tree = random_utree([f"t{i}" for i in range(12)], seed=seed)
        headers, seqs = simulate_alignment(tree, sites, [0.3, 0.2, 0.2, 0.3],
                                           [1.0, 2.0, 1.0, 1.0, 2.0, 1.0],
                                           alpha=0.8, seed=seed)
    else:
        alphabet = "ACGT" if states == 4 else "ARNDCQEGHILKMFPSTWYV"
        headers, seqs = random_alignment(12, sites, alphabet=alphabet,
                                         seed=seed)
        tree = random_utree(headers, seed=seed)
    return tree, dict(zip(headers, seqs))


def _loops(eng, k=K):
    """(loglikelihood_loop(k), newton_loop(k), the branches after it)."""
    acc = eng.loglikelihood_loop(k)
    nl = eng.newton_loop(k)
    return acc, nl, np.asarray(eng.branches.cpu() if torch.is_tensor(
        eng.branches) else eng.branches, dtype=np.float64)


def _close(got, want, rl=1e-12, rd=1e-10, rb=1e-12, ad=1e-9):
    np.testing.assert_allclose(got[0], want[0], rtol=rl)
    np.testing.assert_allclose(got[1][0], want[1][0], rtol=rl)
    np.testing.assert_allclose(got[1][1:], want[1][1:], rtol=rd, atol=ad)
    np.testing.assert_allclose(got[2], want[2], rtol=rb, atol=rb)


@pytest.fixture(scope="module")
def dense64():
    """The dense float64 problem and JAX's loops on it (pallas=False)."""
    tree, by = _problem()
    jp = _jax_partition(tree, by, 160, jnp.float64)
    return tree, jp, _loops(jx.TreeEngine(jp, tree, pallas=False))


@pytest.fixture(scope="module")
def repeats64():
    """The site-repeats float64 problem and JAX's loops on it."""
    tree, by = _problem(repeats=True, sites=320, seed=29)
    jp = _jax_partition(tree, by, 320, jnp.float64, repeats=True)
    je = jx.TreeEngine(jp, tree, pallas=False)
    assert je.repeats_mode
    return tree, by, jp, _loops(je)


def test_choose_loop_routes():
    """One card in one process (a mesh of shards of one card too) takes the
    graph; the CPU, processes and several cards take the eager loop."""
    assert choose_loop(["cuda:0"]) == "graph"
    assert choose_loop(["cuda:0"] * 4) == "graph"
    assert choose_loop(["cuda:1", "cuda:1"]) == "graph"
    assert choose_loop(["cuda:0"], multiprocess=True) == "eager"
    assert choose_loop(["cuda:0", "cuda:1"]) == "eager"
    assert choose_loop(["cpu"]) == "eager"
    assert choose_loop(["cpu"] * 4) == "eager"
    assert choose_loop(["cpu", "cuda:0"]) == "eager"


@pytest.mark.parametrize("route", ["fused", "levels-kernel", "levels",
                                   "scan"])
def test_dense_loops_match_jax_float64(dense64, route):
    """Every dense route's loops against JAX's float64 XLA engine."""
    tree, jp, want = dense64
    kw = {"fused": {}, "levels-kernel": dict(pallas="levels-kernel"),
          "levels": dict(pallas=False),
          "scan": dict(pallas=False, level_schedule=False)}[route]
    eng = tp.TreeEngine(_port(jp), tree, **kw)
    assert eng.execution_path == route
    got = _loops(eng)
    _close(got, want)
    assert eng._last_loop.route == "eager" and eng._last_loop.k == K


@pytest.mark.parametrize("route", ["repeats-dense-fused", "pool-pallas",
                                   "pool"])
def test_repeats_loops_match_jax_float64(repeats64, route):
    """Every site-repeats route's loops against JAX's float64 pooled
    engine; the pools are updated as JAX's loop leaves them."""
    tree, _, jp, want = repeats64
    pallas = {"repeats-dense-fused": "auto", "pool-pallas": "pool",
              "pool": False}[route]
    eng = tp.TreeEngine(_port(jp), tree, pallas=pallas)
    assert eng.execution_path == route
    _close(_loops(eng), want)


def _float32_pair(kernel):
    """(JAX engine on its Pallas kernel in interpret mode, the port's
    engine on the same partition) for one kernel."""
    states = 20 if kernel == "rows" else 4
    tree, by = _problem(repeats=kernel == "pool", states=states,
                        sites=96 if states == 20 else 160,
                        seed=29 if kernel == "pool" else 23)
    jp = _jax_partition(tree, by, 96 if states == 20 else 160, jnp.float32,
                        states=states, repeats=kernel == "pool")
    jkw, tkw, path = {
        "fused": ("interpret", "auto", "fused"),
        "rows": ("interpret", "auto", "fused"),
        "levels": ("levels-interpret", "levels-kernel", "levels-kernel"),
        "pool": ("pool-interpret", "pool", "pool-pallas")}[kernel]
    je = jx.TreeEngine(jp, tree, pallas=jkw)
    te = tp.TreeEngine(_port(jp), tree, pallas=tkw)
    assert te.execution_path == path
    return je, te


@pytest.mark.parametrize("kernel", ["fused", "rows", "levels", "pool"])
def test_float32_loops_match_jax_kernels(kernel):
    """Kernels #1 (DNA fused), #2 (the 20-state rows kernel), #3 (level)
    and #5 (pool): the port's loops against JAX's on its Pallas kernel in
    interpret mode, two iterations each."""
    je, te = _float32_pair(kernel)
    want, got = _loops(je, 2), _loops(te, 2)
    _close(got, want, rl=TOL_LOGL, rd=TOL_D1, rb=1e-6, ad=ATOL_D1)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("pallas", ["auto", "levels-kernel"])
def test_sharded_loops_match_unsharded(dense64, n, pallas):
    """A TreeEngine on an n-shard CPU mesh (its fused or level kernel's
    plain version once a shard an iteration, the psum in every iteration)
    against the port's unsharded loops, in float64; every shard's root rows
    written back as the unsharded engine's."""
    tree, jp, _ = dense64
    ref = tp.TreeEngine(_port(jp), tree, pallas=pallas)
    part = _port(jp)
    shard_partition(part, make_mesh(devices=["cpu"] * n))
    eng = tp.TreeEngine(part, tree, pallas=pallas)
    _close(_loops(eng), _loops(ref))
    if pallas == "auto":
        r = ref.root_idx
        for e, lo in zip(eng._shards.engines, range(0, 160, 160 // n)):
            for row in (r[0], r[2]):
                np.testing.assert_allclose(
                    e.partition.clv[row].numpy(),
                    ref.partition.clv[row][..., lo:lo + 160 // n].numpy(),
                    rtol=1e-12)


def _repeat_parts(tree, by, n, dtype, pkg):
    w = 320 // n
    jps = [_jax_partition(tree, by, w, jnp.float64 if dtype == torch.float64
                          else jnp.float32, repeats=True, lo=k * w)
           for k in range(n)]
    return jps if pkg == "jax" else [_port(p) for p in jps]


def test_sharded_repeats_loops_match_jax(repeats64):
    """ShardedRepeatsEngine's pooled shards (float64, 2 shards) against
    JAX's sharded repeats loops on its CPU mesh (tests/test_parallel_m6.py:
    273, 360)."""
    tree, by, _, _ = repeats64
    eng = ShardedRepeatsEngine(tree, _repeat_parts(tree, by, 2,
                                                   torch.float64, "port"),
                               make_mesh(devices=["cpu"] * 2))
    jeng = jpar.ShardedRepeatsEngine(
        tree, _repeat_parts(tree, by, 2, torch.float64, "jax"),
        jpar.make_mesh(2))
    assert eng.execution_path == "pool-pallas"
    _close(_loops(eng), _loops(jeng))


def test_sharded_dense_fused_loops_match_unsharded(repeats64):
    """ShardedRepeatsEngine's dense-fused shards (float32, 4 shards, the
    fused kernel's plain version once a shard) against the port's
    unsharded dense-fused loops on the same columns."""
    tree, by, _, _ = repeats64
    eng = ShardedRepeatsEngine(tree, _repeat_parts(tree, by, 4,
                                                   torch.float32, "port"),
                               make_mesh(devices=["cpu"] * 4))
    assert eng.dense_fused
    ref = tp.TreeEngine(_port(_jax_partition(tree, by, 320, jnp.float32,
                                             repeats=True)), tree)
    assert ref.execution_path == "repeats-dense-fused"
    _close(_loops(eng), _loops(ref), rl=1e-6, rd=1e-4, rb=1e-6, ad=1e-3)


def _buffers(eng):
    units = eng._units()
    out = [eng.branches.clone()]
    for e in units:
        p = e.partition
        if p.repeats is not None:
            out += [p.clv_flat.clone(), p.sc_flat.clone()]
        else:
            out += [p.clv.clone(), p.scale_buffer.clone()]
        out.append(p.pmatrix.clone())
    return out


@pytest.mark.parametrize("case", ["fused", "levels-kernel", "scan",
                                  "repeats-dense-fused", "pool-pallas",
                                  "sharded", "sharded-repeats"])
def test_k0_leaves_every_buffer(dense64, repeats64, case):
    """loglikelihood_loop(0) is 0.0 and newton_loop(0) (0.0, 0.0, 0.0),
    and neither touches a buffer, a P-matrix or the branches (a negative
    k too, as JAX's fori_loop runs no trip)."""
    tree, jp, _ = dense64
    if case == "sharded-repeats":
        rtree, by, _, _ = repeats64
        eng = ShardedRepeatsEngine(rtree, _repeat_parts(
            rtree, by, 2, torch.float64, "port"),
            make_mesh(devices=["cpu"] * 2))
    elif case in ("repeats-dense-fused", "pool-pallas"):
        rtree, _, rjp, _ = repeats64
        eng = tp.TreeEngine(_port(rjp), rtree, pallas="auto"
                            if case == "repeats-dense-fused" else "pool")
    else:
        part = _port(jp)
        if case == "sharded":
            shard_partition(part, make_mesh(devices=["cpu"] * 2))
        eng = tp.TreeEngine(part, tree, pallas={
            "levels-kernel": "levels-kernel", "scan": False}.get(case, "auto"),
            level_schedule=case != "scan")
    eng.loglikelihood()
    before = _buffers(eng)
    for k in (0, -2):
        assert eng.loglikelihood_loop(k) == 0.0
        assert eng.newton_loop(k) == (0.0, 0.0, 0.0)
    for got, want in zip(_buffers(eng), before):
        assert torch.equal(got, want)


def test_loop_k0_preserves_root_rows():
    """tests/test_heterotachy.py::test_loop_k0_preserves_root_rows on the
    port: a float32 fused engine's stored root row survives
    loglikelihood_loop(0) and newton_loop(0) bit for bit, and a loop that
    runs writes the root rows back once, as a loglikelihood() call
    would."""
    tree, by = _problem(seed=47)
    jp = _jax_partition(tree, by, 160, jnp.float32)
    part = _port(jp)
    eng = tp.TreeEngine(part, tree)
    assert eng.use_fused
    lk = eng.loglikelihood()
    root_row = part.clv[tree.vroot.clv_index].clone()
    assert float(root_row.abs().sum()) > 0
    assert eng.loglikelihood_loop(0) == 0.0
    assert eng.newton_loop(0) == (0.0, 0.0, 0.0)
    assert torch.equal(part.clv[tree.vroot.clv_index], root_row)
    part.clv[tree.vroot.clv_index] = 0.0
    np.testing.assert_allclose(eng.loglikelihood_loop(2), 2 * lk, rtol=1e-6)
    assert torch.equal(part.clv[tree.vroot.clv_index], root_row)


def test_fused_newton_loop_writes_jax_root_rows(dense64):
    """After newton_loop the fused path's root rows hold the last
    iteration's, as JAX's loop scatters them (float64, against JAX's
    XLA engine's rows, 1e-12)."""
    tree, jp, _ = dense64
    jp2 = _jax_partition(tree, _problem()[1], 160, jnp.float64)
    je = jx.TreeEngine(jp2, tree, pallas=False)
    part = _port(jp2)
    eng = tp.TreeEngine(part, tree)
    assert eng.execution_path == "fused"
    je.newton_loop(2)
    eng.newton_loop(2)
    r = eng.root_idx
    for row in (r[0], r[2]):
        np.testing.assert_allclose(part.clv[row].numpy(),
                                   np.asarray(jp2.clv[row]), rtol=1e-12,
                                   atol=1e-300)
