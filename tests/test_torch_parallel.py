"""Site sharding on the port (`libpll2_tpu_torch.parallel`) against
libpll2_tpu.parallel on the CPU.

conftest.py gives JAX 8 virtual CPU devices, so JAX's meshes exist here;
the port's meshes name the CPU once a shard (`make_mesh(devices=["cpu"] *
n)`). Inputs are simulated from seeds with the port's simulator and fed to
both packages. In float64 the sharded port must equal the sharded JAX
package (JAX's GSPMD paths, pallas=False or 'auto' on a CPU mesh) to 1e-12
in logL and 1e-10 in d1/d2, and the unsharded port likewise at every shard
count; in float32 the port's plain kernels against JAX's Pallas kernels in
interpret mode under the mesh at TOL_LOGL 5e-5 / TOL_D1 5e-3 / ATOL_D1 5e-2
(bench_validate.py:61-63). A shard's per-site values and scaler counts equal
the unsharded run's columns. Searches must accept JAX's moves and end at
its logL to 1e-9 (float64).

The port runs 'levels-kernel' under a mesh where JAX runs 'levels' (its
level kernel has no mesh form): a routing difference with the same numbers
(ROADMAP, Rules of the port)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu as jx
from libpll2_tpu import constants as JC
from libpll2_tpu import optimize as jopt
from libpll2_tpu import parallel as jpar
from libpll2_tpu import search as jsearch
from libpll2_tpu import trees as jtrees
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.ops import pallas_fused as jfused

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import constants as C
from libpll2_tpu_torch import optimize as topt
from libpll2_tpu_torch import parallel
from libpll2_tpu_torch import trees as ttrees
from libpll2_tpu_torch.io import maps
from libpll2_tpu_torch.ops import fused as tfused
from libpll2_tpu_torch.parallel import (ShardedRepeatsEngine, make_mesh,
                                        shard_partition)
from libpll2_tpu_torch.parallel.sharding import Mesh, psum
from libpll2_tpu_torch.search import TreeSearch, _internal_edges
from libpll2_tpu_torch.utils import simulate_alignment
from torch_example_lines import assert_same_lines, jax_example

TOL_LOGL, TOL_D1, ATOL_D1 = 5e-5, 5e-3, 5e-2
FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1.0, 2.0, 1.0, 1.0, 2.0, 1.0]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small problems (the test workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n_taxa=12, sites=300, seed=9, perturb=0, states=4):
    """Labels, a tree of each package (the same topology from one seed,
    `perturb` seeded NNI moves away from the simulating tree) and the
    alignment by label, simulated on the unperturbed tree."""
    labels = [f"t{i}" for i in range(n_taxa)]
    f = np.full(states, 1.0 / states) if states != 4 else FREQS
    subst = (SUBST if states == 4 else np.random.default_rng(seed)
             .uniform(0.5, 2.0, states * (states - 1) // 2))
    headers, seqs = simulate_alignment(ttrees.random_utree(labels, seed=seed),
                                       sites, f, subst, alpha=0.8, seed=seed)
    trees = []
    for pkg, edges_of in ((jtrees, jsearch._internal_edges),
                          (ttrees, _internal_edges)):
        tree = pkg.random_utree(labels, seed=seed)
        rng = np.random.default_rng(1)
        for _ in range(perturb):
            edges = edges_of(tree)
            pkg.moves.nni(edges[rng.integers(len(edges))],
                          C.UTREE_MOVE_NNI_LEFT, None)
        trees.append(tree)
    return trees[0], trees[1], dict(zip(headers, seqs)), subst, f


def _jax(tree, by, sites, mesh_n=None, dtype=jnp.float64, asc=None,
         repeats=False, rate_scalers=False, lo=0, states=4, subst=SUBST,
         freqs=FREQS, cats=4):
    p = jx.Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, cats, tree.inner_count, dtype=dtype,
                     asc_bias=getattr(JC.AscBias, asc or "NONE"),
                     sites_alignment=mesh_n or 1, site_repeats=repeats,
                     rate_scalers=rate_scalers)
    _fill(p, tree, by, sites, lo, jmaps, jx.compute_gamma_cats, asc, states,
          subst, freqs, cats)
    if mesh_n:
        jpar.shard_partition(p, jpar.make_mesh(mesh_n))
    return p


def _port(tree, by, sites, mesh_n=None, dtype=torch.float64, asc=None,
          repeats=False, rate_scalers=False, lo=0, states=4, subst=SUBST,
          freqs=FREQS, cats=4, device="cpu"):
    p = tp.Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, cats, tree.inner_count, dtype=dtype,
                     asc_bias=getattr(C.AscBias, asc or "NONE"),
                     sites_alignment=mesh_n or 1, site_repeats=repeats,
                     rate_scalers=rate_scalers, device=device)
    _fill(p, tree, by, sites, lo, maps, tp.compute_gamma_cats, asc, states,
          subst, freqs, cats)
    if mesh_n:
        shard_partition(p, make_mesh(devices=["cpu"] * mesh_n))
    return p


def _fill(p, tree, by, sites, lo, mp, gamma, asc, states, subst, freqs,
          cats):
    cm = mp.map_nt if states == 4 else mp.map_aa
    for tip in tree.tips():
        p.set_tip_states(tip.clv_index, cm, by[tip.label][lo:lo + sites])
    p.set_frequencies(0, freqs)
    p.set_subst_params(0, subst)
    p.set_category_rates(gamma(0.8, cats))
    if asc in ("FELSENSTEIN", "STAMATAKIS"):
        p.set_asc_state_weights([50, 40, 60, 20])


def _close(got, want, rtol_l=1e-12, rtol_d=1e-10):
    """(logL, d1, d2) tuples at the float64 budgets."""
    np.testing.assert_allclose(got[0], want[0], rtol=rtol_l)
    np.testing.assert_allclose(got[1:], want[1:], rtol=rtol_d, atol=1e-9)


# ------------------------------------------------------------ the mesh
def test_mesh_helpers():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.axis_names == (parallel.SITES_AXIS,)
    assert parallel.owned_shards(mesh) == 4
    assert not parallel.is_multiprocess(mesh)
    assert parallel.clv_sharding(mesh).axis == 3
    assert parallel.scaler_sharding(mesh, True).axis == 2
    assert parallel.scaler_sharding(mesh, False).axis == 1
    assert parallel.site_vector_sharding(mesh).axis == 0
    assert parallel.replicated(mesh).axis is None
    x = np.arange(24.0).reshape(2, 12)
    blocks = parallel.put_global(x, mesh, (None, parallel.SITES_AXIS))
    assert [tuple(b.shape) for b in blocks] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(blocks, 1).numpy(), x)
    reps = parallel.put_global(x, mesh, parallel.replicated(mesh))
    assert all(np.array_equal(r.numpy(), x) for r in reps)
    with pytest.raises(ValueError):
        parallel.put_global(np.zeros(10), mesh, (parallel.SITES_AXIS,))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()
    # a two-process mesh seen from rank 0: one owned shard, its index
    two = Mesh(["cpu", "cpu"], owners=[0, 1])
    two.rank = 0
    assert parallel.is_multiprocess(two)
    assert parallel.owned_shards(two) == 1 and two.first_owned == 0


def test_psum_adds_in_shard_order_and_devices_keep_their_index():
    """The reduction is the shard-order left fold, whatever the values'
    magnitudes; the kernels' per-device plans key on the index a CUDA
    device names (pure Python, no card needed)."""
    from libpll2_tpu_torch.ops._kernels import _device_index

    mesh = make_mesh(devices=["cpu"] * 3)
    parts = [torch.tensor([1e16, 1.0], dtype=torch.float64),
             torch.tensor([1.0, -1e16], dtype=torch.float64),
             torch.tensor([-1e16, 1e16], dtype=torch.float64)]
    got = psum(parts, mesh)
    want = (parts[0] + parts[1]) + parts[2]
    assert torch.equal(got, want)
    assert _device_index(torch.device("cuda", 1)) == 1
    assert _device_index("cuda:3") == 3


# --------------------------------------------------- the fused main path
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_count_invariance(n):
    """float64 at 12 x 300: the sharded port against the unsharded port
    (per-site values equal column for column) and against JAX's sharded
    engine, logL and two Newton steps."""
    jt, tt, by, *_ = _problem()
    ref = tp.TreeEngine(_port(tt, by, 300), tt)
    eng = tp.TreeEngine(_port(tt, by, 300, mesh_n=n), tt)
    assert eng.execution_path == ref.execution_path == "fused"
    assert len(eng._shards.engines) == n
    total, per = eng.loglikelihood_persite()
    rtotal, rper = ref.loglikelihood_persite()
    np.testing.assert_allclose(total, rtotal, rtol=1e-12)
    np.testing.assert_allclose(per[:300], rper, rtol=1e-13, atol=0)
    assert not per[300:].any()
    je = jx.TreeEngine(_jax(jt, by, 300, mesh_n=n), jt)
    assert je.fused_mesh is not None
    np.testing.assert_allclose(total, je.loglikelihood(), rtol=1e-12)
    for _ in range(2):
        got = eng.newton_step()
        _close(got, je.newton_step())
        _close(got, ref.newton_step())
    np.testing.assert_allclose(eng.branches.numpy(), ref.branches.numpy(),
                               rtol=1e-12)
    for e in eng._shards.engines:
        assert torch.equal(e.branches, eng.branches)


def test_float32_against_jax_fused_kernel_under_mesh():
    """float32, 4 shards: the port's plain fused version against JAX's
    fused kernel under shard_map in interpret mode; each shard's root rows
    and scaler counts equal the unsharded run's columns."""
    jt, tt, by, *_ = _problem(sites=256)
    je = jx.TreeEngine(_jax(jt, by, 256, mesh_n=4, dtype=jnp.float32), jt,
                       pallas="interpret")
    assert je.execution_path == "fused" and je.fused_mesh is not None
    eng = tp.TreeEngine(_port(tt, by, 256, mesh_n=4, dtype=torch.float32),
                        tt)
    ref = tp.TreeEngine(_port(tt, by, 256, dtype=torch.float32), tt)
    np.testing.assert_allclose(eng.loglikelihood(), je.loglikelihood(),
                               rtol=TOL_LOGL)
    lk, d1, d2 = eng.newton_step()
    jl, jd1, jd2 = je.newton_step()
    np.testing.assert_allclose(lk, jl, rtol=TOL_LOGL)
    np.testing.assert_allclose([d1, d2], [jd1, jd2], rtol=TOL_D1,
                               atol=ATOL_D1)
    _, _, rows = ref._evaluate()
    _, _, shard_rows = eng._shards.evaluate(ref.branches)
    for k, sr in enumerate(shard_rows):
        cols = slice(64 * k, 64 * (k + 1))
        for got, want in zip(sr, rows):
            assert torch.equal(got, want[..., cols])


@pytest.mark.parametrize("asc,sites,n", [("LEWIS", 156, 8),
                                         ("FELSENSTEIN", 156, 8),
                                         ("STAMATAKIS", 156, 8),
                                         ("LEWIS", 17, 4)])
def test_asc_under_mesh(asc, sites, n):
    """The asc columns where JAX's global layout puts them: 156 + 4 = 160 =
    8 x 20 (test_parallel_m6.py:98-123), and 17 + 4 padded to 24 over 4
    shards, whose synthetic columns straddle two shards. The corrections
    are reduced from the shards' partial sums."""
    jt, tt, by, *_ = _problem(sites=sites)
    eng = tp.TreeEngine(_port(tt, by, sites, mesh_n=n, asc=asc), tt)
    if (sites, n) == (17, 4):
        lo = [sh.lo for sh in eng.partition.shards]
        assert lo == [0, 6, 12, 18]        # columns 17-20 in two shards
    ref = tp.TreeEngine(_port(tt, by, sites, asc=asc), tt)
    je = jx.TreeEngine(_jax(jt, by, sites, mesh_n=n, asc=asc), jt,
                       pallas=False)
    got = eng.loglikelihood()
    np.testing.assert_allclose(got, ref.loglikelihood(), rtol=1e-12)
    np.testing.assert_allclose(got, je.loglikelihood(), rtol=1e-12)
    got = eng.newton_step()
    _close(got, ref.newton_step())
    _close(got, je.newton_step())


def test_per_rate_scalers_under_mesh():
    """Per-rate scalers shard like per-site ones; above 8 categories JAX
    leaves the fused kernel under a mesh (libpll2_tpu/engine.py:835-837)
    and so does the port, to the level kernel."""
    jt, tt, by, *_ = _problem(sites=200)
    eng = tp.TreeEngine(_port(tt, by, 200, mesh_n=4, rate_scalers=True), tt)
    je = jx.TreeEngine(_jax(jt, by, 200, mesh_n=4, rate_scalers=True), jt)
    _close(eng.newton_step(), je.newton_step())
    many = tp.TreeEngine(_port(tt, by, 200, mesh_n=4, rate_scalers=True,
                               cats=9), tt)
    assert many.execution_path == "levels-kernel"
    assert tp.TreeEngine(_port(tt, by, 200, rate_scalers=True, cats=9),
                         tt).execution_path == "fused"
    jmany = jx.TreeEngine(_jax(jt, by, 200, mesh_n=4, rate_scalers=True,
                               cats=9), jt)
    assert not jmany.use_fused
    np.testing.assert_allclose(many.loglikelihood(), jmany.loglikelihood(),
                               rtol=1e-12)


def test_fused_under_mesh_unaligned_sites():
    """JAX's test_fused_under_mesh_unaligned_sites: 1000 DNA columns over 8
    shards (125 each) and 648 amino-acid columns (81 each) run the fused
    kernels' shard launches, no grain padding, at JAX's tolerances against
    its unsharded plain engine."""
    for states, sites in ((4, 1000), (20, 648)):
        jt, tt, by, subst, f = _problem(n_taxa=10, sites=sites, seed=41,
                                        states=states)
        kw = dict(states=states, subst=subst, freqs=f)
        want = jx.TreeEngine(_jax(jt, by, sites, dtype=jnp.float32, **kw),
                             jt, pallas=False).loglikelihood()
        eng = tp.TreeEngine(_port(tt, by, sites, mesh_n=8,
                                  dtype=torch.float32, **kw), tt,
                            mxu="highest")
        assert eng.use_fused and eng.partition.shards[0].sites_padded \
            == sites // 8
        np.testing.assert_allclose(eng.loglikelihood(), want,
                                   rtol=2e-6 if states == 4 else 1e-5)
        assert np.isfinite(eng.newton_step()).all()


def test_persite_posteriors_and_candidates_under_mesh():
    """loglikelihood_persite and site_rate_posteriors concatenate the
    shards in order; candidates (evaluate_topologies, pack_candidate +
    evaluate_packed) reduce the shards' [K] sums, against JAX's meshed
    engine."""
    jt, tt, by, *_ = _problem(sites=240)
    eng = tp.TreeEngine(_port(tt, by, 240, mesh_n=4), tt)
    ref = tp.TreeEngine(_port(tt, by, 240), tt)
    je = jx.TreeEngine(_jax(jt, by, 240, mesh_n=4), jt)
    np.testing.assert_allclose(eng.loglikelihood_persite()[1],
                               np.asarray(je.loglikelihood_persite()[1]),
                               rtol=1e-12, atol=1e-13)
    for got, want in zip(eng.site_rate_posteriors(),
                         ref.site_rate_posteriors()):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    cands, jcands, packed = [], [], []
    for (tree, store, pkg) in ((tt, cands, ttrees), (jt, jcands, jtrees)):
        for edge in (_internal_edges if pkg is ttrees
                     else jsearch._internal_edges)(tree)[:3]:
            rb = pkg.moves.Rollback()
            pkg.moves.nni(edge, C.UTREE_MOVE_NNI_LEFT, rb)
            vr = tree.vroot
            ops, br, pidx = pkg.create_operations(pkg.traverse(vr))
            store.append((ops, br, pidx, (vr.clv_index, vr.scaler_index,
                                          vr.back.clv_index,
                                          vr.back.scaler_index,
                                          vr.pmatrix_index)))
            if pkg is ttrees:
                packed.append(eng.pack_candidate(vr))
            pkg.moves.rollback_move(rb)
    want = np.asarray(je.evaluate_topologies(jcands))
    np.testing.assert_allclose(eng.evaluate_topologies(cands), want,
                               rtol=1e-12)
    np.testing.assert_allclose(eng.evaluate_packed(packed), want,
                               rtol=1e-12)
    np.testing.assert_allclose(ref.evaluate_topologies(cands), want,
                               rtol=1e-12)


# ---------------------------------------------- step by step, level kernel
def test_step_by_step_under_mesh():
    """The step-by-step API on a sharded partition, once a shard and
    reduced: P-matrices, a full then a partial op list, the edge and root
    likelihoods with per-site values, the sumtable and derivatives with a
    Lewis correction, ancestral states, CLVs and scalers, against JAX's
    sharded partition and the unsharded port."""
    jt, tt, by, *_ = _problem(sites=156)
    parts = [_jax(jt, by, 156, mesh_n=4, asc="LEWIS"),
             _port(tt, by, 156, mesh_n=4, asc="LEWIS"),
             _port(tt, by, 156, asc="LEWIS")]
    results = []
    for p, tree, pkg in zip(parts, (jt, tt, tt), (jtrees, ttrees, ttrees)):
        ops, br, pidx = pkg.create_operations(pkg.traverse(tree.vroot))
        r = tree.vroot
        edge = (r.clv_index, r.scaler_index, r.back.clv_index,
                r.back.scaler_index, r.pmatrix_index, [0] * 4)
        p.update_prob_matrices([0] * 4, pidx, br)
        p.update_partials(ops)
        out = [p.compute_edge_loglikelihood(*edge, persite=True)]
        p.update_prob_matrices([0] * 4, [pidx[-1]], [br[-1] * 1.7])
        p.update_partials(ops[-3:])
        out.append(p.compute_edge_loglikelihood(*edge, persite=True))
        out.append(p.compute_root_loglikelihood(r.clv_index, r.scaler_index,
                                                [0] * 4, persite=True))
        st = p.update_sumtable(r.clv_index, r.back.clv_index,
                               r.scaler_index, r.back.scaler_index, [0] * 4)
        out.append(p.compute_likelihood_derivatives(
            st, [0] * 4, 0.13, r.scaler_index, r.back.scaler_index))
        out.append(p.compute_node_ancestral(r.clv_index, r.scaler_index,
                                            r.back.clv_index,
                                            r.back.scaler_index,
                                            r.pmatrix_index, [0] * 4))
        out.append((p.get_clv(r.clv_index), p.get_scaler(r.scaler_index),
                    p.get_pmatrix(r.pmatrix_index)))
        results.append(out)
    jres, got, ref = results
    assert isinstance(parts[1].update_sumtable(0, 1, -1, -1, [0] * 4),
                      tuple)
    for want in (jres, ref):
        for (g_l, g_p), (w_l, w_p) in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g_l, w_l, rtol=1e-12)
            np.testing.assert_allclose(g_p, np.asarray(w_p), rtol=1e-12,
                                       atol=1e-13)
        np.testing.assert_allclose(got[3], want[3], rtol=1e-10)
        np.testing.assert_allclose(got[4], np.asarray(want[4]), rtol=1e-12,
                                   atol=1e-15)
        for g, w in zip(got[5], want[5]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12,
                                       atol=1e-300)


def test_levels_kernel_under_mesh_is_a_routing_difference():
    """pallas='levels-kernel' runs the level kernel once a shard where
    JAX's meshed engine reports 'levels' (libpll2_tpu/engine.py:850): the
    same numbers, in float64 to 1e-12 and in float32 (JAX's XLA levels)
    within TOL_LOGL; and a partial op list the fused kernel refuses takes
    the same route from 'auto'."""
    jt, tt, by, *_ = _problem(sites=256)
    for dtype, jdtype, rtol in ((torch.float64, jnp.float64, 1e-12),
                                (torch.float32, jnp.float32, TOL_LOGL)):
        eng = tp.TreeEngine(_port(tt, by, 256, mesh_n=4, dtype=dtype), tt,
                            pallas="levels-kernel")
        je = jx.TreeEngine(_jax(jt, by, 256, mesh_n=4, dtype=jdtype), jt,
                           pallas="levels-interpret")
        assert (eng.execution_path, je.execution_path) == \
            ("levels-kernel", "levels")
        np.testing.assert_allclose(eng.loglikelihood(), je.loglikelihood(),
                                   rtol=rtol)
        got, want = eng.newton_step(), je.newton_step()
        np.testing.assert_allclose(got[0], want[0], rtol=rtol)
        if dtype == torch.float64:
            np.testing.assert_allclose(got[1:], want[1:], rtol=1e-10)
        else:
            np.testing.assert_allclose(got[1:], want[1:], rtol=TOL_D1,
                                       atol=ATOL_D1)


@pytest.mark.parametrize("sites,asc,align", [(150, None, 8), (156, "LEWIS", 8),
                                             (157, "STAMATAKIS", 6),
                                             (160, None, 32)])
def test_sites_alignment_matches_jax(sites, asc, align):
    """`sites_alignment` pads sites_padded as JAX does; the pad columns'
    weights, invariant states and tip codes are JAX's, and an unsharded
    padded partition evaluates as JAX's; a padded partition keeps dense
    buffers where repeats are asked for."""
    jt, tt, by, *_ = _problem(sites=sites)
    jp = jx.Partition(jt.tip_count, jt.inner_count, 4, sites, 1,
                      jt.edge_count, 4, jt.inner_count,
                      asc_bias=getattr(JC.AscBias, asc or "NONE"),
                      sites_alignment=align)
    _fill(jp, jt, by, sites, 0, jmaps, jx.compute_gamma_cats, asc, 4, SUBST,
          FREQS, 4)
    tpart = tp.Partition(tt.tip_count, tt.inner_count, 4, sites, 1,
                         tt.edge_count, 4, tt.inner_count, device="cpu",
                         dtype=torch.float64,
                         asc_bias=getattr(C.AscBias, asc or "NONE"),
                         sites_alignment=align)
    _fill(tpart, tt, by, sites, 0, maps, tp.compute_gamma_cats, asc, 4,
          SUBST, FREQS, 4)
    assert tpart.sites_padded == jp.sites_padded
    assert tpart.sites_padded % align == 0
    jp.update_invariant_sites()
    tpart.update_invariant_sites()
    np.testing.assert_array_equal(tpart.pattern_weights, jp.pattern_weights)
    np.testing.assert_array_equal(tpart.invariant, jp.invariant)
    np.testing.assert_array_equal(tfused.tip_code_matrix(tpart),
                                  jfused.tip_code_matrix(jp))
    np.testing.assert_allclose(
        tp.TreeEngine(tpart, tt).loglikelihood(),
        jx.TreeEngine(jp, jt, pallas=False).loglikelihood(), rtol=1e-12)
    rep = (jx.Partition(12, 10, 4, sites, 1, 21, 4, 10, site_repeats=True,
                        sites_alignment=align),
           tp.Partition(12, 10, 4, sites, 1, 21, 4, 10, site_repeats=True,
                        sites_alignment=align, device="cpu"))
    assert (rep[0].repeats is None) == (rep[1].repeats is None)


# ------------------------------------------------ search and optimization
def test_streamed_rounds_under_mesh():
    """A streamed SPR round and a streamed NNI round on a 4-shard float64
    engine: the passes once a shard, one sum of the candidates' scores;
    JAX's meshed rounds accept the same moves and end at the same logL.
    Asc under a mesh streams on neither package."""
    results = []
    for pkg in ("jax", "port"):
        jt, tt, by, *_ = _problem(sites=320, perturb=3, seed=33)
        if pkg == "jax":
            s = jsearch.TreeSearch(_jax(jt, by, 320, mesh_n=4), jt)
        else:
            s = TreeSearch(_port(tt, by, 320, mesh_n=4), tt)
        s._ensure_engine()
        assert s._streamed_eligible()
        results.append(s.spr_round_streamed(radius=3)
                       + s.nni_round_streamed())
    (jl, ja, jnl, jna), (tl, ta, tnl, tna) = results
    assert (ta, tna) == (ja, jna) and ta >= 1
    np.testing.assert_allclose([tl, tnl], [jl, jnl], rtol=1e-9)
    jt, tt, by, *_ = _problem(sites=156)
    s = TreeSearch(_port(tt, by, 156, mesh_n=4, asc="LEWIS"), tt)
    s._ensure_engine()
    js = jsearch.TreeSearch(_jax(jt, by, 156, mesh_n=4, asc="LEWIS"), jt)
    js._ensure_engine()
    assert not s._streamed_eligible() and not js._streamed_eligible()


def test_maximize_fused_under_mesh():
    """maximize_fused's trials once a shard, [K] sums reduced: JAX's run on
    its meshed plain engine, histories and applied parameters to 1e-8."""
    jt, tt, by, *_ = _problem(sites=200)
    je = jx.TreeEngine(_jax(jt, by, 200, mesh_n=4), jt, pallas=False)
    te = tp.TreeEngine(_port(tt, by, 200, mesh_n=4), tt)
    kw = dict(steps=6, chunk=3, patience=10)
    jl, jparams, jh = jopt.maximize_fused(je, ("subst", "freqs"), **kw)
    tl, tparams, th = topt.maximize_fused(te, ("subst", "freqs"), **kw)
    assert len(th) == len(jh)
    np.testing.assert_allclose(th, jh, rtol=1e-8)
    assert tl == pytest.approx(jl, rel=1e-8)
    for k in jparams:
        np.testing.assert_allclose(tparams[k].numpy(),
                                   np.asarray(jparams[k]), rtol=1e-8,
                                   atol=1e-10)
    np.testing.assert_allclose(te.partition.subst_params,
                               je.partition.subst_params, rtol=1e-8)


def test_unported_consumers_refuse_a_mesh():
    """The gradient route and newton_smooth_all, which refused a mesh until
    they were ported to it, run once a shard and reduce: the gradient
    route's value and gradient (with Lewis asc too) and the sweep's logL
    and lengths against JAX's on its meshed partition, sharded and
    unsharded, at the float64 budgets."""
    import jax

    jt, tt, by, *_ = _problem(sites=160)
    for asc, sites in ((None, 160), ("LEWIS", 156)):
        je = jx.TreeEngine(_jax(jt, by, sites, mesh_n=4, asc=asc), jt,
                           pallas=False)
        jfn, jparams = jopt.make_loglikelihood_fn(je, ("branches",))
        jval, jgrad = jax.value_and_grad(jfn)(jparams)
        outs = []
        for n in (4, None):
            te = tp.TreeEngine(_port(tt, by, sites, mesh_n=n, asc=asc), tt,
                               pallas=False)
            fn, params = topt.make_loglikelihood_fn(te, ("branches",))
            x = params["log_branches"].clone().requires_grad_(True)
            val = fn({"log_branches": x})
            val.backward()
            outs.append((float(val.detach()), x.grad.numpy()))
        for val, grad in outs:
            assert val == pytest.approx(float(jval), rel=1e-12)
            np.testing.assert_allclose(
                grad, np.asarray(jgrad["log_branches"]), rtol=1e-10,
                atol=1e-9)
    jt, _, by, *_ = _problem(sites=160)
    je = jx.TreeEngine(_jax(jt, by, 160, mesh_n=4), jt, pallas=False)
    je.loglikelihood()      # JAX's sweep starts from the P-matrices held
    jlk = jopt.newton_smooth_all(je, jt, passes=1, iterations=3)
    for n in (4, None):
        _, tree, by2, *_ = _problem(sites=160)
        te = tp.TreeEngine(_port(tree, by2, 160, mesh_n=n), tree,
                           pallas=False)
        lk = topt.newton_smooth_all(te, tree, passes=1, iterations=3)
        assert lk == pytest.approx(jlk, rel=1e-12)
        np.testing.assert_allclose(te.branches.numpy(),
                                   np.asarray(je.branches), rtol=1e-10)


@pytest.mark.parametrize("asc,sites,n", [(None, 160, 2), ("LEWIS", 156, 4),
                                         ("FELSENSTEIN", 156, 8)])
def test_newton_smooth_all_under_mesh(asc, sites, n):
    """The sweep on a sharded partition: every step's CLV op and sumtable
    once a shard, each Newton update from the d1/d2 summed over the shards
    (ops/branch_sweep.py:newton_sweep_shards); the final logL, the lengths
    and each shard's CLV block equal to the unsharded sweep's at the
    float64 budgets, on the level kernel's plain version."""
    out = []
    for mesh_n in (n, None):
        _, tree, by, *_ = _problem(sites=sites, seed=4)
        te = tp.TreeEngine(_port(tree, by, sites, mesh_n=mesh_n, asc=asc),
                           tree, pallas="levels-kernel")
        lk = topt.newton_smooth_all(te, tree, passes=2, iterations=4)
        clv, _ = te.partition._dense_buffers()
        out.append((lk, te.branches.numpy(), clv.numpy()))
    (lk, blen, clv), (lk1, blen1, clv1) = out
    assert lk == pytest.approx(lk1, rel=1e-12)
    np.testing.assert_allclose(blen, blen1, rtol=1e-10)
    np.testing.assert_allclose(clv, clv1, rtol=1e-10, atol=1e-300)


def test_make_mesh_n_devices_takes_the_devices_in_turn():
    """`make_mesh(n_devices=n)`: the first n devices, or the devices in
    turn again where there are fewer (4 shards on one card), which
    examples/sharded_multichip.py's `--shards` uses."""
    assert make_mesh(n_devices=3, devices=["cpu"]).devices == \
        (torch.device("cpu"),) * 3
    assert make_mesh(n_devices=2, devices=["cpu"] * 4).size == 2
    assert make_mesh(devices=["cpu"] * 5).size == 5


# ----------------------------------------------------- sharded repeats
def _repeat_parts(tree, by, sites, n, dtype, pkg="port", asc=None,
                  repeats=True):
    w = sites // n
    if pkg == "jax":
        return [_jax(tree, by, w, dtype=dtype, asc=asc, repeats=repeats,
                     lo=k * w) for k in range(n)]
    return [_port(tree, by, w, dtype=dtype, asc=asc, repeats=repeats,
                  lo=k * w) for k in range(n)]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_repeats_invariance(n):
    """float64 repeats shards (the pooled path: JAX's dense-fused shards are
    float32 only) against the unsharded repeats partition and JAX's
    ShardedRepeatsEngine, logL and a Newton step."""
    jt, tt, by, *_ = _problem(sites=512, seed=31)
    eng = ShardedRepeatsEngine(
        tt, _repeat_parts(tt, by, 512, n, torch.float64),
        make_mesh(devices=["cpu"] * n))
    assert not eng.dense_fused
    assert eng.execution_path == "pool-pallas"
    jeng = jpar.ShardedRepeatsEngine(
        jt, _repeat_parts(jt, by, 512, n, jnp.float64, "jax"),
        jpar.make_mesh(n))
    ref = tp.TreeEngine(_port(tt, by, 512, repeats=True), tt)
    got = eng.loglikelihood()
    np.testing.assert_allclose(got, ref.loglikelihood(), rtol=1e-12)
    np.testing.assert_allclose(got, jeng.loglikelihood(), rtol=1e-12)
    got = eng.newton_step()
    _close(got, jeng.newton_step())
    _close(got, ref.newton_step())


def test_sharded_repeats_pool_kernel_against_jax_interpret():
    """float32 shards on the pool path (the pool kernel's plain version
    here) against JAX's pool kernel in interpret mode under the mesh; the
    dense-fused shards against its fused kernel in interpret mode."""
    jt, tt, by, *_ = _problem(n_taxa=10, sites=512, seed=33)
    mesh, jmesh = make_mesh(devices=["cpu"] * 4), jpar.make_mesh(4)
    pooled = ShardedRepeatsEngine(
        tt, _repeat_parts(tt, by, 512, 4, torch.float32), mesh,
        dense_fused=False)
    jpooled = jpar.ShardedRepeatsEngine(
        jt, _repeat_parts(jt, by, 512, 4, jnp.float32, "jax"), jmesh,
        interpret=True, dense_fused=False)
    assert jpooled.use_pallas and pooled.execution_path == "pool-pallas"
    np.testing.assert_allclose(pooled.loglikelihood(),
                               jpooled.loglikelihood(), rtol=TOL_LOGL)
    dense = ShardedRepeatsEngine(
        tt, _repeat_parts(tt, by, 512, 4, torch.float32), mesh)
    jdense = jpar.ShardedRepeatsEngine(
        jt, _repeat_parts(jt, by, 512, 4, jnp.float32, "jax"), jmesh,
        interpret=True)
    assert dense.dense_fused and jdense.dense_fused
    assert dense.execution_path == "repeats-dense-fused"
    got, want = dense.newton_step(), jdense.newton_step()
    np.testing.assert_allclose(got[0], want[0], rtol=TOL_LOGL)
    np.testing.assert_allclose(got[1:], want[1:], rtol=TOL_D1,
                               atol=ATOL_D1)


def test_sharded_repeats_newton_with_lewis():
    """Each shard's own asc columns, its correction composed before the
    reduction: Newton steps against JAX's sharded repeats and the port's
    shards as dense partitions."""
    jt, tt, by, *_ = _problem(sites=512, seed=37)
    mesh = make_mesh(devices=["cpu"] * 4)
    eng = ShardedRepeatsEngine(
        tt, _repeat_parts(tt, by, 512, 4, torch.float64, asc="LEWIS"), mesh)
    jeng = jpar.ShardedRepeatsEngine(
        jt, _repeat_parts(jt, by, 512, 4, jnp.float64, "jax", asc="LEWIS"),
        jpar.make_mesh(4))
    for _ in range(2):
        _close(eng.newton_step(), jeng.newton_step())


def test_sharded_repeats_batched_search():
    """TreeSearch drives a ShardedRepeatsEngine through the batched rounds
    (test_parallel_m6.py:488-553): float32 dense-fused shards at 10 x 256
    over 4, against the unsharded repeats search and JAX's unsharded
    float64 search on the same columns: the same accepted moves."""
    def run(kind):
        jt, tt, by, *_ = _problem(n_taxa=10, sites=256, seed=52, perturb=3)
        if kind == "sharded":
            eng = ShardedRepeatsEngine(
                tt, _repeat_parts(tt, by, 256, 4, torch.float32),
                make_mesh(devices=["cpu"] * 4))
            assert eng.dense_fused and eng.use_fused
            s = TreeSearch(None, tt, engine=eng)
            assert not s._streamed_eligible()
        elif kind == "single":
            s = TreeSearch(_port(tt, by, 256, dtype=torch.float32,
                                 repeats=True), tt, pallas="auto")
        else:
            s = jsearch.TreeSearch(_jax(jt, by, 256), jt)
        return s.spr_round_batched(radius=3) + s.nni_round_batched()

    got, single, want = run("sharded"), run("single"), run("jax")
    assert (got[1], got[3]) == (single[1], single[3]) == (want[1], want[3])
    assert got[1] >= 1
    np.testing.assert_allclose([got[0], got[2]], [single[0], single[2]],
                               rtol=2e-5)
    np.testing.assert_allclose([got[0], got[2]], [want[0], want[2]],
                               rtol=TOL_LOGL)


def test_sharded_repeats_refusals():
    """JAX's refusals and error types."""
    _, tt, by, *_ = _problem(sites=256)
    mesh = make_mesh(devices=["cpu"] * 2)
    parts = _repeat_parts(tt, by, 256, 2, torch.float64)
    with pytest.raises(ValueError):
        ShardedRepeatsEngine(tt, parts[:1], mesh)
    with pytest.raises(C.PllError):
        ShardedRepeatsEngine(tt, _repeat_parts(tt, by, 256, 2, torch.float64,
                                               repeats=False), mesh)
    with pytest.raises(ValueError):
        ShardedRepeatsEngine(tt, [parts[0], _port(tt, by, 64, repeats=True)],
                             mesh)
    with pytest.raises(C.PllError):
        ShardedRepeatsEngine(tt, parts, mesh, dense_fused=True)
    pooled = ShardedRepeatsEngine(tt, parts, mesh)
    with pytest.raises(C.PllError):
        pooled.set_topology(tt)
    assert pooled.pack_candidate(tt.vroot) is None


# ------------------------------------------------------ consumers, refusals
def test_partitioned_engine_shard():
    """PartitionedEngine.shard: two partitions over 4 shards each, linked
    Newton steps and a streamed SPR round, against JAX's; and `maximize`
    of the sharded units (maximize_fused a unit, the trials once a shard)
    against the same units unsharded."""
    out = []
    for pkg in ("jax", "port"):
        jt, tt, by, *_ = _problem(sites=200, perturb=2, seed=21)
        _, _, by2, *_ = _problem(sites=200, seed=22)
        if pkg == "jax":
            jparts =[jx.Partition(jt.tip_count, jt.inner_count, 4, 200, 1,
                                   jt.edge_count, 4, jt.inner_count,
                                   sites_alignment=4) for _ in range(2)]
            for p, b in zip(jparts, (by, by2)):
                _fill(p, jt, b, 200, 0, jmaps, jx.compute_gamma_cats, None,
                      4, SUBST, FREQS, 4)
            jx.PartitionedEngine.shard(jparts, jpar.make_mesh(4))
            pe = jx.PartitionedEngine(jparts, jt)
            s = jsearch.TreeSearch(None, jt, engine=pe)
        else:
            tparts = [tp.Partition(tt.tip_count, tt.inner_count, 4, 200, 1,
                                   tt.edge_count, 4, tt.inner_count,
                                   sites_alignment=4, device="cpu",
                                   dtype=torch.float64) for _ in range(2)]
            for p, b in zip(tparts, (by, by2)):
                _fill(p, tt, b, 200, 0, maps, tp.compute_gamma_cats, None,
                      4, SUBST, FREQS, 4)
            tp.PartitionedEngine.shard(tparts, make_mesh(devices=["cpu"] * 4))
            assert all(len(p.shards) == 4 for p in tparts)
            pe = tp.PartitionedEngine(tparts, tt)
            s = TreeSearch(None, tt, engine=pe)
        newton = [pe.newton_step() for _ in range(2)]
        out.append((newton, s.spr_round_streamed(radius=2)))
    (jn, js), (tn, ts) = out
    for g, w in zip(tn, jn):
        _close(g, w)
    assert ts[1] == js[1]
    np.testing.assert_allclose(ts[0], js[0], rtol=1e-9)
    fits = []
    for mesh_n in (4, None):
        units = [_port(tt, b, 200, mesh_n=mesh_n) for b in (by, by2)]
        pe = tp.PartitionedEngine(units, tt)
        fits.append(pe.maximize(("freqs",), steps=3, chunk=3))
        assert all(e.use_fused for e in pe.engines)
    (lk, params, hist), (lk1, params1, hist1) = fits
    np.testing.assert_allclose(lk, lk1, rtol=1e-10)
    np.testing.assert_allclose(np.concatenate(hist), np.concatenate(hist1),
                               rtol=1e-10)
    for k in params1:
        np.testing.assert_allclose(params[k].numpy(), params1[k].numpy(),
                                   rtol=1e-8, atol=1e-10)


def test_shard_partition_refusals_match_jax():
    """A repeats partition, a width that does not split, and asc under
    several processes: ValueError, as JAX raises."""
    jt, tt, by, *_ = _problem(sites=150)
    cases = [
        (dict(repeats=True), 2),
        (dict(), 4),                        # 150 % 4 != 0
    ]
    for kw, n in cases:
        with pytest.raises(ValueError):
            jpar.shard_partition(_jax(jt, by, 150, **kw), jpar.make_mesh(n))
        with pytest.raises(ValueError):
            shard_partition(_port(tt, by, 150, **kw),
                            make_mesh(devices=["cpu"] * n))
    two = Mesh(["cpu", "cpu"], owners=[0, 1])
    two.rank = 0
    with pytest.raises(ValueError):
        shard_partition(_port(tt, by, 150, asc="LEWIS"), two)
    with pytest.raises(ValueError):
        tp.Partition(12, 10, 4, 150, 1, 21, 4, 10, device="cpu",
                     mesh=make_mesh(devices=["cpu"] * 4))


def test_sharded_multichip_example_prints_jax_lines(capsys, monkeypatch,
                                                    tmp_path):
    """examples/sharded_multichip.py over JAX's 8 virtual devices and the
    port's example over 8 CPU shards print the same lines."""
    from libpll2_tpu_torch.examples import sharded_multichip

    monkeypatch.chdir(tmp_path)
    jax_example("sharded_multichip").main()
    want = capsys.readouterr().out
    sharded_multichip.main(["--device", "cpu", "--shards", "8"])
    assert_same_lines(capsys.readouterr().out, want)


def test_checkpoint_of_a_sharded_partition(tmp_path):
    """A sharded partition saves its gathered buffers and its padded
    width; the checkpoint reloads unsharded, as JAX's does, and evaluates
    to the sharded engine's logL."""
    from libpll2_tpu_torch import checkpoint

    _, tt, by, *_ = _problem(sites=150)
    part = _port(tt, by, 150, mesh_n=4)
    lk = tp.TreeEngine(part, tt).loglikelihood()
    path = str(tmp_path / "mesh.ckpt.npz")
    checkpoint.save(path, part, tt, include_clvs=True)
    back, tree, _ = checkpoint.load(path, device="cpu")
    assert back.sites_padded == part.sites_padded == 152
    assert back.shards is None
    clv, sc = part._dense_buffers()
    assert torch.equal(back.clv, clv) and torch.equal(back.scale_buffer, sc)
    np.testing.assert_allclose(tp.TreeEngine(back, tree).loglikelihood(), lk,
                               rtol=1e-12)
