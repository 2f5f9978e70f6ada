"""Float64 partitions on the card (ROADMAP A5b-1), held on the CPU.

The port's kernels are float32 and JAX's take only float32 too
(libpll2_tpu/engine.py:843-845, :903-906), so JAX runs a float64 partition
on its XLA paths and reports 'levels', 'scan' or 'pool'. The port routes a
float64 CUDA partition the same way, to the plain PyTorch versions of those
paths: `engine.choose_route` decides it from plain values, so its answers
for device type "cuda" are checked here as data, against JAX's
`execution_path` for every `pallas=` name, storage and level schedule. The
route is then run end to end on the CPU (the engine told it is on CUDA)
against JAX's float64 engine at 1e-12 (logL) and 1e-10 (d1, d2). The
callers that run level tables (the step-by-step API, the streamed passes,
the sweep, `prepare_stream`, the pooled plans) take the plain versions for
float64 buffers by dtype (ops/levels.py:level_for, ops/pool.py:pool_for):
with the kernel wrappers replaced by functions that fail, float64 runs
through and float32 reaches the wrapper. 8 taxa x 96 sites."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.trees import random_utree as j_random_utree

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import engine as tengine
from libpll2_tpu_torch.engine import PALLAS_MODES, choose_route
from libpll2_tpu_torch.io import maps
from libpll2_tpu_torch.ops import levels, pool
from libpll2_tpu_torch.optimize import newton_smooth_all
from libpll2_tpu_torch.placement import EdgePlacer
from libpll2_tpu_torch.search import TreeSearch
from libpll2_tpu_torch.trees import (create_operations, random_utree,
                                     traverse)
from libpll2_tpu_torch.utils import simulate_alignment

TAXA, SITES = 8, 96
LABELS = [f"t{i}" for i in range(TAXA)]
FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1.0, 2.5, 0.7, 1.1, 3.0, 1.0]


def _by(seed=3):
    tree = random_utree(LABELS, seed=seed)
    for h in traverse(tree.vroot):
        if h.back is not None:
            h.length = h.back.length = h.length * 0.3
    headers, seqs = simulate_alignment(tree, SITES, FREQS, SUBST, alpha=0.8,
                                       seed=seed)
    return dict(zip(headers, seqs))


def _partition(jax_side, tree, by, dtype, repeats=False):
    n = tree.tip_count
    if jax_side:
        part = JPartition(n, n - 2, 4, SITES, 1, 2 * n - 3, 4, n - 2,
                          dtype=dtype, site_repeats=repeats)
        cm = jmaps.map_nt
    else:
        part = tp.Partition(n, n - 2, 4, SITES, 1, 2 * n - 3, 4, n - 2,
                            device="cpu", dtype=dtype, site_repeats=repeats)
        cm = maps.map_nt
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, cm, by[tip.label])
    part.set_frequencies(0, FREQS)
    part.set_subst_params(0, SUBST)
    part.set_category_rates(tp.compute_gamma_cats(0.8, 4))
    return part


@pytest.fixture
def as_if_on_cuda(monkeypatch):
    """Engines built while it is active take the route a CUDA partition of
    the same dtype would take."""
    real = tengine.choose_route

    def on_cuda(*args, **kw):
        return real(*args, **dict(kw, device_type="cuda"))

    monkeypatch.setattr(tengine, "choose_route", on_cuda)


@pytest.mark.parametrize("level_schedule", [True, False])
@pytest.mark.parametrize("repeats", [False, True])
@pytest.mark.parametrize("pallas", PALLAS_MODES)
def test_float64_cuda_route_is_jax_float64_route(pallas, repeats,
                                                 level_schedule):
    """`choose_route` for a float64 partition on "cuda": no kernel, and the
    path JAX's float64 engine reports for the same arguments; float32 on
    "cuda" takes a kernel route where `pallas` asks for one."""
    route = choose_route(pallas, dtype=torch.float64, device_type="cuda",
                         repeats=repeats, level_schedule=level_schedule)
    assert not (route.fused or route.levels_kernel or route.pool_kernel)
    want = "pool" if repeats else "levels" if level_schedule else "scan"
    assert route.path == want
    jt = j_random_utree(LABELS, seed=3)
    je = JTreeEngine(_partition(True, jt, _by(), jnp.float64, repeats), jt,
                     pallas=pallas, level_schedule=level_schedule)
    assert je.execution_path == want
    f32 = choose_route(pallas, dtype=torch.float32, device_type="cuda",
                       repeats=repeats, level_schedule=level_schedule)
    wants_kernel = pallas in ("auto", True, "interpret") or pallas in (
        ("pool", "pool-interpret") if repeats
        else ("levels-kernel", "levels-interpret"))
    assert (f32.path != want) == wants_kernel


@pytest.mark.parametrize("repeats", [False, True])
def test_float64_cuda_route_matches_jax_float64(as_if_on_cuda, repeats):
    """The float64 CUDA route, run on the CPU: 'levels' (dense) and 'pool'
    (repeats) against JAX's float64 engine, logL, Newton steps, d1 and
    d2."""
    by = _by()
    jt, tt = j_random_utree(LABELS, seed=3), random_utree(LABELS, seed=3)
    je = JTreeEngine(_partition(True, jt, by, jnp.float64, repeats), jt)
    te = tp.TreeEngine(_partition(False, tt, by, torch.float64, repeats), tt)
    assert te.execution_path == je.execution_path == \
        ("pool" if repeats else "levels")
    assert abs(te.loglikelihood() - je.loglikelihood()) \
        < 1e-12 * abs(je.loglikelihood())
    for _ in range(3):
        (tl, t1, t2), (jl, j1, j2) = te.newton_step(), je.newton_step()
        assert abs(tl - jl) < 1e-12 * abs(jl)
        assert abs(t1 - j1) < 1e-10 * max(abs(j1), 1e-3)
        assert abs(t2 - j2) < 1e-10 * max(abs(j2), 1e-3)


@pytest.fixture
def wrappers_fail(monkeypatch):
    """The level and pool kernel wrappers replaced by functions that fail:
    whatever reaches them would launch the kernel on CUDA."""
    def fail(*args, **kw):
        raise AssertionError("reached a kernel wrapper")

    monkeypatch.setattr(levels, "level_update", fail)
    monkeypatch.setattr(pool, "pool_update", fail)


def test_level_and_pool_callers_choose_the_plain_version_by_dtype(
        wrappers_fail):
    """`update_partials` (dense and pooled), the streamed passes of an NNI
    round, `newton_smooth_all` and `prepare_stream` run float64 buffers
    through the plain versions, never the wrappers; float32 buffers reach
    the wrappers."""
    assert levels.level_for(torch.zeros(1, dtype=torch.float64)) \
        is levels.level_update_reference
    assert pool.pool_for(torch.zeros(1, dtype=torch.float64)) \
        is pool.pool_update_reference
    by = _by()
    tree = random_utree(LABELS, seed=3)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    for repeats in (False, True):
        for dtype in (torch.float64, torch.float32):
            part = _partition(False, tree, by, dtype, repeats)
            part.update_prob_matrices([0] * 4, pidx, br)
            if dtype == torch.float32:
                with pytest.raises(AssertionError, match="wrapper"):
                    part.update_partials(ops)
            else:
                part.update_partials(ops)
    part = _partition(False, tree, by, torch.float64)
    TreeSearch(part, tree, pallas=False).nni_round_streamed()
    eng = tp.TreeEngine(part, tree, pallas=False)
    assert np.isfinite(newton_smooth_all(eng, tree, passes=1))
    placer = EdgePlacer(tree, by, dtype=torch.float64, device="cpu")
    placer.set_model(FREQS, SUBST, alpha=0.8)
    placer.prepare_stream()
    place32 = EdgePlacer(tree, by, device="cpu")
    place32.set_model(FREQS, SUBST, alpha=0.8)
    with pytest.raises(AssertionError, match="wrapper"):
        place32.prepare_stream()
