"""The port's certified final evaluation (libpll2_tpu_torch/ops/df64.py)
against libpll2_tpu's, on the CPU.

The same numpy inputs go through JAX's `loglikelihood_df64` (double-single
float32 pairs) and JAX's float64 engine (`pallas=False`), and through the
port's `loglikelihood_df64` (float64 through the fused walk's plain
version on CPU tensors). Budget: 1e-10 relative, JAX's own for its df64
path (tests/test_df64.py:75,87). Cases: the scaling-stressed 96-taxon
caterpillar x 384 at alpha 0.5, 20 states on a 10-taxon random tree x 192,
raw tip rows set with `set_tip_clv`, and a JAX float32 partition carried
across by `convert.partition_from_numpy`. The refusals are JAX's, checked
on the cases of tests/test_df64.py:90-120."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu as jx
from libpll2_tpu import constants as JC
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.trees import parse_newick as jparse
from libpll2_tpu.trees import random_utree as jrandom_utree
from libpll2_tpu.utils import simulate_alignment as jsimulate

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import constants as TC
from libpll2_tpu_torch import convert
from libpll2_tpu_torch.io import maps as tmaps
from libpll2_tpu_torch.ops import fused
from libpll2_tpu_torch.trees import parse_newick as tparse
from libpll2_tpu_torch.constants import SCALE_BUFFER_NONE
from libpll2_tpu_torch.trees import random_utree as trandom_utree

CPU = torch.device("cpu")
TOL = 1e-10


def _caterpillar(n):
    text = f"t{n-1}:0.3"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.3,{text}):0.3"
    return f"(t0:0.3,t1:0.3,{text});"


def _model(states, seed):
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.ones(states) * 10),
            rng.uniform(0.5, 2.0, states * (states - 1) // 2))


def _jax_part(tree, h, s, dtype, states=4, alpha=0.5, seed=11, raw=()):
    part = jx.Partition(tree.tip_count, tree.inner_count, states,
                        len(s[0]), 1, tree.edge_count, 4, tree.inner_count,
                        dtype=dtype)
    _fill(part, tree, h, s, states, alpha, seed, raw, jmaps,
          jx.compute_gamma_cats)
    return part


def _port_part(tree, h, s, dtype, states=4, alpha=0.5, seed=11, raw=()):
    part = tp.Partition(tree.tip_count, tree.inner_count, states,
                        len(s[0]), 1, tree.edge_count, 4, tree.inner_count,
                        device=CPU, dtype=dtype)
    _fill(part, tree, h, s, states, alpha, seed, raw, tmaps,
          tp.compute_gamma_cats)
    return part


def _fill(part, tree, h, s, states, alpha, seed, raw, maps, gamma):
    """Tips (state codes, or seeded raw rows for the labels in `raw`) and a
    seeded model, the same in both packages. Raw rows are rounded to
    float32 first, so that float32 and float64 partitions hold the same
    values."""
    by = dict(zip(h, s))
    cm = maps.map_nt if states == 4 else maps.map_aa
    for tip in tree.tips():
        if tip.label in raw:
            rng = np.random.default_rng(int(tip.label[1:]))
            rows = rng.dirichlet(np.ones(states), size=len(s[0]))
            part.set_tip_clv(tip.clv_index,
                             rows.astype(np.float32).astype(np.float64))
        else:
            part.set_tip_states(tip.clv_index, cm, by[tip.label])
    freqs, subst = _model(states, seed)
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, subst)
    part.set_category_rates(gamma(alpha, 4))


def _references(newick, sites, states, alpha, raw=(), seed=5):
    """(JAX df64 on float32, JAX float64 engine, the port's df64 on float32
    and on float64) for one tree and alignment."""
    jtree, ttree = jparse(newick), tparse(newick)
    freqs = [1.0 / states] * states
    subst = [1, 2, 1, 1, 2, 1] if states == 4 else [1.0] * 190
    h, s = jsimulate(jtree, sites, freqs, subst, alpha=alpha, seed=seed)
    jref = jx.TreeEngine(_jax_part(jtree, h, s, jnp.float64, states, alpha,
                                   raw=raw), jtree,
                         pallas=False).loglikelihood()
    jdf = jx.loglikelihood_df64(_jax_part(jtree, h, s, jnp.float32, states,
                                          alpha, raw=raw), jtree)
    got32 = tp.loglikelihood_df64(_port_part(ttree, h, s, torch.float32,
                                             states, alpha, raw=raw), ttree)
    got64 = tp.loglikelihood_df64(_port_part(ttree, h, s, torch.float64,
                                             states, alpha, raw=raw), ttree)
    return jdf, jref, got32, got64


def _check(jdf, jref, *got):
    for g in got:
        assert abs(g - jdf) / abs(jdf) < TOL, (g, jdf)
        assert abs(g - jref) / abs(jref) < TOL, (g, jref)


def test_caterpillar_scaling_stress():
    """tests/test_df64.py:53's caterpillar: 96 taxa x 384 at alpha 0.5,
    many rescalings in JAX's 2^-16 window, some in float64's."""
    jdf, jref, g32, g64 = _references(_caterpillar(96), 384, 4, 0.5)
    _check(jdf, jref, g32, g64)


def test_random_tree_20_states():
    newick = jx.trees.export_newick(
        jrandom_utree([f"t{i}" for i in range(10)], seed=7).vroot)
    jdf, jref, g32, g64 = _references(newick, 192, 20, 1.0, seed=7)
    _check(jdf, jref, g32, g64)


def test_raw_tip_rows():
    """Tips set with set_tip_clv: their rows enter the float64 walk as
    raw rows (ops/fused.py:ctip_rows), the others as state codes."""
    newick = jx.trees.export_newick(
        jrandom_utree([f"t{i}" for i in range(12)], seed=4).vroot)
    jdf, jref, g32, g64 = _references(newick, 256, 4, 0.7,
                                      raw=("t1", "t4", "t9"), seed=4)
    _check(jdf, jref, g32, g64)


def test_carried_across_from_a_jax_partition():
    """A JAX float32 partition carried across by convert gives JAX's
    certified value from the port's function."""
    jtree = jparse(_caterpillar(40))
    ttree = tparse(_caterpillar(40))
    h, s = jsimulate(jtree, 300, [0.25] * 4, [1, 2, 1, 1, 2, 1], alpha=0.5,
                     seed=8)
    jp = _jax_part(jtree, h, s, jnp.float32, raw=("t3",))
    state = {k: getattr(jp, k) for k in convert.STATE_KEYS}
    tpart = convert.partition_from_numpy(state, device=CPU,
                                         dtype=torch.float32)
    want = jx.loglikelihood_df64(jp, jtree)
    jref = jx.TreeEngine(_jax_part(jtree, h, s, jnp.float64, raw=("t3",)),
                         jtree, pallas=False).loglikelihood()
    _check(want, jref, tp.loglikelihood_df64(tpart, ttree))


def test_one_launch_of_the_float64_walk():
    """The certified evaluation walks the tree once through
    fused_traversal_f64: its plain version, in float64, on CPU tensors."""
    newick = _caterpillar(24)
    ttree = tparse(newick)
    h, s = jsimulate(jparse(newick), 200, [0.25] * 4, [1, 2, 1, 1, 2, 1],
                     alpha=0.5, seed=3)
    part = _port_part(ttree, h, s, torch.float32)
    calls = []
    orig = fused.fused_traversal_reference

    def spy(*a, **k):
        calls.append(a[1].dtype)
        return orig(*a, **k)

    fused.fused_traversal_reference = spy
    try:
        tp.loglikelihood_df64(part, ttree)
    finally:
        fused.fused_traversal_reference = orig
    assert calls == [torch.float64]


def _scope_partition(tree, h, s, module, maps, **kw):
    part = module.Partition(tree.tip_count, tree.inner_count, 4, 64, 1,
                            tree.edge_count, 4, tree.inner_count, **kw)
    by = dict(zip(h, s))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    part.set_category_rates(module.compute_gamma_cats(1.0, 4))
    return part


@pytest.mark.parametrize("mode", ["rate_scalers", "site_repeats", "asc",
                                  "pinv"])
def test_scope_errors_match_jax(mode):
    """JAX's refusals (ops/df64.py:330-338): per-rate scalers
    (tests/test_df64.py:90), site repeats, an asc correction and p-inv > 0,
    each a PllError with JAX's message."""
    jtree = jrandom_utree([f"t{i}" for i in range(6)], seed=3)
    ttree = trandom_utree([f"t{i}" for i in range(6)], seed=3)
    h, s = jsimulate(jtree, 64, [0.25] * 4, [1, 2, 1, 1, 2, 1], alpha=1.0,
                     seed=3)
    kw = {"rate_scalers": {"rate_scalers": True},
          "site_repeats": {"site_repeats": True},
          "asc": {"asc_bias": "LEWIS"}, "pinv": {}}[mode]
    jkw = dict(kw)
    tkw = dict(kw, device=CPU)
    if mode == "asc":
        jkw["asc_bias"], tkw["asc_bias"] = (JC.AscBias.LEWIS,
                                            TC.AscBias.LEWIS)
    jpart = _scope_partition(jtree, h, s, jx, jmaps, **jkw)
    tpart = _scope_partition(ttree, h, s, tp, tmaps, **tkw)
    if mode == "pinv":
        jpart.update_invariant_sites_proportion(0, 0.2)
        tpart.update_invariant_sites_proportion(0, 0.2)
    with pytest.raises(JC.PllError) as jerr:
        jx.loglikelihood_df64(jpart, jtree)
    with pytest.raises(TC.PllError) as terr:
        tp.loglikelihood_df64(tpart, ttree)
    assert str(terr.value) == str(jerr.value)
    assert terr.value.errno == jerr.value.errno


def test_rejects_scalerless_inner_node_as_jax():
    """tests/test_df64.py:104: an inner node without a scaler row."""
    n = 64
    jtree, ttree = jparse(_caterpillar(n)), tparse(_caterpillar(n))
    h, s = jsimulate(jtree, 256, [0.25] * 4, [1, 2, 1, 1, 2, 1], alpha=0.5,
                     seed=9)
    for tree in (jtree, ttree):
        victim = next(nd for nd in tree.nodes()
                      if not nd.is_tip() and nd.scaler_index == 10)
        for half in victim.ring():
            half.scaler_index = SCALE_BUFFER_NONE
    with pytest.raises(JC.PllError) as jerr:
        jx.loglikelihood_df64(_jax_part(jtree, h, s, jnp.float32), jtree)
    with pytest.raises(TC.PllError) as terr:
        tp.loglikelihood_df64(_port_part(ttree, h, s, torch.float32), ttree)
    assert str(terr.value) == str(jerr.value)


def test_float64_walk_refuses_other_modes():
    """fused_traversal_f64's scope: one topology, per-site counts."""
    codes = torch.zeros((3, 8), dtype=torch.int32)
    pm = torch.zeros((4, 4, 4, 4), dtype=torch.float64)
    table = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="candidate form"):
        fused.fused_traversal_f64(codes, pm[None], table[None], 4, 4, 1,
                                  0.5, 2.0)
    with pytest.raises(NotImplementedError, match="per-rate"):
        fused.fused_traversal_f64(codes, pm, table, 4, 4, 1, 0.5, 2.0,
                                  rate_scalers=True)
    with pytest.raises(NotImplementedError, match="query form"):
        fused.fused_traversal_f64(codes, pm, table, 4, 4, 1, 0.5, 2.0,
                                  query_codes=codes[:1])
    with pytest.raises(ValueError, match="float64"):
        fused.fused_traversal_f64(codes, pm.float(), table, 4, 4, 1, 0.5,
                                  2.0)
