"""The public names of the port's TreeEngine and Partition against
libpll2_tpu's, the engine attributes that JAX's consumers read
(`asc_type`, `n_real`, `use_repeats_pallas`, `ops`), and
`Partition.update_partials`'s JAX arguments (`pad_to`, packed
`Operations`), on the CPU.

Every public name of a JAX class must exist on the port's class, except
the names of modules the port has not reached yet, listed here with the
ROADMAP item that brings each (none is left). A listed name that the port
has gained must leave the list. The
attributes are compared with JAX's engines on the same partitions, built
in JAX and carried over with libpll2_tpu_torch.convert: without an asc
correction, under each of the three, and on a site-repeats partition on
the pool paths. JAX's `use_repeats_pallas` also asks that the class pool
fit its kernel's VMEM budget, which holds at these sizes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu as jx
from libpll2_tpu import constants as JC
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.trees import random_alignment, random_utree

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import convert
from libpll2_tpu_torch.io import maps as tmaps

CPU = torch.device("cpu")

# JAX names the port does not have yet: name -> the ROADMAP item (or rule)
NOT_YET = {
    "TreeEngine": {},
    "Partition": {},
}


def _public(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


@pytest.mark.parametrize("name", sorted(NOT_YET))
def test_public_names_match_jax(name):
    jax_names = _public(getattr(jx, name))
    port_names = _public(getattr(tp, name))
    waiting = set(NOT_YET[name])
    assert waiting <= jax_names, sorted(waiting - jax_names)
    assert not waiting & port_names, sorted(waiting & port_names)
    assert jax_names - waiting <= port_names, \
        sorted(jax_names - waiting - port_names)


# JAX's top-level names the port does not export yet: name -> ROADMAP item
NOT_YET_TOP = {}

def test_parallel_names_match_jax():
    """`libpll2_tpu_torch.parallel` exports JAX's `__all__`, and
    ShardedRepeatsEngine has every public name of JAX's."""
    from libpll2_tpu import parallel as jpar

    from libpll2_tpu_torch import parallel as tpar

    assert tpar.__all__ == jpar.__all__
    assert all(hasattr(tpar, n) for n in tpar.__all__)
    jax_names = _public(jpar.ShardedRepeatsEngine)
    port_names = _public(tpar.ShardedRepeatsEngine)
    assert jax_names <= port_names, sorted(jax_names - port_names)
    assert {"loglikelihood_loop", "newton_loop"} <= port_names


def test_top_level_names_match_jax():
    """The port's `__all__` holds JAX's, but for the names still to port;
    each exported name exists."""
    waiting = set(NOT_YET_TOP)
    assert waiting <= set(jx.__all__)
    assert not waiting & set(tp.__all__)
    assert set(jx.__all__) - waiting <= set(tp.__all__), \
        sorted(set(jx.__all__) - waiting - set(tp.__all__))
    assert all(hasattr(tp, n) for n in tp.__all__)


def _jax_partition(asc=None, site_repeats=False, sites=160, seed=23,
                   dtype=jnp.float32):
    """12 taxa of random DNA, float32; with `asc`, constant columns are
    replaced so that the alignment has variable sites only."""
    headers, seqs = random_alignment(12, sites, alphabet="ACGT", seed=seed)
    if asc is not None:
        cols = np.array([list(s) for s in seqs])
        const = np.flatnonzero((cols == cols[:1]).all(axis=0))
        cols[0, const] = np.where(cols[0, const] == "A", "C", "A")
        seqs = ["".join(r) for r in cols]
    tree = random_utree(headers, seed=seed)
    jp = jx.Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                      tree.edge_count, 4, tree.inner_count, dtype=dtype,
                      asc_bias=getattr(JC.AscBias, asc or "NONE"),
                      site_repeats=site_repeats)
    by = dict(zip(headers, seqs))
    for tip in tree.tips():
        jp.set_tip_states(tip.clv_index, jmaps.map_nt, by[tip.label])
    jp.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
    jp.set_subst_params(0, [1.0, 2.0, 1.0, 1.0, 2.0, 1.0])
    jp.set_category_rates(jx.compute_gamma_cats(0.9, 4))
    if asc not in (None, "LEWIS"):
        jp.set_asc_state_weights([50, 40, 60, 20])
    return jp, tree


def _port(jp, dtype=torch.float32):
    state = {k: getattr(jp, k) for k in convert.STATE_KEYS}
    state["_invariant_valid"] = jp._invariant_valid
    if jp.repeats is not None:
        state.update({k: getattr(jp, k, None) for k in convert.REPEATS_KEYS})
    return convert.partition_from_numpy(state, device=CPU, dtype=dtype)


@pytest.mark.parametrize("asc", [None, "LEWIS", "FELSENSTEIN",
                                 "STAMATAKIS"])
def test_asc_type_and_n_real_match_jax(asc):
    jp, tree = _jax_partition(asc)
    je = jx.TreeEngine(jp, tree, pallas=False)
    te = tp.TreeEngine(_port(jp), tree)
    assert te.asc_type == je.asc_type
    assert te.n_real == je.n_real
    assert te.n_real == (-1 if asc is None else 160)


@pytest.mark.parametrize("pallas", ["pool", "pool-interpret", False])
def test_use_repeats_pallas_matches_jax(pallas):
    jp, tree = _jax_partition(site_repeats=True, sites=384, seed=7)
    je = jx.TreeEngine(jp, tree, pallas=pallas)
    te = tp.TreeEngine(_port(jp), tree, pallas=pallas)
    assert te.execution_path == je.execution_path
    assert te.use_repeats_pallas == je.use_repeats_pallas
    assert te.use_repeats_pallas == (pallas is not False)


@pytest.mark.parametrize("pallas", ["auto", "levels-kernel", False, "pool"])
@pytest.mark.parametrize("site_repeats", [False, True])
def test_ops_is_set_on_every_path(pallas, site_repeats):
    jp, tree = _jax_partition(site_repeats=site_repeats)
    te = tp.TreeEngine(_port(jp), tree, pallas=pallas)
    assert te.ops is not None
    if te.execution_path in ("fused", "repeats-dense-fused"):
        table, codes, raw = te.ops
        assert table is te.table and raw is None
        assert codes.shape == (te.partition.tips, te.partition.sites_padded)


def test_fused_ops_follow_a_tip_setter():
    """JAX's `ops` re-reads the tip operands through the tip cache; the
    port's must too: after set_tip_states, `ops` holds the new codes and
    the engine's logL follows them."""
    jp, tree = _jax_partition()
    part = _port(jp)
    te = tp.TreeEngine(part, tree)
    assert te.execution_path == "fused"
    before = te.ops[1].clone()
    lnl = te.loglikelihood()
    tip = next(iter(tree.tips()))
    part.set_tip_states(tip.clv_index, tmaps.map_nt, "A" * part.sites)
    after = te.ops[1]
    assert not torch.equal(before, after)
    assert bool((after[tip.clv_index] == 1).all())
    assert te.loglikelihood() != lnl


def _ops_of(tree):
    from libpll2_tpu.trees import create_operations, traverse

    ops, branches, pidx = create_operations(traverse(tree.vroot))
    return ops, branches, pidx


@pytest.mark.parametrize("pad_to", [None, 0, 40])
def test_update_partials_takes_pad_to_and_packed_operations(pad_to):
    """The step-by-step API with JAX's `pad_to` and packed `Operations`
    (JAX's, padded to `pad_to`, and the port's own): the root edge's logL
    as JAX's on the same float64 partition, 1e-12."""
    from libpll2_tpu.partition import pack_operations as jpack

    jp64, tree = _jax_partition(sites=160, seed=29, dtype=jnp.float64)
    ops, branches, pidx = _ops_of(tree)
    parts = [_port(jp64, torch.float64) for _ in range(3)]
    r = tree.vroot
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index, [0, 0, 0, 0])
    jp64.update_prob_matrices([0] * 4, pidx, branches)
    jp64.update_partials(jpack(ops, pad_to=pad_to, scratch_clv=jp64.nodes),
                         pad_to=pad_to)
    want = jp64.compute_edge_loglikelihood(*edge)
    packed = (jpack(ops, pad_to=pad_to, scratch_clv=jp64.nodes),
              tp.pack_operations(ops, device=CPU), ops)
    for part, arg in zip(parts, packed):
        part.update_prob_matrices([0] * 4, pidx, branches)
        part.update_partials(arg, pad_to=pad_to)
        got = part.compute_edge_loglikelihood(*edge)
        np.testing.assert_allclose(got, want, rtol=1e-12)
    with pytest.raises(TypeError):
        parts[0].update_partials(ops, pad_to=2.5)


def test_update_partials_refuses_packed_operations_on_repeats():
    """A repeats partition needs the host-side Operation list: packed
    Operations raise JAX's PllError on both packages."""
    from libpll2_tpu.partition import pack_operations as jpack

    jp, tree = _jax_partition(site_repeats=True, sites=384, seed=7)
    ops, _, _ = _ops_of(tree)
    part = _port(jp)
    with pytest.raises(JC.PllError) as jerr:
        jp.update_partials(jpack(ops))
    with pytest.raises(tp.PllError) as terr:
        part.update_partials(tp.pack_operations(ops, device=CPU))
    assert terr.value.errno == jerr.value.errno
    with pytest.raises(tp.PllError):
        part.update_partials(jpack(ops), pad_to=8)
