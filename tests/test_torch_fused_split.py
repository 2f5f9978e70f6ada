"""The subtree split of the fused kernel's op table
(libpll2_tpu_torch/ops/fused.py:split_fused_schedule), which the 4 x 4
on-chip body of csrc/fused_traversal.cu runs over the blocks of a thread
block cluster, and its plain emulation (`fused_split_reference`).

The split is checked by walking it symbolically: every value a block
computes is named by the op of the packed table that computes it, so a
slot read before it is written, a slot overwritten while it is alive, a
block reading another block's slot, or an op that is run twice or not at
all shows as a name that differs from the packed table's walk. The
emulation must equal `fused_traversal_reference` on the packed table bit for
bit (it runs the same arithmetic on the same children), and JAX's
`_fused_kernel_planes` in interpret mode at the float32 budget of
tests/test_torch_fused.py: counts equal, root CLVs to 1e-5 of each site's
largest entry, logL to TOL_LOGL (5e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from libpll2_tpu.ops import pallas_fused as jfused

from libpll2_tpu_torch import constants as C
from libpll2_tpu_torch.ops import fused as tfused
from libpll2_tpu_torch.ops.fused import (FUSED_REMOTE, FUSED_SPLIT_HEADER,
                                         FusedSplits, fused_split_reference,
                                         fused_traversal_reference,
                                         split_fused_schedule)
from libpll2_tpu_torch.trees import (create_operations, parse_newick,
                                     random_utree, traverse)

PARTS = (1, 2, 4, 8)
TOL_LOGL = 5e-5
SHIFT = tfused.FUSED_RANK_SHIFT


def _table(tree):
    ops, _, _ = create_operations(traverse(tree.vroot))
    root = tree.vroot
    return tfused.pack_fused_schedule(ops, tree.tip_count,
                                      (root.clv_index, root.back.clv_index))


def _caterpillar(n):
    text = f"t{n - 1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    return parse_newick(f"(t0:0.1,t1:0.1,{text});")


def _main_tree():
    """The DNA main path's tree: chip_smoke.py's random_utree of bench.py's
    128 taxa, seed 7."""
    return random_utree([f"t{i}" for i in range(128)], seed=7)


def _repeats_tree():
    """The 246 x 4465 repeats problem's tree (chip_smoke.py:
    flagship_repeats, seed 13)."""
    return random_utree([f"t{i}" for i in range(246)], seed=13)


def _names(table):
    """Each op's name in a packed table's walk: (m1, left, m2, right), a
    tip child (is_tip, index); returns the names in op order and the root
    row's two."""
    slots: dict = {}
    names = []

    def child(is_tip, idx):
        return slots[idx] if is_tip == 0 else (is_tip, idx)

    for row in table[:-1]:
        name = (row[3], child(row[1], row[2]), row[6], child(row[4], row[5]))
        names.append(name)
        slots[row[0]] = name
    root = table[-1]
    return names, (child(root[0], root[1]), child(root[2], root[3]))


def _walk_split(sp):
    """The split table's walk, block by block as the cluster runs it:
    every block's program in its own slots, block 0's last (its top stream
    after the join reads the peers' roots). Returns {rank: names in
    program order}, the top stream's names, the root row's two and the
    remote reads (rank, name)."""
    t = sp.table
    n_ops = len(t) - 1 - FUSED_SPLIT_HEADER
    begin, end, misc = t[n_ops + 1], t[n_ops + 2], t[n_ops + 3]
    join, parts, n_slots = (int(x) for x in misc[:3])
    assert parts == sp.parts and n_slots == sp.n_slots
    slots = [dict() for _ in range(parts)]
    remote = []
    top = []

    def child(is_tip, idx, rank, row_index):
        if is_tip == 0:
            assert idx < n_slots and idx in slots[rank], "read before write"
            return slots[rank][idx]
        if is_tip == FUSED_REMOTE:
            # only block 0's top stream and its root row read a peer
            assert rank == 0 and row_index >= join
            peer, slot = idx >> SHIFT, idx & ((1 << SHIFT) - 1)
            assert 0 < peer < parts and slot in slots[peer]
            remote.append((peer, slots[peer][slot]))
            return slots[peer][slot]
        return (is_tip, idx)

    names = {}
    for rank in list(range(1, parts)) + [0]:
        names[rank] = []
        for i in range(begin[rank], end[rank]):
            row = t[i]
            name = (row[3], child(row[1], row[2], rank, i), row[6],
                    child(row[4], row[5], rank, i))
            assert row[0] < n_slots
            slots[rank][row[0]] = name
            names[rank].append(name)
            if rank == 0 and i >= join:
                top.append(name)
    root = t[n_ops]
    ends = (child(root[0], root[1], 0, n_ops), child(root[2], root[3], 0,
                                                     n_ops))
    return names, top, ends, remote


def _check_split(table, parts):
    """split_fused_schedule(table, parts) against the packed table's walk;
    returns the split."""
    sp = split_fused_schedule(table, parts)
    n_ops = len(table) - 1
    assert sp.table.shape == (n_ops + 1 + FUSED_SPLIT_HEADER, 8)
    assert sp.table.dtype == np.int32
    assert 1 <= sp.parts <= parts
    want, want_ends = _names(table)
    if sp.parts == 1:          # the walk as it is
        np.testing.assert_array_equal(sp.table[:n_ops + 1], table)
        assert sp.critical == n_ops
        assert sp.n_slots == int(table[:n_ops, 0].max()) + 1
        return sp
    names, top, ends, remote = _walk_split(sp)
    got = [x for rank in names for x in names[rank]]
    # every op once, and the root edge's two values the packed walk's
    assert sorted(map(repr, got)) == sorted(map(repr, want))
    assert len(set(map(repr, got))) == n_ops
    assert ends == want_ends
    # each block's stream reads nothing of another block's but block 0's
    # top stream, which reads only subtree roots (values its own top ops
    # or blocks do not consume otherwise) and its own ops
    top_names = set(map(repr, top))
    for peer, name in remote:
        assert repr(name) in set(map(repr, names[peer]))
        assert repr(name) not in top_names
    consumed = {}
    for rank, prog in names.items():
        for name in prog:
            for c in (name[1], name[3]):
                if len(c) == 4:          # an op's value, not a tip
                    consumed.setdefault(repr(c), []).append(rank)
    assert all(len(v) == 1 for v in consumed.values())
    # the critical path: the longest stream, then the top stream
    streams = [len(names[r]) - (len(top) if r == 0 else 0)
               for r in names]
    assert sp.critical == max(streams) + len(top) < n_ops
    return sp


@settings(max_examples=60, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(taxa=st.integers(4, 300), seed=st.integers(0, 10 ** 6),
       parts=st.sampled_from(PARTS))
def test_split_of_random_trees(taxa, seed, parts):
    tree = random_utree([f"t{i}" for i in range(taxa)], seed=seed)
    table, _ = _table(tree)
    _check_split(table, parts)


@pytest.mark.parametrize("parts", PARTS)
def test_split_of_the_main_trees(parts):
    """The DNA main path's 128 taxa (126 ops, 7 slots) and the repeats
    problem's 246 (244 ops, 10 slots) split with a critical path well
    under the walk, and fewer slots a block."""
    for tree, n_ops, n_slots in ((_main_tree(), 126, 7),
                                 (_repeats_tree(), 244, 10)):
        table, slots = _table(tree)
        assert (len(table) - 1, slots) == (n_ops, n_slots)
        sp = _check_split(table, parts)
        assert sp.parts == parts
        assert sp.n_slots <= n_slots
        if parts > 1:
            # within a few top ops of an even share
            assert sp.critical <= -(-n_ops // parts) + 3 * parts


@pytest.mark.parametrize("parts", PARTS)
def test_caterpillar_does_not_split(parts):
    """A caterpillar's subtrees are a chain: no split shortens it, and the
    walk stays whole."""
    table, _ = _table(_caterpillar(80))
    sp = _check_split(table, parts)
    assert sp.parts == 1


def test_split_refuses_more_parts_than_a_cluster():
    table, _ = _table(_main_tree())
    for parts in (0, 9):
        with pytest.raises(ValueError):
            split_fused_schedule(table, parts)


def test_fused_splits_of_host_tables():
    """FusedSplits holds each candidate's split_fused_schedule, by the
    parts, splitting at the first use only: called, the largest slots and
    critical ops over the candidates; `table`, the split tables stacked on
    a device, uploaded once. A single table is one candidate."""
    tables = np.stack([_table(_main_tree())[0],
                       _table(random_utree([f"t{i}" for i in range(128)],
                                           seed=11))[0]])
    splits = FusedSplits(tables)
    assert splits.host.shape == tables.shape
    for parts in PARTS:
        want = [split_fused_schedule(t, parts) for t in tables]
        assert splits(parts) == (max(x.n_slots for x in want),
                                 max(x.critical for x in want))
        assert splits.of(parts) is splits.of(parts)
        got = splits.table(parts, "cpu")
        assert got is splits.table(parts, "cpu")
        np.testing.assert_array_equal(
            got.numpy(), np.stack([x.table for x in want]))
    one = FusedSplits(tables[0])
    assert one.host.shape == (1, *tables[0].shape)
    assert one(4) == (splits.of(4)[0].n_slots, splits.of(4)[0].critical)


def _engine_on_cpu(tree, sites=64):
    """A float32 DNA engine on the fused path, on the CPU."""
    from libpll2_tpu_torch import Partition, TreeEngine
    from libpll2_tpu_torch.io import maps as tmaps

    rng = np.random.default_rng(5)
    part = Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                     tree.edge_count, 4, tree.inner_count,
                     dtype=torch.float32, device="cpu")
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, tmaps.map_nt,
                            "".join(rng.choice(list("ACGT"), size=sites)))
    return part, TreeEngine(part, tree)


def test_engine_splits_its_packed_table():
    """The engine builds its table's FusedSplits from the array it packs
    (no copy back from the device): the splits of the table it uploaded,
    made anew with each topology; each chunk of candidates carries the
    splits of its own tables."""
    tree = _main_tree()
    part, eng = _engine_on_cpu(tree)
    assert eng.execution_path == "fused"
    np.testing.assert_array_equal(eng.fused_splits.host[0],
                                  eng.table.numpy())
    first = eng.fused_splits
    eng.set_topology(random_utree([f"t{i}" for i in range(128)], seed=11))
    assert eng.fused_splits is not first
    np.testing.assert_array_equal(eng.fused_splits.host[0],
                                  eng.table.numpy())
    packed = [eng.pack_candidate(tree.vroot) for _ in range(3)]
    tables = np.stack([q[0] for q in packed])
    chunks = eng._candidate_chunks(
        tables, np.stack([q[1] for q in packed]),
        np.stack([q[2] for q in packed]), np.asarray([q[3] for q in packed]))
    np.testing.assert_array_equal(chunks[0][4].host, tables)


def _inputs(tree, sites, seed, raw_tips=False):
    """numpy-seeded tip codes, P [E, 4, 4, 4] float32, the packed table
    and, with `raw_tips`, raw tip rows for every third tip (is_tip 2)."""
    rng = np.random.default_rng(seed)
    codes = rng.choice([1, 2, 4, 8, 15, 5, 10], size=(tree.tip_count, sites)
                       ).astype(np.int32)
    ops, branches, pidx = create_operations(traverse(tree.vroot))
    root = tree.vroot
    tip_rows = None
    ctips = None
    if raw_tips:
        tip_rows = np.full(tree.tip_count, -1, np.int32)
        chosen = np.arange(0, tree.tip_count, 3)
        tip_rows[chosen] = np.arange(len(chosen))
        ctips = rng.dirichlet(np.ones(4), size=(len(chosen), sites)
                              ).transpose(0, 2, 1).astype(np.float32)
    table, n_slots = tfused.pack_fused_schedule(
        ops, tree.tip_count, (root.clv_index, root.back.clv_index),
        clv_tip_rows=tip_rows)
    # row-stochastic P per edge and rate: exp of a random rate matrix's
    # eigensystem is not needed here, only positive rows that sum to one
    e = tree.edge_count
    pm = rng.dirichlet(np.ones(4), size=(e, 4, 4)).astype(np.float32)
    return codes, pm, table, n_slots, ctips


def _log_l(clv_p, clv_c, sc_p, sc_c, pm_root, rate_scalers):
    """A logL of the root edge from its rows in float64: equal rate
    weights, equal frequencies, each count a factor 2^-64."""
    p = clv_p.astype(np.float64)
    c = np.einsum('rij,rjs->ris', pm_root.astype(np.float64),
                  clv_c.astype(np.float64))
    site_rate = (p * c).sum(axis=1) * 0.25               # [R, S]
    if rate_scalers:
        site_rate = site_rate * np.exp2(-64.0 * (sc_p + sc_c))
        like = site_rate.mean(axis=0)
    else:
        like = site_rate.mean(axis=0) * np.exp2(-64.0 * (sc_p + sc_c))
    return float(np.log(like).sum())


CASES = {"per_site": (False, False), "per_rate": (True, False),
         "raw_tips": (False, True), "raw_per_rate": (True, True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_walk_equals_the_walk(case):
    """The emulation of each split (2, 4, 8 parts) equals the plain walk of
    the packed table to the bit, on the DNA main path's tree at 64 sites
    that rescale (P's rows scaled down), per site and per rate, with and
    without raw tip rows."""
    rate_scalers, raw = CASES[case]
    codes, pm, table, n_slots, ctips = _inputs(_main_tree(), 64, 5, raw)
    pm = pm * 0.05
    kw = dict(rates=4, states=4, threshold=C.SCALE_THRESHOLD_F32,
              factor=C.SCALE_FACTOR_F32, rate_scalers=rate_scalers,
              tip_clvs=None if ctips is None else torch.tensor(ctips))
    args = (torch.tensor(codes), torch.tensor(pm))
    want = fused_traversal_reference(*args, torch.tensor(table),
                                     n_slots=n_slots, **kw)
    assert int(want[2].max()) > 0        # rescaled
    for parts in (2, 4, 8):
        sp = split_fused_schedule(table, parts)
        assert sp.parts == parts
        got = fused_split_reference(*args, torch.tensor(sp.table), **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    # the candidate form: K tables of one length, each its own split
    other, _ = _table(random_utree([f"t{i}" for i in range(128)], seed=8))
    tables = np.stack([table, other])
    pms = torch.tensor(np.stack([pm, pm[::-1].copy()]))
    splits = np.stack([split_fused_schedule(t, 4).table for t in tables])
    got = fused_split_reference(args[0], pms, torch.tensor(splits), **kw)
    want = fused_traversal_reference(args[0], pms, torch.tensor(tables),
                                     n_slots=max(n_slots, 7), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_walk_matches_pallas_planes(case):
    """The emulation of the 4-part split against JAX's plane kernel in
    interpret mode on the same numpy-seeded inputs (a 40-taxon tree, 256
    sites): counts equal, root CLVs to 1e-5 of each site's max, logL to
    TOL_LOGL."""
    rate_scalers, raw = CASES[case]
    tree = random_utree([f"t{i}" for i in range(40)], seed=11)
    codes, pm, table, n_slots, ctips = _inputs(tree, 256, 9, raw)
    pm = pm * 0.1
    kw = dict(rates=4, states=4, threshold=C.SCALE_THRESHOLD_F32,
              factor=C.SCALE_FACTOR_F32, rate_scalers=rate_scalers)
    want = jfused.fused_traversal(
        jnp.asarray(codes), jnp.asarray(pm), jnp.asarray(table),
        n_slots=n_slots, interpret=True, planes=True,
        tip_clvs=None if ctips is None else jnp.asarray(ctips), **kw)
    want = [np.asarray(w) for w in want]
    sp = split_fused_schedule(table, 4)
    assert sp.parts == 4
    got = fused_split_reference(
        torch.tensor(codes), torch.tensor(pm), torch.tensor(sp.table),
        tip_clvs=None if ctips is None else torch.tensor(ctips), **kw)
    got = [g.numpy() for g in got]
    assert int(want[2].max()) > 0
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        scale = np.maximum(np.abs(w).max(axis=(0, 1)), 1e-30)
        assert float((np.abs(g - w) / scale).max()) <= 1e-5
    root_m = int(tree.vroot.pmatrix_index)
    lk = [_log_l(*x, pm[root_m], rate_scalers) for x in (got, want)]
    assert abs(lk[0] - lk[1]) <= TOL_LOGL * abs(lk[1])
