"""Host-side parity of the PyTorch port (libpll2_tpu_torch) with libpll2_tpu.

The port carries its own copies of the numpy host modules (trees, maps,
gamma, eigen, the fused-schedule packer), so that it imports no jax. From
the same seeds and labels they must give results identical to the JAX
package's: `==`, not a tolerance, except where stated."""
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu.trees as jtrees
from libpll2_tpu import Partition as JPartition
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.ops import eigen as jeigen
from libpll2_tpu.ops import gamma as jgamma
from libpll2_tpu.ops import pallas_fused as jfused

import libpll2_tpu_torch.trees as ttrees
from libpll2_tpu_torch import Partition as TPartition
from libpll2_tpu_torch import constants as TC
from libpll2_tpu_torch.io import maps as tmaps
from libpll2_tpu_torch.ops import eigen as teigen
from libpll2_tpu_torch.ops import fused as tfused
from libpll2_tpu_torch.ops import gamma as tgamma

REPO = pathlib.Path(__file__).resolve().parent.parent


def caterpillar(n):
    text = f"t{n - 1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.{i % 7 + 1}"
    return f"(t0:0.1,t1:0.2,{text});"


@pytest.mark.parametrize("n_taxa,sites,seed,alphabet,gap", [
    (5, 40, 0, "ACGT", 0.0), (24, 300, 7, "ACGT", 0.0),
    (16, 120, 3, "ACGT-NRY", 0.0), (10, 64, 11, "ACGT", 0.2)])
def test_random_alignment_identical(n_taxa, sites, seed, alphabet, gap):
    kw = dict(alphabet=alphabet, seed=seed, gap_prob=gap)
    assert (ttrees.random_alignment(n_taxa, sites, **kw)
            == jtrees.random_alignment(n_taxa, sites, **kw))


@pytest.mark.parametrize("seed", [0, 7, 13])
@pytest.mark.parametrize("balanced", [False, True])
def test_random_utree_and_newick_identical(seed, balanced):
    labels = [f"t{i}" for i in range(23)]
    jt = jtrees.random_utree(labels, seed=seed, balanced=balanced)
    tt = ttrees.random_utree(labels, seed=seed, balanced=balanced)
    assert ((tt.tip_count, tt.inner_count, tt.edge_count)
            == (jt.tip_count, jt.inner_count, jt.edge_count))
    assert ttrees.export_newick(tt.vroot) == jtrees.export_newick(jt.vroot)
    assert (ttrees.export_newick(tt.vroot, rooted=True, root_brlen=0.5)
            == jtrees.export_newick(jt.vroot, rooted=True, root_brlen=0.5))


def _node_key(n):
    return (n.label, n.node_index, n.clv_index, n.scaler_index,
            n.pmatrix_index, n.length)


def _op_key(o):
    return (o.parent_clv_index, o.parent_scaler_index, o.child1_clv_index,
            o.child1_matrix_index, o.child1_scaler_index, o.child2_clv_index,
            o.child2_matrix_index, o.child2_scaler_index)


@pytest.mark.parametrize("newick", ["random:1", "random:2", "caterpillar",
                                    "((a:0.1,b:0.2):0.3,c:0.4,(d:0.5,"
                                    "e:0.6):0.7);"])
def test_traverse_create_operations_and_schedule_identical(newick):
    if newick.startswith("random:"):
        labels = [f"t{i}" for i in range(31)]
        seed = int(newick.split(":")[1])
        jt = jtrees.random_utree(labels, seed=seed)
        tt = ttrees.random_utree(labels, seed=seed)
    else:
        text = caterpillar(40) if newick == "caterpillar" else newick
        jt, tt = jtrees.parse_newick(text), ttrees.parse_newick(text)
    jtrav, ttrav = jtrees.traverse(jt.vroot), ttrees.traverse(tt.vroot)
    assert [_node_key(n) for n in ttrav] == [_node_key(n) for n in jtrav]
    jops, jbr, jpi = jtrees.create_operations(jtrav)
    tops, tbr, tpi = ttrees.create_operations(ttrav)
    assert [_op_key(o) for o in tops] == [_op_key(o) for o in jops]
    assert tbr == jbr and tpi == jpi
    pair = (tt.vroot.clv_index, tt.vroot.back.clv_index)
    jtab, jslots = jfused.pack_fused_schedule(jops, jt.tip_count, pair)
    ttab, tslots = tfused.pack_fused_schedule(tops, tt.tip_count, pair)
    assert tslots == jslots
    assert ttab.dtype == jtab.dtype and np.array_equal(ttab, jtab)


def test_pack_fused_schedule_rejects_like_reference():
    tree = ttrees.parse_newick(caterpillar(12))
    ops, _, _ = ttrees.create_operations(ttrees.traverse(tree.vroot))
    pair = (tree.vroot.clv_index, tree.vroot.back.clv_index)
    ops[3].parent_scaler_index = TC.SCALE_BUFFER_NONE
    assert tfused.pack_fused_schedule(ops, tree.tip_count, pair) == (None, 0)
    assert jfused.pack_fused_schedule(ops, tree.tip_count, pair) == (None, 0)


@pytest.mark.parametrize("name", ["map_nt", "map_bin", "map_aa", "map_gt10",
                                  "map_fasta", "map_phylip"])
def test_state_maps_identical(name):
    t, j = getattr(tmaps, name), getattr(jmaps, name)
    assert t.dtype == j.dtype and np.array_equal(t, j)


def test_tip_code_matrix_identical():
    headers, seqs = ttrees.random_alignment(9, 150, alphabet="ACGTU-NRYKMBDHV",
                                            seed=5)
    tree = ttrees.random_utree(headers, seed=5)
    args = (tree.tip_count, tree.inner_count, 4, 150, 1, tree.edge_count, 4,
            tree.inner_count)
    jp = JPartition(*args, dtype=jnp.float32)
    tp = TPartition(*args, dtype=torch.float32)
    by = dict(zip(headers, seqs))
    for tip in tree.tips():
        jp.set_tip_states(tip.clv_index, jmaps.map_nt, by[tip.label])
        tp.set_tip_states(tip.clv_index, tmaps.map_nt, by[tip.label])
    want = jfused.tip_code_matrix(jp)
    got = tfused.tip_code_matrix(tp)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tp.tip_states, jp.tip_states)


@pytest.mark.parametrize("alpha", [0.05, 0.8, 3.0, 50.0])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("mode", [TC.GAMMA_RATES_MEAN,
                                  TC.GAMMA_RATES_MEDIAN])
def test_compute_gamma_cats_matches(alpha, k, mode):
    np.testing.assert_allclose(tgamma.compute_gamma_cats(alpha, k, mode),
                               jgamma.compute_gamma_cats(alpha, k, mode),
                               rtol=1e-14, atol=0)


@pytest.mark.parametrize("seed,states", [(0, 4), (1, 4), (2, 5), (3, 20)])
def test_update_eigen_matches(seed, states):
    rng = np.random.default_rng(seed)
    freqs = rng.dirichlet(np.ones(states) * 3)
    if seed == 1:
        freqs[2] = 1e-9                # eliminated from the eigenproblem
        freqs /= freqs.sum()
    subst = rng.uniform(0.2, 3.0, states * (states - 1) // 2)
    got, want = teigen.update_eigen(subst, freqs), \
        jeigen.update_eigen(subst, freqs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-14, atol=0)
    batch = np.stack([subst, subst[::-1]]), np.stack([freqs, freqs[::-1]])
    for g, w in zip(teigen.update_eigen_batch(*batch),
                    jeigen.update_eigen_batch(*batch)):
        np.testing.assert_allclose(g, w, rtol=1e-14, atol=0)


def test_import_leaves_no_jax():
    code = ("import sys, libpll2_tpu_torch, libpll2_tpu_torch.convert, "
            "libpll2_tpu_torch.ops._kernels; "
            "bad = [m for m in sys.modules "
            "if m == 'jax' or m.startswith('jax.')]; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_do_not_import_jax():
    """No module of the port imports jax or the JAX package, even lazily
    inside a function."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|libpll2_tpu)\b(?!_torch)",
                         re.MULTILINE)
    offenders = [str(p) for p in (REPO / "libpll2_tpu_torch").rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
