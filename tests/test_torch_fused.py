"""The port's fused traversal (libpll2_tpu_torch/ops/fused.py) against
libpll2_tpu on the CPU.

float32: the plain PyTorch version against the JAX Pallas kernel run in
interpret mode on the plane layout (`_fused_kernel_planes`, the kernel the
CUDA one replaces). Scaler counts must be equal; root CLVs agree to 1e-5 of
each site's largest entry (the two sum the state contraction in different
orders, and the error grows with depth: ~1e-6 at 80 levels).

float64: the plain version against the root rows of the JAX XLA scan path
(`TreeEngine(..., pallas=False)`), to 1e-12."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.ops import pallas_fused as jfused

from libpll2_tpu_torch import compute_gamma_cats
from libpll2_tpu_torch import constants as C
from libpll2_tpu_torch.ops import eigen as teigen
from libpll2_tpu_torch.ops import fused as tfused
from libpll2_tpu_torch.ops import pmatrix as tpm
from libpll2_tpu_torch.trees import (create_operations, parse_newick,
                                     random_alignment, random_utree,
                                     traverse)

FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1, 2, 1, 1, 2, 1]


def caterpillar(n):
    """tests/test_pallas.py:52-58."""
    text = f"t{n - 1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    return parse_newick(f"(t0:0.1,t1:0.1,{text});")


def _problem(tree, sites, seed, alphabet="ACGT", pad_to=0):
    """(codes [tips, max(sites, pad_to)] int32, P [E, 4, 4, 4] float64,
    table, n_slots) from numpy: codes padded with zero columns as
    libpll2_tpu/engine.py:1039-1043 pads them for the plane kernel."""
    headers, seqs = random_alignment(tree.tip_count, sites, alphabet=alphabet,
                                     seed=seed)
    by = dict(zip(headers, seqs))
    codes = np.zeros((tree.tip_count, max(sites, pad_to)), np.int32)
    for tip in tree.tips():
        codes[tip.clv_index, :sites] = jmaps.decode_states(
            by[tip.label], jmaps.map_nt).astype(np.int32)
    ops, branches, pidx = create_operations(traverse(tree.vroot))
    root = tree.vroot
    table, n_slots = tfused.pack_fused_schedule(
        ops, tree.tip_count, (root.clv_index, root.back.clv_index))
    blen = np.zeros(tree.edge_count)
    blen[pidx] = branches
    es = teigen.update_eigen(np.asarray(SUBST, float), np.asarray(FREQS))
    pm = tpm.update_prob_matrices(
        torch.tensor(es.eigenvals[None]), torch.tensor(es.inv_evecs[None]),
        torch.tensor(es.evecs[None]), torch.zeros(1, dtype=torch.float64),
        torch.tensor(compute_gamma_cats(0.9, 4)),
        torch.zeros(4, dtype=torch.long), torch.tensor(blen))
    return codes, pm.numpy(), table, n_slots


def _site_rel_err(got, want):
    scale = np.maximum(np.abs(want).max(axis=(0, 1)), 1e-30)
    return float((np.abs(got - want) / scale).max())


@pytest.mark.parametrize("case", ["random16x1024", "caterpillar80"])
def test_plain_traversal_matches_pallas_planes_f32(case):
    if case == "random16x1024":
        tree = random_utree([f"t{i}" for i in range(16)], seed=4)
        codes, pm, table, n_slots = _problem(tree, 1024, seed=4,
                                             alphabet="ACGTTGCA-NRYKM")
    else:
        tree = caterpillar(80)
        codes, pm, table, n_slots = _problem(tree, 1000, seed=3, pad_to=1024)
    pm32 = pm.astype(np.float32)
    kw = dict(rates=4, states=4, n_slots=n_slots,
              threshold=C.SCALE_THRESHOLD_F32, factor=C.SCALE_FACTOR_F32)
    want = jfused.fused_traversal(jnp.asarray(codes), jnp.asarray(pm32),
                                  jnp.asarray(table), interpret=True,
                                  planes=True, **kw)
    got = tfused.fused_traversal(torch.tensor(codes), torch.tensor(pm32),
                                 torch.tensor(table), **kw)
    assert got[0].dtype == torch.float32 and got[2].dtype == torch.int32
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        assert _site_rel_err(g.numpy(), np.asarray(w)) <= 1e-5
    if case == "caterpillar80":
        assert int(got[2].max()) > 0          # scaling triggered


@pytest.mark.parametrize("case", ["random40", "caterpillar200"])
def test_plain_traversal_matches_xla_f64(case):
    if case == "random40":
        tree = random_utree([f"t{i}" for i in range(40)], seed=8)
        sites = 300
    else:
        tree = caterpillar(200)        # deep enough to scale in float64
        sites = 64
    headers, seqs = random_alignment(tree.tip_count, sites,
                                     alphabet="ACGTN-", seed=6)
    by = dict(zip(headers, seqs))
    jp = JPartition(tree.tip_count, tree.inner_count, 4, sites, 1,
                    tree.edge_count, 4, tree.inner_count, dtype=jnp.float64)
    for tip in tree.tips():
        jp.set_tip_states(tip.clv_index, jmaps.map_nt, by[tip.label])
    jp.set_frequencies(0, FREQS)
    jp.set_subst_params(0, SUBST)
    jp.set_category_rates(compute_gamma_cats(0.9, 4))
    eng = JTreeEngine(jp, tree, pallas=False)
    eng.loglikelihood()
    root = tree.vroot

    ops, _, _ = create_operations(traverse(root))
    table, n_slots = tfused.pack_fused_schedule(
        ops, tree.tip_count, (root.clv_index, root.back.clv_index))
    got = tfused.fused_traversal(
        torch.tensor(jfused.tip_code_matrix(jp)),
        torch.tensor(np.asarray(jp.pmatrix)), torch.tensor(table), rates=4,
        states=4, n_slots=n_slots, threshold=C.SCALE_THRESHOLD,
        factor=C.SCALE_FACTOR)
    assert got[0].dtype == torch.float64
    for g, node in ((got[0], root), (got[1], root.back)):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(jp.clv[node.clv_index]),
                                   rtol=1e-12, atol=0)
    sc = np.asarray(jp.scale_buffer)
    for g, node in ((got[2], root), (got[3], root.back)):
        want = (sc[node.scaler_index] if node.scaler_index >= 0
                else np.zeros(sites, np.int32))
        np.testing.assert_array_equal(g.numpy(), want)
    if case == "caterpillar200":
        assert int(got[2].max()) > 0


def test_fused_traversal_cpu_tensors_take_the_plain_version():
    tree = random_utree([f"t{i}" for i in range(6)], seed=1)
    codes, pm, table, n_slots = _problem(tree, 50, seed=1)
    args = (torch.tensor(codes), torch.tensor(pm).float(),
            torch.tensor(table))
    kw = dict(rates=4, states=4, n_slots=n_slots,
              threshold=C.SCALE_THRESHOLD_F32, factor=C.SCALE_FACTOR_F32)
    before = tfused.fused_traversal.launches
    got = tfused.fused_traversal(*args, **kw)
    want = tfused.fused_traversal_reference(*args, **kw)
    assert tfused.fused_traversal.launches == before     # nothing launched
    for g, w in zip(got, want):
        assert torch.equal(g, w)
