"""The port's CUDA kernel on the card (marker `gpu`; skips without one).

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports jax, which that machine need not
have; this file imports only torch and the port.) The kernel is held against
its plain PyTorch version on the same CUDA tensors: scaler counts equal,
root CLVs to 1e-5 of each site's largest entry (FMA contraction vs
PyTorch's summation order)."""
import numpy as np
import pytest
import torch

from libpll2_tpu_torch import Partition, TreeEngine, compute_gamma_cats
from libpll2_tpu_torch.io import maps
from libpll2_tpu_torch.ops import fused
from libpll2_tpu_torch.ops.pmatrix import update_prob_matrices
from libpll2_tpu_torch.trees import (parse_newick, random_alignment,
                                     random_utree)

pytestmark = pytest.mark.gpu

CHARMAP5 = np.zeros(256, np.uint64)
for _i, _ch in enumerate("ACGTX"):
    CHARMAP5[ord(_ch)] = 1 << _i
CHARMAP5[ord("-")] = 31


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _engine(tree, sites, device, dtype=torch.float32, rates=4, states=4,
            alphabet="ACGT-NRY", seed=3):
    headers, seqs = random_alignment(tree.tip_count, sites,
                                     alphabet=alphabet, seed=seed)
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, rates, tree.inner_count, device=device,
                     dtype=dtype)
    charmap = maps.map_nt if states == 4 else CHARMAP5
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, charmap, by[tip.label])
    rng = np.random.default_rng(seed)
    part.set_frequencies(0, rng.dirichlet(np.ones(states) * 10))
    part.set_subst_params(0, rng.uniform(0.5, 2.0,
                                         size=states * (states - 1) // 2))
    part.set_category_rates(compute_gamma_cats(0.8, rates))
    return part, TreeEngine(part, tree)


def _inputs(part, eng):
    m = eng._model_args()
    pm = update_prob_matrices(m[0], m[1], m[2], m[3], m[4], m[7],
                              eng.branches)
    kw = dict(rates=part.rate_cats, states=part.states,
              n_slots=eng.fused_slots, threshold=part.scale_threshold,
              factor=part.scale_factor)
    return (eng._tip_codes(), pm, eng.table), kw


def _caterpillar(n):
    text = f"t{n - 1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    return parse_newick(f"(t0:0.1,t1:0.1,{text});")


@pytest.mark.parametrize("case", ["ragged", "rates3", "states5",
                                  "caterpillar"])
def test_kernel_matches_plain_on_card(cuda, case):
    if case == "caterpillar":
        part, eng = _engine(_caterpillar(80), 700, cuda, alphabet="ACGT")
    else:
        tree = random_utree([f"t{i}" for i in range(16)], seed=3)
        kw = {"rates3": dict(rates=3),
              "states5": dict(states=5, alphabet="ACGTX-")}.get(case, {})
        part, eng = _engine(tree, 1000, cuda, **kw)
    args, kw = _inputs(part, eng)
    before = fused.fused_traversal.launches
    got = fused.fused_traversal(*args, **kw)
    assert fused.fused_traversal.launches == before + 1
    want = fused.fused_traversal_reference(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        site_max = w.abs().amax(dim=(0, 1)).clamp(min=1e-30)
        assert float(((g - w).abs() / site_max).max()) <= 1e-5
    if case == "caterpillar":
        assert int(want[2].max()) > 0


def test_engine_on_card_matches_cpu_float64(cuda):
    tree = random_utree([f"t{i}" for i in range(24)], seed=5)
    _, gpu = _engine(tree, 3000, cuda)
    _, cpu = _engine(tree, 3000, "cpu", dtype=torch.float64)
    got, want = gpu.loglikelihood(), cpu.loglikelihood()
    assert abs(got - want) / abs(want) < 5e-5
    (gl, g1, g2), (wl, w1, w2) = gpu.newton_step(), cpu.newton_step()
    assert abs(gl - wl) / abs(wl) < 5e-5
    for g, w in ((g1, w1), (g2, w2)):
        assert abs(g - w) / max(abs(w), 10.0) < 5e-3


def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    tree = random_utree([f"t{i}" for i in range(6)], seed=1)
    part, eng = _engine(tree, 64, cuda)
    (codes, pm, table), kw = _inputs(part, eng)
    bad = {
        "float64": (codes, pm.double(), table),
        "non-contiguous": (codes, pm.transpose(2, 3), table),
        "host table": (codes, pm, table.cpu()),
        "int64 codes": (codes.long(), pm, table),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            fused.fused_traversal(*args, **kw)
