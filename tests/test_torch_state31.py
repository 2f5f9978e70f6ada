"""A 32-state alphabet with tips in state 31 (ROADMAP C-J1).

JAX's row-layout kernel decodes a tip code with `(code & masks) > 0` on
int32 (libpll2_tpu/ops/pallas_fused.py:decode_tip_states), so bit 31, the
sign bit, never tests set: a tip in state 31 decodes to a row of zeros and
its 'fused' path (`pallas="interpret"`) returns -inf. The port decodes the
codes as unsigned (csrc/fused_traversal_rows.cu, the plain version's
shift): its 'fused' path is held to JAX's XLA path (`pallas=False`) at
1e-12 in float64, and in float32 to JAX's float64 value within TOL_LOGL
(bench_validate.py:61-63). JAX's -inf is pinned, so that a change on
either side shows. 6 taxa x 30 sites, equal frequencies and rates, one
category, as ROADMAP C-J1 records the fault."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu.trees import random_utree as j_random_utree

import libpll2_tpu_torch as tp

STATES, TAXA, SITES = 32, 6, 30
LETTERS32 = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdef"
TOL_LOGL = 5e-5


def _charmap():
    """State i as the i-th of LETTERS32 (f is state 31); '-' every state."""
    cm = np.zeros(256, np.uint64)
    for i, ch in enumerate(LETTERS32):
        cm[ord(ch)] = 1 << i
    cm[ord("-")] = (1 << STATES) - 1
    return cm


def _alignment(case):
    """The tips' sequences: 'every_state' random states 0-31 with a column
    of state 31 at every tip; 'state31_tip' one tip wholly in state 31, the
    others random in 0-30; 'gaps' random states with gaps."""
    rng = np.random.default_rng({"every_state": 1, "state31_tip": 2,
                                 "gaps": 3}[case])
    hi = STATES - 1 if case == "state31_tip" else STATES
    cols = rng.integers(0, hi, size=(TAXA, SITES))
    if case == "every_state":
        cols[:, 0] = STATES - 1
    if case == "state31_tip":
        cols[2] = STATES - 1
    seqs = ["".join(LETTERS32[c] for c in row) for row in cols]
    if case == "gaps":
        seqs = [s[:5] + "-" + s[6:] for s in seqs]
        seqs[0] = "f" * SITES
    return [f"t{i}" for i in range(TAXA)], seqs


def _setup(part, tree, headers, seqs):
    by = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, _charmap(), by[tip.label])
    part.set_frequencies(0, np.full(STATES, 1.0 / STATES))
    part.set_subst_params(0, np.ones(STATES * (STATES - 1) // 2))
    part.set_category_rates([1.0])
    return part


def _jax(case, dtype, pallas):
    headers, seqs = _alignment(case)
    tree = j_random_utree(headers, seed=4)
    jp = JPartition(tree.tip_count, tree.inner_count, STATES, SITES, 1,
                    tree.edge_count, 1, tree.inner_count, dtype=dtype)
    _setup(jp, tree, headers, seqs)
    return JTreeEngine(jp, tree, pallas=pallas), tree


def _port(case, dtype, tree):
    headers, seqs = _alignment(case)
    part = tp.Partition(tree.tip_count, tree.inner_count, STATES, SITES, 1,
                        tree.edge_count, 1, tree.inner_count, device="cpu",
                        dtype=dtype)
    _setup(part, tree, headers, seqs)
    return tp.TreeEngine(part, tree)


@pytest.mark.parametrize("case", ["every_state", "state31_tip", "gaps"])
def test_port_fused_holds_state31_to_jax_xla_in_float64(case):
    je, tree = _jax(case, jnp.float64, False)
    want = je.loglikelihood()
    assert np.isfinite(want)
    te = _port(case, torch.float64, tree)
    assert te.execution_path == "fused"
    got = te.loglikelihood()
    assert abs(got - want) / abs(want) < 1e-12
    # the port's float32 'fused' path (the rows kernel's plain version on
    # the CPU) decodes state 31 as well
    te32 = _port(case, torch.float32, tree)
    assert te32.execution_path == "fused"
    assert abs(te32.loglikelihood() - want) / abs(want) < TOL_LOGL


@pytest.mark.parametrize("case", ["every_state", "state31_tip", "gaps"])
def test_jax_fused_kernel_drops_state31(case):
    """JAX's 'fused' engine in float32 (the row-layout Pallas kernel in
    interpret mode) returns -inf wherever a tip is in state 31 alone;
    its XLA path in float32 is finite and agrees with float64."""
    je, _ = _jax(case, jnp.float32, "interpret")
    assert je.execution_path == "fused"
    assert je.loglikelihood() == -np.inf
    xla, _ = _jax(case, jnp.float32, False)
    ref, _ = _jax(case, jnp.float64, False)
    got, want = xla.loglikelihood(), ref.loglikelihood()
    assert abs(got - want) / abs(want) < TOL_LOGL
