"""The port's 20-state protein path against libpll2_tpu on the CPU.

Data modules (`models`, `utils/simulate`, the `map_aa` tip decode) are the
same numpy code: `==`, not a tolerance.

Traversal, float32: the port's plain version against the JAX row-layout
Pallas kernel (`_fused_kernel`, the kernel csrc/fused_traversal_rows.cu
replaces) run in interpret mode, per contraction mode. Scaler counts must
be equal. Root CLVs, relative to each site's largest entry:
  'highest' 1e-5 -- the same exact float32 contraction in another order;
  'split'   5e-5 on both trees -- the same three-term bf16 product (P and
                    every child split by split_bf16, exact products,
                    float32 sums), but a last-bit difference of a float32
                    sum can move a child's hi to the other bf16 neighbour,
                    which moves hi + lo by up to ~2^-16 (measured 1.5e-5 on
                    the 16-taxon tree, 2.1e-5 on the 40-deep caterpillar;
                    an exact float32 'split' was 3.6e-5 and 2.8e-4 away);
  'bf16'    90 % of the sites 1e-5, every site 2^-6 -- both round P and
                    inner children to bf16, but a last-bit difference of a
                    float32 sum can round a child value to the other bf16
                    neighbour, one bf16 step (<= 2^-7 relative) at that
                    site; JAX also rounds the child to nearest-even where
                    the port rounds half-up (exact ties only). Measured on
                    the 16-taxon tree: 14 and 17 of 300 sites beyond 1e-5,
                    at most 7.9e-3.
The same walk at 4 states against the JAX row layout (its exact 'fma'
mode) holds to 1e-5.

Engine: float64 against the JAX XLA path under LG+G4 with pattern weights
and p-inv, to 1e-12 in logL and 1e-10 through three Newton steps (only the
summation order differs); float32 per mode against the JAX fused path in
interpret mode, within bench_validate.py's float32 budgets (TOL_LOGL 5e-5,
TOL_D1 5e-3 with an ATOL_D1 5e-2 floor)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll2_tpu.models as jmodels
import libpll2_tpu.models.aa_data as jaa_data
from libpll2_tpu import Partition as JPartition
from libpll2_tpu import TreeEngine as JTreeEngine
from libpll2_tpu import compute_gamma_cats as j_gamma_cats
from libpll2_tpu.io import maps as jmaps
from libpll2_tpu.ops import pallas_fused as jfused
from libpll2_tpu.trees import random_utree as j_random_utree
from libpll2_tpu.utils import simulate_alignment as j_simulate

import libpll2_tpu_torch as tp
import libpll2_tpu_torch.models as tmodels
import libpll2_tpu_torch.models.aa_data as taa_data
from libpll2_tpu_torch import constants as C
from libpll2_tpu_torch import convert
from libpll2_tpu_torch.io import maps as tmaps
from libpll2_tpu_torch.ops import fused as tfused
from libpll2_tpu_torch.ops.pmatrix import update_prob_matrices
from libpll2_tpu_torch.trees import parse_newick, random_utree
from libpll2_tpu_torch.utils import simulate_alignment

TOL_LOGL, TOL_D1, ATOL_D1 = 5e-5, 5e-3, 5e-2      # bench_validate.py:61-63
CLV_TOL = {("highest", "ragged16x300"): 1e-5,
           ("highest", "caterpillar40"): 1e-5,
           ("split", "ragged16x300"): 5e-5,
           ("split", "caterpillar40"): 5e-5}
N_TAXA, SITES, SEED = 16, 300, 11
AA_NOISY = "ARNDCQEGHILKMFPSTWYVBZJX-?*."


def caterpillar_newick(n):
    text = f"t{n - 1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    return f"(t0:0.1,t1:0.1,{text});"


def _site_errs(got, want):
    scale = np.maximum(np.abs(want).max(axis=(0, 1)), 1e-30)
    return (np.abs(got - want) / scale).max(axis=(0, 1))      # [sites]


def _d_err(got, want):
    return abs(got - want) / max(abs(want), ATOL_D1 / TOL_D1)


# ------------------------------------------------------------ data modules
def test_model_registries_identical():
    assert tmodels.AA_MODEL_NAMES == jmodels.AA_MODEL_NAMES
    assert tmodels.MIXTURE_MODEL_NAMES == jmodels.MIXTURE_MODEL_NAMES
    names = sorted(n for n in dir(jaa_data) if n.startswith("AA_"))
    assert sorted(n for n in dir(taa_data) if n.startswith("AA_")) == names
    for n in names:
        t, j = getattr(taa_data, n), getattr(jaa_data, n)
        assert t.dtype == j.dtype and np.array_equal(t, j), n


@pytest.mark.parametrize("name", jmodels.AA_MODEL_NAMES + ["JTT-DCMut",
                                                           "jttdc"])
def test_aa_model_identical(name):
    for t, j in zip(tmodels.aa_model(name), jmodels.aa_model(name)):
        assert t.dtype == j.dtype and np.array_equal(t, j)


@pytest.mark.parametrize("name", jmodels.MIXTURE_MODEL_NAMES)
def test_mixture_model_identical(name):
    for t, j in zip(tmodels.mixture_model(name), jmodels.mixture_model(name)):
        assert t.shape == (4,) + j.shape[1:]
        assert t.dtype == j.dtype and np.array_equal(t, j)


def test_unknown_models_raise():
    with pytest.raises(KeyError):
        tmodels.aa_model("nosuch")
    with pytest.raises(KeyError):
        tmodels.mixture_model("lg")


@pytest.mark.parametrize("name", jmodels.MIXTURE_MODEL_NAMES)
def test_load_mixture_model_installs_like_jax(name):
    args = (4, 2, 20, 10, 4, 5, 4, 2)
    jp = JPartition(*args, dtype=jnp.float64)
    part = tp.Partition(*args, device="cpu")
    jmodels.load_mixture_model(jp, name)
    tmodels.load_mixture_model(part, name)
    for key in ("subst_params", "frequencies"):
        np.testing.assert_array_equal(getattr(part, key), getattr(jp, key))
    with pytest.raises(ValueError):
        tmodels.load_mixture_model(
            tp.Partition(4, 2, 20, 10, 1, 5, 4, 2, device="cpu"), name)


@pytest.mark.parametrize("states,seed", [(4, 3), (20, 11)])
def test_simulate_alignment_identical(states, seed):
    labels = [f"t{i}" for i in range(12)]
    tt, jt = random_utree(labels, seed=seed), j_random_utree(labels,
                                                             seed=seed)
    if states == 4:
        freqs, subst = [0.3, 0.2, 0.2, 0.3], [1, 2, 1, 1, 2, 1]
    else:
        subst, freqs = tmodels.aa_model("wag")
    kw = dict(alpha=0.9, seed=seed)
    got = simulate_alignment(tt, 200, freqs, subst, **kw)
    assert got == j_simulate(jt, 200, freqs, subst, **kw)
    assert set("".join(got[1])) <= set("ACGT" if states == 4 else
                                       "ARNDCQEGHILKMFPSTWYV")


def _aa_partitions(sites=120, seed=2):
    """The same noisy AA alignment (every map_aa code incl. B, Z, J, X,
    gaps and ?) installed into a JAX and a port partition."""
    rng = np.random.default_rng(seed)
    labels = [f"t{i}" for i in range(9)]
    seqs = ["".join(rng.choice(list(AA_NOISY), size=sites))
            for _ in labels]
    tree = random_utree(labels, seed=seed)
    args = (tree.tip_count, tree.inner_count, 20, sites, 1, tree.edge_count,
            4, tree.inner_count)
    jp = JPartition(*args, dtype=jnp.float32)
    part = tp.Partition(*args, device="cpu")
    for i, s in enumerate(seqs):
        jp.set_tip_states(i, jmaps.map_aa, s)
        part.set_tip_states(i, tmaps.map_aa, s)
    return jp, part


def test_set_tip_states_map_aa_identical():
    jp, part = _aa_partitions()
    assert np.array_equal(part.tip_states, jp.tip_states)
    got, want = tfused.tip_code_matrix(part), jfused.tip_code_matrix(jp)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # B = N|D, Z = Q|E, J = I|L; X, -, ? are every state
    order = tmaps.AA_ORDER
    for ch, states in (("B", "ND"), ("Z", "QE"), ("J", "IL"),
                       ("X", order), ("-", order), ("?", order)):
        assert int(tmaps.map_aa[ord(ch)]) == sum(1 << order.index(c)
                                                 for c in states)


def test_round_bf16_matches_jax_split_hi():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(5000), rng.random(5000) * 1e-30,
                        [0.0, 1.0, 1.00390625, 1.005859375]]
                       ).astype(np.float32)
    hi, _ = jfused.split_bf16(jnp.asarray(x))
    got = tfused.round_bf16(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(hi.astype(jnp.float32)))


# -------------------------------------------------------------- traversal
def _traversal_problem(tree, sites, states=20, seed=SEED):
    """(codes [tips, sites] int32, P [E, 4, s, s] float32, table, n_slots)
    of an alignment simulated under WAG (LG+G4 for the P-matrices), with
    ambiguity codes and gaps sprinkled in."""
    if states == 20:
        subst, freqs = tmodels.aa_model("wag")
        cm = tmaps.map_aa
    else:
        subst, freqs = [1, 2, 1, 1, 2, 1], [0.3, 0.2, 0.2, 0.3]
        cm = tmaps.map_nt
    headers, seqs = simulate_alignment(tree, sites, freqs, subst, alpha=0.9,
                                       seed=seed)
    rng = np.random.default_rng(seed)
    noise = "BZX-" if states == 20 else "NRY-"
    seqs = ["".join(c if rng.random() > 0.05 else rng.choice(list(noise))
                    for c in s) for s in seqs]
    part = tp.Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                        tree.edge_count, 4, tree.inner_count, device="cpu")
    by = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, cm, by[tip.label])
    if states == 20:
        tmodels.load_aa_model(part, "lg")
    else:
        part.set_frequencies(0, freqs)
        part.set_subst_params(0, subst)
    part.set_category_rates(tp.compute_gamma_cats(0.9, 4))
    eng = tp.TreeEngine(part, tree)
    m = eng._model_args()
    pm = update_prob_matrices(m[0], m[1], m[2], m[3], m[4], m[7],
                              eng.branches)
    return (tfused.tip_code_matrix(part), pm.numpy(), eng.table.numpy(),
            eng.fused_slots)


def _jax_rows(codes, pm, table, n_slots, states, mode):
    kw = dict(rates=4, states=states, n_slots=n_slots,
              threshold=C.SCALE_THRESHOLD_F32, factor=C.SCALE_FACTOR_F32)
    return jfused.fused_traversal(jnp.asarray(codes), jnp.asarray(pm),
                                  jnp.asarray(table), interpret=True,
                                  planes=False, mxu=mode, **kw), kw


@pytest.mark.parametrize("mode", ["highest", "split", "bf16"])
@pytest.mark.parametrize("case", ["ragged16x300", "caterpillar40"])
def test_plain_rows_matches_pallas_rows_f32(case, mode):
    if case == "ragged16x300":
        tree = random_utree([f"t{i}" for i in range(N_TAXA)], seed=SEED)
        sites = SITES
    else:
        tree = parse_newick(caterpillar_newick(40))   # scales in float32
        sites = 64
    codes, pm, table, n_slots = _traversal_problem(tree, sites)
    want, kw = _jax_rows(codes, pm, table, n_slots, 20, mode)
    got = tfused.fused_traversal(torch.tensor(codes), torch.tensor(pm),
                                 torch.tensor(table), mxu=mode, **kw)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        errs = _site_errs(g.numpy(), np.asarray(w))
        if mode == "bf16":
            assert np.mean(errs <= 1e-5) >= 0.9
            assert errs.max() <= 2.0 ** -6
        else:
            assert errs.max() <= CLV_TOL[mode, case]
    if case == "caterpillar40":
        assert int(got[2].max()) > 0          # scaling triggered


def test_plain_matches_pallas_rows_dna():
    """At 4 states the JAX row layout runs its exact 'fma' contraction,
    the port its plain version (both ignore mxu below 16 states)."""
    tree = random_utree([f"t{i}" for i in range(N_TAXA)], seed=4)
    codes, pm, table, n_slots = _traversal_problem(tree, 200, states=4)
    want, kw = _jax_rows(codes, pm, table, n_slots, 4, "bf16")
    got = tfused.fused_traversal(torch.tensor(codes), torch.tensor(pm),
                                 torch.tensor(table), mxu="bf16", **kw)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[:2], want[:2]):
        assert _site_errs(g.numpy(), np.asarray(w)).max() <= 1e-5


def test_rows_wrapper_cpu_tensors_take_the_plain_version():
    tree = random_utree([f"t{i}" for i in range(6)], seed=1)
    codes, pm, table, n_slots = _traversal_problem(tree, 40)
    args = (torch.tensor(codes), torch.tensor(pm), torch.tensor(table))
    kw = dict(rates=4, states=20, n_slots=n_slots,
              threshold=C.SCALE_THRESHOLD_F32, factor=C.SCALE_FACTOR_F32)
    before = (tfused.fused_traversal.launches,
              tfused.fused_traversal_rows.launches)
    for mode in tfused.MXU_MODES:
        want = tfused.fused_traversal_reference(*args, mxu=mode, **kw)
        for fn in (tfused.fused_traversal, tfused.fused_traversal_rows):
            for g, w in zip(fn(*args, mxu=mode, **kw), want):
                assert torch.equal(g, w)
    assert (tfused.fused_traversal.launches,
            tfused.fused_traversal_rows.launches) == before
    with pytest.raises(ValueError, match="mxu"):
        tfused.fused_traversal(*args, mxu="fast", **kw)


# ----------------------------------------------------------------- engine
def _alignment():
    tree = j_random_utree([f"t{i}" for i in range(N_TAXA)], seed=SEED)
    subst, freqs = jmodels.aa_model("wag")
    headers, seqs = j_simulate(tree, SITES, freqs, subst, alpha=0.9,
                               seed=SEED)
    # the first 60 columns constant: invariant sites for p-inv
    return tree, headers, [seqs[0][:60] + s[60:] for s in seqs]


def _jax_partition(dtype, pinv=0.0):
    tree, headers, seqs = _alignment()
    jp = JPartition(tree.tip_count, tree.inner_count, 20, SITES, 1,
                    tree.edge_count, 4, tree.inner_count, dtype=dtype)
    by = dict(zip(headers, seqs))
    for tip in tree.tips():
        jp.set_tip_states(tip.clv_index, jmaps.map_aa, by[tip.label])
    jmodels.load_aa_model(jp, "lg")
    jp.set_category_rates(j_gamma_cats(0.9, 4))
    rng = np.random.default_rng(SEED)
    jp.set_pattern_weights(rng.integers(1, 4, size=SITES))
    if pinv:
        jp.update_invariant_sites_proportion(0, pinv)
    return jp, tree


def _state(jp):
    state = {k: getattr(jp, k) for k in convert.STATE_KEYS}
    state["_invariant_valid"] = jp._invariant_valid
    return state


def _port_partition(dtype, pinv=0.0):
    """The port's partition built through its own setters and models
    (on the JAX package's tree, which the port's engine reads as its own,
    as tests/test_torch_engine.py does)."""
    tree, headers, seqs = _alignment()
    part = tp.Partition(tree.tip_count, tree.inner_count, 20, SITES, 1,
                        tree.edge_count, 4, tree.inner_count, device="cpu",
                        dtype=dtype)
    by = dict(zip(headers, seqs))
    tips = tree.tips()
    part.set_tip_states_batch(tmaps.map_aa, [by[t.label] for t in tips],
                              [t.clv_index for t in tips])
    tmodels.load_aa_model(part, "lg")
    part.set_category_rates(tp.compute_gamma_cats(0.9, 4))
    rng = np.random.default_rng(SEED)
    part.set_pattern_weights(rng.integers(1, 4, size=SITES))
    if pinv:
        part.update_invariant_sites_proportion(0, pinv)
    return part, tree


@pytest.mark.parametrize("pinv", [0.0, 0.1])
def test_engine_f64_matches_jax_xla(pinv):
    jp, tree = _jax_partition(jnp.float64, pinv)
    je = JTreeEngine(jp, tree, pallas=False)
    part = convert.partition_from_numpy(_state(jp), device="cpu",
                                        dtype=torch.float64)
    te = tp.TreeEngine(part, tree)
    np.testing.assert_allclose(te.loglikelihood(), je.loglikelihood(),
                               rtol=1e-12)
    root_mat = tree.vroot.pmatrix_index
    for _ in range(3):
        (gl, g1, g2), (wl, w1, w2) = te.newton_step(), je.newton_step()
        np.testing.assert_allclose([gl, g2], [wl, w2], rtol=1e-10)
        # d1 tends to 0 as Newton converges (-3.6e-4 here): held to 1e-10
        # of d2, i.e. the step d1/d2 to 1e-10 in branch-length units
        assert abs(g1 - w1) <= 1e-10 * abs(w2)
        np.testing.assert_allclose(float(te.branches[root_mat]),
                                   float(je.branches[root_mat]), rtol=1e-10)


def test_port_setters_and_models_match_jax_partition():
    """The port's partition built through its own setters, map_aa and
    load_aa_model holds the JAX partition's mirrors, and the same logL."""
    jp, tree = _jax_partition(jnp.float64, pinv=0.1)
    part, ttree = _port_partition(torch.float64, pinv=0.1)
    for key in convert.MIRROR_KEYS:
        np.testing.assert_array_equal(getattr(part, key), getattr(jp, key))
    np.testing.assert_allclose(
        tp.TreeEngine(part, ttree).loglikelihood(),
        JTreeEngine(jp, tree, pallas=False).loglikelihood(), rtol=1e-12)


def test_convert_carries_20_state_partition():
    jp, tree = _jax_partition(jnp.float32, pinv=0.1)
    part = convert.partition_from_numpy(_state(jp), device="cpu",
                                        dtype=torch.float32)
    assert (part.states, part.sites, part.rate_cats) == (20, SITES, 4)
    for key in convert.MIRROR_KEYS:
        np.testing.assert_array_equal(getattr(part, key), getattr(jp, key))
    assert part._invariant_valid


@pytest.mark.parametrize("mode", ["split", "bf16", "highest"])
def test_engine_f32_matches_jax_pallas_interpret(mode):
    jp, tree = _jax_partition(jnp.float32)
    je = JTreeEngine(jp, tree, pallas="interpret", mxu=mode)
    assert je.execution_path == "fused"
    part = convert.partition_from_numpy(_state(jp), device="cpu",
                                        dtype=torch.float32)
    te = tp.TreeEngine(part, tree, mxu=mode)
    assert te.mxu == mode and te.execution_path == "fused"
    got, want = te.loglikelihood(), je.loglikelihood()
    assert abs(got - want) / abs(want) < TOL_LOGL
    for _ in range(3):
        (gl, g1, g2), (wl, w1, w2) = te.newton_step(), je.newton_step()
        assert abs(gl - wl) / abs(wl) < TOL_LOGL
        assert _d_err(g1, w1) < TOL_D1 and _d_err(g2, w2) < TOL_D1


def test_mxu_modes_split_equals_highest_and_accuracy_ladder():
    """Counterpart of tests/test_fused_modes.py's accuracy ordering, the
    ladder against float64: err(highest) <= err(split) <= err(bf16) in
    logL, 'highest' (exact float32) within 1e-6, 'split' (JAX's three-term
    bf16 product, ~2^-17 per operand) within 1e-5, 'bf16' within 1e-3
    (measured 5.3e-8, 1.3e-7 and 4.3e-5); 'split''s Newton derivatives
    within TOL_D1 of 'highest''s."""
    part64, tree = _port_partition(torch.float64)
    ref = tp.TreeEngine(part64, tree).loglikelihood()
    res = {}
    for mode in ("split", "highest", "bf16"):
        part, _ = _port_partition(torch.float32)
        eng = tp.TreeEngine(part, tree, mxu=mode)
        res[mode] = (eng.loglikelihood(), eng.newton_step(),
                     eng.newton_step())
    err = {m: abs(r[0] - ref) for m, r in res.items()}
    assert err["highest"] <= err["split"] <= err["bf16"]
    assert err["highest"] <= abs(ref) * 1e-6
    assert err["split"] <= abs(ref) * 1e-5
    assert err["bf16"] <= abs(ref) * 1e-3
    for got, want in zip(res["split"][1:], res["highest"][1:]):
        assert abs(got[0] - want[0]) / abs(want[0]) < TOL_LOGL
        assert _d_err(got[1], want[1]) < TOL_D1
        assert _d_err(got[2], want[2]) < TOL_D1


def test_mxu_ignored_below_16_states():
    tree = random_utree([f"t{i}" for i in range(8)], seed=2)
    codes, pm, table, n_slots = _traversal_problem(tree, 50, states=4)
    kw = dict(rates=4, states=4, n_slots=n_slots,
              threshold=C.SCALE_THRESHOLD_F32, factor=C.SCALE_FACTOR_F32)
    args = (torch.tensor(codes), torch.tensor(pm), torch.tensor(table))
    for g, w in zip(tfused.fused_traversal(*args, mxu="bf16", **kw),
                    tfused.fused_traversal(*args, mxu="highest", **kw)):
        assert torch.equal(g, w)


def test_mxu_validation():
    part, tree = _port_partition(torch.float32)
    with pytest.raises(tp.PllError, match="mxu"):
        tp.TreeEngine(part, tree, mxu="fast")
    with pytest.raises(tp.PllError, match="mxu"):
        tp.TreeEngine(part, tree, mxu=None)
    assert tp.TreeEngine(part, tree).mxu == "split"


@pytest.mark.parametrize("states", [16, 32])
def test_partition_takes_16_to_32_states(states):
    """16 and 32 states, and 17 more (33, 49: the level and pool kernels'
    64-state instantiations, off the fused kernels); past 64 the uint64 tip
    masks end, and the partition refuses."""
    part = tp.Partition(4, 2, states, 10, 1, 5, 4, 2, device="cpu")
    assert part.states == states
    assert tp.Partition(4, 2, states + 17, 10, 1, 5, 4, 2,
                        device="cpu").states == states + 17
    with pytest.raises(tp.PllError, match="64-bit"):
        tp.Partition(4, 2, states + 49, 10, 1, 5, 4, 2, device="cpu")

