#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (libpll2_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

Run from the repository root on a machine with an NVIDIA H100 (sm_90a), the
CUDA toolkit's nvcc and PyTorch built for CUDA; jax is not needed. Phases,
each fatal on failure:

  1. device: a CUDA device, and its name and power limit from nvidia-smi;
  2. build: nvcc builds libpll2_tpu_torch/csrc/*.cu into
     libpll2_tpu_torch/_build/ (first run only);
  3. kernel vs plain: ops/fused.py:fused_traversal (the CUDA kernel) against
     fused_traversal_reference (plain PyTorch) on the card, float32: 16 taxa
     x 1000 ragged sites with gaps and ambiguity codes, an 80-taxon
     caterpillar where scaling must trigger, the 128 x 16384 main-path
     shape, and a 3-category case for the kernel's runtime-size variant;
  4. main path: bench.py's problem (128 taxa x 16384 sites, GTR+G4 DNA,
     seed 7) through Partition(device="cuda") and TreeEngine:
     loglikelihood() and three newton_step()s, counted kernel launches, and
     the same problem through the plain path in float64 on the card;
  5. times: medians over CUDA events of the kernel, the plain traversal,
     one loglikelihood() and one newton_step() at 128 x 16384;
  6. rows kernel vs plain: ops/fused.py:fused_traversal_rows (the CUDA
     kernel for 16 or more states) against the plain version on the card,
     float32: 16 taxa x 1000 ragged AA sites with B/Z/X/gaps, an 80-taxon
     caterpillar where scaling must trigger, a 3-category case, 16- and
     32-state alphabets through a custom charmap, and the protein main
     path's 128 x 8192 shape. Mode 'highest' ('split' runs the same code;
     its outputs must be equal) is held to equal scaler counts and TOL_CLV;
     mode 'bf16' at the logL level (TOL_BF16_LOGL);
  7. protein main path: tools/benchmarks.py:163's problem (128 taxa x 8192
     sites simulated with 20 equal-rate states, alpha 0.9, seed 11,
     evaluated under LG+G4) through Partition(device="cuda") and
     TreeEngine: loglikelihood() and three newton_step()s in the default
     mxu='split', one loglikelihood() with mxu='bf16', counted rows-kernel
     launches, and the same problem through the plain path in float64 on
     the card;
  8. times at 128 x 8192: the rows kernel and its plain version per mode,
     one loglikelihood() and one newton_step();
  9. level kernel vs plain: ops/levels.py:level_update (csrc/level_update.cu)
     against level_update_reference over whole op lists on the card,
     float32, from the same buffers: 16 x 1000 ragged DNA, 3 categories,
     the 80-taxon caterpillar (scaling must trigger), 20 and 32 states, ops
     without a scaler buffer, a partial op list, and 128 x 16384; scaler
     rows equal and CLV rows within TOL_CLV;
 10. the dense paths at full width (DNA 128 x 16384 GTR+G4, protein 128 x
     8192 LG+G4), through the level kernel: the step-by-step chain
     (Partition(device="cuda") -> update_prob_matrices -> update_partials ->
     compute_edge_loglikelihood, compute_node_ancestral -> update_sumtable ->
     compute_likelihood_derivatives), a partial traversal after one branch
     length changes (equal to the full one), TreeEngine(pallas=
     "levels-kernel") with loglikelihood() and three newton_step()s, the
     DNA tree rooted for compute_root_loglikelihood, and LG4X through
     update_prob_matrices([0, 1, 2, 3], ...); each against the float64
     plain path on the card, with the level-kernel launches counted (one
     per level of each traversal);
 11. times of the level kernel over one traversal and its plain version,
     one loglikelihood() on the levels-kernel path and one step-by-step
     traversal, at both sizes; and of the level kernel and its plain
     version over the 80-taxon caterpillar (78 levels of one op each) at
     16384 sites;
 12. pool kernel vs plain: ops/pool.py:pool_update (csrc/pool_update.cu)
     against pool_update_reference over whole op lists on site-repeats
     partitions, float32, from the same buffers: 24 x 600 DNA, the
     150-taxon caterpillar x 300 (scaling must trigger), 3 categories, 20
     conserved states, a partial op list, ops without a scaler buffer,
     bench.py's 128 x 16384 random columns (repeats off at most inner
     nodes: identity ops at full width), the 246 x 4465 conserved problem
     and the 128 x 8192 conserved protein; scaler regions equal and class
     columns within TOL_CLV of each column's max;
 13. the site-repeats paths at full width: tools/benchmarks.py:221-254's
     246 taxa x 4465 conserved sites, GTR+G4, through the step-by-step
     chain on Partition(site_repeats=True, device="cuda"), a partial
     traversal (equal to the full one), TreeEngine(pallas="pool") with
     loglikelihood() and three newton_step()s, the default TreeEngine
     ('repeats-dense-fused': fused-kernel launches counted, and the kernel
     held against its plain version at this shape) and edge_params with
     two rate matrices; and the conserved 128 x 8192 LG+G4 protein on
     'pool-pallas'; each against the float64 plain dense path on the card,
     pool-kernel launches counted (one per level of each traversal), with
     the class columns' share of plain work, the pooled buffers' size
     against the dense ones and the host schedule time;
 14. times at 246 x 4465: the pool kernel over one traversal and its plain
     version (and its bound from the class counts), the fused kernel and
     its plain version on the 'repeats-dense-fused' inputs,
     loglikelihood() on 'pool-pallas', 'repeats-dense-fused' and a dense
     partition's fused path, one step-by-step traversal; and torch.matmul
     of tools/mxu_probe.py's [80, 80] @ [80, 512] in float32 and bf16.

The last three lines are the card's name and power limit, one JSON object
listing every kernel (with its bound at the card's peaks), and {"ok": true,
"device": ...}.
Exits non-zero, printing no result, when there is no CUDA device.
`--profile DIR` also writes a torch.profiler breakdown of one
loglikelihood() and one newton_step() of each main path (fused and
levels-kernel) to DIR/profile.txt.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

N_TAXA, N_SITES, SEED = 128, 16384, 7       # bench.py:25-29
AA_TAXA, AA_SITES, AA_SEED = 128, 8192, 11   # tools/benchmarks.py:163
# AA columns with ambiguity codes and gaps (B = N|D, Z = Q|E, X = any)
AA_NOISY = "ARNDCQEGHILKMFPSTWYV" * 2 + "BZX-"
LETTERS32 = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdef"
# Root CLVs: kernel vs plain version, both float32, relative to each site's
# largest entry. The kernel's FMAs round differently from PyTorch's einsum
# order; the error grows with the tree's depth (about 1e-6 at 80 levels).
TOL_CLV = 1e-5
# float32 main path vs the float64 plain path (bench_validate.py:61-63):
# logL sums ~1e-7-relative per-site logs; derivatives lose 2-3 digits.
TOL_LOGL = 5e-5
TOL_D1 = 5e-3
ATOL_D1 = 5e-2
# 'bf16' mode, rows kernel vs plain version: both round the same operands to
# bf16, but a last-bit difference of a float32 sum can round a value to the
# other bf16 neighbour, so the two are held at the logL level
TOL_BF16_LOGL = 1e-4
# mxu_probe kernel vs plain, relative to the output's largest entry: 'f32'
# adds the same float32 products in another order; 'bf16' and 'split' go
# through the tensor cores, whose float32 accumulation rounds toward zero
# (a bias of ~1e-5 over the probe's sums), which also bounds 'split' against
# the float64 product
TOL_PROBE = 1e-5
TOL_PROBE_MMA = 5e-5
# Scaler counts, kernel vs plain version: equal, except at ties (a block max
# within TOL_TIE of the threshold, which the two FMA orders round to opposite
# sides: `match_counts`), at most MAX_TIES of them in one comparison
TOL_TIE = 1e-5
MAX_TIES = 8
# ancestral state probabilities (normalised per site), float32 step-by-step
# path vs the float64 plain path, absolute
TOL_ANC = 1e-4
REPS = 25
WARMUP = 3
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s and float32 FLOP/s
# outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12
H100_BF16_FLOP_PER_S = 989e12      # dense, tensor cores


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def match_counts(name, got_sc, want_sc, got_clv, want_clv, block, factor,
                 threshold) -> int:
    """Hold a kernel's scaler counts to its plain version's. They may
    differ only at a tie: a block whose max lies within rounding of the
    threshold, which the two versions' different FMA order puts on opposite
    sides of it. There the counts differ by one, the block's values by
    `factor` (to TOL_CLV), and the smaller of the two maxima is the
    threshold to TOL_TIE; `want_clv` is brought to the kernel's scale in
    place, so that the values can be compared after. At most MAX_TIES such
    entries. `block(entry)` gives the index into the CLVs of the block a
    count entry scales. Returns the number of ties."""
    diff = got_sc.long() - want_sc.long()
    entries = diff.nonzero().tolist()
    check(len(entries) <= MAX_TIES, f"{name}: scaler counts differ at "
          f"{len(entries)} entries")
    for e in entries:
        d = int(diff[tuple(e)])
        b = block(tuple(e))
        g, w = got_clv[b], want_clv[b] * factor ** d
        rel = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
        low = min(float(got_clv[b].max()), float(want_clv[b].max()))
        tie = abs(low / threshold - 1.0)
        print(f"  {name}: tie at count entry {e}: counts differ by {d}, "
              f"values by factor**{d} to {rel:.2e}, unscaled max = "
              f"threshold * (1 {'+' if low >= threshold else '-'} "
              f"{tie:.1e})", flush=True)
        check(abs(d) == 1 and rel <= TOL_CLV and tie <= TOL_TIE,
              f"{name}: counts differ at {e} by {d}, not at a tie (values "
              f"{rel:.2e}, max {tie:.2e} off the threshold)")
        want_clv[b] = w
    return len(entries)


def gpu_name_and_power() -> str:
    res = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip() != "",
          f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def caterpillar_newick(n: int = 80) -> str:
    """tests/test_pallas.py:52-58: a caterpillar deep enough that float32
    CLVs underflow the 2^-32 window."""
    text = f"t{n - 1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    return f"(t0:0.1,t1:0.1,{text});"


def dna_model():
    """bench.py:39-60's GTR frequencies and rates (seed 7)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    return rng.dirichlet(np.ones(4) * 10), rng.uniform(0.5, 2.0, size=6)


def dna_partition(tree, by_label, sites, device, rate_cats=4, **options):
    """bench.py:39-60's problem on `device` in float32 (`tree` rooted or
    unrooted); `options` (rate_scalers, asc_bias) go to Partition."""
    import torch
    from libpll2_tpu_torch import Partition, compute_gamma_cats
    from libpll2_tpu_torch.io import maps

    part = Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                     tree.edge_count, rate_cats, tree.inner_count,
                     device=device, dtype=torch.float32, **options)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    freqs, subst = dna_model()
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, subst)
    part.set_category_rates(compute_gamma_cats(0.8, rate_cats))
    return part


def build_engine(tree, by_label, sites, device, rate_cats=4, **options):
    """`dna_partition` and a TreeEngine on its default (fused) path."""
    from libpll2_tpu_torch import TreeEngine

    part = dna_partition(tree, by_label, sites, device, rate_cats, **options)
    return part, TreeEngine(part, tree)


def traversal_inputs(eng):
    """(tip codes, P-matrices, table) of an engine, as its main path
    hands them to the kernel."""
    from libpll2_tpu_torch.ops.pmatrix import update_prob_matrices

    m = eng._model_args()
    pm = update_prob_matrices(m[0], m[1], m[2], m[3], m[4], m[7],
                              eng.branches)
    return eng._tip_codes(), pm, eng.table


def compare_case(name, tree, by_label, sites, device, rate_cats=4,
                 must_scale=False, **options):
    """Kernel vs plain traversal on one problem; returns (max relative
    error, max absolute error)."""
    part, eng = build_engine(tree, by_label, sites, device, rate_cats,
                             **options)
    return compare_traversal(name, part, eng, must_scale)


def root_block(part):
    """`match_counts`' block of a root-row count entry: the site's rows of
    all rates, or of the entry's rate with per-rate counts."""
    if part.rate_scalers:
        return lambda e: (e[0], slice(None), e[1])
    return lambda e: (slice(None), slice(None), e[0])


def traversal_kw(part, eng):
    """The keyword arguments of the fused traversal for an engine's
    partition: sizes, scaling, per-rate mode and raw tip rows."""
    return dict(rates=part.rate_cats, states=part.states,
                n_slots=eng.fused_slots, threshold=part.scale_threshold,
                factor=part.scale_factor, rate_scalers=part.rate_scalers,
                tip_clvs=eng._tip_clvs())


def compare_traversal(name, part, eng, must_scale=False):
    """Kernel vs plain traversal on the inputs a fused engine hands the
    kernel, in the partition's modes (per-rate counts compared per rate;
    with `must_scale` 'rates' in per-rate mode, some rate categories must
    rescale at sites where others do not); returns (max relative error,
    max absolute error)."""
    import torch
    from libpll2_tpu_torch.ops.fused import (fused_traversal,
                                             fused_traversal_reference)

    codes, pm, table = traversal_inputs(eng)
    kw = traversal_kw(part, eng)
    got = fused_traversal(codes, pm, table, **kw)
    want = fused_traversal_reference(codes, pm, table, **kw)
    torch.cuda.synchronize()
    ties = sum(match_counts(f"{name}, {which}", g_sc, w_sc, g_clv, w_clv,
                            root_block(part), part.scale_factor,
                            part.scale_threshold)
               for g_sc, w_sc, g_clv, w_clv, which in (
                   (got[2], want[2], got[0], want[0], "parent"),
                   (got[3], want[3], got[1], want[1], "child")))
    rel, abs_err = 0.0, 0.0
    for g, w in zip(got[:2], want[:2]):
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite CLVs")
        site_max = w.abs().amax(dim=(0, 1)).clamp(min=1e-30)
        rel = max(rel, float(((g - w).abs() / site_max).max()))
        abs_err = max(abs_err, float((g - w).abs().max()))
    scaled = int(max(want[2].max(), want[3].max()))
    mixed = 0
    if part.rate_scalers:     # sites where some rates rescaled, others not
        mixed = int((want[2].amax(0) != want[2].amin(0)).sum())
    raw = int((table[:-1, [1, 4]] == 2).sum())
    print(f"kernel vs plain [{name}]: {part.tips} taxa x {part.sites} sites,"
          f" {part.rate_cats} rates, {len(table) - 1} ops, "
          f"{eng.fused_slots} slots"
          + (", per-rate counts" if part.rate_scalers else "")
          + (f", {raw} raw-tip children" if raw else "")
          + f": scaler counts equal (max {scaled}"
          + (f", rates differing at {mixed} sites" if part.rate_scalers
             else "") + (f"; {ties} ties" if ties else "")
          + f"), max_rel_err {rel:.3e}, max_abs_err {abs_err:.3e}",
          flush=True)
    check(rel <= TOL_CLV, f"{name}: max_rel_err {rel:.3e} > {TOL_CLV}")
    if must_scale:
        check(scaled > 0, f"{name}: scaling never triggered")
    if must_scale == "rates":
        check(mixed > 0, f"{name}: the rate categories never rescaled "
              f"apart")
    return rel, abs_err


def plain_float64(part, eng, branches):
    """(logL, d1, d2) of the main path's first Newton step at `branches`,
    through the plain traversal in float64 on the card."""
    import torch
    from libpll2_tpu_torch import constants as C
    from libpll2_tpu_torch.engine import _fused_newton_step
    from libpll2_tpu_torch.ops.fused import fused_traversal_reference

    f64, dev = torch.float64, eng.device
    model = [torch.tensor(a, dtype=f64, device=dev) for a in (
        part.eigenvals, part.inv_eigenvecs, part.eigenvecs, part.prop_invar,
        part.rates, part.rate_weights, part.frequencies)]
    pw, inv = eng._site_args()
    total, d1, d2 = _fused_newton_step(
        *model, eng.params_idx_rates, branches.to(f64), eng.table,
        eng._tip_codes(), eng.root_idx[4], pw, inv, eng.fused_slots,
        C.SCALE_THRESHOLD, C.SCALE_FACTOR,
        traversal=fused_traversal_reference, **eng._fused_kw())[:3]
    return float(total), float(d1), float(d2)


def main_path(device):
    """Phase 4. Returns (engine, partition, launches)."""
    import torch
    from libpll2_tpu_torch.ops.fused import (fused_traversal,
                                             fused_traversal_rows)
    from libpll2_tpu_torch.trees import random_alignment, random_utree

    headers, seqs = random_alignment(N_TAXA, N_SITES, seed=SEED)
    tree = random_utree(headers, seed=SEED)
    part, eng = build_engine(tree, dict(zip(headers, seqs)), N_SITES,
                             device)
    check(eng.execution_path == "fused",
          f"execution_path is {eng.execution_path!r}")
    inputs = [eng.branches.clone()]
    fused_traversal.launches = 0
    fused_traversal_rows.launches = 0
    lnl = eng.loglikelihood()
    steps = []
    for _ in range(3):
        inputs.append(eng.branches.clone())
        steps.append(eng.newton_step())
    launches = fused_traversal.launches
    rows_launches = fused_traversal_rows.launches
    print(f"main path: {N_TAXA} taxa x {N_SITES} sites GTR+G4, "
          f"execution_path={eng.execution_path}, {eng.fused_slots} slots, "
          f"{len(eng.table) - 1} ops; loglikelihood() = {lnl!r}; kernel "
          f"launches in loglikelihood() + 3 newton_step() = {launches}, "
          f"rows kernel launches = {rows_launches}", flush=True)
    check(launches >= 4, f"only {launches} kernel launches on the main "
          f"path")
    check(rows_launches == 0, "the DNA main path launched the rows kernel")
    check(math.isfinite(lnl), "logL is not finite")
    for i, (lk, d1, d2) in enumerate(steps):
        print(f"  newton_step {i + 1}: logL {lk!r} d1 {d1!r} d2 {d2!r}",
              flush=True)
        check(all(map(math.isfinite, (lk, d1, d2))),
              f"newton_step {i + 1}: non-finite result")
    print(f"  root branch after 3 steps: "
          f"{float(eng.branches[eng.root_idx[4]])!r}", flush=True)

    # the float32 kernel path against the plain float64 path on the card,
    # at the same branch lengths
    rows = [(lnl, None, None)] + steps
    for i, ((lk, d1, d2), b) in enumerate(zip(rows, inputs)):
        ref = plain_float64(part, eng, b)
        rel = abs(lk - ref[0]) / abs(ref[0])
        what = "loglikelihood()" if i == 0 else f"newton_step {i}"
        line = f"  float64 plain path, {what}: logL {ref[0]!r} (rel {rel:.2e})"
        check(rel < TOL_LOGL, f"{what}: logL rel err {rel:.2e} >= "
              f"{TOL_LOGL}")
        if d1 is not None:
            e1 = abs(d1 - ref[1]) / max(abs(ref[1]), ATOL_D1 / TOL_D1)
            e2 = abs(d2 - ref[2]) / max(abs(ref[2]), ATOL_D1 / TOL_D1)
            line += (f", d1 {ref[1]!r} (err {e1:.2e}), d2 {ref[2]!r} "
                     f"(err {e2:.2e})")
            check(e1 < TOL_D1 and e2 < TOL_D1,
                  f"{what}: d1/d2 err {e1:.2e}/{e2:.2e} >= {TOL_D1}")
        print(line, flush=True)
    torch.cuda.synchronize()
    return eng, part, launches


def charmap(states: int):
    """map_aa for 20 states; otherwise the first `states` of LETTERS32,
    with '-' for every state."""
    import numpy as np
    from libpll2_tpu_torch.io import maps

    if states == 20:
        return maps.map_aa
    cm = np.zeros(256, np.uint64)
    for i, ch in enumerate(LETTERS32[:states]):
        cm[ord(ch)] = 1 << i
    cm[ord("-")] = (1 << states) - 1
    return cm


def protein_partition(tree, by_label, sites, device, states=20,
                      rate_cats=4, mixture=None, **options):
    """LG+G4 (alpha 0.9) on `device` in float32, tips installed in one
    batch; other alphabets get random GTR parameters from SEED. `mixture`
    ('lg4x') installs one matrix per category instead (rate_matrices 4);
    `options` (rate_scalers, asc_bias) go to Partition."""
    import numpy as np
    import torch
    from libpll2_tpu_torch import Partition, compute_gamma_cats
    from libpll2_tpu_torch.models import load_aa_model, load_mixture_model

    part = Partition(tree.tip_count, tree.inner_count, states, sites,
                     4 if mixture else 1, tree.edge_count, rate_cats,
                     tree.inner_count, device=device, dtype=torch.float32,
                     **options)
    tips = list(tree.tips())
    part.set_tip_states_batch(charmap(states),
                              [by_label[t.label] for t in tips],
                              [t.clv_index for t in tips])
    if mixture:
        load_mixture_model(part, mixture)
    elif states == 20:
        load_aa_model(part, "lg")
    else:
        rng = np.random.default_rng(SEED)
        part.set_frequencies(0, rng.dirichlet(np.ones(states) * 10))
        part.set_subst_params(0, rng.uniform(0.5, 2.0,
                                             states * (states - 1) // 2))
    part.set_category_rates(compute_gamma_cats(0.9, rate_cats))
    return part


def build_protein_engine(tree, by_label, sites, device, states=20,
                         rate_cats=4):
    """`protein_partition` and a TreeEngine on its default (fused) path."""
    from libpll2_tpu_torch import TreeEngine

    part = protein_partition(tree, by_label, sites, device, states,
                             rate_cats)
    return part, TreeEngine(part, tree)


def compare_rows_case(name, tree, by_label, sites, device, states=20,
                      rate_cats=4, must_scale=False):
    """Rows kernel vs plain traversal on one problem: 'highest' (and
    'split', the same code) to equal counts and TOL_CLV, 'bf16' at the logL
    level. Returns (max relative error, max absolute error)."""
    part, eng = build_protein_engine(tree, by_label, sites, device, states,
                                     rate_cats)
    return compare_rows_traversal(name, part, eng, must_scale)


def compare_rows_traversal(name, part, eng, must_scale=False):
    """`compare_rows_case` on the inputs a fused engine hands the rows
    kernel, in the partition's modes (per-rate counts, raw tips)."""
    import torch
    from libpll2_tpu_torch.engine import _fused_loglikelihood
    from libpll2_tpu_torch.ops.fused import (fused_traversal,
                                             fused_traversal_reference)

    codes, pm, table = traversal_inputs(eng)
    kw = traversal_kw(part, eng)
    got = fused_traversal(codes, pm, table, mxu="highest", **kw)
    split = fused_traversal(codes, pm, table, mxu="split", **kw)
    want = fused_traversal_reference(codes, pm, table, mxu="highest", **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(split, got)),
          f"{name}: mxu='split' differs from mxu='highest'")
    ties = sum(match_counts(f"{name}, {which}", g_sc, w_sc, g_clv, w_clv,
                            root_block(part), part.scale_factor,
                            part.scale_threshold)
               for g_sc, w_sc, g_clv, w_clv, which in (
                   (got[2], want[2], got[0], want[0], "parent"),
                   (got[3], want[3], got[1], want[1], "child")))
    rel, abs_err = 0.0, 0.0
    for g, w in zip(got[:2], want[:2]):
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite CLVs")
        site_max = w.abs().amax(dim=(0, 1)).clamp(min=1e-30)
        rel = max(rel, float(((g - w).abs() / site_max).max()))
        abs_err = max(abs_err, float((g - w).abs().max()))
    scaled = int(max(want[2].max(), want[3].max()))
    check(rel <= TOL_CLV, f"{name}: max_rel_err {rel:.3e} > {TOL_CLV}")
    if must_scale:
        check(scaled > 0, f"{name}: scaling never triggered")

    # 'bf16': the kernel path against the plain path, at the logL level
    lk, rows = [], []
    for trav in (fused_traversal, fused_traversal_reference):
        total, _, r, _ = _fused_loglikelihood(*eng._args(), traversal=trav,
                                              mxu="bf16", **eng._fused_kw())
        lk.append(float(total))
        rows.append(r)
    torch.cuda.synchronize()
    bf_rel = abs(lk[0] - lk[1]) / abs(lk[1])
    sc_diff = sum(int((rows[0][i] != rows[1][i]).sum()) for i in (2, 3))
    raw = int((table[:-1, [1, 4]] == 2).sum())
    print(f"rows kernel vs plain [{name}]: {part.tips} taxa x {part.sites} "
          f"sites, {part.states} states, {part.rate_cats} rates, "
          f"{eng.fused_slots} slots"
          + (", per-rate counts" if part.rate_scalers else "")
          + (f", {raw} raw-tip children" if raw else "")
          + f": highest/split scaler counts equal (max {scaled}"
          + (f"; {ties} ties" if ties else "") + "), "
          f"max_rel_err {rel:.3e}, max_abs_err {abs_err:.3e}; bf16 logL "
          f"rel {bf_rel:.3e}, bf16 scaler counts differing at {sc_diff} "
          f"sites", flush=True)
    check(math.isfinite(lk[0]) and bf_rel < TOL_BF16_LOGL,
          f"{name}: bf16 logL rel err {bf_rel:.3e} >= {TOL_BF16_LOGL}")
    return rel, abs_err


def protein_alignment():
    """tools/benchmarks.py:38-66 at 128 x 8192: 20 equal-rate states,
    alpha 0.9, seed 11. Returns (tree, {label: sequence})."""
    import numpy as np
    from libpll2_tpu_torch.trees import random_utree
    from libpll2_tpu_torch.utils import simulate_alignment

    tree = random_utree([f"t{i}" for i in range(AA_TAXA)], seed=AA_SEED)
    headers, seqs = simulate_alignment(tree, AA_SITES, np.full(20, 0.05),
                                       np.ones(190), alpha=0.9,
                                       seed=AA_SEED)
    return tree, dict(zip(headers, seqs))


def protein_main_path(device, tree, by_label):
    """Phase 7. Returns (engine, partition, rows-kernel launches)."""
    import torch
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.ops.fused import (fused_traversal,
                                             fused_traversal_rows)

    part, eng = build_protein_engine(tree, by_label, AA_SITES, device)
    eng_bf16 = TreeEngine(part, tree, mxu="bf16")
    check(eng.mxu == "split" and eng.execution_path == "fused",
          f"engine mxu {eng.mxu!r}, path {eng.execution_path!r}")
    inputs = [eng.branches.clone()]
    fused_traversal.launches = 0
    fused_traversal_rows.launches = 0
    lnl = eng.loglikelihood()
    steps = []
    for _ in range(3):
        inputs.append(eng.branches.clone())
        steps.append(eng.newton_step())
    lnl_bf16 = eng_bf16.loglikelihood()
    launches = fused_traversal_rows.launches
    dna_launches = fused_traversal.launches
    print(f"protein main path: {AA_TAXA} taxa x {AA_SITES} sites LG+G4, "
          f"{eng.fused_slots} slots, {len(eng.table) - 1} ops; "
          f"loglikelihood() = {lnl!r} (mxu='split'), {lnl_bf16!r} "
          f"(mxu='bf16'); rows kernel launches in 2 loglikelihood() + 3 "
          f"newton_step() = {launches}, DNA kernel launches = "
          f"{dna_launches}", flush=True)
    check(launches >= 5, f"only {launches} rows-kernel launches on the "
          f"protein main path")
    check(dna_launches == 0, "the protein main path launched the DNA kernel")
    check(math.isfinite(lnl) and math.isfinite(lnl_bf16),
          "logL is not finite")
    for i, (lk, d1, d2) in enumerate(steps):
        print(f"  newton_step {i + 1}: logL {lk!r} d1 {d1!r} d2 {d2!r}",
              flush=True)
        check(all(map(math.isfinite, (lk, d1, d2))),
              f"newton_step {i + 1}: non-finite result")
    rows = [(lnl, None, None)] + steps
    refs = [plain_float64(part, eng, b) for b in inputs]
    for i, ((lk, d1, d2), ref) in enumerate(zip(rows, refs)):
        rel = abs(lk - ref[0]) / abs(ref[0])
        what = "loglikelihood()" if i == 0 else f"newton_step {i}"
        line = f"  float64 plain path, {what}: logL {ref[0]!r} (rel {rel:.2e})"
        check(rel < TOL_LOGL, f"{what}: logL rel err {rel:.2e} >= "
              f"{TOL_LOGL}")
        if d1 is not None:
            e1 = abs(d1 - ref[1]) / max(abs(ref[1]), ATOL_D1 / TOL_D1)
            e2 = abs(d2 - ref[2]) / max(abs(ref[2]), ATOL_D1 / TOL_D1)
            line += (f", d1 {ref[1]!r} (err {e1:.2e}), d2 {ref[2]!r} "
                     f"(err {e2:.2e})")
            check(e1 < TOL_D1 and e2 < TOL_D1,
                  f"{what}: d1/d2 err {e1:.2e}/{e2:.2e} >= {TOL_D1}")
        print(line, flush=True)
    ref0 = refs[0][0]
    err_split = abs(lnl - ref0) / abs(ref0)
    err_bf16 = abs(lnl_bf16 - ref0) / abs(ref0)
    print(f"  accuracy ladder vs float64: mxu='split' {err_split:.3e}, "
          f"mxu='bf16' {err_bf16:.3e} (relative logL)", flush=True)
    check(err_bf16 > err_split, "mxu='bf16' is not looser than 'split'")
    torch.cuda.synchronize()
    return eng, part, launches


def run_levels(part, ops, level):
    """`ops` through ops/levels.py level by level on `part`'s buffers, each
    level run by `level` (the wrapper or its plain version); returns the
    number of levels."""
    from libpll2_tpu_torch.ops import levels

    tables = levels.tables_to_device(levels.pack_pallas_levels(
        ops, part.tips, part.scale_buffers + 1, part.scale_buffers),
        part.device)
    levels.update_partials_kernel(part.clv, part.scale_buffer, part.pmatrix,
                                  tables, part.scale_threshold,
                                  part.scale_factor, level=level)
    return len(tables)


def traversal_ops(part, tree):
    """(ops, branches, pmatrix indices) of the full postorder, with the
    partition's P-matrices set from them."""
    from libpll2_tpu_torch.trees import create_operations, traverse

    ops, br, pidx = create_operations(traverse(tree.vroot))
    part.update_prob_matrices([0] * part.rate_cats, pidx, br)
    return ops, br, pidx


def compare_level_case(name, part, ops, first=None, must_scale=False):
    """Level kernel vs its plain version over a whole op list on the
    card, from the same buffers (after `first`, the list that must run
    before a partial one): scaler rows equal but at ties (`match_counts`),
    CLV rows within TOL_CLV of each site's max. Returns (max relative
    error, max absolute error)."""
    import torch
    from libpll2_tpu_torch.ops import levels

    if first is not None:
        run_levels(part, first, levels.level_update)
    clv, sc = part.clv.clone(), part.scale_buffer.clone()
    n_levels = run_levels(part, ops, levels.level_update)
    got_clv, got_sc = part.clv.clone(), part.scale_buffer.clone()
    part.clv.copy_(clv)
    part.scale_buffer.copy_(sc)
    run_levels(part, ops, levels.level_update_reference)
    torch.cuda.synchronize()
    k, n = part.scale_buffers, part.nodes
    writer = {o.parent_scaler_index: o.parent_clv_index for o in ops
              if o.parent_scaler_index >= 0}
    if part.rate_scalers:
        def block(e):
            return writer[e[0]], e[1], slice(None), e[2]
    else:
        def block(e):
            return writer[e[0]], slice(None), slice(None), e[1]
    ties = match_counts(name, got_sc[:k], part.scale_buffer[:k], got_clv,
                        part.clv, block, part.scale_factor,
                        part.scale_threshold)
    check(not bool(got_sc[k + 1].any()), f"{name}: the zero row was written")
    check(bool(torch.isfinite(got_clv[:n]).all()), f"{name}: non-finite CLVs")
    want = part.clv[:n]
    err = (got_clv[:n] - want).abs()
    site_max = want.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-30)
    rel, abs_err = float((err / site_max).max()), float(err.max())
    scaled = int(part.scale_buffer[:k].max())
    print(f"level kernel vs plain [{name}]: {part.tips} taxa x {part.sites} "
          f"sites, {part.states} states, {part.rate_cats} rates"
          + (" (per-rate counts)" if part.rate_scalers else "")
          + f", {len(ops)} "
          f"ops in {n_levels} levels: scaler rows equal (max {scaled}"
          + (f"; {ties} ties" if ties else "") + f"), "
          f"max_rel_err {rel:.3e}, max_abs_err {abs_err:.3e}", flush=True)
    check(rel <= TOL_CLV, f"{name}: max_rel_err {rel:.3e} > {TOL_CLV}")
    if must_scale:
        check(scaled > 0, f"{name}: scaling never triggered")
    return rel, abs_err


def level_cases(device, small, small_by, cat, cat_by, aa_by, big, big_by):
    """Phase 9. Returns the largest absolute error."""
    from libpll2_tpu_torch.trees import random_alignment

    max_abs = 0.0
    headers, seqs = random_alignment(16, 1000, seed=3,
                                     alphabet=LETTERS32 + "-")
    by32 = dict(zip(headers, seqs))

    def case(name, part, tree, **kw):
        nonlocal max_abs
        ops, _, _ = traversal_ops(part, tree)
        if kw.pop("no_scaler", False):
            for op in ops[::3]:
                op.parent_scaler_index = -1
        if kw.pop("partial", False):
            kw["first"], ops = ops, ops[len(ops) // 2:]
        max_abs = max(max_abs, compare_level_case(name, part, ops, **kw)[1])

    case("ragged", dna_partition(small, small_by, 1000, device), small)
    case("3 rates", dna_partition(small, small_by, 1000, device, 3), small)
    case("caterpillar", dna_partition(cat, cat_by, 1000, device), cat,
         must_scale=True)
    for states, by in ((20, aa_by), (32, by32)):
        case(f"{states} states", protein_partition(small, by, 1000, device,
                                                   states), small)
    case("ops without a scaler", dna_partition(small, small_by, 1000,
                                               device), small,
         no_scaler=True)
    case("partial op list", dna_partition(small, small_by, 1000, device),
         small, partial=True)
    case("main-path shape", dna_partition(big, big_by, N_SITES, device),
         big)
    return max_abs


def plain_dense_f64(part, ops, branches, params, edge_params=None):
    """`ops` through the plain level-batched path (ops/partials.py) in
    float64 on the card, from `part`'s tips and model, with P-matrices
    from `branches` (pmatrix order; per edge with `edge_params`, the rate
    matrix of every P-matrix slot). Returns (clv, scaler, P, model tensors
    in the engine's order, pattern weights, invariant)."""
    import torch
    from libpll2_tpu_torch import constants as C
    from libpll2_tpu_torch.ops import partials, pmatrix
    from libpll2_tpu_torch.partition import pack_level_operations

    f64, dev = torch.float64, part.device
    part._ensure_eigen(params)
    model = tuple(torch.tensor(a, dtype=f64, device=dev) for a in (
        part.eigenvals, part.inv_eigenvecs, part.eigenvecs, part.prop_invar,
        part.rates, part.rate_weights, part.frequencies)) + (
        torch.tensor(params, device=dev),)
    if edge_params is None:
        pm = pmatrix.update_prob_matrices(*model[:5], model[7],
                                          branches.to(dev, f64))
    else:
        part._ensure_eigen(edge_params)
        model = tuple(torch.tensor(a, dtype=f64, device=dev) for a in (
            part.eigenvals, part.inv_eigenvecs, part.eigenvecs,
            part.prop_invar)) + model[4:]
        ep = torch.tensor(edge_params, device=dev)[:, None].expand(
            -1, part.rate_cats)
        pm = pmatrix.update_prob_matrices_per_edge(
            *model[:5], ep, branches.to(dev, f64))
    clv = part.clv.double()
    scaler = torch.zeros_like(part.scale_buffer)
    plan = pack_level_operations(ops, part.tips, part.nodes, device=dev)
    partials.update_partials_levels(clv, scaler, pm, *plan,
                                    C.SCALE_THRESHOLD, C.SCALE_FACTOR,
                                    rate_scalers=part.rate_scalers)
    site = (torch.tensor(part.pattern_weights, device=dev),
            torch.tensor(part.invariant, dtype=torch.long, device=dev))
    return clv, scaler, pm, model, site


def f64_edge(part, ops, branches, params, root, edge_params=None):
    """(logL, d1, d2) across the root edge at its length, and the
    ancestral probabilities at `root`, through `plain_dense_f64`, in the
    partition's modes."""
    from libpll2_tpu_torch import constants as C
    from libpll2_tpu_torch.engine import _root_newton
    from libpll2_tpu_torch.ops import likelihood

    clv, sc, pm, model, site = plain_dense_f64(part, ops, branches, params,
                                               edge_params)
    rows = (clv[root.clv_index], clv[root.back.clv_index],
            sc[root.scaler_index], sc[root.back.scaler_index])
    mat = root.pmatrix_index
    modes = part._modes()
    total, _ = likelihood.edge_loglikelihood(
        *rows, pm[mat], model[6], model[3], model[5], model[7], *site,
        C.SCALE_THRESHOLD, **modes)
    d1, d2, _ = _root_newton(rows, branches.to(clv.device, clv.dtype), mat,
                             *model, *site, C.SCALE_THRESHOLD, **modes)
    anc = likelihood.node_ancestral(rows[0], rows[1], rows[2], rows[3],
                                    pm[mat], model[6], model[5], model[7],
                                    C.SCALE_THRESHOLD,
                                    rate_scalers=part.rate_scalers)
    return float(total), float(d1), float(d2), anc


def check_logl(what, got, ref, d=None, dref=None):
    """Print and hold one float32 result against its float64 reference."""
    rel = abs(got - ref) / abs(ref)
    line = f"  {what}: logL {got!r}, float64 {ref!r} (rel {rel:.2e})"
    check(math.isfinite(got) and rel < TOL_LOGL,
          f"{what}: logL rel err {rel:.2e} >= {TOL_LOGL}")
    if d is not None:
        errs = [abs(g - w) / max(abs(w), ATOL_D1 / TOL_D1)
                for g, w in zip(d, dref)]
        line += (f"; d1 {d[0]!r} / {dref[0]!r}, d2 {d[1]!r} / {dref[1]!r} "
                 f"(err {max(errs):.2e})")
        check(max(errs) < TOL_D1, f"{what}: d1/d2 err {max(errs):.2e} >= "
              f"{TOL_D1}")
    print(line, flush=True)


def dense_main_path(device, label, tree, by_label, sites, make):
    """Phase 10 for one problem: the step-by-step chain, a partial
    traversal, TreeEngine(pallas='levels-kernel'), all through the level
    kernel, each held against the float64 plain path on the card. `make`
    builds the float32 partition on the card. Returns (level-kernel
    launches, levels per full traversal, partition, engine, ops)."""
    import torch
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.ops import fused, levels
    from libpll2_tpu_torch.trees import create_operations, traverse

    part = make(tree, by_label, sites, device)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    r = tree.vroot
    params = [0] * part.rate_cats
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index)
    blen = torch.zeros(part.prob_matrices, dtype=torch.float64)
    blen[pidx] = torch.tensor(br, dtype=torch.float64)
    n_levels = len(levels.schedule_levels(ops, part.tips))
    print(f"dense {label} path: {part.tips} taxa x {sites} sites, "
          f"{len(ops)} ops in {n_levels} levels, buffers "
          f"{part.clv_bytes() / 1e6:.1f} MB", flush=True)

    levels.level_update.launches = 0
    fused.fused_traversal.launches = 0
    fused.fused_traversal_rows.launches = 0
    # the step-by-step chain
    part.update_prob_matrices(params, pidx, br)
    part.update_partials(ops)
    lnl = part.compute_edge_loglikelihood(*edge, params)
    anc = part.compute_node_ancestral(*edge, params)
    st = part.update_sumtable(r.clv_index, r.back.clv_index, r.scaler_index,
                              r.back.scaler_index, params)
    d = part.compute_likelihood_derivatives(st, params,
                                            float(blen[r.pmatrix_index]))
    # a partial traversal after one branch length changes, then the full
    # list over the same P-matrices: every row must come out equal
    mat = next(o.child1_matrix_index for o in ops
               if o.child1_clv_index < part.tips)
    bad = set()
    for o in ops:
        if (mat in (o.child1_matrix_index, o.child2_matrix_index)
                or o.child1_clv_index in bad or o.child2_clv_index in bad):
            bad.add(o.parent_clv_index)
    partial, _, _ = create_operations(traverse(
        r, cbtrav=lambda n: not n.is_tip() and n.clv_index in bad))
    blen2 = blen.clone()
    blen2[mat] *= 3.0
    part.update_prob_matrices(params, [mat], [float(blen2[mat])])
    part.update_partials(partial)
    lnl_partial = part.compute_edge_loglikelihood(*edge, params)
    clv_partial = part.clv.clone()
    sc_partial = part.scale_buffer.clone()
    part.update_partials(ops)
    lnl_full = part.compute_edge_loglikelihood(*edge, params)
    partial_equal = (lnl_partial == lnl_full
                     and torch.equal(clv_partial[:part.nodes],
                                     part.clv[:part.nodes])
                     and torch.equal(sc_partial, part.scale_buffer))
    del clv_partial, sc_partial
    n_partial = len(levels.schedule_levels(partial, part.tips))
    # TreeEngine on the levels-kernel path, at the original lengths
    eng = TreeEngine(part, tree, pallas="levels-kernel")
    check(eng.execution_path == "levels-kernel",
          f"execution_path is {eng.execution_path!r}")
    inputs = [eng.branches.clone()]
    lnl_eng = eng.loglikelihood()
    steps = []
    for _ in range(3):
        inputs.append(eng.branches.clone())
        steps.append(eng.newton_step())
    torch.cuda.synchronize()
    launches = levels.level_update.launches
    expected = 6 * n_levels + n_partial
    print(f"  level-kernel launches: {launches} (2 step-by-step traversals + "
          f"1 partial of {len(partial)} ops in {n_partial} levels + 4 "
          f"engine evaluations; expected {expected}); fused kernel "
          f"launches {fused.fused_traversal.launches} + "
          f"{fused.fused_traversal_rows.launches}", flush=True)
    check(launches == expected, f"{launches} level-kernel launches, "
          f"expected {expected}")
    check(fused.fused_traversal.launches
          + fused.fused_traversal_rows.launches == 0,
          "the dense path launched a fused kernel")

    ref = f64_edge(part, ops, blen, params, r)
    check_logl("step-by-step edge", lnl, ref[0], d, ref[1:3])
    anc_err = float(abs(torch.as_tensor(anc) - ref[3].cpu()).max())
    print(f"  node ancestral: max abs err {anc_err:.2e}", flush=True)
    check(anc_err < TOL_ANC, f"ancestral err {anc_err:.2e} >= {TOL_ANC}")
    check(partial_equal, f"partial traversal: logL {lnl_partial!r}, CLV "
          f"or scaler rows differ from the full one's ({lnl_full!r})")
    check_logl(f"partial traversal ({len(partial)} of {len(ops)} ops, "
               f"equal to the full one)", lnl_partial,
               f64_edge(part, ops, blen2, params, r)[0])
    for i, (b, (lk, d1, d2)) in enumerate(zip(
            inputs, [(lnl_eng, None, None)] + steps)):
        ref = f64_edge(part, ops, b.cpu().double(), params, r)
        what = "engine loglikelihood()" if i == 0 else f"newton_step {i}"
        check_logl(what, lk, ref[0], None if d1 is None else (d1, d2),
                   None if d1 is None else ref[1:3])
    return launches, n_levels, part, eng, ops


def rooted_dna(device, tree, by_label):
    """compute_root_loglikelihood of the DNA problem rooted on its root
    edge (root branch length 0), against the float64 plain path. Returns
    the level-kernel launches."""
    import torch
    from libpll2_tpu_torch import constants as C
    from libpll2_tpu_torch.ops import levels, likelihood
    from libpll2_tpu_torch.trees import (export_newick, parse_newick_rooted,
                                         rtree)

    rooted = parse_newick_rooted(export_newick(tree.vroot, rooted=True))
    part = dna_partition(rooted, by_label, N_SITES, device)
    ops, br, pidx = rtree.create_operations(rtree.traverse(rooted.root))
    params = [0] * part.rate_cats
    levels.level_update.launches = 0
    part.update_prob_matrices(params, pidx, br)
    part.update_partials(ops)
    root = rooted.root
    lnl = part.compute_root_loglikelihood(root.clv_index, root.scaler_index,
                                          params)
    launches = levels.level_update.launches
    check(launches == len(levels.schedule_levels(ops, part.tips)),
          f"rooted: {launches} level-kernel launches")
    blen = torch.zeros(part.prob_matrices, dtype=torch.float64)
    blen[pidx] = torch.tensor(br, dtype=torch.float64)
    clv, sc, _, model, site = plain_dense_f64(part, ops, blen, params)
    ref, _ = likelihood.root_loglikelihood(
        clv[root.clv_index], sc[root.scaler_index], model[6], model[3],
        model[5], model[7], *site, C.SCALE_THRESHOLD)
    check_logl(f"rooted tree ({rooted.tip_count} taxa), "
               f"compute_root_loglikelihood, {launches} launches", lnl,
               float(ref))
    return launches


def lg4x_path(device, tree, by_label):
    """LG4X through update_prob_matrices([0, 1, 2, 3], ...) at the protein
    problem's size, against the float64 plain path. Returns the
    level-kernel launches."""
    import torch
    from libpll2_tpu_torch.ops import levels
    from libpll2_tpu_torch.trees import create_operations, traverse

    part = protein_partition(tree, by_label, AA_SITES, device,
                             mixture="lg4x")
    ops, br, pidx = create_operations(traverse(tree.vroot))
    params = [0, 1, 2, 3]
    r = tree.vroot
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index)
    levels.level_update.launches = 0
    part.update_prob_matrices(params, pidx, br)
    part.update_partials(ops)
    lnl = part.compute_edge_loglikelihood(*edge, params)
    launches = levels.level_update.launches
    blen = torch.zeros(part.prob_matrices, dtype=torch.float64)
    blen[pidx] = torch.tensor(br, dtype=torch.float64)
    check_logl(f"LG4X mixture, {launches} launches", lnl,
               f64_edge(part, ops, blen, params, r)[0])
    check(launches > 0, "LG4X launched no level kernel")
    return launches


# ----------------------------------------------------------- site repeats
REP_TAXA, REP_SITES, REP_SEED = 246, 4465, 13    # tools/benchmarks.py:221-254
SUBST_24 = [1.2, 3.0, 0.8, 1.1, 2.6, 1.0]        # tests/test_pallas_repeats.py
FREQS_24 = [0.3, 0.25, 0.2, 0.25]


def conserve(tree, scale, floor, clamp=False):
    """Shorten every branch to scale * len + floor (max(scale * len, floor)
    with `clamp`), so that the data is conserved and the class tables
    compress."""
    seen = set()
    for nd in tree.nodes():
        for h in ([nd] if nd.is_tip() else list(nd.ring())):
            if h.back is not None and id(h) not in seen:
                seen.update((id(h), id(h.back)))
                h.length = h.back.length = (
                    max(h.length * scale, floor) if clamp
                    else h.length * scale + floor)
    return tree


def simulated(tree, sites, seed, states=4, freqs=None, subst=None,
              alpha=0.8):
    """{label: sequence} simulated on `tree` (utils.simulate_alignment);
    20 states with equal rates and frequencies."""
    from libpll2_tpu_torch.utils import simulate_alignment

    if states == 20:
        freqs, subst = [1 / 20] * 20, [1.0] * 190
    headers, seqs = simulate_alignment(tree, sites, freqs, subst,
                                       alpha=alpha, seed=seed)
    return dict(zip(headers, seqs))


def repeats_partition(tree, by_label, sites, device, states=4, rate_cats=4,
                      repeats=True, model=(FREQS_24, SUBST_24), alpha=0.8,
                      rate_matrices=1, **options):
    """A float32 partition on `device` with site repeats (or dense, for the
    references), tips installed in one batch; 20 states under LG, DNA under
    `model` (a second matrix from SEED with `rate_matrices` 2); `options`
    (rate_scalers, asc_bias) go to Partition."""
    import numpy as np
    import torch
    from libpll2_tpu_torch import Partition, compute_gamma_cats
    from libpll2_tpu_torch.io import maps
    from libpll2_tpu_torch.models import load_aa_model

    part = Partition(tree.tip_count, tree.inner_count, states, sites,
                     rate_matrices, tree.edge_count, rate_cats,
                     tree.inner_count, device=device, dtype=torch.float32,
                     site_repeats=repeats, **options)
    tips = list(tree.tips())
    part.set_tip_states_batch(maps.map_aa if states == 20 else maps.map_nt,
                              [by_label[t.label] for t in tips],
                              [t.clv_index for t in tips])
    if states == 20:
        load_aa_model(part, "lg")
    else:
        part.set_frequencies(0, model[0])
        part.set_subst_params(0, model[1])
        if rate_matrices == 2:
            rng = np.random.default_rng(SEED)
            part.set_frequencies(1, rng.dirichlet(np.ones(4) * 10))
            part.set_subst_params(1, rng.uniform(0.5, 2.0, size=6))
    part.set_category_rates(compute_gamma_cats(alpha, rate_cats))
    return part


def flagship_repeats():
    """tools/benchmarks.py:221-254: 246 taxa x 4465 sites, GTR (1,2,1,1,2,1)
    with equal frequencies, Gamma(0.7) x 4, seed 13, on a random tree whose
    branches are shortened to 0.15 len + 0.001. Returns (tree, by_label,
    partition maker)."""
    from libpll2_tpu_torch.trees import random_utree

    tree = conserve(random_utree([f"t{i}" for i in range(REP_TAXA)],
                                 seed=REP_SEED), 0.15, 0.001)
    model = ([0.25] * 4, [1, 2, 1, 1, 2, 1.0])
    by = simulated(tree, REP_SITES, REP_SEED, freqs=model[0],
                   subst=model[1], alpha=0.7)

    def make(device, repeats=True, rate_matrices=1, **options):
        return repeats_partition(tree, by, REP_SITES, device,
                                 repeats=repeats, model=model, alpha=0.7,
                                 rate_matrices=rate_matrices, **options)
    return tree, by, make


def conserved_protein(aa_tree, aa_by):
    """tools/benchmarks.py:38-66 with conserved=True at 128 x 8192: the
    protein problem's columns drawn with repetition from its first quarter
    (seed 11 + 100). Returns (by_label, partition maker)."""
    import numpy as np

    rng = np.random.default_rng(AA_SEED + 100)
    src = rng.integers(0, AA_SITES // 4, size=AA_SITES)
    by = {k: "".join(np.asarray(list(v))[src]) for k, v in aa_by.items()}

    def make(device, repeats=True):
        return repeats_partition(aa_tree, by, AA_SITES, device, states=20,
                                 repeats=repeats, alpha=0.9)
    return by, make


def run_pool(part, ops, level):
    """`ops` through ops/pool.py level by level on `part`'s pooled buffers,
    each level run by `level` (the wrapper or its plain version); returns
    the number of levels."""
    from libpll2_tpu_torch.ops import pool

    plan = part._pool_plan(ops, True)
    pool.update_partials_pool(part.clv_flat, part.sc_flat, part.pmatrix,
                              plan, part.scale_threshold, part.scale_factor,
                              level=level)
    return len(plan.tables)


def compare_pool_case(name, part, ops, first=None, must_scale=False):
    """Pool kernel vs its plain version over a whole op list on the card,
    from the same buffers (after `first`, the list that must run before a
    partial one): scaler regions equal but at ties (`match_counts`; the
    trash region aside: ops without a scaler buffer of one level write it
    at once), the zero region zero, class columns within TOL_CLV of each
    column's max. Returns (max relative error, max absolute error)."""
    import torch
    from libpll2_tpu_torch.ops import pool

    if first is not None:
        run_pool(part, first, pool.pool_update)
    part._pool_plan(ops, True)              # lays the pool out, computes none
    clv, sc = part.clv_flat.clone(), part.sc_flat.clone()
    n_levels = run_pool(part, ops, pool.pool_update)
    got_clv, got_sc = part.clv_flat.clone(), part.sc_flat.clone()
    part.clv_flat.copy_(clv)
    part.sc_flat.copy_(sc)
    run_pool(part, ops, pool.pool_update_reference)
    torch.cuda.synchronize()
    lay = part._flat
    # a scaler region holds the classes of the node that wrote it
    col_of = torch.full((lay.sc_trash,), -1, dtype=torch.long)
    for o in ops:
        k = o.parent_scaler_index
        if k >= 0:
            w = int(lay.sc_caps[k])
            col_of[lay.sc_off[k]:lay.sc_off[k] + w] = torch.arange(
                w) + int(lay.off[o.parent_clv_index])
    if part.rate_scalers:
        def block(e):
            return e[0], slice(None), int(col_of[e[1]])
    else:
        def block(e):
            return slice(None), slice(None), int(col_of[e[0]])
    ties = match_counts(name, got_sc[..., :lay.sc_trash],
                        part.sc_flat[..., :lay.sc_trash], got_clv,
                        part.clv_flat, block, part.scale_factor,
                        part.scale_threshold)
    check(not bool(got_sc[..., lay.sc_zero:].any()),
          f"{name}: the zero region was written")
    check(bool(torch.isfinite(got_clv).all()), f"{name}: non-finite CLVs")
    want = part.clv_flat
    err = (got_clv - want).abs()
    col_max = want.abs().amax(dim=(0, 1), keepdim=True).clamp(min=1e-30)
    rel, abs_err = float((err / col_max).max()), float(err.max())
    scaled = int(part.sc_flat[..., :lay.sc_trash].max()) if lay.sc_trash \
        else 0
    widths = part._repeat_schedule.widths
    print(f"pool kernel vs plain [{name}]: {part.tips} taxa x {part.sites} "
          f"sites, {part.states} states, {part.rate_cats} rates"
          + (" (per-rate counts)" if part.rate_scalers else "")
          + f", {len(ops)} "
          f"ops in {n_levels} levels (widest {max(widths)}), pool "
          f"{lay.total} columns: scaler regions equal (max {scaled}"
          + (f"; {ties} ties" if ties else "") + "), "
          f"max_rel_err {rel:.3e}, max_abs_err {abs_err:.3e}", flush=True)
    check(rel <= TOL_CLV, f"{name}: max_rel_err {rel:.3e} > {TOL_CLV}")
    if must_scale:
        check(scaled > 0, f"{name}: scaling never triggered")
    return rel, abs_err


def pool_cases(device, big, big_by, flagship, aa_make):
    """Phase 12. Returns the largest absolute error."""
    from libpll2_tpu_torch.trees import parse_newick, random_utree

    max_abs = 0.0

    def case(name, part, tree, no_scaler=False, partial=False, **kw):
        nonlocal max_abs
        ops, _, _ = traversal_ops(part, tree)
        if no_scaler:
            for op in ops[::3]:
                op.parent_scaler_index = -1
        if partial:
            kw["first"], ops = ops, ops[len(ops) // 2:]
        max_abs = max(max_abs, compare_pool_case(name, part, ops, **kw)[1])

    t24 = random_utree([f"t{i}" for i in range(24)], seed=11)
    by24 = simulated(t24, 600, 11, freqs=FREQS_24, subst=SUBST_24)
    case("24 x 600 DNA", repeats_partition(t24, by24, 600, device), t24)
    cat = parse_newick(caterpillar_newick(150))
    case("caterpillar 150 x 300", repeats_partition(
        cat, simulated(cat, 300, 13, freqs=FREQS_24, subst=SUBST_24), 300,
        device), cat, must_scale=True)
    case("3 rates", repeats_partition(t24, by24, 600, device, rate_cats=3),
         t24)
    aa = conserve(random_utree([f"t{i}" for i in range(24)], seed=13), 0.3,
                  0.02, clamp=True)
    case("20 states, conserved", repeats_partition(
        aa, simulated(aa, 640, 13, states=20, alpha=0.9), 640, device,
        states=20, alpha=0.9), aa)
    case("partial op list", repeats_partition(t24, by24, 600, device), t24,
         partial=True)
    case("ops without a scaler", repeats_partition(t24, by24, 600, device),
         t24, no_scaler=True)
    case("128 x 16384 random columns (identity ops)", repeats_partition(
        big, big_by, N_SITES, device), big)
    tree, _, make = flagship
    case(f"{REP_TAXA} x {REP_SITES} conserved", make(device), tree)
    aa_tree, make_aa = aa_make
    case(f"protein {AA_TAXA} x {AA_SITES} conserved", make_aa(device),
         aa_tree)
    return max_abs


def pool_bound(part, levels):
    """One traversal through the pool kernel, from the actual class counts,
    each column once (as `level_bound` counts rows): the class columns and
    counts it reads and does not write (the tips' columns; scaler counts of
    nodes outside the list) read once, every parent's class columns and
    counts written once (4 * R * s and 4 bytes a column), the two gather
    int32s of every parent column, P and the op tables read once; against
    4 * R * s^2 + R * s FLOP a parent column."""
    from libpll2_tpu_torch.ops import pool

    ops = [(op, gl.size) for lv in levels for _, op, gl, _ in lv]
    written = {op.parent_clv_index: n for op, n in ops}
    sc_w = {op.parent_scaler_index: n for op, n in ops
            if op.parent_scaler_index >= 0}
    read = {c for op, _ in ops
            for c in (op.child1_clv_index, op.child2_clv_index)
            if c not in written}
    sc_r = {k: part.repeats.classes(c) for op, _ in ops
            for c, k in ((op.child1_clv_index, op.child1_scaler_index),
                         (op.child2_clv_index, op.child2_scaler_index))
            if k >= 0 and k not in sc_w}
    cols = sum(n for _, n in ops)
    R, s = part.rate_cats, part.states
    sc_rows = R if part.rate_scalers else 1
    n_bytes = ((sum(part.repeats.classes(c) for c in read)
                + sum(written.values())) * 4 * R * s
               + (sum(sc_r.values()) + sum(sc_w.values())) * 4 * sc_rows
               + cols * 2 * 4 + len(ops) * pool.POOL_ROWS * 8
               + part.prob_matrices * R * s * s * 4)
    return bound_ms(n_bytes, cols * (4 * R * s * s + R * s))


def repeats_main_path(device, tree, make, label, dense_ref):
    """Phase 13 for one problem: the step-by-step chain on
    Partition(site_repeats=True), a partial traversal equal to the full one,
    TreeEngine(pallas="pool") with loglikelihood() and three newton_step()s,
    the default TreeEngine ('repeats-dense-fused'), and edge_params with two
    rate matrices, each held against the float64 plain dense path on the
    card (`dense_ref`, a dense partition of the same data); the fused
    kernel on the default engine's inputs is held against its plain
    version. Returns (pool launches, levels per traversal, partition,
    engines, ops, levels, (fused-kernel launches on 'repeats-dense-fused',
    its max abs error against the plain version))."""
    import copy

    import numpy as np
    import torch
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.ops import fused, levels as lv, pool
    from libpll2_tpu_torch.trees import create_operations, traverse

    part = make(device)
    ops, br, pidx = create_operations(traverse(tree.vroot))
    r = tree.vroot
    params = [0] * part.rate_cats
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index)
    blen = torch.zeros(part.prob_matrices, dtype=torch.float64)
    blen[pidx] = torch.tensor(br, dtype=torch.float64)
    t0 = time.perf_counter()
    layout, levels = pool.schedule_pool_levels(
        copy.deepcopy(part.repeats), ops, part.tips, part.sites,
        part.scale_buffers)
    pool.pack_pool_levels(layout, levels)
    sched_ms = (time.perf_counter() - t0) * 1e3
    n_levels = len(levels)
    cols, work = pool.pool_work(levels)
    plain_cols = len(ops) * part.sites
    print(f"repeats {label} path: {part.tips} taxa x {part.sites} sites, "
          f"{len(ops)} ops in {n_levels} levels; class columns "
          f"{cols} = {cols / plain_cols:.4f} of plain work ({work} computed "
          f"with the bucket widths, {work / plain_cols:.4f}); host schedule "
          f"{sched_ms:.1f} ms", flush=True)

    pool.pool_update.launches = 0
    fused.fused_traversal.launches = 0
    fused.fused_traversal_rows.launches = 0
    lv.level_update.launches = 0
    # the step-by-step chain
    part.update_prob_matrices(params, pidx, br)
    part.update_partials(ops)
    lnl = part.compute_edge_loglikelihood(*edge, params)
    anc = part.compute_node_ancestral(*edge, params)
    st = part.update_sumtable(r.clv_index, r.back.clv_index, r.scaler_index,
                              r.back.scaler_index, params)
    d = part.compute_likelihood_derivatives(st, params,
                                            float(blen[r.pmatrix_index]))
    # a partial traversal after one branch length changes, then the full
    # list: the root edge's per-site rows must come out equal
    mat = next(o.child1_matrix_index for o in ops
               if o.child1_clv_index < part.tips)
    bad = set()
    for o in ops:
        if (mat in (o.child1_matrix_index, o.child2_matrix_index)
                or o.child1_clv_index in bad or o.child2_clv_index in bad):
            bad.add(o.parent_clv_index)
    partial, _, _ = create_operations(traverse(
        r, cbtrav=lambda n: not n.is_tip() and n.clv_index in bad))
    blen2 = blen.clone()
    blen2[mat] *= 3.0
    part.update_prob_matrices(params, [mat], [float(blen2[mat])])
    part.update_partials(partial)
    lnl_partial = part.compute_edge_loglikelihood(*edge, params)
    rows_partial = [t.clone() for i in (0, 2) for t in part._node_view(
        edge[i], edge[i + 1])[:2]]
    part.update_partials(ops)
    lnl_full = part.compute_edge_loglikelihood(*edge, params)
    rows_full = [t for i in (0, 2) for t in part._node_view(
        edge[i], edge[i + 1])[:2]]
    partial_equal = lnl_partial == lnl_full and all(
        torch.equal(a, b) for a, b in zip(rows_partial, rows_full))
    n_partial = len(lv.schedule_levels(partial, part.tips))
    # TreeEngine on the pooled kernel path, at the original lengths
    eng = TreeEngine(part, tree, pallas="pool")
    check(eng.execution_path == "pool-pallas",
          f"execution_path is {eng.execution_path!r}")
    inputs = [eng.branches.clone()]
    lnl_eng = eng.loglikelihood()
    steps = []
    for _ in range(3):
        inputs.append(eng.branches.clone())
        steps.append(eng.newton_step())
    # per-branch heterotachy on the pooled kernel path
    ep = np.arange(part.prob_matrices) % 2
    part2 = make(device, rate_matrices=2)
    eng_ep = TreeEngine(part2, tree, pallas="pool", edge_params=ep)
    lnl_ep = eng_ep.loglikelihood()
    torch.cuda.synchronize()
    launches = pool.pool_update.launches
    expected = 7 * n_levels + n_partial
    fused_launches = (fused.fused_traversal.launches
                      + fused.fused_traversal_rows.launches)
    print(f"  pool-kernel launches: {launches} (2 step-by-step traversals + "
          f"1 partial of {len(partial)} ops in {n_partial} levels + 4 "
          f"engine evaluations + 1 with edge_params; expected {expected}); "
          f"fused {fused_launches}, level {lv.level_update.launches}",
          flush=True)
    check(launches == expected, f"{launches} pool-kernel launches, expected "
          f"{expected}")
    check(fused_launches + lv.level_update.launches == 0,
          "the pooled path launched another kernel")
    # the default engine: the fused kernel over the repeats partition, one
    # launch per evaluation
    eng_rdf = TreeEngine(part, tree)
    check(eng_rdf.execution_path == "repeats-dense-fused",
          f"default execution_path is {eng_rdf.execution_path!r}")
    fused.fused_traversal.launches = 0
    fused.fused_traversal_rows.launches = 0
    lv.level_update.launches = 0
    pool.pool_update.launches = 0
    lnl_rdf = eng_rdf.loglikelihood()
    step_rdf = eng_rdf.newton_step()
    torch.cuda.synchronize()
    rdf_launches = fused.fused_traversal.launches
    others = (fused.fused_traversal_rows.launches
              + lv.level_update.launches + pool.pool_update.launches)
    print(f"  repeats-dense-fused: fused-kernel launches in loglikelihood() "
          f"+ newton_step() = {rdf_launches}, other kernels {others}",
          flush=True)
    check(rdf_launches == 2, f"{rdf_launches} fused-kernel launches on "
          f"'repeats-dense-fused', expected 2")
    check(others == 0, "'repeats-dense-fused' launched another kernel")
    check(part.clv is None, "the dense-fused engine allocated dense rows")
    # the fused kernel against its plain version at this path's shape
    rdf_err = compare_traversal(f"repeats-dense-fused {label} shape", part,
                                eng_rdf)[1]

    ref = f64_edge(dense_ref, ops, blen, params, r)
    check_logl("step-by-step edge", lnl, ref[0], d, ref[1:3])
    anc_err = float(abs(torch.as_tensor(anc) - ref[3].cpu()).max())
    print(f"  node ancestral: max abs err {anc_err:.2e}", flush=True)
    check(anc_err < TOL_ANC, f"ancestral err {anc_err:.2e} >= {TOL_ANC}")
    check(partial_equal, f"partial traversal: logL {lnl_partial!r} or the "
          f"root rows differ from the full one's ({lnl_full!r})")
    check_logl(f"partial traversal ({len(partial)} of {len(ops)} ops, "
               f"equal to the full one)", lnl_partial,
               f64_edge(dense_ref, ops, blen2, params, r)[0])
    for i, (b, (lk, d1, d2)) in enumerate(zip(
            inputs, [(lnl_eng, None, None)] + steps)):
        ref = f64_edge(dense_ref, ops, b.cpu().double(), params, r)
        what = ("pool-pallas loglikelihood()" if i == 0
                else f"pool-pallas newton_step {i}")
        check_logl(what, lk, ref[0], None if d1 is None else (d1, d2),
                   None if d1 is None else ref[1:3])
    ref = f64_edge(dense_ref, ops, blen, params, r)
    check_logl("repeats-dense-fused loglikelihood()", lnl_rdf, ref[0])
    check_logl("repeats-dense-fused newton_step", step_rdf[0], ref[0],
               step_rdf[1:], ref[1:3])
    if dense_ref.states == 4:
        dense2 = make(device, repeats=False, rate_matrices=2)
        rm = int(ep[r.pmatrix_index])
        check_logl("edge_params, two rate matrices", lnl_ep, f64_edge(
            dense2, ops, blen, [rm] * part.rate_cats, r, edge_params=ep)[0])
    return (launches, n_levels, part, (eng, eng_rdf), ops, levels,
            (rdf_launches, rdf_err))


def protein_repeats_path(device, aa_tree, make_aa):
    """Phase 13, protein: the 128 x 8192 conserved LG+G4 partition on
    'pool-pallas' (loglikelihood() and one newton_step()) against the
    float64 plain dense path. Returns (pool launches, class share)."""
    import torch
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.ops import pool
    from libpll2_tpu_torch.trees import create_operations, traverse

    part = make_aa(device)
    eng = TreeEngine(part, aa_tree, pallas="pool")
    check(eng.execution_path == "pool-pallas",
          f"execution_path is {eng.execution_path!r}")
    pool.pool_update.launches = 0
    b0 = eng.branches.clone()
    lnl = eng.loglikelihood()
    b1 = eng.branches.clone()
    step = eng.newton_step()
    torch.cuda.synchronize()
    launches = pool.pool_update.launches
    check(launches == 2 * len(eng._ops.tables),
          f"{launches} pool launches for 2 evaluations of "
          f"{len(eng._ops.tables)} levels")
    ops, _, _ = create_operations(traverse(aa_tree.vroot))
    dense = make_aa(device, repeats=False)
    r = aa_tree.vroot
    params = [0] * part.rate_cats
    ref0 = f64_edge(dense, ops, b0.cpu().double(), params, r)
    ref1 = f64_edge(dense, ops, b1.cpu().double(), params, r)
    print(f"repeats protein path: {part.tips} taxa x {part.sites} sites "
          f"LG+G4 conserved, {len(eng._ops.tables)} levels, buffers "
          f"{part.clv_bytes() / 1e6:.1f} MB vs dense "
          f"{dense.clv_bytes() / 1e6:.1f} MB; {launches} pool launches",
          flush=True)
    check_logl("protein pool-pallas loglikelihood()", lnl, ref0[0])
    check_logl("protein pool-pallas newton_step", step[0], ref1[0],
               step[1:], ref1[1:3])
    return launches


def repeats_times(part, engines, dense, levels, tree, gpu):
    """Phase 14 at 246 x 4465: medians (ms) of the pool kernel over one
    traversal and of its plain version, of the fused kernel and its plain
    version on the 'repeats-dense-fused' engine's inputs, of loglikelihood()
    on 'pool-pallas', on 'repeats-dense-fused' and on a dense partition's
    'fused' path, and of one step-by-step traversal. Returns (pool kernel,
    plain, pool bound, (fused kernel, plain, fused bound))."""
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.ops import fused, pool
    from libpll2_tpu_torch.trees import create_operations, traverse

    ops, _, _ = create_operations(traverse(tree.vroot))
    plan = part._pool_plan(ops, True)
    args = (part.clv_flat, part.sc_flat, part.pmatrix, plan,
            part.scale_threshold, part.scale_factor)
    kernel = median_ms(lambda: pool.update_partials_pool(*args))
    plain = median_ms(lambda: pool.update_partials_pool(
        *args, level=pool.pool_update_reference))
    eng_pool, eng_rdf = engines
    codes, pm, table = traversal_inputs(eng_rdf)
    kw = dict(rates=part.rate_cats, states=part.states,
              n_slots=eng_rdf.fused_slots, threshold=part.scale_threshold,
              factor=part.scale_factor)
    f_kernel = median_ms(lambda: fused.fused_traversal(codes, pm, table,
                                                       **kw))
    f_plain = median_ms(lambda: fused.fused_traversal_reference(
        codes, pm, table, **kw))
    f_bound = fused_bound(eng_rdf, part)
    eng_dense = TreeEngine(dense, tree)
    check(eng_dense.execution_path == "fused", "dense engine not fused")
    ms = interleaved_ms({"pool-pallas": eng_pool.loglikelihood,
                         "repeats-dense-fused": eng_rdf.loglikelihood,
                         "fused (dense partition)": eng_dense.loglikelihood})
    r = tree.vroot
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index, [0] * part.rate_cats)

    def step():
        part.update_partials(ops)
        part.compute_edge_loglikelihood(*edge)

    step_ms = median_ms(step)
    bound, by = pool_bound(part, levels)
    cols, _ = pool.pool_work(levels)
    print(f"repeats times, {part.tips} x {part.sites} (median of {REPS}, "
          f"CUDA events; {gpu}): pool kernel over {len(plan.tables)} levels "
          f"{kernel:.4f} ms ({cols / kernel / 1e6:.3f} G class-column "
          f"updates/s; bound {bound:.4f} ms by {by}), plain {plain:.4f} ms; "
          f"fused kernel on the repeats-dense-fused inputs {f_kernel:.4f} ms "
          f"(bound {f_bound[0]:.4f} ms by {f_bound[1]}), plain "
          f"{f_plain:.4f} ms; "
          + "; ".join(f"loglikelihood() {k} {v:.4f} ms" for k, v in
                      ms.items()) + f" (in turns, {REPS} rounds)"
          + f"; step-by-step traversal {step_ms:.4f} ms; buffers "
          f"{part.clv_bytes() / 1e6:.2f} MB pooled vs "
          f"{dense.clv_bytes() / 1e6:.2f} MB dense "
          f"({part.clv_bytes() / dense.clv_bytes():.4f})", flush=True)
    return kernel, plain, (bound, by), (f_kernel, f_plain, f_bound)


def bound_ms(n_bytes: int, flops: int, peak=H100_F32_FLOP_PER_S):
    """(least time in ms at the card's peaks, 'bytes' or 'operations');
    `peak` the FLOP/s of the operations' type (float32 by default)."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def traversal_flops(n_ops: int, sites: int, rates: int, states: int) -> int:
    """Per op, site and rate: two matrix-vector products (2 s^2 FMAs, 4 s^2
    FLOP) and their elementwise product (s)."""
    return n_ops * sites * rates * states * (4 * states + 1)


def fused_bound(eng, part):
    """One fused traversal: the state-code tips' codes (4 bytes a site) and
    the raw tips' rows (4 s bytes a site), P and the op table read once,
    the root edge's two CLVs and counts (one per rate with per-rate
    scalers) written once."""
    n_ops = eng.table.shape[0] - 1
    S, R, s = part.sites_padded, part.rate_cats, part.states
    n_raw = int(part._tips_clv_set.sum())
    sc_rows = R if part.rate_scalers else 1
    n_bytes = ((part.tips - n_raw) * S * 4 + n_raw * s * S * 4
               + part.prob_matrices * R * s * s * 4 + eng.table.numel() * 4
               + 2 * R * s * S * 4 + 2 * sc_rows * S * 4)
    return bound_ms(n_bytes, traversal_flops(n_ops, S, R, s))


def level_bound(part, ops):
    """One traversal through the level kernel: every CLV and scaler row it
    reads and does not write (the tips) read once, every row it writes
    written once, P and the level tables read once."""
    written = {o.parent_clv_index for o in ops}
    read = {c for o in ops
            for c in (o.child1_clv_index, o.child2_clv_index)} - written
    sc_w = {o.parent_scaler_index for o in ops if o.parent_scaler_index >= 0}
    sc_r = {x for o in ops for x in (o.child1_scaler_index,
                                     o.child2_scaler_index) if x >= 0} - sc_w
    S, R, s = part.sites_padded, part.rate_cats, part.states
    sc_rows = R if part.rate_scalers else 1
    n_bytes = ((len(read) + len(written)) * R * s * S * 4
               + (len(sc_r) + len(sc_w)) * sc_rows * S * 4
               + part.prob_matrices * R * s * s * 4 + 9 * len(ops) * 4)
    return bound_ms(n_bytes, traversal_flops(len(ops), S, R, s))


def level_times(label, part, eng, ops, gpu):
    """Phase 11 for one problem: medians (ms) of the level kernel over one
    whole traversal (all levels, tables on the card) and of its plain
    version, of one loglikelihood() on the levels-kernel path, and of one
    step-by-step traversal (update_partials + compute_edge_loglikelihood)."""
    from libpll2_tpu_torch.ops import levels

    tables = levels.tables_to_device(levels.pack_pallas_levels(
        ops, part.tips, part.scale_buffers + 1, part.scale_buffers),
        part.device)
    args = (part.clv, part.scale_buffer, part.pmatrix, tables,
            part.scale_threshold, part.scale_factor)
    kernel = median_ms(lambda: levels.update_partials_kernel(*args))
    plain = median_ms(lambda: levels.update_partials_kernel(
        *args, level=levels.level_update_reference))
    logl = median_ms(eng.loglikelihood)
    root = eng.root_idx
    params = [0] * part.rate_cats

    def step():
        part.update_partials(ops)
        part.compute_edge_loglikelihood(*root, params)

    step_ms = median_ms(step)
    bound, by = level_bound(part, ops)
    print(f"level times, {label} {part.tips} x {part.sites} (median of "
          f"{REPS}, CUDA events; {gpu}): kernel over {len(tables)} levels "
          f"{kernel:.4f} ms ({len(ops) * part.sites / kernel / 1e6:.3f} G "
          f"CLV site-updates/s; bound {bound:.4f} ms by {by}), plain "
          f"{plain:.4f} ms; loglikelihood() {logl:.4f} ms; step-by-step "
          f"traversal {step_ms:.4f} ms", flush=True)
    return kernel, plain, logl, step_ms


def caterpillar_times(device, gpu):
    """The level kernel's worst case: the 80-taxon caterpillar at the DNA
    main path's width, 78 ops in 78 levels of one op each. Medians (ms) of
    one traversal through the kernel and through its plain version."""
    from libpll2_tpu_torch.ops import levels
    from libpll2_tpu_torch.trees import parse_newick, random_alignment

    tree = parse_newick(caterpillar_newick(80))
    headers, seqs = random_alignment(80, N_SITES, seed=3)
    part = dna_partition(tree, dict(zip(headers, seqs)), N_SITES, device)
    ops, _, _ = traversal_ops(part, tree)
    tables = levels.tables_to_device(levels.pack_pallas_levels(
        ops, part.tips, part.scale_buffers + 1, part.scale_buffers),
        part.device)
    args = (part.clv, part.scale_buffer, part.pmatrix, tables,
            part.scale_threshold, part.scale_factor)
    kernel = median_ms(lambda: levels.update_partials_kernel(*args))
    plain = median_ms(lambda: levels.update_partials_kernel(
        *args, level=levels.level_update_reference))
    bound, by = level_bound(part, ops)
    print(f"level times, caterpillar 80 x {N_SITES} ({len(ops)} ops in "
          f"{len(tables)} levels; {gpu}): kernel {kernel:.4f} ms "
          f"({len(ops) * N_SITES / kernel / 1e6:.3f} G CLV site-updates/s; "
          f"bound {bound:.4f} ms by {by}), plain {plain:.4f} ms",
          flush=True)


def interleaved_ms(fns: dict) -> dict:
    """Medians (ms, CUDA events) of each of `fns` timed in turns: REPS
    rounds, the order reversed every other round (a, b, c, c, b, a, ...),
    so that drift of the host or the card reaches every one alike."""
    import torch

    for fn in fns.values():
        for _ in range(WARMUP):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for r in range(REPS):
        order = list(fns.items())
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def median_ms(fn) -> float:
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile(engines, out_dir: str) -> None:
    """torch.profiler tables of one loglikelihood() and one newton_step()
    of each (tag, engine) to out_dir/profile.txt."""
    import torch
    from torch.profiler import ProfilerActivity

    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with open(os.path.join(out_dir, "profile.txt"), "w") as fh:
        for tag, eng in engines:
            eng.loglikelihood()
            eng.newton_step()
            torch.cuda.synchronize()
            for name, fn in (("loglikelihood", eng.loglikelihood),
                             ("newton_step", eng.newton_step)):
                with torch.profiler.profile(activities=acts) as prof:
                    fn()
                    torch.cuda.synchronize()
                fh.write(f"== {tag}: {name}()\n")
                fh.write(prof.key_averages().table(
                    sort_by="cuda_time_total", row_limit=25))
                fh.write("\n")
    print(f"profile written to {out_dir}/profile.txt", flush=True)


def times(eng, part, gpu, taxa, sites, modes=("split",)):
    """Medians (ms) of the dispatching kernel call and the plain version
    per contraction mode (ignored below 16 states), then of
    loglikelihood() and newton_step()."""
    from libpll2_tpu_torch.ops.fused import (fused_traversal,
                                             fused_traversal_reference)

    codes, pm, table = traversal_inputs(eng)
    kw = dict(rates=part.rate_cats, states=part.states,
              n_slots=eng.fused_slots, threshold=part.scale_threshold,
              factor=part.scale_factor)
    out = {}
    for mode in modes:
        plain = median_ms(lambda: fused_traversal_reference(
            codes, pm, table, mxu=mode, **kw))
        kernel = median_ms(lambda: fused_traversal(codes, pm, table,
                                                   mxu=mode, **kw))
        out[mode] = (kernel, plain)
    ms_logl = median_ms(eng.loglikelihood)
    ms_newton = median_ms(eng.newton_step)
    n_ops = len(eng.table) - 1
    per_mode = ", ".join(
        f"{'' if len(out) == 1 else f'[{m}] '}kernel {k:.4f} ms "
        f"({n_ops * sites / k / 1e6:.3f} G CLV site-updates/s), plain "
        f"{p:.4f} ms" for m, (k, p) in out.items())
    print(f"times at {taxa} x {sites} (median of {REPS}, CUDA events; "
          f"{gpu}): {per_mode}; loglikelihood() {ms_logl:.4f} ms "
          f"({1e3 / ms_logl:.1f} evals/s), newton_step() {ms_newton:.4f} ms",
          flush=True)
    return out


# ---------------------------------- per-rate scalers, raw tips, asc bias
CATG_SEED = 7                       # the probabilistic MSA's noise
ASC_WEIGHTS = [1200, 900, 1100, 800]  # invariant sites per state (STAM/FELS)


def catg_values(seq, rng):
    """CATG-style probabilities [sites, 4] of one aligned DNA sequence: 1 -
    eps on the observed base and eps / 3 on the others, eps ~ U(0.001,
    0.05) per site; a gap (any other character) is all ones."""
    import numpy as np

    idx = np.array(["ACGT".find(c) for c in seq])
    eps = rng.uniform(0.001, 0.05, len(seq))
    vals = np.repeat((eps / 3)[:, None], 4, axis=1)
    seen = idx >= 0
    vals[seen, idx[seen]] = 1.0 - eps[seen]
    vals[~seen] = 1.0
    return vals


def aa_raw_values(sites, rng):
    """Random amino-acid probability vectors [sites, 20] (a profile-like
    raw tip): Dirichlet(0.3) per site."""
    import numpy as np

    return rng.dirichlet(np.full(20, 0.3), size=sites)


def set_raw_tips(part, tree, by_label, every=1):
    """set_tip_clv on every `every`-th tip (by clv index): CATG
    probabilities of its sequence for DNA, random profiles for proteins,
    from seed 7. Returns the number of raw tips."""
    import numpy as np

    rng = np.random.default_rng(CATG_SEED)
    tips = sorted(tree.tips(), key=lambda t: t.clv_index)[::every]
    for tip in tips:
        vals = (catg_values(by_label[tip.label], rng) if part.states == 4
                else aa_raw_values(part.sites, rng))
        part.set_tip_clv(tip.clv_index, vals)
    return len(tips)


def snp_alignment(tree):
    """The DNA main path's model (dna_model, Gamma 0.8) simulated on its
    tree with utils/simulate.py (seed 7), keeping the first N_SITES
    variable columns: a SNP alignment for the asc corrections."""
    import numpy as np
    from libpll2_tpu_torch.utils import simulate_alignment

    freqs, subst = dna_model()
    headers, seqs = simulate_alignment(tree, 2 * N_SITES, freqs, subst,
                                       alpha=0.8, seed=SEED)
    cols = np.frombuffer("".join(seqs).encode(), dtype=np.uint8).reshape(
        len(seqs), -1)
    var = np.flatnonzero((cols != cols[:1]).any(axis=0))
    check(var.size >= N_SITES, f"only {var.size} variable columns")
    keep = np.ascontiguousarray(cols[:, var[:N_SITES]])
    return {h: keep[i].tobytes().decode() for i, h in enumerate(headers)}


def reset_counts():
    """Every kernel's launch count set to 0."""
    from libpll2_tpu_torch.ops import fused, levels, pool

    for fn in (fused.fused_traversal, fused.fused_traversal_rows,
               levels.level_update, pool.pool_update):
        fn.launches = 0


def counts():
    from libpll2_tpu_torch.ops import fused, levels, pool

    return {"fused": fused.fused_traversal.launches,
            "rows": fused.fused_traversal_rows.launches,
            "level": levels.level_update.launches,
            "pool": pool.pool_update.launches}


def check_counts(what, got, want):
    """The launches of one path: exactly `want` (kernel -> count), and no
    other kernel."""
    print(f"  {what}: launches {got}", flush=True)
    for k, n in got.items():
        check(n == want.get(k, 0), f"{what}: {n} {k}-kernel launches, "
              f"expected {want.get(k, 0)}")


def slice_kernel_cases(device, small, small_by, cat, cat_by, big, big_by,
                       aa_tree, aa_by, flagship):
    """Phase 15: every new variant of kernels 1, 2, 3 and 5 against its
    plain version on the card, float32. Returns ({variant: max abs err},
    {variant: (partition, engine)} of the full-width cases)."""
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.trees import parse_newick, random_alignment

    err, keep = {}, {}

    def note(key, value):
        err[key] = max(err.get(key, 0.0), value)

    # kernel 1: per-rate counts
    note("fused_per_rate", compare_case(
        "per-rate, ragged", small, small_by, 1000, device,
        rate_scalers=True)[1])
    note("fused_per_rate", compare_case(
        "per-rate, runtime-size variant, 16 rates", small, small_by, 1000,
        device, rate_cats=16, rate_scalers=True)[1])
    cat150 = parse_newick(caterpillar_newick(150))
    headers, seqs = random_alignment(150, 1000, seed=3)
    note("fused_per_rate", compare_case(
        "per-rate, caterpillar 150", cat150, dict(zip(headers, seqs)), 1000,
        device, must_scale="rates", rate_scalers=True)[1])
    part, eng = build_engine(big, big_by, N_SITES, device,
                             rate_scalers=True)
    note("fused_per_rate", compare_traversal("per-rate, main-path shape",
                                             part, eng)[1])
    keep["fused_per_rate"] = (part, eng)
    # kernel 1: raw tips, all 128 and mixed with state codes and per-rate
    part = dna_partition(big, big_by, N_SITES, device)
    set_raw_tips(part, big, big_by)
    eng = TreeEngine(part, big)
    check(int((eng.table[:-1, [1, 4]] == 2).sum()) == N_TAXA,
          "not every tip is a raw row")
    note("fused_raw", compare_traversal("raw tips, all 128", part, eng)[1])
    keep["fused_raw"] = (part, eng)
    part = dna_partition(small, small_by, 1000, device, rate_scalers=True)
    set_raw_tips(part, small, small_by, every=2)
    note("fused_raw", compare_traversal(
        "raw tips, every other tip, per-rate", part,
        TreeEngine(part, small))[1])
    part = dna_partition(cat, cat_by, 1000, device, 3, rate_scalers=True)
    set_raw_tips(part, cat, cat_by, every=3)
    note("fused_raw", compare_traversal(
        "raw tips, runtime-size variant, caterpillar", part,
        TreeEngine(part, cat), must_scale=True)[1])
    # kernel 2: per-rate and raw tips at the protein main path's shape
    part = protein_partition(aa_tree, aa_by, AA_SITES, device,
                             rate_scalers=True)
    eng = TreeEngine(part, aa_tree)
    note("rows_per_rate", compare_rows_traversal(
        "per-rate, main-path shape", part, eng)[1])
    keep["rows_per_rate"] = (part, eng)
    part = protein_partition(aa_tree, aa_by, AA_SITES, device,
                             rate_scalers=True)
    set_raw_tips(part, aa_tree, aa_by, every=2)
    eng = TreeEngine(part, aa_tree)
    note("rows_raw", compare_rows_traversal(
        "raw tips (every other tip), per-rate, main-path shape", part,
        eng)[1])
    keep["rows_raw"] = (part, eng)
    headers, seqs = random_alignment(80, 1000, alphabet=AA_NOISY, seed=3)
    part = protein_partition(cat, dict(zip(headers, seqs)), 1000, device,
                             rate_scalers=True)
    note("rows_per_rate", compare_rows_traversal(
        "per-rate, caterpillar", part, TreeEngine(part, cat),
        must_scale=True)[1])
    # kernel 3: per-rate level updates
    part = dna_partition(big, big_by, N_SITES, device, rate_scalers=True)
    ops, _, _ = traversal_ops(part, big)
    note("level_per_rate", compare_level_case(
        "per-rate, main-path shape", part, ops)[1])
    keep["level_per_rate"] = (part, ops)
    part = protein_partition(small, dict(zip(*random_alignment(
        16, 1000, alphabet=AA_NOISY, seed=3))), 1000, device,
        rate_scalers=True)
    ops, _, _ = traversal_ops(part, small)
    note("level_per_rate", compare_level_case("per-rate, 20 states", part,
                                              ops)[1])
    part = dna_partition(cat, cat_by, 1000, device, rate_scalers=True)
    ops, _, _ = traversal_ops(part, cat)
    note("level_per_rate", compare_level_case(
        "per-rate, caterpillar", part, ops, must_scale=True)[1])
    # kernel 5: per-rate pool levels
    tree, _, make = flagship
    part = make(device, rate_scalers=True)
    ops, _, _ = traversal_ops(part, tree)
    note("pool_per_rate", compare_pool_case(
        f"per-rate, {REP_TAXA} x {REP_SITES} conserved", part, ops)[1])
    keep["pool_per_rate"] = (part, ops)
    part = repeats_partition(cat150, simulated(
        cat150, 300, 13, freqs=FREQS_24, subst=SUBST_24), 300, device,
        rate_scalers=True)
    ops, _, _ = traversal_ops(part, cat150)
    note("pool_per_rate", compare_pool_case(
        "per-rate, caterpillar 150 x 300", part, ops, must_scale=True)[1])
    return err, keep


def fused_slice_path(label, part, eng):
    """loglikelihood() and three newton_step()s of a fused engine (its
    kernel's launches counted), the first two held against one float64
    plain evaluation on the card. Returns (launches, engine)."""
    import torch

    check(eng.execution_path == "fused",
          f"{label}: execution_path is {eng.execution_path!r}")
    b0 = eng.branches.clone()
    reset_counts()
    lnl = eng.loglikelihood()
    steps = [eng.newton_step() for _ in range(3)]
    torch.cuda.synchronize()
    got = counts()
    kernel = "rows" if part.states >= 16 else "fused"
    check_counts(f"{label}, loglikelihood() + 3 newton_step()", got,
                 {kernel: 4})
    ref = plain_float64(part, eng, b0)
    check_logl(f"{label}, loglikelihood()", lnl, ref[0])
    check_logl(f"{label}, newton_step 1", steps[0][0], ref[0], steps[0][1:],
               ref[1:])
    for i, (lk, d1, d2) in enumerate(steps[1:], 2):
        check(all(map(math.isfinite, (lk, d1, d2))),
              f"{label}: newton_step {i} is not finite")
        print(f"  {label}, newton_step {i}: logL {lk!r} d1 {d1!r} d2 {d2!r}",
              flush=True)
    return got[kernel], eng


def step_by_step(part, tree, params=None, derivatives=True):
    """The step-by-step chain on the root edge: update_prob_matrices,
    update_partials, compute_edge_loglikelihood, update_sumtable and
    compute_likelihood_derivatives (with the edge's scaler indices).
    Returns (ops, branch vector [pmatrix order], logL, (d1, d2))."""
    import torch
    from libpll2_tpu_torch.trees import create_operations, traverse

    ops, br, pidx = create_operations(traverse(tree.vroot))
    r = tree.vroot
    params = params or [0] * part.rate_cats
    blen = torch.zeros(part.prob_matrices, dtype=torch.float64)
    blen[pidx] = torch.tensor(br, dtype=torch.float64)
    part.update_prob_matrices(params, pidx, br)
    part.update_partials(ops)
    lnl, d = step_edge(part, tree, blen, params, derivatives)
    return ops, blen, lnl, d


def step_edge(part, tree, blen, params, derivatives=True):
    """compute_edge_loglikelihood and (with `derivatives`) the sumtable's
    d1/d2 of the root edge, from the partition's current buffers."""
    r = tree.vroot
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index)
    lnl = part.compute_edge_loglikelihood(*edge, params)
    if not derivatives:
        return lnl, None
    st = part.update_sumtable(r.clv_index, r.back.clv_index, r.scaler_index,
                              r.back.scaler_index, params)
    d = part.compute_likelihood_derivatives(
        st, params, float(blen[r.pmatrix_index]), r.scaler_index,
        r.back.scaler_index)
    return lnl, d


def per_rate_dna_path(device, big, big_by):
    """Phase 16: DNA GTR+G4 at 128 x 16384 with rate_scalers=True, on the
    fused path, through the step-by-step chain and on 'levels-kernel', all
    held against one float64 plain evaluation. Returns (fused launches,
    level launches)."""
    import torch
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.ops import levels

    part, eng = build_engine(big, big_by, N_SITES, device,
                             rate_scalers=True)
    print(f"per-rate DNA path: {N_TAXA} x {N_SITES} GTR+G4, scaler buffer "
          f"{tuple(part.scale_buffer.shape)}", flush=True)
    fused_launches, _ = fused_slice_path("per-rate DNA fused", part, eng)
    reset_counts()
    ops, blen, lnl, d = step_by_step(part, big)
    n_levels = len(levels.schedule_levels(ops, part.tips))
    eng_lk = TreeEngine(part, big, pallas="levels-kernel")
    check(eng_lk.execution_path == "levels-kernel",
          f"execution_path is {eng_lk.execution_path!r}")
    lk_lnl = eng_lk.loglikelihood()
    lk_step = eng_lk.newton_step()
    torch.cuda.synchronize()
    got = counts()
    check_counts("per-rate DNA step-by-step + levels-kernel (3 traversals)",
                 got, {"level": 3 * n_levels})
    sc = part.scale_buffer[big.vroot.scaler_index]
    mixed = int((sc.amax(0) != sc.amin(0)).sum())
    print(f"  root scaler row: per-rate counts differ between rates at "
          f"{mixed} sites (max {int(sc.max())})", flush=True)
    ref = f64_edge(part, ops, blen, [0] * part.rate_cats, big.vroot)
    check_logl("per-rate DNA step-by-step edge", lnl, ref[0], d, ref[1:3])
    check_logl("per-rate DNA levels-kernel loglikelihood()", lk_lnl, ref[0])
    check_logl("per-rate DNA levels-kernel newton_step", lk_step[0], ref[0],
               lk_step[1:], ref[1:3])
    return fused_launches, got["level"]


def per_rate_protein_path(device, aa_tree, aa_by):
    """Phase 16: protein LG+G4 at 128 x 8192 with rate_scalers=True on the
    fused path (the rows kernel's per-rate mode), against one float64 plain
    evaluation. Returns the rows-kernel launches."""
    from libpll2_tpu_torch import TreeEngine

    part = protein_partition(aa_tree, aa_by, AA_SITES, device,
                             rate_scalers=True)
    return fused_slice_path("per-rate protein LG+G4 fused", part,
                            TreeEngine(part, aa_tree))[0]


def raw_tip_dna_path(device, big, big_by):
    """Phase 16: the DNA main path's alignment with every tip given by
    set_tip_clv (CATG-style probabilities from seed 7) on the fused path,
    against one float64 plain evaluation. Returns the fused launches."""
    from libpll2_tpu_torch import TreeEngine

    part = dna_partition(big, big_by, N_SITES, device)
    n_raw = set_raw_tips(part, big, big_by)
    eng = TreeEngine(part, big)
    print(f"raw-tip DNA path: {n_raw} of {N_TAXA} tips from set_tip_clv, "
          f"{int((eng.table[:-1, [1, 4]] == 2).sum())} raw-tip children in "
          f"the op table", flush=True)
    return fused_slice_path("raw-tip DNA fused", part, eng)[0]


def asc_dna_path(device, big):
    """Phase 16: a SNP alignment (snp_alignment) at 128 x 16384 under
    GTR+G4+ASC_LEWIS on the fused path, then Felsenstein and Stamatakis
    (with state weights) through the step-by-step API, each held against
    one float64 plain evaluation. Returns (fused launches, level
    launches)."""
    import torch
    from libpll2_tpu_torch import AscBias, TreeEngine
    from libpll2_tpu_torch.ops import levels

    by = snp_alignment(big)
    part = dna_partition(big, by, N_SITES, device, asc_bias=AscBias.LEWIS)
    eng = TreeEngine(part, big)
    print(f"asc DNA path: {N_TAXA} x {N_SITES} variable columns + "
          f"{part.asc_extra} synthetic, GTR+G4+ASC_LEWIS", flush=True)
    fused_launches, _ = fused_slice_path("ASC_LEWIS fused", part, eng)
    reset_counts()
    part.set_asc_state_weights(ASC_WEIGHTS)
    ops, blen, _, _ = step_by_step(part, big, derivatives=False)
    n_levels = len(levels.schedule_levels(ops, part.tips))
    for asc in (AscBias.FELSENSTEIN, AscBias.STAMATAKIS):
        part.set_asc_bias_type(asc)
        lnl, d = step_edge(part, big, blen, [0] * part.rate_cats)
        ref = f64_edge(part, ops, blen, [0] * part.rate_cats, big.vroot)
        check_logl(f"{asc.name} step-by-step edge (state weights "
                   f"{ASC_WEIGHTS})", lnl, ref[0], d, ref[1:3])
    torch.cuda.synchronize()
    got = counts()
    check_counts("asc step-by-step (1 traversal)", got, {"level": n_levels})
    return fused_launches, got["level"]


def repeats_slice_paths(device, tree, make):
    """Phase 16: the 246 x 4465 repeats problem with rate_scalers=True on
    the default path ('repeats-dense-fused') and on 'pool-pallas', then
    with ASC_LEWIS on both, each held against one float64 plain dense
    evaluation. Returns (pool launches, fused launches)."""
    import torch
    from libpll2_tpu_torch import AscBias, TreeEngine
    from libpll2_tpu_torch.trees import create_operations, traverse

    ops, br, pidx = create_operations(traverse(tree.vroot))
    pool_total = fused_total = 0
    for label, options in (("per-rate", {"rate_scalers": True}),
                           ("ASC_LEWIS", {"asc_bias": AscBias.LEWIS})):
        part = make(device, **options)
        blen = torch.zeros(part.prob_matrices, dtype=torch.float64)
        blen[pidx] = torch.tensor(br, dtype=torch.float64)
        eng_pool = TreeEngine(part, tree, pallas="pool")
        eng_rdf = TreeEngine(part, tree)
        check(eng_pool.execution_path == "pool-pallas"
              and eng_rdf.execution_path == "repeats-dense-fused",
              f"{label}: paths {eng_pool.execution_path!r}, "
              f"{eng_rdf.execution_path!r}")
        reset_counts()
        results = {"pool-pallas loglikelihood()": (eng_pool.loglikelihood(),
                                                   None),
                   "pool-pallas newton_step": eng_pool.newton_step(),
                   "repeats-dense-fused loglikelihood()": (
                       eng_rdf.loglikelihood(), None),
                   "repeats-dense-fused newton_step": eng_rdf.newton_step()}
        torch.cuda.synchronize()
        got = counts()
        n_levels = len(eng_pool._ops.tables)
        check_counts(f"repeats {label} (2 pooled + 2 dense-fused "
                     f"evaluations)", got, {"pool": 2 * n_levels,
                                            "fused": 2})
        pool_total += got["pool"]
        fused_total += got["fused"]
        ref = f64_edge(make(device, repeats=False, **options), ops, blen,
                       [0] * part.rate_cats, tree.vroot)
        for what, res in results.items():
            lk, d = (res[0], None) if res[1] is None else (res[0], res[1:])
            check_logl(f"repeats {label} {what}", lk, ref[0], d,
                       None if d is None else ref[1:3])
    return pool_total, fused_total


def slice_times(keep, gpu):
    """Phase 17: medians (ms) of each new variant's kernel call and its
    plain version at the full-width shapes, with its bound. Returns
    {variant: (kernel, plain, (bound, by))}; the rows kernel's per-rate
    and raw entries add their 'bf16' kernel and plain times."""
    import copy

    from libpll2_tpu_torch.ops import fused, levels, pool

    out = {}
    for key in ("fused_per_rate", "fused_raw", "rows_per_rate", "rows_raw"):
        part, eng = keep[key]
        codes, pm, table = traversal_inputs(eng)
        kw = traversal_kw(part, eng)
        row = []
        for mode in (("split", "bf16") if key.startswith("rows")
                     else ("split",)):
            row += [median_ms(lambda: fused.fused_traversal(
                codes, pm, table, mxu=mode, **kw)),
                median_ms(lambda: fused.fused_traversal_reference(
                    codes, pm, table, mxu=mode, **kw))]
        out[key] = (row[0], row[1], fused_bound(eng, part), *row[2:])
    part, ops = keep["level_per_rate"]
    tables = levels.tables_to_device(levels.pack_pallas_levels(
        ops, part.tips, part.scale_buffers + 1, part.scale_buffers),
        part.device)
    args = (part.clv, part.scale_buffer, part.pmatrix, tables,
            part.scale_threshold, part.scale_factor)
    out["level_per_rate"] = (
        median_ms(lambda: levels.update_partials_kernel(*args)),
        median_ms(lambda: levels.update_partials_kernel(
            *args, level=levels.level_update_reference)),
        level_bound(part, ops))
    part, ops = keep["pool_per_rate"]
    plan = part._pool_plan(ops, True)
    args = (part.clv_flat, part.sc_flat, part.pmatrix, plan,
            part.scale_threshold, part.scale_factor)
    _, lv = pool.schedule_pool_levels(copy.deepcopy(part.repeats), ops,
                                      part.tips, part.sites_padded,
                                      part.scale_buffers)
    out["pool_per_rate"] = (
        median_ms(lambda: pool.update_partials_pool(*args)),
        median_ms(lambda: pool.update_partials_pool(
            *args, level=pool.pool_update_reference)),
        pool_bound(part, lv))
    for key, (k, p, (b, by), *bf) in out.items():
        extra = (f"; bf16 kernel {bf[0]:.4f} ms, plain {bf[1]:.4f} ms"
                 if bf else "")
        print(f"slice times [{key}] ({gpu}): kernel {k:.4f} ms (bound "
              f"{b:.4f} ms by {by}), plain {p:.4f} ms{extra}", flush=True)
    return out


def probe_phase(gpu):
    """Phase 18: the matrix-unit probe (libpll2_tpu_torch/tools/
    mxu_probe.py, csrc/mxu_probe.cu) against its plain version in every
    mode at every probe shape ('split' also within float32-class error of
    the float64 product), then its table at 8 and 264 column tiles with
    torch.matmul's time beside each, its launches counted. Returns the
    kernels-line entry."""
    import numpy as np
    import torch
    from libpll2_tpu_torch.tools import mxu_probe as mp

    max_abs, split_rel = 0.0, 0.0
    for m, k, t, _, _ in mp.SHAPES:
        a, x = mp.make(m, k, t, tiles=8, seed=1)
        f64 = sum(a.double()[(i % 8) * m:(i % 8 + 1) * m] @ x.double()
                  for i in range(7))
        for mode in mp.MODES:
            got = mp.probe(a, x, m, 7, mode)
            want = mp.probe_reference(a, x, m, 7, mode)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            tol = TOL_PROBE if mode == "f32" else TOL_PROBE_MMA
            check(bool(torch.isfinite(got).all()) and rel < tol,
                  f"mxu_probe {mode} [{m},{k}]@[{k},{t}]: rel err "
                  f"{rel:.2e} against its plain version")
            max_abs = max(max_abs, err)
            if mode == "split":
                split_rel = max(split_rel, float(
                    (got.double() - f64).abs().max() / f64.abs().max()))
    print(f"mxu_probe kernel vs plain: 3 modes x {len(mp.SHAPES)} shapes, "
          f"7 iterations, max abs err {max_abs:.3e}; 'split' against the "
          f"float64 product: rel {split_rel:.2e}", flush=True)
    check(split_rel < TOL_PROBE_MMA, f"'split' rel err {split_rel:.2e} is "
          f"not float32-class")
    # the plain version's time per product at the yardstick shape
    a, x = mp.make(80, 80, 512, tiles=264)
    plain = {mode: median_ms(lambda: mp.probe_reference(a, x, 80, 20, mode))
             / (20 * 264) for mode in mp.MODES}
    reps = 3
    mp.probe.launches = 0
    rows = mp.probe_table(tiles=(8, 264), reps=reps)
    torch.cuda.synchronize()
    launches = mp.probe.launches
    print(f"mxu_probe table ({gpu}; per product [m,k]@[k,t] of one column "
          f"tile; torch.matmul of the same product beside):", flush=True)
    for r in rows:
        print("  " + mp.format_row(r), flush=True)
    # two trip counts a row, each a warm-up and `reps` timed launches
    check(launches == 2 * (1 + reps) * len(rows), f"{launches} probe "
          f"launches for {len(rows)} table rows")
    main = {r["mode"]: r for r in rows
            if (r["m"], r["k"], r["t"], r["tiles"]) == (80, 80, 512, 264)}
    # per product, the bound of the table's longer call (500 iterations x
    # 264 tiles of [80,80]@[80,512] in bf16) over its products: A, X read
    # once and out written once (float32), 2 m k t FLOP a product at the
    # bf16 tensor-core peak
    n_prod, cols = 500 * 264, 512 * 264
    bound = bound_ms((8 * 80 * 80 + 80 * cols + 80 * cols) * 4,
                     2 * 80 * 80 * 512 * n_prod, H100_BF16_FLOP_PER_S)
    bound = (bound[0] / n_prod, bound[1])
    return {"name": "mxu_probe", "route": "cuda",
            "source": "libpll2_tpu_torch/csrc/mxu_probe.cu",
            "replaces": "tools/mxu_probe.py:34", "launches": launches,
            "max_abs_err": max_abs, "shape": "bf16 [80,80]@[80,512], 264 "
            "column tiles, per product",
            "ms": main["bf16"]["us"] * 1e-3, "plain_ms": plain["bf16"],
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": main["bf16"]["matmul_us"] * 1e-3,
            "f32_ms": main["f32"]["us"] * 1e-3,
            "f32_plain_ms": plain["f32"],
            "f32_library_ms": main["f32"]["matmul_us"] * 1e-3,
            "split_ms": main["split"]["us"] * 1e-3,
            "split_plain_ms": plain["split"],
            "split_float64_rel_err": split_rel,
            "tflops": {m: r["tflops"] for m, r in main.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    # the plain versions' float32 einsums: full float32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    from libpll2_tpu_torch.ops import _kernels
    from libpll2_tpu_torch.trees import (parse_newick, random_alignment,
                                         random_utree)

    # 1. device
    gpu = gpu_name_and_power()
    print(gpu, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{kind}, {torch.cuda.device_count()} device(s)", flush=True)
    device = "cuda"

    # 2. build
    t0 = time.perf_counter()
    lib_path = _kernels.library_path()
    _kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(lib_path, REPO)}", flush=True)
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if ("registers" in line or "spill" in line
                    or line.startswith("==")):
                print(f"  ptxas: {line.strip()}", flush=True)

    # 3. kernel vs plain on the card
    headers, seqs = random_alignment(16, 1000, alphabet="ACGT-NRY", seed=3)
    small = random_utree(headers, seed=3)
    small_by = dict(zip(headers, seqs))
    compare_case("ragged", small, small_by, 1000, device)
    compare_case("runtime-size variant, 3 rates", small, small_by, 1000,
                 device, rate_cats=3)
    cat = parse_newick(caterpillar_newick(80))
    headers, seqs = random_alignment(80, 1000, seed=3)
    cat_by = dict(zip(headers, seqs))
    compare_case("caterpillar", cat, cat_by, 1000, device, must_scale=True)
    headers_big, seqs = random_alignment(N_TAXA, N_SITES, seed=SEED)
    big_by = dict(zip(headers_big, seqs))
    _, max_abs = compare_case("main-path shape", random_utree(headers_big,
                                                              seed=SEED),
                              big_by, N_SITES, device)

    # 4. main path
    eng, part, launches = main_path(device)

    # 5. times
    ms_kernel, ms_plain = times(eng, part, gpu, N_TAXA, N_SITES)["split"]

    # 6. rows kernel vs plain on the card
    headers, seqs = random_alignment(16, 1000, alphabet=AA_NOISY, seed=3)
    aa_small_by = dict(zip(headers, seqs))
    compare_rows_case("ragged AA", small, aa_small_by, 1000, device)
    compare_rows_case("3 rates", small, aa_small_by, 1000, device,
                      rate_cats=3)
    for states in (16, 32):
        headers, seqs = random_alignment(16, 1000, seed=3,
                                         alphabet=LETTERS32[:states] + "-")
        compare_rows_case(f"{states} states", small,
                          dict(zip(headers, seqs)), 1000, device,
                          states=states)
    headers, seqs = random_alignment(80, 1000, alphabet=AA_NOISY, seed=3)
    compare_rows_case("caterpillar", cat, dict(zip(headers, seqs)), 1000,
                      device, must_scale=True)
    aa_tree, aa_by = protein_alignment()
    _, rows_max_abs = compare_rows_case("main-path shape", aa_tree, aa_by,
                                        AA_SITES, device)

    # 7. protein main path
    aa_eng, aa_part, rows_launches = protein_main_path(device, aa_tree,
                                                       aa_by)

    # 8. times
    rows_ms = times(aa_eng, aa_part, gpu, AA_TAXA, AA_SITES,
                    modes=("split", "bf16"))
    bounds = {"fused_traversal": fused_bound(eng, part),
              "fused_traversal_rows": fused_bound(aa_eng, aa_part)}

    # 9. level kernel vs plain on the card
    big = random_utree(headers_big, seed=SEED)
    level_max_abs = level_cases(device, small, small_by, cat, cat_by,
                                aa_small_by, big, big_by)

    # 10. the dense paths at full width, through the level kernel
    dna = dense_main_path(device, "DNA", big, big_by, N_SITES,
                          dna_partition)
    rooted_launches = rooted_dna(device, big, big_by)
    prot = dense_main_path(device, "protein", aa_tree, aa_by, AA_SITES,
                           protein_partition)
    lg4x_launches = lg4x_path(device, aa_tree, aa_by)
    level_launches = dna[0] + prot[0]
    print(f"level-kernel launches on the dense main paths: "
          f"{level_launches} (DNA {dna[0]}, protein {prot[0]}); rooted "
          f"DNA {rooted_launches}, LG4X {lg4x_launches}", flush=True)

    # 11. times of the level kernel and the dense paths
    lv_ms = level_times("DNA", *dna[2:5], gpu)
    lv_aa_ms = level_times("protein", *prot[2:5], gpu)
    caterpillar_times(device, gpu)
    bounds["level_update"] = level_bound(dna[2], dna[4])
    aa_level_bound = level_bound(prot[2], prot[4])

    # 12. pool kernel vs plain on the card
    flagship = flagship_repeats()
    rep_tree, _, rep_make = flagship
    aa_make = conserved_protein(aa_tree, aa_by)[1]
    pool_max_abs = pool_cases(device, big, big_by, flagship,
                              (aa_tree, aa_make))

    # 13. the site-repeats paths at full width
    rep_dense = rep_make(device, repeats=False)
    rep = repeats_main_path(device, rep_tree, rep_make, "DNA", rep_dense)
    pool_launches = rep[0] + protein_repeats_path(device, aa_tree, aa_make)
    print(f"pool-kernel launches on the repeats main paths: {pool_launches}; "
          f"fused-kernel launches on 'repeats-dense-fused': {rep[6][0]}",
          flush=True)

    # 14. times at 246 x 4465, and the mxu_probe yardstick
    pool_ms = repeats_times(rep[2], rep[3], rep_dense, rep[5], rep_tree,
                            gpu)
    bounds["pool_update"] = pool_ms[2]

    # 15. the new variants of kernels 1, 2, 3 and 5 vs plain on the card
    var_err, var_keep = slice_kernel_cases(
        device, small, small_by, cat, cat_by, big, big_by, aa_tree, aa_by,
        flagship)

    # 16. the slice's paths at full width, launches counted
    pr_fused, pr_level = per_rate_dna_path(device, big, big_by)
    raw_fused = raw_tip_dna_path(device, big, big_by)
    asc_fused, asc_level = asc_dna_path(device, big)
    pr_rows = per_rate_protein_path(device, aa_tree, aa_by)
    rep_pool, rep_fused = repeats_slice_paths(device, rep_tree, rep_make)
    print(f"slice launches: fused kernel per-rate {pr_fused}, raw tips "
          f"{raw_fused}, asc {asc_fused}, repeats {rep_fused}; rows kernel "
          f"per-rate {pr_rows}; level kernel per-rate {pr_level}, asc "
          f"{asc_level}; pool kernel {rep_pool}", flush=True)

    # 17. times of the new variants
    var_ms = slice_times(var_keep, gpu)

    # 18. the matrix-unit probe
    probe_entry = probe_phase(gpu)
    if args.profile:
        profile([("DNA main path", eng), ("protein main path", aa_eng),
                 ("DNA levels-kernel path", dna[3]),
                 ("protein levels-kernel path", prot[3]),
                 ("DNA repeats pool-pallas path", rep[3][0]),
                 ("DNA repeats-dense-fused path", rep[3][1])], args.profile)

    print(gpu, flush=True)

    def bound(name):
        return {"bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": None}

    def variant(prefix, key, launches):
        k, p, (b, by), *bf = var_ms[key]
        out = {f"{prefix}_ms": k, f"{prefix}_plain_ms": p,
               f"{prefix}_bound_ms": b, f"{prefix}_bound_by": by,
               f"{prefix}_max_abs_err": var_err[key]}
        if launches is not None:
            out[f"{prefix}_launches"] = launches
        if bf:
            out.update({f"{prefix}_bf16_ms": bf[0],
                        f"{prefix}_bf16_plain_ms": bf[1]})
        return out

    print(json.dumps({"kernels": [{
        "name": "fused_traversal", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/fused_traversal.cu",
        "replaces": "libpll2_tpu/ops/pallas_fused.py:299",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms_kernel, "plain_ms": ms_plain,
        **bound("fused_traversal"),
        "repeats_launches": rep[6][0], "repeats_max_abs_err": rep[6][1],
        "repeats_ms": pool_ms[3][0], "repeats_plain_ms": pool_ms[3][1],
        "repeats_bound_ms": pool_ms[3][2][0],
        "repeats_bound_by": pool_ms[3][2][1],
        **variant("per_rate", "fused_per_rate", pr_fused),
        **variant("raw_tips", "fused_raw", raw_fused),
        "asc_launches": asc_fused,
        "repeats_slice_launches": rep_fused}, {
        "name": "fused_traversal_rows", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/fused_traversal_rows.cu",
        "replaces": "libpll2_tpu/ops/pallas_fused.py:419",
        "launches": rows_launches, "max_abs_err": rows_max_abs,
        "ms": rows_ms["split"][0], "plain_ms": rows_ms["split"][1],
        **bound("fused_traversal_rows"),
        "bf16_ms": rows_ms["bf16"][0],
        "bf16_plain_ms": rows_ms["bf16"][1],
        **variant("per_rate", "rows_per_rate", pr_rows),
        **variant("raw_tips_per_rate", "rows_raw", None)}, {
        "name": "level_update", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/level_update.cu",
        "replaces": ["libpll2_tpu/ops/pallas_partials.py:48",
                     "libpll2_tpu/ops/pallas_partials.py:170"],
        "launches": level_launches, "max_abs_err": level_max_abs,
        "ms": lv_ms[0], "plain_ms": lv_ms[1], **bound("level_update"),
        "protein_ms": lv_aa_ms[0], "protein_plain_ms": lv_aa_ms[1],
        "protein_bound_ms": aa_level_bound[0],
        "protein_bound_by": aa_level_bound[1],
        **variant("per_rate", "level_per_rate", pr_level),
        "asc_launches": asc_level}, {
        "name": "pool_update", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/pool_update.cu",
        "replaces": "libpll2_tpu/ops/pallas_repeats.py:45",
        "launches": pool_launches, "max_abs_err": pool_max_abs,
        "ms": pool_ms[0], "plain_ms": pool_ms[1],
        **bound("pool_update"),
        **variant("per_rate", "pool_per_rate", rep_pool)},
        probe_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
