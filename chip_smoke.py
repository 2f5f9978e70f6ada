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
     one loglikelihood() and one newton_step().

The last three lines are the card's name and power limit, one JSON object
listing every kernel, and {"ok": true, "device": ...}.
Exits non-zero, printing no result, when there is no CUDA device.
`--profile DIR` also writes a torch.profiler breakdown of one
loglikelihood() and one newton_step() of each main path to
DIR/profile.txt.
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
REPS = 25
WARMUP = 3


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


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


def build_engine(tree, by_label, sites, device, rate_cats=4):
    """bench.py:39-60's problem on `device` in float32."""
    import numpy as np
    import torch
    from libpll2_tpu_torch import Partition, TreeEngine, compute_gamma_cats
    from libpll2_tpu_torch.io import maps

    part = Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                     tree.edge_count, rate_cats, tree.inner_count,
                     device=device, dtype=torch.float32)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    rng = np.random.default_rng(SEED)
    part.set_frequencies(0, rng.dirichlet(np.ones(4) * 10))
    part.set_subst_params(0, rng.uniform(0.5, 2.0, size=6))
    part.set_category_rates(compute_gamma_cats(0.8, rate_cats))
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
                 must_scale=False):
    """Kernel vs plain traversal on one problem; returns (max relative
    error, max absolute error)."""
    import torch
    from libpll2_tpu_torch.ops.fused import (fused_traversal,
                                             fused_traversal_reference)

    part, eng = build_engine(tree, by_label, sites, device, rate_cats)
    codes, pm, table = traversal_inputs(eng)
    kw = dict(rates=rate_cats, states=4, n_slots=eng.fused_slots,
              threshold=part.scale_threshold, factor=part.scale_factor)
    got = fused_traversal(codes, pm, table, **kw)
    want = fused_traversal_reference(codes, pm, table, **kw)
    torch.cuda.synchronize()
    for g, w, which in ((got[2], want[2], "parent"),
                        (got[3], want[3], "child")):
        check(torch.equal(g, w), f"{name}: {which} scaler counts differ "
              f"at {int((g != w).sum())} sites")
    rel, abs_err = 0.0, 0.0
    for g, w in zip(got[:2], want[:2]):
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite CLVs")
        site_max = w.abs().amax(dim=(0, 1)).clamp(min=1e-30)
        rel = max(rel, float(((g - w).abs() / site_max).max()))
        abs_err = max(abs_err, float((g - w).abs().max()))
    scaled = int(max(want[2].max(), want[3].max()))
    print(f"kernel vs plain [{name}]: {tree.tip_count} taxa x {sites} sites,"
          f" {rate_cats} rates, {eng.fused_slots} slots: scaler counts "
          f"equal (max {scaled}), max_rel_err {rel:.3e}, max_abs_err "
          f"{abs_err:.3e}", flush=True)
    check(rel <= TOL_CLV, f"{name}: max_rel_err {rel:.3e} > {TOL_CLV}")
    if must_scale:
        check(scaled > 0, f"{name}: scaling never triggered")
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
    total, d1, d2, _ = _fused_newton_step(
        *model, eng.params_idx_rates, branches.to(f64), eng.table,
        eng._tip_codes(), eng.root_idx[4], pw, inv, eng.fused_slots,
        C.SCALE_THRESHOLD, C.SCALE_FACTOR,
        traversal=fused_traversal_reference)
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


def build_protein_engine(tree, by_label, sites, device, states=20,
                         rate_cats=4):
    """LG+G4 (alpha 0.9) on `device` in float32, tips installed in one
    batch; other alphabets get random GTR parameters from SEED."""
    import numpy as np
    import torch
    from libpll2_tpu_torch import Partition, TreeEngine, compute_gamma_cats
    from libpll2_tpu_torch.models import load_aa_model

    part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, rate_cats, tree.inner_count,
                     device=device, dtype=torch.float32)
    tips = list(tree.tips())
    part.set_tip_states_batch(charmap(states),
                              [by_label[t.label] for t in tips],
                              [t.clv_index for t in tips])
    if states == 20:
        load_aa_model(part, "lg")
    else:
        rng = np.random.default_rng(SEED)
        part.set_frequencies(0, rng.dirichlet(np.ones(states) * 10))
        part.set_subst_params(0, rng.uniform(0.5, 2.0,
                                             states * (states - 1) // 2))
    part.set_category_rates(compute_gamma_cats(0.9, rate_cats))
    return part, TreeEngine(part, tree)


def compare_rows_case(name, tree, by_label, sites, device, states=20,
                      rate_cats=4, must_scale=False):
    """Rows kernel vs plain traversal on one problem: 'highest' (and
    'split', the same code) to equal counts and TOL_CLV, 'bf16' at the logL
    level. Returns (max relative error, max absolute error)."""
    import torch
    from libpll2_tpu_torch.engine import _fused_loglikelihood
    from libpll2_tpu_torch.ops.fused import (fused_traversal,
                                             fused_traversal_reference)

    part, eng = build_protein_engine(tree, by_label, sites, device, states,
                                     rate_cats)
    codes, pm, table = traversal_inputs(eng)
    kw = dict(rates=rate_cats, states=states, n_slots=eng.fused_slots,
              threshold=part.scale_threshold, factor=part.scale_factor)
    got = fused_traversal(codes, pm, table, mxu="highest", **kw)
    split = fused_traversal(codes, pm, table, mxu="split", **kw)
    want = fused_traversal_reference(codes, pm, table, mxu="highest", **kw)
    torch.cuda.synchronize()
    for g, w, which in ((got[2], want[2], "parent"),
                        (got[3], want[3], "child")):
        check(torch.equal(g, w), f"{name}: {which} scaler counts differ "
              f"at {int((g != w).sum())} sites")
    check(all(torch.equal(a, b) for a, b in zip(split, got)),
          f"{name}: mxu='split' differs from mxu='highest'")
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
        total, _, r = _fused_loglikelihood(*eng._args(), traversal=trav,
                                           mxu="bf16")
        lk.append(float(total))
        rows.append(r)
    torch.cuda.synchronize()
    bf_rel = abs(lk[0] - lk[1]) / abs(lk[1])
    sc_diff = sum(int((rows[0][i] != rows[1][i]).sum()) for i in (2, 3))
    print(f"rows kernel vs plain [{name}]: {tree.tip_count} taxa x {sites} "
          f"sites, {states} states, {rate_cats} rates, {eng.fused_slots} "
          f"slots: highest/split scaler counts equal (max {scaled}), "
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
    compare_case("ragged", small, dict(zip(headers, seqs)), 1000, device)
    compare_case("runtime-size variant, 3 rates", small,
                 dict(zip(headers, seqs)), 1000, device, rate_cats=3)
    cat = parse_newick(caterpillar_newick(80))
    headers, seqs = random_alignment(80, 1000, seed=3)
    compare_case("caterpillar", cat, dict(zip(headers, seqs)), 1000, device,
                 must_scale=True)
    headers, seqs = random_alignment(N_TAXA, N_SITES, seed=SEED)
    _, max_abs = compare_case("main-path shape", random_utree(headers,
                                                              seed=SEED),
                              dict(zip(headers, seqs)), N_SITES, device)

    # 4. main path
    eng, part, launches = main_path(device)

    # 5. times
    ms_kernel, ms_plain = times(eng, part, gpu, N_TAXA, N_SITES)["split"]

    # 6. rows kernel vs plain on the card
    headers, seqs = random_alignment(16, 1000, alphabet=AA_NOISY, seed=3)
    by = dict(zip(headers, seqs))
    compare_rows_case("ragged AA", small, by, 1000, device)
    compare_rows_case("3 rates", small, by, 1000, device, rate_cats=3)
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
    if args.profile:
        profile([("DNA main path", eng), ("protein main path", aa_eng)],
                args.profile)

    print(gpu, flush=True)

    print(json.dumps({"kernels": [{
        "name": "fused_traversal", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/fused_traversal.cu",
        "replaces": "libpll2_tpu/ops/pallas_fused.py:299",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms_kernel, "plain_ms": ms_plain}, {
        "name": "fused_traversal_rows", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/fused_traversal_rows.cu",
        "replaces": "libpll2_tpu/ops/pallas_fused.py:419",
        "launches": rows_launches, "max_abs_err": rows_max_abs,
        "ms": rows_ms["split"][0], "plain_ms": rows_ms["split"][1],
        "bf16_ms": rows_ms["bf16"][0],
        "bf16_plain_ms": rows_ms["bf16"][1]}]}), flush=True)
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
