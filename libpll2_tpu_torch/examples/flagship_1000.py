"""The flagship end-to-end analysis at 1000 taxa (port of
examples/flagship_1000.py), a RAxML-NG-class pipeline:

    alignment -> pattern compression -> native stepwise-parsimony
    starting tree -> model optimization (batched central-difference Adam,
    each step's trials one launch of the fused kernel) + all-edges Newton
    smoothing -> streamed SPR (full radius-5 neighbourhood) + streamed NNI
    -> final smoothing -> bootstrap -> checkpoint -> certified final
    evaluation (`loglikelihood_df64`, float64 on the card)

The data is the JAX example's: a simulated 1000-taxon alignment of 4000
sites, conserved enough that pattern compression engages (3581 patterns).
Runs the pipeline twice in one process: pass 1 includes the builds of the
CUDA kernels (nvcc) and of the native library (g++), pass 2 reuses them.
Then the checkpoint is loaded on the CPU in float64 and evaluated on the
plain path (the cross-check; JAX needed a subprocess for float64). Prints
each stage's wall clock, the certified logL and its relative error against
the CPU's float64, and the card's name and power limit; writes the same as
`flagship.json` into the output directory, with the checkpoint.

Usage: python -m libpll2_tpu_torch.examples.flagship_1000 [--taxa N]
       [--sites N] [--device cpu|cuda] [--out DIR]
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import torch

from .. import (Partition, TreeEngine, bootstrap_loglikelihoods, checkpoint,
                compute_gamma_cats, loglikelihood_df64)
from ..io import maps
from ..io.compress import compress_site_patterns
from ..ops import spr_stream
from ..optimize import maximize_fused, newton_smooth_all
from ..parsimony import FastParsimony
from ..parsimony.stepwise import fastparsimony_stepwise
from ..search import TreeSearch
from ..trees import export_newick, random_utree
from ..trees.utree import reset_template_indices
from ..utils import simulate_alignment
from ._cli import parser

# the pipeline's depth, as in the JAX example: 2 rounds of (60
# maximize_fused steps + 2 sweep passes), radius-5 SPR, 3 final passes,
# 1000 bootstrap replicates
DEPTH = {"rounds": 2, "fused_steps": 60, "round_passes": 2, "radius": 5,
         "final_passes": 3, "replicates": 1000}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(taxa=1000, sites=4000, t0=None, stages=None, search_split=None,
        device="cuda", out_dir=None, seed=7, depth=None):
    """One pipeline pass; appends [stage, seconds] to `stages` and, with a
    `search_split` list, the SPR stage's host and device seconds (the
    device's: `spr_stream_scores` calls, the device synchronised around
    each). `depth` overrides entries of DEPTH. The checkpoint goes to
    `out_dir`/flagship.ckpt.npz, by default in a new temporary directory.
    Returns the pass's results, with its final `partition` and `tree`."""
    d = dict(DEPTH, **(depth or {}))
    if out_dir is None:
        out_dir = tempfile.mkdtemp(prefix="flagship_")
    stages = [] if stages is None else stages
    if t0 is None:
        t0 = time.perf_counter()

    def mark(stage, since):
        _sync(device)
        dt = time.perf_counter() - since
        stages.append([stage, round(dt, 4)])
        print(f"[{time.perf_counter()-t0:7.1f}s] {stage}: {dt:.2f} s",
              flush=True)
        return time.perf_counter()

    # --- data (outside the timed pipeline: IO stand-in) -----------------
    true_tree = random_utree([f"t{i}" for i in range(taxa)], seed=seed)
    for node in true_tree.nodes():
        for h in ([node] if node.is_tip() else list(node.ring())):
            if h.back is not None:
                # conserved regime so compression/repeats engage
                h.length = h.back.length = max(h.length * 0.12, 0.004)
    headers, seqs = simulate_alignment(
        true_tree, sites, [0.3, 0.2, 0.2, 0.3],
        [1.2, 3.5, 0.8, 1.1, 3.0, 1.0], alpha=0.8, seed=seed)
    n = len(headers)
    t = time.perf_counter()

    # --- 1. pattern compression -----------------------------------------
    comp, weights, _ = compress_site_patterns(seqs, maps.map_nt)
    patterns = len(comp[0])
    t = mark(f"compress ({sites} sites -> {patterns} patterns)", t)

    # --- 2. native stepwise-parsimony starting tree ---------------------
    pars_part = Partition(n, n - 2, 4, patterns, 1, 2 * n - 3, 1, n - 2,
                          device=device)
    pars_part.set_tip_states_batch(maps.map_nt, comp)
    pars_part.set_pattern_weights(weights)
    fp = FastParsimony(pars_part)
    tree, cost = fastparsimony_stepwise([fp], headers, seed)
    t = mark(f"stepwise starting tree (parsimony {cost})", t)

    seen = set()
    for node in tree.nodes():
        for h in ([node] if node.is_tip() else list(node.ring())):
            if h.back is not None and id(h) not in seen:
                seen.add(id(h)), seen.add(id(h.back))
                h.length = h.back.length = 0.05
    reset_template_indices(tree.vroot, tree.tip_count)

    part = Partition(n, n - 2, 4, patterns, 1, 2 * n - 3, 4, n - 2,
                     device=device)
    by_label = dict(zip(headers, comp))
    tips = list(tree.tips())
    part.set_tip_states_batch(maps.map_nt,
                              [by_label[t.label] for t in tips],
                              tip_indices=[t.clv_index for t in tips])
    part.set_pattern_weights(weights)
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1.0, 1.1, 0.9, 1.05, 0.95, 1.0])
    part.set_category_rates(compute_gamma_cats(1.0, 4))
    eng = TreeEngine(part, tree)
    lk0 = eng.loglikelihood()
    t = mark(f"first evaluation (logL {lk0:.1f}, "
             f"path {eng.execution_path})", t)

    # --- 3. model + branch optimization (fused fast path) ---------------
    lk = lk0
    for _ in range(d["rounds"]):
        lk, params, h = maximize_fused(eng, ("subst", "freqs"),
                                       steps=d["fused_steps"],
                                       learning_rate=0.05)
        if d["round_passes"]:
            lk = newton_smooth_all(eng, tree, passes=d["round_passes"])
    t = mark(f"model + branch optimization (logL {lk:.1f})", t)

    # --- 4. streamed SPR (FULL radius-5 neighborhood) to convergence ----
    dev_t = [0.0]
    orig = spr_stream.spr_stream_scores
    if search_split is not None:
        def timed(*a, **k):
            _sync(device)
            s0 = time.perf_counter()
            out = orig(*a, **k)
            _sync(device)
            dev_t[0] += time.perf_counter() - s0
            return out

        spr_stream.spr_stream_scores = timed
    search = TreeSearch(part, tree, engine=eng)
    try:
        lk_spr, acc_spr = search.spr_round_streamed(radius=d["radius"])
    finally:
        spr_stream.spr_stream_scores = orig
    t = mark(f"streamed SPR rounds (radius {d['radius']}, {acc_spr} moves, "
             f"logL {lk_spr:.1f})", t)
    if search_split is not None:
        wall = stages[-1][1]
        search_split.append({"stage": "spr", "wall": wall,
                             "device": round(dev_t[0], 4),
                             "host": round(wall - dev_t[0], 4)})

    lk_nni, acc_nni = search.nni_round_streamed()
    t = mark(f"streamed NNI rounds ({acc_nni} moves, "
             f"logL {lk_nni:.1f})", t)

    # --- 5. final branch smoothing --------------------------------------
    eng2 = TreeEngine(part, tree)
    lk_final = newton_smooth_all(eng2, tree, passes=d["final_passes"])
    # write the optimized engine branches back onto the tree halves: the
    # checkpointed newick (and the float64 cross-check) must carry them
    eng2.apply_branches_to_tree(tree)
    t = mark(f"final branch smoothing (logL {lk_final:.1f})", t)

    # --- 6. bootstrap ----------------------------------------------------
    logls, _ = bootstrap_loglikelihoods(eng2, d["replicates"], seed=seed)
    t = mark(f"{d['replicates']} bootstrap replicates "
             f"(mean {logls.mean():.1f})", t)

    # --- 7. checkpoint ---------------------------------------------------
    ckpt = os.path.join(out_dir, "flagship.ckpt.npz")
    checkpoint.save(ckpt, part, tree, best_logl=lk_final)
    t = mark("checkpoint", t)

    # --- 8. certified final evaluation (float64 on the device) ----------
    lk_cert = loglikelihood_df64(part, tree)
    t = mark(f"df64 certified eval (logL {lk_cert:.4f})", t)
    return {"taxa": taxa, "sites": sites, "patterns": patterns,
            "logl": float(lk_final), "df64_logl": float(lk_cert),
            "ckpt": ckpt, "newick_head": export_newick(tree.vroot)[:80],
            "partition": part, "tree": tree}


def fp64_check(ckpt_path) -> float:
    """The checkpointed analysis rebuilt on the CPU in float64 and evaluated
    on the plain path: the final topology's logL."""
    part, tree, _ = checkpoint.load(ckpt_path, dtype=torch.float64,
                                    device="cpu")
    return TreeEngine(part, tree, pallas=False).loglikelihood()


def card(device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--taxa", type=int, default=1000)
    ap.add_argument("--sites", type=int, default=4000)
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="output directory for flagship.json and the "
                    "checkpoint (default: a new temporary directory)")
    args = ap.parse_args(argv)
    out_dir = args.out or tempfile.mkdtemp(prefix="flagship_")
    os.makedirs(out_dir, exist_ok=True)
    gpu = card(args.device)
    print(f"device: {args.device} ({gpu}); {args.taxa} taxa x {args.sites} "
          f"sites", flush=True)

    t0 = time.perf_counter()
    cold_stages, warm_stages, split = [], [], []
    print("--- pass 1 (cold: includes the kernel and native builds) ---",
          flush=True)
    run(args.taxa, args.sites, t0, cold_stages, device=args.device,
        out_dir=out_dir)
    cold_total = time.perf_counter() - t0

    print("--- pass 2 (warm: every build reused) ---", flush=True)
    t1 = time.perf_counter()
    info = run(args.taxa, args.sites, t0, warm_stages, search_split=split,
               device=args.device, out_dir=out_dir)
    warm_total = time.perf_counter() - t1
    del info["partition"], info["tree"]

    print("--- float64 cross-check (checkpoint on the CPU) ---", flush=True)
    fp64_logl = fp64_check(info["ckpt"])
    rel = abs(info["logl"] - fp64_logl) / abs(fp64_logl)
    rel_cert = abs(info["df64_logl"] - fp64_logl) / abs(fp64_logl)
    print(f"float32 logL {info['logl']:.4f} vs float64 CPU "
          f"{fp64_logl:.4f} (rel {rel:.2e}); certified float64 on "
          f"{args.device} {info['df64_logl']:.4f} (rel {rel_cert:.2e})",
          flush=True)

    out = {"device": args.device, "card": gpu, **info,
           "cold_total_s": round(cold_total, 2),
           "warm_total_s": round(warm_total, 2),
           "cold_stages": cold_stages, "warm_stages": warm_stages,
           "search_split": split, "fp64_logl": fp64_logl,
           "fp64_rel_err": rel, "df64_rel_err": rel_cert}
    with open(os.path.join(out_dir, "flagship.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(gpu, flush=True)
    print(json.dumps({"cold_s": out["cold_total_s"],
                      "warm_s": out["warm_total_s"],
                      "fp64_rel_err": rel, "df64_rel_err": rel_cert,
                      "out": out_dir}), flush=True)
    return out


if __name__ == "__main__":
    main()
