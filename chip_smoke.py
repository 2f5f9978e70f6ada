#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (libpll2_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --rows-only CHECKOUT
    python3 chip_smoke.py --fused-only CHECKOUT
    python3 chip_smoke.py --generic-only CHECKOUT
    python3 chip_smoke.py --pool-only CHECKOUT
    python3 chip_smoke.py --levels-only CHECKOUT
    python3 chip_smoke.py --mesh-only
    python3 chip_smoke.py --loops-only
    python3 chip_smoke.py --states64-only
    python3 chip_smoke.py --states64-times
    python3 chip_smoke.py --probe-only CHECKOUT

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
     shape (a thread block cluster of 2 blocks, FUSED_MAIN_PLAN), and
     every plan and thread layout of ops/_kernels.py:fused_plan (40003 and
     4465 sites: two sites a thread, ragged tails; 4159: one; 250 slots:
     the spill plan), each 4 x 4 on-chip case equal to its walk at 1, 2, 4
     and 8 blocks a cluster to the bit (`cluster_walks_equal`; the
     246 x 4465 repeats walk of phase 13 in clusters of 4,
     FUSED_REPEATS_PLAN); then the runtime-size body (fused_generic,
     every shape but 4 x 4: `generic_cases`) at 1, 3, 8 and 33 rates and at
     2, 5 and 15 states, each as the walk is, per rate, with raw tip rows,
     as 3 candidates, as 3 queries of 2 candidates and spilled (1000 slots,
     2000 at 2 states), and the rescaling caterpillar at 3 rates per site
     and per rate; each case prints the plan it ran and must run the one
     expected;
  4. main path: bench.py's problem (128 taxa x 16384 sites, GTR+G4 DNA,
     seed 7) through Partition(device="cuda") and TreeEngine:
     loglikelihood() and three newton_step()s, counted kernel launches, and
     the same problem through the plain path in float64 on the card;
  5. times: medians over CUDA events of the kernel, the plain traversal,
     one loglikelihood() and one newton_step() at 128 x 16384; then the
     kernel's device time over one traversal from torch.profiler (and per
     op); 5b. the runtime-size body at full width (GENERIC_FULL: bench.py's
     DNA problem at 1 and 8 categories, a 5-state alphabet at 4): each
     against its plain version on the card, through TreeEngine 'fused'
     (loglikelihood() and one newton_step(), 2 launches counted, logL
     against the float64 plain path), its call, device time, bound, plain
     time and plan;
  6. rows kernel vs plain: first the rows kernel's build report
     (`rows_build_report`: each instantiation's registers and spills, the
     log's wgmma serialization notes, the HGMMA count in its SASS; every
     tensor-core body must issue HGMMA, unserialized and without spills);
     then ops/fused.py:fused_traversal_rows (the CUDA kernel for 16 or
     more states) against the plain version of each mode on the card,
     float32: 16 taxa x 1000 ragged AA sites with B/Z/X/gaps, an 80-taxon
     caterpillar where scaling must trigger, a 3-category case, 16-, 17-,
     21- and 32-state alphabets through a custom charmap (17 and 21: P
     padded to 20 and 24 states), 40003 sites (a tail tile of 3), 12
     slots forced (the tensor cores' slots in device memory), the spill
     plans (ops/_kernels.py:rows_plan) at 8 rates x 32 states with per-rate
     counts and at 16 and 32 rates x 32 states, and the protein main
     path's 128 x 8192 shape; each case prints the plan each mode ran and
     must run the one expected ('highest' on the CUDA cores; 'split' and
     'bf16' on the tensor cores, 'tc-on-chip' or 'tc-spill', but at 32
     rates x 32 states). 'highest' is held to equal scaler counts and
     TOL_CLV; 'split' to equal counts but at ties (TOL_SPLIT_TIE) and
     TOL_SPLIT_CLV; 'bf16' to equal counts but at ties (TOL_BF16_TIE);
     both rounded modes at the logL level (TOL_BF16_LOGL);
  7. protein main path: tools/benchmarks.py:163's problem (128 taxa x 8192
     sites simulated with 20 equal-rate states, alpha 0.9, seed 11,
     evaluated under LG+G4) through Partition(device="cuda") and
     TreeEngine: loglikelihood() and three newton_step()s in the default
     mxu='split', one loglikelihood() with mxu='bf16', counted rows-kernel
     launches, and the same problem through the plain path in float64 on
     the card;
  8. times at 128 x 8192: the rows kernel and its plain version per mode
     ('split', 'bf16', 'highest'), one loglikelihood() and one
     newton_step(); then the rows kernel's device time over one traversal
     per mode from torch.profiler (and per op, with the plan each ran),
     its bounds per mode ('split' and 'bf16' on the tensor cores at the
     bf16 peak, three passes and one; 'highest' at the float32 peak; the
     bytes), and 16 rates x 32 states on the protein tree at 128 x 4096
     (against its plain version, then timed: 'tc-spill' in 'split');
  9. level kernel vs plain: ops/levels.py:level_update (csrc/level_update.cu)
     against level_update_reference over whole op lists on the card,
     float32, from the same buffers: 16 x 1000 ragged DNA, 3 categories,
     the 80-taxon caterpillar (scaling must trigger), 20, 32, 5 and 2
     states, ops without a scaler buffer, a partial op list, an op that
     writes its own child in place, 16 rates x 32 states with per-rate
     counts (P beyond one 48 KB staging), 128 x 16384 DNA per site and
     per rate, 128 x 16387 DNA and the caterpillar at 16384 sites (each
     printing the 4x4 variant's layout level by level and failing on
     another: ops/_kernels.py:level_fixed_plan's 4, 2 and 1 sites a lane)
     and the 128 x 8192 LG+G4 protein tree (the runtime-size variant's
     thread layouts of the protein main path); scaler rows equal and CLV
     rows within TOL_CLV;
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
     traversal, at both sizes; of the level kernel and its plain version
     over the 80-taxon caterpillar (78 levels of one op each) at 16384
     sites; then, after those timings, the level kernels' device time over
     one traversal at both sizes, over the caterpillar and over the DNA
     tree with per-rate counts, from torch.profiler, level by level beside
     each level's byte bound, the rate its bytes imply and its layout;
 12. pool kernel vs plain: ops/pool.py:update_partials_pool and
     pool_update (csrc/pool_update.cu) against pool_update_reference over
     whole op lists on site-repeats partitions, float32, from the same
     buffers: 24 x 600 DNA, the 150-taxon caterpillar x 300 (scaling must
     trigger), 3 categories (also per rate), 1 category, 20 conserved
     states (also per rate), 5, 17 and 32 states, a partial op list, ops
     without a scaler buffer, bench.py's 128 x 16384 random columns
     (repeats off at most inner nodes: identity ops at full width), 64 x
     4096 random DNA at 3 rates (a level's ops 16x apart), the 246 x 4465
     conserved problem (the 4x4 traversal kernel, one launch a traversal;
     also a serial-fallback list with write-after-read hazards, two
     traversals back to back under different P-matrices, each level a
     launch of its own, and per rate with a grid of more blocks than
     tickets), the 128 x 8192 conserved protein and a simulated 128 x
     16384 protein; scaler regions equal and class columns within TOL_CLV
     of each column's max, the launches counted; each runtime-size case
     launched with the thread layout it names (the plan's launches);
 13. the site-repeats paths at full width: tools/benchmarks.py:221-254's
     246 taxa x 4465 conserved sites, GTR+G4, through the step-by-step
     chain on Partition(site_repeats=True, device="cuda"), a partial
     traversal (equal to the full one), TreeEngine(pallas="pool") with
     loglikelihood() and three newton_step()s, the default TreeEngine
     ('repeats-dense-fused': fused-kernel launches counted, and the kernel
     held against its plain version at this shape) and edge_params with
     two rate matrices; and the conserved 128 x 8192 LG+G4 protein on
     'pool-pallas'; each against the float64 plain dense path on the card,
     pool-kernel launches counted (one a traversal at 4x4, one a level for
     the protein), with the class columns' share of plain work, the pooled
     buffers' size against the dense ones and the host schedule time;
 14. times at 246 x 4465: the pool kernel over one traversal and its plain
     version (and its bound from the class counts), its device time (one
     launch, beside the traversal's bound and its levels' own bounds
     summed) and host enqueue time, the fused kernel and
     its plain version on the 'repeats-dense-fused' inputs,
     loglikelihood() on 'pool-pallas', 'repeats-dense-fused' and a dense
     partition's fused path, one step-by-step traversal; then the fused
     kernel's device time on the 'repeats-dense-fused'
     inputs, and the pool kernel's runtime-size variant over one traversal
     of the conserved 128 x 8192 protein (kernel, plain version, device
     time and bound);
 15-18. the per-rate and raw-tip modes of kernels 1, 2, 3 and 5 against
     their plain versions (kernel 1 also in every plan and thread layout),
     and kernel 1's device time per rate and with all tips raw, the slice's
     paths at full width with their launches counted, their times, and the
     matrix-unit probe (phase 18: every mode against its plain version at
     every probe shape, and its `pack` kernel against its own; its
     kernels' registers, spills (and those inside the loops that issue
     HGMMA, from cuobjdump's SASS) and HGMMA count; its table at 8 and 264
     column tiles beside each row's bound and one torch.matmul of the same
     products a call; `pack`'s device time);
 19. candidate scoring (TreeEngine.evaluate_topologies, pack_candidate +
     evaluate_packed, evaluate_packed_arrays): the full NNI neighbourhood
     of the DNA main path's tree (250 candidates, 2 chunks of the fused
     kernel's candidate form a call) through the three entry points,
     launches counted, each score against its candidate's set_topology +
     loglikelihood() on the card and the first four against the float64
     plain path; 64 protein candidates at 128 x 8192 in 'split' and
     'bf16' (one launch of the rows kernel each); 64 candidates of the 246
     x 4465 repeats problem on 'repeats-dense-fused' (one launch) and 4 on
     'pool-pallas' (one pool-kernel dispatch each); each kernel's
     candidate form against its plain version at the path's own K (a DNA
     chunk of 128, 64 protein, 64 repeats), the plan it took, its call
     and device time a chunk beside its bound, the plain version's call;
     the host's packing a candidate for each entry point, each call in
     candidates/s and the same candidates through set_topology +
     loglikelihood() one at a time;
 20. topology search (libpll2_tpu_torch.search.TreeSearch): the DNA
     problem's alignment simulated on its tree (128 x 16384, seed 7) and
     the search started 3 NNI and 2 SPR seeded moves away;
     spr_round_streamed(radius=5) and nni_round_streamed() to convergence
     (at most SEARCH_CAP iterations each) on the default 'fused' engine,
     each iteration printing its candidates, the native schedule's ms,
     n_aux / n_arows / the extended buffers' MB, the level kernel's
     launches and the passes' device time (torch.profiler), the scoring
     and verify ms and the logL; the first iterations' streamed scores
     against set_topology + loglikelihood() (every NNI candidate; 64
     seeded SPR candidates and the best 8), 4 of each against the float64
     plain path on the CPU; the first SPR iteration's passes, wave by
     wave, against the level kernel's plain version, with their call time
     and bound; spr_round_batched(radius=5) and nni_round_batched() (the
     native builder, the fused kernel's candidate form), each accepting as
     many moves as its streamed twin and ending within TOL_LOGL of it, with
     the native builder's host us a candidate beside the Python walk's it
     replaces, and the round's candidates/s (every round starts on its
     own copy of the tree: the SPR rounds 5 moves away, the NNI rounds the
     3 NNI moves away, which they must undo in part at least);
     TreeSearch.run(max_rounds=1,
     use_spr=False); then one streamed NNI iteration on the 246 x 4465
     repeats problem ('repeats-dense-fused', the dense tip-row base) and on
     the 128 x 8192 LG+G4 protein ('split': the level kernel's runtime-size
     variant), the best 8 against set_topology + loglikelihood() and the
     passes, wave by wave, against the level kernel's plain version; the
     level, fused and rows kernels' launches counted over the phase;
 21. model optimization (libpll2_tpu_torch.optimize, modelselect): phase
     20's DNA problem (128 x 16384, its tree's lengths x 1.7 + 0.02, the
     model started away from the simulation's) on 'fused': one step's
     2n+1 = 19 model trials through the fused kernel's candidate form (one
     launch, the op table repeated, each trial its own P-matrices) against
     its plain version (TOL_LOGL), the launch's call, device time and bound;
     maximize_loglikelihood of subst and freqs (the trial route, one launch
     a step), the Gamma shape and p-inv by Brent, newton_smooth_all(2
     passes) with every step's CLV op a one-op level of the level kernel
     (launches counted), its first pass held step by step against the
     plain version (scaler rows equal, CLVs TOL_CLV, branches 1e-4), and
     the optimized logL against the float64 plain path on the CPU; the
     protein 128 x 8192 LG+G4 'split': maximize_fused of the frequencies
     (41 trials a step on the rows kernel) and one sweep pass on the
     runtime-size level kernel, held step by step as the DNA one; one
     maximize_fused step on 'levels-kernel' (DNA per site and per rate,
     the protein), 'repeats-dense-fused' and 'pool-pallas' (246 x 4465,
     the conserved 128 x 8192 protein), its trials against the path's
     plain version, and on 'levels-kernel' and 'pool-pallas' the trial
     form of the level and pool kernels (B-3b: each chunk of trials one
     launch a level, or at 4x4 one launch a traversal, each trial its own
     P, rows and scaler rows) held chunk by chunk against its plain
     version (scaler rows equal but at ties, CLVs TOL_CLV), the first
     chunk's call, device time (torch.profiler), bound (its trials times
     one traversal's) and plain time printed, and the step's launches
     counted: one a level (a traversal) a chunk of the 2n+1 trials and of
     the final pair, and no other; one value and gradient of make_loglikelihood_fn on a
     pallas=False float32 engine at 128 x 16384 against float64 on the CPU
     (the gradient route launches no kernel); select_dna_model of JC, HKY
     and GTR at a reduced 32 x 2048. Host-clock ms a step, a Brent
     evaluation and a sweep pass, level launches a pass;
 22. an analysis from an alignment file (io, parsimony, bootstrap,
     checkpoint): examples/flagship_1000.py:81-91's data at full width
     (1000 taxa x 4000 sites simulated by utils/simulate.py) written to a
     FASTA and an interleaved PHYLIP file and read back (equal), compressed
     to site patterns (weights summing to 4000); a parsimony Partition on
     the card, FastParsimony and the native stepwise build (the library
     must load), Fitch over the tree's ops on the card (its edge score the
     build's cost, its vectors, costs and one tip's insertion scores over
     every edge == numpy Fitch on the host), the Python loop (Fitch on the
     card) on the first 64 taxa == the native build; lengths 0.1, GTR+G4 on
     the dense path (kernel #1, or #3 where the phase prints
     'levels-kernel'; launches counted) against the float64 plain path on
     the card, count_invariant_sites(); the same data as a site-repeats
     partition on 'pool-pallas' (kernel #5, launches counted) within
     TOL_LOGL of the dense logL, the native classer's classes of every tip
     and op == numpy's; 1000 bootstrap replicates from one evaluation,
     three re-evaluated through set_pattern_weights (TOL_LOGL); a
     checkpoint saved with and without CLVs and loaded onto the card: the
     root edge's logL from the stored CLVs equal to the saved partition's,
     the reloaded engine's within TOL_LOGL. Host-clock ms of each step,
     the classer's ms native and numpy;
 23. placement and partitioned analyses (libpll2_tpu_torch.placement,
     partitioned): (a) tools/benchmarks.py:734-793's EPA workload (a
     101-taxon random_utree, seed 23, 1024 sites simulated under GTR (1, 2,
     1, 1, 2, 1), frequencies 0.3/0.2/0.2/0.3, alpha 0.9; t100 pruned, 197
     edges): place() of the pruned taxon (its true edge ranked first),
     place_batch of 32 queries in chunks of 16, place_stream of 1000 (5 %
     mutated, 20 % gapped copies of reference rows) and to_jplace(top_k=7);
     (b) the DNA main path's 128 x 16384 and the protein's 128 x 8192
     LG+G4 ('split') with their last taxon pruned, 16 and 4 queries through
     place_batch (one chunk) and 1000 through place_stream; every launch
     of the fused kernels' query form (kernel #1 and #2, the queries x
     edges of a chunk in one launch, split along the edges above
     ops/fused.py:QUERY_LAUNCH_BYTES) held against its plain version
     (counts equal but at ties, CLVs TOL_CLV), every place_batch query
     against place() (TOL_LOGL) and the first against float64 on the
     card, place_stream's first queries against place() (2e-5); host-clock
     ms and queries/s of each placer, one launch's device time, bound and
     plain time, prepare_stream's level launches and ms; (c) a
     PartitionedEngine of phase 20's simulated DNA in three partitions,
     each its own GTR+G4, and 2048 LG+G4 protein sites simulated on the
     true tree, on phase 20's start tree: loglikelihood() against four
     single engines and float64 on the card, three linked newton_step()s
     (one root length), one streamed SPR round (radius 5) against its
     batched twin (the same moves and splits, TOL_LOGL), PART_STEPS maximize() steps
     of subst and freqs (maximize_fused a unit), launches counted.
 24. the certified final evaluation and the flagship analysis: (b) first,
     examples/flagship_1000.py's pipeline at its full width (1000 taxa x
     4000 sites, 3581 patterns) through the port's
     `libpll2_tpu_torch.examples.flagship_1000.run`, cut in depth
     (FLAGSHIP_SMOKE_DEPTH: 10 maximize_fused steps, no sweep in stage 3,
     one final pass), its launches counted (one of the float64 walk, the
     certified evaluation), each stage's ms printed, the certified logL
     against float64 on the CPU (the checkpoint's partition on the run's
     tree) at TOL_DF64 and the float32 final logL within TOL_LOGL of it;
     then (a) `loglikelihood_df64` on the DNA main path (128 x 16384), the
     protein (128 x 8192 LG+G4), the 300 x 16384 caterpillar at alpha 0.5
     (it must rescale in float64's window) and the flagship's final
     1000-taxon tree: csrc/fused_traversal.cu's float64 walk (one launch,
     counted) against its plain version on the card (counts equal, CLVs
     TOL_F64_CLV of each site's max), the logL
     against float64 on the CPU at TOL_DF64, the launch's device time
     (torch.profiler), call, bound at the float64 peak and plain time; and
     the engine's profiler annotations' host cost outside a profiler: one
     block's us times the annotations of one DNA loglikelihood(), as a
     share of that call's host time.
 25. site sharding (libpll2_tpu_torch.parallel) on a mesh of MESH_SHARDS
     shards of the one card, which run one after another (their times are
     per-shard overhead, not scaling): (1) the DNA main path's problem
     sharded (Partition(sites_alignment=4, mesh=...)): loglikelihood() and
     three newton_step()s, kernel #1 launched once a shard a call
     (counted), every shard's root rows and counts equal to the unsharded
     run's columns and its per-site logL equal to the likelihood epilogue
     run on those columns (the epilogue's GEMMs may round the full width
     otherwise in the last bit: the sites where they do are printed), the
     totals against the float64 plain path; (2) the protein main path in 'split' and 'bf16' on kernel #2
     the same way; (3) the DNA problem's step-by-step chain, a partial
     traversal (equal to the full list) and pallas='levels-kernel' on
     kernel #3 once a shard a level, and one pass of newton_smooth_all
     sharded and unsharded (each step's level launch once a shard, the
     logL within TOL_LOGL); (4) one streamed SPR round of phase
     20's problem, sharded and unsharded: the same moves and splits; (5)
     one maximize_fused step of phase 21's problem on 'fused' (the trials
     one launch a shard) and on 'levels-kernel' (the level kernel's trial
     form one launch a level a chunk a shard); (6) ShardedRepeatsEngine on the 246 x 4465 problem trimmed
     to 4464 = 4 x 1116 columns, on 'repeats-dense-fused' (kernel #1) and
     the pooled path (kernel #5), and one batched SPR round against the
     unsharded repeats engine on the same columns; (7)
     PartitionedEngine.shard on phase 23c's four units; (8)
     tests/torch_mh_worker.py as one process of 4 shards and as 2
     processes (torch.distributed over gloo, the card shared) of 2 shards
     each: logL, d1 and d2 equal; (9) examples/sharded_multichip.py
     --shards 4 exits 0. Each kernel's call on one shard's block beside
     the unsharded call, and loglikelihood(), newton_step() and the rounds
     sharded beside unsharded. `--mesh-only` runs this phase alone (after
     the build) and prints its numbers as one JSON line.
 26. alphabets of 33-64 states and float64 partitions on the card: the
     `-Xptxas -v` registers and spills of the level and pool kernels'
     64-state body (csrc/states64.cuh: a rate a block, a tile's rates in a
     thread block cluster; no spills allowed); each against its plain
     version (scaler rows equal but at ties, CLVs TOL_CLV): the level
     kernel at 40 states, 61 per rate, the 80-taxon caterpillar at 61
     (scaling must trigger), an op that writes its own child, 61 states at
     5 rates (a cluster of 5), 40 states at 10 rates (2 rates a block) and
     the full-width 61-state problem, the pool kernel at 40 states, 61 per
     rate, 40 x 10 rates and the conserved full-width problem (one rate
     warp); a codon-sized alphabet at full width (61 states, the
     DNA main path's tree, 128 taxa x 4096 sites simulated under seeded
     GTR parameters, Gamma(0.7) x 4): the step-by-step chain, a partial
     traversal and 'levels-kernel' with three Newton steps against the
     float64 plain path on the card, the default engine's route
     ('levels-kernel'), one maximize_fused step of the frequencies (121
     trials) on the level kernel's trial form held chunk by chunk against
     its plain version; its conserved twin as a repeats partition on the
     default 'pool-pallas' (loglikelihood(), newton_step(), a
     maximize_fused step on the pool kernel's trial form); launches
     counted, each kernel's call, plain time, device time (torch.profiler)
     and bound over one traversal, each level's device time beside its own
     bound and its plan (the clusters checked), and a yardstick the port
     never calls (one batched torch.matmul of the 42-op level's
     contractions); then float64 partitions on the card
     (JAX's routes for float64: 'levels', 'scan', 'pool', no kernel
     launch): bench.py's DNA problem (loglikelihood(), newton_step(), the
     step-by-step API's full and partial traversals, the first iteration
     of a streamed SPR round at radius 2, one newton_smooth_all pass at 2
     iterations an edge) and the 246 x 4465 repeats problem, each against
     float64 on the CPU (logL 1e-12, d1/d2 1e-10), the calls' ms beside
     the float32 fused call's. `--states64-only` runs this phase alone;
     `--states64-times` only times the two 64-state kernels on its
     61-state problem, per site and per rate (each held against its
     plain version), for one build against another on one card;
 27. the loops (`--loops-only` runs this phase alone after the build):
     `loglikelihood_loop(k)` and `newton_loop(k)` (engine.py:run_chained:
     the first iteration eager, the next captured once in a CUDA graph and
     replayed k - 1 times) on bench.py's DNA ('fused', 'levels-kernel'),
     the protein ('split', 'bf16'), the 246 x 4465 repeats problem
     ('repeats-dense-fused', 'pool-pallas'), the DNA on a 4-shard mesh of
     the card and a ShardedRepeatsEngine (dense-fused and pooled shards):
     loglikelihood_loop at k = 0, 1, 5 and 65 against the eager chain of k
     evaluations summed in float32 and against k x loglikelihood()
     (TOL_LOGL), newton_loop(5) against 5 chained newton_step()s on a twin
     engine (logL, d1/d2 to TOL_D1 / ATOL_D1, the branches), the launch
     counters against k x one evaluation's and against the profiler's count
     of our kernels in one loglikelihood_loop(65); then bench.py's metric
     (trip counts 5 and 65 differenced, best of 7 in turns) beside one eager
     loglikelihood(), the capture's host ms, and the device-idle share of
     loglikelihood_loop(65) and of 65 eager calls (torch.profiler). The
     JSON line's kernel entries gain `loop_launches` and `loop`.

The last three lines are the card's name and power limit, one JSON object
listing every kernel (with its bound at the card's peaks), and {"ok": true,
"device": ...}.
Exits non-zero, printing no result, when there is no CUDA device.
`--rows-only CHECKOUT` runs only phase 8's rows-kernel times on the protein
main path, importing the port from CHECKOUT (a checkout of another commit):
the build report, a walk in each mode (call and device time, the plan),
and one launch per mode of 64 candidates, 41 model trials and 4 queries x
the pruned tree's edges, and loglikelihood_loop's ms an evaluation; it
prints them as one JSON line: two commits compared on one card.
`--fused-only CHECKOUT` does the same for the DNA fused kernel: its call
and device times on the DNA main path, per rate, with all tips raw and on
the 246 x 4465 'repeats-dense-fused' inputs, each with its plan (G, SPT,
blocks, clusters) and bound; where the checkout has them, the walk at each
cluster size (`cluster_sweep`), a chunk of 128 DNA candidates, a query
launch of 16 x 60 walks and the DNA loop's evaluation. `--generic-only CHECKOUT`
does the same for the runtime-size body: phase 5b's three float32 shapes
and the float64 walk on phase 24a's problems (the flagship's native
stepwise tree over its 3581 patterns standing in for the final tree, which
only the pipeline makes). `--pool-only CHECKOUT` does
the same for the pool kernel: its call, host enqueue and device times (a
level's launch at a time for the runtime-size variant) on the conserved
128 x 8192 protein (per site and per rate), the 246 x 4465 DNA problem
with 3 rates, the conserved 128 x 8192 problem at 5, 17 and 32 states,
and the 4x4 kernel on the 246 x 4465 DNA problem per site and per rate,
with its 'pool-pallas' loglikelihood() and step-by-step traversal and the
time to build its device plan. `--levels-only CHECKOUT` does the same for the
level kernel: its call time, its host enqueue time and its device time
level by level on the DNA main path's tree per site and per rate, on the
80-taxon caterpillar at 16384 sites, and on the protein tree (the
runtime-size variant) as a control. Where the checkout has them, both
also run phase 21's trial forms (each chunk against its plain version; the
first chunk's call, device time, bound and plain time): `--levels-only`
DNA per site and per rate and the protein on 'levels-kernel',
`--pool-only` the 246 x 4465 repeats and the conserved protein on
'pool-pallas'.
`--probe-only CHECKOUT` builds the kernels of CHECKOUT and runs phase 18
alone (the probe against its plain version, its registers, spills and
HGMMA count, its table at 8 and 264 column tiles, and `pack`'s checks and
times at every shape), printing one JSON line.
`--profile DIR` also writes a torch.profiler breakdown of one
loglikelihood() and one newton_step() of each main path (fused and
levels-kernel) to DIR/profile.txt.
"""
from __future__ import annotations

import argparse
import contextlib
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
LETTERS64 = LETTERS32 + "ghijklmnopqrstuvwxyz0123456789@#"
# Root CLVs: kernel vs plain version, both float32, relative to each site's
# largest entry. The kernel's FMAs round differently from PyTorch's einsum
# order; the error grows with the tree's depth (about 1e-6 at 80 levels).
TOL_CLV = 1e-5
# float32 main path vs the float64 plain path (bench_validate.py:61-63):
# logL sums ~1e-7-relative per-site logs; derivatives lose 2-3 digits.
TOL_LOGL = 5e-5
TOL_D1 = 5e-3
ATOL_D1 = 5e-2
# 'bf16' and 'split' modes, rows kernel (the tensor cores) vs plain version:
# both round the same operands to bf16, but a last-bit difference of a
# float32 sum can round a value to the other bf16 neighbour (one bf16 step,
# <= 2^-7 relative, in 'bf16'; hi + lo moves by <= 2^-16 in 'split'), and
# the tensor cores' float32 accumulation rounds toward zero. Both modes are
# held at the logL level; 'split''s root CLVs to TOL_SPLIT_CLV of each
# site's max, and the counts of both to equal but at ties within
# TOL_SPLIT_TIE ('split') or TOL_BF16_TIE ('bf16') of the threshold
TOL_BF16_LOGL = 1e-4
TOL_SPLIT_CLV = 5e-4
TOL_SPLIT_TIE = 1e-3
TOL_BF16_TIE = 2.0 ** -5
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
# torch.profiler sessions a device-time measurement may take
# (`launches_device_us`)
PROFILE_SESSIONS = 5
PROFILE_WARMUP_S = 0.05    # sentinel kernels opening a profiled session
PROFILE_MARKER_CYCLES = 1000   # a marker kernel's spin (`between_markers`)
# fused_traversal.cu's thread layouts on an H100 (ops/_kernels.py:fused_plan,
# 132 SMs): site counts and the threads a site each takes (40003 and 4465,
# the repeats problem's width: two sites a thread, 64-site blocks with tails
# of 3 and 49; 4159, the widest with one site a thread: 32-site blocks with
# a tail of 31; 1000 sites take one too), and a slot count that forces the
# spill plan
FUSED_LAYOUT_SITES = ((40003, 2), (4465, 2), (4159, 4))
FUSED_SPILL_SLOTS = 250
# the 4 x 4 on-chip body's plans (plan, threads a site, blocks a cluster)
# at the DNA main path's 128 x 16384 (126 ops: two subtree streams side by
# side) and the 246 x 4465 repeats problem (244 ops: four); the cases above
# keep one block a walk
FUSED_MAIN_PLAN = ("on-chip", 2, 2)
FUSED_REPEATS_PLAN = ("on-chip", 2, 4)
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s and float32 FLOP/s
# outside the tensor cores (132 SMs x 256 FLOP a clock at 1980 MHz)
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOP_PER_S = 67e12
# bf16 dense on the tensor cores at the same 1980 MHz: 132 SMs x 4096 FLOP
# a clock. The data sheet's 989 TFLOP/s is taken at 1830 MHz, and the
# probe's 'bf16' runs faster than that on a card at 1980 MHz.
H100_BF16_FLOP_PER_S = 132 * 4096 * 1.98e9


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def mode_tolerances(states: int, mxu: str):
    """(CLV tolerance or None, tie tolerance) of a fused kernel against its
    plain version in contraction mode `mxu`: the rows kernel's rounded
    modes (16 or more states) TOL_SPLIT_CLV / TOL_SPLIT_TIE in 'split' and
    TOL_BF16_TIE in 'bf16' (whose CLVs are held at the logL level), every
    other walk TOL_CLV / TOL_TIE."""
    if states >= 16 and mxu == "split":
        return TOL_SPLIT_CLV, TOL_SPLIT_TIE
    if states >= 16 and mxu == "bf16":
        return None, TOL_BF16_TIE
    return TOL_CLV, TOL_TIE


def match_counts(name, got_sc, want_sc, got_clv, want_clv, block, factor,
                 threshold, clv_tol=TOL_CLV, tie_tol=TOL_TIE) -> int:
    """Hold a kernel's scaler counts to its plain version's. They may
    differ only at a tie: a block whose max lies within rounding of the
    threshold, which the two versions' different FMA order puts on opposite
    sides of it. There the counts differ by one, the block's values by
    `factor` (to `clv_tol`, TOL_CLV by default), and the smaller of the two
    maxima is the threshold to `tie_tol` (TOL_TIE); `want_clv` is brought
    to the kernel's scale in place, so that the values can be compared
    after. At most MAX_TIES such entries. `block(entry)` gives the index
    into the CLVs of the block a count entry scales. Returns the number of
    ties."""
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
        check(abs(d) == 1 and rel <= clv_tol and tie <= tie_tol,
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
    unrooted); `options` (rate_scalers, asc_bias, dtype) go to
    Partition."""
    import torch
    from libpll2_tpu_torch import Partition, compute_gamma_cats
    from libpll2_tpu_torch.io import maps

    options.setdefault("dtype", torch.float32)
    part = Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                     tree.edge_count, rate_cats, tree.inner_count,
                     device=device, **options)
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
                 must_scale=False, plan=None, n_slots=None, **options):
    """Kernel vs plain traversal on one problem (`plan`, `n_slots`: as
    `compare_traversal`); returns (max relative error, max absolute
    error)."""
    part, eng = build_engine(tree, by_label, sites, device, rate_cats,
                             **options)
    return compare_traversal(name, part, eng, must_scale, plan, n_slots)


def fused_plan_of(part, eng, n_slots=None, walks=1):
    """fused_traversal.cu's plan (ops/_kernels.py:fused_plan) for an
    engine's traversal on the current device, with `n_slots` slots (the
    engine's by default) and `walks` walks a launch, raw tip rows staged
    where the engine has them (a package without the runtime-size body's
    plan takes no such argument)."""
    import inspect

    from libpll2_tpu_torch.ops import _kernels

    raw = ({"raw_tips": eng._tip_clvs() is not None}
           if hasattr(_kernels, "generic_plan") else {})
    if walks == 1 and "split" in inspect.signature(
            _kernels.device_fused_plan).parameters:
        # the 4 x 4 on-chip body's cluster, from the engine's table's
        # subtree splits (the launcher's plan)
        raw["split"] = eng.fused_splits
    return _kernels.device_fused_plan(
        part.device, part.rate_cats, part.states,
        n_slots or eng.fused_slots, part.rate_scalers, part.sites_padded,
        walks, **raw)


def plan_text(plan) -> str:
    text = (f"plan {plan.plan}, {plan.threads_per_site} thread"
            f"{'s' if plan.threads_per_site > 1 else ''} a site, "
            f"{plan.sites_per_block} sites a block, {plan.smem_bytes} bytes "
            f"of shared memory")
    if hasattr(plan, "padded_states"):   # the runtime-size body's
        text += (f", width {plan.padded_states}, {plan.warps} compute "
                 f"warp{'s' if plan.warps > 1 else ''}, a ring of "
                 f"{plan.depth}")
    if hasattr(plan, "cluster"):         # the 4 x 4 on-chip body's
        text += f", {plan.cluster} block{'s' if plan.cluster > 1 else ''} "\
                f"a cluster"
    return text


def cluster_of(plan) -> int:
    """The blocks of a fused_traversal.cu plan's thread block cluster (1
    where the package's plans have none)."""
    return getattr(plan, "cluster", 1)


def launch_text(plan, sites, walks=1) -> str:
    """A 4 x 4 plan's launch: G (blocks a cluster), SPT (sites a compute
    thread), its blocks and clusters over `walks` walks of `sites` sites."""
    g = cluster_of(plan)
    blocks = walks * -(-sites // plan.sites_per_block) * g
    return (f"G {g}, SPT {4 // plan.threads_per_site if plan.plan == 'on-chip' else 1}, "
            f"{blocks} blocks, {blocks // g} cluster{'s' if blocks > g else ''}"
            + (f" of {g}" if g > 1 else " (no cluster)"))


def cluster_walks_equal(name, codes, pm, table, kw, got, plan):
    """A 4 x 4 on-chip walk launched at every cluster size (1, 2, 4, 8,
    through the launcher's plan argument: launches that compare and are
    not counted) equals `got`, the walk at its own plan's, bit for bit.
    Returns the sizes compared."""
    import torch
    from libpll2_tpu_torch.ops import _kernels

    if kw.get("splits") is None or plan.plan != "on-chip" \
            or (kw["rates"], kw["states"]) != (4, 4):
        return ()
    base = _kernels.device_fused_plan(
        pm.device, 4, 4, kw["n_slots"], kw.get("rate_scalers", False),
        codes.shape[1], 1, kw.get("tip_clvs") is not None)
    sizes = (1, 2, 4, 8)
    for g in sizes:
        if g == plan.cluster:
            continue
        out = _kernels.launch_fused_traversal(
            codes, pm[None], table[None], kw["rates"], kw["states"],
            kw["n_slots"], kw["threshold"], kw["factor"],
            kw.get("rate_scalers", False), kw.get("tip_clvs"),
            plan=base._replace(cluster=g), splits=kw["splits"])
        torch.cuda.synchronize()
        check(all(torch.equal(a[0], b) for a, b in zip(out, got)),
              f"{name}: the walk at G {g} differs from G {plan.cluster}")
    return sizes


# a walk's cluster launches in a CUDA graph (`graph_replays`): the walks
# captured, one a P-matrix set (loglikelihood_loop(65)'s evaluations), and
# the replays checked in the main run
GRAPH_WALKS = 65
GRAPH_REPLAYS = 8


def graph_replays(codes, pm, table, kw, plan, replays=GRAPH_REPLAYS,
                  sessions=0):
    """A 4 x 4 on-chip walk at `plan` (its cluster forced through the
    launcher's plan argument: launches that are not counted) on GRAPH_WALKS
    sets of P-matrices (P scaled by 1 - i / (4 GRAPH_WALKS), so that every
    walk computes other rows), all captured in one CUDA graph, each
    launch's root rows copied out and then overwritten with -1 inside the
    graph; the graph replayed `replays` times, the copies set to -2 before
    each. A launch that did not run in a replay leaves -1 (its rows from
    the replay before were overwritten), one that ran out of turn another
    walk's rows. Returns {"replays", "walks", "launches", "bad": the launches
    whose rows differ from their eager walk's, bit for bit, "profiled": per
    profiled session (`sessions` more replays under torch.profiler, each
    after a lead replay) [our kernels in the window replay's host window,
    our kernels in the whole trace, expected in the window, in all, ours
    between the window's markers (`between_markers`; -1 without them)]}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from libpll2_tpu_torch.ops import _kernels

    walks = GRAPH_WALKS
    pms = torch.stack([pm * (1.0 - i / (4.0 * walks))
                       for i in range(walks)])

    def launch(i):
        return _kernels.launch_fused_traversal(
            codes, pms[i][None], table[None], kw["rates"], kw["states"],
            kw["n_slots"], kw["threshold"], kw["factor"],
            kw.get("rate_scalers", False), kw.get("tip_clvs"), plan=plan,
            splits=kw["splits"])

    want = [launch(i) for i in range(walks)]
    got = [tuple(torch.empty_like(o) for o in w) for w in want]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(walks):
            for g, o in zip(got[i], launch(i)):
                g.copy_(o)
                o.fill_(-1)

    def replay():
        for g in got:
            for t in g:
                t.fill_(-2)
        graph.replay()
        torch.cuda.synchronize()
        return sum(not all(torch.equal(a, b) for a, b in zip(g, w))
                   for g, w in zip(got, want))

    bad = sum(replay() for _ in range(replays))
    profiled = []
    sentinel = torch.zeros(1, device="cuda")
    for _ in range(sessions):
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm_end = time.perf_counter() + PROFILE_WARMUP_S
            while time.perf_counter() < warm_end:
                sentinel.add_(1)
                torch.cuda.synchronize()
                time.sleep(0.001)
            bad += replay()
            torch.cuda._sleep(PROFILE_MARKER_CYCLES)
            torch.cuda.synchronize()
            with record_function("pll.graph_window"):
                bad += replay()
            torch.cuda._sleep(PROFILE_MARKER_CYCLES)
            for _ in range(8):
                sentinel.add_(1)
            torch.cuda.synchronize()
        events = prof.events()
        win = [e for e in events if e.name == "pll.graph_window"
               and e.device_type == DeviceType.CPU]
        ours = [e.time_range.start for e in events
                if e.device_type == DeviceType.CUDA
                and "fused_onchip" in e.name]
        t0, t1 = ((win[0].time_range.start, win[0].time_range.end) if win
                  else (0, 0))
        marked = between_markers(events, ("fused_onchip",))
        profiled.append([sum(t0 <= t < t1 for t in ours), len(ours), walks,
                         2 * walks, -1 if marked is None else marked])
    return {"replays": replays + 2 * sessions, "walks": walks,
            "launches": walks * (replays + 2 * sessions), "bad": bad,
            "profiled": profiled}


def graph_replays_equal(name, codes, pm, table, kw, plan) -> str:
    """`graph_replays` of a cluster plan: every launch of every replay
    equal to its eager walk bit for bit. Returns the text that says so."""
    got = graph_replays(codes, pm, table, kw, plan)
    check(got["bad"] == 0, f"{name}: {got['bad']} of {got['launches']} "
          f"launches at G {plan.cluster} replayed in a CUDA graph differ "
          f"from their eager walks")
    return (f"; {got['walks']} walks at G {plan.cluster} captured in a CUDA "
            f"graph and replayed {got['replays']} times: all "
            f"{got['launches']} launches equal to their eager walks")


def root_block(part):
    """`match_counts`' block of a root-row count entry: the site's rows of
    all rates, or of the entry's rate with per-rate counts."""
    if part.rate_scalers:
        return lambda e: (e[0], slice(None), e[1])
    return lambda e: (slice(None), slice(None), e[0])


def traversal_kw(part, eng):
    """The keyword arguments of the fused traversal for an engine's
    partition: sizes, scaling, per-rate mode, raw tip rows and the table's
    subtree splits (where the package has them)."""
    kw = dict(rates=part.rate_cats, states=part.states,
              n_slots=eng.fused_slots, threshold=part.scale_threshold,
              factor=part.scale_factor, rate_scalers=part.rate_scalers,
              tip_clvs=eng._tip_clvs())
    if hasattr(eng, "fused_splits"):
        kw["splits"] = eng.fused_splits
    return kw


def compare_traversal(name, part, eng, must_scale=False, plan=None,
                      n_slots=None):
    """Kernel vs plain traversal on the inputs a fused engine hands the
    kernel, in the partition's modes (per-rate counts compared per rate;
    with `must_scale` 'rates' in per-rate mode, some rate categories must
    rescale at sites where others do not), with `n_slots` slots (more
    than the table uses force the spill plan). Below 16 states the case
    prints the plan it ran, which must be `plan` ((name, threads a site))
    where given; returns (max relative error, max absolute error)."""
    import torch
    from libpll2_tpu_torch.ops.fused import (fused_traversal,
                                             fused_traversal_reference)

    codes, pm, table = traversal_inputs(eng)
    kw = traversal_kw(part, eng)
    if n_slots is not None:
        kw["n_slots"] = n_slots
    ran = ""
    got_plan = None
    if part.states < 16:
        got_plan = fused_plan_of(part, eng, kw["n_slots"])
        ran = f"; {plan_text(got_plan)}"
        if isinstance(got_plan, tuple) and hasattr(got_plan, "cluster"):
            ran += f" ({launch_text(got_plan, part.sites_padded)})"
        if plan is not None:
            have = (got_plan.plan, got_plan.threads_per_site,
                    cluster_of(got_plan))[:len(plan)]
            check(have == tuple(plan),
                  f"{name}: ran {plan_text(got_plan)}, expected {plan}")
    got = fused_traversal(codes, pm, table, **kw)
    want = fused_traversal_reference(codes, pm, table, **kw)
    torch.cuda.synchronize()
    if got_plan is not None and hasattr(got_plan, "cluster"):
        sizes = cluster_walks_equal(name, codes, pm, table, kw, got,
                                    got_plan)
        if sizes:
            ran += f"; equal to the walk at G {', '.join(map(str, sizes))} " \
                   f"bit for bit"
        if sizes and got_plan.cluster > 1:
            ran += graph_replays_equal(name, codes, pm, table, kw, got_plan)
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
          f"{kw['n_slots']} slots"
          + (", per-rate counts" if part.rate_scalers else "")
          + (f", {raw} raw-tip children" if raw else "")
          + f": scaler counts equal (max {scaled}"
          + (f", rates differing at {mixed} sites" if part.rate_scalers
             else "") + (f"; {ties} ties" if ties else "")
          + f"), max_rel_err {rel:.3e}, max_abs_err {abs_err:.3e}{ran}",
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
    """map_aa for 20 states; otherwise the first `states` of LETTERS64,
    with '-' for every state."""
    import numpy as np
    from libpll2_tpu_torch.io import maps

    if states == 20:
        return maps.map_aa
    cm = np.zeros(256, np.uint64)
    for i, ch in enumerate(LETTERS64[:states]):
        cm[ord(ch)] = 1 << i
    cm[ord("-")] = (1 << states) - 1
    return cm


def protein_partition(tree, by_label, sites, device, states=20,
                      rate_cats=4, mixture=None, **options):
    """LG+G4 (alpha 0.9) on `device` in float32, tips installed in one
    batch; other alphabets get random GTR parameters from SEED. `mixture`
    ('lg4x') installs one matrix per category instead (rate_matrices 4);
    `options` (rate_scalers, asc_bias, dtype: float32 by default) go to
    Partition."""
    import numpy as np
    import torch
    from libpll2_tpu_torch import Partition, compute_gamma_cats
    from libpll2_tpu_torch.models import load_aa_model, load_mixture_model

    options.setdefault("dtype", torch.float32)
    part = Partition(tree.tip_count, tree.inner_count, states, sites,
                     4 if mixture else 1, tree.edge_count, rate_cats,
                     tree.inner_count, device=device, **options)
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
                      rate_cats=4, must_scale=False, plan="on-chip",
                      rounded_plan="tc-on-chip", n_slots=None, **options):
    """Rows kernel vs plain traversal on one problem in each mode
    (`compare_rows_traversal`); the kernel must run `plan` in 'highest'
    and `rounded_plan` in 'split' and 'bf16'. `n_slots` forces the slot
    count; `options` (rate_scalers) go to Partition. Returns 'split''s
    (max relative error, max absolute error)."""
    from libpll2_tpu_torch import TreeEngine

    part = protein_partition(tree, by_label, sites, device, states,
                             rate_cats, **options)
    return compare_rows_traversal(name, part, TreeEngine(part, tree),
                                  must_scale, plan, rounded_plan, n_slots)


def rows_plan_of(part, eng, mxu=None, n_slots=None):
    """The rows kernel's plan (ops/_kernels.py:rows_plan) for an engine's
    traversal on the current device in mode `mxu` (the engine's own by
    default; a package whose plan takes no mode gets none), with the
    engine's slots or `n_slots`."""
    import inspect

    from libpll2_tpu_torch.ops import _kernels

    args = (part.device, part.rate_cats, part.states,
            n_slots or eng.fused_slots, part.rate_scalers, part.sites_padded)
    if "mxu" not in inspect.signature(_kernels.device_rows_plan).parameters:
        return _kernels.device_rows_plan(*args)
    return _kernels.device_rows_plan(*args, mxu=mxu or eng.mxu)


def rows_plan_line(plan) -> str:
    """A RowsPlan as chip_smoke prints it."""
    return (f"plan {plan.plan} ({plan.sites_per_thread} site(s) a thread, "
            f"{plan.smem_bytes} bytes of shared memory, P padded to "
            f"{plan.padded_states}, {plan.rate_chunk} rates staged at once, "
            f"{plan.groups} "
            f"{'warpgroups' if plan.plan.startswith('tc') else 'warp groups'})")


def compare_rows_traversal(name, part, eng, must_scale=False,
                           plan="on-chip", rounded_plan="tc-on-chip",
                           n_slots=None):
    """`compare_rows_case` on the inputs a fused engine hands the rows
    kernel, in the partition's modes (per-rate counts, raw tips): in each
    contraction mode the kernel against the plain version of that mode on
    the same inputs, printing the plan it ran ('highest' must run `plan`,
    'split' and 'bf16' `rounded_plan`). 'highest': counts equal but at
    ties, CLVs TOL_CLV; 'split': counts equal but at ties (TOL_SPLIT_TIE),
    CLVs TOL_SPLIT_CLV; 'bf16': counts equal but at ties (TOL_BF16_TIE);
    'split' and 'bf16' also at the logL level (TOL_BF16_LOGL; not with a
    forced slot count `n_slots`, which the engine's logL does not take).
    Returns 'split''s (max relative error, max absolute error)."""
    import torch
    from libpll2_tpu_torch.engine import _fused_loglikelihood
    from libpll2_tpu_torch.ops.fused import (fused_traversal,
                                             fused_traversal_reference)

    codes, pm, table = traversal_inputs(eng)
    kw = traversal_kw(part, eng)
    if n_slots:
        kw["n_slots"] = n_slots
    raw = int((table[:-1, [1, 4]] == 2).sum())
    print(f"rows kernel vs plain [{name}]: {part.tips} taxa x {part.sites} "
          f"sites, {part.states} states, {part.rate_cats} rates, "
          f"{kw['n_slots']} slots"
          + (", per-rate counts" if part.rate_scalers else "")
          + (f", {raw} raw-tip children" if raw else ""), flush=True)
    errs = {}
    for mode, want_plan in (("highest", plan), ("split", rounded_plan),
                            ("bf16", rounded_plan)):
        clv_tol, tie_tol = mode_tolerances(part.states, mode)
        ran = rows_plan_of(part, eng, mode, n_slots)
        check(ran.plan == want_plan, f"{name}: the rows kernel runs the "
              f"{ran.plan} plan in {mode!r}, not {want_plan}")
        got = fused_traversal(codes, pm, table, mxu=mode, **kw)
        want = fused_traversal_reference(codes, pm, table, mxu=mode, **kw)
        torch.cuda.synchronize()
        ties = sum(match_counts(f"{name}, {mode}, {which}", g_sc, w_sc,
                                g_clv, w_clv, root_block(part),
                                part.scale_factor, part.scale_threshold,
                                clv_tol or 1.0, tie_tol)
                   for g_sc, w_sc, g_clv, w_clv, which in (
                       (got[2], want[2], got[0], want[0], "parent"),
                       (got[3], want[3], got[1], want[1], "child")))
        rel, abs_err = 0.0, 0.0
        for g, w in zip(got[:2], want[:2]):
            check(bool(torch.isfinite(g).all()),
                  f"{name}: non-finite CLVs in {mode!r}")
            site_max = w.abs().amax(dim=(0, 1)).clamp(min=1e-30)
            rel = max(rel, float(((g - w).abs() / site_max).max()))
            abs_err = max(abs_err, float((g - w).abs().max()))
        errs[mode] = (rel, abs_err)
        scaled = int(max(want[2].max(), want[3].max()))
        line = (f"  [{mode}] {rows_plan_line(ran)}: scaler counts equal "
                f"(max {scaled}" + (f"; {ties} ties" if ties else "")
                + f"), max_rel_err {rel:.3e}, max_abs_err {abs_err:.3e}")
        if mode != "highest" and not n_slots:
            # the kernel path against the plain path, at the logL level
            lk = []
            for trav in (fused_traversal, fused_traversal_reference):
                total = _fused_loglikelihood(*eng._args(), traversal=trav,
                                             mxu=mode, **eng._fused_kw())[0]
                lk.append(float(total))
            torch.cuda.synchronize()
            lk_rel = abs(lk[0] - lk[1]) / abs(lk[1])
            line += f", logL rel {lk_rel:.3e}"
        print(line, flush=True)
        if clv_tol is not None:
            check(rel <= clv_tol, f"{name}: {mode!r} max_rel_err {rel:.3e} "
                  f"> {clv_tol}")
        if mode != "highest" and not n_slots:
            check(math.isfinite(lk[0]) and lk_rel < TOL_BF16_LOGL,
                  f"{name}: {mode!r} logL rel err {lk_rel:.3e} >= "
                  f"{TOL_BF16_LOGL}")
        if must_scale:
            check(scaled > 0, f"{name}: scaling never triggered")
    return errs["split"]


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


def self_child_op(ops, n_tips):
    """One op that writes its own child1 in place (CLV and scaler row):
    the last op of `ops` whose child1 is an inner node, its parent rows
    redirected to that child's."""
    import copy

    op = copy.copy(next(o for o in reversed(ops)
                        if o.child1_clv_index >= n_tips))
    op.parent_clv_index = op.child1_clv_index
    op.parent_scaler_index = op.child1_scaler_index
    return op


def level_layouts(part, tables):
    """The layout each level table launches the 4x4 level kernel with, as
    (sites a lane, tiles a block) from ops/_kernels.py:level_fixed_plan,
    which the wrapper passes and the kernel's entry checks; None for the
    runtime-size variant, "unplanned" for a package without the plan
    (another checkout's)."""
    from libpll2_tpu_torch.ops import _kernels

    if (part.rate_cats, part.states) != (4, 4):
        return None
    if not hasattr(_kernels, "level_fixed_plan"):
        return "unplanned"
    sms = _kernels.device_sm_count(part.device)
    aligned = (part.clv.data_ptr() | part.scale_buffer.data_ptr()) % 16 == 0
    plans = [_kernels.level_fixed_plan(t.shape[1], part.sites_padded, sms,
                                       aligned, part.rate_scalers)
             for t in tables]
    return [(p.sites_per_lane, p.tiles_per_block) for p in plans]


def level_layout_text(layouts) -> str:
    """Each sites-a-lane layout of `level_layouts` with its levels."""
    if layouts is None:
        return "runtime-size variant"
    if layouts == "unplanned":
        return "4x4 variant without a plan"
    seen = {}
    for v, _ in layouts:
        seen[v] = seen.get(v, 0) + 1
    return ", ".join(f"{v} site{'s' if v > 1 else ''} a lane at {n} "
                     f"level{'s' if n > 1 else ''}"
                     for v, n in sorted(seen.items(), reverse=True))


def compare_level_case(name, part, ops, first=None, must_scale=False,
                       lanes=None):
    """Level kernel vs its plain version over a whole op list on the
    card, from the same buffers (after `first`, the list that must run
    before a partial one): scaler rows equal but at ties (`match_counts`),
    CLV rows within TOL_CLV of each site's max. With `lanes`, the 4x4
    variant's levels must take exactly those sites a lane (a set, or a
    list level by level; `level_layouts`). Returns (max relative error,
    max absolute error)."""
    import torch
    from libpll2_tpu_torch.ops import levels

    if first is not None:
        run_levels(part, first, levels.level_update)
    clv, sc = part.clv.clone(), part.scale_buffer.clone()
    n_levels = run_levels(part, ops, levels.level_update)
    layouts = level_layouts(part, levels.tables_to_device(
        levels.pack_pallas_levels(ops, part.tips, part.scale_buffers + 1,
                                  part.scale_buffers), part.device))
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
          f"ops in {n_levels} levels ({level_layout_text(layouts)}"
          + (f"; sites a lane, tiles a block by level: "
             f"{' '.join(f'{v}x{n}' for v, n in layouts)}"
             if isinstance(layouts, list) else "")
          + f"): scaler rows equal (max {scaled}"
          + (f"; {ties} ties" if ties else "") + f"), "
          f"max_rel_err {rel:.3e}, max_abs_err {abs_err:.3e}", flush=True)
    check(rel <= TOL_CLV, f"{name}: max_rel_err {rel:.3e} > {TOL_CLV}")
    if lanes is not None:
        ran = [v for v, _ in layouts]
        check(ran == lanes if isinstance(lanes, list) else set(ran) == lanes,
              f"{name}: the 4x4 variant ran {ran} sites a lane, expected "
              f"{lanes}")
    if must_scale:
        check(scaled > 0, f"{name}: scaling never triggered")
    return rel, abs_err


# the sites a lane of the DNA main path's 13 levels (42, 25, 15, 11, 9, 6,
# 5, 4, 3, 2, 2, 1, 1 ops at 16384 sites) on a 132-SM H100
# (ops/_kernels.py:level_fixed_plan), and a site count that is not a
# multiple of 4
DNA_LEVEL_LANES = [4] * 9 + [2, 2, 1, 1]
ODD_SITES = 16387


def level_cases(device, small, small_by, cat, cat_by, aa_by, big, big_by,
                aa_tree, aa_big_by):
    """Phase 9. Returns the largest absolute error. The runtime-size
    variant picks its threads from each level's ops x sites: the 16 x 1000
    cases run one site a thread with a site's rates over 4 threads, the
    protein main path's levels (128 x 8192, 40 down to 1 ops) also two
    sites a thread and rates over 2 threads, so that tree is held here too,
    level by level. The 4x4 variant's cases name the sites a lane their
    levels must take."""
    from libpll2_tpu_torch.trees import random_alignment

    max_abs = 0.0

    def letters(states):
        headers, seqs = random_alignment(16, 1000, seed=3,
                                         alphabet=LETTERS32[:states] + "-")
        return dict(zip(headers, seqs))

    def case(name, part, tree, **kw):
        nonlocal max_abs
        ops, _, _ = traversal_ops(part, tree)
        if kw.pop("no_scaler", False):
            for op in ops[::3]:
                op.parent_scaler_index = -1
        if kw.pop("partial", False):
            kw["first"], ops = ops, ops[len(ops) // 2:]
        if kw.pop("self_child", False):
            kw["first"], ops = ops, [self_child_op(ops, part.tips)]
        max_abs = max(max_abs, compare_level_case(name, part, ops, **kw)[1])

    case("ragged", dna_partition(small, small_by, 1000, device), small,
         lanes={1})
    case("3 rates", dna_partition(small, small_by, 1000, device, 3), small)
    case("caterpillar", dna_partition(cat, cat_by, 1000, device), cat,
         must_scale=True, lanes={1})
    for states, by in ((20, aa_by), (32, letters(32)), (5, letters(5)),
                       (2, letters(2))):
        case(f"{states} states", protein_partition(small, by, 1000, device,
                                                   states), small)
    case("ops without a scaler", dna_partition(small, small_by, 1000,
                                               device), small,
         no_scaler=True)
    case("partial op list", dna_partition(small, small_by, 1000, device),
         small, partial=True)
    case("an op that writes its own child, 20 states",
         protein_partition(small, aa_by, 1000, device), small,
         self_child=True)
    case("per-rate, 16 rates x 32 states (P in chunks)",
         protein_partition(small, letters(32), 1000, device, 32,
                           rate_cats=16, rate_scalers=True), small)
    # the 4x4 variant at full width, each level on the layout that
    # level_fixed_plan gives it on a 132-SM H100: the DNA main path's 13
    # levels of 42 down to 1 ops (4 sites a lane down to 3 ops, 2 at 2, 1
    # at 1) per site and per rate, its alignment cut to 16387 sites (the
    # scalar layout, a ragged last tile) and the caterpillar at 16384
    # sites (78 levels of one op: one site a lane)
    case("main-path shape", dna_partition(big, big_by, N_SITES, device),
         big, lanes=DNA_LEVEL_LANES)
    case("main-path shape, per-rate counts",
         dna_partition(big, big_by, N_SITES, device, rate_scalers=True),
         big, lanes=DNA_LEVEL_LANES)
    headers, seqs = random_alignment(N_TAXA, ODD_SITES, seed=SEED)
    case(f"{ODD_SITES} sites (the scalar layout)",
         dna_partition(big, dict(zip(headers, seqs)), ODD_SITES, device),
         big, lanes={1})
    headers, seqs = random_alignment(80, N_SITES, seed=3)
    case(f"caterpillar, 80 x {N_SITES}",
         dna_partition(cat, dict(zip(headers, seqs)), N_SITES, device), cat,
         must_scale=True, lanes={1})
    case("protein main-path shape, LG+G4",
         protein_partition(aa_tree, aa_big_by, AA_SITES, device), aa_tree)
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
    other than 4 states, equal rates and frequencies (20: the amino acids,
    else the first `states` of LETTERS32)."""
    from libpll2_tpu_torch.utils import simulate_alignment

    alphabet = None
    if states != 4:
        freqs = [1 / states] * states
        subst = [1.0] * (states * (states - 1) // 2)
        alphabet = None if states == 20 else LETTERS32[:states]
    headers, seqs = simulate_alignment(tree, sites, freqs, subst,
                                       alpha=alpha, seed=seed,
                                       alphabet=alphabet)
    return dict(zip(headers, seqs))


def repeats_partition(tree, by_label, sites, device, states=4, rate_cats=4,
                      repeats=True, model=(FREQS_24, SUBST_24), alpha=0.8,
                      rate_matrices=1, **options):
    """A float32 partition on `device` with site repeats (or dense, for the
    references), tips installed in one batch; 20 states under LG, DNA under
    `model` (a second matrix from SEED with `rate_matrices` 2), other
    alphabets (`charmap`) under random GTR parameters from SEED; `options`
    (rate_scalers, asc_bias, dtype) go to Partition."""
    import numpy as np
    import torch
    from libpll2_tpu_torch import Partition, compute_gamma_cats
    from libpll2_tpu_torch.io import maps
    from libpll2_tpu_torch.models import load_aa_model

    options.setdefault("dtype", torch.float32)
    part = Partition(tree.tip_count, tree.inner_count, states, sites,
                     rate_matrices, tree.edge_count, rate_cats,
                     tree.inner_count, device=device, site_repeats=repeats,
                     **options)
    tips = list(tree.tips())
    part.set_tip_states_batch(maps.map_nt if states == 4
                              else charmap(states),
                              [by_label[t.label] for t in tips],
                              [t.clv_index for t in tips])
    if states == 20:
        load_aa_model(part, "lg")
    elif states != 4:
        rng = np.random.default_rng(SEED)
        part.set_frequencies(0, rng.dirichlet(np.ones(states) * 10))
        part.set_subst_params(0, rng.uniform(0.5, 2.0,
                                             states * (states - 1) // 2))
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


def conserved_protein(aa_tree, aa_by, states=20):
    """tools/benchmarks.py:38-66 with conserved=True at 128 x 8192: the
    protein problem's columns drawn with repetition from its first quarter
    (seed 11 + 100). Other `states`: the same draw from an alignment of
    that alphabet simulated on the protein tree (seed 11 + states). Returns
    (by_label, partition maker; its `options` go to repeats_partition)."""
    import numpy as np

    if states != 20:
        aa_by = simulated(aa_tree, AA_SITES, AA_SEED + states, states=states,
                          alpha=0.9)
    rng = np.random.default_rng(AA_SEED + 100)
    src = rng.integers(0, AA_SITES // 4, size=AA_SITES)
    by = {k: "".join(np.asarray(list(v))[src]) for k, v in aa_by.items()}

    def make(device, repeats=True, **options):
        return repeats_partition(aa_tree, by, AA_SITES, device,
                                 states=states, repeats=repeats, alpha=0.9,
                                 **options)
    return by, make


def run_pool(part, ops, level=None):
    """`ops` through ops/pool.py on `part`'s pooled buffers: the whole plan
    through update_partials_pool, by default on the plan's kernels (the
    4x4 traversal kernel in one launch), or a level at a time through a
    given `level` (the wrapper, or its plain version); returns the number
    of levels."""
    from libpll2_tpu_torch.ops import pool

    plan = part._pool_plan(ops, True)
    # another checkout's update_partials_pool may take no level of None
    kw = {} if level is None else {"level": level}
    pool.update_partials_pool(part.clv_flat, part.sc_flat, part.pmatrix,
                              plan, part.scale_threshold, part.scale_factor,
                              **kw)
    return len(plan.tables)


def pool_traversal_of(plan):
    """The plan's 4x4 traversal (one launch a traversal), or None: the
    runtime-size variant, or a package whose 4x4 kernel runs a level a
    launch (another checkout's)."""
    return getattr(plan, "traversal", None)


def pool_launches(plan) -> int:
    """The pool-kernel launches of one traversal of `plan` through
    update_partials_pool."""
    return 1 if pool_traversal_of(plan) is not None else len(plan.tables)


def compare_pool_case(name, part, ops, first=None, must_scale=False,
                      layouts=None, level=None, p_sets=None):
    """Pool kernel vs its plain version over a whole op list on the card,
    from the same buffers (after `first`, the list that must run before a
    partial one): scaler regions equal but at ties (`match_counts`; the
    trash region aside: ops without a scaler buffer write it at once), the
    zero region zero, class columns within TOL_CLV of each column's max.
    The runtime-size variant's levels must run with the threads a column
    in `layouts` (a set, each at least once; None: the 4x4 traversal
    kernel, one launch a traversal). `level` "levels" runs each level
    through the wrapper on its own (the 4x4 kernel one level a launch).
    `p_sets` (two functions that set the P-matrices) runs two traversals
    back to back, the first after p_sets[0], the second after p_sets[1].
    Returns (max relative error, max absolute error)."""
    import torch
    from libpll2_tpu_torch.ops import pool

    if first is not None:
        run_pool(part, first)
    plan = part._pool_plan(ops, True)       # lays the pool out, computes none
    clv, sc = part.clv_flat.clone(), part.sc_flat.clone()
    runs = p_sets or (lambda: None,)

    def run(how):
        n = 0
        for set_p in runs:
            set_p()
            n += run_pool(part, ops, how)
        return n

    before = pool.pool_update.launches
    n_levels = run(pool.pool_update if level == "levels"
                   else None) // len(runs)
    launched = pool.pool_update.launches - before
    got_clv, got_sc = part.clv_flat.clone(), part.sc_flat.clone()
    part.clv_flat.copy_(clv)
    part.sc_flat.copy_(sc)
    run(pool.pool_update_reference)
    torch.cuda.synchronize()
    want_launches = len(runs) * (n_levels if level == "levels"
                                 else pool_launches(plan))
    check(launched == want_launches, f"{name}: {launched} pool-kernel "
          f"launches, expected {want_launches}")
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
    widest = max(int(t[8].max()) for t in plan.tables)
    ran = pool_layouts(part, plan)
    print(f"pool kernel vs plain [{name}]: {part.tips} taxa x {part.sites} "
          f"sites, {part.states} states, {part.rate_cats} rates"
          + (" (per-rate counts)" if part.rate_scalers else "")
          + f", {len(ops)} "
          f"ops in {n_levels} levels (widest {widest}), pool "
          f"{lay.total} columns, {layout_text(ran)}, {launched} "
          f"launch{'es' if launched > 1 else ''}: scaler regions equal "
          f"(max {scaled}" + (f"; {ties} ties" if ties else "") + "), "
          f"max_rel_err {rel:.3e}, max_abs_err {abs_err:.3e}", flush=True)
    check(rel <= TOL_CLV, f"{name}: max_rel_err {rel:.3e} > {TOL_CLV}")
    got = None if not isinstance(ran, list) else {
        lay.rate_threads for lay in ran}
    check(got == layouts, f"{name}: ran {layout_text(ran)}, expected "
          + ("the 4x4 traversal kernel" if layouts is None else
             f"{sorted(layouts)} threads a column"))
    if must_scale:
        check(scaled > 0, f"{name}: scaling never triggered")
    return rel, abs_err


def pool_cases(device, big, big_by, flagship, aa_make):
    """Phase 12. The 4x4 cases run the traversal kernel, one launch a
    traversal, and also a serial-fallback list with write-after-read
    hazards, two traversals back to back, each level a launch of its own
    and a grid of more blocks than tickets. Each runtime-size case names
    the threads a column its levels launch with (ops/_kernels.py:
    pool_plan, read from the plan's launches): a column's rates split over
    the largest power of two up to 4 that the rates fill (1 thread at 1
    rate, 2 at 3 rates, 4 at 4); the
    simulated 128 x 16384 protein has levels up to 196,608 columns wide,
    its blocks taking runs of tiles; the 64 x 4096 random DNA holds a
    level whose ops differ 16x in width. Returns the largest absolute
    error."""
    import copy

    from libpll2_tpu_torch.trees import (parse_newick, random_alignment,
                                         random_utree)

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
    by_cat = simulated(cat, 300, 13, freqs=FREQS_24, subst=SUBST_24)
    case("caterpillar 150 x 300", repeats_partition(cat, by_cat, 300,
                                                    device),
         cat, must_scale=True)
    case("3 rates", repeats_partition(t24, by24, 600, device, rate_cats=3),
         t24, layouts={2})
    case("1 rate", repeats_partition(t24, by24, 600, device, rate_cats=1),
         t24, layouts={1})
    case("3 rates, per-rate, caterpillar 150 x 300", repeats_partition(
        cat, by_cat, 300, device, rate_cats=3, rate_scalers=True), cat,
        must_scale=True, layouts={2})
    aa = conserve(random_utree([f"t{i}" for i in range(24)], seed=13), 0.3,
                  0.02, clamp=True)
    by_aa = simulated(aa, 640, 13, states=20, alpha=0.9)
    case("20 states, conserved", repeats_partition(
        aa, by_aa, 640, device, states=20, alpha=0.9), aa, layouts={4})
    case("20 states, conserved, per-rate", repeats_partition(
        aa, by_aa, 640, device, states=20, alpha=0.9, rate_scalers=True),
        aa, layouts={4})
    for states in (5, 17, 32):
        case(f"{states} states, conserved", repeats_partition(
            aa, simulated(aa, 640, 13, states=states, alpha=0.9), 640,
            device, states=states, alpha=0.9), aa, layouts={4})
    case("partial op list", repeats_partition(t24, by24, 600, device), t24,
         partial=True)
    case("ops without a scaler", repeats_partition(t24, by24, 600, device),
         t24, no_scaler=True)
    case("128 x 16384 random columns (identity ops)", repeats_partition(
        big, big_by, N_SITES, device), big)
    t64 = random_utree([f"t{i}" for i in range(64)], seed=11)
    headers, seqs = random_alignment(64, 4096, seed=11)
    case("64 x 4096 random columns, 3 rates (a level's ops 16x apart)",
         repeats_partition(t64, dict(zip(headers, seqs)), 4096, device,
                           rate_cats=3), t64, layouts={2})
    tree, _, make = flagship
    case(f"{REP_TAXA} x {REP_SITES} conserved", make(device), tree)
    # the 4x4 traversal kernel: a serial-fallback list, the traversal and
    # then the first half of its postorder again with each op's P-matrices
    # swapped, which rewrites nodes whose parents the traversal read and
    # that half leaves (write after read and after write, which the final
    # pools show); two traversals back to back under different
    # P-matrices (the counters zeroed before each); each level a launch
    # of its own; and a grid past the card's resident blocks
    part = make(device)
    ops, br, pidx = traversal_ops(part, tree)
    again = [copy.copy(o) for o in ops[:len(ops) // 2]]
    for o in again:
        o.child1_matrix_index, o.child2_matrix_index = \
            o.child2_matrix_index, o.child1_matrix_index
    max_abs = max(max_abs, compare_pool_case(
        "a serial-fallback list: the traversal, then its first half again "
        "with swapped P-matrices", part, ops + again)[1])
    br2 = [b * 1.7 for b in br]
    params = [0] * part.rate_cats
    max_abs = max(max_abs, compare_pool_case(
        "two traversals back to back", part, ops, p_sets=(
            lambda: part.update_prob_matrices(params, pidx, br),
            lambda: part.update_prob_matrices(params, pidx, br2)))[1])
    part.update_prob_matrices(params, pidx, br)
    max_abs = max(max_abs, compare_pool_case(
        "each level a launch", part, ops, level="levels")[1])
    part = make(device, rate_scalers=True)
    ops = traversal_ops(part, tree)[0]
    plan = part._pool_plan(ops, True)
    trav = plan.traversal
    big_grid = trav.plan._replace(blocks=4 * trav.plan.tiles)
    part._repeat_schedule = plan._replace(traversal=trav._replace(
        plan=big_grid))
    max_abs = max(max_abs, compare_pool_case(
        f"per-rate, a grid of {big_grid.blocks} blocks for "
        f"{big_grid.tiles} tickets", part, ops)[1])
    aa_tree, make_aa = aa_make
    case(f"protein {AA_TAXA} x {AA_SITES} conserved", make_aa(device),
         aa_tree, layouts={4})
    case(f"protein {AA_TAXA} x {2 * AA_SITES} simulated (wide levels)",
         repeats_partition(aa_tree, simulated(aa_tree, 2 * AA_SITES,
                                              AA_SEED, states=20,
                                              alpha=0.9),
                           2 * AA_SITES, device, states=20, alpha=0.9),
         aa_tree, layouts={4})
    return max_abs


def pool_bound(part, levels, trials=1):
    """One traversal through the pool kernel, from the actual class counts,
    each column once (as `level_bound` counts rows): the class columns and
    counts it reads and does not write (the tips' columns; scaler counts of
    nodes outside the list) read once, every parent's class columns and
    counts written once (4 * R * s and 4 bytes a column), the two gather
    int32s of every parent column, P and the op tables read once; against
    4 * R * s^2 + R * s FLOP a parent column. The trial form over `trials`
    trials reads what every trial shares (the columns and counts read and
    not written, the gather int32s, the op tables) once, and writes each
    trial's parent columns and counts, reads its P and does its FLOP once
    a trial."""
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
                + trials * sum(written.values())) * 4 * R * s
               + (sum(sc_r.values()) + trials * sum(sc_w.values()))
               * 4 * sc_rows
               + cols * 2 * 4 + len(ops) * pool.POOL_ROWS * 8
               + trials * part.prob_matrices * R * s * s * 4)
    return bound_ms(n_bytes, trials * cols * (4 * R * s * s + R * s))


def pool_level_bounds(part, levels):
    """Each level of a traversal through the pool kernel on its own (us),
    counted as `pool_bound` counts the traversal: every child's distinct
    class columns and counts read once (its class count), every parent's
    class columns and counts written once, the two gather int32s of every
    parent column, the level's P-matrices and op table read once; against
    4 * R * s^2 + R * s FLOP a parent column. A level reads the columns an
    earlier level wrote, so the levels' bounds add up to more than
    `pool_bound`."""
    from libpll2_tpu_torch.ops import pool

    R, s = part.rate_cats, part.states
    sc_rows = R if part.rate_scalers else 1
    classes = part.repeats.classes
    out = []
    for lv in levels:
        ops = [(op, gl.size) for _, op, gl, _ in lv]
        cols = sum(n for _, n in ops)
        kids = {c: k for op, _ in ops
                for c, k in ((op.child1_clv_index, op.child1_scaler_index),
                             (op.child2_clv_index, op.child2_scaler_index))}
        mats = {m for op, _ in ops
                for m in (op.child1_matrix_index, op.child2_matrix_index)}
        n_bytes = ((sum(classes(c) for c in kids) + cols) * 4 * R * s
                   + (sum(classes(c) for c, k in kids.items() if k >= 0)
                      + sum(n for op, n in ops
                            if op.parent_scaler_index >= 0)) * 4 * sc_rows
                   + cols * 2 * 4 + len(ops) * pool.POOL_ROWS * 8
                   + len(mats) * R * s * s * 4)
        out.append(1e3 * bound_ms(n_bytes,
                                  cols * (4 * R * s * s + R * s))[0])
    return out


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
          f"{sched_ms:.1f} ms, then its device plan (pack_pool_levels and "
          f"plan_to_device) {plan_build_ms(part, ops):.2f} ms (median of "
          f"5)", flush=True)

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
    # the 4x4 traversal kernel launches once a traversal, the runtime-size
    # variant once a level
    per = pool_launches(eng._ops)
    expected = 7 * per + (1 if per == 1 else n_partial)
    fused_launches = (fused.fused_traversal.launches
                      + fused.fused_traversal_rows.launches)
    print(f"  pool-kernel launches: {launches} (2 step-by-step traversals + "
          f"1 partial of {len(partial)} ops in {n_partial} levels + 4 "
          f"engine evaluations + 1 with edge_params, "
          f"{'one launch a traversal' if per == 1 else 'a level a launch'}"
          f"; expected {expected}); fused {fused_launches}, level "
          f"{lv.level_update.launches}", flush=True)
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
                                eng_rdf, plan=FUSED_REPEATS_PLAN)[1]

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
    check(launches == 2 * pool_launches(eng._ops),
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
              factor=part.scale_factor, splits=eng_rdf.fused_splits)
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
          f"in {pool_launches(plan)} launch(es) {kernel:.4f} ms "
          f"({cols / kernel / 1e6:.3f} G class-column updates/s; bound "
          f"{bound:.4f} ms by {by}), plain {plain:.4f} ms; "
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


def pool_layouts(part, plan):
    """The layout each level of `plan` launches the runtime-size pool
    kernel with (the plan's launches, which the wrapper passes to the
    kernel); for the 4x4 size the traversal kernel's plan, or "levels" for
    a package that runs it a level a launch (another checkout's);
    "unplanned" for a package without launches."""
    if (part.rate_cats, part.states) == (4, 4):
        trav = pool_traversal_of(plan)
        return "levels" if trav is None else trav.plan
    if not hasattr(plan, "launches"):
        return "unplanned"
    return list(plan.launches)


def layout_text(layouts) -> str:
    """Each thread layout of `pool_layouts` with its number of levels."""
    if layouts == "levels":
        return "4x4 variant, a level a launch"
    if layouts == "unplanned":
        return "runtime-size variant without a plan"
    if not isinstance(layouts, list):
        return (f"4x4 traversal kernel: {layouts.tiles} tickets, "
                f"{layouts.blocks} blocks")
    seen = {}
    for lay in layouts:
        seen[lay.rate_threads] = seen.get(lay.rate_threads, 0) + 1
    return ", ".join(f"{ty} thread{'s' if ty > 1 else ''} a column at {n} "
                     f"level{'s' if n > 1 else ''}"
                     for ty, n in sorted(seen.items()))


def pool_device(label, part, ops, gpu):
    """Phase 14 (and `--pool-only`): the pool kernel's device time over one
    traversal of `ops` on `part` (P-matrices set), from
    `launches_device_us`: the 4x4 traversal kernel as one launch, beside
    the traversal's bound and the sum of its levels' own bounds
    (`pool_level_bounds`); a kernel launched a level at a time level by
    level, beside each level's computed and class columns, its threads a
    column (the warps its rates are split over) and its own bound.
    Returns (device ms, [us a launch], [bound us a level], [(computed,
    class) columns a level], [threads a column a level, or None])."""
    import copy

    from libpll2_tpu_torch.ops import pool

    plan = part._pool_plan(ops, True)
    args = (part.clv_flat, part.sc_flat, part.pmatrix, plan,
            part.scale_threshold, part.scale_factor)
    per = launches_device_us(lambda: pool.update_partials_pool(*args),
                             "pool_", pool_launches(plan))
    _, lv = pool.schedule_pool_levels(copy.deepcopy(part.repeats), ops,
                                      part.tips, part.sites_padded,
                                      part.scale_buffers)
    R, s = part.rate_cats, part.states
    cols = [(sum(int(w) for w, *_ in level),
             sum(int(g.size) for _, _, g, _ in level)) for level in lv]
    bounds = pool_level_bounds(part, lv)
    layouts = pool_layouts(part, plan)
    lays = ([lay.rate_threads for lay in layouts]
            if isinstance(layouts, list) else [None] * len(lv))
    device = sum(per) * 1e-3
    bound = pool_bound(part, lv)
    head = (f"pool kernel device time, {label}, {part.tips} x {part.sites}, "
            f"{s} states x {R} rates"
            f"{' (per-rate)' if part.rate_scalers else ''} (torch.profiler, "
            f"median of 5 traversals per launch; {gpu}): "
            f"{device * 1e3:.1f} us over {len(lv)} levels in {len(per)} "
            f"launch{'es' if len(per) > 1 else ''} "
            f"({device / bound[0]:.2f}x the bound {bound[0]:.4f} ms by "
            f"{bound[1]}; {device * 1e3 / sum(bounds):.2f}x the levels' own "
            f"bounds, {sum(bounds):.2f} us summed); {layout_text(layouts)}")
    if len(per) == 1 and len(lv) > 1:
        print(f"{head}; levels (ops, computed/class columns: their own "
              f"bound in us) "
              + ", ".join(f"({len(level)}, {c}/{n}: {b:.2f})"
                          for level, (c, n), b in zip(lv, cols, bounds)),
              flush=True)
    else:
        print(f"{head}; by level (ops, computed/class columns, threads a "
              f"column: us, its bound in us) "
              + ", ".join(f"({len(level)}, {c}/{n}, {t or '-'}: {u:.1f} / "
                          f"{b:.1f})"
                          for level, (c, n), t, u, b in zip(lv, cols, lays,
                                                            per, bounds)),
              flush=True)
    return device, per, bounds, cols, lays


def plan_build_ms(part, ops, reps=5) -> float:
    """The host's time (ms, median of `reps`) to build the device plan of
    `ops` on `part` from its scheduled levels: ops/pool.py's
    pack_pool_levels and plan_to_device (at 4x4 also the wait lists, the
    tickets and their copy), synchronised."""
    import copy

    import torch
    from libpll2_tpu_torch.ops import pool

    layout, levels = pool.schedule_pool_levels(
        copy.deepcopy(part.repeats), ops, part.tips, part.sites_padded,
        part.scale_buffers)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pool.plan_to_device(*pool.pack_pool_levels(layout, levels),
                            part.device, part.rate_cats, part.states)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def pool_host_ms(part, ops, gpu) -> float:
    """Phase 14: the host's time to enqueue one pool traversal of `ops` on
    `part` (`host_ms`, least of 100), printed beside its median."""
    from libpll2_tpu_torch.ops import pool

    plan = part._pool_plan(ops, True)
    args = (part.clv_flat, part.sc_flat, part.pmatrix, plan,
            part.scale_threshold, part.scale_factor)
    least, median = host_ms(lambda: pool.update_partials_pool(*args))
    print(f"pool kernel host enqueue, {part.tips} x {part.sites} "
          f"({pool_launches(plan)} launch(es); {gpu}): {least:.4f} ms "
          f"least of 100, {median:.4f} ms median", flush=True)
    return least


def protein_pool_times(device, aa_tree, make_aa, gpu):
    """Phase 14: the pool kernel's runtime-size variant over one traversal
    of the conserved 128 x 8192 LG+G4 protein (after one step-by-step
    traversal sets its P-matrices): medians (ms) of the kernel and of its
    plain version, its device time level by level (`pool_device`) and its
    bound from the class counts. Returns (kernel, plain, (bound, by),
    `pool_device`'s tuple)."""
    import copy

    from libpll2_tpu_torch.ops import pool

    part = make_aa(device)
    ops = step_by_step(part, aa_tree, derivatives=False)[0]
    plan = part._pool_plan(ops, True)
    args = (part.clv_flat, part.sc_flat, part.pmatrix, plan,
            part.scale_threshold, part.scale_factor)
    kernel = median_ms(lambda: pool.update_partials_pool(*args))
    plain = median_ms(lambda: pool.update_partials_pool(
        *args, level=pool.pool_update_reference))
    dev = pool_device("conserved protein", part, ops, gpu)
    _, lv = pool.schedule_pool_levels(copy.deepcopy(part.repeats), ops,
                                      part.tips, part.sites_padded,
                                      part.scale_buffers)
    bound = pool_bound(part, lv)
    print(f"pool kernel, runtime-size variant, protein {part.tips} x "
          f"{part.sites} conserved (median of {REPS}, CUDA events; {gpu}): "
          f"kernel over {len(plan.tables)} levels {kernel:.4f} ms, device "
          f"{dev[0] * 1e3:.1f} us (bound {bound[0]:.4f} ms by {bound[1]}), "
          f"plain {plain:.4f} ms", flush=True)
    return kernel, plain, bound, dev


def pool_only(device, gpu) -> dict:
    """`--pool-only`: the pool kernel's call time (ms, CUDA events), the
    host's time to enqueue it (`host_ms`) and its device time
    (`pool_device`) over one traversal, of the package that was imported,
    which may be another checkout's: the conserved 128 x 8192 LG+G4
    protein, per site and per rate; the 246 x 4465 DNA problem with 3
    rates (the runtime-size variant at 4 states); the conserved 128 x 8192
    problem at 5, 17 and 32 states; and the 246 x 4465 DNA problem at 4x4,
    per site and per rate, with its 'pool-pallas' loglikelihood() and one
    step-by-step traversal (update_partials and the edge logL), and the
    150-taxon caterpillar x 300 (148 levels of one op: the chain of
    dependent levels alone), each 4x4 case first held against the plain
    version (`compare_pool_case`); at 246 x 4465 4x4 per site also the
    time to build the device plan (`plan_build_ms`). Under "trials", the
    pool kernel's trial forms (`trial_forms_only`)."""
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.ops import pool
    from libpll2_tpu_torch.trees import parse_newick

    aa_tree, aa_by = protein_alignment()
    rep_tree, _, rep_make = flagship_repeats()
    make_aa = conserved_protein(aa_tree, aa_by)[1]
    cases = {"protein": lambda: (make_aa(device), aa_tree),
             "protein_per_rate": lambda: (make_aa(device, rate_scalers=True),
                                          aa_tree),
             "dna_3_rates": lambda: (rep_make(device, rate_cats=3),
                                     rep_tree)}
    for states in (5, 17, 32):
        cases[f"states_{states}"] = (
            lambda st=states: (conserved_protein(aa_tree, aa_by,
                                                 st)[1](device), aa_tree))
    cases["dna_4x4"] = lambda: (rep_make(device), rep_tree)
    cases["dna_4x4_per_rate"] = lambda: (rep_make(device, rate_scalers=True),
                                         rep_tree)
    cat = parse_newick(caterpillar_newick(150))
    cases["dna_4x4_caterpillar"] = lambda: (repeats_partition(
        cat, simulated(cat, 300, 13, freqs=FREQS_24, subst=SUBST_24), 300,
        device), cat)
    out = {}
    for key, build in cases.items():
        part, tree = build()
        ops = step_by_step(part, tree, derivatives=False)[0]
        if key.startswith("dna_4x4"):
            compare_pool_case(key, part, ops)
        plan = part._pool_plan(ops, True)
        args = (part.clv_flat, part.sc_flat, part.pmatrix, plan,
                part.scale_threshold, part.scale_factor)
        ms = median_ms(lambda: pool.update_partials_pool(*args))
        host = host_ms(lambda: pool.update_partials_pool(*args))
        dev, per, bounds, cols, lays = pool_device(key, part, ops, gpu)
        out[key] = {"ms": ms, "host_ms": host, "device_ms": dev,
                    "launch_device_us": per, "level_bound_us": bounds,
                    "level_columns": cols, "level_threads_per_column": lays}
        extra = ""
        if key in ("dna_4x4", "dna_4x4_per_rate"):
            r = tree.vroot
            edge = (r.clv_index, r.scaler_index, r.back.clv_index,
                    r.back.scaler_index, r.pmatrix_index,
                    [0] * part.rate_cats)

            def step():
                part.update_partials(ops)
                part.compute_edge_loglikelihood(*edge)

            eng = TreeEngine(part, tree, pallas="pool")
            check(eng.execution_path == "pool-pallas",
                  f"{key}: execution_path is {eng.execution_path!r}")
            out[key].update(interleaved_ms({"loglikelihood_ms":
                                            eng.loglikelihood,
                                            "step_ms": step}))
            extra = (f"; 'pool-pallas' loglikelihood() "
                     f"{out[key]['loglikelihood_ms']:.4f} ms, step-by-step "
                     f"traversal {out[key]['step_ms']:.4f} ms (in turns)")
        if key == "dna_4x4":
            out[key]["plan_ms"] = plan_build_ms(part, ops)
            extra += (f"; device plan built in {out[key]['plan_ms']:.2f} "
                      f"ms (median of 5)")
        print(f"  pool kernel call, {key}: {ms:.4f} ms; host enqueue "
              f"{host[0]:.4f} ms least, {host[1]:.4f} median{extra}",
              flush=True)
        del part, plan, args
    out["trials"] = trial_forms_only(device, gpu,
                                     ("repeats", "conserved_protein"))
    return out


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


# the rows kernel's passes over its products on the tensor cores in each
# rounded mode: one bf16 pass in 'bf16', three ('split': Ph ch + Ph cl + Pl
# ch); 'highest' (and every mode below 16 states) runs float32 FMAs
ROWS_TC_PASSES = {"bf16": 1, "split": 3}


def rows_bound(n_bytes: int, flops: int, states: int, mxu: str,
               plan: str = "tc-on-chip"):
    """`bound_ms` of a fused walk in contraction mode `mxu`: its useful
    FLOP at the float32 CUDA-core peak, or, on the rows kernel's tensor
    cores (16 or more states, 'bf16' and 'split'), its passes over them at
    the bf16 peak (as `probe_bounds` counts the probe's); the spill plan's
    'split' runs two float32 FMAs a term on the CUDA cores."""
    if states >= 16 and mxu in ROWS_TC_PASSES:
        if plan == "spill":
            return bound_ms(n_bytes, (2 if mxu == "split" else 1) * flops)
        return bound_ms(n_bytes, ROWS_TC_PASSES[mxu] * flops,
                        H100_BF16_FLOP_PER_S)
    return bound_ms(n_bytes, flops)


def fused_bound(eng, part, mxu="highest", plan="tc-on-chip"):
    """One fused traversal: the state-code tips' codes (4 bytes a site) and
    the raw tips' rows (4 s bytes a site), P and the op table read once,
    the root edge's two CLVs and counts (one per rate with per-rate
    scalers) written once; its operations at `rows_bound`'s peak for the
    contraction mode `mxu` on `plan`."""
    n_ops = eng.table.shape[0] - 1
    S, R, s = part.sites_padded, part.rate_cats, part.states
    return rows_bound(fused_bytes(eng, part), traversal_flops(n_ops, S, R, s),
                      s, mxu, plan)


def fused_bytes(eng, part) -> int:
    """`fused_bound`'s bytes: one traversal's inputs read once, its root
    rows written once."""
    S, R, s = part.sites_padded, part.rate_cats, part.states
    n_raw = int(part._tips_clv_set.sum())
    sc_rows = R if part.rate_scalers else 1
    return ((part.tips - n_raw) * S * 4 + n_raw * s * S * 4
            + part.prob_matrices * R * s * s * 4 + eng.table.numel() * 4
            + 2 * R * s * S * 4 + 2 * sc_rows * S * 4)


def level_bound(part, ops, trials=1):
    """One traversal through the level kernel: every CLV and scaler row it
    reads and does not write (the tips) read once, every row it writes
    written once, P and the level tables read once. The trial form over
    `trials` trials reads what every trial shares (the rows read and not
    written, the tables) once, and writes each trial's rows and scaler
    rows, reads its P and does its FLOP once a trial."""
    written = {o.parent_clv_index for o in ops}
    read = {c for o in ops
            for c in (o.child1_clv_index, o.child2_clv_index)} - written
    sc_w = {o.parent_scaler_index for o in ops if o.parent_scaler_index >= 0}
    sc_r = {x for o in ops for x in (o.child1_scaler_index,
                                     o.child2_scaler_index) if x >= 0} - sc_w
    S, R, s = part.sites_padded, part.rate_cats, part.states
    sc_rows = R if part.rate_scalers else 1
    n_bytes = ((len(read) + trials * len(written)) * R * s * S * 4
               + (len(sc_r) + trials * len(sc_w)) * sc_rows * S * 4
               + trials * part.prob_matrices * R * s * s * 4
               + 9 * len(ops) * 4)
    return bound_ms(n_bytes, trials * traversal_flops(len(ops), S, R, s))


def launches_device_us(fn, name, n_launches, reps=5):
    """Device time (us) of each of the `n_launches` kernels whose names
    hold `name` in a call of `fn`, in launch order, from torch.profiler:
    the last `reps` of `reps + 1` calls in one profiled session, the
    median per launch. The session opens with PROFILE_WARMUP_S of small
    sentinel kernels and closes with eight, and its first call is a lead
    call that is not read (the profiler can drop the events of a session's
    first milliseconds, a lead call's kernels with them, or its last
    events, and now and then records no device event at all); one whose
    trace still lacks some of the last `reps` calls' kernels is run again,
    up to PROFILE_SESSIONS sessions in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    sentinel = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_SESSIONS):
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm_end = time.perf_counter() + PROFILE_WARMUP_S
            while time.perf_counter() < warm_end:
                sentinel.add_(1)
                torch.cuda.synchronize()
                time.sleep(0.001)
            for _ in range(reps + 1):
                fn()
                torch.cuda.synchronize()
            for _ in range(8):
                sentinel.add_(1)
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kernels = sorted((e for e in device if name in e.name),
                         key=lambda e: e.time_range.start)
        if len(kernels) >= reps * n_launches:
            kernels = kernels[len(kernels) - reps * n_launches:]
            break
        print(f"  (the profiler recorded {len(kernels)} of the last "
              f"{reps * n_launches} {name} kernels and {len(device)} device "
              f"events in all; profiled again)", flush=True)
    check(len(kernels) == reps * n_launches, f"the profiler missed {name} "
          f"kernels in {PROFILE_SESSIONS} sessions of {reps} calls")
    times = [e.time_range.elapsed_us() for e in kernels]
    return [statistics.median(times[r * n_launches + i] for r in range(reps))
            for i in range(n_launches)]


def level_device_us(args, n_levels, reps=5):
    """Device time (us) of each level's kernel over one traversal through
    the level kernel (`args` of update_partials_kernel), from
    `launches_device_us`."""
    from libpll2_tpu_torch.ops import levels

    return launches_device_us(lambda: levels.update_partials_kernel(*args),
                              "level_", n_levels, reps)


def level_tables(part, ops):
    """The level tables of `ops` on the card, and the arguments of
    update_partials_kernel over `part`'s buffers."""
    from libpll2_tpu_torch.ops import levels

    tables = levels.tables_to_device(levels.pack_pallas_levels(
        ops, part.tips, part.scale_buffers + 1, part.scale_buffers),
        part.device)
    return tables, (part.clv, part.scale_buffer, part.pmatrix, tables,
                    part.scale_threshold, part.scale_factor)


def level_times(label, part, eng, ops, gpu):
    """Phase 11 for one problem: medians (ms) of the level kernel over one
    whole traversal (all levels, tables on the card) and of its plain
    version, of one loglikelihood() on the levels-kernel path, and of one
    step-by-step traversal (update_partials + compute_edge_loglikelihood)."""
    from libpll2_tpu_torch.ops import levels

    tables, args = level_tables(part, ops)
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


def level_device(label, part, ops, gpu) -> dict:
    """Phase 11 (and `--levels-only`), after every timing (a profiler
    session could disturb them): the level kernels' device time over one
    traversal of `ops` on `part` (P-matrices set), from `level_device_us`,
    printed level by level beside each level's own byte bound (each op
    reads two child rows and writes one, at the card's HBM rate), the rate
    its bytes imply (above the HBM rate only through L2 hits) and, for the
    4x4 variant, its layout (`level_layouts`). Returns {"ms": the
    traversal, "level_us", "level_bound_us", "level_ops", "layout": per
    level, "widest_ms", "slowest_ms", "bound_ms", "bound_by"}."""
    tables, args = level_tables(part, ops)
    per_level = level_device_us(args, len(tables))
    device = sum(per_level) * 1e-3
    widths = [t.shape[1] for t in tables]
    wide = widths.index(max(widths))
    narrow = widths.index(min(widths))
    slow = per_level.index(max(per_level))
    row = part.rate_cats * part.states * part.sites_padded * 4
    level_bounds = [3 * w * row / H100_BYTES_PER_S * 1e6 for w in widths]
    layouts = level_layouts(part, tables)
    lay = layouts if isinstance(layouts, list) else [None] * len(widths)
    bound, by = level_bound(part, ops)
    print(f"level device time, {label} {part.tips} x {part.sites}"
          f"{' (per-rate counts)' if part.rate_scalers else ''} "
          f"(torch.profiler, median of 5 traversals per level; {gpu}): "
          f"{device:.4f} ms over {len(tables)} levels ({device / bound:.2f}x "
          f"the bound {bound:.4f} ms by {by}; the levels' own bounds add up "
          f"to {sum(level_bounds) * 1e-3:.4f} ms); "
          f"{level_layout_text(layouts)}; widest level ({widths[wide]} ops) "
          f"{per_level[wide]:.1f} us, slowest ({widths[slow]} "
          f"op{'s' if widths[slow] > 1 else ''}) {per_level[slow]:.1f} us; "
          f"by level (ops[, sites a lane x tiles a block]: us / its bound "
          f"in us at 3 rows an op, TB/s) "
          + ", ".join(f"{w}{f' {l[0]}x{l[1]}' if l else ''}: {t:.1f} / "
                      f"{b:.1f}, {3 * w * row / t * 1e-6:.2f}"
                      for w, l, t, b in zip(widths, lay, per_level,
                                            level_bounds)),
          flush=True)
    return {"ms": device, "level_us": per_level,
            "level_bound_us": level_bounds, "level_ops": widths,
            "layout": lay, "widest_ms": per_level[wide] * 1e-3,
            "narrowest_ms": per_level[narrow] * 1e-3,
            "slowest_ms": per_level[slow] * 1e-3, "bound_ms": bound,
            "bound_by": by}


def caterpillar_partition(device):
    """The level kernel's worst case: the 80-taxon caterpillar at the DNA
    main path's width (random columns, seed 3), 78 ops in 78 levels of one
    op each, P-matrices set. Returns (partition, ops)."""
    from libpll2_tpu_torch.trees import parse_newick, random_alignment

    tree = parse_newick(caterpillar_newick(80))
    headers, seqs = random_alignment(80, N_SITES, seed=3)
    part = dna_partition(tree, dict(zip(headers, seqs)), N_SITES, device)
    return part, traversal_ops(part, tree)[0]


def caterpillar_times(device, gpu):
    """Phase 11: medians (ms) of one caterpillar traversal
    (`caterpillar_partition`) through the kernel and through its plain
    version. Returns (partition, ops)."""
    from libpll2_tpu_torch.ops import levels

    part, ops = caterpillar_partition(device)
    tables, args = level_tables(part, ops)
    kernel = median_ms(lambda: levels.update_partials_kernel(*args))
    plain = median_ms(lambda: levels.update_partials_kernel(
        *args, level=levels.level_update_reference))
    bound, by = level_bound(part, ops)
    print(f"level times, caterpillar 80 x {N_SITES} ({len(ops)} ops in "
          f"{len(tables)} levels; {gpu}): kernel {kernel:.4f} ms "
          f"({len(ops) * N_SITES / kernel / 1e6:.3f} G CLV site-updates/s; "
          f"bound {bound:.4f} ms by {by}), plain {plain:.4f} ms",
          flush=True)
    return part, ops


def levels_only(device, gpu) -> dict:
    """`--levels-only`: the level kernel's call time (ms, CUDA events),
    the host's time to enqueue it (`host_ms`) and its device time level by
    level (`level_device`) over one traversal, of the package that was
    imported, which may be another checkout's: the DNA main path's 128 x
    16384 tree per site and per rate (the 4x4 variant), the 80-taxon
    caterpillar at 16384 sites, and the 128 x 8192 LG+G4 protein tree (the
    runtime-size variant, a control). Each entry holds `level_device`'s
    keys, its "ms" the call's and "device_ms" the traversal's device
    time. Under "trials", the level kernel's trial forms
    (`trial_forms_only`)."""
    from libpll2_tpu_torch.ops import levels
    from libpll2_tpu_torch.trees import random_alignment, random_utree

    headers, seqs = random_alignment(N_TAXA, N_SITES, seed=SEED)
    big, big_by = random_utree(headers, seed=SEED), dict(zip(headers, seqs))
    aa_tree, aa_by = protein_alignment()

    def dna(**options):
        part = dna_partition(big, big_by, N_SITES, device, **options)
        return part, traversal_ops(part, big)[0]

    def protein():
        part = protein_partition(aa_tree, aa_by, AA_SITES, device)
        return part, traversal_ops(part, aa_tree)[0]

    cases = {"dna": dna, "dna_per_rate": lambda: dna(rate_scalers=True),
             "caterpillar": lambda: caterpillar_partition(device),
             "protein": protein}
    out = {}
    for key, build in cases.items():
        part, ops = build()
        args = level_tables(part, ops)[1]
        ms = median_ms(lambda: levels.update_partials_kernel(*args))
        host = host_ms(lambda: levels.update_partials_kernel(*args))
        dev = level_device(key, part, ops, gpu)
        out[key] = {**dev, "ms": ms, "device_ms": dev["ms"], "host_ms": host}
        print(f"  level kernel call, {key}: {ms:.4f} ms; host enqueue "
              f"{host[0]:.4f} ms least, {host[1]:.4f} median", flush=True)
        del part, args
    out["trials"] = trial_forms_only(device, gpu,
                                     ("dna", "dna_per_rate", "protein"))
    return out


def trial_forms_only(device, gpu, keys) -> dict:
    """Phase 21's trial forms of the level and pool kernels for
    `--levels-only` and `--pool-only` (`trial_form_case`: each chunk
    against its plain version, the first chunk's call, device time, bound
    and plain time), of the package that was imported, {} where it has no
    trial form: of `keys`, DNA 128 x 16384 per site and per rate
    ('dna', 'dna_per_rate') and the 128 x 8192 LG+G4 protein ('protein')
    on 'levels-kernel', the 246 x 4465 repeats ('repeats') and the
    conserved protein ('conserved_protein') on 'pool-pallas'."""
    from libpll2_tpu_torch import TreeEngine

    if not hasattr(TreeEngine, "trial_chunk"):
        return {}

    aa_tree, aa_by = protein_alignment()
    rep_tree, _, rep_make = flagship_repeats()
    aa_make = conserved_protein(aa_tree, aa_by)[1]
    dna = ("subst", "freqs")
    cases = {
        "dna": (lambda: opt_problem(device)[2::-2], "levels-kernel", dna),
        "dna_per_rate": (lambda: opt_problem(
            device, rate_scalers=True)[2::-2], "levels-kernel", dna),
        "protein": (lambda: (protein_partition(aa_tree, aa_by, AA_SITES,
                                               device), aa_tree),
                    "levels-kernel", ("freqs",)),
        "repeats": (lambda: (rep_make(device), rep_tree), "pool", dna),
        "conserved_protein": (lambda: (aa_make(device), aa_tree), "pool",
                              ("freqs",))}
    out = {}
    for key in keys:
        make, pallas, groups = cases[key]
        part, tree = make()
        eng = TreeEngine(part, tree, pallas=pallas)
        c = trial_form_case(key, eng, tree, groups, gpu)
        out[key] = {k: v for k, v in c.items() if k != "bound"}
        out[key]["bound_ms"] = c["bound"][0]
        del eng, part
    return out


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


def median_ms(fn, reps=REPS) -> float:
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps=100):
    """(least, median) ms of the host's clock for one call of `fn`, the
    device idle before each: the host's own work to enqueue it, which the
    least of many calls separates from the noise of a shared host."""
    import torch

    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return min(times), statistics.median(times)


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


def kernel_device_us(fn, name: str, reps=5) -> float:
    """Device time (us) of the one kernel whose name holds `name` in a call
    of `fn`, from `launches_device_us`."""
    return launches_device_us(fn, name, 1, reps)[0]


def rows_device(eng, part, gpu, modes=("split", "bf16", "highest")):
    """Phase 8, after the timings: the rows kernel's device time (ms) over
    one traversal of the protein main path per mode, and per op, each with
    the plan it ran (`rows_plan_of`, where the package has modes)."""
    import inspect

    from libpll2_tpu_torch.ops import _kernels
    from libpll2_tpu_torch.ops.fused import fused_traversal

    codes, pm, table = traversal_inputs(eng)
    kw = dict(rates=part.rate_cats, states=part.states,
              n_slots=eng.fused_slots, threshold=part.scale_threshold,
              factor=part.scale_factor)
    n_ops = len(eng.table) - 1
    out = {mode: kernel_device_us(lambda: fused_traversal(
        codes, pm, table, mxu=mode, **kw), "fused_rows") * 1e-3
        for mode in modes}
    moded = "mxu" in inspect.signature(_kernels.device_rows_plan).parameters
    plans = {m: rows_plan_of(part, eng, m).plan if moded
             else rows_plan_of(part, eng).plan for m in modes}
    print(f"rows kernel device time, {part.tips} x {part.sites} "
          f"(torch.profiler, median of 5 traversals; {gpu}): "
          + ", ".join(f"[{m}] {v * 1e3:.1f} us ({v * 1e3 / n_ops:.3f} us "
                      f"an op over {n_ops} ops, plan {plans[m]})"
                      for m, v in out.items()), flush=True)
    out["plans"] = plans
    return out


def fused_device(label, part, eng, gpu) -> float:
    """The DNA fused kernel's device time (ms) over one traversal of an
    engine's inputs, from torch.profiler (median of 5), printed with its
    time an op, its bound and the plan it ran (on the 4 x 4 on-chip body:
    G, SPT, blocks and clusters)."""
    from libpll2_tpu_torch.ops import _kernels
    from libpll2_tpu_torch.ops.fused import fused_traversal

    codes, pm, table = traversal_inputs(eng)
    kw = traversal_kw(part, eng)
    n_ops = len(table) - 1
    dev = kernel_device_us(lambda: fused_traversal(codes, pm, table, **kw),
                           "fused_") * 1e-3
    ran = ""
    if hasattr(_kernels, "device_fused_plan"):
        plan = fused_plan_of(part, eng)
        ran = f"; {plan_text(plan)}"
        if not hasattr(plan, "padded_states"):
            ran += f"; {launch_text(plan, part.sites_padded)}"
    bound = fused_bound(eng, part)
    print(f"fused kernel device time, {label}, {part.tips} x {part.sites} "
          f"(torch.profiler, median of 5 traversals; {gpu}): "
          f"{dev * 1e3:.1f} us ({dev * 1e3 / n_ops:.3f} us an op over "
          f"{n_ops} ops), bound {bound[0] * 1e3:.1f} us by {bound[1]}"
          f"{ran}", flush=True)
    return dev


def query_walk_inputs(placer, queries, q, n_edges):
    """The query form's operands on a placer: the shared tip codes, the
    first `n_edges` attachment edges' P [E, B, R, s, s] and tables, the
    first `q` queries' codes; and its keywords."""
    import numpy as np
    import torch
    from libpll2_tpu_torch.engine import _pmatrices

    eng = placer._ensure_engine()
    tables, blens, _, n_slots = placer._fused_batch_inputs()
    m = eng._model_args()
    pm = _pmatrices(*m[:5], m[7], blens[:n_edges].reshape(-1))
    pm = pm.view(n_edges, -1, *pm.shape[1:])
    seqs = [queries[k] for k in list(queries)[:q]]
    codes = torch.as_tensor(placer._query_codes_batch(seqs).astype(np.int32),
                            device=placer.partition.device)
    p = placer.partition
    kw = dict(rates=p.rate_cats, states=p.states, n_slots=n_slots,
              threshold=p.scale_threshold, factor=p.scale_factor,
              query_codes=codes, query_row=placer.query_row)
    return (eng._tip_codes(), pm, tables[:n_edges].contiguous()), kw


def cluster_sweep(label, part, eng, gpu) -> dict:
    """The 4 x 4 on-chip walk of an engine at every cluster size G (1, 2,
    4, 8; forced through the launcher's plan argument, launches that are
    not counted): device us from torch.profiler, each with its critical
    ops (`split_fused_schedule`), slots and blocks, where the package has
    clusters."""
    from libpll2_tpu_torch.ops import _kernels

    codes, pm, table = traversal_inputs(eng)
    kw = traversal_kw(part, eng)
    splits = kw.get("splits")
    if splits is None:
        return {}
    base = _kernels.device_fused_plan(
        part.device, 4, 4, kw["n_slots"], part.rate_scalers,
        part.sites_padded, 1, kw["tip_clvs"] is not None)
    out = {}
    for g in (1, 2, 4, 8):
        plan = base._replace(cluster=g)
        out[g] = kernel_device_us(lambda: _kernels.launch_fused_traversal(
            codes, pm[None], table[None], 4, 4, kw["n_slots"],
            kw["threshold"], kw["factor"], part.rate_scalers,
            kw["tip_clvs"], plan=plan, splits=splits), "fused_")
    print(f"fused kernel device time at each cluster size, {label}, "
          f"{part.tips} x {part.sites} (torch.profiler, median of 5; {gpu}): "
          + "; ".join(f"G {g}: {us:.1f} us ({splits(g)[1]} ops one after "
                      f"another, {splits(g)[0]} slots, "
                      f"{launch_text(base._replace(cluster=g), part.sites_padded)})"
                      for g, us in out.items()), flush=True)
    return out


# `--fused-only`'s query launch: 16 queries x the first 60 attachment edges
# of the DNA main path's tree with t127 pruned (phase 23's launches: 14
# slots)
FUSED_ONLY_QUERIES = (16, 60)


# `--graph-replays`: profiled sessions a form
GRAPH_SESSIONS = 30


def graph_replays_only(device, gpu) -> dict:
    """`--graph-replays`: on the DNA main path (G 2) and the 246 x 4465
    repeats problem (G 4), `graph_replays` at the plan's cluster and at
    G 1, GRAPH_SESSIONS of its replays under torch.profiler; then phase
    27's profiled loglikelihood_loop(65) (`profiled_window`) as many times
    with the engine's splits (its cluster) and without them (one block a
    walk). Prints and returns, for each, the launches whose rows differed
    and, per session, the profiler's count of our kernels against the
    launches."""
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.ops import _kernels
    from libpll2_tpu_torch.trees import random_alignment, random_utree

    headers, seqs = random_alignment(N_TAXA, N_SITES, seed=SEED)
    tree = random_utree(headers, seed=SEED)
    cases = {"dna": build_engine(tree, dict(zip(headers, seqs)), N_SITES,
                                 device)}
    rep_tree, _, make = flagship_repeats()
    part = make(device)
    cases["repeats"] = (part, TreeEngine(part, rep_tree))
    out = {}
    for key, (part, eng) in cases.items():
        codes, pm, table = traversal_inputs(eng)
        kw = traversal_kw(part, eng)
        g_plan = cluster_of(fused_plan_of(part, eng))
        base = _kernels.device_fused_plan(
            part.device, 4, 4, kw["n_slots"], part.rate_scalers,
            part.sites_padded, 1, kw["tip_clvs"] is not None)
        rec = out[key] = {"cluster": g_plan}
        for g in (g_plan, 1):
            got = graph_replays(codes, pm, table, kw,
                                base._replace(cluster=g),
                                sessions=GRAPH_SESSIONS)
            rec[f"graph_g{g}"] = got
            prof = got["profiled"]
            print(f"{key}, G {g}: {got['walks']} walks in a CUDA graph, "
                  f"{got['replays']} replays, {got['bad']} of "
                  f"{got['launches']} launches differing from their eager "
                  f"walks; profiled: {sum(p[0] < p[2] for p in prof)} of "
                  f"{len(prof)} sessions short in the window "
                  f"({sum(p[2] - p[0] for p in prof)} kernels missing), "
                  f"{sum(p[1] < p[3] for p in prof)} short in the whole "
                  f"trace ({sum(p[3] - p[1] for p in prof)} missing), "
                  f"{sum(p[4] != p[2] for p in prof)} between the markers "
                  f"differing from {got['walks']}; {gpu}", flush=True)
        kept = eng.fused_splits
        for splits in (kept, None):
            eng.fused_splits = splits
            g = cluster_of(fused_plan_of(part, eng)) if splits else 1
            loop = []
            for _ in range(GRAPH_SESSIONS):
                win = profiled_window(lambda: eng.loglikelihood_loop(65))
                loop.append([win["ours"], sum(win["counted"].values())])
            rec[f"loop_g{g}"] = loop
            print(f"{key}, G {g}: profiled loglikelihood_loop(65), "
                  f"{sum(a < b for a, b in loop)} of {len(loop)} sessions "
                  f"with fewer of our kernels than counted "
                  f"({sum(b - a for a, b in loop)} missing); {gpu}",
                  flush=True)
        eng.fused_splits = kept
    return out


def fused_registers_check(lib_path) -> dict:
    """The 4 x 4 on-chip body's cluster instantiations (fused_onchip<SPT,
    PER_RATE, true>) as built: the most registers a thread at each SPT from
    the `-Xptxas -v` log, which must be allocated as many a warp as the
    plan's residency model assumes (ops/_kernels.py:FUSED_REGISTERS).
    Prints and returns them."""
    import re

    from libpll2_tpu_torch.ops import _kernels

    log = lib_path.with_suffix(".log")
    regs, spt = {}, None
    for line in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            m = re.search(r"fused_onchipILi(\d)ELb[01]ELb1E", m.group(1))
            spt = int(m.group(1)) if m else None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and spt is not None:
            regs[spt] = max(regs.get(spt, 0), int(m.group(1)))
            spt = None
    unit = _kernels.WARP_REGISTER_UNIT // 32
    print(f"fused_onchip's cluster body as built: registers a thread "
          f"{regs} (the plan assumes {_kernels.FUSED_REGISTERS}, allocated "
          f"{unit} at a time)", flush=True)
    check(sorted(regs) == sorted(_kernels.FUSED_REGISTERS) and all(
        -(-regs[s] // unit) * unit == w
        for s, w in _kernels.FUSED_REGISTERS.items()),
        f"the cluster body's registers {regs} differ from the plan's "
        f"FUSED_REGISTERS {_kernels.FUSED_REGISTERS}")
    return regs


def topology_change_ms(eng, trees, reps=None) -> tuple:
    """Host ms of `eng.set_topology(tree)` then `eng.loglikelihood()` (its
    value on the host), the `trees` taken in turn, after one change to
    each: (least, median) of `reps` (LOOP_REPS) changes. The engine is
    left on the last of `trees`."""
    reps = reps or LOOP_REPS
    times = []
    for i in range(reps + len(trees)):
        t0 = time.perf_counter()
        eng.set_topology(trees[i % len(trees)])
        eng.loglikelihood()
        times.append((time.perf_counter() - t0) * 1e3)
    times = times[len(trees):]
    return min(times), statistics.median(times)


def fused_only(device, gpu) -> dict:
    """`--fused-only`: the DNA fused kernel's call and device times (ms)
    on the DNA main path, per rate, with all 128 tips raw and on the
    246 x 4465 'repeats-dense-fused' inputs, each with the plan it ran;
    where the package has them, the walk at each cluster size
    (`cluster_sweep`: DNA, repeats and a 16-taxon walk at 1000 sites), the
    device time of a chunk of the DNA tree's NNI neighbours (the candidate
    form), of one query-form launch (FUSED_ONLY_QUERIES) and the DNA
    'fused' loglikelihood_loop's ms an evaluation (bench.py's differenced
    trip counts), of the package that was imported, which may be another
    checkout's."""
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.ops import _kernels
    from libpll2_tpu_torch.ops.fused import fused_traversal
    from libpll2_tpu_torch.trees import random_alignment, random_utree

    headers, seqs = random_alignment(N_TAXA, N_SITES, seed=SEED)
    tree = random_utree(headers, seed=SEED)
    by = dict(zip(headers, seqs))
    cases = {"dna": build_engine(tree, by, N_SITES, device),
             "per_rate": build_engine(tree, by, N_SITES, device,
                                      rate_scalers=True)}
    part = dna_partition(tree, by, N_SITES, device)
    set_raw_tips(part, tree, by)
    cases["raw_tips"] = (part, TreeEngine(part, tree))
    rep_tree, _, make = flagship_repeats()
    part = make(device)
    cases["repeats"] = (part, TreeEngine(part, rep_tree))
    out = {}
    for key, (part, eng) in cases.items():
        codes, pm, table = traversal_inputs(eng)
        kw = traversal_kw(part, eng)
        ms = median_ms(lambda: fused_traversal(codes, pm, table, **kw))
        dev = fused_device(key, part, eng, gpu)
        plan = fused_plan_of(part, eng)
        out[key] = {"ms": ms, "device_ms": dev,
                    "us_per_op": dev * 1e3 / (len(table) - 1),
                    "bound_ms": fused_bound(eng, part)[0],
                    "threads_per_site": plan.threads_per_site,
                    "cluster": cluster_of(plan)}
        print(f"  fused kernel call, {key}: {ms:.4f} ms", flush=True)
    # the cluster sizes side by side: the two problems above and a
    # 16-taxon walk at 1000 sites, where a cluster costs more than it gains
    headers16, seqs16 = random_alignment(16, 1000, alphabet="ACGT-NRY",
                                         seed=3)
    small = build_engine(random_utree(headers16, seed=3),
                         dict(zip(headers16, seqs16)), 1000, device)
    for key, (part, eng) in (("dna", cases["dna"]),
                             ("repeats", cases["repeats"]),
                             ("small", small)):
        sweep = cluster_sweep(key, part, eng, gpu)
        if sweep:
            out.setdefault("clusters_us", {})[key] = sweep
    from libpll2_tpu_torch import engine
    if hasattr(engine, "CANDIDATE_CHUNK"):  # a package with candidates
        part, eng = cases["dna"]
        packed = at_neighbours(tree, lambda: eng.pack_candidate(tree.vroot),
                               engine.CANDIDATE_CHUNK)
        args, kw = candidate_inputs(part, eng, packed)
        dev = kernel_device_us(lambda: fused_traversal(*args, **kw),
                               "fused_") * 1e-3
        plan = _kernels_plan(part, kw["n_slots"], len(packed),
                             kw.get("splits"))
        bound = candidate_bound(part, len(packed), args[2].shape[1] - 1)
        out["candidates"] = {"device_ms": dev, "candidates": len(packed),
                             "us_per_candidate": dev * 1e3 / len(packed),
                             "bound_ms": bound[0],
                             "cluster": cluster_of(plan)}
        print(f"fused kernel device time, a chunk of {len(packed)} DNA "
              f"candidates (torch.profiler, median of 5; {gpu}): "
              f"{dev * 1e3:.1f} us ({dev * 1e3 / len(packed):.2f} us a "
              f"candidate), bound {bound[0] * 1e3:.1f} us by {bound[1]}; "
              f"{plan_text(plan)}; "
              f"{launch_text(plan, part.sites_padded, len(packed))}",
              flush=True)
    if hasattr(fused_traversal, "query_launches"):   # the query form
        from libpll2_tpu_torch import EdgePlacer

        ref, ref_by, victim, _ = pruned_reference(tree, by,
                                                  f"t{N_TAXA - 1}")
        placer = EdgePlacer(ref, ref_by, device=device)
        freqs, subst = dna_model()
        placer.set_model(freqs, subst, alpha=0.8)
        q, e = FUSED_ONLY_QUERIES
        queries = mutated_queries(ref_by, q, 2, "ACGT",
                                  start={"victim": victim})
        args, kw = query_walk_inputs(placer, queries, q, e)
        dev = kernel_device_us(lambda: fused_traversal(*args, **kw),
                               "fused_") * 1e-3
        p = placer.partition
        plan = _kernels_plan(p, kw["n_slots"], q * e, kw.get("splits"))
        bound = query_bound(p, q, e, args[2].shape[1] - 1)
        out["query"] = {"device_ms": dev, "walks": q * e,
                        "us_per_walk": dev * 1e3 / (q * e),
                        "slots": kw["n_slots"], "bound_ms": bound[0],
                        "cluster": cluster_of(plan)}
        print(f"fused kernel device time, a query launch of {q} x {e} "
              f"walks, {kw['n_slots']} slots (torch.profiler, median of 5; "
              f"{gpu}): {dev * 1e3:.1f} us ({dev * 1e3 / (q * e):.2f} us a "
              f"walk), bound {bound[0] * 1e3:.1f} us by {bound[1]}; "
              f"{plan_text(plan)}; {launch_text(plan, p.sites_padded, q * e)}",
              flush=True)
        del placer
    # a walk right after a topology change: set_topology, then
    # loglikelihood() (the new table packed, its splits made where the
    # package makes them, the walk, its value on the host), the main
    # path's and the repeats problem's trees taken in turn with a second
    # random tree of as many taxa (same tip buffers, other tips paired)
    for key, first in (("dna", tree), ("repeats", rep_tree)):
        part, eng = cases[key]
        second = random_utree([n.label for n in first.tips()],
                              seed=SEED + 1)
        change = topology_change_ms(eng, (second, first))
        steady = host_ms(eng.loglikelihood, reps=20)
        out[key].update(topology_change_ms=change[1],
                        topology_change_least_ms=change[0],
                        loglikelihood_ms=steady[1])
        print(f"  {key}: set_topology + loglikelihood() {change[1]:.3f} ms "
              f"(least {change[0]:.3f}; {LOOP_REPS} changes) beside "
              f"loglikelihood() alone {steady[1]:.3f} ms (least "
              f"{steady[0]:.3f})", flush=True)
    part, eng = cases["dna"]
    if hasattr(eng, "loglikelihood_loop"):   # the loops
        k1, k2 = LOOP_BENCH
        t1, t2 = best_ms([lambda: eng.loglikelihood_loop(k1),
                          lambda: eng.loglikelihood_loop(k2)])
        out["loop_ms_per_evaluation"] = (t2 - t1) / (k2 - k1)
        print(f"DNA 'fused' loglikelihood_loop, ms an evaluation ({k1} and "
              f"{k2} differenced, best of {LOOP_REPS}; {gpu}): "
              f"{out['loop_ms_per_evaluation']:.4f}", flush=True)
    return out


# the runtime-size body of fused_traversal.cu (fused_generic): every float32
# shape but 4 states x 4 rates, and the float64 walk. Phase 3's cases: a
# site's rates on 1, 4, 8 or 32 lanes (1, 3, 8 and 33 rates at 4 states)
# and 2, 5 and 15 states (4, 8 and 16 wide), each as the walk is, with
# per-rate counts, raw tip rows, 3 candidates, 3 queries of 2 candidates
# and GENERIC_SPILL_SLOTS slots (the spill plan; 2 states need 2000); phase
# 5b's full-width shapes, bench.py's DNA problem at 1 and 8 categories and
# a 5-state alphabet at 4 (the fifth state 'X', '-' every state)
GENERIC_RATES = (1, 3, 8, 33)
GENERIC_STATES = (2, 5, 15)
GENERIC_MODES = ("walk", "per_rate", "raw", "k3", "q3", "spill")
GENERIC_SPILL_SLOTS = 1000
GENERIC_FULL = (("DNA GTR, 1 category", 1, 4), ("DNA GTR+G8", 8, 4),
                ("5 states, 4 categories", 4, 5))
ALPHABET5 = "ACGTX"


def generic_alphabet(states):
    """The tips' characters of a `states`-state problem: DNA with
    ambiguity codes at 4, else the first `states` of LETTERS32 with '-'."""
    return "ACGT-NRY" if states == 4 else (
        ALPHABET5 + "-" if states == 5 else LETTERS32[:states] + "-")


def generic_partition(tree, by_label, sites, device, rate_cats=4, states=4,
                      **options):
    """`dna_partition` at 4 states; otherwise GTR on `states` states (the
    first `states` of LETTERS32, or ALPHABET5 at 5; '-' every state) with
    Dirichlet(10) frequencies and U(0.5, 2) rates from seed 7, Gamma(0.8)
    x `rate_cats`."""
    import numpy as np
    import torch
    from libpll2_tpu_torch import Partition, compute_gamma_cats

    if states == 4:
        return dna_partition(tree, by_label, sites, device, rate_cats,
                             **options)
    options.setdefault("dtype", torch.float32)
    part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, rate_cats, tree.inner_count,
                     device=device, **options)
    cm = np.zeros(256, np.uint64)
    for i, ch in enumerate(ALPHABET5 if states == 5 else LETTERS32[:states]):
        cm[ord(ch)] = 1 << i
    cm[ord("-")] = (1 << states) - 1
    tips = list(tree.tips())
    part.set_tip_states_batch(cm, [by_label[t.label] for t in tips],
                              [t.clv_index for t in tips])
    rng = np.random.default_rng(SEED)
    part.set_frequencies(0, rng.dirichlet(np.ones(states) * 10))
    part.set_subst_params(0, rng.uniform(0.5, 2.0,
                                         states * (states - 1) // 2))
    part.set_category_rates(compute_gamma_cats(0.8, rate_cats))
    return part


def walks_as_sites(out):
    """Root rows with leading candidate (and query) axes as one walk of
    their sites side by side: CLVs [R, s, W * S], counts [W * S] ([R, W *
    S] per rate), so that `match_counts` and the per-site error read them
    as one walk's."""
    clv_p, clv_c, sc_p, sc_c = out
    lead = clv_p.dim() - 3
    if lead == 0:
        return out

    def clv(x):
        x = x.reshape(-1, *x.shape[lead:])
        return x.permute(1, 2, 0, 3).reshape(x.shape[1], x.shape[2], -1)

    def sc(x):
        x = x.reshape(-1, *x.shape[lead:])
        return (x.reshape(-1) if x.dim() == 2
                else x.permute(1, 0, 2).reshape(x.shape[1], -1))
    return clv(clv_p), clv(clv_c), sc(sc_p), sc(sc_c)


def generic_case(name, part, eng, tree, mode):
    """One of phase 3's runtime-size cases: the kernel (one launch, the
    candidate and query forms too) against its plain version on the card,
    counts equal (or a rescale tie, `match_counts`), root CLVs TOL_CLV of
    each site's max, on the plan expected (spill at GENERIC_SPILL_SLOTS,
    a site's rates on generic_lanes(R) lanes). Returns the max abs err."""
    import torch
    from libpll2_tpu_torch.ops import _kernels
    from libpll2_tpu_torch.ops.fused import (fused_traversal,
                                             fused_traversal_reference)

    if mode in ("k3", "q3"):
        packed = at_neighbours(tree, lambda: eng.pack_candidate(tree.vroot),
                               3 if mode == "k3" else 2)
        args, kw = candidate_inputs(part, eng, packed)
    else:
        args = traversal_inputs(eng)
        kw = traversal_kw(part, eng)
    walks = 1
    if mode == "k3":
        walks = 3
    if mode == "q3":
        kw.update(query_codes=args[0][[3, 5, 7]].contiguous(), query_row=0)
        walks = 6
    if mode == "spill":
        kw["n_slots"] = 2000 if part.states == 2 else GENERIC_SPILL_SLOTS
    plan = fused_plan_of(part, eng, kw["n_slots"], walks)
    want = ("spill" if mode == "spill" else "on-chip",
            _kernels.generic_lanes(part.rate_cats))
    check(isinstance(plan, _kernels.GenericPlan)
          and (plan.plan, plan.threads_per_site) == want,
          f"{name}: plan {plan}, expected {want}")
    before = fused_traversal.launches
    got = walks_as_sites(fused_traversal(*args, **kw))
    check(fused_traversal.launches == before + 1,
          f"{name}: {fused_traversal.launches - before} launches")
    ref = walks_as_sites(fused_traversal_reference(*args, **kw))
    torch.cuda.synchronize()
    ties = sum(match_counts(f"{name}, {which}", g_sc, w_sc, g_clv, w_clv,
                            root_block(part), part.scale_factor,
                            part.scale_threshold)
               for g_sc, w_sc, g_clv, w_clv, which in (
                   (got[2], ref[2], got[0], ref[0], "parent"),
                   (got[3], ref[3], got[1], ref[1], "child")))
    rel = abs_err = 0.0
    for g, w in zip(got[:2], ref[:2]):
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite CLVs")
        site_max = w.abs().amax(dim=(0, 1)).clamp(min=1e-30)
        rel = max(rel, float(((g - w).abs() / site_max).max()))
        abs_err = max(abs_err, float((g - w).abs().max()))
    print(f"  generic [{name}]: {walks} walk{'s' if walks > 1 else ''}, "
          f"{kw['n_slots']} slots, counts equal (max "
          f"{int(max(ref[2].max(), ref[3].max()))}"
          f"{f'; {ties} ties' if ties else ''}), max_rel_err {rel:.3e}; "
          f"{plan_text(plan)}", flush=True)
    check(rel <= TOL_CLV, f"{name}: max_rel_err {rel:.3e} > {TOL_CLV}")
    return abs_err


def generic_cases(device, small, cat):
    """Phase 3's runtime-size cases on the 16-taxon tree at 1000 sites
    (33 rates at 300) and, per site and per rate, the 80-taxon caterpillar
    at 3 rates (which must rescale). Returns the max abs err."""
    import numpy as np
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.trees import random_alignment

    err = 0.0
    shapes = [(r, 4) for r in GENERIC_RATES] + [(4, s)
                                                 for s in GENERIC_STATES]
    for rates, states in shapes:
        sites = 300 if rates > 32 else 1000
        headers, seqs = random_alignment(16, sites, seed=3,
                                         alphabet=generic_alphabet(states))
        by = dict(zip(headers, seqs))
        for mode in GENERIC_MODES:
            part = generic_partition(small, by, sites, device, rates, states,
                                     rate_scalers=mode == "per_rate")
            if mode == "raw":
                rng = np.random.default_rng(CATG_SEED)
                for tip in sorted(small.tips(),
                                  key=lambda t: t.clv_index)[::2]:
                    part.set_tip_clv(tip.clv_index, rng.dirichlet(
                        np.ones(states), size=sites))
            err = max(err, generic_case(
                f"{rates} rates x {states} states, {mode}", part,
                TreeEngine(part, small), small, mode))
    headers, seqs = random_alignment(80, 1000, seed=3)
    by = dict(zip(headers, seqs))
    for per_rate in (False, True):
        part = generic_partition(cat, by, 1000, device, 3,
                                 rate_scalers=per_rate)
        eng = TreeEngine(part, cat)
        err = max(err, compare_traversal(
            f"runtime-size body, caterpillar, 3 rates"
            f"{', per rate' if per_rate else ''}", part, eng,
            must_scale="rates" if per_rate else True, plan=("on-chip", 4))[1])
    return err


def generic_full_width(device):
    """Phase 5b's problems: {label: (partition, engine)} of GENERIC_FULL on
    bench.py's tree (128 x 16384, seed 7)."""
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.trees import random_alignment, random_utree

    out = {}
    for label, rates, states in GENERIC_FULL:
        headers, seqs = random_alignment(
            N_TAXA, N_SITES, seed=SEED,
            alphabet="ACGT" if states == 4 else generic_alphabet(states))
        tree = random_utree(headers, seed=SEED)
        part = generic_partition(tree, dict(zip(headers, seqs)), N_SITES,
                                 device, rates, states)
        out[label] = (part, TreeEngine(part, tree))
    return out


def generic_phase(device, gpu):
    """Phase 5b: the runtime-size body at full width (GENERIC_FULL):
    each problem's kernel against its plain version on the card, then
    through TreeEngine 'fused' (loglikelihood() and one newton_step(),
    two launches counted, logL against the plain float64 path on the
    card), then its call (CUDA events), device time (torch.profiler),
    bound and plain time, and the plan it ran. Returns {label: numbers}."""
    import torch
    from libpll2_tpu_torch.ops import _kernels
    from libpll2_tpu_torch.ops.fused import (fused_traversal,
                                             fused_traversal_reference)

    out = {}
    for label, (part, eng) in generic_full_width(device).items():
        plan = fused_plan_of(part, eng)
        rel, abs_err = compare_traversal(
            f"runtime-size body, {label}, main-path shape", part, eng,
            plan=("on-chip", _kernels.generic_lanes(part.rate_cats)))
        check(eng.execution_path == "fused",
              f"{label}: execution_path is {eng.execution_path!r}")
        b0 = eng.branches.clone()
        reset_counts()
        lnl = eng.loglikelihood()
        lk, d1, d2 = eng.newton_step()
        got_counts = counts()
        check_counts(f"{label}: loglikelihood() + newton_step()", got_counts,
                     {"fused": 2})
        check(all(map(math.isfinite, (lnl, lk, d1, d2))),
              f"{label}: non-finite result")
        ref = plain_float64(part, eng, b0)[0]
        rel_logl = abs(lnl - ref) / abs(ref)
        check(rel_logl < TOL_LOGL, f"{label}: logL {lnl!r} is {rel_logl:.2e} "
              f"from the plain float64 path {ref!r}")
        codes, pm, table = traversal_inputs(eng)
        kw = traversal_kw(part, eng)
        call = median_ms(lambda: fused_traversal(codes, pm, table, **kw))
        plain = median_ms(lambda: fused_traversal_reference(
            codes, pm, table, **kw), reps=5)
        dev = kernel_device_us(lambda: fused_traversal(codes, pm, table,
                                                       **kw),
                               "fused_generic") / 1e3
        bound = fused_bound(eng, part)
        torch.cuda.synchronize()
        print(f"runtime-size body, {label}, {part.tips} x {part.sites} "
              f"({len(table) - 1} ops; {gpu}): logL {lnl!r} (float64 plain "
              f"{ref!r}, rel {rel_logl:.2e}); device {dev * 1e3:.1f} us, "
              f"call {call:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]}, "
              f"plain {plain:.4f} ms; {plan_text(plan)}", flush=True)
        out[label] = {"launches": got_counts["fused"], "max_abs_err": abs_err,
                      "logl_rel_err": rel_logl, "ms": call, "plain_ms": plain,
                      "device_ms": dev, "bound": bound, "plan": plan.plan,
                      "threads_per_site": plan.threads_per_site,
                      "sites_per_block": plan.sites_per_block,
                      "padded_states": plan.padded_states,
                      "depth": plan.depth, "smem_bytes": plan.smem_bytes}
    return out


def flagship_stepwise(device):
    """The flagship's data (phase 22's alignment, compressed to 3581
    patterns) on its native stepwise tree, as a float32 GTR+G4 partition
    (`analysis_partition`): (partition, tree)."""
    from libpll2_tpu_torch import native
    from libpll2_tpu_torch.io import compress_site_patterns, maps
    from libpll2_tpu_torch.parsimony import FastParsimony
    from libpll2_tpu_torch.parsimony.stepwise import fastparsimony_stepwise
    from libpll2_tpu_torch.partition import Partition

    headers, seqs = analysis_data()
    comp, weights, _ = compress_site_patterns(seqs, maps.map_nt)
    n, patterns = len(headers), len(comp[0])
    check(native.load() is not None, "the native library did not load")
    pars = Partition(n, n - 2, 4, patterns, 1, 2 * n - 3, 1, n - 2,
                     device=device)
    pars.set_tip_states_batch(maps.map_nt, comp)
    pars.set_pattern_weights(weights)
    tree, _ = fastparsimony_stepwise([FastParsimony(pars)], headers,
                                     ANA_SEED)
    return analysis_partition(tree, comp, weights, headers, device), tree


def f64_walk_problems(device, big, big_by, aa_tree, aa_by, flagship=None,
                      dtype=None):
    """The float64 walk's problems of phase 24a: [(label, partition,
    tree)]: the DNA and protein main paths, the F64_CATERPILLAR_TAXA x
    16384 caterpillar at alpha 0.5 (which must rescale in float64's 2^-256
    window), and `flagship` (partition, tree) where given; partitions in
    `dtype` (float32 by default) on `device`."""
    import torch
    from libpll2_tpu_torch import compute_gamma_cats
    from libpll2_tpu_torch.trees import parse_newick, random_alignment

    dtype = dtype or torch.float32
    cat = parse_newick(caterpillar_newick(F64_CATERPILLAR_TAXA))
    headers, seqs = random_alignment(F64_CATERPILLAR_TAXA, N_SITES, seed=3)
    cat_part = dna_partition(cat, dict(zip(headers, seqs)), N_SITES, device,
                             dtype=dtype)
    cat_part.set_category_rates(compute_gamma_cats(0.5, 4))
    out = [("DNA 128 x 16384", dna_partition(big, big_by, N_SITES, device,
                                             dtype=dtype), big),
           ("protein 128 x 8192 LG+G4",
            protein_partition(aa_tree, aa_by, AA_SITES, device, dtype=dtype),
            aa_tree),
           (f"caterpillar {F64_CATERPILLAR_TAXA} x 16384, alpha 0.5",
            cat_part, cat)]
    if flagship is not None:
        out.append(("flagship 1000 x 3581, stepwise tree", *flagship))
    return out


def generic_only(device, gpu) -> dict:
    """`--generic-only`: the runtime-size body's call (CUDA events) and
    device time (torch.profiler) on phase 5b's float32 shapes and on the
    float64 walks of phase 24a's problems (the flagship's stepwise tree
    standing in for its final one: 998 ops over the same 3581 patterns),
    of the package that was imported, which may be another checkout's; the
    plan where the package has generic_plan."""
    from libpll2_tpu_torch.ops import _kernels, df64, fused
    from libpll2_tpu_torch.trees import (create_operations,
                                         random_alignment, random_utree,
                                         traverse)

    out = {}
    for label, (part, eng) in generic_full_width(device).items():
        codes, pm, table = traversal_inputs(eng)
        kw = traversal_kw(part, eng)
        call = median_ms(lambda: fused.fused_traversal(codes, pm, table,
                                                       **kw))
        dev = kernel_device_us(lambda: fused.fused_traversal(
            codes, pm, table, **kw), "fused_generic") / 1e3
        ran = (plan_text(fused_plan_of(part, eng))
               if hasattr(_kernels, "generic_plan") else "one thread a site")
        print(f"  float32 {label}: device {dev * 1e3:.1f} us, call "
              f"{call:.4f} ms; {ran}", flush=True)
        out[label] = {"ms": call, "device_ms": dev}
    headers, seqs = random_alignment(N_TAXA, N_SITES, seed=SEED)
    big = random_utree(headers, seed=SEED)
    aa_tree, aa_by = protein_alignment()
    for label, part, tree in f64_walk_problems(
            device, big, dict(zip(headers, seqs)), aa_tree, aa_by,
            flagship_stepwise(device)):
        ops, branches, pidx = create_operations(traverse(tree.vroot))
        walk = df64.walk_inputs(part, tree, ops, branches, pidx)
        call = median_ms(lambda: fused.fused_traversal_f64(**walk), reps=9)
        dev = kernel_device_us(lambda: fused.fused_traversal_f64(**walk),
                               "fused_generic<double") / 1e3
        ran = (plan_text(_kernels.device_generic_plan(
            part.device, walk["rates"], walk["states"], walk["n_slots"],
            False, walk["tip_codes"].shape[1], itemsize=8))
            if hasattr(_kernels, "generic_plan") else "one thread a site")
        print(f"  float64 walk, {label} ({len(ops)} ops, {walk['n_slots']} "
              f"slots): device {dev * 1e3:.1f} us, call {call:.4f} ms; "
              f"{ran}", flush=True)
        out[f"f64 {label}"] = {"ms": call, "device_ms": dev}
    return out


# the spill plan's timing case: 16 rates x 32 states on the protein tree
SPILL_RATES, SPILL_STATES, SPILL_SITES = 16, 32, 4096


def rows_spill_case(device, aa_tree, gpu):
    """Phase 8: the rows kernel's spill plan at a shape that needs it (16
    rates x 32 states, 128 x 4096, a random 32-letter alignment on the
    protein tree), against its plain version, then timed. Returns (max abs
    err, kernel ms, plain ms, device ms, (bound, by))."""
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.ops.fused import (fused_traversal,
                                             fused_traversal_reference)
    from libpll2_tpu_torch.trees import random_alignment

    headers, seqs = random_alignment(AA_TAXA, SPILL_SITES,
                                     alphabet=LETTERS32 + "-", seed=AA_SEED)
    part = protein_partition(aa_tree, dict(zip(headers, seqs)), SPILL_SITES,
                             device, states=SPILL_STATES,
                             rate_cats=SPILL_RATES)
    eng = TreeEngine(part, aa_tree)
    err = compare_rows_traversal(
        f"spill timing shape, {SPILL_RATES} rates x {SPILL_STATES} states",
        part, eng, plan="spill", rounded_plan="tc-spill")[1]
    codes, pm, table = traversal_inputs(eng)
    kw = traversal_kw(part, eng)
    kernel = median_ms(lambda: fused_traversal(codes, pm, table, **kw))
    plain = median_ms(lambda: fused_traversal_reference(codes, pm, table,
                                                        **kw))
    dev = kernel_device_us(lambda: fused_traversal(codes, pm, table, **kw),
                           "fused_rows") * 1e-3
    bound = fused_bound(eng, part, eng.mxu, "tc-spill")
    print(f"rows kernel, spill plan ('{eng.mxu}'), {AA_TAXA} x {SPILL_SITES}, "
          f"{SPILL_RATES} rates x {SPILL_STATES} states (median of {REPS}, "
          f"CUDA events; {gpu}): kernel {kernel:.4f} ms, device "
          f"{dev * 1e3:.1f} us (bound {bound[0]:.4f} ms by {bound[1]}), "
          f"plain {plain:.4f} ms", flush=True)
    return err, kernel, plain, dev, bound


def rows_only(device, gpu) -> dict:
    """`--rows-only`: the protein main path's rows-kernel times of the
    package that was imported, which may be another checkout's, in each
    mode with the plan it ran (phase 8's walk: call and device time), and
    its build report (registers, spills, HGMMA count); then the device
    time of one launch per mode of the kernel's other forms on the main
    path's problems: 64 NNI candidates (phase 19), one maximize_fused step's
    41 frequency trials (phase 21), 4 queries x the pruned tree's edges
    (phase 23), and loglikelihood_loop's ms an evaluation (phase 27,
    differenced trip counts)."""
    from libpll2_tpu_torch.ops import _kernels

    aa_tree, aa_by = protein_alignment()
    part, eng = build_protein_engine(aa_tree, aa_by, AA_SITES, device)
    build = rows_build_report(_kernels.library_path(), require_tc=False)
    ms = times(eng, part, gpu, AA_TAXA, AA_SITES,
               modes=("split", "bf16", "highest"))
    dev = rows_device(eng, part, gpu)
    out = {"ms": ms["split"][0], "plain_ms": ms["split"][1],
           "bf16_ms": ms["bf16"][0], "bf16_plain_ms": ms["bf16"][1],
           "highest_ms": ms["highest"][0],
           "highest_plain_ms": ms["highest"][1],
           "device_ms": dev["split"], "bf16_device_ms": dev["bf16"],
           "highest_device_ms": dev["highest"], "plans": dev["plans"],
           "hgmma": build["hgmma"], "ops": len(eng.table) - 1}
    out.update(rows_forms(device, gpu, aa_tree, aa_by, part, eng))
    return out


def rows_forms(device, gpu, aa_tree, aa_by, part, eng) -> dict:
    """`rows_only`'s launches of the candidate, trial and query forms and
    the loop, each per mode: {form: {mode: device ms}}, and the loop's
    {mode: ms an evaluation}."""
    import torch
    from libpll2_tpu_torch import EdgePlacer, TreeEngine, compute_gamma_cats
    from libpll2_tpu_torch.engine import _pmatrices
    from libpll2_tpu_torch.models import load_aa_model
    from libpll2_tpu_torch.ops import fused
    from libpll2_tpu_torch.optimize import make_fused_loglikelihood_fn
    from libpll2_tpu_torch.trees.utils import utree_clone

    modes = ("split", "bf16", "highest")

    def per_mode(label, args, kw, unit):
        got = {}
        for mode in modes:
            kw = dict(kw, mxu=mode)
            got[mode] = kernel_device_us(lambda: fused.fused_traversal(
                *args, **kw), "fused_rows") * 1e-3
        print(f"rows kernel device time, {label} (torch.profiler, median of "
              f"5; {gpu}): " + ", ".join(
                  f"[{m}] {v * 1e3:.1f} us ({v * 1e3 / unit:.2f} us a walk)"
                  for m, v in got.items()), flush=True)
        return got

    out = {}
    packed = at_neighbours(aa_tree, lambda: eng.pack_candidate(
        aa_tree.vroot), CAND_AA)
    args, kw = candidate_inputs(part, eng, packed)
    out["candidates"] = per_mode(f"{len(packed)} candidates", args, kw,
                                 len(packed))
    # one maximize_fused step's 2n+1 frequency trials, their launch captured
    tree = utree_clone(aa_tree)
    t_eng = TreeEngine(part, tree)
    fnb, x0, _ = make_fused_loglikelihood_fn(t_eng, ("freqs",))
    captured = {}

    def capture(*a, **k_):
        captured["args"], captured["kw"] = a, k_
        return fused.fused_traversal(*a, **k_)

    with trials_through(t_eng, traversal=capture):
        fnb(fd_batch(x0))
    n_trials = captured["args"][2].shape[0]
    out["trials"] = per_mode(f"{n_trials} model trials", captured["args"],
                             captured["kw"], n_trials)
    # the query form: 4 queries x the pruned tree's edges (phase 23b)
    ref, ref_by, victim, _ = pruned_reference(aa_tree, aa_by,
                                              f"t{AA_TAXA - 1}")
    placer = EdgePlacer(ref, ref_by, states=20, device=device)
    load_aa_model(placer.partition, "lg")
    placer.partition.set_category_rates(compute_gamma_cats(0.9, 4))
    placer._engine = placer._stream = None
    q_eng = placer._ensure_engine()
    tables, blens, _, n_slots = placer._fused_batch_inputs()
    m = q_eng._model_args()
    pm = _pmatrices(*m[:5], m[7], blens.reshape(-1))
    pm = pm.view(tables.shape[0], -1, *pm.shape[1:])
    batch = mutated_queries(ref_by, 4, 4, "ARNDCQEGHILKMFPSTWYV",
                            start={"victim": victim})
    codes = torch.as_tensor(placer._query_codes_batch(list(batch.values()))
                            .astype("int32"), device=device)
    p = placer.partition
    q_kw = dict(rates=p.rate_cats, states=p.states, n_slots=n_slots,
                threshold=p.scale_threshold, factor=p.scale_factor,
                query_codes=codes, query_row=placer.query_row)
    out["queries"] = per_mode(f"{codes.shape[0]} queries x "
                              f"{tables.shape[0]} edges",
                              (q_eng._tip_codes(), pm, tables.contiguous()),
                              q_kw, codes.shape[0] * tables.shape[0])
    del placer
    # the loop's evaluation, bench.py's metric (phase 27)
    loop = {}
    k1, k2 = LOOP_BENCH
    for mode in ("split", "bf16"):
        l_eng = TreeEngine(part, utree_clone(aa_tree), mxu=mode)
        t1, t2 = best_ms([lambda: l_eng.loglikelihood_loop(k1),
                          lambda: l_eng.loglikelihood_loop(k2)])
        loop[mode] = (t2 - t1) / (k2 - k1)
    print(f"protein loglikelihood_loop, ms an evaluation ({k1} and {k2} "
          f"differenced, best of {LOOP_REPS}; {gpu}): "
          + ", ".join(f"[{m}] {v:.4f}" for m, v in loop.items()),
          flush=True)
    out["loop_ms_per_evaluation"] = loop
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
               levels.level_update, pool.pool_update,
               fused.fused_traversal_f64):
        fn.launches = 0


def counts():
    from libpll2_tpu_torch.ops import fused, levels, pool

    return {"fused": fused.fused_traversal.launches,
            "rows": fused.fused_traversal_rows.launches,
            "level": levels.level_update.launches,
            "pool": pool.pool_update.launches,
            "f64": fused.fused_traversal_f64.launches}


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
                                             part, eng,
                                             plan=FUSED_MAIN_PLAN)[1])
    keep["fused_per_rate"] = (part, eng)
    # kernel 1 per rate and with raw tips in every plan and thread layout
    for sites, tps in FUSED_LAYOUT_SITES:
        headers, seqs = random_alignment(16, sites, alphabet="ACGT-NRY",
                                         seed=3)
        by = dict(zip(headers, seqs))
        note("fused_per_rate", compare_case(
            f"per-rate, {sites} sites", small, by, sites, device,
            plan=("on-chip", tps), rate_scalers=True)[1])
        part = dna_partition(small, by, sites, device, rate_scalers=True)
        set_raw_tips(part, small, by, every=2)
        note("fused_raw", compare_traversal(
            f"raw tips, every other tip, per-rate, {sites} sites", part,
            TreeEngine(part, small), plan=("on-chip", tps))[1])
    note("fused_per_rate", compare_case(
        f"per-rate, spill: {FUSED_SPILL_SLOTS} slots", small, small_by,
        1000, device, plan=("spill", 1), n_slots=FUSED_SPILL_SLOTS,
        rate_scalers=True)[1])
    part = dna_partition(small, small_by, 1000, device)
    set_raw_tips(part, small, small_by, every=2)
    note("fused_raw", compare_traversal(
        f"raw tips, every other tip, spill: {FUSED_SPILL_SLOTS} slots", part,
        TreeEngine(part, small), plan=("spill", 1),
        n_slots=FUSED_SPILL_SLOTS)[1])
    # kernel 1: raw tips, all 128 and mixed with state codes and per-rate
    part = dna_partition(big, big_by, N_SITES, device)
    set_raw_tips(part, big, big_by)
    eng = TreeEngine(part, big)
    check(int((eng.table[:-1, [1, 4]] == 2).sum()) == N_TAXA,
          "not every tip is a raw row")
    note("fused_raw", compare_traversal("raw tips, all 128", part, eng,
                                        plan=FUSED_MAIN_PLAN)[1])
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
    part = protein_partition(aa_tree, aa_by, AA_SITES, device,
                             rate_scalers=True)
    ops, _, _ = traversal_ops(part, aa_tree)
    note("level_per_rate", compare_level_case(
        "per-rate, 20 states, protein main-path shape", part, ops)[1])
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
        check_counts(f"repeats {label} (2 pooled + 2 dense-fused "
                     f"evaluations)", got,
                     {"pool": 2 * pool_launches(eng_pool._ops), "fused": 2})
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
    args = level_tables(part, ops)[1]
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


def probe_checks():
    """Phase 18's correctness checks: the probe (libpll2_tpu_torch/tools/
    mxu_probe.py, csrc/mxu_probe.cu) against its plain version in every
    mode at every probe shape, 7 iterations, 8 column tiles ('split' also
    within float32-class error of the float64 product). Returns (the
    largest absolute error, 'split''s relative error against float64)."""
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
    return max_abs, split_rel


def _packed_values(packed, mode):
    """The values a `pack` output holds: float32, or bf16 as float32."""
    import torch

    if mode == "f32":
        return packed.view(torch.float32)
    bits = packed.view(torch.int16).to(torch.int32) & 0xFFFF
    return (bits << 16).view(torch.float32)


def pack_checks():
    """The probe's `pack` kernel (csrc/mxu_probe.cu) against its plain
    version (ops/_kernels.py:probe_packed) in every mode at every probe
    shape: the same bytes. Returns the largest absolute difference of the
    values they hold."""
    import torch
    from libpll2_tpu_torch.ops import _kernels
    from libpll2_tpu_torch.tools import mxu_probe as mp

    max_abs = 0.0
    for m, k, t, _, _ in mp.SHAPES:
        a, _ = mp.make(m, k, t, tiles=1, seed=2)
        for mode in mp.MODES:
            plan = _kernels.probe_plan(m, k, t, 1, mode)
            got = mp.pack(a, m, mode, t)
            want = _kernels.probe_packed(a, m, 8, plan, mode)
            err = float((_packed_values(got, mode)
                         - _packed_values(want, mode)).abs().max())
            check(torch.equal(got, want), f"mxu_probe pack {mode} [{m},{k}]"
                  f": bytes differ from its plain version (max abs err "
                  f"{err:.3e})")
            max_abs = max(max_abs, err)
    print(f"mxu_probe pack vs plain: 3 modes x {len(mp.SHAPES)} shapes, "
          f"the same bytes, max abs err {max_abs:.3e}", flush=True)
    return max_abs


def pack_times(shapes=None):
    """The `pack` kernel for each probe shape and mode: its call (CUDA
    events, median of REPS, the host's enqueue included) and its device
    time (torch.profiler), beside its plain version's call and its bound:
    A [8 m, k] read once and its 8 slices written once as laid out."""
    from libpll2_tpu_torch.ops import _kernels
    from libpll2_tpu_torch.tools import mxu_probe as mp

    rows = []
    for m, k, t, _, _ in shapes or mp.SHAPES:
        a, _ = mp.make(m, k, t, tiles=1, seed=2)
        for mode in mp.MODES:
            plan = _kernels.probe_plan(m, k, t, 1, mode)
            b = bound_ms(8 * m * k * 4 + 8 * plan.slice_bytes, 0)
            rows.append({
                "m": m, "k": k, "t": t, "mode": mode,
                "ms": median_ms(lambda: mp.pack(a, m, mode, t)),
                "device_ms": kernel_device_us(
                    lambda: mp.pack(a, m, mode, t), "pack") * 1e-3,
                "plain_ms": median_ms(lambda: _kernels.probe_packed(
                    a, m, 8, plan, mode)),
                "bound_ms": b[0], "bound_by": b[1]})
    for r in rows:
        print(f"  mxu_probe pack {r['mode']:5s} [{r['m']},{r['k']}]: "
              f"device {r['device_ms'] * 1e3:.3f} us (bound "
              f"{r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}), call "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms", flush=True)
    return rows


def _loop_spills(body):
    """Of one function's SASS [(address, instruction)]: the spill accesses
    (LDL, STL) inside the innermost loops that issue HGMMA, a loop being
    the range from a backward branch's target to the branch."""
    import re

    loops = []
    for addr, ins in body:
        m = re.search(r"\bBRA(?:\.\S+)?\s+(?:[^;]*?,\s*)?(?:`\()?0x([0-9a-f]+)",
                      ins)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = set()
    for addr, ins in body:
        if "HGMMA" in ins:
            around = [lp for lp in loops if lp[0] <= addr <= lp[1]]
            if around:
                inner.add(min(around, key=lambda lp: lp[1] - lp[0]))
    return sum(1 for addr, ins in body
               if re.search(r"\b(LDL|STL)\b", ins)
               and any(lo <= addr <= hi for lo, hi in inner)), len(inner)


def _rows_label(mangled):
    """'fused_rows_tc<20, split>' (SP, mode) or 'fused_rows<20, 2, on-chip>'
    (SP, sites a thread, plan, ', split' for the spilled 'split' body) for
    a rows kernel's mangled name, else None."""
    import re

    m = re.search(r"fused_rows_tcILi(\d+)ELb([01])E", mangled)
    if m:
        return (f"fused_rows_tc<{m.group(1)}, "
                f"{'split' if m.group(2) == '1' else 'bf16'}>")
    m = re.search(r"fused_rowsILi(\d+)ELi(\d+)ELb([01])E(?:Lb([01])E)?",
                  mangled)
    if m:
        return (f"fused_rows<{m.group(1)}, {m.group(2)}, "
                f"{'on-chip' if m.group(3) == '1' else 'spill'}"
                f"{', split' if m.group(4) == '1' else ''}>")
    return None


def rows_build_report(lib_path, require_tc=True):
    """The rows kernel's instantiations as built: registers and spills
    from the `-Xptxas -v` log, the log's wgmma serialization notes, and the
    HGMMA instructions in each one's SASS (cuobjdump). Prints them; where
    `require_tc`, fails unless every tensor-core body (fused_rows_tc)
    issues HGMMA, unserialized and without spills. Returns them as a
    dict."""
    import re
    import shutil

    out = {"kernels": {}, "serialized": [], "hgmma": {}}
    log = lib_path.with_suffix(".log")
    label = None
    for line in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            label = _rows_label(m.group(1))
            continue
        if "serialized" in line:
            m = re.search(r"function '([^']+)'", line)
            if m and _rows_label(m.group(1)):
                out["serialized"].append(_rows_label(m.group(1)))
        if label is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out["kernels"].setdefault(label, {})["spills"] = [
                int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["kernels"].setdefault(label, {})["registers"] = int(
                m.group(1))
            label = None
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    check(os.path.exists(tool), "cuobjdump (the CUDA toolkit's, beside "
          "nvcc) not found: the rows kernel's SASS cannot be read")
    sass = subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    label = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            label = _rows_label(m.group(1))
            if label:
                out["hgmma"].setdefault(label, 0)
            continue
        if label and re.search(r"\bHGMMA\b", line):
            out["hgmma"][label] += 1
    tc = sorted(k for k in out["hgmma"] if k.startswith("fused_rows_tc"))
    print(f"rows kernel build: registers and spill bytes (stores, loads) "
          f"{ {k: (v.get('registers'), v.get('spills')) for k, v in sorted(out['kernels'].items())} }; "
          f"wgmma serialized in {out['serialized'] or 'none'}; HGMMA in "
          f"the SASS {out['hgmma']}", flush=True)
    if require_tc:
        check(tc and all(out["hgmma"][k] > 0 for k in tc),
              f"a tensor-core body of the rows kernel issues no HGMMA: "
              f"{out['hgmma']}")
        check(not out["serialized"], f"wgmma serialized in "
              f"{out['serialized']}")
        spilled = [k for k in tc if any(out["kernels"].get(k, {}).get(
            "spills", [0]))]
        check(not spilled, f"the tensor-core bodies {spilled} spill")
    return out


def probe_build_report(lib_path):
    """The probe kernels as built: per kernel (probe_f32, probe_wgmma<N,
    KS, bf16 or split>) its registers and spills from the `-Xptxas -v` log,
    the log's wgmma serialization notes, and its HGMMA / FFMA / spill
    instructions in the SASS (cuobjdump, beside nvcc), with the spill
    accesses inside the innermost loops that issue HGMMA (`_loop_spills`).
    Prints a summary and returns it as a dict."""
    import re
    import shutil

    out = {"kernels": {}, "serialized": [], "sass": {}}
    log = lib_path.with_suffix(".log")
    label = None
    for line in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            label = _probe_label(m.group(1))
            continue
        if "serialized" in line:
            m = re.search(r"function '([^']+)'", line)
            if m and _probe_label(m.group(1)):
                out["serialized"].append(_probe_label(m.group(1)))
        if label is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out["kernels"].setdefault(label, {})["spills"] = [
                int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["kernels"].setdefault(label, {})["registers"] = int(
                m.group(1))
            label = None
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    check(os.path.exists(tool), "cuobjdump (the CUDA toolkit's, beside "
          "nvcc) not found: the probe's SASS cannot be read")
    sass = subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    sample, label, bodies = None, None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            label = _probe_label(m.group(1))
            continue
        if label is None:
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*)", line)
        if m:
            bodies.setdefault(label, []).append((int(m.group(1), 16),
                                                 m.group(2)))
        for op in ("HGMMA", "FFMA", "LDS.128", "LDL", "STL"):
            if re.search(rf"\b{re.escape(op)}\b", line):
                counts = out["sass"].setdefault(label, {})
                counts[op] = counts.get(op, 0) + 1
                if op == "HGMMA" and sample is None:
                    sample = f"{label}: " + line.split(";")[0].strip()
    for label, body in bodies.items():
        if label.startswith("probe_wgmma"):
            spills, loops = _loop_spills(body)
            out["sass"].setdefault(label, {}).update(
                {"hgmma_loops": loops, "spills_in_hgmma_loops": spills})
    regs = {k: v.get("registers") for k, v in out["kernels"].items()}
    spills = {k: v["spills"] for k, v in out["kernels"].items()
              if any(v.get("spills", [0]))}
    print(f"mxu_probe build: registers {regs}; spills {spills or 'none'}; "
          f"wgmma serialized in {out['serialized'] or 'none'}", flush=True)
    hg = {k: v.get("HGMMA", 0) for k, v in out["sass"].items()}
    inner = {k: (v.get("LDL", 0) + v.get("STL", 0),
                 v.get("spills_in_hgmma_loops"), v.get("hgmma_loops"))
             for k, v in out["sass"].items() if k.startswith("probe_wgmma")}
    print(f"mxu_probe SASS: HGMMA {hg}; probe_f32 "
          f"{out['sass'].get('probe_f32', {})}; e.g. {sample}", flush=True)
    print(f"mxu_probe SASS spill accesses (LDL + STL in all, inside the "
          f"innermost loops that issue HGMMA, those loops): {inner}",
          flush=True)
    out["sass_sample"] = sample
    return out


def _probe_label(mangled):
    """'probe_f32', 'probe_wgmma<80, 8, split>' (N, X's fragment k steps,
    mode) for a probe kernel's mangled name, else None."""
    import re

    if "probe_f32" in mangled:
        return "probe_f32"
    m = re.search(r"probe_wgmmaILi(\d+)ELi(\d+)ELb([01])E", mangled)
    if m:
        return (f"probe_wgmma<{m.group(1)}, {m.group(2)}, "
                f"{'split' if m.group(3) == '1' else 'bf16'}>")
    return None


def probe_bounds(m, k, t, tiles, iters):
    """Per product [m, k] @ [k, t], the least time (ms) of a probe launch
    of `iters` iterations over `tiles` column tiles, divided by its
    products, in each mode: A, X read once and out written once (float32)
    against 2 m k t FLOP a product at the mode's peak ('split': three bf16
    passes)."""
    n_prod, cols = iters * tiles, t * tiles
    n_bytes = (8 * m * k + k * cols + m * cols) * 4
    out = {}
    for mode, passes, peak in (("f32", 1, H100_F32_FLOP_PER_S),
                               ("bf16", 1, H100_BF16_FLOP_PER_S),
                               ("split", 3, H100_BF16_FLOP_PER_S)):
        b = bound_ms(n_bytes, passes * 2 * m * k * t * n_prod, peak)
        out[mode] = (b[0] / n_prod, b[1])
    return out


def probe_table_rows(gpu, reps=3):
    """The probe's table at 8 and 264 column tiles (tools/mxu_probe.py:
    probe_table; each row's bound from `probe_bounds`), printed; returns
    the rows and the launches they made."""
    import torch
    from libpll2_tpu_torch.tools import mxu_probe as mp

    has_pack = hasattr(mp, "pack")      # a checkout before `pack` has none
    mp.probe.launches = 0
    if has_pack:
        mp.pack.launches = 0
    rows = mp.probe_table(tiles=(8, 264), reps=reps)
    torch.cuda.synchronize()
    launches = mp.probe.launches
    print(f"mxu_probe table ({gpu}; per product [m,k]@[k,t] of one column "
          f"tile, beside its bound and torch.matmul's time a product):",
          flush=True)
    hi = {(m, k, t): high for m, k, t, _, high in mp.SHAPES}
    for r in rows:
        b = probe_bounds(r["m"], r["k"], r["t"], r["tiles"],
                         hi[(r["m"], r["k"], r["t"])])[r["mode"]]
        r["bound_us"] = b[0] * 1e3
        print(f"  {mp.format_row(r)}; bound {r['bound_us']:.4f} us "
              f"({r['bound_us'] / r['us']:.0%})", flush=True)
    # two trip counts a row, each a warm-up and `reps` timed launches
    check(launches == 2 * (1 + reps) * len(rows), f"{launches} probe "
          f"launches for {len(rows)} table rows")
    if has_pack:
        check(mp.pack.launches == launches, f"{mp.pack.launches} pack "
              f"launches for {launches} probe launches")
    return rows, launches


def probe_phase(gpu, lib_path):
    """Phase 18: `probe_checks` and `pack_checks`, the build's report
    (`probe_build_report`: the tensor-core modes must issue HGMMA), then
    the probe's table at 8 and 264 column tiles, its launches and its
    `pack` launches counted, and `pack`'s times at [80,80]. Returns the
    kernels-line entries of the probe and of `pack`."""
    from libpll2_tpu_torch.tools import mxu_probe as mp

    max_abs, split_rel = probe_checks()
    pack_err = pack_checks()
    build = probe_build_report(lib_path)
    wgmma = [k for k in build["sass"] if k.startswith("probe_wgmma")]
    check(len(wgmma) > 0, "no probe_wgmma kernel in the library's SASS")
    for label in wgmma:
        check(build["sass"][label].get("HGMMA", 0) > 0,
              f"{label} has no HGMMA")
    # the plain version's time per product at the yardstick shape
    a, x = mp.make(80, 80, 512, tiles=264)
    plain = {mode: median_ms(lambda: mp.probe_reference(a, x, 80, 20, mode))
             / (20 * 264) for mode in mp.MODES}
    rows, launches = probe_table_rows(gpu)
    pack_launches = mp.pack.launches
    main = {r["mode"]: r for r in rows
            if (r["m"], r["k"], r["t"], r["tiles"]) == (80, 80, 512, 264)}
    bounds = probe_bounds(80, 80, 512, 264, 500)
    packs = {r["mode"]: r for r in pack_times(((80, 80, 512, 0, 0),))}
    pack_entry = {
        "name": "mxu_probe_pack", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/mxu_probe.cu",
        "replaces": "tools/mxu_probe.py:34", "launches": pack_launches,
        "max_abs_err": pack_err, "shape": "bf16, A [8 x 80, 80], one call",
        **{k: packs["bf16"][k] for k in ("ms", "device_ms", "plain_ms",
                                         "bound_ms", "bound_by")},
        "library_ms": None,
        **{f"{mode}_{k}": packs[mode][k] for mode in ("f32", "split")
           for k in ("ms", "device_ms", "plain_ms", "bound_ms")}}
    return [{"name": "mxu_probe", "route": "cuda",
            "source": "libpll2_tpu_torch/csrc/mxu_probe.cu",
            "replaces": "tools/mxu_probe.py:34", "launches": launches,
            "max_abs_err": max_abs, "shape": "bf16 [80,80]@[80,512], 264 "
            "column tiles, per product",
            "ms": main["bf16"]["us"] * 1e-3, "plain_ms": plain["bf16"],
            "bound_ms": bounds["bf16"][0], "bound_by": bounds["bf16"][1],
            "library_ms": main["bf16"]["library_us"] * 1e-3,
            "f32_ms": main["f32"]["us"] * 1e-3,
            "f32_plain_ms": plain["f32"],
            "f32_bound_ms": bounds["f32"][0],
            "f32_library_ms": main["f32"]["library_us"] * 1e-3,
            "split_ms": main["split"]["us"] * 1e-3,
            "split_plain_ms": plain["split"],
            "split_bound_ms": bounds["split"][0],
            "split_library_ms": main["split"]["library_us"] * 1e-3,
            "split_float64_rel_err": split_rel,
            "tflops": {m: r["tflops"] for m, r in main.items()},
            "registers": {k: v.get("registers")
                          for k, v in build["kernels"].items()},
            "hgmma": {k: v.get("HGMMA", 0)
                      for k, v in build["sass"].items()}}, pack_entry]


def probe_only(gpu, lib_path):
    """`--probe-only`: phase 18's checks, the build's report and the
    probe's table of the checkout's port, and where it has `pack` (an
    older checkout lays A out inside the probe) its checks and times at
    every shape, as one dict."""
    from libpll2_tpu_torch.tools import mxu_probe as mp

    max_abs, split_rel = probe_checks()
    has_pack = hasattr(mp, "pack")
    pack_err = pack_checks() if has_pack else None
    build = probe_build_report(lib_path)
    rows, launches = probe_table_rows(gpu)
    packs = pack_times() if has_pack else []
    keep = ("m", "k", "t", "mode", "tiles", "us", "us_call", "tflops",
            "bound_us", "library_us")
    return {"max_abs_err": max_abs, "split_float64_rel_err": split_rel,
            "launches": launches, "pack_max_abs_err": pack_err,
            "pack": packs,
            "registers": {k: v.get("registers")
                          for k, v in build["kernels"].items()},
            "spills": {k: v.get("spills")
                       for k, v in build["kernels"].items()},
            "serialized": build["serialized"],
            "sass": build["sass"],
            "rows": [{key: r[key] for key in keep if key in r}
                     for r in rows]}


# phase 19: candidate scoring. Candidates held against the float64 plain
# path; the protein and repeats batches; the host clock's repetitions of a
# scoring call
CAND_F64 = 4
CAND_AA = 64
CAND_REPEATS, CAND_POOL = 64, 4
CAND_REPS = 5


def at_neighbours(tree, fn, k=None):
    """fn() at the first k (all) NNI neighbours of `tree`, each move made
    with trees/moves.py and rolled back."""
    from libpll2_tpu_torch.trees import moves

    out = []
    for h, move in moves.nni_neighbours(tree)[:k]:
        rb = moves.Rollback()
        moves.nni(h, move, rb)
        out.append(fn())
        moves.rollback_move(rb)
    return out


def candidate_objects(tree, k=None):
    """(operations, branches, pmatrix_indices, root 5-tuple) of the NNI
    neighbours, the input of evaluate_topologies."""
    from libpll2_tpu_torch.trees import create_operations, traverse

    def snapshot():
        ops, br, pidx = create_operations(traverse(tree.vroot))
        vr = tree.vroot
        return (ops, br, pidx, (vr.clv_index, vr.scaler_index,
                                vr.back.clv_index, vr.back.scaler_index,
                                vr.pmatrix_index))
    return at_neighbours(tree, snapshot, k)


def candidate_inputs(part, eng, packed):
    """The candidate form's operands for `pack_candidate` tuples: (tip
    codes, P [K, E, R, s, s], tables [K, n_ops+1, 8]) and its keywords."""
    import numpy as np
    import torch
    from libpll2_tpu_torch.ops.pmatrix import update_prob_matrices

    dev = part.device
    tables = torch.as_tensor(np.stack([q[0] for q in packed]), device=dev)
    blens = torch.as_tensor(np.stack([q[1] for q in packed]),
                            dtype=torch.float32, device=dev)
    m = eng._model_args()
    pm = update_prob_matrices(m[0], m[1], m[2], m[3], m[4], m[7],
                              blens.reshape(-1))
    pm = pm.view(len(packed), -1, *pm.shape[1:])
    kw = traversal_kw(part, eng)
    kw["n_slots"] = max(q[3] for q in packed)
    if "splits" in kw:   # the candidates' own
        from libpll2_tpu_torch.ops.fused import FusedSplits

        kw["splits"] = FusedSplits(np.stack([q[0] for q in packed]))
    return (eng._tip_codes(), pm, tables), kw


def candidate_bound(part, k, n_ops, mxu="highest"):
    """One launch of K candidates: the shared tip codes (raw tip rows) read
    once, each candidate's P and table read once and its two root CLVs and
    counts written once; K traversals' operations (`rows_bound`'s peak
    for the contraction mode `mxu`)."""
    S, R, s = part.sites_padded, part.rate_cats, part.states
    n_raw = int(part._tips_clv_set.sum())
    sc_rows = R if part.rate_scalers else 1
    n_bytes = ((part.tips - n_raw) * S * 4 + n_raw * s * S * 4
               + k * (part.prob_matrices * R * s * s * 4 + (n_ops + 1) * 32
                      + 2 * R * s * S * 4 + 2 * sc_rows * S * 4))
    return rows_bound(n_bytes, k * traversal_flops(n_ops, S, R, s), s, mxu)


def _kernels_plan(part, n_slots, k, splits=None):
    """fused_traversal.cu's plan of a launch of `k` walks; with the
    launch's `splits` (ops/fused.py:FusedSplits of its tables) the 4 x 4
    on-chip body's cluster too, as the launcher plans it."""
    from libpll2_tpu_torch.ops import _kernels

    extra = {}
    if splits is not None:
        extra["split"] = splits
    return _kernels.device_fused_plan(part.device, part.rate_cats,
                                      part.states, n_slots,
                                      part.rate_scalers, part.sites_padded,
                                      k, **extra)


def rows_plan_text(part, n_slots, k, mxu="split"):
    from libpll2_tpu_torch.ops import _kernels

    plan = _kernels.device_rows_plan(part.device, part.rate_cats,
                                     part.states, n_slots, part.rate_scalers,
                                     part.sites_padded, k, mxu=mxu)
    return (f"rows plan {plan.plan} ('{mxu}'), {plan.sites_per_thread} "
            f"site(s) a thread, {plan.smem_bytes} bytes of shared memory")


def sequential_scores(part, tree, mxu="split", k=None, **engine_kw):
    """set_topology + loglikelihood() of each of the first k NNI
    neighbours, on another engine over the same partition. Returns (scores,
    ms a candidate on the host's clock)."""
    from libpll2_tpu_torch import TreeEngine

    one = TreeEngine(part, tree, mxu=mxu, **engine_kw)
    one.loglikelihood()
    t0 = time.perf_counter()
    got = at_neighbours(tree, lambda: (one.set_topology(tree),
                                       one.loglikelihood())[1], k)
    ms = (time.perf_counter() - t0) * 1e3 / len(got)
    one.set_topology(tree)
    return got, ms


def check_scores(what, got, want, tol=TOL_LOGL):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape and bool(np.isfinite(got).all()),
          f"{what}: {got.shape} scores, {want.shape} expected, or not "
          f"finite")
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    check(rel < tol, f"{what}: max rel err {rel:.3e} >= {tol}")
    return rel


def candidate_f64(part, eng, packed):
    """logL of packed candidates through the plain traversal in float64 on
    the card."""
    import numpy as np
    import torch
    from libpll2_tpu_torch import constants as C
    from libpll2_tpu_torch.engine import _fused_multi_topology
    from libpll2_tpu_torch.ops.fused import fused_traversal_reference

    f64, dev = torch.float64, part.device
    model = [torch.tensor(a, dtype=f64, device=dev) for a in (
        part.eigenvals, part.inv_eigenvecs, part.eigenvecs, part.prop_invar,
        part.rates, part.rate_weights, part.frequencies)]
    pw, inv = eng._site_args()
    total = _fused_multi_topology(
        *model, eng.params_idx_rates, torch.as_tensor(
            [list(q[1]) for q in packed], dtype=f64, device=dev),
        torch.as_tensor(np.stack([q[0] for q in packed]), device=dev),
        eng._tip_codes(), torch.as_tensor([q[2][4] for q in packed],
                                          device=dev), pw, inv,
        max(q[3] for q in packed), C.SCALE_THRESHOLD, C.SCALE_FACTOR,
        traversal=fused_traversal_reference, **eng._fused_kw())
    return total.cpu().numpy()


def candidate_kernel(label, part, eng, packed, gpu, mxu="split"):
    """One chunk of K candidates, at the main path's own K, through the
    candidate form's kernel (one launch) and its plain version on the same
    inputs: counts equal but at ties, CLVs within TOL_CLV of each site's
    max ('highest', and 'split' below 16 states; the rows kernel's 'split'
    to `mode_tolerances`); in 'bf16' the K logLs within TOL_BF16_LOGL.
    Then the kernel's call (CUDA events, median of REPS) and device time
    (torch.profiler, median of 5) beside the bound, and the plain
    version's call (once). None of these launches is the path's. Returns
    {max_abs_err (of the logLs in 'bf16'), ms, plain_ms, device_ms,
    bound}."""
    import torch
    from libpll2_tpu_torch.engine import _fused_multi_topology
    from libpll2_tpu_torch.ops import fused

    args, kw = candidate_inputs(part, eng, packed)
    k, n_ops = len(packed), args[2].shape[1] - 1
    if part.states < 16:
        plan = plan_text(_kernels_plan(part, kw["n_slots"], k,
                                       kw.get("splits")))
    else:
        plan = rows_plan_text(part, kw["n_slots"], k, mxu)
    plain_ms = []

    def plain(*a, **k_):
        """The plain version, its call timed once by CUDA events."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fused.fused_traversal_reference(*a, **k_)
        end.record()
        end.synchronize()
        plain_ms.append(start.elapsed_time(end))
        return out

    if mxu == "bf16":
        m, (pw, inv) = eng._model_args(), eng._site_args()
        margs = (*m, torch.as_tensor(
            [list(q[1]) for q in packed], dtype=torch.float32,
            device=part.device), args[2], args[0],
            torch.as_tensor([q[2][4] for q in packed], device=part.device),
            pw, inv, kw["n_slots"], part.scale_threshold, part.scale_factor)
        lk = [_fused_multi_topology(*margs, traversal=t, mxu=mxu,
                                    **eng._fused_kw()).double()
              for t in (fused.fused_traversal, plain)]
        rel = float(((lk[0] - lk[1]).abs() / lk[1].abs()).max())
        err = float((lk[0] - lk[1]).abs().max())
        agree = f"'bf16', logL max rel err {rel:.3e}"
        tol = TOL_BF16_LOGL
    else:
        got = fused.fused_traversal(*args, mxu=mxu, **kw)
        want = plain(*args, mxu=mxu, **kw)

        def block(e):
            """`match_counts`' block of a count entry: (candidate, site) or
            (candidate, rate, site)."""
            if part.rate_scalers:
                return (e[0], e[1], slice(None), e[2])
            return (e[0], slice(None), slice(None), e[1])

        tol, tie_tol = mode_tolerances(part.states, mxu)
        ties = sum(match_counts(f"{label}, {which}", g_sc, w_sc, g_clv,
                                w_clv, block, part.scale_factor,
                                part.scale_threshold, tol, tie_tol)
                   for g_sc, w_sc, g_clv, w_clv, which in (
                       (got[2], want[2], got[0], want[0], "parent"),
                       (got[3], want[3], got[1], want[1], "child")))
        rel = err = 0.0
        for g, w in zip(got[:2], want[:2]):
            check(bool(torch.isfinite(g).all()), f"{label}: non-finite CLVs")
            site_max = w.abs().amax(dim=(1, 2)).clamp(min=1e-30)
            rel = max(rel, float(((g - w).abs()
                                  / site_max[:, None, None]).max()))
            err = max(err, float((g - w).abs().max()))
        agree = (f"scaler counts equal{f' ({ties} ties)' if ties else ''}, "
                 f"max_rel_err {rel:.3e}, max_abs_err {err:.3e}")
    print(f"candidate kernel vs plain [{label}, {mxu}]: {k} candidates in "
          f"one launch, {part.tips} taxa x {part.sites} sites, {plan}: "
          f"{agree}", flush=True)
    check(rel <= tol, f"{label} '{mxu}': {k} candidates, max rel err "
          f"{rel:.3e} > {tol}")
    ms = median_ms(lambda: fused.fused_traversal(*args, mxu=mxu, **kw))
    name = "fused_rows" if part.states >= 16 else "fused_"
    dev = kernel_device_us(lambda: fused.fused_traversal(
        *args, mxu=mxu, **kw), name) * 1e-3
    bound = candidate_bound(part, k, n_ops, mxu)
    print(f"candidate kernel times [{label}, {mxu}] ({gpu}): {k} candidates "
          f"of {n_ops} ops in one launch: call {ms:.4f} ms, device "
          f"{dev * 1e3:.1f} us ({dev * 1e3 / k:.2f} us a candidate, "
          f"{dev * 1e3 / (k * n_ops):.3f} us a candidate op), bound "
          f"{bound[0]:.4f} ms by {bound[1]}, plain {plain_ms[0]:.4f} ms "
          f"(once)", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms[0],
            "device_ms": dev, "bound": bound}


def dna_candidates(device, big, big_by, gpu):
    """Phase 19, DNA 128 x 16384: the full NNI neighbourhood through the
    three entry points (launches counted), each score against its
    candidate's set_topology + loglikelihood() on the card, a few against
    the float64 plain path, a chunk's kernel against its plain version,
    and the times."""
    import numpy as np
    import torch
    from libpll2_tpu_torch.engine import CANDIDATE_CHUNK
    from libpll2_tpu_torch.ops import fused

    part, eng = build_engine(big, big_by, N_SITES, device)
    base = eng.loglikelihood()
    cands = candidate_objects(big)
    packed = at_neighbours(big, lambda: eng.pack_candidate(big.vroot))
    k = len(cands)
    check(all(q is not None for q in packed), "pack_candidate refused an "
          "NNI neighbour")
    arrays = (np.stack([q[0] for q in packed]),
              np.stack([q[1] for q in packed]),
              np.asarray([q[2] for q in packed]), max(q[3] for q in packed))
    reset_counts()
    scores = eng.evaluate_topologies(cands)
    s_packed = eng.evaluate_packed(packed)
    s_arrays = eng.evaluate_packed_arrays(*arrays)
    torch.cuda.synchronize()
    got = counts()
    chunks = -(-k // CANDIDATE_CHUNK)
    check_counts(f"candidate scoring, DNA {N_TAXA} x {N_SITES}, {k} "
                 f"candidates through 3 entry points", got,
                 {"fused": 3 * chunks})
    launches = got["fused"]
    check(eng.loglikelihood() == base, "scoring changed the engine's logL")
    seq, seq_ms = sequential_scores(part, big)
    rel = check_scores("evaluate_topologies vs set_topology + "
                       "loglikelihood()", scores, seq)
    check_scores("evaluate_packed vs evaluate_topologies", s_packed, scores,
                 1e-6)
    check_scores("evaluate_packed_arrays vs evaluate_topologies", s_arrays,
                 scores, 1e-6)
    ref = candidate_f64(part, eng, packed[:CAND_F64])
    rel64 = check_scores("the first candidates vs the float64 plain path",
                         scores[:CAND_F64], ref)
    print(f"candidate scoring, DNA {N_TAXA} x {N_SITES} (the full NNI "
          f"neighbourhood, {k} candidates, {chunks} chunks): scores vs "
          f"set_topology + loglikelihood() max rel err {rel:.3e}, vs the "
          f"float64 plain path ({CAND_F64}) {rel64:.3e}; packed and arrays "
          f"entry points agree; best {float(scores.max())!r} against the "
          f"tree's {base!r}", flush=True)
    chunk = packed[:CANDIDATE_CHUNK]
    kt = candidate_kernel("DNA, a chunk", part, eng, chunk, gpu)
    # the host's share: packing a candidate for each entry point (a sweep
    # over the neighbourhood, median of CAND_REPS), then each call
    pack_ms, cand_ms, stack_ms = (host_ms(fn, CAND_REPS)[1] / k for fn in (
        lambda: [fused.pack_fused_schedule(c[0], part.tips,
                                           (c[3][0], c[3][2]))
                 for c in cands],
        lambda: [eng.pack_candidate(big.vroot) for _ in range(k)],
        lambda: (np.stack([q[0] for q in packed]),
                 np.stack([q[1] for q in packed]),
                 np.asarray([q[2] for q in packed]))))
    calls = {n: host_ms(fn, CAND_REPS)[1] for n, fn in (
        ("evaluate_topologies", lambda: eng.evaluate_topologies(cands)),
        ("evaluate_packed", lambda: eng.evaluate_packed(packed)),
        ("evaluate_packed_arrays",
         lambda: eng.evaluate_packed_arrays(*arrays)))}
    print(f"candidate scoring times, DNA ({gpu}): host packing a candidate "
          f"(a sweep of {k}, median of {CAND_REPS}): pack_fused_schedule "
          f"{pack_ms:.4f} ms "
          f"(evaluate_topologies), pack_candidate {cand_ms:.4f} ms "
          f"(evaluate_packed), np.stack {stack_ms:.5f} ms "
          f"(evaluate_packed_arrays); calls of {k} candidates (host clock, "
          f"median of {CAND_REPS}): "
          + ", ".join(f"{n} {v:.3f} ms ({k / v * 1e3:.0f} candidates/s)"
                      for n, v in calls.items())
          + f"; {k} x set_topology + loglikelihood() {seq_ms:.4f} ms a "
          f"candidate ({1e3 / seq_ms:.0f} candidates/s)", flush=True)
    return {"launches": launches, "k": k, "chunk": len(chunk), **kt,
            "pack_ms": pack_ms, "pack_candidate_ms": cand_ms, "stack_ms": stack_ms,
            "calls_ms": calls, "sequential_ms": seq_ms}


def protein_candidates(device, aa_tree, aa_by, gpu):
    """Phase 19, protein 128 x 8192 LG+G4: CAND_AA candidates through
    evaluate_topologies in 'split' and 'bf16' (one launch each), each
    score against its set_topology + loglikelihood() in the same mode, a
    sample's kernel against its plain version, and the times."""
    from libpll2_tpu_torch import TreeEngine

    part = protein_partition(aa_tree, aa_by, AA_SITES, device)
    cands = candidate_objects(aa_tree, CAND_AA)
    out = {}
    for mxu in ("split", "bf16"):
        eng = TreeEngine(part, aa_tree, mxu=mxu)
        packed = at_neighbours(aa_tree, lambda: eng.pack_candidate(
            aa_tree.vroot), CAND_AA)
        reset_counts()
        t0 = time.perf_counter()
        scores = eng.evaluate_topologies(cands)
        call = (time.perf_counter() - t0) * 1e3
        got = counts()
        check_counts(f"candidate scoring, protein '{mxu}', {CAND_AA} "
                     f"candidates", got, {"rows": 1})
        seq, seq_ms = sequential_scores(part, aa_tree, mxu, CAND_AA)
        rel = check_scores(f"protein '{mxu}' evaluate_topologies vs "
                           f"set_topology + loglikelihood()", scores, seq)
        kt = candidate_kernel("protein", part, eng, packed, gpu, mxu)
        calls = host_ms(lambda: eng.evaluate_topologies(cands), CAND_REPS)[1]
        print(f"candidate scoring, protein {AA_TAXA} x {AA_SITES} '{mxu}' "
              f"({gpu}): {CAND_AA} candidates in one launch, scores vs "
              f"set_topology + loglikelihood() max rel err {rel:.3e}; "
              f"evaluate_topologies {calls:.3f} ms ({CAND_AA / calls * 1e3:.0f}"
              f" candidates/s; first call {call:.3f} ms), "
              f"set_topology + loglikelihood() {seq_ms:.4f} ms a candidate",
              flush=True)
        out[mxu] = {"launches": got["rows"], **kt,
                    "call_ms": calls, "sequential_ms": seq_ms}
    return out


def repeats_candidates(device, rep_tree, rep_make, gpu):
    """Phase 19, repeats 246 x 4465: CAND_REPEATS candidates on
    'repeats-dense-fused' (one launch of the fused kernel, its call and
    device time a chunk) and CAND_POOL on 'pool-pallas' (one pool-kernel
    dispatch each, the class schedule packed on the host for each), each
    against its set_topology + loglikelihood()."""
    from libpll2_tpu_torch import TreeEngine

    out, dev_times = {}, None
    for path, k, kw, want in (
            ("repeats-dense-fused", CAND_REPEATS, {}, {"fused": 1}),
            ("pool-pallas", CAND_POOL, {"pallas": "pool"},
             {"pool": CAND_POOL})):
        part = rep_make(device)
        eng = TreeEngine(part, rep_tree, **kw)
        check(eng.execution_path == path, f"execution_path is "
              f"{eng.execution_path!r}, expected {path!r}")
        base = eng.loglikelihood()
        cands = candidate_objects(rep_tree, k)
        reset_counts()
        t0 = time.perf_counter()
        scores = eng.evaluate_topologies(cands)
        call = (time.perf_counter() - t0) * 1e3
        got = counts()
        check_counts(f"candidate scoring, repeats {REP_TAXA} x {REP_SITES} "
                     f"'{path}', {k} candidates", got, want)
        check(eng.loglikelihood() == base,
              f"scoring on '{path}' changed the engine's logL")
        seq, seq_ms = sequential_scores(part, rep_tree, k=k, **kw)
        rel = check_scores(f"repeats '{path}' evaluate_topologies vs "
                           f"set_topology + loglikelihood()", scores, seq)
        if eng.use_fused:
            dev_times = candidate_kernel(
                "repeats", part, eng, at_neighbours(
                    rep_tree, lambda: eng.pack_candidate(rep_tree.vroot), k),
                gpu)
        print(f"candidate scoring, repeats {REP_TAXA} x {REP_SITES} "
              f"'{path}' ({gpu}): {k} candidates, launches {got}, scores vs "
              f"set_topology + loglikelihood() max rel err {rel:.3e}; "
              f"evaluate_topologies {call:.3f} ms ({call / k:.3f} ms a "
              f"candidate, the host's class schedule included), "
              f"set_topology + loglikelihood() {seq_ms:.4f} ms a candidate",
              flush=True)
        out[path] = {"launches": sum(got.values()), "call_ms": call,
                     "sequential_ms": seq_ms, "k": k}
    return out, dev_times


# phase 20: topology search. The DNA problem's alignment is simulated on its
# tree and the search starts SEARCH_MOVES (NNI, SPR) seeded moves away from
# it; the rounds' radius and iteration cap; SPR candidates held against
# set_topology + loglikelihood() (a seeded sample and the best), and those
# held against the float64 plain path on the CPU
SEARCH_MOVES = (3, 2)
SEARCH_RADIUS = 5
SEARCH_CAP = 10
SEARCH_SAMPLE, SEARCH_TOP, SEARCH_F64 = 64, 8, 4


class _OneIteration(Exception):
    """Ends a round after its first iteration (`RoundLog(stop=True)`)."""


class RoundLog:
    """Per-iteration record of one streamed round of `search`, taken by
    wrapping its schedule build, scoring and verification on the instance:
    candidates, schedule ms (the native builder), n_aux / n_arows / the
    extended buffers' MB, the level kernel's launches and the passes'
    device us (torch.profiler, over the same scoring run again, its
    launches not counted), scoring ms, verify ms and logL. `first(scheds,
    scores)` runs on the first iteration's schedule and scores before the
    round uses them. A round that needs more than SEARCH_CAP iterations
    fails; with `stop` the round ends after its first (`run`)."""

    def __init__(self, label, search, kind, first=None, stop=False):
        import torch
        from libpll2_tpu_torch.ops import levels

        self.label, self.iters = label, []
        build = search._stream_schedules
        score = getattr(search, f"_summed_{kind}_scores")
        verify = search.evaluate

        def schedules(*a, **k):
            self._report()
            if stop and self.iters:
                raise _OneIteration
            check(len(self.iters) < SEARCH_CAP, f"{label}: no convergence "
                  f"in {SEARCH_CAP} iterations")
            t0 = time.perf_counter()
            out = build(*a, **k)
            ms = (time.perf_counter() - t0) * 1e3
            sched = next(iter(out.values()))
            p = search._engine.partition
            n_a = int(sched.a_valid.sum())
            rows = search._n_rows(p) + sched.n_aux + n_a
            sc_rows = p.scale_buffers + sched.n_aux + n_a + 2
            block = p.rate_cats * p.states * p.sites_padded * 4
            sc_block = (p.rate_cats if p.rate_scalers else 1) \
                * p.sites_padded * 4
            self.iters.append({
                "candidates": sched.n_candidates, "schedule_ms": ms,
                "n_aux": sched.n_aux, "n_arows": sched.n_arows, "a_rows": n_a,
                "ext_mb": (rows * block + sc_rows * sc_block) / 1e6,
                "verify_ms": 0.0, "evaluations": 0, "logl": None})
            return out

        def scores(scheds, chunk):
            rec = self.iters[-1]
            torch.cuda.synchronize()
            n0 = levels.level_update.launches
            t0 = time.perf_counter()
            out = score(scheds, chunk)
            torch.cuda.synchronize()
            rec["score_ms"] = (time.perf_counter() - t0) * 1e3
            rec["launches"] = levels.level_update.launches - n0
            rec["pass_us"] = sum(launches_device_us(
                lambda: score(scheds, chunk), "level_", rec["launches"],
                reps=1))
            levels.level_update.launches = n0 + rec["launches"]
            if first is not None and len(self.iters) == 1:
                first(scheds, out)
            return out

        def evaluate():
            rec = self.iters[-1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lk = verify()
            rec["verify_ms"] += (time.perf_counter() - t0) * 1e3
            rec["evaluations"] += 1
            rec["logl"] = lk if rec["logl"] is None else max(rec["logl"], lk)
            return lk

        self.wrapped = {"_stream_schedules": schedules,
                        f"_summed_{kind}_scores": scores,
                        "evaluate": evaluate}
        self.search, self._printed = search, 0

    def _report(self):
        for i in range(self._printed, len(self.iters)):
            r = self.iters[i]
            print(f"  {self.label} iteration {i + 1}: {r['candidates']} "
                  f"candidates, schedule {r['schedule_ms']:.3f} ms (native "
                  f"builder), n_aux {r['n_aux']}, n_arows {r['n_arows']} "
                  f"({r['a_rows']} A rows), extended buffers "
                  f"{r['ext_mb']:.1f} MB; level kernel {r['launches']} "
                  f"launches, passes {r['pass_us']:.1f} us of device time; "
                  f"scoring {r['score_ms']:.3f} ms, verify "
                  f"{r['verify_ms']:.3f} ms ({r['evaluations']} "
                  f"evaluations), best verified logL {r['logl']!r}",
                  flush=True)
        self._printed = len(self.iters)

    def run(self, fn):
        """fn() (the round) with the search's methods wrapped: its result
        and host ms; (None, ms) when `stop` ended it."""
        vars(self.search).update(self.wrapped)
        t0 = time.perf_counter()
        try:
            out = fn()
        except _OneIteration:
            out = None
        finally:
            for name in self.wrapped:
                vars(self.search).pop(name)
        ms = (time.perf_counter() - t0) * 1e3
        self._report()
        return out, ms

    def own_ms(self) -> float:
        """The round's own host ms: its iterations' schedule builds,
        scoring and verification, without the checks and the profiled
        replays."""
        return sum(r["schedule_ms"] + r["score_ms"] + r["verify_ms"]
                   for r in self.iters)


def search_start(seed=SEED):
    """Phase 20's DNA problem: the tree (random_utree, seed 7), the
    alignment simulated on it under dna_model()'s GTR and Gamma(0.8) x 4,
    and the tree after SEARCH_MOVES seeded NNI and SPR moves (within
    SEARCH_RADIUS). Returns (start tree, the tree after the NNI moves
    alone, {label: sequence})."""
    import numpy as np
    from libpll2_tpu_torch import constants as PC
    from libpll2_tpu_torch.search import _internal_edges, _radius_targets
    from libpll2_tpu_torch.trees import moves, random_utree
    from libpll2_tpu_torch.trees.utils import utree_clone
    from libpll2_tpu_torch.utils import simulate_alignment

    tree = random_utree([f"t{i}" for i in range(N_TAXA)], seed=seed)
    freqs, subst = dna_model()
    headers, seqs = simulate_alignment(tree, N_SITES, freqs, subst,
                                       alpha=0.8, seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(SEARCH_MOVES[0]):
        edges = _internal_edges(tree)
        moves.nni(edges[rng.integers(len(edges))], PC.UTREE_MOVE_NNI_LEFT,
                  None)
    nni_start = utree_clone(tree)
    for _ in range(SEARCH_MOVES[1]):
        edges = _internal_edges(tree)
        p = edges[rng.integers(len(edges))]
        targets = _radius_targets(p, SEARCH_RADIUS)
        moves.spr(p, targets[rng.integers(len(targets))], None, safe=True)
    return tree, nni_start, dict(zip(headers, seqs))


def full_scores(eng, tree, moved, cands):
    """set_topology + loglikelihood() of `eng` at each candidate of
    `cands`, each applied by `moved(c)` (a context manager) on `tree`."""
    out = []
    for c in cands:
        with moved(c):
            eng.set_topology(tree)
            out.append(eng.loglikelihood())
    return out


@contextlib.contextmanager
def nni_moved(c):
    """An NNI candidate (edge, kind) applied, then undone (an
    involution)."""
    from libpll2_tpu_torch.trees import moves

    moves.nni(c[0], c[1], None)
    try:
        yield
    finally:
        moves.nni(c[0], c[1], None)


@contextlib.contextmanager
def spr_moved(c):
    """An SPR candidate (prune, target) applied, then rolled back."""
    from libpll2_tpu_torch.trees import moves

    rb = moves.Rollback()
    moves.spr(c[0], c[1], rb, safe=True)
    try:
        yield
    finally:
        moves.rollback_move(rb)


def stream_pass_case(label, search, sched, kind, gpu):
    """The streamed passes of one schedule through the level kernel (post
    and up for `kind` "nni"; post, up and A over [E + merged] P-matrices
    for "spr"),
    then each of its level tables again through the plain version on the
    card, in order, from the kernel's own rows of the waves before it (so
    that a rescale tie does not carry into later waves; the kernel's rows
    are put back after each): scaler rows of every op equal but at ties
    (`match_counts`), its CLV rows within TOL_CLV of each site's max, the
    zero row untouched. None of these launches is counted. Then the
    passes' call time (the kernel over all the level tables again, CUDA
    events; the plain version's waves once) and the bound: every row read
    and not written and every row written, once, with P and the tables,
    or the ops' FLOPs. Returns {max_abs_err, ms, plain_ms, bound, ops,
    levels}."""
    import torch
    from libpll2_tpu_torch.ops import levels, spr_stream
    from libpll2_tpu_torch.ops.pmatrix import update_prob_matrices

    ue = search._engine
    p = ue.partition
    m = ue._model_args()
    clv_arg, sc_arg, base = search._stream_base(p)

    def pm(lengths):
        return update_prob_matrices(m[0], m[1], m[2], m[3], m[4], m[7],
                                    torch.as_tensor(lengths, device=p.device))

    passes = [(sched.post_table, sched.post_valid),
              (sched.up_table, sched.up_valid)]
    pm_ext = pm(sched.blen_full)
    if kind == "spr":
        passes.append((sched.a_table, sched.a_valid))
        pm_ext = torch.cat([pm_ext, pm(sched.merged_len)])
    n0 = levels.level_update.launches
    got = spr_stream.stream_passes(
        clv_arg, sc_arg, pm_ext, passes, sched.n_aux, sched.n_arows, p.scale_threshold, p.scale_factor,
        base=base, rate_scalers=p.rate_scalers)
    torch.cuda.synchronize()
    check(not bool(got.scaler[got.zero].any()),
          f"{label}: the zero scaler row was written")
    n, R, s, S = got.clv.shape
    clv2d = got.clv.view(n, R * s, S)
    ties, rel, err, scaled, plain_ms = 0, 0.0, 0.0, 0, 0.0
    for t in got.tables:
        tl = t.long()
        parent, psc = tl[0], tl[7][tl[8] > 0]
        k_clv, k_sc = got.clv[parent], got.scaler[psc]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        levels.level_update_reference(clv2d, got.scaler, pm_ext, t, R, s,
                                      p.scale_threshold, p.scale_factor)
        end.record()
        end.synchronize()
        plain_ms += start.elapsed_time(end)
        w_clv, w_sc = got.clv[parent], got.scaler[psc]
        rows = torch.nonzero(tl[8] > 0)[:, 0].tolist()
        if p.rate_scalers:
            def block(e, rows=rows):
                return rows[e[0]], e[1], slice(None), e[2]
        else:
            def block(e, rows=rows):
                return rows[e[0]], slice(None), slice(None), e[1]
        ties += match_counts(label, k_sc, w_sc, k_clv, w_clv, block,
                             p.scale_factor, p.scale_threshold)
        check(bool(torch.isfinite(k_clv).all()), f"{label}: non-finite CLVs")
        e = (k_clv - w_clv).abs()
        site_max = w_clv.abs().amax(dim=(1, 2), keepdim=True).clamp(
            min=1e-30)
        rel = max(rel, float((e / site_max).max()))
        err = max(err, float(e.max()))
        scaled = max(scaled, int(k_sc.max()) if k_sc.numel() else 0)
        got.clv[parent] = k_clv
        got.scaler[psc] = k_sc
    n_ops, n_levels = sum(t.shape[1] for t in got.tables), len(got.tables)
    print(f"level kernel vs plain [{label}, the streamed {kind.upper()} "
          f"passes]: {n_ops} ops in {n_levels} level tables ("
          + ("post, up and A" if kind == "spr" else "post and up")
          + " waves), "
          f"{p.tips} taxa x {p.sites} sites: scaler rows equal (max "
          f"{scaled}" + (f"; {ties} ties" if ties else "") + f"), "
          f"max_rel_err {rel:.3e}, max_abs_err {err:.3e}", flush=True)
    check(rel <= TOL_CLV, f"{label}: passes max_rel_err {rel:.3e} > "
          f"{TOL_CLV}")
    rerun = (got.clv, got.scaler, pm_ext, got.tables, p.scale_threshold,
             p.scale_factor)
    ms = median_ms(lambda: levels.update_partials_kernel(*rerun))
    levels.level_update.launches = n0
    tables = torch.cat(list(got.tables), dim=1).cpu().numpy()
    written = set(tables[0].tolist())
    read = set(tables[1].tolist()) | set(tables[2].tolist())
    sc_w = set(tables[7][tables[8] > 0].tolist())
    sc_r = (set(tables[5].tolist()) | set(tables[6].tolist())) - {got.zero}
    n_bytes = ((len(read - written) + len(written)) * R * s * S * 4
               + (len(sc_r - sc_w) + len(sc_w))
               * (R if p.rate_scalers else 1) * S * 4
               + pm_ext.numel() * 4 + tables.size * 4)
    bound = bound_ms(n_bytes, traversal_flops(n_ops, S, R, s))
    print(f"streamed {kind.upper()} passes times [{label}] ({gpu}): "
          f"{n_ops} ops in "
          f"{n_levels} launches: kernel {ms:.4f} ms (CUDA events, "
          f"median of {REPS}), plain {plain_ms:.4f} ms (once, wave by "
          f"wave); bound {bound[0]:.4f} ms by {bound[1]} "
          f"({n_bytes / 1e9:.3f} GB)", flush=True)
    del got
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound": bound, "ops": n_ops, "levels": n_levels}


def dna_search(device, gpu):
    """Phase 20 A: streamed SPR and NNI rounds to convergence on the DNA
    main path ('fused'), each on its own copy of its start (the SPR rounds
    all SEARCH_MOVES away, the NNI ones the NNI moves alone: from the whole
    start NNI climbs past SEARCH_CAP iterations), the first iterations'
    scores against full evaluations (and the float64 plain path), the
    passes against their plain version, the batched twins from the same
    starts, and run()."""
    import numpy as np
    import torch
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.engine import CANDIDATE_CHUNK
    from libpll2_tpu_torch.search import TreeSearch
    from libpll2_tpu_torch.trees.utils import utree_clone

    start, nni_start, by = search_start()
    starts = {"spr": start, "nni": nni_start}
    part = dna_partition(start, by, N_SITES, device)
    p64 = dna_partition(start, by, N_SITES, "cpu", dtype=torch.float64)
    label = f"DNA {N_TAXA} x {N_SITES}"
    out = {"label": label}

    def spr_first(s, tree, check_eng, eng64, scheds, scores):
        sched = next(iter(scheds.values()))
        n = sched.n_candidates
        rng = np.random.default_rng(SEED)
        idx = sorted(set(rng.choice(n, SEARCH_SAMPLE, replace=False)
                         .tolist()) | set(np.argsort(-scores)[:SEARCH_TOP]
                                          .tolist()))
        cands = [sched.pairs[i] for i in idx]
        rel = check_scores(f"{label} SPR: streamed vs set_topology + "
                           f"loglikelihood()", scores[idx],
                           full_scores(check_eng, tree, spr_moved, cands))
        rel64 = check_scores(
            f"{label} SPR: streamed vs the float64 plain path",
            scores[idx][:SEARCH_F64],
            full_scores(eng64, tree, spr_moved, cands[:SEARCH_F64]))
        print(f"  {label} SPR, first iteration: {len(idx)} of {n} streamed "
              f"scores ({SEARCH_SAMPLE} seeded, the best {SEARCH_TOP}) vs "
              f"set_topology + loglikelihood() max rel err {rel:.3e}, "
              f"{SEARCH_F64} vs the float64 plain path {rel64:.3e}",
              flush=True)
        out["spr_max_rel"], out["spr_max_rel_f64"] = rel, rel64
        out["passes"] = stream_pass_case(label, s, sched, "spr", gpu)

    def nni_first(s, tree, check_eng, eng64, scheds, scores):
        sched = next(iter(scheds.values()))
        cands = list(sched.pairs)
        rel = check_scores(f"{label} NNI: streamed vs set_topology + "
                           f"loglikelihood()", scores,
                           full_scores(check_eng, tree, nni_moved, cands))
        rel64 = check_scores(
            f"{label} NNI: streamed vs the float64 plain path",
            scores[:SEARCH_F64],
            full_scores(eng64, tree, nni_moved, cands[:SEARCH_F64]))
        print(f"  {label} NNI, first iteration: all {len(cands)} streamed "
              f"scores vs set_topology + loglikelihood() max rel err "
              f"{rel:.3e}, {SEARCH_F64} vs the float64 plain path "
              f"{rel64:.3e}", flush=True)
        out["nni_max_rel"], out["nni_max_rel_f64"] = rel, rel64

    streamed = {}
    for kind, first in (("spr", spr_first), ("nni", nni_first)):
        tree = utree_clone(starts[kind])
        s = TreeSearch(part, tree)
        ctx = (s, tree, TreeEngine(part, tree), TreeEngine(p64, tree))
        fn = (s.nni_round_streamed if kind == "nni" else
              lambda s=s: s.spr_round_streamed(radius=SEARCH_RADIUS))
        log = RoundLog(f"{label} {kind.upper()}", s, kind,
                       lambda scheds, scores, first=first, ctx=ctx:
                       first(*ctx, scheds, scores))
        (best, acc), ms = log.run(fn)
        streamed[kind] = (best, acc)
        own = log.own_ms()
        print(f"search [{label}, streamed {kind.upper()}"
              + (f", radius {SEARCH_RADIUS}" if kind == "spr" else "")
              + f", {SEARCH_MOVES[0] if kind == 'nni' else sum(SEARCH_MOVES)}"
              f" moves away] ({gpu}): {acc} moves accepted in "
              f"{len(log.iters)} iterations, logL {best!r}; {own:.1f} ms of "
              f"schedules, scoring and verification ({ms:.1f} ms with the "
              f"checks)", flush=True)
        out[kind] = {"accepted": acc, "logl": best, "ms": own,
                     "ms_with_checks": ms, "iterations": log.iters}
    out["pass_device_ms"] = out["spr"]["iterations"][0]["pass_us"] * 1e-3

    # the batched twins, each on its own copy of its streamed twin's start
    reset, py_us = counts()["fused"], None
    for kind in ("spr", "nni"):
        s2 = TreeSearch(part, utree_clone(starts[kind]))
        native_ms, cands = [], []

        def native(moves_list, built=s2._native_candidates):
            t0 = time.perf_counter()
            res = built(moves_list)
            native_ms.append((time.perf_counter() - t0) * 1e3)
            check(res is not None, "the native candidate builder declined")
            cands.append(len(res[0]))
            return res

        s2._native_candidates = native
        s2._ensure_engine()
        if py_us is None:
            py_us = python_pack_us(s2)
        fn = (s2.nni_round_batched if kind == "nni" else
              lambda: s2.spr_round_batched(radius=SEARCH_RADIUS))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best, acc = fn()
        ms = (time.perf_counter() - t0) * 1e3
        us = sum(native_ms) * 1e3 / max(sum(cands), 1)
        print(f"search [{label}, batched {kind.upper()}, the same start] "
              f"({gpu}): {acc} moves accepted, logL {best!r}, {ms:.1f} ms; "
              f"{sum(cands)} candidates in {len(cands)} iterations "
              f"({sum(cands) / ms * 1e3:.0f} candidates/s); the native "
              f"builder {us:.3f} us a candidate on the host, the Python "
              f"walk it replaces {py_us:.3f} us (apply, pack_candidate, "
              f"roll back)", flush=True)
        sb, sa = streamed[kind]
        check(acc == sa, f"{label} {kind}: batched accepted {acc} moves, "
              f"streamed {sa}")
        rel = abs(best - sb) / abs(sb)
        check(rel < TOL_LOGL, f"{label} {kind}: batched logL {best!r} vs "
              f"streamed {sb!r}, rel {rel:.3e}")
        out[f"batched_{kind}"] = {
            "accepted": acc, "logl": best, "ms": ms,
            "candidates": sum(cands), "iterations": len(cands),
            "native_us_per_candidate": us, "python_us_per_candidate": py_us,
            "chunks": sum(-(-k // CANDIDATE_CHUNK) for k in cands)}
    check(streamed["nni"][1] > 0, f"{label}: the NNI rounds accepted no "
          f"move")
    out["batched_launches"] = counts()["fused"] - reset
    s3 = TreeSearch(part, utree_clone(start))
    lk0 = s3.evaluate()
    t0 = time.perf_counter()
    lk = s3.run(max_rounds=1, use_spr=False)
    ms = (time.perf_counter() - t0) * 1e3
    check(np.isfinite(lk) and lk >= lk0, f"run(): {lk!r} from {lk0!r}")
    print(f"search [{label}, TreeSearch.run(max_rounds=1, use_spr=False)] "
          f"({gpu}): logL {lk0!r} -> {lk!r}, {ms:.1f} ms", flush=True)
    out["run"] = {"logl": lk, "ms": ms}
    del p64
    return out


def python_pack_us(search, k=256):
    """Host us a candidate of the Python walk that the native builder
    replaces (apply the SPR, `pack_candidate`, roll back), over the first
    `k` radius-SEARCH_RADIUS moves of the search's tree."""
    from libpll2_tpu_torch.search import _internal_edges, _radius_targets
    from libpll2_tpu_torch.trees import moves

    tree, eng = search.tree, search._engine
    pairs = [(p, r) for p in _internal_edges(tree)
             for r in _radius_targets(p, SEARCH_RADIUS)][:k]
    t0 = time.perf_counter()
    for p, r in pairs:
        rb = moves.Rollback()
        moves.spr(p, r, rb, safe=True)
        check(eng.pack_candidate(tree.vroot) is not None,
              "pack_candidate refused an SPR candidate")
        moves.rollback_move(rb)
    return (time.perf_counter() - t0) * 1e6 / len(pairs)


def one_streamed_iteration(label, part, tree, gpu):
    """Phase 20 B and C: one nni_round_streamed() iteration on `part`'s
    default engine, its best SEARCH_TOP scores against set_topology +
    loglikelihood() and its passes, wave by wave, against the level
    kernel's plain version (`stream_pass_case`). Returns the iteration's
    record with the passes' under "passes"."""
    import numpy as np
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.search import TreeSearch

    s = TreeSearch(part, tree)
    s._ensure_engine()
    check(s._streamed_eligible(), f"{label}: not eligible for the streamed "
          f"rounds")
    check_eng = TreeEngine(part, tree)
    res = {}

    def first(scheds, scores):
        sched = next(iter(scheds.values()))
        idx = np.argsort(-scores)[:SEARCH_TOP]
        res["max_rel"] = check_scores(
            f"{label} NNI: streamed vs set_topology + loglikelihood()",
            scores[idx], full_scores(check_eng, tree, nni_moved,
                                     [sched.pairs[i] for i in idx]))
        res["passes"] = stream_pass_case(label, s, sched, "nni", gpu)

    log = RoundLog(f"{label} NNI", s, "nni", first, stop=True)
    log.run(s.nni_round_streamed)
    print(f"search [{label}, one streamed NNI iteration on "
          f"'{s._engine.execution_path}'] ({gpu}): the best {SEARCH_TOP} "
          f"scores vs set_topology + loglikelihood() max rel err "
          f"{res['max_rel']:.3e}", flush=True)
    return {"path": s._engine.execution_path, **res, **log.iters[0]}


def search_phase(device, gpu, flagship, aa_tree, aa_by):
    """Phase 20. The level kernel's and the fused kernel's launch counts
    are reset before the rounds and read after: the streamed rounds must
    have launched the level kernel, the batched ones the fused kernel."""
    from libpll2_tpu_torch import native
    from libpll2_tpu_torch.trees.utils import utree_clone

    check(native.load() is not None, "the native builders did not load")
    print(f"search: the native builders "
          f"{os.path.relpath(native.library_path(), REPO)}", flush=True)
    reset_counts()
    dna = dna_search(device, gpu)
    rep_tree, _, rep_make = flagship
    rep = one_streamed_iteration(f"repeats {REP_TAXA} x {REP_SITES}",
                                 rep_make(device), utree_clone(rep_tree),
                                 gpu)
    check(rep["path"] == "repeats-dense-fused", f"repeats search on "
          f"{rep['path']!r}")
    aa = one_streamed_iteration(
        f"protein {AA_TAXA} x {AA_SITES}",
        protein_partition(aa_tree, aa_by, AA_SITES, device),
        utree_clone(aa_tree), gpu)
    got = counts()
    print(f"search launches: {got}", flush=True)
    check(got["level"] > 0 and got["fused"] > 0 and got["rows"] > 0,
          f"search: a kernel of the path never launched: {got}")
    return {"dna": dna, "repeats": rep, "protein": aa, "launches": got}


# ------------------------------------------------- 21. model optimization
OPT_STEPS, AA_OPT_STEPS = 40, 10
# ModelTest-NG's pattern at a reduced size: 3 models x 2 rounds of Adam and
# Brent on the plain gradient route
MS_TAXA, MS_SITES, MS_STEPS = 32, 2048, 30
FD_STEP = 0.02                     # libpll2_tpu/optimize.py:376 fd_step


def opt_problem(device, dtype=None, by=None, **options):
    """Phase 21's DNA problem: phase 20's tree (random_utree, seed 7) with
    its branch lengths perturbed (x 1.7 + 0.02) and the alignment simulated
    on the unperturbed tree under dna_model()'s GTR and Gamma(0.8) x 4,
    the partition started from perturbed parameters (seed 7 + 21);
    `options` (rate_scalers) go to the partition. Returns (tree, {label:
    sequence}, partition)."""
    import numpy as np
    import torch
    from libpll2_tpu_torch.trees import random_utree
    from libpll2_tpu_torch.utils import simulate_alignment

    labels = [f"t{i}" for i in range(N_TAXA)]
    freqs, subst = dna_model()
    if by is None:
        headers, seqs = simulate_alignment(random_utree(labels, seed=SEED),
                                           N_SITES, freqs, subst, alpha=0.8,
                                           seed=SEED)
        by = dict(zip(headers, seqs))
    tree = random_utree(labels, seed=SEED)
    seen = set()
    for node in tree.nodes():
        for h in ([node] if node.is_tip() else list(node.ring())):
            if h.back is not None and id(h) not in seen:
                seen.update((id(h), id(h.back)))
                h.length = h.back.length = h.length * 1.7 + 0.02
    part = dna_partition(tree, by, N_SITES, device,
                         dtype=dtype or torch.float32, **options)
    rng = np.random.default_rng(SEED + 21)
    part.set_frequencies(0, freqs * rng.uniform(0.7, 1.3, 4))
    part.set_subst_params(0, subst * np.exp(rng.normal(0.0, 0.4, 6)))
    return tree, by, part


@contextlib.contextmanager
def trials_through(eng, **path_kw):
    """The engine's model trials with `path_kw` (the plain `traversal` or
    `level` of its path) in place of its kernel."""
    orig = type(eng)._trial_loglikelihoods
    eng._trial_loglikelihoods = lambda e, f: orig(eng, e, f, **path_kw)
    try:
        yield
    finally:
        del eng._trial_loglikelihoods


def fd_batch(x0):
    """maximize_fused's 2n+1 central-difference rows at x0."""
    import torch

    eye = torch.eye(x0.numel(), dtype=x0.dtype, device=x0.device) * FD_STEP
    return torch.cat([x0[None], x0[None] + eye, x0[None] - eye])


def trial_step(label, eng, groups, gpu, timed=True):
    """One maximize_fused step's trials (2n+1 at the start) through the
    path's kernel and its plain version on the same inputs: logL within
    TOL_LOGL. On the fused paths the kernel's launch (the candidate form,
    the table repeated) is also timed (CUDA events, median of REPS), its
    device time taken (torch.profiler) and its bound counted as for a
    candidate chunk. None of these launches is the path's. Returns {k,
    max_abs_err, max_rel_err, ms, plain_ms, device_ms, bound, launches}."""
    import torch
    from libpll2_tpu_torch.ops import fused, levels, pool
    from libpll2_tpu_torch.optimize import make_fused_loglikelihood_fn

    fnb, x0, _ = make_fused_loglikelihood_fn(eng, groups)
    X = fd_batch(x0)
    k = X.shape[0]
    path = eng.execution_path
    reset_counts()
    got = fnb(X).double()
    torch.cuda.synchronize()
    launched = counts()
    captured = {}
    plain_ms = []

    def plain_traversal(*a, **kw):
        captured["args"], captured["kw"] = a, kw
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fused.fused_traversal_reference(*a, **kw)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    plain_kw = {"fused": {"traversal": plain_traversal},
                "repeats-dense-fused": {"traversal": plain_traversal},
                "levels-kernel": {"level": levels.level_update_reference},
                "pool-pallas": {"level": pool.pool_update_reference}}[path]
    with trials_through(eng, **plain_kw):
        want = fnb(X).double()
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite trials")
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs()).max())
    out = {"k": k, "max_abs_err": err, "max_rel_err": rel,
           "launches": launched, "path": path}
    text = (f"model trials [{label}, {path}]: {k} trials of one step, "
            f"kernel vs plain logL max rel err {rel:.3e} (max abs "
            f"{err:.3e}), launches {launched}")
    check(rel < TOL_LOGL, f"{label}: trials max rel err {rel:.3e} >= "
          f"{TOL_LOGL}")
    if "args" in captured and timed:
        args, kw = captured["args"], captured["kw"]
        kw = dict(kw)
        n_ops = args[2].shape[1] - 1
        ms = median_ms(lambda: fused.fused_traversal(*args, **kw))
        name = "fused_rows" if eng.partition.states >= 16 else "fused_"
        dev = kernel_device_us(lambda: fused.fused_traversal(*args, **kw),
                               name) * 1e-3
        bound = candidate_bound(eng.partition, k, n_ops, eng.mxu)
        out.update(ms=ms, plain_ms=plain_ms[0], device_ms=dev, bound=bound)
        text += (f"; the trial launch ({gpu}): {k} trials of {n_ops} ops, "
                 f"call {ms:.4f} ms, device {dev * 1e3:.1f} us "
                 f"({dev * 1e3 / k:.2f} us a trial), bound {bound[0]:.4f} "
                 f"ms by {bound[1]}, plain {plain_ms[0]:.4f} ms (once)")
    print(text, flush=True)
    return out


def trial_bound(eng, tree, trials):
    """The bound of the trial form over `trials` trials on the engine's
    path: `level_bound` of its op list on 'levels-kernel', `pool_bound` of
    its pooled levels on 'pool-pallas' (what the trials share counted
    once)."""
    import copy

    from libpll2_tpu_torch.ops import pool
    from libpll2_tpu_torch.trees import create_operations, traverse

    part = eng.partition
    ops, _, _ = create_operations(traverse(tree.vroot))
    if eng.execution_path == "levels-kernel":
        return level_bound(part, ops, trials)
    _, lv = pool.schedule_pool_levels(copy.deepcopy(part.repeats), ops,
                                      part.tips, part.sites_padded,
                                      part.scale_buffers)
    return pool_bound(part, lv, trials)


def trial_inputs(eng, groups):
    """One maximize_fused step's 2n+1 trial models at the engine's model,
    as make_fused_loglikelihood_fn hands them to _trial_loglikelihoods:
    ((eigenvals, evecs, inv_evecs), freqs), each [K, M, ...]."""
    import torch
    from libpll2_tpu_torch.optimize import make_fused_loglikelihood_fn

    fnb, x0, _ = make_fused_loglikelihood_fn(eng, groups)
    X = fd_batch(x0)
    got = {}

    def capture(eigen, freqs):
        got["eigen"], got["freqs"] = eigen, freqs
        return torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
    eng._trial_loglikelihoods = capture
    try:
        fnb(X)
    finally:
        del eng._trial_loglikelihoods
    return got["eigen"], got["freqs"]


def trial_launches(eng) -> int:
    """The launches one chunk of trials takes on the engine's path: one a
    level on 'levels-kernel', on 'pool-pallas' one a traversal at 4x4 and
    one a level otherwise."""
    if eng.execution_path == "levels-kernel":
        return len(eng._ops)
    plan = eng._ops
    return 1 if pool_traversal_of(plan) is not None else len(plan.tables)


def trial_chunks(eng, k) -> int:
    return -(-k // eng.trial_chunk())


def compare_level_trials(name, eng, clv, sc, want_clv, want_sc):
    """A chunk of the level kernel's trial form against its plain version
    (the trial buffers after each): per trial, the scaler rows the
    traversal writes equal but at ties (`match_counts`; the trash row
    aside), the parent rows within TOL_CLV of each site's largest entry.
    Returns (max relative error, max absolute error, ties)."""
    import torch

    part = eng.partition
    base = eng._trial_rows[0]
    table = torch.cat([t.cpu() for t in eng._ops], dim=1)
    writer = {int(psc): int(par) - base for par, psc, has in zip(
        table[0].tolist(), table[7].tolist(), table[8].tolist()) if has}
    rows = sorted(writer)
    parents = sorted({int(p) - base for p in table[0].tolist()})
    if part.rate_scalers:
        def block(e):
            return writer[rows[e[0]]], e[1], slice(None), e[2]
    else:
        def block(e):
            return writer[rows[e[0]]], slice(None), slice(None), e[1]
    ties, rel, abs_err = 0, 0.0, 0.0
    for i in range(clv.shape[0]):
        ties += match_counts(f"{name}, trial {i}", sc[i, rows],
                             want_sc[i, rows], clv[i], want_clv[i], block,
                             part.scale_factor, part.scale_threshold)
        got, want = clv[i, parents], want_clv[i, parents]
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite CLVs")
        err = (got - want).abs()
        site_max = want.abs().amax(dim=(1, 2), keepdim=True).clamp(
            min=1e-30)
        rel = max(rel, float((err / site_max).max()))
        abs_err = max(abs_err, float(err.max()))
    check(rel <= TOL_CLV, f"{name}: max_rel_err {rel:.3e} > {TOL_CLV}")
    return rel, abs_err, ties


def compare_pool_trials(name, eng, pools, sc, want_pools, want_sc):
    """A chunk of the pool kernel's trial form against its plain version:
    per trial, the scaler regions equal but at ties (the trash region
    aside), the zero region zero, the class columns within TOL_CLV of each
    column's largest entry. Returns (max relative error, max absolute
    error, ties)."""
    import torch

    part = eng.partition
    lay = part._flat
    col_of = torch.full((lay.sc_trash,), -1, dtype=torch.long)
    for o in eng._repeat_ops:
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
    check(not bool(sc[..., lay.sc_zero:].any()),
          f"{name}: the zero region was written")
    ties, rel, abs_err = 0, 0.0, 0.0
    for i in range(pools.shape[0]):
        ties += match_counts(f"{name}, trial {i}",
                             sc[i, ..., :lay.sc_trash],
                             want_sc[i, ..., :lay.sc_trash], pools[i],
                             want_pools[i], block, part.scale_factor,
                             part.scale_threshold)
        check(bool(torch.isfinite(pools[i]).all()),
              f"{name}: non-finite class columns")
        err = (pools[i] - want_pools[i]).abs()
        col_max = want_pools[i].abs().amax(dim=(0, 1), keepdim=True).clamp(
            min=1e-30)
        rel = max(rel, float((err / col_max).max()))
        abs_err = max(abs_err, float(err.max()))
    check(rel <= TOL_CLV, f"{name}: max_rel_err {rel:.3e} > {TOL_CLV}")
    return rel, abs_err, ties


def trial_form_case(label, eng, tree, groups, gpu):
    """The trial form of the engine's path kernel (#3 on 'levels-kernel',
    #5 on 'pool-pallas') against its plain version over one
    maximize_fused step's 2n+1 trials, chunk by chunk (`trial_chunk`):
    each chunk's trial buffers through the kernel, its launches counted
    (one a level a chunk; one a traversal at 4x4), and through the plain
    version (`compare_level_trials`, `compare_pool_trials`). Then the first
    chunk's traversal timed: its call (CUDA events, median of REPS), its
    device time (torch.profiler, the chunk's launches summed) beside its
    bound (`trial_bound` at the chunk's trials, on `tree`), and the plain
    version once. Returns {k, chunk, chunks, launches,
    max_abs_err, max_rel_err, ties, ms, device_ms, plain_ms, bound}."""
    import torch
    from libpll2_tpu_torch.ops import levels, pool

    part = eng.partition
    path = eng.execution_path
    lev = path == "levels-kernel"
    (w, evecs, ivecs), freqs = trial_inputs(eng, groups)
    k_all, chunk = w.shape[0], eng.trial_chunk()
    n_launch = trial_launches(eng)
    kernel = "level" if lev else "pool"
    thr, fac = part.scale_threshold, part.scale_factor

    def runner(pmat):
        if lev:
            clv, sc, tips = eng._level_trial_buffers(pmat.shape[0])

            def run(c, s, level=levels.level_update):
                levels.update_partials_kernel(c, s, pmat, eng._ops, thr,
                                              fac, level=level, tips=tips)
        else:
            clv, sc = eng._pool_trial_buffers(pmat.shape[0])

            def run(c, s, level=None):
                pool.update_partials_pool(c, s, pmat, eng._ops, thr, fac,
                                          level=level)
        return run, clv, sc

    plain = (levels.level_update_reference if lev
             else pool.pool_update_reference)
    compare = compare_level_trials if lev else compare_pool_trials
    rel = abs_err = 0.0
    ties = launched = 0
    first = None
    for i in range(0, k_all, chunk):
        pmat, _ = eng._trial_pmatrices(w[i:i + chunk], ivecs[i:i + chunk],
                                       evecs[i:i + chunk])
        run, clv, sc = runner(pmat)
        want_clv, want_sc = clv.clone(), sc.clone()
        torch.cuda.synchronize()
        reset_counts()
        run(clv, sc)
        torch.cuda.synchronize()
        got = counts()
        check_counts(f"{label}: the trial form over trials {i}.."
                     f"{i + pmat.shape[0] - 1}", got, {kernel: n_launch})
        launched += got[kernel]
        run(want_clv, want_sc, plain)
        torch.cuda.synchronize()
        r, a, t = compare(f"{label} trials", eng, clv, sc, want_clv,
                          want_sc)
        rel, abs_err, ties = max(rel, r), max(abs_err, a), ties + t
        if first is None:
            first = (run, clv, sc, pmat.shape[0])
        else:
            del clv, sc
        del want_clv, want_sc
    run, clv, sc, k = first
    ms = median_ms(lambda: run(clv, sc))
    dev = sum(launches_device_us(lambda: run(clv, sc), f"{kernel}_",
                                 n_launch)) * 1e-3
    want_clv, want_sc = clv.clone(), sc.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(want_clv, want_sc, plain)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    del want_clv, want_sc, clv, sc, first, run
    bound = trial_bound(eng, tree, k)
    one = trial_bound(eng, tree, 1)[0]
    out = {"k": k_all, "chunk": chunk, "chunks": -(-k_all // chunk),
           "launches": launched, "max_abs_err": abs_err, "max_rel_err": rel,
           "ties": ties, "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
           "bound": bound, "trial_bytes": eng.trial_bytes()}
    print(f"trial form [{label}, {path}] ({gpu}): {k_all} trials of one "
          f"step in {out['chunks']} chunk(s) of at most {chunk} "
          f"({eng.trial_bytes() / 1e6:.1f} MB a trial), {n_launch} "
          f"launch(es) a chunk, {launched} in all; kernel vs plain: scaler "
          f"rows equal" + (f" ({ties} ties)" if ties else "")
          + f", max_rel_err {rel:.3e}, max_abs_err {abs_err:.3e}; a chunk "
          f"of {k} trials: call {ms:.4f} ms, device {dev * 1e3:.1f} us "
          f"({dev * 1e3 / k:.2f} us a trial), bound {bound[0]:.4f} ms by "
          f"{bound[1]} (one trial's {one:.4f}), plain "
          f"{plain_ms:.4f} ms (once)", flush=True)
    return out


def maximize_counted(label, eng, groups, steps, want_kernel):
    """maximize_loglikelihood on a kernel engine (the trial route), launches
    counted: one of `want_kernel` a step of at most 128 trials on the fused
    paths and one for the final pair. Logs must rise, and the applied
    parameters reproduce the reported logL within 2e-2 (tests/
    test_optimize.py:256). Returns {lk0, lk, steps, ms_per_step,
    launches}."""
    import torch
    from libpll2_tpu_torch.optimize import maximize_loglikelihood

    lk0 = eng.loglikelihood()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    lk, _, hist = maximize_loglikelihood(eng, groups, steps=steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    got = counts()
    check_counts(f"{label}: maximize, {len(hist)} steps", got,
                 {want_kernel: len(hist) + 1})
    applied = eng.loglikelihood()
    print(f"{label}: maximize_loglikelihood{groups} on "
          f"{eng.execution_path!r}: logL {lk0!r} -> {lk!r} in {len(hist)} "
          f"steps, {wall / len(hist):.2f} ms a step (host clock, Adam "
          f"included); the applied parameters give {applied!r}", flush=True)
    check(lk > lk0 and hist[-1] > hist[0], f"{label}: logL did not rise "
          f"({lk0} -> {lk})")
    check(abs(applied - lk) < 2e-2, f"{label}: the applied parameters give "
          f"{applied}, reported {lk}")
    return {"lk0": lk0, "lk": lk, "steps": len(hist),
            "ms_per_step": wall / len(hist), "launches": got}


def lockstep_level(label, stats):
    """A `level` for newton_sweep that holds every level launch against the
    plain version on the same inputs before going on with the kernel's
    rows: the parent rows' scaler counts equal (ties printed,
    `match_counts`) and their CLVs within TOL_CLV of each site's max."""
    import torch
    from libpll2_tpu_torch.ops import levels

    def level(clv2d, scaler, pmatrix, table, rates, states, thr, fac):
        rows, sc_rows = table[0].long(), table[7].long()
        keep = clv2d[rows].clone(), scaler[sc_rows].clone()
        levels.level_update_reference(clv2d, scaler, pmatrix, table, rates,
                                      states, thr, fac)
        want = clv2d[rows].clone(), scaler[sc_rows].clone()
        clv2d[rows], scaler[sc_rows] = keep
        levels.level_update(clv2d, scaler, pmatrix, table, rates, states,
                            thr, fac)
        got_clv = clv2d[rows].view(len(rows), rates, states, -1)
        want_clv = want[0].view(len(rows), rates, states, -1)
        stats["ties"] += match_counts(
            f"{label}, step {stats['calls']}", scaler[sc_rows], want[1],
            got_clv, want_clv, lambda e: (e[0], slice(None), slice(None),
                                          e[1]), fac, thr)
        site_max = want_clv.abs().amax(dim=(1, 2)).clamp(min=1e-30)
        rel = float(((got_clv - want_clv).abs()
                     / site_max[:, None, None]).max())
        stats["rel"] = max(stats["rel"], rel)
        stats["abs"] = max(stats["abs"],
                           float((got_clv - want_clv).abs().max()))
        stats["calls"] += 1
        check(rel <= TOL_CLV, f"{label}: level {stats['calls']} max rel "
              f"err {rel:.3e} > {TOL_CLV}")
    return level


def sweep_check(label, eng, tree, branches=True):
    """newton_smooth_all's first pass, step by step, through the level
    kernel against its plain version (`lockstep_level`), and with
    `branches` the pass's branches through the kernel against the pass
    through the plain version alone: within 1e-4 relative. Returns
    {max_abs_err, ties, levels}."""
    import torch
    from libpll2_tpu_torch.ops import branch_sweep, levels
    from libpll2_tpu_torch.optimize import _sweep_inputs

    args, kw = _sweep_inputs(eng, tree)
    stats = {"ties": 0, "rel": 0.0, "abs": 0.0, "calls": 0}
    got = branch_sweep.newton_sweep(*args, passes=1,
                                    level=lockstep_level(label, stats), **kw)
    brel = 0.0
    if branches:
        want = branch_sweep.newton_sweep(
            *args, passes=1, level=levels.level_update_reference, **kw)
        brel = float(((got[0] - want[0]).abs() / want[0].abs()).max())
    ties = f" ({stats['ties']} ties)" if stats["ties"] else ""
    print(f"sweep vs plain [{label}]: {stats['calls']} level launches of "
          f"one pass held step by step, scaler rows equal{ties}, CLV max "
          f"rel err {stats['rel']:.3e} (abs {stats['abs']:.3e})"
          + (f"; the pass's branches vs the plain pass max rel err "
             f"{brel:.3e}" if branches else ""), flush=True)
    check(brel <= 1e-4, f"{label}: sweep branches max rel err {brel:.3e}")
    return {"max_abs_err": stats["abs"], "ties": stats["ties"],
            "levels": stats["calls"]}


def sweep_counted(label, eng, tree, passes, want_kernel):
    """newton_smooth_all, launches counted: the level kernel passes x steps
    + (passes + 1) x levels, and one of `want_kernel` for the final
    loglikelihood(). Returns {lk0, lk, ms_per_pass, level_launches_per_pass,
    launches}."""
    import torch
    from libpll2_tpu_torch.ops import branch_sweep, levels
    from libpll2_tpu_torch.optimize import newton_smooth_all
    from libpll2_tpu_torch.trees import create_operations, traverse

    p = eng.partition
    steps, _ = branch_sweep.build_smoothing_schedule(
        tree, p.nodes, p.scale_buffers, p.prob_matrices)
    n_levels = len(levels.schedule_levels(
        create_operations(traverse(tree.vroot))[0], p.tips))
    lk0 = eng.loglikelihood()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    lk = newton_smooth_all(eng, tree, passes=passes)
    wall = (time.perf_counter() - t0) * 1e3
    got = counts()
    check_counts(f"{label}: newton_smooth_all, {passes} pass(es), "
                 f"{len(steps)} steps, {n_levels} levels", got,
                 {"level": passes * len(steps) + (passes + 1) * n_levels,
                  want_kernel: 1})
    per_pass = len(steps) + n_levels
    print(f"{label}: newton_smooth_all({passes} passes) on "
          f"{eng.execution_path!r}: logL {lk0!r} -> {lk!r}, "
          f"{wall / passes:.1f} ms a pass (host clock), {per_pass} level "
          f"launches a pass ({len(steps)} one-op steps, {n_levels} refresh "
          f"levels)", flush=True)
    check(lk > lk0, f"{label}: the sweep lowered logL ({lk0} -> {lk})")
    return {"lk0": lk0, "lk": lk, "ms_per_pass": wall / passes,
            "level_launches_per_pass": per_pass, "launches": got}


def brent_counted(label, eng):
    """optimize_gamma_shape, then optimize_pinv, each evaluation one
    loglikelihood() (one fused launch). Returns {alpha, pinv, lk,
    evaluations, ms_per_evaluation}."""
    import torch
    from libpll2_tpu_torch.optimize import optimize_gamma_shape, optimize_pinv

    lk0 = eng.loglikelihood()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    alpha, lk1 = optimize_gamma_shape(eng)
    pinv, lk2 = optimize_pinv(eng)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    got = counts()
    evals = got["fused"]
    check(evals > 0 and got["level"] == got["rows"] == got["pool"] == 0,
          f"{label}: Brent launches {got}")
    print(f"{label}: Brent alpha {alpha:.5f} (logL {lk1!r}), p-inv "
          f"{pinv:.5f} (logL {lk2!r}) from {lk0!r}: {evals} evaluations, "
          f"{wall / evals:.3f} ms an evaluation (host clock)", flush=True)
    # p-inv's optimum may sit at its lower bound, where the logL moves by
    # float32's last bits (0.125 at 1.9e6)
    slack = 1e-6 * abs(lk0)
    check(lk1 >= lk0 - slack and lk2 >= lk1 - slack,
          f"{label}: Brent lowered logL ({lk0} -> {lk1} -> {lk2})")
    return {"alpha": alpha, "pinv": pinv, "lk": lk2, "evaluations": evals,
            "ms_per_evaluation": wall / evals, "launches": got}


def f64_cpu_logl(part, eng, tree, by):
    """The engine's model, branches and tree through the plain path in
    float64 on the CPU."""
    import torch
    from libpll2_tpu_torch import TreeEngine

    p64 = dna_partition(tree, by, N_SITES, "cpu", dtype=torch.float64)
    p64.set_frequencies(0, part.frequencies[0])
    p64.set_subst_params(0, part.subst_params[0])
    p64.set_category_rates(part.rates)
    if part.prop_invar[0] > 0:
        p64.update_invariant_sites_proportion(0, float(part.prop_invar[0]))
    return TreeEngine(p64, tree, pallas=False).loglikelihood(
        branches=eng.branches.cpu().double())


def gradient_check(device, by, gpu):
    """The gradient route on the card: one value and gradient of
    make_loglikelihood_fn (branches, subst, freqs) on a pallas=False
    float32 engine at 128 x 16384, against float64 on the CPU: logL within
    TOL_LOGL, each group's gradient within TOL_D1 of its largest entry; no
    kernel launches (the route is the plain path, as in JAX)."""
    import torch
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.optimize import make_loglikelihood_fn

    groups = ("branches", "subst", "freqs")
    out = []
    for dev, dtype in ((device, torch.float32), ("cpu", torch.float64)):
        tree, _, part = opt_problem(dev, dtype, by)
        eng = TreeEngine(part, tree, pallas=False)
        fn, p0 = make_loglikelihood_fn(eng, groups)
        q = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        reset_counts()
        t0 = time.perf_counter()
        value = fn(q)
        grads = torch.autograd.grad(value, list(q.values()))
        if dev != "cpu":
            torch.cuda.synchronize()
            check(all(v == 0 for v in counts().values()),
                  f"gradient route launched kernels: {counts()}")
        ms = (time.perf_counter() - t0) * 1e3
        out.append((float(value.detach()),
                    {k: g.double().cpu() for k, g in zip(q, grads)}, ms))
    (v32, g32, ms32), (v64, g64, ms64) = out
    rel = abs(v32 - v64) / abs(v64)
    grel = {k: float((g32[k] - g64[k]).abs().max() / g64[k].abs().max())
            for k in g64}
    print(f"gradient route ({gpu}): make_loglikelihood_fn{groups} at "
          f"{N_TAXA} x {N_SITES}, float32 on the card vs float64 on the "
          f"CPU: logL {v32!r} vs {v64!r} (rel {rel:.3e}), gradient max rel "
          f"err {grel}; value and gradient {ms32:.1f} ms on the card "
          f"(host clock, once), {ms64:.1f} ms on the CPU", flush=True)
    check(rel < TOL_LOGL, f"gradient route logL rel err {rel:.3e}")
    check(all(r < TOL_D1 for r in grel.values()),
          f"gradient route gradient rel err {grel}")
    return {"rel_err": rel, "grad_rel_err": grel, "ms": ms32}


def modelselect_check(device, gpu):
    """select_dna_model(("JC", "HKY", "GTR"), steps=30) on the card at a
    reduced MS_TAXA x MS_SITES (each model is 2 rounds of Adam and Brent on
    the gradient route, whose plain ops are launch-bound at full width):
    finite criteria, JC ranked last, HKY's kappa above 2 for data
    simulated at kappa 6."""
    import math as _math
    from libpll2_tpu_torch import modelselect
    from libpll2_tpu_torch.trees import random_utree
    from libpll2_tpu_torch.utils import simulate_alignment

    labels = [f"t{i}" for i in range(MS_TAXA)]
    tree = random_utree(labels, seed=SEED)
    headers, seqs = simulate_alignment(tree, MS_SITES,
                                       [0.4, 0.15, 0.15, 0.3],
                                       [1.0, 6.0, 1.0, 1.0, 6.0, 1.0],
                                       alpha=0.8, seed=SEED)
    t0 = time.perf_counter()
    rows = modelselect.select_dna_model(
        tree, dict(zip(headers, seqs)), models=("JC", "HKY", "GTR"),
        steps=MS_STEPS, device=device)
    s = time.perf_counter() - t0
    text = ", ".join(f"{r['model']} logL {r['logL']:.3f} BIC {r['BIC']:.3f} "
                     f"alpha {r['alpha']:.4f}" for r in rows)
    print(f"modelselect ({gpu}): select_dna_model at {MS_TAXA} x "
          f"{MS_SITES} (reduced from {N_TAXA} x {N_SITES}), steps "
          f"{MS_STEPS}: {text}; {s:.1f} s", flush=True)
    hky = next(r for r in rows if r["model"] == "HKY")
    check(all(_math.isfinite(r["BIC"]) for r in rows)
          and rows[-1]["model"] == "JC"
          and hky["subst"][1] / hky["subst"][0] > 2.0,
          f"modelselect: ranking {[r['model'] for r in rows]}, HKY kappa "
          f"{hky['subst'][1] / hky['subst'][0]}")
    return {"ranking": [r["model"] for r in rows], "s": s}


def maximize_step_case(label, eng, tree, groups, gpu):
    """One maximize_fused step on a kernel engine: its trials held against
    the path's plain version first (`trial_step`); on 'levels-kernel' and
    'pool-pallas' the trial form of the level and pool kernels (B-3b) held
    chunk by chunk against its plain version and timed (`trial_form_case`);
    then the step itself, its launches counted: one a level (or, at 4x4 on
    the pool, one a traversal) for each chunk of its 2n+1 trials and of
    its final pair ('repeats-dense-fused': one launch each). Returns (the
    trial step's record with step_ms and step_launches, the trial form's
    record or None)."""
    import torch
    from libpll2_tpu_torch.optimize import maximize_fused

    path = eng.execution_path
    want = {"levels-kernel": "level", "repeats-dense-fused": "fused",
            "pool-pallas": "pool"}[path]
    o = trial_step(label, eng, groups, gpu, timed=False)
    form = None
    if path != "repeats-dense-fused":
        form = trial_form_case(label, eng, tree, groups, gpu)
        step_want = (trial_chunks(eng, o["k"]) + trial_chunks(eng, 2)) \
            * trial_launches(eng)
    else:
        step_want = 2
    lk0 = eng.loglikelihood()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    lk1, _, hist = maximize_fused(eng, groups, steps=1)
    torch.cuda.synchronize()
    o["step_ms"] = (time.perf_counter() - t0) * 1e3
    o["step_launches"] = counts()
    print(f"{label}: one maximize_fused step on {path!r}: logL {lk0!r} -> "
          f"{lk1!r}, {o['step_ms']:.1f} ms (host clock), launches "
          f"{o['step_launches']} ({o['k']} trials and a final pair, "
          f"{trial_chunks(eng, o['k'])} + {trial_chunks(eng, 2)} "
          f"chunk(s))", flush=True)
    check_counts(f"{label}: a maximize_fused step on {path!r}",
                 o["step_launches"], {want: step_want})
    check(lk1 >= lk0 - 1e-2, f"{path!r}: a step lowered logL {lk0} -> "
          f"{lk1}")
    return o, form


def optimize_phase(device, gpu, flagship, aa_tree, aa_by):
    """Phase 21, model optimization: DNA 128 x 16384 GTR+G4 on 'fused'
    (maximize_loglikelihood of subst and freqs, the Gamma shape and p-inv by
    Brent, newton_smooth_all), protein 128 x 8192 LG+G4 'split'
    (maximize_fused of the frequencies, one sweep pass on the runtime-size
    level kernel), a trial step on 'levels-kernel', 'repeats-dense-fused'
    and 'pool-pallas', the gradient route and modelselect."""
    import torch
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.optimize import maximize_fused
    from libpll2_tpu_torch.trees.utils import utree_clone

    t_phase = time.perf_counter()
    tree, by, part = opt_problem(device)
    eng = TreeEngine(part, tree)
    check(eng.execution_path == "fused", f"DNA on {eng.execution_path!r}")
    groups = ("subst", "freqs")
    trial = trial_step("DNA", eng, groups, gpu)
    dna = maximize_counted("DNA", eng, groups, OPT_STEPS, "fused")
    brent = brent_counted("DNA", eng)
    sweep_cmp = sweep_check("DNA", eng, tree)
    sweep = sweep_counted("DNA", eng, tree, 2, "fused")
    lk = eng.loglikelihood()
    ref = f64_cpu_logl(part, eng, tree, by)
    rel = abs(lk - ref) / abs(ref)
    print(f"DNA optimized: logL {lk!r} vs the float64 plain path on the "
          f"CPU {ref!r} (rel {rel:.3e})", flush=True)
    check(rel < TOL_LOGL, f"DNA optimized logL rel err {rel:.3e}")

    aa_part = protein_partition(aa_tree, aa_by, AA_SITES, device)
    aa_tree = utree_clone(aa_tree)
    aa_eng = TreeEngine(aa_part, aa_tree)
    aa_trial = trial_step("protein", aa_eng, ("freqs",), gpu)
    aa_lk0 = aa_eng.loglikelihood()
    reset_counts()
    t0 = time.perf_counter()
    aa_lk, _, aa_hist = maximize_fused(aa_eng, ("freqs",),
                                       steps=AA_OPT_STEPS)
    aa_ms = (time.perf_counter() - t0) * 1e3 / len(aa_hist)
    check_counts(f"protein: maximize_fused, {len(aa_hist)} steps", counts(),
                 {"rows": len(aa_hist) + 1})
    print(f"protein: maximize_fused(freqs) {aa_lk0!r} -> {aa_lk!r} in "
          f"{len(aa_hist)} steps, {aa_ms:.2f} ms a step (host clock)",
          flush=True)
    check(aa_lk > aa_lk0, f"protein: logL did not rise ({aa_lk0} -> "
          f"{aa_lk})")
    aa_sweep_cmp = sweep_check("protein", aa_eng, aa_tree, branches=False)
    aa_sweep = sweep_counted("protein", aa_eng, aa_tree, 1, "rows")
    del aa_eng, aa_part

    # a maximize_fused step on each other kernel path, its trials held
    # against the path's plain version first; on 'levels-kernel' and
    # 'pool-pallas' the trial form of the level and pool kernels (B-3b) held
    # chunk by chunk against its plain version and timed, and the step's
    # launches counted: one a level (or, at 4x4 on the pool, one a
    # traversal) for each chunk of its 2n+1 trials and of its final pair
    others, trial_forms = {}, {}
    rep_tree, _, rep_make = flagship
    aa_make = conserved_protein(aa_tree, aa_by)[1]
    rep = f"repeats {REP_TAXA} x {REP_SITES}"
    for key, label, make, pallas, grp in (
            ("levels-kernel", "DNA", lambda: (part, tree), "levels-kernel",
             groups),
            ("levels-kernel per rate", "DNA per rate",
             lambda: opt_problem(device, rate_scalers=True)[2::-2],
             "levels-kernel", groups),
            ("levels-kernel protein", "protein", lambda: (protein_partition(
                aa_tree, aa_by, AA_SITES, device), aa_tree), "levels-kernel",
             ("freqs",)),
            ("repeats-dense-fused", rep, lambda: (rep_make(device), rep_tree),
             "auto", groups),
            ("pool-pallas", rep, lambda: (rep_make(device), rep_tree), "pool",
             groups),
            ("pool-pallas protein", "conserved protein", lambda: (
                aa_make(device), aa_tree), "pool", ("freqs",))):
        o_part, t = make()
        o_eng = TreeEngine(o_part, t, pallas=pallas)
        others[key], form = maximize_step_case(label, o_eng, t, grp, gpu)
        if form is not None:
            trial_forms[key] = form
        del o_eng, o_part
    grad = gradient_check(device, by, gpu)
    ms = modelselect_check(device, gpu)
    s = time.perf_counter() - t_phase
    print(f"model optimization: {s:.1f} s", flush=True)
    return {"trial": trial, "dna": dna, "brent": brent,
            "sweep_check": sweep_cmp, "sweep": sweep, "final_rel_err": rel,
            "aa_trial": aa_trial, "aa_ms_per_step": aa_ms,
            "aa_launches": len(aa_hist) + 1, "aa_sweep_check": aa_sweep_cmp,
            "aa_sweep": aa_sweep, "others": others,
            "trial_forms": trial_forms, "gradient": grad,
            "modelselect": ms, "s": s}


# phase 22: an analysis from an alignment file. examples/flagship_1000.py:
# 81-91's data at full width: 1000 taxa on random_utree(seed 7), the
# branches shortened as its loop does (`analysis_data`), 4000 sites
# simulated under GTR (freqs 0.3/0.2/0.2/0.3, rates 1.2/3.5/0.8/1.1/3.0/1.0,
# alpha 0.8, seed 7)
ANA_TAXA, ANA_SITES, ANA_SEED = 1000, 4000, 7
ANA_FREQS = [0.3, 0.2, 0.2, 0.3]
ANA_SUBST = [1.2, 3.5, 0.8, 1.1, 3.0, 1.0]
ANA_PY_TAXA = 64            # the Python stepwise loop's cross-check
ANA_BOOT = 1000
ANA_BOOT_CHECK = (0, 1, 999)
ANA_REPS = 5


def write_alignment(tmp, headers, seqs):
    """The alignment as a FASTA file and an interleaved PHYLIP file (60
    characters a line) in `tmp`; returns their paths."""
    fas, phy = os.path.join(tmp, "aln.fas"), os.path.join(tmp, "aln.phy")
    with open(fas, "w") as fh:
        for h, s in zip(headers, seqs):
            fh.write(f">{h}\n")
            for i in range(0, len(s), 60):
                fh.write(s[i:i + 60] + "\n")
    width = max(len(h) for h in headers) + 2
    with open(phy, "w") as fh:
        fh.write(f"{len(seqs)} {len(seqs[0])}\n")
        for i in range(0, len(seqs[0]), 60):
            for h, s in zip(headers, seqs):
                fh.write((h.ljust(width) if i == 0 else "") + s[i:i + 60]
                         + "\n")
            fh.write("\n")
    return fas, phy


def host_fitch(fp, ops, tip, e1, e2):
    """Fitch on the host in numpy from the tips' packed vectors: every
    op's directional vector and cost in list order, then the score of
    inserting `tip` on each edge (e1[i], e2[i]). Returns (vectors as uint32,
    node costs, insertion scores)."""
    import numpy as np

    vec = np.zeros((fp.vectors.shape[0],) + fp.packed_host.shape[1:],
                   np.uint32)
    vec[:fp.tips] = fp.packed_host
    cost = np.zeros(vec.shape[0], np.int64)
    popc = np.array([bin(i).count("1") for i in range(256)], np.int64)

    def steps(union):
        return popc[np.ascontiguousarray(~union).view(np.uint8)].reshape(
            union.shape[:-1] + (-1,)).sum(-1)

    def join(a, b):
        ands = a & b
        union = np.bitwise_or.reduce(ands, axis=-2)
        return (ands | (~union[..., None, :] & (a | b))), steps(union)

    for o in ops:
        p, c1, c2 = (o.parent_score_index, o.child1_score_index,
                     o.child2_score_index)
        vec[p], s = join(vec[c1], vec[c2])
        cost[p] = s + cost[c1] + cost[c2]
    joined, s = join(vec[e1], vec[e2])
    union = np.bitwise_or.reduce(joined & vec[tip][None], axis=-2)
    scores = steps(union) + s + cost[e1] + cost[e2] + cost[tip]
    return vec, cost, scores + fp.const_cost


def analysis_data():
    """(headers, sequences) of phase 22's alignment: the flagship's loop
    as written (examples/flagship_1000.py:82-87), which visits both halves
    of an edge and so scales each length twice, max(max(l * 0.12, 0.004) *
    0.12, 0.004): the data of its recorded run (FLAGSHIP.json: 3581
    patterns)."""
    from libpll2_tpu_torch.trees import random_utree
    from libpll2_tpu_torch.utils import simulate_alignment

    tree = random_utree([f"t{i}" for i in range(ANA_TAXA)], seed=ANA_SEED)
    for nd in tree.nodes():
        for h in ([nd] if nd.is_tip() else list(nd.ring())):
            if h.back is not None:
                h.length = h.back.length = max(h.length * 0.12, 0.004)
    return simulate_alignment(tree, ANA_SITES, ANA_FREQS, ANA_SUBST,
                              alpha=0.8, seed=ANA_SEED)


def analysis_partition(tree, comp, weights, headers, device, repeats=False):
    """The flagship's GTR+G4 partition (examples/flagship_1000.py:112-123)
    over the compressed alignment, the tips bound to the tree's rows."""
    import torch
    from libpll2_tpu_torch import Partition, compute_gamma_cats
    from libpll2_tpu_torch.io import maps

    n = len(headers)
    part = Partition(n, n - 2, 4, len(comp[0]), 1, 2 * n - 3, 4, n - 2,
                     device=device, dtype=torch.float32,
                     site_repeats=repeats)
    by = dict(zip(headers, comp))
    tips = list(tree.tips())
    part.set_tip_states_batch(maps.map_nt, [by[t.label] for t in tips],
                              [t.clv_index for t in tips])
    part.set_pattern_weights(weights)
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1.0, 1.1, 0.9, 1.05, 0.95, 1.0])
    part.set_category_rates(compute_gamma_cats(1.0, 4))
    return part


def timed(fn):
    """(result, host-clock ms) of one call, the device synchronized."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def classer_check(part, ops):
    """The native classer's classes of every tip and op of a repeats
    partition `==` numpy's first-occurrence classes of the same codes, and
    both timed over the ops: (enabled ops, native ms, numpy ms)."""
    import numpy as np
    from libpll2_tpu_torch import native
    from libpll2_tpu_torch.repeats import _first_occurrence_classes

    table = part.repeats
    S = table.sites

    def same(node, got):
        site_id, id_site, ids = got
        if ids >= S:                   # no compression: the node is plain
            return int(table.ids[node]) == 0
        return (int(table.ids[node]) == ids
                and np.array_equal(table.site_id[node], site_id)
                and np.array_equal(table.id_site[node, :ids], id_site))

    for t in range(part.tips):
        got = _first_occurrence_classes(part.tip_states[t, :S])
        check(same(t, got), f"repeats classes of tip {t} differ from numpy")
    pairs = []
    for op in ops:
        p, l, r = (op.parent_clv_index, op.child1_clv_index,
                   op.child2_clv_index)
        if not table.enable_for(l, r):
            check(int(table.ids[p]) == 0, f"op {p}: classes on a plain op")
            continue
        li, ri = int(table.ids[l]), int(table.ids[r])
        pairs.append((table.site_id[l], table.site_id[r], li, ri))
        got = _first_occurrence_classes(
            table.site_id[l].astype(np.int64)
            + table.site_id[r].astype(np.int64) * li)
        check(same(p, got), f"repeats classes of op {p} differ from numpy")
    lookup = np.full(max((li * ri for _, _, li, ri in pairs), default=1),
                     -1, np.int32)
    t0 = time.perf_counter()
    for left, right, li, ri in pairs:
        native.repeats_update(left, right, li, li * ri, lookup)
    t1 = time.perf_counter()
    for left, right, li, ri in pairs:
        _first_occurrence_classes(left.astype(np.int64)
                                  + right.astype(np.int64) * li)
    t2 = time.perf_counter()
    return len(pairs), (t1 - t0) * 1e3, (t2 - t1) * 1e3


def analysis_phase(device, gpu):
    """Phase 22: an analysis from an alignment file (read, compress,
    stepwise parsimony, dense and 'pool-pallas' evaluation, bootstrap,
    checkpoint) at the flagship's full width. Returns the launches and
    times."""
    import copy
    import tempfile

    import numpy as np
    import torch
    from libpll2_tpu_torch import (TreeEngine, bootstrap_loglikelihoods,
                                   checkpoint, native)
    from libpll2_tpu_torch.io import (compress_site_patterns, load_fasta,
                                      maps, parse_phylip)
    from libpll2_tpu_torch.ops import pool
    from libpll2_tpu_torch.ops.fused import (fused_traversal,
                                             fused_traversal_reference)
    from libpll2_tpu_torch.parsimony import FastParsimony
    from libpll2_tpu_torch.parsimony.stepwise import fastparsimony_stepwise
    from libpll2_tpu_torch.partition import Partition
    from libpll2_tpu_torch.trees import (create_operations, export_newick,
                                         traverse)
    from libpll2_tpu_torch.trees.utree import (create_pars_buildops,
                                               reset_template_indices)

    t_phase = time.perf_counter()
    out = {}
    headers, seqs = analysis_data()
    n = len(headers)
    with tempfile.TemporaryDirectory() as tmp:
        # 1. read the alignment back from a FASTA and a PHYLIP file
        fas, phy = write_alignment(tmp, headers, seqs)
        (h_fas, s_fas), out["read_fasta_ms"] = timed(lambda: load_fasta(fas))
        (h_phy, s_phy), out["read_phylip_ms"] = timed(
            lambda: parse_phylip(phy, interleaved=True))
        check(h_fas == headers and s_fas == seqs, "FASTA read-back differs")
        check(h_phy == headers and s_phy == seqs, "PHYLIP read-back differs")

        # 2. compress to site patterns
        (comp, weights, _), out["compress_ms"] = timed(
            lambda: compress_site_patterns(s_fas, maps.map_nt))
        patterns = len(comp[0])
        check(int(weights.sum()) == ANA_SITES,
              f"pattern weights sum to {weights.sum()}, not {ANA_SITES}")
        print(f"analysis: {n} taxa x {ANA_SITES} sites read from FASTA in "
              f"{out['read_fasta_ms']:.1f} ms and interleaved PHYLIP in "
              f"{out['read_phylip_ms']:.1f} ms (equal), compressed to "
              f"{patterns} patterns in {out['compress_ms']:.1f} ms (host "
              f"clock)", flush=True)
        out["patterns"] = patterns

        # 3. parsimony: the native stepwise build, Fitch on the card
        check(native.load() is not None, "the native library did not load")
        pars = Partition(n, n - 2, 4, patterns, 1, 2 * n - 3, 1, n - 2,
                         device=device)
        pars.set_tip_states_batch(maps.map_nt, comp)
        pars.set_pattern_weights(weights)
        fp, out["fitch_init_ms"] = timed(lambda: FastParsimony(pars))
        check(fp.vectors.device.type == "cuda", "Fitch vectors off the card")
        (tree, cost), out["stepwise_ms"] = timed(
            lambda: fastparsimony_stepwise([fp], headers, ANA_SEED))
        pops = create_pars_buildops(traverse(tree.vroot))
        _, out["fitch_first_ms"] = timed(lambda: fp.update_vectors(pops))
        out["fitch_update_ms"] = statistics.median(
            timed(lambda: fp.update_vectors(pops))[1]
            for _ in range(ANA_REPS))
        root = tree.vroot
        edge = fp.edge_score(root.node_index, root.back.node_index)
        check(edge == cost, f"edge score {edge} != stepwise cost {cost}")
        e1 = np.array([h.node_index for h in traverse(tree.vroot)
                       if h.back is not None], np.int64)
        e2 = np.array([h.back.node_index for h in traverse(tree.vroot)
                       if h.back is not None], np.int64)
        scores = fp.batch_insert_scores(0, e1, e2)
        out["insert_scores_ms"] = host_ms(
            lambda: fp.batch_insert_scores(0, e1, e2), ANA_REPS)[1]
        h_vec, h_cost, h_scores = host_fitch(fp, pops, 0, e1, e2)
        inner = sorted({o.parent_score_index for o in pops})
        check(np.array_equal(fp.vectors.cpu().numpy().view(np.uint32)[inner],
                             h_vec[inner])
              and np.array_equal(fp.node_cost.cpu().numpy()[inner],
                                 h_cost[inner]),
              "Fitch vectors or costs on the card differ from numpy's")
        check(np.array_equal(scores, h_scores),
              "batch_insert_scores differ from numpy's")
        print(f"  parsimony: FastParsimony {out['fitch_init_ms']:.1f} ms "
              f"({fp.informative_count} informative patterns, const "
              f"{fp.const_cost}), native stepwise {out['stepwise_ms']:.1f} "
              f"ms (cost {cost}), Fitch over the tree's {len(pops)} ops on "
              f"the card {out['fitch_update_ms']:.2f} ms (median of "
              f"{ANA_REPS}; the first call {out['fitch_first_ms']:.2f} ms; "
              f"edge score {edge} == cost), {len(e1)} insertion scores "
              f"{out['insert_scores_ms']:.2f} ms (median of {ANA_REPS}; == "
              f"numpy Fitch on the host)", flush=True)
        out["parsimony_cost"] = cost

        k = ANA_PY_TAXA
        small = Partition(k, k - 2, 4, patterns, 1, 2 * k - 3, 1, k - 2,
                          device=device)
        small.set_tip_states_batch(maps.map_nt, comp[:k])
        small.set_pattern_weights(weights)
        fp_k = FastParsimony(small)
        (t_nat, c_nat), ms_nat = timed(
            lambda: fastparsimony_stepwise([fp_k], headers[:k], ANA_SEED))
        (t_py, c_py), ms_py = timed(lambda: fastparsimony_stepwise(
            [fp_k], headers[:k], ANA_SEED, use_native=False))
        check(c_nat == c_py and export_newick(t_nat.vroot)
              == export_newick(t_py.vroot),
              f"{k} taxa: the Python loop gives cost {c_py}, the native "
              f"build {c_nat}, or another tree")
        print(f"  {k} taxa: native stepwise {ms_nat:.1f} ms, the Python "
              f"loop with Fitch on the card {ms_py:.1f} ms: the same tree, "
              f"cost {c_nat}", flush=True)
        out.update(py_taxa=k, py_native_ms=ms_nat, py_loop_ms=ms_py)
        del fp, pars, fp_k, small

        # 4. the ML evaluation on the dense partition (kernel #1)
        seen = set()
        for nd in tree.nodes():
            for h in ([nd] if nd.is_tip() else list(nd.ring())):
                if h.back is not None and id(h) not in seen:
                    seen.update((id(h), id(h.back)))
                    h.length = h.back.length = 0.1
        reset_template_indices(tree.vroot, tree.tip_count)
        part = analysis_partition(tree, comp, weights, headers, device)
        eng = TreeEngine(part, tree)
        path = eng.execution_path
        reset_counts()
        lnl = eng.loglikelihood()
        dense_counts = counts()
        want = "fused" if path == "fused" else "level"
        check(path in ("fused", "levels-kernel") and dense_counts[want] > 0
              and all(c == 0 for kk, c in dense_counts.items()
                      if kk != want),
              f"dense path {path!r} launched {dense_counts}")
        invariant = part.count_invariant_sites()
        ops = create_operations(traverse(tree.vroot))[0]
        ref = f64_edge(part, ops, eng.branches, [0] * 4, tree.vroot)[0]
        out["dense_ms"] = host_ms(eng.loglikelihood, ANA_REPS)[1]
        print(f"  dense GTR+G4 on {path!r} ({len(ops)} ops): launches "
              f"{dense_counts}, {invariant} invariant sites, "
              f"loglikelihood() {out['dense_ms']:.3f} ms (host clock, "
              f"median of {ANA_REPS})", flush=True)
        if path == "fused":
            out["dense_max_abs_err"] = compare_traversal(
                "the stepwise tree", part, eng)[1]
            codes, pm, table = traversal_inputs(eng)
            kw = traversal_kw(part, eng)
            out["dense_call_ms"] = median_ms(
                lambda: fused_traversal(codes, pm, table, **kw))
            out["dense_plain_ms"] = median_ms(
                lambda: fused_traversal_reference(codes, pm, table, **kw),
                reps=ANA_REPS)
            out["dense_device_ms"] = fused_device(
                "the stepwise tree", part, eng, gpu)
            out["dense_bound"] = fused_bound(eng, part)
            print(f"  kernel #1 at {n} x {patterns}: call "
                  f"{out['dense_call_ms']:.4f} ms (CUDA events, median of "
                  f"{REPS}), plain version {out['dense_plain_ms']:.4f} ms "
                  f"(median of {ANA_REPS}), bound "
                  f"{out['dense_bound'][0]:.4f} ms by "
                  f"{out['dense_bound'][1]}", flush=True)
        check_logl("dense loglikelihood()", lnl, ref)
        out.update(dense_path=path, dense_launches=dense_counts[want],
                   dense_kernel=want, dense_rel_err=abs(lnl - ref)
                   / abs(ref), invariant_sites=invariant, logl=lnl)

        # 5. the same data as a site-repeats partition (kernel #5)
        rpart = analysis_partition(tree, comp, weights, headers, device,
                                   repeats=True)
        reng = TreeEngine(rpart, tree, pallas="pool")
        check(reng.execution_path == "pool-pallas",
              f"repeats on {reng.execution_path!r}")
        reset_counts()
        rlnl = reng.loglikelihood()
        rep_counts = counts()
        check(rep_counts["pool"] > 0 and all(
            c == 0 for kk, c in rep_counts.items() if kk != "pool"),
            f"'pool-pallas' launched {rep_counts}")
        n_cls, nat_ms, np_ms = classer_check(rpart, ops)
        out["pool_ms"] = host_ms(reng.loglikelihood, ANA_REPS)[1]
        out["pool_max_abs_err"] = compare_pool_case("the stepwise tree",
                                                    rpart, ops)[1]
        plan = rpart._pool_plan(ops, True)
        args = (rpart.clv_flat, rpart.sc_flat, rpart.pmatrix, plan,
                rpart.scale_threshold, rpart.scale_factor)
        out["pool_call_ms"] = median_ms(
            lambda: pool.update_partials_pool(*args))
        out["pool_plain_ms"] = median_ms(
            lambda: pool.update_partials_pool(
                *args, level=pool.pool_update_reference), reps=ANA_REPS)
        out["pool_device_ms"] = pool_device("the stepwise tree", rpart, ops,
                                            gpu)[0]
        _, levels = pool.schedule_pool_levels(
            copy.deepcopy(rpart.repeats), ops, rpart.tips,
            rpart.sites_padded, rpart.scale_buffers)
        out["pool_bound"] = pool_bound(rpart, levels)
        print(f"  kernel #5 at {n} x {patterns}: call "
              f"{out['pool_call_ms']:.4f} ms (CUDA events, median of "
              f"{REPS}), plain version {out['pool_plain_ms']:.4f} ms "
              f"(median of {ANA_REPS}), bound {out['pool_bound'][0]:.4f} "
              f"ms by {out['pool_bound'][1]}", flush=True)
        print(f"  repeats on 'pool-pallas': loglikelihood() "
              f"{out['pool_ms']:.3f} ms (host clock, median of "
              f"{ANA_REPS}), launches {rep_counts}; the "
              f"native classer's classes of {n} tips and {len(ops)} ops == "
              f"numpy's; its {n_cls} classed ops {nat_ms:.1f} ms native, "
              f"{np_ms:.1f} ms numpy (host clock)", flush=True)
        check_logl("'pool-pallas' loglikelihood() vs dense", rlnl, lnl)
        out.update(pool_launches=rep_counts["pool"], classer_ops=n_cls,
                   classer_native_ms=nat_ms, classer_numpy_ms=np_ms,
                   pool_rel_err=abs(rlnl - lnl) / abs(lnl))
        del reng, rpart

        # 6. bootstrap replicates from one evaluation
        (logls, W), out["bootstrap_ms"] = timed(
            lambda: bootstrap_loglikelihoods(eng, ANA_BOOT, seed=ANA_SEED))
        check(logls.shape == (ANA_BOOT,) and np.isfinite(logls).all()
              and np.all(W.sum(axis=1) == ANA_SITES),
              "bootstrap: bad replicates")
        for r in ANA_BOOT_CHECK:
            part.set_pattern_weights(W[r].astype(np.int64))
            check_logl(f"bootstrap replicate {r} re-evaluated",
                       eng.loglikelihood(), float(logls[r]))
        part.set_pattern_weights(weights)
        print(f"  {ANA_BOOT} bootstrap replicates in "
              f"{out['bootstrap_ms']:.1f} ms (host clock), mean "
              f"{logls.mean()!r}", flush=True)

        # 7. checkpoint and resume on the card
        lnl = eng.loglikelihood()
        ck_clv, ck = os.path.join(tmp, "clv.npz"), os.path.join(tmp, "a.npz")
        _, out["save_ms"] = timed(lambda: checkpoint.save(
            ck_clv, part, tree, include_clvs=True, logl=lnl))
        checkpoint.save(ck, part, tree, logl=lnl)
        (part2, tree2, extras), out["load_ms"] = timed(
            lambda: checkpoint.load(ck_clv, device=device))
        check(float(extras["logl"]) == lnl and torch.equal(part2.clv,
                                                           part.clv),
              "checkpoint: extras or CLVs differ after load")
        r = eng.root_idx
        blen = [float(eng.branches[r[4]])]
        edge_lk = []
        for p in (part, part2):
            p.update_prob_matrices([0] * 4, [r[4]], blen)
            edge_lk.append(p.compute_edge_loglikelihood(*r, [0] * 4))
        check(edge_lk[0] == edge_lk[1], f"checkpoint: the stored CLVs give "
              f"{edge_lk[1]!r}, the saved partition {edge_lk[0]!r}")
        part3, tree3, _ = checkpoint.load(ck, device=device)
        lk3 = TreeEngine(part3, tree3).loglikelihood()
        print(f"  checkpoint: save {out['save_ms']:.1f} ms, load "
              f"{out['load_ms']:.1f} ms (host clock); the root edge's logL "
              f"from the stored CLVs {edge_lk[1]!r} == the saved "
              f"partition's", flush=True)
        check_logl("reloaded engine's loglikelihood()", lk3, lnl)
    out["s"] = time.perf_counter() - t_phase
    print(f"analysis from an alignment file: {out['s']:.1f} s", flush=True)
    return out


# ------------------------------------- 23. placement, partitioned analyses
# phase 23a: the repo's own EPA workload, at tools/benchmarks.py:734-793's
# shapes; 23b: the main paths' problems as reference trees; 23c: a
# partitioned analysis on phase 20's DNA problem
EPA_TAXA, EPA_SITES, EPA_SEED = 101, 1024, 23
EPA_BATCH, EPA_CHUNK, EPA_TOP = 32, 16, 7
PLACE_DNA_BATCH, PLACE_AA_BATCH = 16, 4
PLACE_STREAM = 1000
# queries checked against place() after place_stream, and edges of the
# first query evaluated in float64 on the card
PLACE_STREAM_CHECK, PLACE_F64_EDGES = 8, 4
PART_DNA_BLOCKS, PART_AA_SITES, PART_STEPS = 3, 2048, 10


def query_checker(results, label):
    """A stand-in for ops/fused.py:fused_traversal in an EdgePlacer's query
    form (`EdgePlacer._traversal`): each launch (the path's own, counted by
    the wrapper), then the plain version on the same inputs: counts equal
    but at ties (`match_counts`), root CLVs within TOL_CLV of each site's
    max (the rows kernel's rounded modes to `mode_tolerances`). Appends
    each launch's (queries, edges, max_abs_err, its inputs) to `results`
    and returns the kernel's rows."""
    import torch
    from libpll2_tpu_torch.ops import fused

    def traversal(tip_codes, pmatrix, table, **kw):
        got = fused.fused_traversal(tip_codes, pmatrix, table, **kw)
        want = fused.fused_traversal_reference(tip_codes, pmatrix, table,
                                               **kw)
        q, e = got[0].shape[:2]
        clv_tol, tie_tol = mode_tolerances(kw["states"],
                                           kw.get("mxu", "split"))

        def block(en):
            """(query, edge, site) or (query, edge, rate, site)."""
            if kw.get("rate_scalers"):
                return (en[0], en[1], en[2], slice(None), en[3])
            return (en[0], en[1], slice(None), slice(None), en[2])

        ties = sum(match_counts(f"{label}, {which}", g_sc, w_sc, g_clv,
                                w_clv, block, kw["factor"], kw["threshold"],
                                clv_tol or 1.0, tie_tol)
                   for g_sc, w_sc, g_clv, w_clv, which in (
                       (got[2], want[2], got[0], want[0], "parent"),
                       (got[3], want[3], got[1], want[1], "child")))
        rel = err = 0.0
        for g, w in zip(got[:2], want[:2]):
            check(bool(torch.isfinite(g).all()), f"{label}: non-finite CLVs")
            site_max = w.abs().amax(dim=(2, 3)).clamp(min=1e-30)
            rel = max(rel, float(((g - w).abs()
                                  / site_max[:, :, None, None]).max()))
            err = max(err, float((g - w).abs().max()))
        check(clv_tol is None or rel <= clv_tol, f"{label}: query form vs "
              f"plain, max rel err {rel:.3e} > {clv_tol}")
        results.append({"q": q, "e": e, "max_abs_err": err, "rel": rel,
                        "ties": ties,
                        "inputs": ((tip_codes, pmatrix, table), kw)})
        return got

    return traversal


def reset_query_counts():
    from libpll2_tpu_torch.ops import fused

    reset_counts()
    fused.fused_traversal.query_launches = 0
    fused.fused_traversal_rows.query_launches = 0


def query_counts():
    from libpll2_tpu_torch.ops import fused

    return {"fused": fused.fused_traversal.query_launches,
            "rows": fused.fused_traversal_rows.query_launches}


def query_bound(part, q, k, n_ops, mxu="highest"):
    """One launch of the query form: the shared tip codes and the Q query
    rows read once, each candidate's P and table read once, the Q x K
    walks' two root CLVs and counts written once; Q x K traversals'
    operations (`rows_bound`'s peak for the contraction mode `mxu`)."""
    S, R, s = part.sites_padded, part.rate_cats, part.states
    n_bytes = (part.tips * S * 4 + q * S * 4
               + k * (part.prob_matrices * R * s * s * 4 + (n_ops + 1) * 32)
               + q * k * (2 * R * s * S * 4 + 2 * S * 4))
    return rows_bound(n_bytes, q * k * traversal_flops(n_ops, S, R, s), s,
                      mxu)


def leaves_behind(h):
    """Tip labels of the subtree behind half-edge h (away from h)."""
    out, stack = set(), [h.back]
    while stack:
        n = stack.pop()
        if n.is_tip():
            out.add(n.label)
            continue
        stack.extend(r.back for r in (n.next, n.next.next))
    return frozenset(out)


def pruned_reference(tree, by, victim):
    """(reference tree without `victim`, its dict, the victim's sequence,
    the leaf split of the edge it hung from) of a copy of `tree`."""
    from libpll2_tpu_torch.trees import export_newick, parse_newick, prune_tip
    from libpll2_tpu_torch.trees.utils import utree_clone

    full = utree_clone(tree)
    a = prune_tip(full, victim)
    side = leaves_behind(a)
    ref = parse_newick(export_newick(a if not a.is_tip() else a.back))
    return ref, {k: v for k, v in by.items() if k != victim}, by[victim], side


def mutated_queries(by, n, seed, alphabet, start=None):
    """`n` queries: copies of reference rows drawn from an rng of `seed`,
    5 % of their sites mutated and 20 % gapped (tools/benchmarks.py:
    770-778), after the given `start` ones."""
    import numpy as np

    rng = np.random.default_rng(seed)
    labels, chars = sorted(by), np.array(list(alphabet))
    out = dict(start or {})
    while len(out) < n:
        src = np.array(list(by[labels[int(rng.integers(len(labels)))]]))
        mut = rng.random(len(src)) < 0.05
        src[mut] = chars[rng.integers(0, len(chars), int(mut.sum()))]
        src[rng.random(len(src)) < 0.2] = "-"
        out[f"s{len(out)}"] = "".join(src)
    return out


def by_edge(rows):
    import numpy as np

    return np.array([r["logL"] for r in sorted(rows, key=lambda r:
                                               r["edge"])])


def place_f64(placer, seq, edges):
    """The logL of `seq` at the first `edges` attachment edges through the
    query form's plain version in float64 on the card."""
    import torch
    from libpll2_tpu_torch import constants as C
    from libpll2_tpu_torch.engine import _pmatrices
    from libpll2_tpu_torch.ops.fused import fused_traversal_reference
    from libpll2_tpu_torch.placement import _place_scores

    p, eng = placer.partition, placer._ensure_engine()
    f64, dev = torch.float64, p.device
    model = [torch.tensor(a, dtype=f64, device=dev) for a in (
        p.eigenvals, p.inv_eigenvecs, p.eigenvecs, p.prop_invar, p.rates,
        p.rate_weights, p.frequencies)] + [eng.params_idx_rates]
    tables, blens, roots, n_slots = placer._fused_batch_inputs()
    pm = _pmatrices(*model[:5], model[7], blens[:edges].to(f64).reshape(-1))
    pm = pm.view(edges, -1, *pm.shape[1:])
    codes = torch.as_tensor(placer._query_codes_batch([seq]).astype("int32"),
                            device=dev)
    out = _place_scores(codes, tables[:edges], pm,
                        torch.as_tensor(roots[:edges, 4], device=dev), model,
                        eng._site_args(), eng._tip_codes(), placer.query_row,
                        n_slots, C.SCALE_THRESHOLD, C.SCALE_FACTOR,
                        traversal=fused_traversal_reference)
    return out[0].cpu().numpy()


def placement_case(label, placer, batch, stream, chunk, gpu, jplace=False,
                   truth=None, victim=None):
    """One placement problem: place() of the victim (its true edge first
    where `truth`, the edge's leaf split, is given), place_batch of `batch`
    in chunks of `chunk` with every query-form launch held against its
    plain version, each query against place() (TOL_LOGL), the first
    against float64 on the card; then timed without the checks; the first
    launch's device time, bound and plain time; prepare_stream's level
    launches and ms, place_stream of `stream` (with to_jplace where
    `jplace`), its first queries against place() (2e-5). Returns the
    numbers."""
    import numpy as np
    import torch
    from libpll2_tpu_torch.ops import fused, levels
    from libpll2_tpu_torch.placement import to_jplace

    p = placer.partition
    kernel = "rows" if p.states >= fused.ROWS_STATES_MIN else "fused"
    out = {"edges": len(placer.edges), "taxa": placer.n_ref,
           "sites": p.sites, "states": p.states}
    if victim is not None:
        rows, ms = timed(lambda: placer.place(victim))
        out["place_ms"] = ms
        best = placer.edges[rows[0]["edge"]]
        if truth is not None:
            got = {leaves_behind(best), leaves_behind(best.back)}
            check(truth in got, f"{label}: the pruned taxon's true edge is "
                  f"not ranked first ({rows[0]})")
        print(f"placement [{label}] ({gpu}): {placer.n_ref} taxa x "
              f"{p.sites} sites, {len(placer.edges)} edges: place() of the "
              f"pruned taxon {ms:.1f} ms (host clock), best edge "
              f"{rows[0]['edge_nodes']} lwr {rows[0]['lwr']:.3f}"
              + (", its true edge" if truth is not None else ""), flush=True)
    # the query form, every launch against its plain version
    launches = []
    placer._traversal = query_checker(launches, f"{label} query form")
    reset_query_counts()
    got = placer.place_batch(batch, chunk=chunk)
    torch.cuda.synchronize()
    n_launch = query_counts()[kernel]
    all_counts = counts()
    placer._traversal = fused.fused_traversal
    check(n_launch == len(launches) and n_launch >= -(-len(batch) // chunk),
          f"{label}: {n_launch} query-form launches for {len(launches)} "
          f"checked ones")
    check(all_counts[kernel] == n_launch, f"{label}: launches {all_counts}")
    singles = {k: placer.place(v) for k, v in batch.items()}
    rel = max(float(np.max(np.abs(by_edge(got[k]) - by_edge(singles[k]))
                           / np.abs(by_edge(singles[k])))) for k in batch)
    check(rel < TOL_LOGL, f"{label}: place_batch vs place max rel err "
          f"{rel:.3e}")
    first = next(iter(batch))
    ref64 = place_f64(placer, batch[first], PLACE_F64_EDGES)
    rel64 = float(np.max(np.abs(by_edge(got[first])[:PLACE_F64_EDGES]
                                - ref64) / np.abs(ref64)))
    check(rel64 < TOL_LOGL, f"{label}: place_batch vs float64 max rel err "
          f"{rel64:.3e}")
    err = max(r["max_abs_err"] for r in launches)
    shapes = sorted({(r["q"], r["e"]) for r in launches})
    print(f"placement [{label}]: place_batch of {len(batch)} queries in "
          f"chunks of {chunk}: {n_launch} launches of the {kernel} kernel's "
          f"query form (queries x edges {shapes}; the launch budget "
          f"{placer._launch_bytes / 2**30:.1f} GiB a launch), each equal "
          f"to its plain version (max_abs_err {err:.3e}, "
          f"{sum(r['ties'] for r in launches)} ties); vs place() max rel err "
          f"{rel:.3e}, the first query vs float64 on the card "
          f"({PLACE_F64_EDGES} edges) {rel64:.3e}", flush=True)
    out.update(launches=n_launch, max_abs_err=err, rel_err=rel,
               rel_err_f64=rel64, launch_shapes=shapes)
    # times, without the checks
    _, ms = timed(lambda: placer.place_batch(batch, chunk=chunk))
    _, ms = timed(lambda: placer.place_batch(batch, chunk=chunk))
    (args, kw) = launches[0]["inputs"]
    q, e = launches[0]["q"], launches[0]["e"]
    n_ops = args[2].shape[1] - 1
    name = "fused_rows" if kernel == "rows" else "fused_"
    dev = kernel_device_us(lambda: fused.fused_traversal(*args, **kw), name)
    _, plain_ms = timed(lambda: fused.fused_traversal_reference(*args, **kw))
    bound = query_bound(p, q, e, n_ops, kw.get("mxu", "split"))
    plan = (rows_plan_text(p, kw["n_slots"], q * e, kw.get("mxu", "split"))
            if kernel == "rows"
            else plan_text(_kernels_plan(p, kw["n_slots"], q * e,
                                         kw.get("splits"))))
    print(f"placement times [{label}] ({gpu}): place_batch {ms:.1f} ms "
          f"({ms / len(batch):.2f} ms a query, {len(batch) / ms * 1e3:.1f} "
          f"queries/s, host clock); a launch of {q} x {e} walks of {n_ops} "
          f"ops, {kw['n_slots']} slots (the first edge's candidate "
          f"{placer._engine.fused_slots}), {plan}: device {dev:.1f} us "
          f"({dev / (q * e):.2f} us a walk), bound {bound[0]:.4f} ms by "
          f"{bound[1]}, plain {plain_ms:.1f} ms (once)", flush=True)
    out.update(batch_ms=ms, batch_queries_per_s=len(batch) / ms * 1e3,
               device_us=dev, device_us_per_walk=dev / (q * e),
               bound=bound, plain_ms=plain_ms, walks=q * e,
               slots=kw["n_slots"])
    # the streaming placer
    del launches
    levels.level_update.launches = 0
    _, prep_ms = timed(placer.prepare_stream)
    prep_launches = levels.level_update.launches
    check(prep_launches > 0, f"{label}: prepare_stream launched no level "
          f"kernel")
    placer.place_stream(dict(list(stream.items())[:64]))

    def run():
        res = placer.place_stream(stream)
        return (res, to_jplace(placer, res, top_k=EPA_TOP)) if jplace \
            else (res, None)

    (res, jp), stream_ms = timed(run)
    check(len(res) == len(stream), f"{label}: {len(res)} streamed rows")
    if jp is not None:
        check(len(jp["placements"]) == len(stream)
              and all(len(x["p"]) == EPA_TOP for x in jp["placements"]),
              f"{label}: jplace rows")
    keys = list(stream)[:PLACE_STREAM_CHECK]
    srel = max(float(np.max(np.abs(by_edge(res[k])
                                   - by_edge(placer.place(stream[k])))
                            / np.abs(by_edge(res[k])))) for k in keys)
    check(srel < 2e-5, f"{label}: place_stream vs place max rel err "
          f"{srel:.3e}")
    print(f"placement stream [{label}] ({gpu}): prepare_stream {prep_ms:.1f} "
          f"ms, {prep_launches} level-kernel launches; place_stream of "
          f"{len(stream)} queries{' + to_jplace(top_k=7)' if jplace else ''}"
          f" {stream_ms:.1f} ms ({len(stream) / stream_ms * 1e3:.0f} "
          f"queries/s, host clock); {len(keys)} vs place() max rel err "
          f"{srel:.3e}", flush=True)
    out.update(prepare_ms=prep_ms, prepare_level_launches=prep_launches,
               stream_ms=stream_ms,
               stream_queries_per_s=len(stream) / stream_ms * 1e3,
               stream_rel_err=srel)
    return out


def epa_problem(device):
    """Phase 23a: tools/benchmarks.py:734-793's problem, a 101-taxon
    random_utree (seed 23), 1024 sites simulated under GTR (1, 2, 1, 1, 2,
    1), frequencies 0.3/0.2/0.2/0.3, alpha 0.9; t100 pruned. Returns
    (placer, batch, stream, victim, truth)."""
    import numpy as np
    from libpll2_tpu_torch import EdgePlacer
    from libpll2_tpu_torch.trees import random_utree
    from libpll2_tpu_torch.utils import simulate_alignment

    full = random_utree([f"t{i}" for i in range(EPA_TAXA)], seed=EPA_SEED)
    freqs, subst = [0.3, 0.2, 0.2, 0.3], [1, 2, 1, 1, 2, 1.0]
    headers, seqs = simulate_alignment(full, EPA_SITES, freqs, subst,
                                       alpha=0.9, seed=EPA_SEED)
    ref, ref_by, victim, truth = pruned_reference(
        full, dict(zip(headers, seqs)), f"t{EPA_TAXA - 1}")
    placer = EdgePlacer(ref, ref_by, device=device)
    placer.set_model(freqs, subst, alpha=0.9)
    rng = np.random.default_rng(1)
    batch = {f"q{i}": "".join(rng.choice(list("ACGT"), size=EPA_SITES))
             for i in range(EPA_BATCH)}
    batch["q0"] = victim
    stream = mutated_queries(ref_by, PLACE_STREAM, 1, "ACGT")
    return placer, batch, stream, victim, truth


def placement_phase(device, gpu, big, big_by, aa_tree, aa_by):
    """Phase 23: placement (a: the EPA workload; b: the DNA and protein main
    paths' trees with a taxon pruned, at full width) and a partitioned
    analysis (c). Returns the numbers."""
    from libpll2_tpu_torch import EdgePlacer
    from libpll2_tpu_torch.models import load_aa_model
    from libpll2_tpu_torch import compute_gamma_cats

    t_phase = time.perf_counter()
    out = {}
    placer, batch, stream, victim, truth = epa_problem(device)
    out["epa"] = placement_case(f"EPA {EPA_TAXA - 1} x {EPA_SITES}", placer,
                                batch, stream,
                                EPA_CHUNK, gpu, jplace=True, truth=truth,
                                victim=victim)
    del placer, stream
    # b: the DNA main path's problem with t127 pruned
    ref, ref_by, victim, truth = pruned_reference(big, big_by,
                                                  f"t{N_TAXA - 1}")
    placer = EdgePlacer(ref, ref_by, device=device)
    freqs, subst = dna_model()
    placer.set_model(freqs, subst, alpha=0.8)
    batch = mutated_queries(ref_by, PLACE_DNA_BATCH, 2, "ACGT",
                            start={"victim": victim})
    stream = mutated_queries(ref_by, PLACE_STREAM, 3, "ACGT", start=batch)
    out["dna"] = placement_case(f"DNA {N_TAXA - 1} x {N_SITES}", placer,
                                batch, stream, PLACE_DNA_BATCH, gpu)
    del placer, stream
    # b: the protein main path's problem, LG+G4, 'split'
    ref, ref_by, victim, truth = pruned_reference(aa_tree, aa_by,
                                                  f"t{AA_TAXA - 1}")
    placer = EdgePlacer(ref, ref_by, states=20, device=device)
    load_aa_model(placer.partition, "lg")
    placer.partition.set_category_rates(compute_gamma_cats(0.9, 4))
    placer._engine = placer._stream = None
    batch = mutated_queries(ref_by, PLACE_AA_BATCH, 4,
                            "ARNDCQEGHILKMFPSTWYV", start={"victim": victim})
    stream = mutated_queries(ref_by, PLACE_STREAM, 5, "ARNDCQEGHILKMFPSTWYV",
                             start=batch)
    check(placer._ensure_engine().mxu == "split", "protein placer's mode")
    out["aa"] = placement_case(f"protein {AA_TAXA - 1} x {AA_SITES}",
                               placer, batch, stream, PLACE_AA_BATCH, gpu)
    del placer, stream
    out["partitioned"] = partitioned_case(device, gpu)
    out["s"] = time.perf_counter() - t_phase
    print(f"placement and partitioned analyses: {out['s']:.1f} s",
          flush=True)
    return out


def partitioned_units(device, tree, by, aa_by, **options):
    """Phase 23c's partitions over `tree`: the DNA alignment's columns in
    PART_DNA_BLOCKS blocks, each under its own GTR+G4 (an rng of seed 100 +
    block), and the protein alignment under LG+G4; `options`
    (sites_alignment) go to every Partition."""
    import numpy as np
    from libpll2_tpu_torch import Partition, compute_gamma_cats
    from libpll2_tpu_torch.io import maps
    from libpll2_tpu_torch.models import load_aa_model

    bounds = np.linspace(0, N_SITES, PART_DNA_BLOCKS + 1).astype(int)
    parts = []
    for k in range(PART_DNA_BLOCKS):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        p = Partition(tree.tip_count, tree.inner_count, 4, hi - lo, 1,
                      tree.edge_count, 4, tree.inner_count, device=device,
                      **options)
        for tip in tree.tips():
            p.set_tip_states(tip.clv_index, maps.map_nt,
                             by[tip.label][lo:hi])
        rng = np.random.default_rng(100 + k)
        p.set_frequencies(0, rng.dirichlet(np.ones(4) * 10))
        p.set_subst_params(0, rng.uniform(0.5, 2.0, size=6))
        p.set_category_rates(compute_gamma_cats(0.6 + 0.2 * k, 4))
        parts.append(p)
    p = Partition(tree.tip_count, tree.inner_count, 20, PART_AA_SITES, 1,
                  tree.edge_count, 4, tree.inner_count, device=device,
                  **options)
    for tip in tree.tips():
        p.set_tip_states(tip.clv_index, maps.map_aa, aa_by[tip.label])
    load_aa_model(p, "lg")
    p.set_category_rates(compute_gamma_cats(0.9, 4))
    parts.append(p)
    return parts


def partitioned_case(device, gpu):
    """Phase 23c: a PartitionedEngine on phase 20's DNA problem (its
    simulated 128 x 16384 alignment in PART_DNA_BLOCKS partitions, the
    search's start tree) plus a PART_AA_SITES-site LG+G4 protein partition
    simulated on the true tree: loglikelihood() against four single
    engines and the float64 plain path, three linked newton_step()s, one
    streamed SPR round (radius 5) against its batched twin, and
    PART_STEPS maximize() steps of subst and freqs."""
    from libpll2_tpu_torch import PartitionedEngine, TreeEngine
    from libpll2_tpu_torch.search import TreeSearch
    from libpll2_tpu_torch.trees import random_utree, tree_bipartitions
    from libpll2_tpu_torch.trees.utils import utree_clone

    out = {}
    start, _, by = search_start()
    aa_by = simulated(random_utree([f"t{i}" for i in range(N_TAXA)],
                                   seed=SEED), PART_AA_SITES, SEED + 1,
                      states=20)
    tree = utree_clone(start)
    parts = partitioned_units(device, tree, by, aa_by)
    reset_counts()
    pe = PartitionedEngine(parts, tree)
    lk = pe.loglikelihood()
    got = counts()
    check(got["fused"] == PART_DNA_BLOCKS and got["rows"] == 1,
          f"partitioned loglikelihood(): launches {got}")
    singles = sum(TreeEngine(p, tree).loglikelihood() for p in parts)
    rel = abs(lk - singles) / abs(singles)
    check(rel < 1e-6, f"partitioned logL {lk!r} vs the single engines' sum "
          f"{singles!r}")
    ref = sum(plain_float64(p, e, e.branches)[0]
              for p, e in zip(parts, pe.engines))
    rel64 = abs(lk - ref) / abs(ref)
    check(rel64 < TOL_LOGL, f"partitioned logL vs float64 {rel64:.3e}")
    steps = [pe.newton_step() for _ in range(3)]
    lens = {float(e.branches[int(e.root_idx[4])]) for e in pe.engines}
    check(len(lens) == 1, f"linked newton_step left lengths {lens}")
    print(f"partitioned [{PART_DNA_BLOCKS} DNA blocks of {N_SITES} sites + "
          f"LG+G4 x {PART_AA_SITES}, {N_TAXA} taxa] ({gpu}): logL {lk!r} "
          f"(launches {got}); vs 4 single engines {rel:.2e}, vs float64 "
          f"{rel64:.2e}; 3 linked newton_step()s: "
          + ", ".join(f"({s[0]:.4f}, d1 {s[1]:.3f})" for s in steps)
          + f", root length {lens.pop():.6f}", flush=True)
    out.update(loglikelihood=lk, rel_err=rel, rel_err_f64=rel64)
    # one streamed SPR round against its batched twin, each from the start
    rounds = {}
    for kind in ("streamed", "batched"):
        t = utree_clone(start)
        us = parts if kind == "streamed" else partitioned_units(
            device, t, by, aa_by)
        search = TreeSearch(None, t, engine=PartitionedEngine(us, t))
        search.evaluate()
        if kind == "streamed":
            check(search._streamed_eligible(), "partitioned streamed round "
                  "not eligible")
        reset_counts()
        fn = getattr(search, f"spr_round_{kind}")
        (lk_r, acc), ms = timed(lambda: fn(radius=SEARCH_RADIUS))
        rounds[kind] = (lk_r, acc, ms, counts(), tree_bipartitions(t))
        del search, us
    (lk_s, acc_s, ms_s, c_s, sp_s), (lk_b, acc_b, ms_b, c_b, sp_b) = (
        rounds["streamed"], rounds["batched"])
    check(acc_s == acc_b and acc_s > 0, f"partitioned SPR rounds accepted "
          f"{acc_s} streamed, {acc_b} batched")
    check(sp_s == sp_b, f"partitioned SPR rounds end in different "
          f"topologies: {len(sp_s ^ sp_b)} splits differ")
    rel_r = abs(lk_s - lk_b) / abs(lk_b)
    check(rel_r < TOL_LOGL, f"partitioned SPR rounds end {lk_s!r} vs "
          f"{lk_b!r}")
    check(c_s["level"] > 0, f"streamed round: launches {c_s}")
    print(f"partitioned SPR round (radius {SEARCH_RADIUS}) ({gpu}): "
          f"streamed {acc_s} moves, {ms_s:.1f} ms, launches {c_s}; batched "
          f"twin {acc_b} moves, {ms_b:.1f} ms, launches {c_b}; logL "
          f"{lk_s!r} vs {lk_b!r} ({rel_r:.2e}), the same {len(sp_s)} "
          f"splits", flush=True)
    out.update(spr_moves=acc_s, spr_streamed_ms=ms_s, spr_batched_ms=ms_b,
               spr_streamed_launches=c_s, spr_batched_launches=c_b)
    # maximize: each unit's model by maximize_fused (kernel paths)
    pe = PartitionedEngine(parts, tree)
    lk0 = pe.loglikelihood()
    reset_counts()
    (lk_m, params, hist), ms = timed(lambda: pe.maximize(
        ("subst", "freqs"), steps=PART_STEPS, chunk=PART_STEPS))
    c_m = counts()
    check(c_m["fused"] >= PART_DNA_BLOCKS * PART_STEPS and c_m["rows"] >=
          PART_STEPS, f"partitioned maximize: launches {c_m}")
    lk1 = pe.loglikelihood()
    check(lk_m >= lk0 and abs(lk1 - lk_m) / abs(lk_m) < TOL_LOGL,
          f"partitioned maximize: {lk0!r} -> {lk_m!r}, re-evaluated {lk1!r}")
    print(f"partitioned maximize (subst, freqs; {PART_STEPS} steps a unit) "
          f"({gpu}): logL {lk0!r} -> {lk_m!r} in {ms:.1f} ms, launches "
          f"{c_m}, {len(params)} parameter groups", flush=True)
    out.update(maximize_ms=ms, maximize_launches=c_m, maximize_gain=lk_m
               - lk0)
    return out

# phase 24: the certified evaluation's float64 walk against its plain
# version (both float64: FMA contraction against PyTorch's order), relative
# to each site's largest entry; its logL against float64 on the CPU at gate
# case dna_df64's budget (bench_validate.py:255-262)
TOL_F64_CLV = 1e-12
TOL_DF64 = 1e-8
# the flagship pipeline cut to depth for the smoke run (its full depth is
# examples/flagship_1000.py's DEPTH: 2 x (60 steps + 2 sweep passes), 3
# final passes): 10 maximize_fused steps, no sweep in stage 3, one final
# pass; a sweep pass at 1000 taxa is host-bound (~3000 steps)
FLAGSHIP_SMOKE_DEPTH = {"rounds": 1, "fused_steps": 10, "round_passes": 0,
                        "final_passes": 1}
# the H100 SXM's float64 peak outside the tensor cores (NVIDIA's data sheet)
H100_F64_FLOP_PER_S = 34e12
# phase 24a's caterpillar: 300 taxa of random columns at alpha 0.5 rescale
# every site in float64's 2^-256 window (twice at most), as the gpu test's
# 300-taxon case does; 80 taxa never reach it
F64_CATERPILLAR_TAXA = 300


def walk_flops(table, sites: int, rates: int, states: int) -> int:
    """The operations of one walk over the op table `table`, per site and
    rate: for each child side a matrix-vector product (s^2 FMAs, 2 s^2
    FLOP) where the child is a slot or a raw tip row, a column gather (s)
    where it is a state-code tip (table column 1 or 4 equal to 1), and the
    two sides' elementwise product (s)."""
    sides = table[:-1][:, [1, 4]].cpu()
    n_code = int((sides == 1).sum())
    n_dense = sides.numel() - n_code
    n_ops = sides.shape[0]
    return sites * rates * states * (n_dense * 2 * states + n_code + n_ops)


def f64_bound(walk):
    """One float64 walk: the tips' codes (and raw rows, 8 s bytes a site),
    P and the op table read once, the root edge's two CLVs (8 bytes a
    value) and counts written once; its operations (`walk_flops`) at the
    float64 peak."""
    codes, pm, table = walk["tip_codes"], walk["pmatrix"], walk["table"]
    R, s, S = walk["rates"], walk["states"], codes.shape[1]
    raw = walk["tip_clvs"]
    n_bytes = (codes.numel() * 4 + pm.numel() * 8 + table.numel() * 4
               + (0 if raw is None else raw.numel() * 8)
               + 2 * R * s * S * 8 + 2 * S * 4)
    return bound_ms(n_bytes, walk_flops(table, S, R, s),
                    peak=H100_F64_FLOP_PER_S)


def certified_case(label, part, tree, cpu_part, gpu, must_scale=False):
    """Phase 24a on one problem: the float64 walk (one launch) against its
    plain version on the card (counts equal, CLVs TOL_F64_CLV of each
    site's max; with `must_scale`, some count above 0),
    `loglikelihood_df64` on the card (its launches counted)
    against `cpu_part` (the same data in float64 on the CPU) through the
    plain path at TOL_DF64, the launch's device time, call, bound and the
    plain version's time. Returns a dict of them."""
    import torch
    from libpll2_tpu_torch import TreeEngine, loglikelihood_df64
    from libpll2_tpu_torch.ops import _kernels, df64, fused
    from libpll2_tpu_torch.trees import create_operations, traverse

    ops, branches, pidx = create_operations(traverse(tree.vroot))
    walk = df64.walk_inputs(part, tree, ops, branches, pidx)
    got = fused.fused_traversal_f64(**walk)
    torch.cuda.synchronize()
    want = fused.fused_traversal_reference(**walk)
    for what, g, w in (("sc_p", got[2], want[2]), ("sc_c", got[3], want[3])):
        check(torch.equal(g, w), f"{label}: float64 walk {what} differs from "
              f"the plain version at {int((g != w).sum())} sites")
    err = 0.0
    for g, w in zip(got[:2], want[:2]):
        scale = w.abs().amax(dim=(0, 1)).clamp_min(1e-300)
        err = max(err, float(((g - w).abs() / scale).max()))
    check(err <= TOL_F64_CLV, f"{label}: float64 walk {err:.3e} from the "
          f"plain version (> {TOL_F64_CLV})")
    max_count = int(max(got[2].max(), got[3].max()))
    check(max_count > 0 or not must_scale, f"{label}: the float64 walk "
          f"never rescaled")
    reset_counts()
    t0 = time.perf_counter()
    lk = loglikelihood_df64(part, tree)
    lk_ms = (time.perf_counter() - t0) * 1e3
    got_counts = counts()
    check_counts(f"{label} loglikelihood_df64", got_counts, {"f64": 1})
    ref = TreeEngine(cpu_part, tree, pallas=False).loglikelihood()
    rel = abs(lk - ref) / abs(ref)
    check(rel <= TOL_DF64, f"{label}: certified logL {lk!r} is {rel:.3e} "
          f"from float64 on the CPU {ref!r}")
    call = median_ms(lambda: fused.fused_traversal_f64(**walk))
    plain = median_ms(lambda: fused.fused_traversal_reference(**walk),
                      reps=5)
    dev = kernel_device_us(lambda: fused.fused_traversal_f64(**walk),
                           "fused_generic<double") / 1e3
    bound = f64_bound(walk)
    S = walk["tip_codes"].shape[1]
    plan = _kernels.device_generic_plan(
        part.device, walk["rates"], walk["states"], walk["n_slots"], False, S,
        itemsize=8, raw_tips=walk["tip_clvs"] is not None)
    blocks = -(-S // plan.sites_per_block)
    print(f"certified {label} ({len(ops)} ops, {S} sites, "
          f"{walk['states']} states x {walk['rates']} rates, "
          f"{walk['n_slots']} slots, {blocks} blocks; {plan_text(plan)}; "
          f"{gpu}): logL "
          f"{lk:.10f}, float64 CPU {ref:.10f} (rel {rel:.3e}), "
          f"loglikelihood_df64 {lk_ms:.2f} ms; walk vs plain {err:.3e}, "
          f"max count {max_count}; device "
          f"{dev * 1e3:.1f} us, call {call:.4f} ms, bound {bound[0]:.4f} ms "
          f"by {bound[1]}, plain {plain:.4f} ms", flush=True)
    return {"launches": got_counts["f64"], "max_abs_err": err,
            "rel_err": rel, "logl": lk, "ms": call, "plain_ms": plain,
            "device_ms": dev, "bound": bound, "sites": S,
            "ops": len(ops), "slots": walk["n_slots"], "blocks": blocks,
            "plan": plan.plan, "sites_per_block": plan.sites_per_block,
            "depth": plan.depth, "smem_bytes": plan.smem_bytes,
            "df64_ms": lk_ms, "max_count": max_count}


def annotation_cost(eng):
    """What the engine's profiler annotations (utils/profiling.py:annotate)
    cost outside a profiler: one `with annotate(...)` block's host us
    against a bare call (the least of 5 runs of 100000 each), times the
    annotations one DNA main-path loglikelihood() opens (counted inside a
    CPU profiler), as a share of that call's median host ms."""
    import timeit

    import torch
    from libpll2_tpu_torch.utils.profiling import annotate

    def block():
        with annotate("annotation.cost"):
            pass

    def bare():
        pass

    block_us, bare_us = (min(timeit.repeat(fn, number=100000, repeat=5)) * 10
                         for fn in (block, bare))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.loglikelihood()
    names = [e.name for e in prof.events()
             if e.name.startswith(("pll.", "sweep."))]
    call_ms = host_ms(eng.loglikelihood, reps=50)[1]
    share = len(names) * (block_us - bare_us) / (call_ms * 1e3)
    print(f"annotations outside a profiler: one block {block_us:.3f} us (a "
          f"bare call {bare_us:.3f} us); {len(names)} a DNA main-path "
          f"loglikelihood() ({sorted(set(names))}) of {call_ms:.4f} ms "
          f"median host time: {100 * share:.3f} %", flush=True)
    return {"annotate_us": block_us, "bare_us": bare_us,
            "per_call": len(names), "call_ms": call_ms, "share": share}


def certified_phase(device, gpu, eng, big, big_by, aa_tree, aa_by):
    """Phase 24: (b) the flagship pipeline at 1000 x 4000 through
    examples/flagship_1000.run, cut to FLAGSHIP_SMOKE_DEPTH, its launches
    counted (the certified evaluation one launch of the float64 walk), its
    certified logL against the checkpoint in float64 on the CPU at
    TOL_DF64 and its float32 final logL within TOL_LOGL of that; (a) the
    certified evaluation on the DNA main path (128 x 16384), the protein
    (128 x 8192 LG+G4), the F64_CATERPILLAR_TAXA x 16384 caterpillar at
    alpha 0.5 (which must rescale) and the flagship's final 1000-taxon tree
    (`certified_case`); then the profiler annotations' cost
    (`annotation_cost`)."""
    import shutil
    import tempfile

    import torch
    from libpll2_tpu_torch import TreeEngine, checkpoint
    from libpll2_tpu_torch.examples import flagship_1000

    out_dir = tempfile.mkdtemp(prefix="flagship_smoke_")
    try:
        stages, split = [], []
        reset_counts()
        t0 = time.perf_counter()
        info = flagship_1000.run(ANA_TAXA, ANA_SITES, stages=stages,
                                 search_split=split, device=device,
                                 out_dir=out_dir,
                                 depth=FLAGSHIP_SMOKE_DEPTH)
        wall = time.perf_counter() - t0
        flag_counts = counts()
        print(f"  flagship pipeline: launches {flag_counts}", flush=True)
        check(flag_counts["f64"] == 1 and flag_counts["fused"] > 0
              and flag_counts["level"] > 0,
              f"flagship pipeline: launches {flag_counts}, expected one of "
              f"the float64 walk and some of the fused and level kernels")
        flag_part, flag_tree = info["partition"], info["tree"]
        # the checkpoint's partition in float64 on the CPU (its model and
        # tips exactly) on the run's own tree; the example's cross-check
        # (fp64_check) reads the checkpoint's newick, whose six decimals
        # round each length
        flag_cpu = checkpoint.load(info["ckpt"], dtype=torch.float64,
                                   device="cpu")[0]
        ref = TreeEngine(flag_cpu, flag_tree, pallas=False).loglikelihood()
        fp64 = flagship_1000.fp64_check(info["ckpt"])
        rel = abs(info["df64_logl"] - ref) / abs(ref)
        rel32 = abs(info["logl"] - ref) / abs(ref)
        rel_ckpt = abs(info["df64_logl"] - fp64) / abs(fp64)
        check(rel <= TOL_DF64, f"flagship: certified logL "
              f"{info['df64_logl']!r} is {rel:.3e} from float64 {ref!r} on "
              f"the CPU")
        check(rel32 <= TOL_LOGL, f"flagship: float32 final logL "
              f"{info['logl']!r} is {rel32:.3e} from float64 {ref!r}")
        print(f"flagship 1000 x 4000 ({info['patterns']} patterns; depth "
              f"{FLAGSHIP_SMOKE_DEPTH}; {gpu}): {wall:.1f} s; certified "
              f"{info['df64_logl']:.6f}, float64 CPU {ref:.6f} (rel "
              f"{rel:.3e}), float32 final {info['logl']:.6f} (rel "
              f"{rel32:.3e}); the checkpoint's float64 {fp64:.6f} (rel "
              f"{rel_ckpt:.3e}); SPR split {split}", flush=True)
        for stage, secs in stages:
            print(f"  stage {stage}: {secs * 1e3:.1f} ms", flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    problems = [(*gpu_problem, cpu_problem[1]) for gpu_problem, cpu_problem
                in zip(f64_walk_problems(device, big, big_by, aa_tree, aa_by),
                       f64_walk_problems("cpu", big, big_by, aa_tree, aa_by,
                                         dtype=torch.float64))]
    problems.append(("flagship 1000 x 3581, final tree", flag_part,
                     flag_tree, flag_cpu))
    cases = {}
    for label, part, tree, cpu_part in problems:
        cases[label] = certified_case(label, part, tree, cpu_part, gpu,
                                      must_scale=label.startswith("cater"))
        del cpu_part
    return {"cases": cases, "flagship": {
        "launches": flag_counts, "wall_s": wall, "stages": stages,
        "search_split": split, "rel_err": rel, "rel_err_f32": rel32,
        "rel_err_checkpoint": rel_ckpt, "patterns": info["patterns"]},
        "annotations": annotation_cost(eng)}

# phase 25: site sharding on one card. MESH_SHARDS shards of one device run
# one after another: the phase shows that the sharded path is right and runs
# each kernel once a shard; its times are per-shard overhead, not scaling.
MESH_SHARDS = 4
MESH_DEVICE = "cuda:0"
REP_MESH_SITES = 4464         # REP_SITES trimmed to MESH_SHARDS x 1116
MESH_REPS = 10
MESH_NOTE = (f"one card running {MESH_SHARDS} shards one after another: "
             f"per-shard overhead, not scaling")


def mesh_of(n=MESH_SHARDS):
    from libpll2_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[MESH_DEVICE] * n)


def epilogue_on_columns(ref, rows, lo, hi):
    """The per-site logL of the likelihood epilogue
    (ops/likelihood.py:edge_loglikelihood) run on the columns [lo, hi) of
    the unsharded engine `ref`'s root rows `rows`, with its P-matrices and
    site data: what a shard of those columns computes from equal rows."""
    from libpll2_tpu_torch.ops import likelihood as ops_likelihood

    p = ref.partition
    m = ref._model_args()
    pw, inv = ref._site_args()
    clv_p, clv_c, sc_p, sc_c = (r[..., lo:hi].contiguous() for r in rows)
    modes = dict(p._modes(), col0=lo)
    return ops_likelihood.edge_loglikelihood(
        clv_p, clv_c, sc_p, sc_c, p.pmatrix[ref.root_idx[4]], m[6], m[3],
        m[5], m[7], pw[lo:hi], inv[lo:hi], p.scale_threshold, **modes)[1]


def mesh_columns(label, eng, ref):
    """Each shard's root rows and scaler counts against the unsharded
    engine's columns at the same branch lengths: equal (every kernel is
    elementwise over sites); and each shard's per-site logL equal to the
    likelihood epilogue run on the unsharded rows cut to its columns
    (`epilogue_on_columns`). The epilogue's contractions over the states
    are cuBLAS GEMMs, whose algorithm may depend on the width: the sites
    where the unsharded run's own per-site logL differs, and by how many
    ulp, are printed. Returns the largest CLV difference (0.0)."""
    import torch

    ref._set_branches(eng.branches)
    _, per1, rows1 = ref._evaluate()
    _, per, rows = eng._shards.evaluate(eng.branches)
    torch.cuda.synchronize()
    max_abs, lo = 0.0, 0
    for shard in rows:
        w = shard[0].shape[-1]
        for got, want in zip(shard, rows1):
            cols = want[..., lo:lo + w]
            diff = float((got.double() - cols.double()).abs().max())
            max_abs = max(max_abs, diff)
            check(torch.equal(got, cols), f"{label}: shard at column {lo}: "
                  f"root rows or counts differ from the unsharded run's "
                  f"(max {diff!r})")
        sliced = epilogue_on_columns(ref, rows1, lo, lo + w)
        n_off = int((per[lo:lo + w] != sliced).sum())
        check(n_off == 0, f"{label}: shard at column {lo}: per-site logL "
              f"differs at {n_off} sites from the epilogue on the unsharded "
              f"rows cut to its columns")
        lo += w
    ulps = float(((per - per1).abs() / (per1.abs() * 2.0 ** -23)
                  .clamp_min(1e-30)).max())
    n_diff = int((per != per1).sum())
    print(f"  {label}: {len(rows)} shards' root rows and counts equal the "
          f"unsharded run's columns, and their per-site logL the epilogue "
          f"on those columns; against the unsharded run's per-site logL "
          + ("equal" if n_diff == 0 else f"{n_diff} sites differ, "
             f"{ulps:.2f} ulp at most (the epilogue at full width)"),
          flush=True)
    return max_abs


def mesh_calls(label, eng, ref, gpu, newton=True):
    """Medians (ms, CUDA events) of loglikelihood() and newton_step() on the
    sharded engine and its unsharded twin, printed with MESH_NOTE."""
    out = {"loglikelihood_ms": median_ms(eng.loglikelihood, MESH_REPS),
           "loglikelihood_unsharded_ms": median_ms(ref.loglikelihood,
                                                   MESH_REPS)}
    if newton:
        out["newton_step_ms"] = median_ms(eng.newton_step, MESH_REPS)
        out["newton_step_unsharded_ms"] = median_ms(ref.newton_step,
                                                    MESH_REPS)
    print(f"  {label} times ({MESH_NOTE}; {gpu}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items()), flush=True)
    return out


def mesh_fused_case(label, part, ref_part, tree, gpu, want_kernel, mxu,
                    n_newton, tol=TOL_LOGL):
    """A sharded fused-path engine: loglikelihood() and `n_newton`
    newton_step()s with the kernel's launches counted (once a shard a
    call), the totals against the float64 plain path at the same branch
    lengths, the columns against the unsharded run's, one shard's kernel
    call beside the unsharded call, and the times."""
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.ops.fused import fused_traversal

    eng = TreeEngine(part, tree, mxu=mxu)
    ref = TreeEngine(ref_part, tree, mxu=mxu)
    check(eng.execution_path == "fused" and len(eng._shards.engines)
          == MESH_SHARDS, f"{label}: path {eng.execution_path}")
    inputs = [eng.branches.clone()]
    reset_counts()
    lnl = eng.loglikelihood()
    steps = []
    for _ in range(n_newton):
        inputs.append(eng.branches.clone())
        steps.append(eng.newton_step())
    got = counts()
    calls = 1 + n_newton
    check_counts(f"{label}: loglikelihood() + {n_newton} newton_step()",
                 got, {want_kernel: calls * MESH_SHARDS})
    for i, ((lk, *d), b) in enumerate(zip([(lnl,)] + steps, inputs)):
        ref64 = plain_float64(ref_part, ref, b)
        what = "loglikelihood()" if i == 0 else f"newton_step {i}"
        if tol == TOL_LOGL:
            check_logl(f"{label} {what} vs float64", lk, ref64[0],
                       d or None, ref64[1:] if d else None)
        else:
            rel = abs(lk - ref64[0]) / abs(ref64[0])
            check(rel < tol, f"{label} {what}: rel {rel:.2e} >= {tol}")
            print(f"  {label} {what}: logL {lk!r}, float64 {ref64[0]!r} "
                  f"(rel {rel:.2e})", flush=True)
    max_abs = mesh_columns(label, eng, ref)
    se = eng._shards.engines[0]
    codes, pm, table = traversal_inputs(se)
    kw = dict(traversal_kw(se.partition, se), mxu=mxu)
    rcodes, rpm, rtable = traversal_inputs(ref)
    rkw = dict(traversal_kw(ref_part, ref), mxu=mxu)
    shard_ms = median_ms(lambda: fused_traversal(codes, pm, table, **kw))
    full_ms = median_ms(lambda: fused_traversal(rcodes, rpm, rtable, **rkw))
    print(f"  {label}: the kernel on one shard's {se.partition.sites_padded} "
          f"columns {shard_ms:.4f} ms, on the unsharded {ref_part.sites} "
          f"{full_ms:.4f} ms (median of {REPS}, CUDA events; {gpu})",
          flush=True)
    out = {"launches": got[want_kernel], "max_abs_err": max_abs,
           "ms_per_shard": shard_ms, "unsharded_ms": full_ms,
           "bound_per_shard": fused_bound(se, se.partition),
           **mesh_calls(label, eng, ref, gpu)}
    return out


def mesh_dna(device, gpu, big, big_by):
    """25.1 and 25.3: the DNA main path's problem on the mesh: the fused
    path, then the step-by-step API with a partial traversal and
    pallas='levels-kernel' on the level kernel."""
    import torch
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.ops import levels
    from libpll2_tpu_torch.trees import create_operations, traverse

    mesh = mesh_of()
    part = dna_partition(big, big_by, N_SITES, MESH_DEVICE,
                         sites_alignment=MESH_SHARDS, mesh=mesh)
    ref_part = dna_partition(big, big_by, N_SITES, device)
    out = {"fused": mesh_fused_case(f"sharded DNA {N_TAXA} x {N_SITES}",
                                    part, ref_part, big, gpu, "fused",
                                    "split", 3)}
    # the step-by-step chain, a partial traversal after one branch length
    # changes (equal to the full list), then 'levels-kernel'
    label = "sharded DNA step by step"
    r = big.vroot
    params = [0] * 4
    reset_counts()
    ops, blen, lnl, d = step_by_step(part, big)
    got = counts()
    n_levels = len(levels.schedule_levels(ops, part.tips))
    check_counts(f"{label}: one traversal", got,
                 {"level": n_levels * MESH_SHARDS})
    ref = f64_edge(ref_part, ops, blen, params, r)
    check_logl(f"{label}: edge vs float64", lnl, ref[0], d, ref[1:3])
    mat = next(o.child1_matrix_index for o in ops
               if o.child1_clv_index < part.tips)
    bad = set()
    for o in ops:
        if (mat in (o.child1_matrix_index, o.child2_matrix_index)
                or o.child1_clv_index in bad or o.child2_clv_index in bad):
            bad.add(o.parent_clv_index)
    partial = create_operations(traverse(
        r, cbtrav=lambda n: not n.is_tip() and n.clv_index in bad))[0]
    blen2 = blen.clone()
    blen2[mat] *= 3.0
    part.update_prob_matrices(params, [mat], [float(blen2[mat])])
    reset_counts()
    part.update_partials(partial)
    got_p = counts()
    lnl_p = step_edge(part, big, blen2, params, False)[0]
    clv_p, sc_p = part._dense_buffers()
    part.update_partials(ops)
    lnl_f = step_edge(part, big, blen2, params, False)[0]
    clv_f, sc_f = part._dense_buffers()
    n = part.nodes
    check(lnl_p == lnl_f and torch.equal(clv_p[:n], clv_f[:n])
          and torch.equal(sc_p, sc_f), f"{label}: partial traversal "
          f"{lnl_p!r} differs from the full one {lnl_f!r}")
    del clv_p, sc_p, clv_f, sc_f
    n_partial = len(levels.schedule_levels(partial, part.tips))
    check(got_p["level"] == n_partial * MESH_SHARDS,
          f"{label}: partial traversal launches {got_p}")
    check_logl(f"{label}: partial traversal ({len(partial)} of {len(ops)} "
               f"ops, equal to the full one) vs float64", lnl_p,
               f64_edge(ref_part, ops, blen2, params, r)[0])
    lk_eng = TreeEngine(part, big, pallas="levels-kernel")
    lk_ref = TreeEngine(ref_part, big, pallas="levels-kernel")
    check(lk_eng.execution_path == "levels-kernel", "levels-kernel path")
    inputs = [lk_eng.branches.clone()]
    reset_counts()
    rows = [(lk_eng.loglikelihood(), None, None)]
    for _ in range(2):
        inputs.append(lk_eng.branches.clone())
        rows.append(lk_eng.newton_step())
    got_l = counts()
    check_counts("sharded 'levels-kernel': loglikelihood() + 2 "
                 "newton_step()", got_l,
                 {"level": 3 * n_levels * MESH_SHARDS})
    for i, (b, (lk, d1, d2)) in enumerate(zip(inputs, rows)):
        ref = f64_edge(ref_part, ops, b.cpu().double(), params, r)
        what = "loglikelihood()" if i == 0 else f"newton_step {i}"
        check_logl(f"sharded 'levels-kernel' {what} vs float64", lk, ref[0],
                   None if d1 is None else (d1, d2),
                   None if d1 is None else ref[1:3])
    sp = lk_eng._shards.engines[0].partition
    shard_ms = median_ms(lambda: run_levels(sp, ops, levels.level_update))
    full_ms = median_ms(lambda: run_levels(ref_part, ops,
                                           levels.level_update))
    print(f"  the level kernel over one traversal of a shard's "
          f"{sp.sites_padded} columns {shard_ms:.4f} ms, of the unsharded "
          f"{N_SITES} {full_ms:.4f} ms (median of {REPS}, CUDA events; "
          f"{gpu})", flush=True)
    out["levels"] = {"launches": got["level"] + got_p["level"]
                     + got_l["level"], "levels": n_levels,
                     "partial_ops": len(partial),
                     "ms_per_shard": shard_ms, "unsharded_ms": full_ms,
                     "bound_per_shard": level_bound(sp, ops),
                     **mesh_calls("sharded 'levels-kernel'", lk_eng, lk_ref,
                                  gpu)}
    return out


def mesh_sweep(device, gpu, big, big_by):
    """25.3b: one pass of newton_smooth_all on the DNA problem, sharded and
    unsharded, each on its own copy of the tree: every step's level
    launch once a shard (counted), the final logL within TOL_LOGL of the
    unsharded sweep's and the lengths within float32 summation order."""
    import numpy as np
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.optimize import newton_smooth_all
    from libpll2_tpu_torch.trees.utils import utree_clone

    runs = {}
    for kind in ("unsharded", "sharded"):
        tree = utree_clone(big)
        part = (dna_partition(tree, big_by, N_SITES, MESH_DEVICE,
                              sites_alignment=MESH_SHARDS, mesh=mesh_of())
                if kind == "sharded" else
                dna_partition(tree, big_by, N_SITES, device))
        eng = TreeEngine(part, tree, pallas="levels-kernel")
        eng.loglikelihood()
        reset_counts()
        lk, ms = timed(lambda: newton_smooth_all(eng, tree, passes=1,
                                                 iterations=2))
        runs[kind] = (lk, ms, counts(), eng.branches.cpu().double().numpy())
        del eng, part
    (lk_m, ms_m, c_m, b_m), (lk_1, ms_1, c_1, b_1) = (runs["sharded"],
                                                       runs["unsharded"])
    rel = abs(lk_m - lk_1) / abs(lk_1)
    check(rel < TOL_LOGL, f"sharded newton_smooth_all {lk_m!r} vs {lk_1!r}")
    blen_rel = float(np.max(np.abs(b_m - b_1) / np.maximum(b_1, 1e-6)))
    check(blen_rel < 1e-3, f"sharded newton_smooth_all lengths differ by "
          f"{blen_rel:.2e}")
    check(c_m["level"] == MESH_SHARDS * c_1["level"] and c_1["level"] > 0,
          f"sharded newton_smooth_all launches {c_m}, unsharded {c_1}")
    print(f"sharded newton_smooth_all (1 pass, 2 iterations; {N_TAXA} x "
          f"{N_SITES}) ({MESH_NOTE}; {gpu}): logL {lk_m!r} in {ms_m:.1f} ms, "
          f"launches {c_m}; unsharded {lk_1!r} in {ms_1:.1f} ms, launches "
          f"{c_1} ({rel:.2e}; lengths within {blen_rel:.2e})", flush=True)
    return {"ms": ms_m, "unsharded_ms": ms_1, "launches": c_m["level"],
            "rel_err": rel, "branch_rel_err": blen_rel}


def mesh_protein(device, gpu, aa_tree, aa_by):
    """25.2: LG+G4 at 128 x 8192 on the mesh in 'split' and 'bf16'."""
    mesh = mesh_of()
    part = protein_partition(aa_tree, aa_by, AA_SITES, MESH_DEVICE,
                             sites_alignment=MESH_SHARDS, mesh=mesh)
    ref_part = protein_partition(aa_tree, aa_by, AA_SITES, device)
    return {mode: mesh_fused_case(
        f"sharded protein {AA_TAXA} x {AA_SITES} [{mode}]", part, ref_part,
        aa_tree, gpu, "rows", mode, 3 if mode == "split" else 1,
        tol=TOL_LOGL if mode == "split" else TOL_BF16_LOGL)
        for mode in ("split", "bf16")}


def mesh_search(device, gpu):
    """25.4: one streamed SPR round of phase 20's problem on the mesh and
    unsharded, each from its own copy of the start: the same moves and
    splits, logL within TOL_LOGL, the passes' level launches once a
    shard."""
    from libpll2_tpu_torch.search import TreeSearch
    from libpll2_tpu_torch.trees import tree_bipartitions
    from libpll2_tpu_torch.trees.utils import utree_clone

    start, _, by = search_start()
    rounds = {}
    # the first round pays the warm-ups (the native library, handles);
    # the unsharded one runs again after the sharded one and is reported
    for kind in ("unsharded", "sharded", "unsharded"):
        t = utree_clone(start)
        part = (dna_partition(t, by, N_SITES, MESH_DEVICE,
                              sites_alignment=MESH_SHARDS, mesh=mesh_of())
                if kind == "sharded" else
                dna_partition(t, by, N_SITES, device))
        s = TreeSearch(part, t)
        s.evaluate()
        check(s._streamed_eligible(), f"{kind} streamed round not eligible")
        reset_counts()
        (lk, acc), ms = timed(lambda: s.spr_round_streamed(
            radius=SEARCH_RADIUS))
        rounds[kind] = (lk, acc, ms, counts(), tree_bipartitions(t))
        del s, part
    (lk_m, acc_m, ms_m, c_m, sp_m), (lk_1, acc_1, ms_1, c_1, sp_1) = (
        rounds["sharded"], rounds["unsharded"])
    check(acc_m == acc_1 and acc_m > 0, f"sharded SPR round accepted "
          f"{acc_m}, unsharded {acc_1}")
    check(sp_m == sp_1, f"sharded SPR round ends in another topology: "
          f"{len(sp_m ^ sp_1)} splits differ")
    rel = abs(lk_m - lk_1) / abs(lk_1)
    check(rel < TOL_LOGL, f"sharded SPR round logL {lk_m!r} vs {lk_1!r}")
    check(c_m["level"] == MESH_SHARDS * c_1["level"] and c_m["fused"]
          == MESH_SHARDS * c_1["fused"], f"sharded SPR round launches "
          f"{c_m}, unsharded {c_1}")
    print(f"sharded streamed SPR round (radius {SEARCH_RADIUS}, {N_TAXA} x "
          f"{N_SITES}) ({MESH_NOTE}; {gpu}): {acc_m} moves in {ms_m:.1f} ms, "
          f"launches {c_m}; unsharded {acc_1} moves in {ms_1:.1f} ms, "
          f"launches {c_1}; logL {lk_m!r} vs {lk_1!r} ({rel:.2e}), the "
          f"same {len(sp_m)} splits", flush=True)
    return {"moves": acc_m, "ms": ms_m, "unsharded_ms": ms_1,
            "launches": c_m, "unsharded_launches": c_1, "rel_err": rel}


def mesh_optimize(device, gpu):
    """25.5: one maximize_fused step of phase 21's problem on the mesh
    against the unsharded step, on 'fused' (the trials in one launch a
    shard) and on 'levels-kernel' (the level kernel's trial form: one
    launch a level a chunk a shard, 13 levels x 2 chunks unsharded)."""
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.optimize import (make_fused_loglikelihood_fn,
                                            maximize_fused)

    tree, by, ref_part = opt_problem(device)
    part = dna_partition(tree, by, N_SITES, MESH_DEVICE,
                         sites_alignment=MESH_SHARDS, mesh=mesh_of())
    part.set_frequencies(0, ref_part.frequencies[0])
    part.set_subst_params(0, ref_part.subst_params[0])
    res = {}
    for pallas, kernel in (("auto", "fused"), ("levels-kernel", "level")):
        out = {}
        engines = {"sharded": TreeEngine(part, tree, pallas=pallas),
                   "unsharded": TreeEngine(ref_part, tree, pallas=pallas)}
        for eng in engines.values():
            fn, x0, _ = make_fused_loglikelihood_fn(eng, ("subst", "freqs"))
            fn(x0[None])         # the first eigh on the card pays its set-up
        for kind, eng in engines.items():
            reset_counts()
            (lk, _, hist), ms = timed(lambda: maximize_fused(
                eng, ("subst", "freqs"), steps=1, chunk=1))
            out[kind] = (lk, hist, ms, counts())
        (lk_m, h_m, ms_m, c_m), (lk_1, h_1, ms_1, c_1) = (out["sharded"],
                                                           out["unsharded"])
        rel = max(abs(lk_m - lk_1) / abs(lk_1),
                  abs(h_m[0] - h_1[0]) / abs(h_1[0]))
        check(rel < TOL_LOGL, f"sharded maximize_fused step on {pallas!r} "
              f"{lk_m!r} / {h_m[0]!r} vs {lk_1!r} / {h_1[0]!r}")
        ref = engines["unsharded"]
        want = (2 if kernel == "fused" else
                (trial_chunks(ref, 2 * x0.numel() + 1)
                 + trial_chunks(ref, 2)) * trial_launches(ref))
        check_counts(f"unsharded maximize_fused step on {pallas!r}", c_1,
                     {kernel: want})
        check_counts(f"sharded maximize_fused step on {pallas!r}", c_m,
                     {kernel: MESH_SHARDS * want})
        print(f"sharded maximize_fused step on "
              f"{ref.execution_path!r} (subst, freqs; {N_TAXA} x "
              f"{N_SITES}) ({MESH_NOTE}; {gpu}): logL {h_m[0]!r} -> "
              f"{lk_m!r} in {ms_m:.1f} ms, launches {c_m}; unsharded "
              f"{h_1[0]!r} -> {lk_1!r} in {ms_1:.1f} ms, launches {c_1} "
              f"({rel:.2e})", flush=True)
        res[kernel] = {"ms": ms_m, "unsharded_ms": ms_1,
                       "launches": c_m[kernel], "rel_err": rel}
    return {**res["fused"], "levels_kernel": res["level"]}


def mesh_repeats(device, gpu, flagship):
    """25.6: ShardedRepeatsEngine on the 246 x 4465 problem trimmed to
    REP_MESH_SITES columns (MESH_SHARDS x 1116): the shards'
    'repeats-dense-fused' (kernel #1) and pooled (kernel #5) paths against
    the unsharded repeats partition on the same columns, and one batched
    SPR round with the same moves."""
    import numpy as np
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch import constants as PC
    from libpll2_tpu_torch.parallel import ShardedRepeatsEngine
    from libpll2_tpu_torch.search import TreeSearch, _internal_edges
    from libpll2_tpu_torch.trees import (create_operations, moves,
                                         traverse, tree_bipartitions)
    from libpll2_tpu_torch.trees.utils import utree_clone

    tree, by, _ = flagship
    w = REP_MESH_SITES // MESH_SHARDS
    model = ([0.25] * 4, [1, 2, 1, 1, 2, 1.0])

    def shard_parts(t, dev=MESH_DEVICE):
        return [repeats_partition(t, {k: v[i * w:(i + 1) * w]
                                      for k, v in by.items()}, w, dev,
                                  model=model, alpha=0.7)
                for i in range(MESH_SHARDS)]

    def whole(t, repeats=True):
        return repeats_partition(t, {k: v[:REP_MESH_SITES]
                                     for k, v in by.items()},
                                 REP_MESH_SITES, device, repeats=repeats,
                                 model=model, alpha=0.7)

    print(f"sharded repeats: {REP_TAXA} x {REP_SITES} trimmed to "
          f"{REP_MESH_SITES} = {MESH_SHARDS} x {w} columns (the mesh needs "
          f"equal shards)", flush=True)
    out = {}
    mesh = mesh_of()
    for kind, kw, ref_kw, want in (
            ("repeats-dense-fused", {}, {}, "fused"),
            ("pool-pallas", {"dense_fused": False}, {"pallas": "pool"},
             "pool")):
        eng = ShardedRepeatsEngine(tree, shard_parts(tree), mesh, **kw)
        ref = TreeEngine(whole(tree), tree, **ref_kw)
        check(eng.execution_path == kind == ref.execution_path,
              f"sharded repeats: {eng.execution_path}, unsharded "
              f"{ref.execution_path}")
        reset_counts()
        lk = eng.loglikelihood()
        step = eng.newton_step()
        got = counts()
        check_counts(f"sharded repeats [{kind}]: loglikelihood() + "
                     f"newton_step()", got, {want: 2 * MESH_SHARDS})
        check_logl(f"sharded repeats [{kind}] loglikelihood() vs "
                   f"unsharded", lk, ref.loglikelihood())
        r = ref.newton_step()
        check_logl(f"sharded repeats [{kind}] newton_step vs unsharded",
                   step[0], r[0], step[1:], r[1:])
        se = eng.engines[0]
        sp = se.partition
        if kind == "pool-pallas":
            ops = create_operations(traverse(tree.vroot))[0]
            shard_ms = median_ms(lambda: run_pool(sp, ops))
            full_ms = median_ms(lambda: run_pool(ref.partition, ops))
        else:
            from libpll2_tpu_torch.ops.fused import fused_traversal
            codes, pm, table = traversal_inputs(se)
            kw2 = traversal_kw(sp, se)
            rcodes, rpm, rtable = traversal_inputs(ref)
            rkw = traversal_kw(ref.partition, ref)
            shard_ms = median_ms(lambda: fused_traversal(codes, pm, table,
                                                         **kw2))
            full_ms = median_ms(lambda: fused_traversal(rcodes, rpm, rtable,
                                                        **rkw))
        print(f"  [{kind}] the kernel on one shard's {w} columns "
              f"{shard_ms:.4f} ms, on the unsharded {REP_MESH_SITES} "
              f"{full_ms:.4f} ms (median of {REPS}, CUDA events; {gpu})",
              flush=True)
        out[kind] = {"launches": got[want], "ms_per_shard": shard_ms,
                     "unsharded_ms": full_ms}
    # one batched SPR round, two seeded NNI moves from the true tree
    rng = np.random.default_rng(REP_SEED)
    start = utree_clone(tree)
    for _ in range(2):
        edges = _internal_edges(start)
        moves.nni(edges[rng.integers(len(edges))], PC.UTREE_MOVE_NNI_LEFT,
                  None)
    rounds = {}
    for kind in ("unsharded", "sharded", "unsharded"):
        t = utree_clone(start)
        if kind == "sharded":
            s = TreeSearch(None, t, engine=ShardedRepeatsEngine(
                t, shard_parts(t), mesh))
        else:
            s = TreeSearch(whole(t), t, pallas="auto")
        reset_counts()
        (lk, acc), ms = timed(lambda: s.spr_round_batched(radius=3))
        rounds[kind] = (lk, acc, ms, counts(), tree_bipartitions(t))
    (lk_m, acc_m, ms_m, c_m, sp_m), (lk_1, acc_1, ms_1, c_1, sp_1) = (
        rounds["sharded"], rounds["unsharded"])
    rel = abs(lk_m - lk_1) / abs(lk_1)
    check(acc_m == acc_1 and sp_m == sp_1 and rel < TOL_LOGL,
          f"sharded repeats SPR round: {acc_m} moves, logL {lk_m!r}; "
          f"unsharded {acc_1}, {lk_1!r}; {len(sp_m ^ sp_1)} splits differ")
    check(c_m["fused"] >= MESH_SHARDS and c_m["fused"] % MESH_SHARDS == 0,
          f"sharded repeats SPR round launches {c_m}")
    print(f"sharded repeats batched SPR round (radius 3) ({MESH_NOTE}; "
          f"{gpu}): {acc_m} moves in {ms_m:.1f} ms, launches {c_m}; "
          f"unsharded {acc_1} moves in {ms_1:.1f} ms, launches {c_1}; logL "
          f"{lk_m!r} vs {lk_1!r} ({rel:.2e})", flush=True)
    out["spr_round"] = {"moves": acc_m, "ms": ms_m, "unsharded_ms": ms_1,
                        "launches": c_m}
    return out


def mesh_partitioned(device, gpu):
    """25.7: PartitionedEngine.shard on phase 23c's four units (each
    padded to a multiple of MESH_SHARDS columns): loglikelihood() and two
    linked newton_step()s against the unsharded units."""
    from libpll2_tpu_torch import PartitionedEngine
    from libpll2_tpu_torch.trees import random_utree
    from libpll2_tpu_torch.trees.utils import utree_clone

    start, _, by = search_start()
    aa_by = simulated(random_utree([f"t{i}" for i in range(N_TAXA)],
                                   seed=SEED), PART_AA_SITES, SEED + 1,
                      states=20)
    tree = utree_clone(start)
    parts = partitioned_units(MESH_DEVICE, tree, by, aa_by,
                              sites_alignment=MESH_SHARDS)
    PartitionedEngine.shard(parts, mesh_of())
    ref_parts = partitioned_units(device, tree, by, aa_by)
    pe, ref = PartitionedEngine(parts, tree), PartitionedEngine(ref_parts,
                                                                tree)
    reset_counts()
    lk = pe.loglikelihood()
    steps = [pe.newton_step() for _ in range(2)]
    got = counts()
    check_counts("sharded partitioned loglikelihood() + 2 newton_step()",
                 got, {"fused": 3 * PART_DNA_BLOCKS * MESH_SHARDS,
                       "rows": 3 * MESH_SHARDS})
    check_logl("sharded partitioned loglikelihood() vs unsharded", lk,
               ref.loglikelihood())
    for i, s in enumerate(steps):
        r = ref.newton_step()
        check_logl(f"sharded partitioned newton_step {i + 1} vs unsharded",
                   s[0], r[0], s[1:], r[1:])
    ms = median_ms(pe.loglikelihood, MESH_REPS)
    ms1 = median_ms(ref.loglikelihood, MESH_REPS)
    print(f"  sharded partitioned loglikelihood() {ms:.3f} ms, unsharded "
          f"{ms1:.3f} ms ({MESH_NOTE}; {gpu})", flush=True)
    return {"launches": got, "loglikelihood_ms": ms,
            "loglikelihood_unsharded_ms": ms1}


def mesh_processes(gpu):
    """25.8: tests/torch_mh_worker.py on the card: one process of
    MESH_SHARDS shards, then 2 processes (torch.distributed over gloo: the
    ranks share the card) of MESH_SHARDS / 2 shards each, at 128 x 16384;
    logL, d1 and d2 equal, each rank's per-site logL its block of the
    one-process run's, the fused kernel launched once a shard a call."""
    import shutil
    import socket
    import tempfile

    worker = os.path.join(REPO, "tests", "torch_mh_worker.py")
    deadline = 150

    def group(n, shards):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                            "RANK")}
        tmp = tempfile.mkdtemp(prefix="pll_mh_")
        logs = [(os.path.join(tmp, f"{r}.out"), os.path.join(tmp, f"{r}.err"))
                for r in range(n)]
        t0 = time.perf_counter()
        procs = []
        for r, (out, err) in enumerate(logs):
            with open(out, "w") as fo, open(err, "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, worker, str(r), str(n), str(port),
                     str(shards), MESH_DEVICE, str(N_TAXA), str(N_SITES),
                     str(deadline)], cwd=REPO, env=env, stdout=fo,
                    stderr=fe))
        try:
            for p in procs:
                try:
                    p.wait(timeout=deadline + 30)
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ms = (time.perf_counter() - t0) * 1e3
        for p, (_, err) in zip(procs, logs):
            with open(err) as fe:
                tail = fe.read()[-3000:]
            check(p.returncode == 0, f"{n} processes: a worker exited "
                  f"{p.returncode}: {tail}")
        outs = []
        for out, _ in logs:
            with open(out) as fo:
                outs.append(json.loads(fo.read().splitlines()[-1]))
        shutil.rmtree(tmp)
        return outs, ms

    (one,), ms1 = group(1, MESH_SHARDS)
    two, ms2 = group(2, MESH_SHARDS // 2)
    for rank in two:
        for key in ("lk", "lk2", "d1", "d2"):
            check(rank[key] == one[key], f"2 processes: rank {rank['rank']} "
                  f"{key} {rank[key]!r} != one process's {one[key]!r}")
        check(rank["fused_launches"] == 2 * rank["shards"],
              f"rank {rank['rank']}: {rank['fused_launches']} launches")
    check(one["fused_launches"] == 2 * MESH_SHARDS,
          f"one process: {one['fused_launches']} launches")
    per = [x for r in two for x in r["persite"]]
    check(per == one["persite"], "2 processes: per-site blocks differ from "
          "the one-process run's")
    print(f"2 processes x {MESH_SHARDS // 2} shards (gloo, one card) vs 1 "
          f"process x {MESH_SHARDS} shards at {N_TAXA} x {N_SITES}: logL "
          f"{two[0]['lk']!r}, d1 {two[0]['d1']!r}, d2 {two[0]['d2']!r}, "
          f"equal on every rank; loglikelihood() {two[0]['ms']:.3f} ms (rank "
          f"0) vs {one['ms']:.3f} ms; wall clock of the runs {ms2:.0f} ms "
          f"vs {ms1:.0f} ms ({MESH_NOTE}; {gpu})", flush=True)
    return {"loglikelihood_ms": two[0]["ms"],
            "loglikelihood_one_process_ms": one["ms"],
            "run_ms": ms2, "run_one_process_ms": ms1,
            "launches": sum(r["fused_launches"] for r in two)}


def mesh_phase(device, gpu, big, big_by, aa_tree, aa_by, flagship):
    """Phase 25: site sharding (libpll2_tpu_torch.parallel) on one card,
    MESH_SHARDS shards of MESH_DEVICE."""
    print(f"phase 25: site sharding over {MESH_SHARDS} shards of "
          f"{MESH_DEVICE} ({MESH_NOTE})", flush=True)
    out = {"dna": mesh_dna(device, gpu, big, big_by),
           "sweep": mesh_sweep(device, gpu, big, big_by),
           "protein": mesh_protein(device, gpu, aa_tree, aa_by),
           "search": mesh_search(device, gpu),
           "optimize": mesh_optimize(device, gpu),
           "repeats": mesh_repeats(device, gpu, flagship),
           "partitioned": mesh_partitioned(device, gpu),
           "processes": mesh_processes(gpu)}
    res = subprocess.run([sys.executable, "-m",
                          "libpll2_tpu_torch.examples.sharded_multichip",
                          "--shards", str(MESH_SHARDS), "--device",
                          MESH_DEVICE.split(":")[0]], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    check(res.returncode == 0 and "sharded logL" in res.stdout,
          f"examples/sharded_multichip.py --shards {MESH_SHARDS} exited "
          f"{res.returncode}: {res.stderr[-2000:]}")
    print("examples/sharded_multichip.py --shards "
          f"{MESH_SHARDS}: exit 0; " + " | ".join(res.stdout.splitlines()),
          flush=True)
    return out


# phase 26: alphabets of 33 to 64 states and float64 partitions on the card.
# A codon-sized alphabet (61 states: the sense codons) at a concatenated-gene
# length: the DNA main path's tree (128 taxa, random_utree seed 7), 4096
# sites simulated by utils/simulate.py under seeded GTR exchangeabilities
# and frequencies (S64_SEED) with Gamma(0.7) x 4, evaluated under the same
# model; its repeats twin on the same tree shortened to 0.15 len + 0.001
# (conserved). The level and pool kernels run it through their 64-state
# instantiations (csrc/states64.cuh). S64_SMALL is the 40-state, per-rate
# and caterpillar cases' width; S64_GROUPS the maximize_fused step's group
# (60 free frequencies: 121 trials, where the 1,830 exchangeabilities would
# give 3,661). The float64 partitions are bench.py's DNA problem and the
# 246 x 4465 repeats problem, each against float64 on the CPU; the streamed
# SPR iteration runs at radius S64_F64_RADIUS and the sweep pass at
# S64_F64_ITERATIONS Newton iterations an edge (reduced depth: the CPU
# reference must run it too).
S64_STATES, S64_SITES, S64_SEED = 61, 4096, 26
S64_SMALL = 1000
S64_GROUPS = ("freqs",)
S64_F64_RADIUS = 2
S64_F64_ITERATIONS = 2
# float64 on the card against float64 on the CPU: logL and d1/d2, relative
# (d1/d2 with a floor of 1e-3)
TOL_F64_LOGL = 1e-12
TOL_F64_D = 1e-10
S64_KERNELS = ("level_generic64", "pool_generic64")


def s64_model(states):
    """The seeded GTR frequencies and exchangeabilities of an alphabet of
    `states` letters."""
    import numpy as np

    rng = np.random.default_rng(S64_SEED + states)
    return (rng.dirichlet(np.ones(states) * 5),
            rng.uniform(0.5, 2.0, states * (states - 1) // 2))


def s64_problem(taxa, sites, states=S64_STATES, conserved=False,
                caterpillar=False):
    """(tree, {label: sequence}) of `states` letters (LETTERS64) simulated
    under `s64_model` with Gamma(0.7) x 4 on random_utree(seed 7) of
    `taxa` taxa (or a caterpillar), conserved: its branches shortened to
    0.15 len + 0.001."""
    from libpll2_tpu_torch.trees import parse_newick, random_utree
    from libpll2_tpu_torch.utils import simulate_alignment

    tree = (parse_newick(caterpillar_newick(taxa)) if caterpillar
            else random_utree([f"t{i}" for i in range(taxa)], seed=SEED))
    if conserved:
        conserve(tree, 0.15, 0.001)
    freqs, subst = s64_model(states)
    headers, seqs = simulate_alignment(tree, sites, freqs, subst, alpha=0.7,
                                       seed=S64_SEED,
                                       alphabet=LETTERS64[:states])
    return tree, dict(zip(headers, seqs))


def s64_partition(tree, by_label, sites, device, states=S64_STATES,
                  repeats=False, rates=4, **options):
    """A float32 partition of `s64_problem`'s data (dense, or site repeats)
    under `s64_model` with Gamma(0.7) x `rates`; `options` go to
    Partition."""
    import torch
    from libpll2_tpu_torch import Partition, compute_gamma_cats

    options.setdefault("dtype", torch.float32)
    part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, rates, tree.inner_count, device=device,
                     site_repeats=repeats, **options)
    tips = list(tree.tips())
    part.set_tip_states_batch(charmap(states),
                              [by_label[t.label] for t in tips],
                              [t.clv_index for t in tips])
    freqs, subst = s64_model(states)
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, subst)
    part.set_category_rates(compute_gamma_cats(0.7, rates))
    return part


def ptxas_report(lib_path, names=S64_KERNELS):
    """{kernel: (registers, spill stores, spill loads) of each
    instantiation} from the build's `-Xptxas -v` log, for the kernels whose
    mangled names hold one of `names`."""
    import re

    log = lib_path.with_suffix(".log")
    out, current = {}, None
    if not log.exists():
        return out
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            form = "trials" if "ILb1E" in m.group(1) else "one topology"
            current = next((f"{n}<{form}>" for n in names
                            if n in m.group(1)), None)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(current, {})["spills"] = (int(m.group(1)),
                                                     int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(current, {})["registers"] = int(m.group(1))
            current = None
    return out


def s64_kernel_cases(device):
    """Phase 26a: the level and pool kernels' 64-state body against their
    plain versions on the card: 40 states and 61 per rate at 16 x
    S64_SMALL, the 80-taxon caterpillar at 61 states (scaling must
    trigger), an op that writes its own child, 5 rates (a cluster of 5
    blocks), 10 rates at 40 states (a cluster of 8, two blocks taking 2
    rates each) and the full-width 61-state problem; pool cases at 40
    states, 61 per rate, 40 x 10 rates and the conserved full-width
    problem, each level one rate warp. Returns the largest absolute error
    of each kernel."""
    level_err, pool_err = 0.0, 0.0
    for name, taxa, sites, states, kw in (
            ("40 states", 16, S64_SMALL, 40, {}),
            ("61 states, per rate", 16, S64_SMALL, 61,
             {"rate_scalers": True}),
            ("61 states, caterpillar", 80, S64_SMALL, 61,
             {"caterpillar": True}),
            ("61 states, an op writing its own child", 16, S64_SMALL, 61,
             {"self_child": True}),
            ("61 states, 5 rates (a cluster of 5)", 16, S64_SMALL, 61,
             {"rates": 5}),
            ("40 states, 10 rates (2 rates a block)", 16, S64_SMALL, 40,
             {"rates": 10}),
            (f"61 states, {N_TAXA} x {S64_SITES}", N_TAXA, S64_SITES, 61,
             {})):
        cat, self_child = kw.pop("caterpillar", False), kw.pop("self_child",
                                                               False)
        tree, by = s64_problem(taxa, sites, states, caterpillar=cat)
        part = s64_partition(tree, by, sites, device, states, **kw)
        ops = traversal_ops(part, tree)[0]
        if self_child:
            err = compare_level_case(name, part, [self_child_op(
                ops, part.tips)], first=ops)[1]
        else:
            err = compare_level_case(name, part, ops, must_scale=cat)[1]
        level_err = max(level_err, err)
        del part
    for name, taxa, sites, states, kw in (
            ("40 states", 24, S64_SMALL, 40, {}),
            ("61 states, per rate", 24, S64_SMALL, 61,
             {"rate_scalers": True}),
            ("40 states, 10 rates (2 rates a block)", 24, S64_SMALL, 40,
             {"rates": 10}),
            (f"61 states, conserved {N_TAXA} x {S64_SITES}", N_TAXA,
             S64_SITES, 61, {})):
        tree, by = s64_problem(taxa, sites, states, conserved=True)
        part = s64_partition(tree, by, sites, device, states, repeats=True,
                             **kw)
        ops = traversal_ops(part, tree)[0]
        pool_err = max(pool_err, compare_pool_case(name, part, ops,
                                                   layouts={1})[1])
        del part
    return level_err, pool_err


def s64_level_bounds(part, widths):
    """Each level's own bound over the level kernel (us, 'bytes' or
    'operations'): its ops' two child rows read and parent row written
    (`level_device`'s 3 rows an op) against `traversal_flops` of its ops."""
    R, s, S = part.rate_cats, part.states, part.sites_padded
    out = []
    for w in widths:
        t, by = bound_ms(3 * w * R * s * S * 4,
                         traversal_flops(w, S, R, s))
        out.append((t * 1e3, by))
    return out


def s64_plans(part, widths=None, plan=None):
    """The 64-state body's layout of each level (csrc/states64.cuh), as
    (blocks a cluster, tiles a block, blocks): the level kernel's from
    ops/_kernels.py:level64_plan over the levels' ops `widths` with the
    card's resident clusters, the pool kernel's from the pool plan's
    launches (`plan`)."""
    from libpll2_tpu_torch.ops import _kernels

    if plan is not None:
        return [(lay.cluster, lay.tiles_per_block, lay.blocks)
                for lay in plan.launches]
    resident = _kernels.device_states64_resident(part.device, "level",
                                                 part.rate_cats)
    return [(p.cluster, p.tiles_per_block, p.blocks) for p in (
        _kernels.level64_plan(w, part.sites_padded, part.rate_cats, resident)
        for w in widths)]


def s64_levels_text(label, widths, level_us, bounds, plans, gpu):
    """Prints each level's device time beside its own bound and its plan
    (narrow and wide levels apart); `bounds` (us, by) or us."""
    rows = []
    for b, w, us, (cluster, per, blocks) in zip(bounds, widths, level_us,
                                                plans):
        b = b if isinstance(b, tuple) else (b, "")
        rows.append(f"{w}, cluster {cluster} x {per} tile"
                    f"{'s' if per > 1 else ''} a block, {blocks} blocks: "
                    f"{us:.1f} / {b[0]:.1f}{' ' + b[1] if b[1] else ''} "
                    f"({us / b[0]:.1f}x)")
    print(f"{label} by level ({gpu}; width, plan: device us / its own bound "
          f"us): " + "; ".join(rows), flush=True)


def s64_matmul_yardstick(part, width, gpu):
    """A yardstick the port never calls: one batched torch.matmul (float32,
    TF32 off) that computes only the contractions of a level of `width`
    ops, [ops x R x 2, 64, 64] @ [ops x R x 2, 64, S], on seeded random
    inputs (no product of the two children, no rescale, no counts, so not
    the level's function). Returns its ms (median of REPS, CUDA events)."""
    import torch

    n, S = width * part.rate_cats * 2, part.sites_padded
    g = torch.Generator(device=part.device).manual_seed(S64_SEED)
    a = torch.rand((n, 64, 64), generator=g, device=part.device)
    b = torch.rand((n, 64, S), generator=g, device=part.device)
    out = torch.empty((n, 64, S), device=part.device)
    ms = median_ms(lambda: torch.matmul(a, b, out=out))
    print(f"yardstick, not a port: one torch.matmul of the {width}-op "
          f"level's contractions [{n}, 64, 64] @ [{n}, 64, {S}] ({gpu}): "
          f"{ms:.4f} ms, {2 * n * 64 * 64 * S / ms / 1e9:.1f} TFLOP/s",
          flush=True)
    del a, b, out
    return ms


def s64_dense_path(device, gpu):
    """Phase 26b: the 61-state problem at full width on the dense paths:
    the step-by-step chain, a partial traversal and 'levels-kernel' with
    three Newton steps (`dense_main_path`, against the float64 plain path
    on the card), the default engine's route ('levels-kernel': the fused
    kernels take at most 32 states), one maximize_fused step on the level
    kernel's trial form; then the level kernel's call over one traversal
    beside its plain version's, its device time (torch.profiler) and its
    bound."""
    from libpll2_tpu_torch import TreeEngine

    tree, by = s64_problem(N_TAXA, S64_SITES)
    dense = dense_main_path(
        device, f"{S64_STATES}-state", tree, by, S64_SITES,
        lambda t, b, sites, dev: s64_partition(t, b, sites, dev))
    launches, n_levels, part, eng, ops = dense
    default = TreeEngine(part, tree)
    check(default.execution_path == "levels-kernel",
          f"61 states: the default engine took {default.execution_path!r}")
    want = TreeEngine(part, tree, pallas="levels-kernel").loglikelihood()
    got = default.loglikelihood()
    check(got == want, f"61 states: the default engine's logL {got!r} is "
          f"not 'levels-kernel''s {want!r}")
    step, form = maximize_step_case(f"{S64_STATES} states", default, tree,
                                    S64_GROUPS, gpu)
    kernel, plain, logl, step_ms = level_times(f"{S64_STATES}-state", part,
                                               eng, ops, gpu)
    dev = level_device(f"{S64_STATES}-state", part, ops, gpu)
    widths = dev["level_ops"]
    bounds = s64_level_bounds(part, widths)
    plans = s64_plans(part, widths)
    check({c for c, _, _ in plans} == {part.rate_cats},
          f"61 states: the level plans' clusters {plans}")
    s64_levels_text(f"level_generic64, {S64_STATES}-state {part.tips} x "
                    f"{part.sites}", widths, dev["level_us"], bounds, plans,
                    gpu)
    yardstick = s64_matmul_yardstick(part, max(widths), gpu)
    return {"launches": launches + step["step_launches"]["level"],
            "levels": n_levels, "ms": kernel, "plain_ms": plain,
            "loglikelihood_ms": logl, "step_by_step_ms": step_ms,
            "device_ms": dev["ms"], "level_us": dev["level_us"],
            "level_ops": widths, "level_bound_us": [b[0] for b in bounds],
            "plans": plans, "yardstick_matmul_ms": yardstick,
            "bound": (dev["bound_ms"], dev["bound_by"]),
            "trial": step, "trial_form": form,
            "buffers_mb": part.clv_bytes() / 1e6}


def s64_repeats_path(device, gpu):
    """Phase 26c: the conserved 61-state problem at full width as a site
    repeats partition: the default engine ('pool-pallas'),
    loglikelihood() and one newton_step() against the float64 plain dense
    path on the card, pool-kernel launches counted (one a level), one
    maximize_fused step on the pool kernel's trial form; then the pool
    kernel's call over one traversal beside its plain version's, its
    device time (torch.profiler, a launch a level) and its bound from the
    class counts."""
    import copy

    import torch
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.ops import pool

    tree, by = s64_problem(N_TAXA, S64_SITES, conserved=True)
    part = s64_partition(tree, by, S64_SITES, device, repeats=True)
    eng = TreeEngine(part, tree)
    check(eng.execution_path == "pool-pallas",
          f"61-state repeats: the default engine took "
          f"{eng.execution_path!r}")
    reset_counts()
    b0 = eng.branches.clone()
    lnl = eng.loglikelihood()
    b1 = eng.branches.clone()
    step = eng.newton_step()
    torch.cuda.synchronize()
    got = counts()
    n_per = pool_launches(eng._ops)
    check_counts("61-state repeats: loglikelihood() + newton_step()", got,
                 {"pool": 2 * n_per})
    ops, _, _ = traversal_ops(part, tree)
    dense = s64_partition(tree, by, S64_SITES, device)
    r = tree.vroot
    params = [0] * part.rate_cats
    ref0 = f64_edge(dense, ops, b0.cpu().double(), params, r)
    ref1 = f64_edge(dense, ops, b1.cpu().double(), params, r)
    del dense
    _, levels = pool.schedule_pool_levels(copy.deepcopy(part.repeats), ops,
                                          part.tips, part.sites_padded,
                                          part.scale_buffers)
    cols, _ = pool.pool_work(levels)
    print(f"repeats {S64_STATES}-state path: {part.tips} taxa x "
          f"{part.sites} sites, {len(levels)} levels, class columns "
          f"{cols / (len(ops) * part.sites):.4f} of plain work, buffers "
          f"{part.clv_bytes() / 1e6:.1f} MB", flush=True)
    check_logl("61-state pool-pallas loglikelihood()", lnl, ref0[0])
    check_logl("61-state pool-pallas newton_step", step[0], ref1[0],
               step[1:], ref1[1:3])
    trial, form = maximize_step_case(f"{S64_STATES}-state repeats", eng,
                                     tree, S64_GROUPS, gpu)
    ms = median_ms(lambda: run_pool(part, ops))
    plain = median_ms(lambda: run_pool(part, ops, pool.pool_update_reference),
                      reps=3)
    device_ms, per, level_bounds, cols, _ = pool_device(
        f"{S64_STATES}-state", part, ops, gpu)
    plans = s64_plans(part, plan=part._pool_plan(ops, True))
    check({c for c, _, _ in plans} == {part.rate_cats},
          f"61-state repeats: the pool plans' clusters {plans}")
    s64_levels_text(f"pool_generic64, conserved {S64_STATES}-state "
                    f"{part.tips} x {part.sites} (computed columns)",
                    [c for c, _ in cols], per, level_bounds, plans, gpu)
    bound = pool_bound(part, levels)
    print(f"pool times, {S64_STATES}-state {part.tips} x {part.sites} "
          f"(median of {REPS}, CUDA events; {gpu}): kernel over "
          f"{len(levels)} levels {ms:.4f} ms (device {device_ms:.4f} ms, "
          f"bound {bound[0]:.4f} ms by {bound[1]}), plain {plain:.4f} ms",
          flush=True)
    return {"launches": 2 * n_per + trial["step_launches"]["pool"],
            "levels": len(levels), "ms": ms, "plain_ms": plain,
            "device_ms": device_ms, "level_us": per,
            "level_columns": [c for c, _ in cols],
            "level_bound_us": level_bounds, "plans": plans,
            "bound": bound, "trial": trial, "trial_form": form}


def s64_times(device, gpu):
    """`--states64-times`: the two 64-state kernels alone on the 61-state
    problem at full width (phase 26's), per site and per rate, for one
    build against another on the same card: each held once against its
    plain version (`compare_level_case`, `compare_pool_case`), then its
    call over one traversal (median of REPS, CUDA events) and its device
    time level by level (`level_device_us`, `pool_device`'s profiler)."""
    out = {}
    tree, by = s64_problem(N_TAXA, S64_SITES)
    rtree, rby = s64_problem(N_TAXA, S64_SITES, conserved=True)
    from libpll2_tpu_torch.ops import levels

    for mode, kw in (("per site", {}), ("per rate", {"rate_scalers": True})):
        part = s64_partition(tree, by, S64_SITES, device, **kw)
        ops = traversal_ops(part, tree)[0]
        err = compare_level_case(f"61 states {mode}", part, ops)[1]
        tables, args = level_tables(part, ops)
        call = median_ms(lambda: levels.update_partials_kernel(*args))
        per = level_device_us(args, len(tables))
        print(f"level_generic64 {mode} ({gpu}): call {call:.4f} ms, device "
              f"{sum(per):.1f} us, by level "
              + ", ".join(f"{u:.1f}" for u in per), flush=True)
        out[f"level {mode}"] = {"ms": call, "device_us": sum(per),
                                "level_us": per, "max_abs_err": err}
        del part
        part = s64_partition(rtree, rby, S64_SITES, device, repeats=True,
                             **kw)
        ops = traversal_ops(part, rtree)[0]
        err = compare_pool_case(f"61 states {mode}", part, ops,
                                layouts={1})[1]
        call = median_ms(lambda: run_pool(part, ops))
        dev, per = pool_device(f"61-state {mode}", part, ops, gpu)[:2]
        out[f"pool {mode}"] = {"ms": call, "device_us": dev * 1e3,
                               "level_us": per, "max_abs_err": err}
        del part
    return out


def f64_streamed_scores(part, tree, **engine_kw):
    """The streamed scores of the first iteration of an SPR round
    (radius S64_F64_RADIUS) on `part`'s search engine (`engine_kw`), and
    its execution path."""
    from libpll2_tpu_torch.search import TreeSearch

    s = TreeSearch(part, tree, **engine_kw)
    s._ensure_engine()
    score = s._summed_spr_scores
    got = {}

    def first(scheds, chunk):
        got["scores"] = score(scheds, chunk)
        raise _OneIteration

    s._summed_spr_scores = first
    try:
        s.spr_round_streamed(radius=S64_F64_RADIUS)
    except _OneIteration:
        pass
    return got["scores"], s._engine.execution_path


def f64_step_by_step(part, tree):
    """A full traversal and a partial one (after one branch length
    changes) through the step-by-step API; the edge logL after each and
    the root edge's d1, d2."""
    from libpll2_tpu_torch.trees import create_operations, traverse

    ops, br, pidx = create_operations(traverse(tree.vroot))
    r = tree.vroot
    params = [0] * part.rate_cats
    edge = (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index)
    part.update_prob_matrices(params, pidx, br)
    part.update_partials(ops)
    full = part.compute_edge_loglikelihood(*edge, params)
    st = part.update_sumtable(r.clv_index, r.back.clv_index, r.scaler_index,
                              r.back.scaler_index, params)
    d = part.compute_likelihood_derivatives(st, params, r.length)
    mat = next(o.child1_matrix_index for o in ops
               if o.child1_clv_index < part.tips)
    bad = set()
    for o in ops:
        if (mat in (o.child1_matrix_index, o.child2_matrix_index)
                or o.child1_clv_index in bad or o.child2_clv_index in bad):
            bad.add(o.parent_clv_index)
    partial, _, _ = create_operations(traverse(
        r, cbtrav=lambda n: not n.is_tip() and n.clv_index in bad))
    part.update_prob_matrices(params, [mat], [3.0 * br[pidx.index(mat)]])
    part.update_partials(partial)
    return full, d, part.compute_edge_loglikelihood(*edge, params)


def f64_close(what, got, want, tol=TOL_F64_LOGL, floor=0.0):
    rel = abs(got - want) / max(abs(want), floor)
    print(f"  {what}: {got!r} vs CPU {want!r} (rel {rel:.2e})", flush=True)
    check(rel < tol, f"{what}: rel err {rel:.2e} >= {tol}")
    return rel


def f64_card_phase(device, gpu, big, big_by, flagship, eng32):
    """Phase 26d: float64 partitions on the card, on the routes JAX takes
    for float64 ('levels', 'scan', 'pool': the plain versions; no kernel
    launches): bench.py's DNA problem and the 246 x 4465 repeats problem,
    each against the same partition in float64 on the CPU:
    loglikelihood() and newton_step() (TOL_F64_LOGL, d1/d2 TOL_F64_D), the
    step-by-step API's full and partial traversals, the first iteration of
    a streamed SPR round (every candidate's score) and one
    newton_smooth_all pass (its logL and lengths); each call's ms beside
    the float32 fused call's on the card."""
    import copy

    import numpy as np
    import torch
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.optimize import newton_smooth_all

    f64 = torch.float64
    out = {}
    parts = [dna_partition(big, big_by, N_SITES, dev, dtype=f64)
             for dev in (device, "cpu")]
    engines = [TreeEngine(p, big, pallas="auto" if p.device.type == "cuda"
                          else False) for p in parts]
    out["dna_path"] = engines[0].execution_path
    check(out["dna_path"] == "levels", f"float64 DNA on the card took "
          f"{out['dna_path']!r}, JAX's route is 'levels'")
    reset_counts()
    (lk, lk_ms), (st, st_ms) = timed(engines[0].loglikelihood), timed(
        engines[0].newton_step)
    step_by_step = f64_step_by_step(parts[0], big)
    check_counts("float64 DNA on the card: loglikelihood(), newton_step(), "
                 "the step-by-step API", counts(), {})
    out["dna_loglikelihood_ms"] = median_ms(engines[0].loglikelihood, reps=5)
    out["dna_newton_step_ms"] = st_ms
    out["f32_fused_loglikelihood_ms"] = median_ms(eng32.loglikelihood,
                                                  reps=5)
    ref_lk, ref_st = engines[1].loglikelihood(), engines[1].newton_step()
    ref_sbs = f64_step_by_step(parts[1], big)
    print(f"float64 DNA {N_TAXA} x {N_SITES} on the card ({gpu}): "
          f"execution_path {out['dna_path']!r}, loglikelihood() "
          f"{out['dna_loglikelihood_ms']:.2f} ms (float32 'fused' "
          f"{out['f32_fused_loglikelihood_ms']:.2f} ms), newton_step() "
          f"{st_ms:.2f} ms (host clock, first call)", flush=True)
    rels = [f64_close("loglikelihood()", lk, ref_lk),
            f64_close("newton_step() logL", st[0], ref_st[0]),
            f64_close("newton_step() d1", st[1], ref_st[1], TOL_F64_D, 1e-3),
            f64_close("newton_step() d2", st[2], ref_st[2], TOL_F64_D, 1e-3),
            f64_close("step-by-step full traversal", step_by_step[0],
                      ref_sbs[0]),
            f64_close("step-by-step d1", step_by_step[1][0], ref_sbs[1][0],
                      TOL_F64_D, 1e-3),
            f64_close("step-by-step d2", step_by_step[1][1], ref_sbs[1][1],
                      TOL_F64_D, 1e-3),
            f64_close("step-by-step partial traversal", step_by_step[2],
                      ref_sbs[2])]
    del engines, parts
    # a streamed SPR iteration and a sweep pass, each from fresh partitions
    parts = [dna_partition(big, big_by, N_SITES, dev, dtype=f64)
             for dev in (device, "cpu")]
    reset_counts()
    (got, path), spr_ms = timed(lambda: f64_streamed_scores(parts[0],
                                                            copy.deepcopy(
                                                                big)))
    want, _ = f64_streamed_scores(parts[1], copy.deepcopy(big), pallas=False)
    spr_rel = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"  streamed SPR iteration (radius {S64_F64_RADIUS}, engine "
          f"{path!r}): {len(got)} scores, max rel err against the CPU "
          f"{spr_rel:.2e}, {spr_ms:.1f} ms (host clock)", flush=True)
    check(spr_rel < TOL_F64_LOGL, f"float64 streamed scores: rel err "
          f"{spr_rel:.2e}")
    sweep = []
    for p in parts:
        tree = copy.deepcopy(big)
        eng = TreeEngine(p, tree, pallas="auto" if p.device.type == "cuda"
                         else False)
        t0 = time.perf_counter()
        lk = newton_smooth_all(eng, tree, passes=1,
                               iterations=S64_F64_ITERATIONS)
        if p.device.type == "cuda":
            torch.cuda.synchronize()
        sweep.append((lk, eng.branches.cpu().numpy(),
                      (time.perf_counter() - t0) * 1e3))
    blen_rel = float(np.max(np.abs(sweep[0][1] - sweep[1][1])
                            / np.abs(sweep[1][1])))
    print(f"  newton_smooth_all (1 pass, {S64_F64_ITERATIONS} iterations an "
          f"edge): {sweep[0][2]:.1f} ms on the card, {sweep[1][2]:.1f} ms "
          f"on the CPU; lengths max rel err {blen_rel:.2e}", flush=True)
    rels.append(f64_close("newton_smooth_all logL", sweep[0][0],
                          sweep[1][0]))
    check(blen_rel < TOL_F64_D, f"float64 sweep lengths: rel err "
          f"{blen_rel:.2e}")
    check_counts("float64 DNA on the card: a streamed SPR iteration and a "
                 "sweep pass", counts(), {})
    out.update(spr_ms=spr_ms, spr_candidates=len(got),
               spr_max_rel_err=spr_rel, sweep_ms=sweep[0][2],
               sweep_cpu_ms=sweep[1][2], sweep_lengths_max_rel_err=blen_rel)
    del parts
    # the repeats problem
    rep_tree, _, rep_make = flagship
    parts = [rep_make(dev, dtype=f64) for dev in (device, "cpu")]
    engines = [TreeEngine(p, rep_tree, pallas="auto"
                          if p.device.type == "cuda" else False)
               for p in parts]
    out["repeats_path"] = engines[0].execution_path
    check(out["repeats_path"] == "pool", f"float64 repeats on the card "
          f"took {out['repeats_path']!r}, JAX's route is 'pool'")
    reset_counts()
    (lk, _), (st, st_ms) = timed(engines[0].loglikelihood), timed(
        engines[0].newton_step)
    check_counts("float64 repeats on the card", counts(), {})
    out["repeats_loglikelihood_ms"] = median_ms(engines[0].loglikelihood,
                                                reps=5)
    ref_lk, ref_st = engines[1].loglikelihood(), engines[1].newton_step()
    print(f"float64 repeats {REP_TAXA} x {REP_SITES} on the card ({gpu}): "
          f"execution_path {out['repeats_path']!r}, loglikelihood() "
          f"{out['repeats_loglikelihood_ms']:.2f} ms, newton_step() "
          f"{st_ms:.2f} ms (host clock, first call)", flush=True)
    rels += [f64_close("repeats loglikelihood()", lk, ref_lk),
             f64_close("repeats newton_step() logL", st[0], ref_st[0]),
             f64_close("repeats newton_step() d1", st[1], ref_st[1],
                       TOL_F64_D, 1e-3),
             f64_close("repeats newton_step() d2", st[2], ref_st[2],
                       TOL_F64_D, 1e-3)]
    out["max_rel_err"] = max(rels + [spr_rel])
    return out


def states64_phase(device, gpu, lib_path, big, big_by, flagship, eng32):
    """Phase 26 (see the module docstring): the 64-state instantiations
    against their plain versions, the 61-state dense and repeats paths at
    full width with their launches counted (every count set to 0 before,
    read after, each kernel launched), their times beside the bounds, the
    instantiations' registers and spills, and the float64 partitions on
    the card. Returns the phase's numbers."""
    t0 = time.perf_counter()
    regs = ptxas_report(lib_path)
    for name, r in sorted(regs.items()):
        print(f"ptxas, {name}: {r.get('registers')} registers, spill "
              f"stores/loads {r.get('spills')} bytes", flush=True)
    check(len(regs) == 4 and all(r.get("spills") == (0, 0)
                                 for r in regs.values()),
          f"the 64-state instantiations' ptxas report: {regs}")
    level_err, pool_err = s64_kernel_cases(device)
    reset_counts()
    dense = s64_dense_path(device, gpu)
    rep = s64_repeats_path(device, gpu)
    print(f"{S64_STATES}-state paths: level-kernel launches "
          f"{dense['launches']}, pool-kernel launches {rep['launches']}",
          flush=True)
    check(dense["launches"] > 0 and rep["launches"] > 0,
          "a 64-state instantiation was not launched on its path")
    f64 = f64_card_phase(device, gpu, big, big_by, flagship, eng32)
    s = time.perf_counter() - t0
    print(f"phase 26 (33-64 states, float64 on the card): {s:.1f} s",
          flush=True)
    return {"ptxas": regs, "level_err": level_err, "pool_err": pool_err,
            "dense": dense, "repeats": rep, "f64": f64, "s": s}


# ------------------------------------------------------- 27. the loops
LOOP_KS = (0, 1, 5, 65)       # loglikelihood_loop's trip counts checked
LOOP_NEWTON = 5               # newton_loop's, against chained newton_step()
LOOP_BENCH = (5, 65)          # bench.py:86's trip counts, differenced
LOOP_REPS = 7                 # best of, as bench.py:90-95 takes it
LOOP_KERNELS = ("fused_onchip", "fused_fixed", "fused_generic", "fused_rows",
                "level_fixed", "level_generic", "pool_traversal",
                "pool_generic")


def loop_cases(device, big, big_by, aa_tree, aa_by, flagship):
    """(label, a maker of fresh engines, the kernel its path launches) of
    every phase-27 problem: bench.py's DNA on 'fused' and 'levels-kernel',
    the protein in 'split' and 'bf16', the 246 x 4465 repeats problem on
    'repeats-dense-fused' and 'pool-pallas', the DNA on a 4-shard mesh of
    the card and a ShardedRepeatsEngine's dense-fused and pooled shards."""
    from libpll2_tpu_torch import TreeEngine
    from libpll2_tpu_torch.parallel import ShardedRepeatsEngine

    rep_tree, rep_by, rep_make = flagship
    w = REP_MESH_SITES // MESH_SHARDS
    model = ([0.25] * 4, [1, 2, 1, 1, 2, 1.0])

    def sharded_repeats(**kw):
        parts = [repeats_partition(rep_tree, {k: v[i * w:(i + 1) * w]
                                              for k, v in rep_by.items()},
                                   w, MESH_DEVICE, model=model, alpha=0.7)
                 for i in range(MESH_SHARDS)]
        return ShardedRepeatsEngine(rep_tree, parts, mesh_of(), **kw)

    return [
        (f"DNA {N_TAXA} x {N_SITES} fused", lambda: build_engine(
            big, big_by, N_SITES, device)[1], "fused"),
        (f"DNA {N_TAXA} x {N_SITES} levels-kernel", lambda: TreeEngine(
            dna_partition(big, big_by, N_SITES, device), big,
            pallas="levels-kernel"), "level"),
        (f"protein {AA_TAXA} x {AA_SITES} split", lambda: TreeEngine(
            protein_partition(aa_tree, aa_by, AA_SITES, device), aa_tree),
         "rows"),
        (f"protein {AA_TAXA} x {AA_SITES} bf16", lambda: TreeEngine(
            protein_partition(aa_tree, aa_by, AA_SITES, device), aa_tree,
            mxu="bf16"), "rows"),
        (f"repeats {REP_TAXA} x {REP_SITES} repeats-dense-fused",
         lambda: TreeEngine(rep_make(device), rep_tree), "fused"),
        (f"repeats {REP_TAXA} x {REP_SITES} pool-pallas",
         lambda: TreeEngine(rep_make(device), rep_tree, pallas="pool"),
         "pool"),
        (f"DNA {N_TAXA} x {N_SITES} on {MESH_SHARDS} shards of the card",
         lambda: TreeEngine(dna_partition(
             big, big_by, N_SITES, MESH_DEVICE, sites_alignment=MESH_SHARDS,
             mesh=mesh_of()), big), "fused"),
        (f"ShardedRepeatsEngine {MESH_SHARDS} x {w} dense-fused",
         sharded_repeats, "fused"),
        (f"ShardedRepeatsEngine {MESH_SHARDS} x {w} pooled",
         lambda: sharded_repeats(dense_fused=False), "pool")]


def idle_share(device, t0, t1):
    """The share of [t0, t1] (profiler us) in which no device span of
    `device` ((start, end) pairs sorted by start) ran."""
    busy, end = 0.0, t0
    for s, e in device:
        s, e = max(s, end), min(e, t1)
        if e > s:
            busy += e - s
            end = e
    return 1.0 - busy / (t1 - t0)


def profiled_window(fn):
    """One call of `fn` under torch.profiler: {"ours": the kernels of ours
    it launched (`between_markers`), "idle": its device-idle share, "ms":
    its host window,
    "counted": the launch counters over it, and, where the call replays a
    graph (run_chained's `pll.loop.replays` range), "replay_idle" and
    "replay_ms": the same from the replays' first enqueue to the device's
    last activity}. The idle share is the share of the call's host window
    (from its start until its result is on the host) in which no device
    activity (kernel, copy or memset) ran; the annotations' device-side
    spans (record_function, the engine's `pll.*` ranges) are not activity.
    The session opens with PROFILE_WARMUP_S of sentinel kernels and a lead
    call that is not read, and is run again, up to PROFILE_SESSIONS times,
    when the trace lacks the window or any device event in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    sentinel = torch.zeros(1, device="cuda")
    for _ in range(PROFILE_SESSIONS):
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm_end = time.perf_counter() + PROFILE_WARMUP_S
            while time.perf_counter() < warm_end:
                sentinel.add_(1)
                torch.cuda.synchronize()
                time.sleep(0.001)
            fn()
            torch.cuda.synchronize()
            reset_counts()
            torch.cuda._sleep(PROFILE_MARKER_CYCLES)
            torch.cuda.synchronize()
            with record_function("pll.loop_window"):
                fn()
                torch.cuda.synchronize()
            torch.cuda._sleep(PROFILE_MARKER_CYCLES)
            counted = counts()
            for _ in range(8):
                sentinel.add_(1)
            torch.cuda.synchronize()
        events = prof.events()
        win = [e for e in events if e.name == "pll.loop_window"
               and e.device_type == DeviceType.CPU]
        ours = between_markers(events, LOOP_KERNELS)
        if not win or ours is None:
            continue
        t0, t1 = win[0].time_range.start, win[0].time_range.end
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in events if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and not e.name.startswith(("pll.", "sweep."))
                       and t0 <= e.time_range.start < t1)
        if not spans:
            continue
        device = [(a, b) for a, b, _ in spans]
        out = {"ours": ours, "idle": idle_share(device, t0, t1),
               "ms": (t1 - t0) / 1e3, "counted": counted}
        rep = [e for e in events if e.name == "pll.loop.replays"
               and e.device_type == DeviceType.CPU
               and t0 <= e.time_range.start < t1]
        if rep:
            r0 = rep[0].time_range.start
            r1 = max(b for _, b in device)
            out.update(replay_idle=idle_share(device, r0, r1),
                       replay_ms=(r1 - r0) / 1e3)
        return out
    check(False, f"the profiler recorded no window with device events in "
          f"{PROFILE_SESSIONS} sessions")


def between_markers(events, names):
    """The device kernels whose names hold one of `names` that started
    between the two marker kernels (torch.cuda._sleep's `spin_kernel`) of
    a profiled session, by the device's own timestamps: a count that no
    offset between the host's clock and the device's can move (the host
    window, by the host's clock, lost up to 15 of 65 kernels that all ran:
    PERF.md, Findings, PR 27). None without exactly two markers."""
    from torch.autograd import DeviceType

    device = [e for e in events if e.device_type == DeviceType.CUDA]
    marks = sorted(e.time_range.start for e in device
                   if "spin_kernel" in e.name)
    if len(marks) != 2:
        return None
    return sum(marks[0] < e.time_range.start < marks[1] for e in device
               if any(n in e.name for n in names))


def best_ms(fns, reps=LOOP_REPS) -> list:
    """bench.py:90-95: the least host-clock ms of `reps` calls of each of
    `fns` (each returns its result to the host), the functions called in
    turns after one call each, so that a slow stretch of the host (a
    capture that allocates its pool, say) reaches each alike."""
    for fn in fns:
        fn()
    best = [float("inf")] * len(fns)
    for _ in range(reps):
        for i, fn in enumerate(fns):
            t0 = time.perf_counter()
            fn()
            best[i] = min(best[i], (time.perf_counter() - t0) * 1e3)
    return best


def loop_case(label, make, kernel):
    """One problem of phase 27: loglikelihood_loop(k) at LOOP_KS against the
    eager chain of k evaluations summed in the partition's dtype (the
    replays run its kernels: equal to the last bit expected) and against k
    x loglikelihood() (TOL_LOGL), launches counted against k x one
    evaluation's; newton_loop(LOOP_NEWTON) against as many chained
    newton_step()s on a twin engine (logL, d1 and d2, the branches); the
    counters against the profiler's count of our kernels in one
    loglikelihood_loop(65); then bench.py's differenced time, the capture's
    host ms and the device-idle share of the loop and of 65 eager calls."""
    import torch

    eng, twin = make(), make()
    check(eng.execution_path == twin.execution_path, f"{label}: paths")
    reset_counts()
    lk = twin.loglikelihood()
    per_eval = counts()
    check(per_eval[kernel] > 0 and sum(per_eval.values())
          == per_eval[kernel], f"{label}: one evaluation launched "
          f"{per_eval}")
    chain, acc = {}, None
    for i in range(1, max(LOOP_KS) + 1):
        total = twin._evaluate()[0].reshape(())
        acc = total.clone() if acc is None else acc + total
        if i in LOOP_KS:
            chain[i] = float(acc)
    rec = {"path": eng.execution_path, "kernel": kernel,
           "launches_per_evaluation": per_eval[kernel], "loglikelihood": lk}
    worst, equal = 0.0, True
    for k in LOOP_KS:
        reset_counts()
        got = eng.loglikelihood_loop(k)
        torch.cuda.synchronize()
        n = counts()
        run = eng._last_loop if k else None
        if k == 0:
            check(got == 0.0 and sum(n.values()) == 0,
                  f"{label}: loglikelihood_loop(0) = {got!r}, launches {n}")
            continue
        check(run.route == "graph" and run.k == k, f"{label}: route "
              f"{run.route} at k = {k}")
        check(n[kernel] == k * per_eval[kernel] and sum(n.values())
              == n[kernel], f"{label}: loglikelihood_loop({k}) counted "
              f"{n}, expected {k * per_eval[kernel]} {kernel}")
        rel = abs(got - k * lk) / abs(k * lk)
        chain_rel = abs(got - chain[k]) / abs(chain[k])
        worst = max(worst, rel, chain_rel)
        equal = equal and got == chain[k]
        print(f"  {label}: loglikelihood_loop({k}) = {got!r}; eager chain "
              f"{chain[k]!r} ({'equal' if got == chain[k] else f'rel {chain_rel:.2e}'}"
              f"), {k} x loglikelihood() {k * lk!r} (rel {rel:.2e}); "
              f"{n[kernel]} {kernel} launches", flush=True)
        check(chain_rel < TOL_LOGL and rel < TOL_LOGL,
              f"{label}: loglikelihood_loop({k}) rel err "
              f"{max(rel, chain_rel):.2e}")
    steps = [twin.newton_step() for _ in range(LOOP_NEWTON)]
    reset_counts()
    got = eng.newton_loop(LOOP_NEWTON)
    torch.cuda.synchronize()
    n = counts()
    check(n[kernel] == LOOP_NEWTON * per_eval[kernel],
          f"{label}: newton_loop({LOOP_NEWTON}) counted {n}")
    want = steps[-1]
    rel = abs(got[0] - want[0]) / abs(want[0])
    d_err = max(abs(g - w) / max(abs(w), ATOL_D1 / TOL_D1)
                for g, w in zip(got[1:], want[1:]))
    b_err = float((eng.branches - twin.branches).abs().max())
    same = got == want and b_err == 0.0
    print(f"  {label}: newton_loop({LOOP_NEWTON}) = {got!r}; chained "
          f"newton_step() {want!r} ({'equal, branches equal' if same else f'logL rel {rel:.2e}, d1/d2 err {d_err:.2e}, branches max diff {b_err:.2e}'})",
          flush=True)
    check(rel < TOL_LOGL and d_err < TOL_D1 and b_err < 1e-5,
          f"{label}: newton_loop rel {rel:.2e}, d err {d_err:.2e}, "
          f"branches {b_err:.2e}")
    # the counters against the profiler's count of the card's launches
    prof_loop = profiled_window(lambda: eng.loglikelihood_loop(65))
    ours = prof_loop["ours"]
    check(ours == 65 * per_eval[kernel] == prof_loop["counted"][kernel]
          and "replay_idle" in prof_loop,
          f"{label}: the profiler saw {ours} of our kernels in "
          f"loglikelihood_loop(65), the counters {prof_loop['counted']}")
    prof_eager = profiled_window(
        lambda: [twin.loglikelihood() for _ in range(65)])
    # bench.py's metric: differenced trip counts, best of LOOP_REPS
    k1, k2 = LOOP_BENCH
    t1, t2 = best_ms([lambda: eng.loglikelihood_loop(k1),
                      lambda: eng.loglikelihood_loop(k2)])
    per_ms = max((t2 - t1) / (k2 - k1), 1e-9)
    eager_ms = host_ms(twin.loglikelihood, reps=20)
    captures = []
    for _ in range(LOOP_REPS):
        eng.loglikelihood_loop(2)
        captures.append(eng._last_loop.capture_ms)
    rec.update(
        max_rel_err=worst, equal_to_eager_chain=equal,
        newton=got, newton_chained=want, newton_equal=same,
        newton_rel_err=rel, newton_d_err=d_err, branches_max_diff=b_err,
        launches_per_iteration=dict(eng._last_loop.launches),
        profiler_launches_in_loop65=ours, loop5_ms=t1, loop65_ms=t2,
        ms_per_evaluation=per_ms, evals_per_s=1e3 / per_ms,
        eager_loglikelihood_ms=eager_ms[1],
        eager_loglikelihood_least_ms=eager_ms[0],
        capture_ms=statistics.median(captures),
        idle_share_loop65=prof_loop["idle"],
        window_loop65_ms=prof_loop["ms"],
        idle_share_replays=prof_loop["replay_idle"],
        window_replays_ms=prof_loop["replay_ms"],
        idle_share_eager65=prof_eager["idle"],
        window_eager65_ms=prof_eager["ms"])
    print(f"  {label}: {per_ms:.4f} ms an evaluation differenced "
          f"(loglikelihood_loop {k1}: {t1:.3f} ms, {k2}: {t2:.3f} ms; "
          f"{1e3 / per_ms:.1f} evals/s) beside one eager loglikelihood() "
          f"{eager_ms[1]:.4f} ms (least {eager_ms[0]:.4f}); capture "
          f"{rec['capture_ms']:.2f} ms host; device idle (profiled) "
          f"{100 * prof_loop['idle']:.1f} % of loglikelihood_loop(65)'s "
          f"{prof_loop['ms']:.2f} ms ({100 * prof_loop['replay_idle']:.1f} "
          f"% of its 64 replays' {prof_loop['replay_ms']:.2f} ms), "
          f"{100 * prof_eager['idle']:.1f} % of 65 eager calls' "
          f"{prof_eager['ms']:.2f} ms; the profiler's launches {ours} = "
          f"the counters'", flush=True)
    return rec


def loops_phase(device, gpu, big, big_by, aa_tree, aa_by, flagship):
    """Phase 27: `loglikelihood_loop` and `newton_loop` on every problem of
    `loop_cases`, each on its kernels, captured once in a CUDA graph and
    replayed (`loop_case`). Returns {label: record} and the launches the
    phase counted by kernel (the loop calls' and the lead calls', the
    twins' eager chains not among them)."""
    import torch

    print(f"phase 27, the loops (k chained evaluations captured once in a "
          f"CUDA graph and replayed; {gpu}):", flush=True)
    out = {}
    for label, make, kernel in loop_cases(device, big, big_by, aa_tree,
                                          aa_by, flagship):
        out[label] = loop_case(label, make, kernel)
        torch.cuda.empty_cache()
    return out


def loop_launches(loops, kernel) -> int:
    """The launches of `kernel` in phase 27's checked loop calls
    (loglikelihood_loop at LOOP_KS and newton_loop(LOOP_NEWTON))."""
    return sum((sum(LOOP_KS) + LOOP_NEWTON) * r["launches_per_evaluation"]
               for r in loops.values() if r["kernel"] == kernel)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None)
    ap.add_argument("--rows-only", metavar="REPO", default=None,
                    help="only time the rows kernel on the protein main "
                    "path, importing the port from the checkout REPO (for "
                    "one commit against another on the same card), and "
                    "print the times as one JSON line")
    ap.add_argument("--graph-replays", action="store_true",
                    help="only replay the DNA fused kernel's cluster "
                    "launches in CUDA graphs, every launch's rows checked, "
                    "and count them under torch.profiler beside one block "
                    "a walk, and print the counts as one JSON line")
    ap.add_argument("--fused-only", metavar="REPO", default=None,
                    help="only time the DNA fused kernel (main path, per "
                    "rate, raw tips, the repeats problem, and a chunk of "
                    "128 candidates where the port has them), importing the "
                    "port from the checkout REPO, and print the times as "
                    "one JSON line")
    ap.add_argument("--generic-only", metavar="REPO", default=None,
                    help="only time the fused kernel's runtime-size body "
                    "(DNA 128 x 16384 at 1 and 8 categories, 5 states, "
                    "and the float64 walks of phase 24a, the flagship's "
                    "stepwise tree for its final one), importing the port "
                    "from the checkout REPO, and print the times as one "
                    "JSON line")
    ap.add_argument("--pool-only", metavar="REPO", default=None,
                    help="only time the pool kernel (the conserved protein "
                    "per site and per rate, 3-rate DNA, 5, 17 and 32 "
                    "states, 4x4 DNA as a control), importing the port "
                    "from the checkout REPO, and print the times as one "
                    "JSON line")
    ap.add_argument("--levels-only", metavar="REPO", default=None,
                    help="only time the level kernel (DNA 128 x 16384 per "
                    "site and per rate, the 80-taxon caterpillar, the "
                    "protein tree as a control), importing the port from "
                    "the checkout REPO, and print the times as one JSON "
                    "line")
    ap.add_argument("--mesh-only", action="store_true",
                    help="only build the kernels and run phase 25 (site "
                    "sharding on the card), and print its numbers as one "
                    "JSON line")
    ap.add_argument("--states64-times", action="store_true",
                    help="only build the kernels and time the two 64-state "
                    "kernels on phase 26's 61-state problem, per site and "
                    "per rate (each held against its plain version), and "
                    "print the times as one JSON line")
    ap.add_argument("--probe-only", metavar="REPO", default=None,
                    help="only build the kernels of the checkout REPO and "
                    "run phase 18 (the matrix-unit probe: its checks, its "
                    "build report and its table at 8 and 264 column "
                    "tiles), and print its numbers as one JSON line")
    ap.add_argument("--loops-only", action="store_true",
                    help="after the build, run only phase 27 (the loops: "
                    "loglikelihood_loop and newton_loop captured in a CUDA "
                    "graph on every problem) and print its numbers as one "
                    "JSON line")
    ap.add_argument("--states64-only", action="store_true",
                    help="only build the kernels and run phase 26 (33-64 "
                    "states and float64 partitions on the card), and print "
                    "its numbers as one JSON line")
    args = ap.parse_args()
    other = (args.rows_only or args.fused_only or args.pool_only
             or args.levels_only or args.generic_only or args.probe_only)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    # the plain versions' float32 einsums: full float32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.abspath(other or REPO))
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
    if args.rows_only:
        print(f"rows kernel of {os.path.abspath(args.rows_only)}",
              flush=True)
        print(json.dumps({"rows_only": rows_only(device, gpu),
                          "gpu": gpu}), flush=True)
        return 0
    if args.graph_replays:
        print(json.dumps({"graph_replays": graph_replays_only(device, gpu),
                          "gpu": gpu}), flush=True)
        return 0
    if args.fused_only:
        print(f"fused kernel of {os.path.abspath(args.fused_only)}",
              flush=True)
        print(json.dumps({"fused_only": fused_only(device, gpu),
                          "gpu": gpu}), flush=True)
        return 0
    if args.generic_only:
        print(f"runtime-size body of {os.path.abspath(args.generic_only)}",
              flush=True)
        print(json.dumps({"generic_only": generic_only(device, gpu),
                          "gpu": gpu}), flush=True)
        return 0
    if args.pool_only:
        print(f"pool kernel of {os.path.abspath(args.pool_only)}",
              flush=True)
        print(json.dumps({"pool_only": pool_only(device, gpu),
                          "gpu": gpu}), flush=True)
        return 0
    if args.levels_only:
        print(f"level kernel of {os.path.abspath(args.levels_only)}",
              flush=True)
        print(json.dumps({"levels_only": levels_only(device, gpu),
                          "gpu": gpu}), flush=True)
        return 0

    # 2. build
    t0 = time.perf_counter()
    lib_path = _kernels.library_path()
    _kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(lib_path, REPO)}", flush=True)
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                print(f"  ptxas: {line.split(chr(39))[1]}", flush=True)
            elif ("Used" in line and "registers" in line or "spill" in line
                    or line.startswith("==")):
                print(f"  ptxas: {line.strip()}", flush=True)

    if args.probe_only:
        print(f"probe of {os.path.abspath(args.probe_only)}", flush=True)
        print(json.dumps({"probe_only": probe_only(gpu, lib_path),
                          "gpu": gpu}), flush=True)
        return 0

    if args.states64_times:
        print(json.dumps({"states64_times": s64_times(device, gpu),
                          "gpu": gpu}), flush=True)
        return 0

    if args.states64_only:
        headers_big, seqs = random_alignment(N_TAXA, N_SITES, seed=SEED)
        big = random_utree(headers_big, seed=SEED)
        big_by = dict(zip(headers_big, seqs))
        eng32 = build_engine(big, big_by, N_SITES, device)[1]
        print(json.dumps({"states64_only": states64_phase(
            device, gpu, lib_path, big, big_by, flagship_repeats(), eng32),
            "gpu": gpu}), flush=True)
        return 0

    if args.loops_only:
        headers_big, seqs = random_alignment(N_TAXA, N_SITES, seed=SEED)
        aa_tree, aa_by = protein_alignment()
        loops = loops_phase(device, gpu, random_utree(headers_big,
                                                      seed=SEED),
                            dict(zip(headers_big, seqs)), aa_tree, aa_by,
                            flagship_repeats())
        print(json.dumps({"loops_only": loops, "gpu": gpu}), flush=True)
        return 0

    if args.mesh_only:
        headers_big, seqs = random_alignment(N_TAXA, N_SITES, seed=SEED)
        aa_tree, aa_by = protein_alignment()
        print(json.dumps({"mesh_only": mesh_phase(
            device, gpu, random_utree(headers_big, seed=SEED),
            dict(zip(headers_big, seqs)), aa_tree, aa_by,
            flagship_repeats()), "gpu": gpu}), flush=True)
        return 0

    # 3. kernel vs plain on the card
    headers, seqs = random_alignment(16, 1000, alphabet="ACGT-NRY", seed=3)
    small = random_utree(headers, seed=3)
    small_by = dict(zip(headers, seqs))
    compare_case("ragged", small, small_by, 1000, device,
                 plan=("on-chip", 4))
    for sites, tps in FUSED_LAYOUT_SITES:
        headers, seqs = random_alignment(16, sites, alphabet="ACGT-NRY",
                                         seed=3)
        compare_case(f"{sites} sites", small, dict(zip(headers, seqs)),
                     sites, device, plan=("on-chip", tps))
    compare_case(f"spill: {FUSED_SPILL_SLOTS} slots", small, small_by, 1000,
                 device, plan=("spill", 1), n_slots=FUSED_SPILL_SLOTS)
    cat = parse_newick(caterpillar_newick(80))
    headers, seqs = random_alignment(80, 1000, seed=3)
    cat_by = dict(zip(headers, seqs))
    compare_case("caterpillar", cat, cat_by, 1000, device, must_scale=True,
                 plan=("on-chip", 4))
    generic_err = generic_cases(device, small, cat)
    headers_big, seqs = random_alignment(N_TAXA, N_SITES, seed=SEED)
    big_by = dict(zip(headers_big, seqs))
    _, max_abs = compare_case("main-path shape", random_utree(headers_big,
                                                              seed=SEED),
                              big_by, N_SITES, device,
                              plan=FUSED_MAIN_PLAN)

    # 4. main path
    eng, part, launches = main_path(device)

    # 5. times
    ms_kernel, ms_plain = times(eng, part, gpu, N_TAXA, N_SITES)["split"]
    fused_dev = fused_device("DNA main path", part, eng, gpu)
    fused_registers = fused_registers_check(_kernels.library_path())

    # 5b. the runtime-size body at full width
    generic = generic_phase(device, gpu)

    # 6. rows kernel vs plain on the card
    rows_build = rows_build_report(lib_path)
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
    for states in (17, 21):   # P padded to 20 and 24 states
        headers, seqs = random_alignment(16, 1000, seed=3,
                                         alphabet=LETTERS32[:states] + "-")
        compare_rows_case(f"{states} states", small,
                          dict(zip(headers, seqs)), 1000, device,
                          states=states)
    headers, seqs = random_alignment(16, 300, seed=3,
                                     alphabet=LETTERS32 + "-")
    for rates, per_rate in ((8, True), (16, False), (32, False)):
        compare_rows_case(f"{'per-rate, ' if per_rate else ''}{rates} rates "
                          f"x 32 states", small, dict(zip(headers, seqs)),
                          300, device, states=32, rate_cats=rates,
                          plan="spill", rounded_plan=(
                              "spill" if rates == 32 else "tc-spill"),
                          rate_scalers=per_rate)
    headers, seqs = random_alignment(16, 40003, alphabet=AA_NOISY, seed=3)
    compare_rows_case("wide: 40003 sites, 64-site tiles, a tail of 3", small,
                      dict(zip(headers, seqs)), 40003, device)
    headers, seqs = random_alignment(80, 1000, alphabet=AA_NOISY, seed=3)
    compare_rows_case("caterpillar", cat, dict(zip(headers, seqs)), 1000,
                      device, must_scale=True)
    compare_rows_case("12 slots: the tensor cores' slots in device memory",
                      small, aa_small_by, 1000, device, n_slots=12,
                      rounded_plan="tc-spill")
    aa_tree, aa_by = protein_alignment()
    _, rows_max_abs = compare_rows_case("main-path shape", aa_tree, aa_by,
                                        AA_SITES, device)

    # 7. protein main path
    aa_eng, aa_part, rows_launches = protein_main_path(device, aa_tree,
                                                       aa_by)

    # 8. times
    rows_ms = times(aa_eng, aa_part, gpu, AA_TAXA, AA_SITES,
                    modes=("split", "bf16", "highest"))
    rows_dev = rows_device(aa_eng, aa_part, gpu)
    rows_spill = rows_spill_case(device, aa_tree, gpu)
    bounds = {"fused_traversal": fused_bound(eng, part),
              "fused_traversal_rows": fused_bound(aa_eng, aa_part, "split")}
    rows_bounds = {f"{m}_bound_ms": fused_bound(aa_eng, aa_part, m)[0]
                   for m in ("split", "bf16", "highest")}
    rows_bounds["byte_bound_ms"] = (fused_bytes(aa_eng, aa_part)
                                    / H100_BYTES_PER_S * 1e3)
    print(f"rows kernel bounds, protein main path: 'split' on the tensor "
          f"cores {rows_bounds['split_bound_ms']:.4f} ms, 'bf16' "
          f"{rows_bounds['bf16_bound_ms']:.4f} ms, 'highest' on the CUDA "
          f"cores {rows_bounds['highest_bound_ms']:.4f} ms, bytes "
          f"{rows_bounds['byte_bound_ms']:.4f} ms", flush=True)

    # 9. level kernel vs plain on the card
    big = random_utree(headers_big, seed=SEED)
    level_max_abs = level_cases(device, small, small_by, cat, cat_by,
                                aa_small_by, big, big_by, aa_tree, aa_by)

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
    cat_part, cat_ops = caterpillar_times(device, gpu)
    lv_dev = level_device("DNA", dna[2], dna[4], gpu)
    lv_aa_dev = level_device("protein", prot[2], prot[4], gpu)
    lv_cat_dev = level_device("caterpillar", cat_part, cat_ops, gpu)
    del cat_part
    pr_part = dna_partition(big, big_by, N_SITES, device, rate_scalers=True)
    lv_pr_dev = level_device("DNA", pr_part, traversal_ops(pr_part, big)[0],
                             gpu)
    del pr_part
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
    rep_fused_dev = fused_device("repeats-dense-fused", rep[2], rep[3][1],
                                 gpu)
    rep_pool_dev = pool_device("repeats DNA", rep[2], rep[4], gpu)[0]
    rep_pool_host = pool_host_ms(rep[2], rep[4], gpu)
    aa_pool = protein_pool_times(device, aa_tree, aa_make, gpu)

    # 15. the new variants of kernels 1, 2, 3 and 5 vs plain on the card
    var_err, var_keep = slice_kernel_cases(
        device, small, small_by, cat, cat_by, big, big_by, aa_tree, aa_by,
        flagship)
    var_dev = {key: fused_device(key, *var_keep[key], gpu)
               for key in ("fused_per_rate", "fused_raw")}

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
    pr_pool_dev = pool_device("repeats DNA", *var_keep["pool_per_rate"],
                              gpu)[0]

    # 18. the matrix-unit probe
    probe_entries = probe_phase(gpu, lib_path)

    # 19. candidate scoring
    cand_dna = dna_candidates(device, big, big_by, gpu)
    cand_aa = protein_candidates(device, aa_tree, aa_by, gpu)
    cand_rep, rep_dev = repeats_candidates(device, rep_tree, rep_make, gpu)

    # 20. topology search
    search = search_phase(device, gpu, flagship, aa_tree, aa_by)
    sd, sp = search["dna"], search["dna"]["passes"]
    pass_err = {k: c["passes"]["max_abs_err"] for k, c in search.items()
                if k != "launches"}

    # 21. model optimization
    opt = optimize_phase(device, gpu, flagship, aa_tree, aa_by)

    # 22. an analysis from an alignment file
    ana = analysis_phase(device, gpu)

    # 23. placement and partitioned analyses
    place = placement_phase(device, gpu, big, big_by, aa_tree, aa_by)

    # 24. the certified evaluation and the flagship pipeline
    cert = certified_phase(device, gpu, eng, big, big_by, aa_tree, aa_by)
    cert_dna = cert["cases"]["DNA 128 x 16384"]

    # 25. site sharding on the card
    mesh = mesh_phase(device, gpu, big, big_by, aa_tree, aa_by, flagship)

    # 26. 33-64-state alphabets and float64 partitions on the card
    s64 = states64_phase(device, gpu, lib_path, big, big_by, flagship, eng)

    # 27. the loops: k chained evaluations in one captured CUDA graph
    loops = loops_phase(device, gpu, big, big_by, aa_tree, aa_by, flagship)
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

    def trial(t, launches):
        """A fused kernel's model-trial launch (phase 21): its launches on
        the path, error against the plain version, call, device time and
        bound."""
        return {"trial_launches": launches, "trial_trials": t["k"],
                "trial_max_abs_err": t["max_abs_err"], "trial_ms": t["ms"],
                "trial_plain_ms": t["plain_ms"],
                "trial_device_ms": t["device_ms"],
                "trial_bound_ms": t["bound"][0],
                "trial_bound_by": t["bound"][1]}

    def analysis(kernel):
        """Phase 22's dense evaluation, on the entry of the kernel that ran
        it: its launches, host-clock ms and error against float64."""
        if ana["dense_kernel"] != kernel:
            return {}
        extra = {}
        if "dense_device_ms" in ana:
            extra = {"analysis_device_ms": ana["dense_device_ms"],
                     "analysis_call_ms": ana["dense_call_ms"],
                     "analysis_plain_ms": ana["dense_plain_ms"],
                     "analysis_max_abs_err": ana["dense_max_abs_err"],
                     "analysis_bound_ms": ana["dense_bound"][0],
                     "analysis_bound_by": ana["dense_bound"][1]}
        return {"analysis_launches": ana["dense_launches"],
                "analysis_ms": ana["dense_ms"],
                "analysis_rel_err": ana["dense_rel_err"], **extra}

    def query(problems):
        """The query form's launches on phase 23's placement paths, its
        largest error against the plain version, and one launch's device
        time, bound and plain time (the first of `problems`), and each
        placer's numbers."""
        first = place[problems[0]]
        return {"query_launches": sum(place[k]["launches"]
                                      for k in problems),
                "query_max_abs_err": max(place[k]["max_abs_err"]
                                         for k in problems),
                "query_walks": first["walks"],
                "query_device_us": first["device_us"],
                "query_device_us_per_walk": first["device_us_per_walk"],
                "query_bound_ms": first["bound"][0],
                "query_bound_by": first["bound"][1],
                "query_plain_ms": first["plain_ms"],
                "placement": {k: {n: v for n, v in place[k].items()
                                  if n not in ("bound", "launch_shapes")}
                              for k in problems}}

    def sharded(m, launches):
        """Phase 25: the kernel's launches on the sharded paths (once a
        shard), its call on one shard's block and on the unsharded
        inputs, and the per-shard bound."""
        out = {"mesh_shards": MESH_SHARDS, "mesh_launches": launches,
               "mesh_ms_per_shard": m["ms_per_shard"],
               "mesh_unsharded_ms": m["unsharded_ms"]}
        if "bound_per_shard" in m:
            out.update(mesh_bound_ms_per_shard=m["bound_per_shard"][0],
                       mesh_bound_by=m["bound_per_shard"][1])
        for k in ("loglikelihood_ms", "loglikelihood_unsharded_ms",
                  "newton_step_ms", "newton_step_unsharded_ms",
                  "max_abs_err"):
            if k in m:
                out[f"mesh_{k}"] = m[k]
        return out

    def trial_form(name, source, replaces, keys, kernel, extra=0):
        """Phase 21's trial form of the level or pool kernel (B-3b): its
        launches in the maximize_fused steps on its paths (and `extra`
        more, phase 25's), its largest error against the plain version,
        and the first case's chunk call, device time, bound and plain
        time; every case's numbers and step beside it."""
        tf = opt["trial_forms"]
        first = tf[keys[0]]
        cases = {}
        for k in keys:
            c = {n: v for n, v in tf[k].items() if n != "bound"}
            c.update(bound_ms=tf[k]["bound"][0], bound_by=tf[k]["bound"][1],
                     step_ms=opt["others"][k]["step_ms"],
                     step_launches=opt["others"][k]["step_launches"][kernel])
            cases[k] = c
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launch_shape": "libpll2_tpu/optimize.py:366",
                "launches": extra + sum(
                    opt["others"][k]["step_launches"][kernel] for k in keys),
                "max_abs_err": max(tf[k]["max_abs_err"] for k in keys),
                "ms": first["ms"], "plain_ms": first["plain_ms"],
                "bound_ms": first["bound"][0],
                "bound_by": first["bound"][1], "library_ms": None,
                "trials": first["k"], "chunk": first["chunk"],
                "device_ms": first["device_ms"], "cases": cases}

    def states64(name, source, replaces, path, err, kernel):
        """Phase 26: a 64-state instantiation's launches on its 61-state
        path, its largest error against the plain version, its call, plain
        time, device time and bound over one traversal, its registers and
        spills, and the trial form of its maximize_fused step."""
        p, form = s64[path], s64[path]["trial_form"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "states": S64_STATES,
                "padded_states": 64, "launches": p["launches"],
                "max_abs_err": max(err, form["max_abs_err"]),
                "ms": p["ms"], "plain_ms": p["plain_ms"],
                "bound_ms": p["bound"][0], "bound_by": p["bound"][1],
                "library_ms": None, "device_ms": p["device_ms"],
                "ptxas": {k: v for k, v in s64["ptxas"].items()
                          if k.startswith(kernel)},
                "trial_ms": form["ms"], "trial_plain_ms": form["plain_ms"],
                "trial_device_ms": form["device_ms"],
                "trial_bound_ms": form["bound"][0],
                "trial_trials": form["k"], "trial_chunk": form["chunk"],
                "step_launches": p["trial"]["step_launches"],
                "step_ms": p["trial"]["step_ms"],
                "level_us": p["level_us"],
                "level_bound_us": p["level_bound_us"], "plans": p["plans"],
                "yardstick_matmul_ms": p.get("yardstick_matmul_ms")}

    def loop(kernel, *labels):
        """Phase 27: the kernel's launches in the checked loop calls, and
        bench.py's differenced ms an evaluation beside one eager
        loglikelihood(), the capture's host ms and the device-idle shares
        of each of its problems."""
        keys = ("path", "ms_per_evaluation", "evals_per_s",
                "eager_loglikelihood_ms", "capture_ms", "idle_share_loop65",
                "idle_share_replays", "idle_share_eager65", "max_rel_err",
                "equal_to_eager_chain",
                "newton_equal", "launches_per_iteration")
        return {"loop_launches": loop_launches(loops, kernel),
                "loop": {lb: {k: loops[lb][k] for k in keys}
                         for lb in loops if any(lb.startswith(x)
                                                for x in labels)
                         and loops[lb]["kernel"] == kernel}}

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
        "plan": fused_plan_of(part, eng).plan,
        "threads_per_site": fused_plan_of(part, eng).threads_per_site,
        "cluster": cluster_of(fused_plan_of(part, eng)),
        "device_ms": fused_dev,
        "us_per_op": fused_dev * 1e3 / (len(eng.table) - 1),
        "repeats_launches": rep[6][0], "repeats_max_abs_err": rep[6][1],
        "repeats_ms": pool_ms[3][0], "repeats_plain_ms": pool_ms[3][1],
        "repeats_bound_ms": pool_ms[3][2][0],
        "repeats_bound_by": pool_ms[3][2][1],
        "repeats_device_ms": rep_fused_dev,
        "repeats_threads_per_site": fused_plan_of(
            rep[2], rep[3][1]).threads_per_site,
        "repeats_cluster": cluster_of(fused_plan_of(rep[2], rep[3][1])),
        "cluster_registers": fused_registers,
        **variant("per_rate", "fused_per_rate", pr_fused),
        "per_rate_device_ms": var_dev["fused_per_rate"],
        **variant("raw_tips", "fused_raw", raw_fused),
        "raw_tips_device_ms": var_dev["fused_raw"],
        "asc_launches": asc_fused,
        "repeats_slice_launches": rep_fused,
        "generic_source": "libpll2_tpu_torch/csrc/fused_traversal.cu "
                          "fused_generic<float, SP, on chip>",
        "generic_launches": sum(g["launches"] for g in generic.values()),
        "generic_max_abs_err": max([generic_err] + [
            g["max_abs_err"] for g in generic.values()]),
        "generic_ms": generic[GENERIC_FULL[1][0]]["ms"],
        "generic_plain_ms": generic[GENERIC_FULL[1][0]]["plain_ms"],
        "generic_device_ms": generic[GENERIC_FULL[1][0]]["device_ms"],
        "generic_bound_ms": generic[GENERIC_FULL[1][0]]["bound"][0],
        "generic_bound_by": generic[GENERIC_FULL[1][0]]["bound"][1],
        "generic": {k: {n: v for n, v in g.items() if n != "bound"}
                    | {"bound_ms": g["bound"][0], "bound_by": g["bound"][1]}
                    for k, g in generic.items()},
        **trial(opt["trial"], opt["dna"]["launches"]["fused"]),
        "trial_repeats_launches":
            opt["others"]["repeats-dense-fused"]["step_launches"]["fused"],
        "trial_repeats_max_abs_err":
            opt["others"]["repeats-dense-fused"]["max_abs_err"],
        "brent_launches": opt["brent"]["evaluations"],
        "brent_ms_per_evaluation": opt["brent"]["ms_per_evaluation"],
        **analysis("fused"), **query(("dna", "epa")),
        "partitioned": place["partitioned"],
        **sharded(mesh["dna"]["fused"], mesh["dna"]["fused"]["launches"]
                  + mesh["repeats"]["repeats-dense-fused"]["launches"]
                  + mesh["partitioned"]["launches"]["fused"]),
        "mesh_repeats_ms_per_shard":
            mesh["repeats"]["repeats-dense-fused"]["ms_per_shard"],
        "mesh_repeats_unsharded_ms":
            mesh["repeats"]["repeats-dense-fused"]["unsharded_ms"],
        "mesh": {k: v for k, v in mesh.items()
                 if k not in ("dna", "protein")},
        **loop("fused", "DNA", "repeats", "ShardedRepeatsEngine")}, {
        "name": "fused_traversal_rows", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/fused_traversal_rows.cu",
        "replaces": "libpll2_tpu/ops/pallas_fused.py:419",
        "launches": rows_launches, "max_abs_err": rows_max_abs,
        "ms": rows_ms["split"][0], "plain_ms": rows_ms["split"][1],
        **bound("fused_traversal_rows"),
        "plan": rows_plan_of(aa_part, aa_eng).plan,
        "plans": rows_dev["plans"],
        "sites_per_thread": rows_plan_of(aa_part, aa_eng).sites_per_thread,
        "hgmma": rows_build["hgmma"], **rows_bounds,
        "device_ms": rows_dev["split"],
        "us_per_op": rows_dev["split"] * 1e3 / (len(aa_eng.table) - 1),
        "bf16_ms": rows_ms["bf16"][0],
        "bf16_plain_ms": rows_ms["bf16"][1],
        "bf16_device_ms": rows_dev["bf16"],
        "highest_ms": rows_ms["highest"][0],
        "highest_plain_ms": rows_ms["highest"][1],
        "highest_device_ms": rows_dev["highest"],
        "spill_shape": f"{AA_TAXA} x {SPILL_SITES}, {SPILL_RATES} rates x "
                       f"{SPILL_STATES} states",
        "spill_max_abs_err": rows_spill[0], "spill_ms": rows_spill[1],
        "spill_plain_ms": rows_spill[2], "spill_device_ms": rows_spill[3],
        "spill_bound_ms": rows_spill[4][0],
        "spill_bound_by": rows_spill[4][1],
        **variant("per_rate", "rows_per_rate", pr_rows),
        **variant("raw_tips_per_rate", "rows_raw", None),
        **trial(opt["aa_trial"], opt["aa_launches"]), **query(("aa",)),
        **sharded(mesh["protein"]["split"], sum(
            v["launches"] for v in mesh["protein"].values())
            + mesh["partitioned"]["launches"]["rows"]),
        "mesh_bf16_ms_per_shard": mesh["protein"]["bf16"]["ms_per_shard"],
        "mesh_bf16_unsharded_ms": mesh["protein"]["bf16"]["unsharded_ms"],
        **loop("rows", "protein")},
        {
        "name": "level_update", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/level_update.cu",
        "replaces": ["libpll2_tpu/ops/pallas_partials.py:48",
                     "libpll2_tpu/ops/pallas_partials.py:170"],
        "launches": level_launches, "max_abs_err": level_max_abs,
        "ms": lv_ms[0], "plain_ms": lv_ms[1], **bound("level_update"),
        "device_ms": lv_dev["ms"],
        "dna_level_device_us": lv_dev["level_us"],
        "dna_level_bound_us": lv_dev["level_bound_us"],
        "dna_level_layout": lv_dev["layout"],
        "per_rate_device_ms": lv_pr_dev["ms"],
        "caterpillar_device_ms": lv_cat_dev["ms"],
        "caterpillar_slowest_level_device_ms": lv_cat_dev["slowest_ms"],
        "protein_ms": lv_aa_ms[0],
        "protein_plain_ms": lv_aa_ms[1], "protein_device_ms": lv_aa_dev["ms"],
        "protein_widest_level_device_ms": lv_aa_dev["widest_ms"],
        "protein_narrowest_level_device_ms": lv_aa_dev["narrowest_ms"],
        "protein_bound_ms": aa_level_bound[0],
        "protein_bound_by": aa_level_bound[1],
        **variant("per_rate", "level_per_rate", pr_level),
        "asc_launches": asc_level,
        "sweep_launches": opt["sweep"]["launches"]["level"]
        + opt["aa_sweep"]["launches"]["level"],
        "sweep_max_abs_err": max(opt["sweep_check"]["max_abs_err"],
                                 opt["aa_sweep_check"]["max_abs_err"]),
        "sweep_ms_per_pass": opt["sweep"]["ms_per_pass"],
        "sweep_level_launches_per_pass":
            opt["sweep"]["level_launches_per_pass"],
        "sweep_protein_ms_per_pass": opt["aa_sweep"]["ms_per_pass"],
        "trial_launches":
            opt["others"]["levels-kernel"]["step_launches"]["level"],
        "trial_max_abs_err": opt["others"]["levels-kernel"]["max_abs_err"],
        **analysis("level"),
        **sharded(mesh["dna"]["levels"], mesh["dna"]["levels"]["launches"]
                  + mesh["search"]["launches"]["level"]),
        **loop("level", "DNA")},
        {
        "name": "pool_update", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/pool_update.cu",
        "replaces": "libpll2_tpu/ops/pallas_repeats.py:45",
        "launches": pool_launches, "max_abs_err": pool_max_abs,
        "ms": pool_ms[0], "plain_ms": pool_ms[1],
        **bound("pool_update"),
        "dna_traversal_device_us": rep_pool_dev * 1e3,
        "dna_host_enqueue_ms": rep_pool_host,
        "dna_level_bounds_us": sum(pool_level_bounds(rep[2], rep[5])),
        "per_rate_device_us": pr_pool_dev * 1e3,
        "protein_ms": aa_pool[0], "protein_plain_ms": aa_pool[1],
        "protein_device_ms": aa_pool[3][0],
        "protein_bound_ms": aa_pool[2][0],
        "protein_bound_by": aa_pool[2][1],
        "protein_level_device_us": aa_pool[3][1],
        "protein_level_bound_us": aa_pool[3][2],
        "protein_level_columns": aa_pool[3][3],
        "protein_level_threads_per_column": aa_pool[3][4],
        **variant("per_rate", "pool_per_rate", rep_pool),
        "trial_launches":
            opt["others"]["pool-pallas"]["step_launches"]["pool"],
        "trial_max_abs_err": opt["others"]["pool-pallas"]["max_abs_err"],
        "analysis_launches": ana["pool_launches"],
        "analysis_ms": ana["pool_ms"],
        "analysis_device_ms": ana["pool_device_ms"],
        "analysis_call_ms": ana["pool_call_ms"],
        "analysis_plain_ms": ana["pool_plain_ms"],
        "analysis_max_abs_err": ana["pool_max_abs_err"],
        "analysis_bound_ms": ana["pool_bound"][0],
        "analysis_bound_by": ana["pool_bound"][1],
        "analysis_rel_err_vs_dense": ana["pool_rel_err"],
        **sharded(mesh["repeats"]["pool-pallas"],
                  mesh["repeats"]["pool-pallas"]["launches"]),
        **loop("pool", "repeats", "ShardedRepeatsEngine")},
        *probe_entries, {
        "name": "fused_traversal[candidates]", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/fused_traversal.cu",
        "replaces": "libpll2_tpu/ops/pallas_fused.py:299",
        "launch_shape": "libpll2_tpu/engine.py:713-728",
        "launches": cand_dna["launches"] + cand_rep[
            "repeats-dense-fused"]["launches"],
        "max_abs_err": max(cand_dna["max_abs_err"],
                           rep_dev["max_abs_err"]),
        "ms": cand_dna["ms"], "plain_ms": cand_dna["plain_ms"],
        "bound_ms": cand_dna["bound"][0], "bound_by": cand_dna["bound"][1],
        "library_ms": None, "candidates": cand_dna["chunk"],
        "device_ms": cand_dna["device_ms"],
        "device_us_per_candidate": cand_dna["device_ms"] * 1e3
        / cand_dna["chunk"],
        "neighbourhood": cand_dna["k"],
        "calls_ms": cand_dna["calls_ms"],
        "host_pack_ms_per_candidate": {
            "evaluate_topologies": cand_dna["pack_ms"],
            "evaluate_packed": cand_dna["pack_candidate_ms"],
            "evaluate_packed_arrays": cand_dna["stack_ms"]},
        "sequential_ms_per_candidate": cand_dna["sequential_ms"],
        "repeats": cand_rep, "repeats_device_ms": rep_dev["device_ms"],
        "repeats_bound_ms": rep_dev["bound"][0],
        "repeats_plain_ms": rep_dev["plain_ms"],
        "repeats_candidates": CAND_REPEATS,
        "search_launches": sd["batched_launches"],
        "search_candidate_launches": sum(
            sd[f"batched_{k}"]["chunks"] for k in ("spr", "nni")),
        "search_native_us_per_candidate": {
            k: sd[f"batched_{k}"]["native_us_per_candidate"]
            for k in ("spr", "nni")}}, {
        "name": "fused_traversal_rows[candidates]", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/fused_traversal_rows.cu",
        "replaces": "libpll2_tpu/ops/pallas_fused.py:419",
        "launch_shape": "libpll2_tpu/engine.py:713-728",
        "launches": sum(v["launches"] for v in cand_aa.values()),
        "max_abs_err": cand_aa["split"]["max_abs_err"],
        "ms": cand_aa["split"]["ms"],
        "plain_ms": cand_aa["split"]["plain_ms"],
        "bound_ms": cand_aa["split"]["bound"][0],
        "bound_by": cand_aa["split"]["bound"][1], "library_ms": None,
        "candidates": CAND_AA,
        "device_ms": cand_aa["split"]["device_ms"],
        "device_us_per_candidate": cand_aa["split"]["device_ms"] * 1e3
        / CAND_AA,
        "bf16_ms": cand_aa["bf16"]["ms"],
        "bf16_plain_ms": cand_aa["bf16"]["plain_ms"],
        "bf16_device_ms": cand_aa["bf16"]["device_ms"],
        "bf16_max_abs_err_logl": cand_aa["bf16"]["max_abs_err"],
        "calls_ms": {m: v["call_ms"] for m, v in cand_aa.items()},
        "sequential_ms_per_candidate": {
            m: v["sequential_ms"] for m, v in cand_aa.items()}}, {
        "name": "level_update[stream]", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/level_update.cu",
        "replaces": ["libpll2_tpu/ops/pallas_partials.py:48",
                     "libpll2_tpu/ops/pallas_partials.py:170"],
        "launch_shape": "libpll2_tpu/ops/spr_stream.py:776-780",
        "launches": search["launches"]["level"],
        "max_abs_err": max(pass_err.values()),
        "max_abs_err_by_problem": pass_err, "ms": sp["ms"],
        "plain_ms": sp["plain_ms"], "bound_ms": sp["bound"][0],
        "bound_by": sp["bound"][1], "library_ms": None,
        "ops": sp["ops"], "level_tables": sp["levels"],
        "device_ms_per_round": sd["pass_device_ms"],
        "search": {k: v for k, v in search.items() if k != "launches"}},
        trial_form("level_update[trials]",
                   "libpll2_tpu_torch/csrc/level_update.cu",
                   ["libpll2_tpu/ops/pallas_partials.py:48",
                    "libpll2_tpu/ops/pallas_partials.py:170"],
                   ("levels-kernel", "levels-kernel per rate",
                    "levels-kernel protein"), "level",
                   mesh["optimize"]["levels_kernel"]["launches"]),
        trial_form("pool_update[trials]",
                   "libpll2_tpu_torch/csrc/pool_update.cu",
                   "libpll2_tpu/ops/pallas_repeats.py:45",
                   ("pool-pallas", "pool-pallas protein"), "pool"), {
        "name": "fused_traversal_f64", "route": "cuda",
        "source": "libpll2_tpu_torch/csrc/fused_traversal.cu",
        "replaces": "libpll2_tpu/ops/df64.py:183",
        "replaces_kind": "XLA (the certified evaluation's double-single "
                         "lax.scan), not a Pallas kernel",
        "launches": cert["flagship"]["launches"]["f64"] + sum(
            c["launches"] for c in cert["cases"].values()),
        "max_abs_err": max(c["max_abs_err"]
                           for c in cert["cases"].values()),
        "ms": cert_dna["ms"], "plain_ms": cert_dna["plain_ms"],
        "bound_ms": cert_dna["bound"][0], "bound_by": cert_dna["bound"][1],
        "library_ms": None, "device_ms": cert_dna["device_ms"],
        "cases": cert["cases"], "flagship": cert["flagship"],
        "annotations": cert["annotations"]},
        states64("level_update[64 states]",
                 "libpll2_tpu_torch/csrc/level_update.cu level_generic64 "
                 "(csrc/states64.cuh)",
                 ["libpll2_tpu/ops/pallas_partials.py:48",
                  "libpll2_tpu/ops/pallas_partials.py:170"], "dense",
                 s64["level_err"], "level_generic64"),
        states64("pool_update[64 states]",
                 "libpll2_tpu_torch/csrc/pool_update.cu pool_generic64 "
                 "(csrc/states64.cuh)",
                 "libpll2_tpu/ops/pallas_repeats.py:45", "repeats",
                 s64["pool_err"], "pool_generic64")]}),
        flush=True)
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
