"""Multi-partition analyses: several alignments, one topology.

Port of libpll2_tpu/partitioned.py. The reference leaves partitioned models
to its consumers (each holds one partition per alignment block and sums
logL and d1/d2 across them, the pattern of libpll-2's stepwise.c:337-346
multi-partition score sum). `PartitionedEngine` packages it: every
partition gets its own TreeEngine bound to the shared tree, and totals are
summed.

`PartitionedEngine.shard` distributes the analysis over a site mesh: every
partition's columns are split over the mesh's shards, and each partition's
engine reduces its logL, d1 and d2 over them before the sums across
partitions.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import constants as C
from .engine import TreeEngine
from .partition import Partition
from .trees.utree import UTree

__all__ = ["PartitionedEngine"]


class PartitionedEngine:
    """Sum of per-partition log-likelihoods over one shared topology.

    Branch lengths may be shared (linked=True: one set of lengths, summed
    d1/d2 drive a single Newton update applied to every partition) or
    unlinked (each partition optimizes its own root branch).
    """

    @staticmethod
    def shard(partitions: Sequence[Partition], mesh) -> None:
        """Distribute a partitioned analysis over a device mesh: every
        partition's site axis is sharded in place (build each with
        sites_alignment=owned_shards(mesh)), after which each partition's
        engine runs its kernels once a shard and reduces its logL/d1/d2
        over the shards, and the sums across partitions stay host-side
        scalars. This is the consumers' MPI partitioned layout (each rank
        holds a column slice of EVERY partition, reference pll.c:1112 per
        partition). Call before constructing the PartitionedEngine."""
        from .parallel import shard_partition
        for p in partitions:
            shard_partition(p, mesh)

    def __init__(self, partitions: Sequence[Partition], tree: UTree,
                 params_indices: Optional[Sequence[int]] = None,
                 linked: bool = True, **engine_kwargs):
        if params_indices is None:
            params_indices = [0] * len(partitions)
        self.engines: List[TreeEngine] = [
            TreeEngine(p, tree, params_index=i, **engine_kwargs)
            for p, i in zip(partitions, params_indices)]
        self.linked = linked

    def loglikelihood(self) -> float:
        return sum(e.loglikelihood() for e in self.engines)

    # --- the TreeSearch engine protocol: a PartitionedEngine drives
    # topology search directly (TreeSearch(None, tree, engine=pe)).
    # Candidate tables are index-identical across partitions (one shared
    # tree template), so each candidate batch is scored by every partition
    # and the scores summed (the reference consumers' multi-partition score
    # sum, stepwise.c:337-346).

    @property
    def use_fused(self) -> bool:
        return all(e.use_fused for e in self.engines)

    def set_topology(self, tree: UTree) -> None:
        for e in self.engines:
            e.set_topology(tree)

    @property
    def shared_unit(self) -> Optional[TreeEngine]:
        """The first engine when every engine packs a candidate into the
        same table and branch vector (one pmatrix slot count, one set of
        raw-tip rows), so that one packing serves all; else None."""
        if len({(e.partition.prob_matrices, e._packed_ctips)
                for e in self.engines}) != 1:
            return None
        return self.engines[0]

    def pack_candidate(self, vroot):
        # only when EVERY partition runs fused (evaluate_packed needs it)
        # and they share one packing; else the search scores Operation
        # candidates through evaluate_topologies
        if not self.use_fused or self.shared_unit is None:
            return None
        return self.engines[0].pack_candidate(vroot)

    def evaluate_packed(self, packed):
        total = self.engines[0].evaluate_packed(packed)
        for e in self.engines[1:]:
            total = total + e.evaluate_packed(packed)
        return total

    def evaluate_packed_arrays(self, tables, blens, roots, n_slots: int):
        # the native builder's stacked candidates (the search's batched
        # rounds on fused engines that share one packing)
        total = self.engines[0].evaluate_packed_arrays(tables, blens, roots,
                                                       n_slots)
        for e in self.engines[1:]:
            total = total + e.evaluate_packed_arrays(tables, blens, roots,
                                                     n_slots)
        return total

    def evaluate_topologies(self, candidates):
        total = self.engines[0].evaluate_topologies(candidates)
        for e in self.engines[1:]:
            total = total + e.evaluate_topologies(candidates)
        return total

    def newton_step(self) -> Tuple[float, float, float]:
        """(total logL, summed d1, summed d2); with linked branches a
        single Newton update from the summed derivatives and the shared
        pre-step length replaces each engine's own (the multi-partition
        derivative sum of the reference's consumers)."""
        from .ops.derivatives import newton_step as _newton

        pre = [float(e.branches[int(e.root_idx[4])]) for e in self.engines]
        totals = [e.newton_step() for e in self.engines]
        total = sum(t[0] for t in totals)
        d1 = sum(t[1] for t in totals)
        d2 = sum(t[2] for t in totals)
        if self.linked:
            f64 = torch.float64
            new_len = _newton(torch.tensor(pre[0], dtype=f64),
                              torch.tensor(d1, dtype=f64),
                              torch.tensor(d2, dtype=f64),
                              C.OPT_MIN_BRANCH_LEN, C.OPT_MAX_BRANCH_LEN)
            for e in self.engines:
                branches = e.branches.clone()
                branches[int(e.root_idx[4])] = new_len.to(branches.dtype)
                e.branches = branches
        return total, d1, d2

    def make_joint_loglikelihood_fn(self, optimize=("branches",)):
        """(fn, params0): fn(params) = sum of per-partition logL,
        differentiable by torch.autograd. Parameter keys: `log_branches` is
        SHARED across partitions when linked (RAxML-NG's linked branch
        lengths); per-partition model parameters are namespaced
        `p{i}:log_subst` / `p{i}:freq_logits`, and with unlinked branches
        `p{i}:log_branches`. Engines must be built with pallas=False (the
        differentiable plain path)."""
        from .optimize import make_loglikelihood_fn

        fns = []
        params = {}
        for i, e in enumerate(self.engines):
            fi, pi = make_loglikelihood_fn(e, optimize)
            fns.append(fi)
            for k, v in pi.items():
                if k == "log_branches" and self.linked:
                    params.setdefault("log_branches", v)
                else:
                    params[f"p{i}:{k}"] = v

        linked = self.linked

        def fn(q):
            total = 0.0
            for i, fi in enumerate(fns):
                qi = {}
                for k in ("log_subst", "freq_logits", "log_branches"):
                    if f"p{i}:{k}" in q:
                        qi[k] = q[f"p{i}:{k}"]
                if linked and "log_branches" in q:
                    qi["log_branches"] = q["log_branches"]
                total = total + fi(qi)
            return total

        return fn, params

    def maximize(self, optimize=("branches",), steps: int = 200,
                 learning_rate: float = 0.02, tol: float = 1e-6,
                 patience: int = 25, chunk: int = 25):
        """Joint Adam ascent over all partitions: shared (linked) branch
        lengths + per-partition model parameters, the standard partitioned
        analysis. Applies the best parameters back to every engine and
        partition; returns (total logL, params, history).

        When any engine runs a kernel ('fused', 'levels-kernel',
        'repeats-dense-fused', or 'pool-pallas', whose pooled units JAX's
        `maximize_fused` cannot run: ROADMAP C) the model groups go to
        `maximize_fused` a partition at a time: with branch lengths fixed
        the joint objective decomposes exactly (each partition's model
        parameters touch only its own term). Branch lengths on such engines
        belong to the Newton machinery (newton_step, newton_smooth_all) and
        raise PllError here."""
        from .optimize import _apply, adam_ascent

        if any(e.use_pallas or e.repeats_dense_fused or e.use_repeats_pallas
               for e in self.engines):
            from .optimize import maximize_fused

            if "branches" in tuple(optimize):
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    "branch lengths on kernel-path engines are optimized "
                    "by the Newton machinery (newton_step loops); "
                    "maximize() here covers 'subst'/'freqs' only")
            total = 0.0
            params = {}
            history = []
            for i, e in enumerate(self.engines):
                lk, best, hist = maximize_fused(
                    e, optimize, steps=steps,
                    learning_rate=learning_rate, tol=tol,
                    patience=patience, chunk=chunk)
                total += lk
                history.append(hist)
                for k, v in best.items():
                    params[f"p{i}:{k}"] = v
            return total, params, history

        fn, params = self.make_joint_loglikelihood_fn(optimize)
        final, best, history = adam_ascent(
            fn, params, steps=steps, learning_rate=learning_rate,
            tol=tol, patience=patience, chunk=chunk)
        for i, e in enumerate(self.engines):
            qi = {k.split(":", 1)[1]: v for k, v in best.items()
                  if k.startswith(f"p{i}:")}
            if self.linked and "log_branches" in best:
                qi["log_branches"] = best["log_branches"]
            _apply(e, qi)
        return final, best, history
