"""libpll2_tpu_torch — the PyTorch + CUDA port of libpll2_tpu.

The ported slices carry the main path: an alignment goes into a `Partition`
(explicit `device` and `dtype`), and `TreeEngine(part, tree)` evaluates the
full-tree log-likelihood and guarded Newton steps on the root branch through
one hand-written CUDA kernel for the whole postorder traversal
(ops/fused.py): csrc/fused_traversal.cu for small alphabets (DNA),
csrc/fused_traversal_rows.cu for 16 to 32 states (proteins under the
empirical models of `models`, with `TreeEngine(mxu=...)`). Module paths and
names mirror libpll2_tpu/, which stays the reference the port is tested
against.

An analysis starts from an alignment file: `io` reads FASTA and PHYLIP
and compresses the columns to site patterns, `parsimony` builds a
randomized stepwise-addition starting tree (natively on the host, Fitch on
the device without the native library), `optimize` (branch lengths,
exchangeabilities, frequencies, alpha and p-inv) and `modelselect` (the
ModelTest-NG pattern) sit on top of the engine, `bootstrap_loglikelihoods`
scores bootstrap replicates from one evaluation, and `checkpoint` saves and
restores the partition and the tree in libpll2_tpu's format.

Two consumers sit on the engine: `PartitionedEngine` (partitioned.py)
sums several alignment blocks over one tree, with linked or unlinked
branch lengths, and drives search and optimization as one engine;
`EdgePlacer` (placement.py) places query sequences onto a reference tree,
EPA-style, a query at a time, a batch of queries in one launch of the
fused kernel's query form, or streamed from per-edge attachment tensors,
and `placement.to_jplace` writes the jplace format.

`loglikelihood_df64` is the certified final evaluation: the whole tree in
float64 on the card, through the fused kernel's float64 instantiation
(ops/df64.py). `examples` holds the JAX package's examples, run as
`python -m libpll2_tpu_torch.examples.<name>`, and `utils` the hardware
probe, the printers and the profiling hooks.

The package imports torch, numpy and scipy, and never jax: the host modules
it needs (constants, io, trees, models, utils, ops/gamma, ops/eigen) are
carried over.
"""
from . import constants
from .constants import AscBias, PllError
from .engine import TreeEngine
from .ops.gamma import compute_gamma_cats
from .partition import Operation, Partition, pack_operations
from . import checkpoint
from .partitioned import PartitionedEngine
from .bootstrap import bootstrap_loglikelihoods
from . import modelselect
from .placement import EdgePlacer
from .ops.df64 import loglikelihood_df64

__all__ = ["constants", "AscBias", "PllError", "Operation", "Partition",
           "pack_operations", "TreeEngine", "compute_gamma_cats",
           "checkpoint", "PartitionedEngine", "bootstrap_loglikelihoods",
           "modelselect", "EdgePlacer", "loglikelihood_df64"]
__version__ = "0.1.0"
