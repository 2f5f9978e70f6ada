"""libpll2_tpu_torch — the PyTorch + CUDA port of libpll2_tpu.

The first slice carries the main path: an alignment goes into a `Partition`
(explicit `device` and `dtype`), and `TreeEngine(part, tree)` evaluates the
full-tree log-likelihood and guarded Newton steps on the root branch through
one hand-written CUDA kernel for the whole postorder traversal
(ops/fused.py, csrc/fused_traversal.cu). Module paths and names mirror
libpll2_tpu/, which stays the reference the port is tested against.

The package imports torch, numpy and scipy, and never jax: the host modules
it needs (constants, io/maps, trees, ops/gamma, ops/eigen) are carried over.
"""
from . import constants
from .constants import AscBias, PllError
from .engine import TreeEngine
from .ops.gamma import compute_gamma_cats
from .partition import Operation, Partition

__all__ = ["constants", "AscBias", "PllError", "Operation", "Partition",
           "TreeEngine", "compute_gamma_cats"]
__version__ = "0.1.0"
