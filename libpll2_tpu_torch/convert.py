"""Carry a partition's state across from libpll2_tpu.

`partition_from_numpy` builds the port's Partition from the sizes and numpy
mirrors of a libpll2_tpu Partition, under the same attribute names
(libpll2_tpu/partition.py:148-233), and, where given, its dense buffers
(`clv`, `scale_buffer`, `pmatrix`), so that a partial traversal can start
from the JAX partition's own CLVs. The caller reads them off the JAX
object, e.g. `{k: getattr(jp, k) for k in STATE_KEYS}`; this module never
imports the JAX package. Both functions default to the CUDA device, as
`Partition` does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from .partition import Partition, not_ported, resolve_device

SIZE_KEYS = ("tips", "clv_buffers", "states", "sites", "rate_matrices",
             "prob_matrices", "rate_cats", "scale_buffers")
MIRROR_KEYS = ("tip_states", "_tips_set", "_tips_clv_set", "frequencies",
               "subst_params", "rates", "rate_weights", "prop_invar",
               "pattern_weights", "invariant")
# optional: the dense buffers, cast to the port partition's dtype
BUFFER_KEYS = ("clv", "scale_buffer", "pmatrix")
STATE_KEYS = SIZE_KEYS + MIRROR_KEYS + BUFFER_KEYS


def partition_from_numpy(state: dict, *, device="cuda",
                         dtype: torch.dtype = torch.float32) -> Partition:
    """A port Partition holding the given sizes, host mirrors and, where
    present, dense buffers. The eigensystem is recomputed on first use;
    `_invariant_valid` is taken from `state` when present."""
    missing = [k for k in SIZE_KEYS + MIRROR_KEYS if k not in state]
    if missing:
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         f"partition state lacks {missing}")
    part = Partition(*(int(state[k]) for k in SIZE_KEYS), device=device,
                     dtype=dtype)
    if np.asarray(state["_tips_clv_set"]).any():
        raise not_ported("raw tip CLVs (set_tip_clv)")
    for key in MIRROR_KEYS:
        src = np.asarray(state[key])
        dst = getattr(part, key)
        if src.shape != dst.shape:
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                f"{key}: shape {src.shape} != {dst.shape} (the port keeps "
                f"no site padding and no asc columns)")
        setattr(part, key, src.astype(dst.dtype, copy=True))
    for key in BUFFER_KEYS:
        if key not in state:
            continue
        src = np.asarray(state[key])
        dst = getattr(part, key)
        if src.shape != tuple(dst.shape):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"{key}: shape {src.shape} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.tensor(src, dtype=dst.dtype))
    part._invariant_valid = bool(state.get("_invariant_valid", False))
    part._tip_version += 1
    part._model_version += 1
    return part


def engine_branches_from_numpy(branches, *, device="cuda",
                               dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """The pmatrix-ordered branch vector of a libpll2_tpu TreeEngine
    (`np.asarray(engine.branches)`) as a tensor for the port's
    `TreeEngine.loglikelihood(branches=...)`."""
    arr = np.asarray(branches, dtype=np.float64)
    if arr.ndim != 1:
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         f"branches must be 1-D, got shape {arr.shape}")
    return torch.tensor(arr, dtype=dtype, device=resolve_device(device))
