"""Carry a partition's state across from libpll2_tpu.

`partition_from_numpy` builds the port's Partition from the sizes, options
(per-rate scalers, the asc correction) and numpy mirrors of a libpll2_tpu
Partition, under the same attribute names (libpll2_tpu/partition.py:
148-233), and, where given, its dense buffers (`clv`, `scale_buffer`,
`pmatrix`), so that a partial traversal can start from the JAX partition's
own CLVs. The asc columns and their state weights come with the mirrors
(`pattern_weights` spans them); the tips set with set_tip_clv come with the
dense `clv` rows, or on a repeats partition with `_tip_cols`. The caller
reads them off the JAX object, e.g. `{k: getattr(jp, k) for k in
STATE_KEYS}`; this module never imports the JAX package. Both functions default to the CUDA device, as
`Partition` does.

`params_from_jax` and `flat_from_jax` carry libpll2_tpu/optimize.py's
parameters across (its params pytree as a dict of numpy arrays, or its flat
`ravel_pytree` vector), so that both packages' optimizers start from one
point.

A site-repeats partition of the JAX package also carries REPEATS_KEYS: its
class table (`repeats`: site_id, id_site, ids), its tips' class columns
(`_tip_cols`) and, where it has them, its pooled buffers (`clv_flat`,
`sc_flat`) with their layout (`_flat`); the port's partition then starts
from the same classes and pools.
"""
from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from .partition import Partition, resolve_device
from .repeats import FlatLayout

SIZE_KEYS = ("tips", "clv_buffers", "states", "sites", "rate_matrices",
             "prob_matrices", "rate_cats", "scale_buffers")
# optional: off when absent (`asc_bias` may be either package's AscBias;
# `sites_padded` carries a `sites_alignment` padding)
OPTION_KEYS = ("rate_scalers", "asc_bias", "sites_padded")
MIRROR_KEYS = ("tip_states", "_tips_set", "_tips_clv_set", "frequencies",
               "subst_params", "rates", "rate_weights", "prop_invar",
               "pattern_weights", "invariant")
# optional: the dense buffers, cast to the port partition's dtype
BUFFER_KEYS = ("clv", "scale_buffer", "pmatrix")
STATE_KEYS = SIZE_KEYS + OPTION_KEYS + MIRROR_KEYS + BUFFER_KEYS
# a site-repeats partition's classes and pooled storage (`repeats` is None
# on a dense partition; the others exist on repeats partitions only)
REPEATS_KEYS = ("repeats", "_tip_cols", "clv_flat", "sc_flat", "_flat")
LAYOUT_FIELDS = ("caps", "off", "total", "sc_caps", "sc_off", "sc_trash",
                 "sc_zero", "sc_total")


def partition_from_numpy(state: dict, *, device="cuda",
                         dtype: torch.dtype = torch.float32) -> Partition:
    """A port Partition holding the given sizes, host mirrors and, where
    present, dense buffers, or a repeats partition's classes and pools. The
    eigensystem is recomputed on first use; `_invariant_valid` is taken
    from `state` when present."""
    missing = [k for k in SIZE_KEYS + MIRROR_KEYS if k not in state]
    if missing:
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         f"partition state lacks {missing}")
    rep = state.get("repeats")
    asc = state.get("asc_bias", C.AscBias.NONE)
    # the padded width is its own alignment: ceil(base / w) * w == w
    align = int(state.get("sites_padded") or 1)
    part = Partition(*(int(state[k]) for k in SIZE_KEYS), device=device,
                     dtype=dtype, site_repeats=rep is not None,
                     rate_scalers=bool(state.get("rate_scalers", False)),
                     asc_bias=C.AscBias(int(getattr(asc, "value", asc))),
                     sites_alignment=align)
    if (rep is None) != (part.repeats is None):
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         "a repeats table for a partition too small for "
                         "site repeats")
    if (np.asarray(state["_tips_clv_set"]).any() and rep is None
            and state.get("clv") is None):
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         "tips set with set_tip_clv need the dense `clv` "
                         "rows that hold their values")
    for key in MIRROR_KEYS:
        src = np.asarray(state[key])
        dst = getattr(part, key)
        if src.shape != dst.shape:
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                f"{key}: shape {src.shape} != {dst.shape} (the port keeps "
                f"no site padding)")
        setattr(part, key, src.astype(dst.dtype, copy=True))
    for key in BUFFER_KEYS:
        if state.get(key) is None:
            continue
        src = np.asarray(state[key])
        dst = getattr(part, key)
        if dst is None or src.shape != tuple(dst.shape):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"{key}: shape {src.shape} != "
                             f"{None if dst is None else tuple(dst.shape)}")
        dst.copy_(torch.tensor(src, dtype=dst.dtype))
    if rep is not None:
        _repeats_from_numpy(part, rep, state)
    part._invariant_valid = bool(state.get("_invariant_valid", False))
    part._tip_version += 1
    part._model_version += 1
    return part


def _repeats_from_numpy(part: Partition, rep, state: dict) -> None:
    """The class table, tip columns and, where given, pooled buffers of a
    repeats partition's state, installed on `part`."""
    table = part.repeats
    for name in ("site_id", "id_site", "ids"):
        src = np.asarray(getattr(rep, name))
        if src.shape != getattr(table, name).shape:
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"repeats.{name}: shape {src.shape} != "
                             f"{getattr(table, name).shape}")
        setattr(table, name, src.astype(np.int32, copy=True))
    part._tip_cols = {int(t): np.array(c, dtype=np.float64)
                      for t, c in (state.get("_tip_cols") or {}).items()}
    if state.get("clv_flat") is None:
        return
    lay = state["_flat"]
    layout = FlatLayout(**{f: np.asarray(getattr(lay, f), dtype=np.int64)
                           if np.ndim(getattr(lay, f)) else
                           int(getattr(lay, f)) for f in LAYOUT_FIELDS})
    clv, sc = np.asarray(state["clv_flat"]), np.asarray(state["sc_flat"])
    want = (part.rate_cats, part.states, layout.total)
    want_sc = part._sc_rows() + (layout.sc_total,)
    if clv.shape != want or sc.shape != want_sc:
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         f"pooled buffers {clv.shape}, {sc.shape} do not "
                         f"fit the layout ({want}, {want_sc})")
    part.clv_flat = torch.tensor(clv, dtype=part.dtype, device=part.device)
    part.sc_flat = torch.tensor(sc, dtype=torch.int32, device=part.device)
    part._flat = layout


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


def params_from_jax(params, *, device="cuda",
                    dtype: torch.dtype = torch.float32) -> dict:
    """libpll2_tpu/optimize.py's params pytree ({"freq_logits",
    "log_branches", "log_subst"}, arrays read with np.asarray) as the
    port's dict of tensors."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                            device=dev) for k, v in params.items()}


def flat_from_jax(x, *, device="cuda",
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A flat parameter vector of libpll2_tpu's `make_fused_loglikelihood_fn`
    (or a [K, n] batch of them) as a tensor: the port's flat order is JAX's
    `ravel_pytree` order."""
    return torch.tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                        device=resolve_device(device))
