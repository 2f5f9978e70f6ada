"""Partition: alignment, model and site data of one partition, in PyTorch.

Port of libpll2_tpu/partition.py (reference: libpll-2 src/pll.c:424-1206,
models.c). The fused path reads only the tip state bitmasks and the model,
so this slice keeps the host mirrors of the JAX partition and no dense CLV
buffer: the engine turns the mirrors into tensors on `device`, in `dtype`.

`dtype` is explicit and defaults to torch.float32, whose 2**-32 rescaling
window keeps threshold**2 above float32's smallest normal; torch.float64
uses the reference's 2**-256 window. float64 runs only on the CPU in this
slice.

Features outside this slice raise NotImplementedError naming the feature
(ROADMAP.md lists the module or kernel that lifts each one).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import constants as C
from .io import maps as state_maps
from .ops import eigen as ops_eigen

__all__ = ["Operation", "Partition"]


@dataclass
class Operation:
    """One pruning step (pll.h:314-324 pll_operation_t)."""
    parent_clv_index: int
    parent_scaler_index: int
    child1_clv_index: int
    child1_matrix_index: int
    child1_scaler_index: int
    child2_clv_index: int
    child2_matrix_index: int
    child2_scaler_index: int


def not_ported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to libpll2_tpu_torch yet (see ROADMAP.md)")


class Partition:
    """Likelihood computation state for one alignment partition."""

    def __init__(self,
                 tips: int,
                 clv_buffers: int,
                 states: int,
                 sites: int,
                 rate_matrices: int,
                 prob_matrices: int,
                 rate_cats: int,
                 scale_buffers: int,
                 *,
                 device="cpu",
                 dtype: torch.dtype = torch.float32,
                 rate_scalers: bool = False,
                 asc_bias: C.AscBias = C.AscBias.NONE,
                 site_repeats: bool = False,
                 mesh=None):
        self.device = torch.device(device)
        if dtype not in (torch.float32, torch.float64):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"dtype must be torch.float32 or torch.float64, "
                             f"got {dtype!r}")
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Partition(device='cuda') needs a CUDA "
                                   "device, and none is available")
            if dtype == torch.float64:
                raise not_ported("float64 on CUDA (the fused kernel is "
                                 "float32)")
        elif self.device.type != "cpu":
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"device must be cpu or cuda, got {device!r}")
        if rate_scalers:
            raise not_ported("per-rate scalers (rate_scalers=True)")
        if asc_bias != C.AscBias.NONE:
            raise not_ported("ascertainment bias correction")
        if site_repeats:
            raise not_ported("site repeats (site_repeats=True)")
        if mesh is not None:
            raise not_ported("site sharding over a device mesh")
        if states >= 16:
            raise not_ported(f"{states}-state alphabets (the row-layout "
                             f"kernel, states >= 16)")
        self.dtype = dtype
        if dtype == torch.float64:
            self.scale_threshold = C.SCALE_THRESHOLD
            self.scale_factor = C.SCALE_FACTOR
        else:
            self.scale_threshold = C.SCALE_THRESHOLD_F32
            self.scale_factor = C.SCALE_FACTOR_F32

        self.tips = tips
        self.clv_buffers = clv_buffers
        self.nodes = tips + clv_buffers
        self.states = states
        self.sites = sites
        self.rate_matrices = rate_matrices
        self.prob_matrices = prob_matrices
        self.rate_cats = rate_cats
        self.scale_buffers = scale_buffers
        # no site-grain padding: the kernel masks the ragged edge itself
        self.sites_padded = sites

        S, R, s = self.sites_padded, rate_cats, states
        # model parameters (host mirrors; tiny)
        self.frequencies = np.zeros((rate_matrices, s))
        self.subst_params = np.zeros((rate_matrices, s * (s - 1) // 2))
        self.rates = np.zeros(R)
        self.rate_weights = np.full(R, 1.0 / R)
        self.prop_invar = np.zeros(rate_matrices)
        self.eigenvals = np.zeros((rate_matrices, s))
        self.eigenvecs = np.zeros((rate_matrices, s, s))
        self.inv_eigenvecs = np.zeros((rate_matrices, s, s))
        self.eigen_decomp_valid = np.zeros(rate_matrices, dtype=bool)
        # bumped by every model/site-data setter; engines cache their
        # device copies of the model on it
        self._model_version = 0

        pw = np.zeros(S, dtype=np.int64)
        pw[:sites] = 1
        self.pattern_weights = pw
        self.invariant = np.full(S, -1, dtype=np.int32)
        self._invariant_valid = False
        # per-tip state bitmasks: the fused kernel's tip input
        self.tip_states = np.zeros((tips, S), dtype=np.uint64)
        self._tips_set = np.zeros(tips, dtype=bool)
        self._tips_clv_set = np.zeros(tips, dtype=bool)
        # bumped by tip setters; engines cache tip-code tensors on it
        self._tip_version = 0

    # ------------------------------------------------------------------ tips
    def set_tip_states(self, tip_index: int, charmap: np.ndarray,
                       sequence: str) -> None:
        """Bit-decode one aligned sequence into the tip's state masks
        (pll.c:1026)."""
        if len(sequence) != self.sites:
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"sequence length {len(sequence)} != sites "
                             f"{self.sites}")
        masks = state_maps.decode_states(sequence,
                                         np.asarray(charmap, dtype=np.uint64))
        if np.any(masks == 0):
            bad = sequence[int(np.argmax(masks == 0))]
            raise C.PllError(C.ERROR_TIPDATA_ILLEGALSTATE,
                             f"Illegal state code in tip \"{bad}\"")
        self._set_tip_masks(np.asarray([tip_index]), masks[None, :])

    def set_tip_states_batch(self, charmap, sequences,
                             tip_indices=None) -> None:
        """Install many aligned sequences at once; the same result as
        set_tip_states per tip in order."""
        seqs = list(sequences)
        if tip_indices is None:
            tip_indices = np.arange(len(seqs))
        tip_indices = np.asarray(tip_indices, np.int64)
        if tip_indices.shape[0] != len(seqs):
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                f"tip_indices ({tip_indices.shape[0]}) and sequences "
                f"({len(seqs)}) must have equal lengths")
        for s in seqs:
            if len(s) != self.sites:
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    f"sequence length {len(s)} != sites {self.sites}")
        cm = np.asarray(charmap, dtype=np.uint64)
        raw = np.frombuffer("".join(seqs).encode("latin-1"),
                            dtype=np.uint8).reshape(len(seqs), self.sites)
        masks = cm[raw]
        if np.any(masks == 0):
            ti, si = np.unravel_index(int(np.argmax(masks == 0)),
                                      masks.shape)
            raise C.PllError(
                C.ERROR_TIPDATA_ILLEGALSTATE,
                f"Illegal state code in tip \"{seqs[ti][si]}\"")
        self._set_tip_masks(tip_indices, masks)

    def _set_tip_masks(self, tip_indices: np.ndarray,
                       masks: np.ndarray) -> None:
        self.tip_states[tip_indices, :self.sites] = masks
        self._tips_set[tip_indices] = True
        self._tips_clv_set[tip_indices] = False
        self._tip_version += 1
        self._invariant_valid = False

    def set_tip_clv(self, tip_index: int, clv, padded: bool = False) -> None:
        raise not_ported("raw tip CLVs (set_tip_clv)")

    # ----------------------------------------------------------------- model
    def set_frequencies(self, params_index: int, freqs) -> None:
        f = np.asarray(freqs, dtype=np.float64)
        if abs(f.sum() - 1.0) > C.MISC_EPSILON:
            f = f / f.sum()
        self.frequencies[params_index] = f
        self.eigen_decomp_valid[params_index] = False
        self._model_version += 1

    def set_subst_params(self, params_index: int, params) -> None:
        self.subst_params[params_index] = np.asarray(params,
                                                     dtype=np.float64)
        self.eigen_decomp_valid[params_index] = False
        self._model_version += 1

    def set_category_rates(self, rates) -> None:
        self.rates = np.asarray(rates, dtype=np.float64).copy()
        self._model_version += 1

    def set_category_weights(self, weights) -> None:
        self.rate_weights = np.asarray(weights, dtype=np.float64).copy()
        self._model_version += 1

    def set_pattern_weights(self, weights) -> None:
        self.pattern_weights[:self.sites] = np.asarray(weights,
                                                       dtype=np.int64)
        self._invariant_valid = False
        self._model_version += 1

    def update_invariant_sites_proportion(self, params_index: int,
                                          prop_invar: float) -> None:
        """models.c:495-544."""
        if prop_invar < 0 or prop_invar >= 1:
            raise C.PllError(C.ERROR_INVAR_PROPORTION,
                             f"Invalid proportion of invariant sites "
                             f"({prop_invar})")
        if prop_invar > 0.0 and not self._invariant_valid:
            self.update_invariant_sites()
        self.prop_invar[params_index] = prop_invar
        self._model_version += 1

    def update_invariant_sites(self) -> None:
        """Bitwise-AND of observed states per column (models.c:651-752)."""
        gap = np.uint64((1 << self.states) - 1)
        acc = np.full(self.sites, gap, dtype=np.uint64)
        for t in range(self.tips):
            if self._tips_set[t]:
                acc &= self.tip_states[t, :self.sites]
        popcount = np.array([bin(int(x)).count('1') for x in acc])
        inv = np.where(popcount == 1,
                       np.array([int(x).bit_length() - 1 for x in acc]), -1)
        self.invariant[:self.sites] = inv.astype(np.int32)
        self.invariant[self.sites:] = -1
        self._invariant_valid = True
        self._model_version += 1
        if not np.any(popcount == 1):
            raise C.PllError(C.ERROR_INVAR_NONEFOUND,
                             "No invariant sites found")

    # ----------------------------------------------------------------- eigen
    def update_eigen(self, params_index: int) -> None:
        es = ops_eigen.update_eigen(self.subst_params[params_index],
                                    self.frequencies[params_index])
        self.eigenvals[params_index] = es.eigenvals
        self.eigenvecs[params_index] = es.evecs
        self.inv_eigenvecs[params_index] = es.inv_evecs
        self.eigen_decomp_valid[params_index] = True
        self._model_version += 1

    def _ensure_eigen(self, params_indices) -> None:
        for p in set(int(i) for i in params_indices):
            if not self.eigen_decomp_valid[p]:
                self.update_eigen(p)
