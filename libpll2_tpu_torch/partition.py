"""Partition: alignment, model, site data and likelihood buffers of one
partition, in PyTorch.

Port of libpll2_tpu/partition.py (reference: libpll-2 src/pll.c:424-1206,
partials.c, likelihood.c, derivatives.c, models.c). As in the JAX package,
the reference's per-index buffer tables are leading axes of dense tensors on
`device`, allocated at construction:

  * `clv` [nodes+1, rates, states, sites_padded]: tips hold bit-decoded
    indicator CLVs (ambiguity codes set several states), or the raw
    probabilities of `set_tip_clv`, the same for every rate; the last row
    is scratch;
  * `scale_buffer` [scale_buffers+2, sites_padded] int32, or
    [scale_buffers+2, rates, sites_padded] with `rate_scalers=True` (one
    count per rate category, PLL_ATTRIB_RATE_SCALERS): row K absorbs the
    counts of ops without a parent scaler (trash), row K+1 stays zero and
    serves every SCALE_BUFFER_NONE read;
  * `pmatrix` [prob_matrices, rates, states, states].

`sites_padded` is `sites`, plus `states` synthetic columns with an
ascertainment-bias correction (`asc_bias`): column sites + k observes state
k at every tip (pll.c:525-531), and its pattern weight is the state weight
of `set_asc_state_weights`.

With `site_repeats=True` (and at least C.REPEATS_MIN_SITES sites) the CLVs
are pooled class columns instead (repeats.py), classed over the real and the
asc columns: `clv` and `scale_buffer` are None, and `clv_flat` [rates,
states, columns] and `sc_flat` [columns] (or [rates, columns] per rate)
int32 hold every node's class columns and every scaler's counts in the
regions of a `FlatLayout`, laid out when an op list is first scheduled
(tips seed their regions from `_tip_cols`).

The step-by-step API (`update_prob_matrices` -> `update_partials` ->
`compute_edge_loglikelihood` / `compute_root_loglikelihood` /
`compute_node_ancestral` -> `update_sumtable` ->
`compute_likelihood_derivatives`) works on these buffers; `update_partials`
runs its op list level by level through the level kernel (ops/levels.py),
or on a repeats partition through the pool kernel (ops/pool.py). The fused
path of `TreeEngine` reads only the tip state bitmasks and the model, and
writes back the root edge's rows. The host mirrors (model, pattern weights,
tip masks) are numpy, as in the JAX package.

`device` defaults to "cuda" and raises without a CUDA device; the CPU runs
only when asked for (`device="cpu"`). `dtype` is explicit and defaults to
torch.float32, whose 2**-32 rescaling window keeps threshold**2 above
float32's smallest normal; torch.float64 uses the reference's 2**-256
window and runs only on the CPU (the kernels are float32).

Features outside this slice raise NotImplementedError naming the feature
(ROADMAP.md lists the module or kernel that lifts each one).
"""
from __future__ import annotations

from dataclasses import dataclass

from typing import Sequence

import numpy as np
import torch

from . import constants as C
from .io import maps as state_maps
from .ops import derivatives as ops_derivatives
from .ops import eigen as ops_eigen
from .ops import levels as ops_levels
from .ops import likelihood as ops_likelihood
from .ops import pmatrix as ops_pmatrix
from .ops import pool as ops_pool
from .ops.partials import Operations, gather_flat_view
from .repeats import RepeatsTable, build_flat_layout

__all__ = ["Operation", "Partition", "pack_operations",
           "pack_level_operations", "resolve_device"]

# both traversal kernels and tip_code_matrix carry tip states as int32 masks
MAX_STATES = 32


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


def resolve_device(device) -> torch.device:
    """`device` as a torch.device: CUDA raises RuntimeError when no CUDA
    device is available (no quiet fall back to the CPU), anything but CPU
    or CUDA raises PllError."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} needs a CUDA device, and "
                               f"none is available (pass device='cpu' to "
                               f"run on the CPU)")
    elif dev.type != "cpu":
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         f"device must be cpu or cuda, got {device!r}")
    return dev


def _fields(op: Operation):
    return (op.parent_clv_index, op.parent_scaler_index,
            op.child1_clv_index, op.child1_matrix_index,
            op.child1_scaler_index, op.child2_clv_index,
            op.child2_matrix_index, op.child2_scaler_index)


def pack_operations(operations: Sequence[Operation], *,
                    device) -> Operations:
    """Host operations as the structure-of-arrays format of
    ops/partials.py:update_partials (int64 tensors [n] on `device`)."""
    arr = np.array([_fields(op) for op in operations],
                   dtype=np.int64).reshape(-1, 8)
    t = torch.as_tensor(arr.T.copy(), device=device)
    return Operations(*t)


def pack_level_operations(operations: Sequence[Operation], n_tips: int,
                          scratch_clv: int, *, device):
    """Group operations into levels (ops/levels.py:schedule_levels) and
    pad to a rectangle. Returns (Operations of [L, W] tensors, valid [L, W]
    bool) for `update_partials_levels`: padded slots write the scratch CLV
    row and no scaler row."""
    levels = ops_levels.schedule_levels(operations, n_tips)
    n_levels = len(levels)
    width = max((len(lv) for lv in levels), default=0)
    pad = (scratch_clv, -1, 0, 0, -1, 0, 0, -1)
    arr = np.array([[_fields(op) for op in lv] + [pad] * (width - len(lv))
                    for lv in levels], dtype=np.int64)
    arr = arr.reshape(n_levels, width, 8)
    valid = np.zeros((n_levels, width), dtype=bool)
    for i, lv in enumerate(levels):
        valid[i, :len(lv)] = True
    t = torch.as_tensor(arr.transpose(2, 0, 1).copy(), device=device)
    return Operations(*t), torch.as_tensor(valid, device=device)


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
                 device="cuda",
                 dtype: torch.dtype = torch.float32,
                 rate_scalers: bool = False,
                 asc_bias: C.AscBias = C.AscBias.NONE,
                 site_repeats: bool = False,
                 mesh=None):
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.float64):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"dtype must be torch.float32 or torch.float64, "
                             f"got {dtype!r}")
        if self.device.type == "cuda" and dtype == torch.float64:
            raise not_ported("float64 on CUDA (the kernels are float32)")
        asc_bias = C.AscBias(asc_bias)
        if asc_bias != C.AscBias.NONE and rate_scalers:
            raise C.PllError(C.ERROR_AB_NOSUPPORT,
                             "Per-rate scalers are not supported with asc "
                             "bias correction")
        if mesh is not None:
            raise not_ported("site sharding over a device mesh")
        if states > MAX_STATES:
            raise not_ported(f"{states}-state alphabets (tip states travel "
                             f"to the kernels as 32-bit masks, so at most "
                             f"{MAX_STATES} states)")
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
        self.rate_scalers = bool(rate_scalers)
        self.asc_bias = asc_bias
        # the asc corrections append `states` synthetic all-state-k columns
        # after the real sites (pll.c:525-531); no site-grain padding
        # otherwise: the kernels mask the ragged edge themselves
        self.asc_extra = states if asc_bias != C.AscBias.NONE else 0
        self.sites_padded = sites + self.asc_extra

        S, R, s = self.sites_padded, rate_cats, states
        # repeats switch off below 16 sites, as in pll.c:441-449; the class
        # domain spans the asc columns too (repeats.c:69,122,201)
        self.repeats = None
        if site_repeats and sites >= C.REPEATS_MIN_SITES:
            self.repeats = RepeatsTable(self.nodes, S)
        if self.repeats is None:
            # +1 scratch CLV row; scalers get +2 rows: row K absorbs writes
            # of scaler-less ops (trash), row K+1 stays zero and serves
            # every SCALE_BUFFER_NONE read
            self.clv = torch.zeros((self.nodes + 1, R, s, S), dtype=dtype,
                                   device=self.device)
            self.scale_buffer = torch.zeros(
                (scale_buffers + 2,) + self._sc_rows() + (S,),
                dtype=torch.int32, device=self.device)
        else:
            # pooled class columns, laid out once class counts are known
            # (first update_partials, or the first read)
            self.clv = self.scale_buffer = None
            self.clv_flat = self.sc_flat = None
            self._flat = None
            self._tip_cols = {}          # tip -> numpy [s, classes] columns
            self._repeat_key = self._repeat_schedule = None
            self._repeat_layout = None
            # scaler index -> the node whose classes its region holds (the
            # parent of the last op that wrote it; repeats->perscale_ids)
            self._scaler_writer = {}
        self.pmatrix = torch.zeros((prob_matrices, R, s, s), dtype=dtype,
                                   device=self.device)
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
        # per-tip state bitmasks: the fused kernels' tip input
        self.tip_states = np.zeros((tips, S), dtype=np.uint64)
        self._tips_set = np.zeros(tips, dtype=bool)
        self._tips_clv_set = np.zeros(tips, dtype=bool)
        # bumped by tip setters; engines cache tip-code tensors on it
        self._tip_version = 0

    def _sc_rows(self) -> tuple:
        """The scaler buffers' rate axis: (rates,) with per-rate scalers."""
        return (self.rate_cats,) if self.rate_scalers else ()

    def _asc_cols(self) -> np.ndarray:
        """[states, asc_extra] values of the synthetic asc columns at a tip:
        column k observes state k."""
        return np.eye(self.states)[:, :self.asc_extra]

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

    def _set_tip_masks(self, tip_indices: np.ndarray, masks: np.ndarray,
                       chunk: int = 64) -> None:
        """Install decoded state bitmasks [n, sites] of `tip_indices`: the
        host mirror, and the tips' dense CLV rows (indicators, the same for
        every rate; the asc columns' single states after the sites), in
        chunks of `chunk` tips per device copy. On a repeats partition, the
        tips' classes and class columns instead, classed over the sites and
        the asc columns' single-state masks (repeats.c:189-254); the pooled
        layout and any cached schedule are then stale."""
        self.tip_states[tip_indices, :self.sites] = masks
        self._tips_set[tip_indices] = True
        self._tips_clv_set[tip_indices] = False
        self._tip_version += 1
        self._invariant_valid = False
        R, s, S = self.rate_cats, self.states, self.sites_padded
        if self.repeats is not None:
            self._flat = None
            self._repeat_key = self._repeat_schedule = None
            asc = np.uint64(1) << np.arange(self.asc_extra, dtype=np.uint64)
            for tip, m in zip(tip_indices, masks):
                tip = int(tip)
                m = np.concatenate([m, asc])
                self.repeats.set_tip(tip, m)
                rep = self.repeats.id_site[tip, :self.repeats.ids[tip]]
                self._tip_cols[tip] = np.ascontiguousarray(
                    state_maps.bits_to_clv(m[rep], s).T)
            return
        for c0 in range(0, len(tip_indices), chunk):
            idx = torch.as_tensor(tip_indices[c0:c0 + chunk],
                                  device=self.device)
            m = masks[c0:c0 + chunk]
            ind = state_maps.bits_to_clv(m.reshape(-1), s).reshape(
                len(m), self.sites, s)
            rows = np.zeros((len(m), s, S))
            rows[:, :, :self.sites] = ind.transpose(0, 2, 1)
            rows[:, :, self.sites:] = self._asc_cols()
            rows = torch.as_tensor(rows, dtype=self.dtype).to(self.device)
            self.clv[idx] = rows[:, None].expand(len(m), R, s, S)

    def set_tip_clv(self, tip_index: int, clv, padded: bool = False) -> None:
        """Set a tip CLV from [sites, states] values, the same for every
        rate category (pll.c:1063 pll_set_tip_clv), plus the asc columns'
        single states. The tip leaves invariant-site detection (its values
        are no state masks). On a repeats partition the tip takes the
        identity mapping (no classes to group probabilities by) and its
        per-site columns; the pooled layout and any cached schedule are
        then stale. `padded` is accepted for the reference's signature:
        states_padded equals states here."""
        self._index([tip_index], "tip index", self.tips)
        arr = np.asarray(clv, dtype=np.float64).reshape(self.sites,
                                                        self.states)
        cols = np.concatenate([arr.T, self._asc_cols()], axis=1)
        if self.repeats is not None:
            self.repeats.reset_node(tip_index)
            self._flat = None
            self._repeat_key = self._repeat_schedule = None
            self._tip_cols[tip_index] = np.ascontiguousarray(cols)
        else:
            rows = torch.as_tensor(cols, dtype=self.dtype).to(self.device)
            self.clv[tip_index] = rows[None].expand(self.rate_cats,
                                                    *rows.shape)
        self._tips_set[tip_index] = False
        self._tips_clv_set[tip_index] = True
        self._tip_version += 1
        self._invariant_valid = False

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

    def set_asc_bias_type(self, asc_bias: C.AscBias) -> None:
        """Switch the correction type (pll.c:1126-1172). The partition must
        have been created with asc_bias != NONE, so that the synthetic
        columns exist."""
        asc_bias = C.AscBias(asc_bias)
        if not self.asc_extra:
            raise C.PllError(C.ERROR_AB_NOSUPPORT,
                             "Partition was not created with ascertainment "
                             "bias support")
        if asc_bias != C.AscBias.NONE and np.any(self.prop_invar > 0):
            raise C.PllError(C.ERROR_INVAR_INCOMPAT,
                             "Invariant sites are not compatible with asc "
                             "bias correction")
        if asc_bias != C.AscBias.NONE and self.rate_scalers:
            raise C.PllError(C.ERROR_AB_NOSUPPORT,
                             "Per-rate scalers are not supported with asc "
                             "bias correction")
        self.asc_bias = asc_bias

    def set_asc_state_weights(self, state_weights) -> None:
        """Weights of the synthetic per-state columns (pll.c:1174-1181):
        for Stamatakis the per-state invariant-site counts, for Felsenstein
        the number of invariant sites (on any column)."""
        if not self.asc_extra:
            raise C.PllError(C.ERROR_AB_NOSUPPORT,
                             "Partition was not created with ascertainment "
                             "bias support")
        self.pattern_weights[self.sites:] = np.asarray(state_weights,
                                                       dtype=np.int64)
        self._model_version += 1

    def update_invariant_sites_proportion(self, params_index: int,
                                          prop_invar: float) -> None:
        """models.c:495-544."""
        if prop_invar != 0.0 and self.asc_bias != C.AscBias.NONE:
            raise C.PllError(C.ERROR_INVAR_INCOMPAT,
                             "Invariant sites are not compatible with asc "
                             "bias")
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

    # ----------------------------------------------------------- to device
    def _dev(self, a, dtype=None) -> torch.Tensor:
        """A host array as a tensor on the partition's device (the model
        mirrors in the partition's dtype)."""
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    def _index(self, a, what: str, limit: int, low: int = 0) -> np.ndarray:
        idx = np.asarray(a, dtype=np.int64).reshape(-1)
        if idx.size and (idx.min() < low or idx.max() >= limit):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"{what} out of range [{low}, {limit})")
        return idx

    def _check_operations(self, operations: Sequence[Operation]) -> None:
        """Raise PllError unless every index of every op is in range: the
        kernels trust them."""
        f = np.array([_fields(op) for op in operations],
                     dtype=np.int64).reshape(-1, 8)
        self._index(f[:, [0, 2, 5]], "CLV index", self.nodes)
        self._index(f[:, [3, 6]], "matrix index", self.prob_matrices)
        self._index(f[:, [1, 4, 7]], "scaler index", self.scale_buffers,
                    low=C.SCALE_BUFFER_NONE)

    # -------------------------------------------------------------- pmatrix
    def update_prob_matrices(self, params_indices, matrix_indices,
                             branch_lengths) -> None:
        """models.c:412-443, batched over all requested edges at once.
        `params_indices` holds one rate-matrix index per rate category
        (mixtures such as LG4X use [0, 1, 2, 3])."""
        pidx = self._index(params_indices, "params index",
                           self.rate_matrices)
        if pidx.size != self.rate_cats:
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"params_indices needs {self.rate_cats} "
                             f"entries, got {pidx.size}")
        midx = self._index(matrix_indices, "matrix index",
                           self.prob_matrices)
        blen = np.asarray(branch_lengths, dtype=np.float64).reshape(-1)
        if blen.size != midx.size:
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"{midx.size} matrix indices but {blen.size} "
                             f"branch lengths")
        self._ensure_eigen(pidx)
        pmat = ops_pmatrix.update_prob_matrices(
            self._dev(self.eigenvals), self._dev(self.inv_eigenvecs),
            self._dev(self.eigenvecs), self._dev(self.prop_invar),
            self._dev(self.rates), self._dev(pidx, torch.long),
            self._dev(blen))
        self.pmatrix[self._dev(midx, torch.long)] = pmat

    # -------------------------------------------------------------- partials
    def update_partials(self, operations: Sequence[Operation],
                        update_repeats: bool = True) -> None:
        """partials.c:237-291. The op list runs level by level
        (ops/levels.py:schedule_levels: its dependency levels, or one op
        per level where they would not equal the serial list), each level
        one launch of the level kernel on CUDA, or its plain version on the
        CPU; parent rows and scaler rows are written in place.

        On a repeats partition the levels run over the pooled class columns
        through the pool kernel (ops/pool.py), one launch per level. The
        class schedule is rebuilt when the op list (every field of every
        op), the tips or the pooled layout changed; with `update_repeats`
        False the class tables are left as they are
        (pll_update_partials_rep with update_repeats=0). With per-rate
        scalers both kernels run their per-rate mode (each rate category
        rescales on its own, one count per rate)."""
        operations = list(operations)
        self._check_operations(operations)
        if self.repeats is not None:
            plan = self._pool_plan(operations, update_repeats)
            for op in operations:
                if op.parent_scaler_index >= 0:
                    self._scaler_writer[op.parent_scaler_index] = \
                        op.parent_clv_index
            ops_pool.update_partials_pool(
                self.clv_flat, self.sc_flat, self.pmatrix, plan,
                self.scale_threshold, self.scale_factor)
            return
        tables = ops_levels.pack_pallas_levels(
            operations, self.tips, zero_scaler_row=self.scale_buffers + 1,
            trash_scaler_row=self.scale_buffers)
        ops_levels.update_partials_kernel(
            self.clv, self.scale_buffer, self.pmatrix,
            ops_levels.tables_to_device(tables, self.device),
            self.scale_threshold, self.scale_factor)

    def _pool_plan(self, operations, update_repeats: bool):
        """The device plan of `operations` on the pooled storage, cached
        until the op list, the tips or the installed layout changes."""
        key = tuple(_fields(op) for op in operations)
        if (self._repeat_schedule is None or key != self._repeat_key
                or self._flat is not self._repeat_layout):
            layout, levels = ops_pool.schedule_pool_levels(
                self.repeats, operations, self.tips, self.sites_padded,
                self.scale_buffers, update_repeats=update_repeats,
                previous=self._flat)
            self._install_flat(layout)
            self._repeat_schedule = ops_pool.plan_to_device(
                *ops_pool.pack_pool_levels(layout, levels), self.device)
            self._repeat_key, self._repeat_layout = key, layout
        return self._repeat_schedule

    # -------------------------------------------------------- flat storage
    def _install_flat(self, layout) -> None:
        """(Re)allocate the pooled buffers for `layout`: the tips' regions
        seeded from their class columns, and every inner node's and
        scaler's columns carried over from the previous layout (as many as
        both regions hold), so that a partial traversal finds the children
        it does not recompute. (The JAX package starts every new layout
        from zeros.) Per-rate scalers carry all R rows of a region."""
        R, s = self.rate_cats, self.states
        dev = self.device
        clv = torch.zeros((R, s, layout.total), dtype=self.dtype, device=dev)
        sc = torch.zeros(self._sc_rows() + (layout.sc_total,),
                         dtype=torch.int32, device=dev)
        old = self._flat
        if old is not None:
            def cols(offs_old, offs_new, caps_old, caps_new, which):
                src, dst = [], []
                for n in which:
                    w = int(min(caps_old[n], caps_new[n]))
                    src.append(offs_old[n] + np.arange(w))
                    dst.append(offs_new[n] + np.arange(w))
                cat = (lambda a: torch.as_tensor(
                    np.concatenate(a) if a else np.zeros(0, np.int64),
                    device=dev))
                return cat(src), cat(dst)

            src, dst = cols(old.off, layout.off, old.caps, layout.caps,
                            range(self.tips, self.nodes))
            clv[:, :, dst] = self.clv_flat[:, :, src]
            src, dst = cols(old.sc_off, layout.sc_off, old.sc_caps,
                            layout.sc_caps, range(self.scale_buffers))
            sc[..., dst] = self.sc_flat[..., src]
        tips = sorted(self._tip_cols)
        if tips:
            cols = np.concatenate([self._tip_cols[t] for t in tips], axis=1)
            dst = np.concatenate([layout.off[t] + np.arange(
                self._tip_cols[t].shape[1]) for t in tips])
            clv[:, :, torch.as_tensor(dst, device=dev)] = torch.as_tensor(
                cols, dtype=self.dtype, device=dev)[None]
        self.clv_flat, self.sc_flat, self._flat = clv, sc, layout

    def _ensure_flat(self) -> None:
        if self._flat is None:
            self._install_flat(build_flat_layout(
                self.repeats, {}, self.sites_padded, self.scale_buffers))

    # ------------------------------------------------------------ likelihood
    def _scaler_row(self, index: int):
        if index == C.SCALE_BUFFER_NONE:
            # the guaranteed-zero row (never written)
            return self.scale_buffer[self.scale_buffers + 1], False
        self._index([index], "scaler index", self.scale_buffers)
        return self.scale_buffer[index], True

    def _scaler_sites(self, index: int) -> torch.Tensor:
        """Per-site counts [S] of scaler `index`, zero for SCALE_BUFFER_NONE:
        its row, or on a repeats partition its region read through the
        classes of the node that last wrote it (the reference's
        perscale_ids; zero if no op wrote it)."""
        if self.repeats is None:
            return self._scaler_row(index)[0]
        node = self._scaler_writer.get(index)
        if node is None:
            return torch.zeros(self.sites_padded, dtype=torch.int32,
                               device=self.device)
        return self._node_view(node, index)[1]

    def _node_view(self, clv_index: int, scaler_index: int):
        """(clv [R, s, S], scaler [S] or [R, S], has_scaler) of one node; on
        a repeats partition its pooled class columns expanded through
        site_id."""
        self._index([clv_index], "CLV index", self.nodes)
        if self.repeats is not None:
            if scaler_index != C.SCALE_BUFFER_NONE:
                self._index([scaler_index], "scaler index",
                            self.scale_buffers)
            self._ensure_flat()
            lay = self._flat
            sid = self.repeats.site_id[clv_index].astype(np.int64)
            has = (scaler_index != C.SCALE_BUFFER_NONE
                   and lay.sc_caps[scaler_index] > 0)
            sc_base = lay.sc_off[scaler_index] if has else lay.sc_zero
            clv_node, scaler = gather_flat_view(
                self.clv_flat, self.sc_flat,
                self._dev(lay.off[clv_index] + sid, torch.long),
                self._dev(sc_base + sid, torch.long))
            return clv_node, scaler, has
        scaler, has = self._scaler_row(scaler_index)
        return self.clv[clv_index], scaler, has

    def _site_tensors(self):
        return (self._dev(self.pattern_weights, torch.long),
                self._dev(self.invariant, torch.long))

    def _persite(self, total, per, persite: bool):
        if persite:
            return float(total), per.cpu().numpy()[:self.sites]
        return float(total)

    def _modes(self) -> dict:
        """The per-rate and asc arguments of the likelihood functions (the
        engine's paths and the step-by-step API alike; n_real marks the
        first synthetic column, past the last column without asc)."""
        return dict(rate_scalers=self.rate_scalers,
                    asc_type=self.asc_bias.value, n_real=self.sites)

    def compute_root_loglikelihood(self, clv_index: int, scaler_index: int,
                                   freqs_indices, persite: bool = False):
        """likelihood.c:122-190: the likelihood at a root CLV (rooted
        trees). Returns logL, or (logL, per-site weighted logL) with
        `persite`."""
        clv_node, scaler, has_scaler = self._node_view(clv_index,
                                                       scaler_index)
        pidx = self._index(freqs_indices, "params index", self.rate_matrices)
        total, per = ops_likelihood.root_loglikelihood(
            clv_node, scaler, self._dev(self.frequencies),
            self._dev(self.prop_invar), self._dev(self.rate_weights),
            self._dev(pidx, torch.long), *self._site_tensors(),
            self.scale_threshold, has_scaler=has_scaler, **self._modes())
        return self._persite(total, per, persite)

    def compute_edge_loglikelihood(self, parent_clv_index: int,
                                   parent_scaler_index: int,
                                   child_clv_index: int,
                                   child_scaler_index: int,
                                   matrix_index: int,
                                   freqs_indices,
                                   persite: bool = False):
        """likelihood.c:586-700: the likelihood across the edge (parent,
        child) with P-matrix `matrix_index`."""
        pclv, pscaler, has_p = self._node_view(parent_clv_index,
                                               parent_scaler_index)
        cclv, cscaler, has_c = self._node_view(child_clv_index,
                                               child_scaler_index)
        self._index([matrix_index], "matrix index", self.prob_matrices)
        pidx = self._index(freqs_indices, "params index", self.rate_matrices)
        total, per = ops_likelihood.edge_loglikelihood(
            pclv, cclv, pscaler, cscaler, self.pmatrix[matrix_index],
            self._dev(self.frequencies), self._dev(self.prop_invar),
            self._dev(self.rate_weights), self._dev(pidx, torch.long),
            *self._site_tensors(), self.scale_threshold,
            has_pscaler=has_p, has_cscaler=has_c, **self._modes())
        return self._persite(total, per, persite)

    def compute_node_ancestral(self, node_clv_index: int,
                               node_scaler_index: int,
                               other_clv_index: int,
                               other_scaler_index: int,
                               matrix_index: int,
                               freqs_indices) -> np.ndarray:
        """Marginal ancestral state probabilities [sites, states] at `node`,
        combining its CLV with the neighbour's across the connecting edge
        (likelihood.c:758-830, pll_compute_node_ancestral)."""
        nclv, nscaler, has_n = self._node_view(node_clv_index,
                                               node_scaler_index)
        oclv, oscaler, has_o = self._node_view(other_clv_index,
                                               other_scaler_index)
        self._index([matrix_index], "matrix index", self.prob_matrices)
        pidx = self._index(freqs_indices, "params index", self.rate_matrices)
        anc = ops_likelihood.node_ancestral(
            nclv, oclv, nscaler, oscaler, self.pmatrix[matrix_index],
            self._dev(self.frequencies), self._dev(self.rate_weights),
            self._dev(pidx, torch.long), self.scale_threshold,
            rate_scalers=self.rate_scalers, has_nscaler=has_n,
            has_oscaler=has_o)
        return anc.cpu().numpy()[:self.sites]

    # ----------------------------------------------------------- derivatives
    def update_sumtable(self, parent_clv_index: int, child_clv_index: int,
                        parent_scaler_index: int, child_scaler_index: int,
                        params_indices) -> torch.Tensor:
        """derivatives.c:239-330 (phase 1, once per edge): the sumtable
        [R, s, S] on the partition's device."""
        pclv, pscaler, has_p = self._node_view(parent_clv_index,
                                               parent_scaler_index)
        cclv, cscaler, has_c = self._node_view(child_clv_index,
                                               child_scaler_index)
        pidx = self._index(params_indices, "params index",
                           self.rate_matrices)
        self._ensure_eigen(pidx)
        return ops_derivatives.update_sumtable(
            pclv, cclv, pscaler, cscaler, self._dev(self.inv_eigenvecs),
            self._dev(self.eigenvecs), self._dev(self.frequencies),
            self._dev(pidx, torch.long), self.scale_threshold,
            rate_scalers=self.rate_scalers, has_pscaler=has_p,
            has_cscaler=has_c)

    def compute_likelihood_derivatives(self, sumtable: torch.Tensor,
                                       params_indices,
                                       branch_length: float,
                                       parent_scaler_index: int =
                                       C.SCALE_BUFFER_NONE,
                                       child_scaler_index: int =
                                       C.SCALE_BUFFER_NONE):
        """derivatives.c:333-416 (phase 2, per candidate length): (d1, d2)
        of -logL. The Lewis and Felsenstein asc corrections need the
        sumtable's edge's scaler indices, to undo the synthetic columns'
        scaling."""
        pidx = self._index(params_indices, "params index",
                           self.rate_matrices)
        self._ensure_eigen(pidx)
        asc_scalers = None
        if self.asc_bias in (C.AscBias.LEWIS, C.AscBias.FELSENSTEIN):
            asc_scalers = (self._scaler_sites(parent_scaler_index)
                           + self._scaler_sites(child_scaler_index))
        d1, d2 = ops_derivatives.likelihood_derivatives(
            sumtable, self._dev(self.eigenvals), self._dev(self.prop_invar),
            self._dev(self.frequencies), self._dev(self.rates),
            self._dev(self.rate_weights), self._dev(pidx, torch.long),
            *self._site_tensors(), self._dev(branch_length),
            asc_scalers=asc_scalers, scale_threshold=self.scale_threshold,
            asc_type=self.asc_bias.value, n_real=self.sites)
        return float(d1), float(d2)

    # ------------------------------------------------------------- debugging
    def get_clv(self, index: int) -> np.ndarray:
        """CLV of the real sites as [sites, rate_cats, states] (reference
        memory order); on a repeats partition the pooled class columns
        expanded per site."""
        if self.repeats is not None:
            self._ensure_flat()
            o, c = int(self._flat.off[index]), int(self._flat.caps[index])
            block = self.clv_flat[:, :, o:o + c].cpu().numpy()
            block = block[:, :, self.repeats.site_id[index, :self.sites]]
        else:
            block = self.clv[index, :, :, :self.sites].cpu().numpy()
        return np.transpose(block, (2, 0, 1))

    def clv_bytes(self) -> int:
        """Allocated CLV + scaler bytes (the pooled buffers on a repeats
        partition: the memory site repeats save shows here)."""
        if self.repeats is not None:
            self._ensure_flat()
            bufs = (self.clv_flat, self.sc_flat)
        else:
            bufs = (self.clv, self.scale_buffer)
        return sum(b.numel() * b.element_size() for b in bufs)

    def get_pmatrix(self, index: int) -> np.ndarray:
        return self.pmatrix[index].cpu().numpy()

    def get_scaler(self, index: int) -> np.ndarray:
        """Scaler counts of the real sites ([sites], or [rates, sites] per
        rate); on a repeats partition the raw class-layout region of the
        pooled buffer (its width is the region's capacity)."""
        if self.repeats is not None:
            self._ensure_flat()
            lay = self._flat
            o, c = int(lay.sc_off[index]), int(lay.sc_caps[index])
            return self.sc_flat[..., o:o + c].cpu().numpy()
        return self.scale_buffer[index, ..., :self.sites].cpu().numpy()
