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
of `set_asc_state_weights`; rounded up to a multiple of `sites_alignment`
(pad columns carry zero weight and zero tip codes), so that the columns
split evenly over the shards of a site mesh.

On a mesh (`mesh=`, or `parallel.shard_partition`) the partition keeps one
column block per shard it owns, each a `PartitionShard` on its shard's
device with its own dense buffers (the asc columns where JAX's global
layout puts them, after the real sites); the host mirrors stay here, one
copy. The step-by-step API then runs once a shard and reduces the per-shard
sums (parallel/sharding.py:psum); per-site outputs are concatenated in
shard order.

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
window. The kernels are float32, so a float64 partition on CUDA runs the
plain PyTorch versions (ops/levels.py:level_for, ops/pool.py:pool_for), as
JAX runs such a partition on XLA.

Alphabets of up to MAX_STATES (64) states: the tip states are uint64 masks,
as in JAX. The level and pool kernels take them all (33-64 states through
their 64-state instantiation, csrc/states64.cuh); the fused kernels take at
most ops/fused.py:FUSED_MAX_STATES (32: their tip codes are int32 masks),
and TreeEngine routes a larger alphabet off them.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass

from typing import Optional, Sequence

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
from .parallel.sharding import psum, shard_partition
from .repeats import RepeatsTable, build_flat_layout

__all__ = ["Operation", "Partition", "PartitionShard", "pack_operations",
           "pack_level_operations", "resolve_device"]

# tip states are uint64 masks (as libpll2_tpu/partition.py:229 keeps them)
MAX_STATES = 64


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


def _is_packed(operations) -> bool:
    """Packed Operations (this package's or JAX's: a named tuple of the
    same eight fields) rather than a sequence of Operation."""
    return getattr(operations, "_fields", None) == Operations._fields


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
                 sites_alignment: int = 1,
                 site_repeats: bool = False,
                 mesh=None):
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.float64):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"dtype must be torch.float32 or torch.float64, "
                             f"got {dtype!r}")
        asc_bias = C.AscBias(asc_bias)
        if asc_bias != C.AscBias.NONE and rate_scalers:
            raise C.PllError(C.ERROR_AB_NOSUPPORT,
                             "Per-rate scalers are not supported with asc "
                             "bias correction")
        if states > MAX_STATES:
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"states={states}: tip states are 64-bit "
                             f"masks, so at most {MAX_STATES} states")
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
        # otherwise (the kernels mask the ragged edge themselves), only the
        # `sites_alignment` a mesh asks for
        self.asc_extra = states if asc_bias != C.AscBias.NONE else 0
        base = sites + self.asc_extra
        self.sites_padded = -(-base // sites_alignment) * sites_alignment
        self.mesh = self.shards = None

        S, R, s = self.sites_padded, rate_cats, states
        # repeats switch off below 16 sites, as in pll.c:441-449; the class
        # domain spans the asc columns too (repeats.c:69,122,201), and a
        # padded partition keeps dense buffers (libpll2_tpu/partition.py:
        # 177)
        self.repeats = None
        if (site_repeats and sites >= C.REPEATS_MIN_SITES
                and self.sites_padded == base):
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
        self._dense_tip_key = self._dense_tip_cache = None
        if mesh is not None:
            shard_partition(self, mesh)

    def _sc_rows(self) -> tuple:
        """The scaler buffers' rate axis: (rates,) with per-rate scalers."""
        return (self.rate_cats,) if self.rate_scalers else ()

    def _asc_cols(self) -> np.ndarray:
        """[states, asc_extra] values of the synthetic asc columns at a tip:
        column k observes state k."""
        return np.eye(self.states)[:, :self.asc_extra]

    def _pad_cols(self, cols: np.ndarray) -> np.ndarray:
        """[..., sites] tip values with the asc columns appended and the
        pad columns zero: [..., sites_padded]."""
        out = np.zeros(cols.shape[:-1] + (self.sites_padded,))
        out[..., :self.sites] = cols
        out[..., self.sites:self.sites + self.asc_extra] = self._asc_cols()
        return out

    def _blocks(self) -> list:
        """(holder of the dense buffers, its first column): each shard on a
        sharded partition, else the partition itself."""
        if self.shards is None:
            return [(self, 0)]
        return [(sh, sh.lo) for sh in self.shards]

    def _write_tip_rows(self, tip_indices, rows: np.ndarray) -> None:
        """Dense tip rows [n, states, sites_padded], the same for every rate,
        into `clv`, or into each shard's column block."""
        R, s = self.rate_cats, self.states
        for blk, lo in self._blocks():
            w = blk.sites_padded
            idx = torch.as_tensor(np.asarray(tip_indices), device=blk.device)
            t = torch.as_tensor(rows[..., lo:lo + w],
                                dtype=self.dtype).to(blk.device)
            blk.clv[idx] = t[:, None].expand(len(idx), R, s, w)

    def _tip_clv_rows(self, tip_indices) -> torch.Tensor:
        """The dense rows [n, states, sites_padded] of `tip_indices` (rate
        0), gathered from the shards on a mesh."""
        def rows(blk):
            idx = torch.as_tensor(np.asarray(tip_indices), device=blk.device)
            return blk.clv[idx, 0]

        if self.shards is None:
            return rows(self)
        return torch.cat([rows(sh).to(self.device) for sh in self.shards],
                         dim=-1)

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
        s = self.states
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
            m = masks[c0:c0 + chunk]
            ind = state_maps.bits_to_clv(m.reshape(-1), s).reshape(
                len(m), self.sites, s)
            self._write_tip_rows(tip_indices[c0:c0 + chunk],
                                 self._pad_cols(ind.transpose(0, 2, 1)))

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
        cols = self._pad_cols(arr.T)
        if self.repeats is not None:
            self.repeats.reset_node(tip_index)
            self._flat = None
            self._repeat_key = self._repeat_schedule = None
            self._tip_cols[tip_index] = np.ascontiguousarray(cols)
        else:
            self._write_tip_rows([tip_index], cols[None])
        self._tips_set[tip_index] = False
        self._tips_clv_set[tip_index] = True
        self._tip_version += 1
        self._invariant_valid = False

    def dense_tip_rows(self) -> torch.Tensor:
        """[tips, states, sites_padded] per-site tip CLVs in the partition's
        dtype on its device, the same for every rate (callers broadcast over
        the categories): the streamed search's base on a site-repeats
        partition, whose pooled class columns have no dense rows
        (libpll2_tpu/partition.py:390). State-code tips decode their masks
        and the asc columns their single states; tips set with set_tip_clv
        take their values (on a repeats partition their per-site columns).
        Needs every tip set; cached until a tip setter runs."""
        if self._dense_tip_key == self._tip_version:
            return self._dense_tip_cache
        if not bool(np.all(self._tips_set | self._tips_clv_set)):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             "dense_tip_rows needs every tip set")
        s, n = self.states, self.sites
        rows = np.zeros((self.tips, s, self.sites_padded))
        coded = np.flatnonzero(self._tips_set)
        ind = state_maps.bits_to_clv(
            self.tip_states[coded, :n].reshape(-1), s).reshape(-1, n, s)
        rows[coded, :, :n] = ind.transpose(0, 2, 1)
        rows[coded, :, n:n + self.asc_extra] = self._asc_cols()
        raw = np.flatnonzero(self._tips_clv_set)
        if self.repeats is not None:
            # a raw tip of a repeats partition has the identity mapping: its
            # class columns are its per-site columns, asc columns included
            for t in raw:
                rows[t] = self._tip_cols[t]
        out = torch.as_tensor(rows, dtype=self.dtype).to(self.device)
        if self.repeats is None and raw.size:
            out[torch.as_tensor(raw, device=self.device)] = \
                self._tip_clv_rows(raw)
        self._dense_tip_cache, self._dense_tip_key = out, self._tip_version
        return out

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
        self.pattern_weights[self.sites:self.sites + self.asc_extra] = \
            np.asarray(state_weights, dtype=np.int64)
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

    def count_invariant_sites(self) -> int:
        """Sites (pattern weights) whose tips share one state
        (libpll2_tpu/partition.py:517-521); detects them first if a tip
        setter made the detection stale."""
        if not self._invariant_valid:
            self.update_invariant_sites()
        mask = self.invariant[:self.sites] >= 0
        return int(self.pattern_weights[:self.sites][mask].sum())

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

    def _unpack(self, packed) -> list:
        """Packed Operations [n] as Operation objects, without JAX's
        padding entries (parent: the scratch CLV row `nodes`)."""
        cols = [np.asarray(f.cpu() if isinstance(f, torch.Tensor) else f)
                for f in packed]
        if any(c.ndim != 1 for c in cols):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             "packed Operations must hold [n] arrays (the "
                             "serial op list)")
        rows = np.stack(cols, axis=1).astype(np.int64).tolist()
        return [Operation(*r) for r in rows if r[0] != self.nodes]

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
        for blk, _ in self._blocks():
            blk.pmatrix[torch.as_tensor(midx, device=blk.device)] = \
                pmat.to(blk.device)

    # -------------------------------------------------------------- partials
    def update_partials(self, operations: Sequence[Operation],
                        pad_to: Optional[int] = None,
                        update_repeats: bool = True) -> None:
        """partials.c:237-291. `operations` is a list of Operation or, on a
        dense partition, packed Operations (`pack_operations`, or JAX's,
        whose padding entries write the scratch CLV row and are dropped
        here); a repeats partition refuses packed ones (PllError), as JAX
        does. `pad_to` (JAX's op count to pad to, an int or None) pads
        nothing: the port compiles nothing per op count. The op list runs
        level by level
        (ops/levels.py:schedule_levels: its dependency levels, or one op
        per level where they would not equal the serial list), each level
        one launch of the level kernel on CUDA, or its plain version on the
        CPU and for float64 (ops/levels.py:level_for); parent rows and
        scaler rows are written in place.

        On a repeats partition the levels run over the pooled class columns
        through the pool kernel (ops/pool.py): at 4 states x 4 rates one
        launch for the whole list, else one launch per level. The
        class schedule is rebuilt when the op list (every field of every
        op), the tips or the pooled layout changed; with `update_repeats`
        False the class tables are left as they are
        (pll_update_partials_rep with update_repeats=0). With per-rate
        scalers both kernels run their per-rate mode (each rate category
        rescales on its own, one count per rate)."""
        if pad_to is not None:
            operator.index(pad_to)
        if _is_packed(operations):
            if self.repeats is not None:
                raise C.PllError(C.ERROR_PARAM_INVALID,
                                 "site-repeats partitions need the host-side "
                                 "Operation list (class columns), not packed "
                                 "Operations")
            operations = self._unpack(operations)
        operations = list(operations)
        self._check_operations(operations)
        if self.shards is not None:
            for sh in self.shards:
                sh.update_partials(operations, update_repeats=update_repeats)
            return
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
                *ops_pool.pack_pool_levels(layout, levels), self.device,
                self.rate_cats, self.states)
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

    def _reduce(self, name: str, *args):
        """`name`'s (total, per-site) on a partition, or on a sharded one
        once a shard: the shards' partial sums reduced in shard order and
        finished (ops/likelihood.py:asc_total), the per-site values
        concatenated."""
        if self.shards is None:
            return getattr(self, name)(*args)
        outs = [getattr(sh, name)(*args) for sh in self.shards]
        total = ops_likelihood.asc_total(
            psum([o[0] for o in outs], self.mesh), self.asc_bias.value)
        return total, torch.cat([o[1].to(self.device) for o in outs])

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
        total, per = self._reduce("_root_terms", clv_index, scaler_index,
                                  freqs_indices)
        return self._persite(total, per, persite)

    def _root_terms(self, clv_index, scaler_index, freqs_indices):
        clv_node, scaler, has_scaler = self._node_view(clv_index,
                                                       scaler_index)
        pidx = self._index(freqs_indices, "params index", self.rate_matrices)
        return ops_likelihood.root_loglikelihood(
            clv_node, scaler, self._dev(self.frequencies),
            self._dev(self.prop_invar), self._dev(self.rate_weights),
            self._dev(pidx, torch.long), *self._site_tensors(),
            self.scale_threshold, has_scaler=has_scaler, **self._modes())

    def compute_edge_loglikelihood(self, parent_clv_index: int,
                                   parent_scaler_index: int,
                                   child_clv_index: int,
                                   child_scaler_index: int,
                                   matrix_index: int,
                                   freqs_indices,
                                   persite: bool = False):
        """likelihood.c:586-700: the likelihood across the edge (parent,
        child) with P-matrix `matrix_index`."""
        total, per = self._reduce(
            "_edge_terms", parent_clv_index, parent_scaler_index,
            child_clv_index, child_scaler_index, matrix_index, freqs_indices)
        return self._persite(total, per, persite)

    def _edge_terms(self, parent_clv_index, parent_scaler_index,
                    child_clv_index, child_scaler_index, matrix_index,
                    freqs_indices):
        pclv, pscaler, has_p = self._node_view(parent_clv_index,
                                               parent_scaler_index)
        cclv, cscaler, has_c = self._node_view(child_clv_index,
                                               child_scaler_index)
        self._index([matrix_index], "matrix index", self.prob_matrices)
        pidx = self._index(freqs_indices, "params index", self.rate_matrices)
        return ops_likelihood.edge_loglikelihood(
            pclv, cclv, pscaler, cscaler, self.pmatrix[matrix_index],
            self._dev(self.frequencies), self._dev(self.prop_invar),
            self._dev(self.rate_weights), self._dev(pidx, torch.long),
            *self._site_tensors(), self.scale_threshold,
            has_pscaler=has_p, has_cscaler=has_c, **self._modes())

    def compute_node_ancestral(self, node_clv_index: int,
                               node_scaler_index: int,
                               other_clv_index: int,
                               other_scaler_index: int,
                               matrix_index: int,
                               freqs_indices) -> np.ndarray:
        """Marginal ancestral state probabilities [sites, states] at `node`,
        combining its CLV with the neighbour's across the connecting edge
        (likelihood.c:758-830, pll_compute_node_ancestral)."""
        if self.shards is not None:
            return np.concatenate([sh.compute_node_ancestral(
                node_clv_index, node_scaler_index, other_clv_index,
                other_scaler_index, matrix_index, freqs_indices)
                for sh in self.shards])[:self.sites]
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
        [R, s, S] on the partition's device; on a sharded partition a
        tuple of the shards' sumtables, each on its shard's device."""
        if self.shards is not None:
            return tuple(sh.update_sumtable(
                parent_clv_index, child_clv_index, parent_scaler_index,
                child_scaler_index, params_indices) for sh in self.shards)
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
        scaling. On a sharded partition `sumtable` is `update_sumtable`'s
        tuple, and the shards' partial sums are reduced first."""
        if self.shards is not None:
            if len(sumtable) != len(self.shards):
                raise C.PllError(C.ERROR_PARAM_INVALID,
                                 f"a sharded partition takes one sumtable "
                                 f"a shard ({len(self.shards)}), got "
                                 f"{len(sumtable)}")
            parts = psum([sh._derivative_terms(
                st, params_indices, branch_length, parent_scaler_index,
                child_scaler_index) for sh, st in zip(self.shards, sumtable)],
                self.mesh)
            d1, d2 = ops_derivatives.derivatives_total(parts,
                                                       self.asc_bias.value)
            return float(d1), float(d2)
        d1, d2 = self._derivative_terms(sumtable, params_indices,
                                        branch_length, parent_scaler_index,
                                        child_scaler_index)
        return float(d1), float(d2)

    def _derivative_terms(self, sumtable, params_indices, branch_length,
                          parent_scaler_index, child_scaler_index):
        pidx = self._index(params_indices, "params index",
                           self.rate_matrices)
        self._ensure_eigen(pidx)
        asc_scalers = None
        if self.asc_bias in (C.AscBias.LEWIS, C.AscBias.FELSENSTEIN):
            asc_scalers = (self._scaler_sites(parent_scaler_index)
                           + self._scaler_sites(child_scaler_index))
        modes = self._modes()
        del modes["rate_scalers"]
        return ops_derivatives.likelihood_derivatives(
            sumtable, self._dev(self.eigenvals), self._dev(self.prop_invar),
            self._dev(self.frequencies), self._dev(self.rates),
            self._dev(self.rate_weights), self._dev(pidx, torch.long),
            *self._site_tensors(), self._dev(branch_length),
            asc_scalers=asc_scalers, scale_threshold=self.scale_threshold,
            **modes)

    # ------------------------------------------------------------- debugging
    def get_clv(self, index: int) -> np.ndarray:
        """CLV of the real sites as [sites, rate_cats, states] (reference
        memory order); on a repeats partition the pooled class columns
        expanded per site."""
        if self.shards is not None:
            return np.concatenate([sh.get_clv(index) for sh in self.shards]
                                  )[:self.sites]
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
        partition: the memory site repeats save shows here; every shard's
        on a sharded one)."""
        if self.shards is not None:
            return sum(sh.clv_bytes() for sh in self.shards)
        if self.repeats is not None:
            self._ensure_flat()
            bufs = (self.clv_flat, self.sc_flat)
        else:
            bufs = (self.clv, self.scale_buffer)
        return sum(b.numel() * b.element_size() for b in bufs)

    def get_pmatrix(self, index: int) -> np.ndarray:
        if self.shards is not None:
            return self.shards[0].get_pmatrix(index)
        return self.pmatrix[index].cpu().numpy()

    def get_scaler(self, index: int) -> np.ndarray:
        """Scaler counts of the real sites ([sites], or [rates, sites] per
        rate); on a repeats partition the raw class-layout region of the
        pooled buffer (its width is the region's capacity)."""
        if self.shards is not None:
            return np.concatenate([sh.get_scaler(index)
                                   for sh in self.shards], axis=-1
                                  )[..., :self.sites]
        if self.repeats is not None:
            self._ensure_flat()
            lay = self._flat
            o, c = int(lay.sc_off[index]), int(lay.sc_caps[index])
            return self.sc_flat[..., o:o + c].cpu().numpy()
        return self.scale_buffer[index, ..., :self.sites].cpu().numpy()

    # ------------------------------------------------------------- the mesh
    def _dense_buffers(self):
        """(clv, scale_buffer), the shards' blocks concatenated on the first
        shard's device on a sharded partition."""
        if self.shards is None:
            return self.clv, self.scale_buffer
        dev = self.shards[0].device
        return (torch.cat([sh.clv.to(dev) for sh in self.shards], dim=-1),
                torch.cat([sh.scale_buffer.to(dev) for sh in self.shards],
                          dim=-1))

    def _shard(self, mesh) -> None:
        """One PartitionShard a shard this process owns, each holding its
        equal column block of the dense buffers on its device, the
        P-matrices replicated (parallel/sharding.py:shard_partition checks
        the layout first). A partition sharded before is gathered and split
        again."""
        clv, sc = self._dense_buffers()
        pm = self.pmatrix if self.shards is None else self.shards[0].pmatrix
        devs = mesh.local_devices
        w = self.sites_padded // len(devs)
        self.shards = [PartitionShard(self, k * w, (k + 1) * w, dev,
                                      clv[..., k * w:(k + 1) * w],
                                      sc[..., k * w:(k + 1) * w], pm)
                       for k, dev in enumerate(devs)]
        self.mesh = mesh
        self.device = devs[0]
        self.clv = self.scale_buffer = self.pmatrix = None
        self._dense_tip_key = self._dense_tip_cache = None


def _shared(name: str) -> property:
    """A PartitionShard attribute that reads and writes its parent's."""
    return property(lambda self: getattr(self._parent, name),
                    lambda self, value: setattr(self._parent, name, value))


class PartitionShard(Partition):
    """The column block [lo, hi) of a sharded Partition, on its shard's
    device: its own dense buffers (`clv` [N+1, R, s, hi-lo], `scale_buffer`
    and a replica of `pmatrix`) and, for everything else, its parent's
    (sizes, model, tip flags and versions read and written through; the
    pattern weights, invariant states and tip masks as views of the
    block's columns). The engine and the step-by-step API run on it as on
    any partition; `_modes` adds `col0`, the block's first column, with
    which the likelihood functions return partial sums
    (ops/likelihood.py:_apply_asc) for the parent to reduce."""

    def __init__(self, parent: Partition, lo: int, hi: int, device, clv,
                 scale_buffer, pmatrix):
        self._parent = parent
        self.lo, self.hi = lo, hi
        self.device = torch.device(device)
        self.sites_padded = hi - lo
        self.clv = clv.contiguous().to(self.device)
        self.scale_buffer = scale_buffer.contiguous().to(self.device)
        self.pmatrix = pmatrix.to(self.device, copy=True)
        self.repeats = None
        self.mesh = self.shards = None
        self._dense_tip_key = self._dense_tip_cache = None

    @property
    def pattern_weights(self) -> np.ndarray:
        return self._parent.pattern_weights[self.lo:self.hi]

    @property
    def invariant(self) -> np.ndarray:
        return self._parent.invariant[self.lo:self.hi]

    @property
    def tip_states(self) -> np.ndarray:
        return self._parent.tip_states[:, self.lo:self.hi]

    def _modes(self) -> dict:
        return dict(self._parent._modes(), col0=self.lo)


for _name in ("tips", "clv_buffers", "nodes", "states", "sites",
              "rate_matrices", "prob_matrices", "rate_cats", "scale_buffers",
              "rate_scalers", "asc_bias", "asc_extra", "dtype",
              "scale_threshold", "scale_factor", "frequencies",
              "subst_params", "rates", "rate_weights", "prop_invar",
              "eigenvals", "eigenvecs", "inv_eigenvecs",
              "eigen_decomp_valid", "_model_version", "_tips_set",
              "_tips_clv_set", "_tip_version", "_invariant_valid"):
    setattr(PartitionShard, _name, _shared(_name))
del _name
