"""One tree level of independent pruning ops per launch, written in place.

Port of libpll2_tpu/ops/pallas_partials.py: the per-level TPU kernel
`_kernel` and its in-place variant `_inplace_kernel` are one CUDA kernel
here, csrc/level_update.cu, which always writes the parent rows straight
into the dense CLV buffer (there is no PLL_PALLAS_INPLACE switch).

The host compiles an operation list into per-level index tables
(`pack_pallas_levels`, [9, W] int32 each). Rows:

    0 parent clv, 1 child1 clv, 2 child2 clv, 3 matrix1, 4 matrix2,
    5 scaler1 read, 6 scaler2 read, 7 parent scaler write, 8 has_scaler

A SCALE_BUFFER_NONE read maps to the guaranteed-zero scaler row K+1, a NONE
write to the trash row K. For each op of a level and each site:

    x[r, i] = (sum_j P[m1, r, i, j] left[r, j])
            * (sum_j P[m2, r, i, j] right[r, j])

and when has_scaler is set and x < threshold for every rate and state, the
site is multiplied by `factor`; the parent's count is sc1 + sc2 + that
rescale (0 or 1). Per-rate mode (a scaler buffer [K+2, R, S], the
partition's `rate_scalers`) compares each rate's block with the threshold
on its own and keeps one count per rate. libpll2_tpu's level kernel has no
per-rate mode (its per-rate step-by-step API runs XLA); the port's kernel
has one, because its step-by-step API always launches it.

`level_update` is the dispatching wrapper: CPU tensors run
`level_update_reference`, the plain PyTorch version; CUDA tensors launch the
kernel (float32) or raise. `level_update.launches` counts the launches.
`update_partials_kernel` runs all levels of a traversal. The kernel is
float32, and JAX runs a float64 partition on XLA: callers take the plain
version for float64 buffers by `level_for` (a float64 CUDA tensor passed to
the wrapper raises).

The trial form (libpll2_tpu/optimize.py:366 vmaps the TPU kernel over model
trials) runs one level of K trials in one launch: a leading trial axis on
the CLV rows [K, rows, R*s, S], the scaler rows [K, K+2, (R,) S] and P [K,
E, R, s, s], and the shared rows `tips` [base, R*s, S]. Row index i reads
`tips[i]` below base and the trial's own row `i - base` from base up; every
parent is at or above base. `trial_rows` says which rows a trial buffer
must start from.

In place is safe because no op of a level reads or writes a row that
another op of the same level writes: `schedule_levels` checks this for any
op list and falls back to one op per level where it does not hold.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

__all__ = ["TABLE_ROWS", "schedule_levels", "pack_pallas_levels",
           "tables_to_device", "trial_rows", "level_update_reference",
           "level_update", "level_for", "update_partials_kernel"]

TABLE_ROWS = 9


def _levels_equal_serial(operations, n_tips: int) -> bool:
    """True when running compile_levels' levels in order, each level's ops
    at once and in place, gives the serial list's result: every op runs at
    a higher level than each earlier op that writes a row it reads (clv or
    scaler), that writes a row it writes, or that reads a row it writes.
    Writes to the trash scaler row (ops without a scaler) are never read
    and are not tracked."""
    level_of = {}
    last_write, last_read = {}, {}
    for op in operations:
        def lvl(idx):
            return -1 if idx < n_tips else level_of.get(idx, -1)
        level = 1 + max(lvl(op.child1_clv_index), lvl(op.child2_clv_index))
        level_of[op.parent_clv_index] = level
        reads = [("clv", op.child1_clv_index), ("clv", op.child2_clv_index)]
        reads += [("sc", s) for s in (op.child1_scaler_index,
                                      op.child2_scaler_index) if s >= 0]
        writes = [("clv", op.parent_clv_index)]
        if op.parent_scaler_index >= 0:
            writes.append(("sc", op.parent_scaler_index))
        if any(last_write.get(k, -1) >= level for k in reads):
            return False
        for k in reads:
            last_read[k] = max(last_read.get(k, -1), level)
        if any(max(last_write.get(k, -1), last_read.get(k, -1)) >= level
               for k in writes):
            return False
        for k in writes:
            last_write[k] = level
    return True


def schedule_levels(operations, n_tips: int) -> List[list]:
    """The ops grouped into levels that may each run at once, in place:
    `compile_levels`' levels when they equal the serial list
    (`_levels_equal_serial`), otherwise one op per level in list order
    (e.g. an op that writes a row an earlier op of its level reads, or two
    ops that write the same parent)."""
    from ..trees.utree import compile_levels
    if _levels_equal_serial(operations, n_tips):
        return compile_levels(operations, n_tips)
    return [[op] for op in operations]


def pack_pallas_levels(operations, n_tips: int, zero_scaler_row: int,
                       trash_scaler_row: int) -> tuple:
    """Per-level [9, W] int32 index tables (numpy) of `schedule_levels`'
    levels (rows in the module docstring). Level widths are exact: the
    kernel needs no padding to a power of two."""
    tables = []
    for lv in schedule_levels(operations, n_tips):
        t = np.zeros((TABLE_ROWS, len(lv)), dtype=np.int32)
        for k, op in enumerate(lv):
            t[:, k] = [
                op.parent_clv_index,
                op.child1_clv_index,
                op.child2_clv_index,
                op.child1_matrix_index,
                op.child2_matrix_index,
                op.child1_scaler_index if op.child1_scaler_index >= 0
                else zero_scaler_row,
                op.child2_scaler_index if op.child2_scaler_index >= 0
                else zero_scaler_row,
                op.parent_scaler_index if op.parent_scaler_index >= 0
                else trash_scaler_row,
                1 if op.parent_scaler_index >= 0 else 0,
            ]
        tables.append(t)
    return tuple(tables)


def tables_to_device(tables: Sequence[np.ndarray], device) -> tuple:
    """The level tables in one int32 tensor [9, total ops] on `device`
    (one host-to-device copy), returned as one column-slice view per level.
    The kernel takes a view's row stride as its leading dimension."""
    if not tables:
        return ()
    flat = torch.as_tensor(np.concatenate(tables, axis=1), device=device)
    out, off = [], 0
    for t in tables:
        out.append(flat[:, off:off + t.shape[1]])
        off += t.shape[1]
    return tuple(out)


def trial_rows(tables, n_tips: int, root_rows=(), root_scalers=()):
    """What the trial form's buffers need from a partition's for the levels
    `tables` (numpy [9, W] each, level order): (base, CLV rows, scaler
    rows). Rows below `base` (the tips, or below the lowest parent) are
    shared; of the rows from `base` up, and of the scaler rows, those that
    an op or the epilogue (`root_rows`, `root_scalers`: the root edge's,
    mapped rows as the tables hold them) reads before any op writes them
    must be copied into every trial's buffer. A full postorder needs no CLV
    row and only the zero scaler row."""
    parents = [int(p) for t in tables for p in np.asarray(t)[0]]
    base = min([n_tips] + parents)
    clv_w, sc_w, clv_need, sc_need = set(), set(), set(), set()
    for t in tables:
        t = np.asarray(t)
        clv_need.update(c for c in t[1:3].ravel().tolist()
                        if c >= base and c not in clv_w)
        sc_need.update(c for c in t[5:7].ravel().tolist() if c not in sc_w)
        clv_w.update(t[0].tolist())
        sc_w.update(t[7].tolist())
    clv_need.update(c for c in root_rows if c >= base and c not in clv_w)
    sc_need.update(c for c in root_scalers if c not in sc_w)
    return (base, np.asarray(sorted(clv_need), dtype=np.int64),
            np.asarray(sorted(sc_need), dtype=np.int64))


def _trial_children(clv2d, tips, idx):
    """Rows `idx` [W] of every trial, [K, W, R*s, S]: a shared row below
    the base, the trial's own from it up."""
    base = 0 if tips is None else tips.shape[0]
    own = clv2d[:, (idx - base).clamp(min=0)]
    if base == 0:
        return own
    shared = tips[idx.clamp(max=base - 1)].to(clv2d.dtype)
    return torch.where((idx < base)[None, :, None, None], shared[None], own)


def _trials_reference(clv2d, scaler, pmatrix, t, rates, states,
                      threshold, factor, tips) -> None:
    """`level_update_reference`'s trial form (see the module docstring),
    batched over the trials."""
    parent, c1, c2, m1, m2, s1, s2, psc, has = t
    base = 0 if tips is None else tips.shape[0]
    if len(parent) and int(parent.min()) < base:
        raise ValueError("level_update: the trial form writes no shared row "
                         f"(a parent below the {base} shared rows)")
    k, w, sites = clv2d.shape[0], t.shape[1], clv2d.shape[-1]
    shape = (k, w, rates, states, sites)
    x = (torch.einsum('kwrij,kwrjs->kwris', pmatrix[:, m1].to(clv2d.dtype),
                      _trial_children(clv2d, tips, c1).view(shape))
         * torch.einsum('kwrij,kwrjs->kwris', pmatrix[:, m2].to(clv2d.dtype),
                        _trial_children(clv2d, tips, c2).view(shape)))
    if scaler.dim() == 4:
        scale = ((torch.amax(x, dim=3) < threshold)
                 & (has[None, :, None, None] > 0))
        x = torch.where(scale[:, :, :, None, :], x * factor, x)
    else:
        scale = ((torch.amax(x, dim=(2, 3)) < threshold)
                 & (has[None, :, None] > 0))
        x = torch.where(scale[:, :, None, None, :], x * factor, x)
    counts = scaler[:, s1] + scaler[:, s2] + scale.to(scaler.dtype)
    clv2d[:, parent - base] = x.reshape(k, w, rates * states, sites)
    scaler[:, psc] = counts


def level_update_reference(clv2d: torch.Tensor,     # [N+1, R*s, S]
                           scaler: torch.Tensor,    # [K+2, (R,) S] int32
                           pmatrix: torch.Tensor,   # [E, R, s, s]
                           table,                   # [9, W] int
                           rates: int, states: int,
                           threshold: float, factor: float,
                           tips=None) -> None:
    """Plain PyTorch version of one level, in the dtype of `clv2d`: gathers
    the W ops' children, computes the parents and writes them, and their
    scaler rows, into `clv2d` and `scaler` in place. A scaler buffer with a
    rate axis selects the per-rate mode. With a leading trial axis on
    `clv2d` ([K, rows, R*s, S]), `scaler` and `pmatrix`, the trial form
    (module docstring), `tips` the shared rows."""
    t = torch.as_tensor(table, device=clv2d.device).long()
    if clv2d.dim() == 4:
        _trials_reference(clv2d, scaler, pmatrix, t, rates, states,
                          threshold, factor, tips)
        return
    parent, c1, c2, m1, m2, s1, s2, psc, has = t
    w, sites = t.shape[1], clv2d.shape[-1]
    shape = (w, rates, states, sites)
    x = (torch.einsum('wrij,wrjs->wris', pmatrix[m1].to(clv2d.dtype),
                      clv2d[c1].view(shape))
         * torch.einsum('wrij,wrjs->wris', pmatrix[m2].to(clv2d.dtype),
                        clv2d[c2].view(shape)))
    if scaler.dim() == 3:
        scale = (torch.amax(x, dim=2) < threshold) & (has[:, None, None] > 0)
        x = torch.where(scale[:, :, None, :], x * factor, x)
    else:
        scale = (torch.amax(x, dim=(1, 2)) < threshold) & (has[:, None] > 0)
        x = torch.where(scale[:, None, None, :], x * factor, x)
    counts = scaler[s1] + scaler[s2] + scale.to(scaler.dtype)
    clv2d[parent] = x.reshape(w, rates * states, sites)
    scaler[psc] = counts


def level_update(clv2d: torch.Tensor, scaler: torch.Tensor,
                 pmatrix: torch.Tensor, table, rates: int, states: int,
                 threshold: float, factor: float, tips=None) -> None:
    """One level of independent ops, parent rows and scaler rows written in
    place; `scaler` [K+2, S], or [K+2, R, S] for the per-rate mode; with a
    leading trial axis the trial form, all K trials in one launch, `tips`
    the shared rows. CUDA tensors launch csrc/level_update.cu (float32) on
    the current stream without synchronising, or raise; CPU tensors run
    `level_update_reference`. The table's indices are trusted: callers
    build it with `pack_pallas_levels` from ops whose indices they have
    checked against the buffers (Partition and TreeEngine do)."""
    if clv2d.device.type == "cpu" and pmatrix.device.type == "cpu":
        level_update_reference(clv2d, scaler, pmatrix, table, rates, states,
                               threshold, factor, tips=tips)
        return
    from . import _kernels
    _kernels.launch_level_update(clv2d, scaler, pmatrix, table, rates,
                                 states, threshold, factor, tips=tips)
    level_update.launches += 1


level_update.launches = 0


def level_for(clv: torch.Tensor):
    """The level function for buffers like `clv`: the wrapper
    `level_update` (the kernel for float32 CUDA tensors), or the plain
    version for float64 ones, which the kernel does not take (JAX runs
    them on XLA)."""
    return (level_update_reference if clv.dtype == torch.float64
            else level_update)


def update_partials_kernel(clv: torch.Tensor,      # [N+1, R, s, S]
                           scaler: torch.Tensor,   # [K+2, (R,) S] int32
                           pmatrix: torch.Tensor,  # [E, R, s, s]
                           tables: Sequence,       # [9, W_l] per level
                           threshold: float, factor: float,
                           level=None, tips=None):
    """Run all levels in order through `level` (by default `level_for`:
    the dispatching wrapper, or the plain version for float64 buffers; or
    the plain version for a comparison on the card); returns (clv,
    scaler), updated in place. The trial form: `clv` [K, rows, R, s, S],
    `scaler` and `pmatrix` with the same leading K, `tips` [base, R, s, S]
    the shared rows (or None), each level one call of `level` for all K."""
    level = level or level_for(clv)
    if clv.dim() == 5:
        k, n, rates, states, sites = clv.shape
        kw = {"tips": None if tips is None
              else tips.reshape(tips.shape[0], rates * states, sites)}
        clv2d = clv.view(k, n, rates * states, sites)
    else:
        n, rates, states, sites = clv.shape
        kw = {}
        clv2d = clv.view(n, rates * states, sites)
    for table in tables:
        level(clv2d, scaler, pmatrix, table, rates, states, threshold,
              factor, **kw)
    return clv, scaler
