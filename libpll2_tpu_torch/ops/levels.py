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
rescale (0 or 1).

`level_update` is the dispatching wrapper: CPU tensors run
`level_update_reference`, the plain PyTorch version; CUDA tensors launch the
kernel (float32) or raise. `level_update.launches` counts the launches.
`update_partials_kernel` runs all levels of a traversal.

In place is safe because no op of a level reads or writes a row that
another op of the same level writes: `schedule_levels` checks this for any
op list and falls back to one op per level where it does not hold.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

__all__ = ["TABLE_ROWS", "schedule_levels", "pack_pallas_levels",
           "tables_to_device", "level_update_reference", "level_update",
           "update_partials_kernel"]

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


def level_update_reference(clv2d: torch.Tensor,     # [N+1, R*s, S]
                           scaler: torch.Tensor,    # [K+2, S] int32
                           pmatrix: torch.Tensor,   # [E, R, s, s]
                           table,                   # [9, W] int
                           rates: int, states: int,
                           threshold: float, factor: float) -> None:
    """Plain PyTorch version of one level, in the dtype of `clv2d`: gathers
    the W ops' children, computes the parents and writes them, and their
    scaler rows, into `clv2d` and `scaler` in place."""
    t = torch.as_tensor(table, device=clv2d.device).long()
    parent, c1, c2, m1, m2, s1, s2, psc, has = t
    w, sites = t.shape[1], clv2d.shape[-1]
    shape = (w, rates, states, sites)
    x = (torch.einsum('wrij,wrjs->wris', pmatrix[m1].to(clv2d.dtype),
                      clv2d[c1].view(shape))
         * torch.einsum('wrij,wrjs->wris', pmatrix[m2].to(clv2d.dtype),
                        clv2d[c2].view(shape)))
    scale = (torch.amax(x, dim=(1, 2)) < threshold) & (has[:, None] > 0)
    x = torch.where(scale[:, None, None, :], x * factor, x)
    counts = scaler[s1] + scaler[s2] + scale.to(scaler.dtype)
    clv2d[parent] = x.reshape(w, rates * states, sites)
    scaler[psc] = counts


def level_update(clv2d: torch.Tensor, scaler: torch.Tensor,
                 pmatrix: torch.Tensor, table, rates: int, states: int,
                 threshold: float, factor: float) -> None:
    """One level of independent ops, parent rows and scaler rows written in
    place. CUDA tensors launch csrc/level_update.cu (float32) on the current
    stream without synchronising, or raise; CPU tensors run
    `level_update_reference`. The table's indices are trusted: callers
    build it with `pack_pallas_levels` from ops whose indices they have
    checked against the buffers (Partition and TreeEngine do)."""
    if clv2d.device.type == "cpu" and pmatrix.device.type == "cpu":
        level_update_reference(clv2d, scaler, pmatrix, table, rates, states,
                               threshold, factor)
        return
    from . import _kernels
    _kernels.launch_level_update(clv2d, scaler, pmatrix, table, rates,
                                 states, threshold, factor)
    level_update.launches += 1


level_update.launches = 0


def update_partials_kernel(clv: torch.Tensor,      # [N+1, R, s, S]
                           scaler: torch.Tensor,   # [K+2, S] int32
                           pmatrix: torch.Tensor,  # [E, R, s, s]
                           tables: Sequence,       # [9, W_l] per level
                           threshold: float, factor: float,
                           level=level_update):
    """Run all levels in order through `level` (the dispatching wrapper,
    or its plain version for a comparison on the card); returns (clv,
    scaler), updated in place."""
    n, rates, states, sites = clv.shape
    clv2d = clv.view(n, rates * states, sites)
    for table in tables:
        level(clv2d, scaler, pmatrix, table, rates, states, threshold,
              factor)
    return clv, scaler
