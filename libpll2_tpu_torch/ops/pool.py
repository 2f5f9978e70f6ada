"""Site repeats' pooled class columns: one launch a traversal at 4 states x
4 rates, one a dependency level for other sizes.

Port of libpll2_tpu/ops/pallas_repeats.py, as ops/levels.py is of
pallas_partials.py: the TPU kernel `_run_kernel` becomes csrc/pool_update.cu.

The TPU kernel runs one call per (width bucket, identity profile) run of ops
and relies on the TPU's grid steps running in order, because a bucket may
hold a parent and its own child (buckets group by width, not dependency). A
CUDA grid runs its blocks in no order. The port groups the ops into
dependency levels (ops/levels.py:schedule_levels, whose hazard check holds
unchanged: every node and every scaler index owns its own pooled region).
The runtime-size kernel runs one level a launch. The 4x4 kernel (4 states x
4 rates) runs the whole plan in one launch: blocks claim tiles in level
order from an atomic ticket, and a tile waits on device counters until the
ops in its op's wait list (`wait_lists`) have finished, which stands in for
the TPU's in-order grid. The block-band tables, the 128-lane gather loop,
the float scaler rows and the identity-profile split of the TPU kernel are
not ported: a CUDA lane reads its child column gl[c] directly, and an
identity map is just gl[c] = c.

The host packs an op list into per-level int64 tables [11, W]
(`pack_pool_levels`), one column per op. Rows:

    0 p_off, 1 psc_off, 2 c1_off, 3 m1, 4 s1_off, 5 c2_off, 6 m2, 7 s2_off,
    8 W (the op's width), 9 g_off (its gather maps in gl/gr), 10 has_scaler

plus two int32 arrays, `gl` and `gr`, holding every op's W child class
indices one after another, and per level a tile map (`tile_map`): one
int32 pair (op, first column) per POOL_GRANULE class columns of each op,
over which the runtime-size kernel lays its flat grid. For the 4x4 kernel
`traversal_arrays` lays every op's tiles out as tickets in level order,
with each op's wait list. For each op and parent class column c < W:

    x[r, i] = (sum_j P[m1, r, i, j] pool[r, j, c1_off + gl[g_off + c]])
            * (sum_j P[m2, r, i, j] pool[r, j, c2_off + gr[g_off + c]])

When has_scaler is set and x < threshold for every rate and state, the
column is multiplied by `factor`; sc[psc_off + c] = sc[s1_off + gl[..]] +
sc[s2_off + gr[..]] + that rescale. Without a scaler buffer, psc_off is the
trash region and nothing is rescaled, as on the dense paths and in the
reference. (The JAX package's two pool paths rescale every op and send the
count of a scaler-less one to the trash region, which drops it; both agree
with this wherever every op has a scaler buffer, as `create_operations`
gives.) Padding classes (c at or past the parent's class count, below W)
gather class 0, as in the JAX package.

Per-rate mode (`sc` [R, T2], the partition's `rate_scalers`): each rate's
block is compared with the threshold on its own and every scaler region
holds one count row per rate. libpll2_tpu refuses per-rate scalers in its
pool kernel and runs XLA; the port's kernels have the mode.

`pool_update` is the dispatching wrapper of one level: CPU tensors run
`pool_update_reference`, the plain PyTorch version; CUDA tensors launch the
kernel (float32: the runtime-size variant with the level's
ops/_kernels.py:pool_plan, or the 4x4 kernel over that level alone) or
raise. `pool_update.launches` counts the kernel launches.
`update_partials_pool` runs a whole plan: by default through the plan's
kernels (the 4x4 kernel in one launch when the plan has a traversal and the
pool lies on a CUDA device in float32, else `pool_for` a level at a time:
the wrapper, or the plain version for a float64 pool, which the kernel does
not take), or level by level through a given `level` (the wrapper itself,
or the plain version for `TreeEngine(pallas=False)` ('pool') and float64
references).

The trial form (libpll2_tpu/optimize.py:366 would vmap the TPU kernel over
model trials) runs K trials of one plan at once: a leading trial axis on
the pool [K, R*s, T], the scaler pool [K, (R,) T2] and P [K, E, R, s, s],
each trial's pools a copy of the partition's made once a chunk (the engine
makes it with one broadcast copy). At 4x4 that is one launch of the
traversal kernel for all K (its counters sized for K trials:
ops/_kernels.py:trial_traversal), else one launch a level; the plain
version batches over the trials.
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..repeats import classify_operations, op_fields
from ._kernels import (POOL_COUNTER_STRIDE, POOL_FIXED_TILE, POOL_GRANULE,
                       WIDE_STATES_MIN, PoolFixedLevel, PoolLaunch,
                       PoolTraversal, device_sm_count,
                       device_states64_resident, pool_fixed_plan, pool_plan)
from .levels import schedule_levels
from .partials import host_rows

__all__ = ["POOL_ROWS", "PoolPlan", "schedule_pool_levels", "tile_map",
           "pack_pool_levels", "wait_lists", "traversal_arrays",
           "level_launches", "plan_to_device", "pool_update_reference",
           "pool_update", "pool_for", "update_partials_pool", "pool_work"]

POOL_ROWS = 11


class PoolPlan(NamedTuple):
    """A packed traversal on its device: one [11, n_l] int64 column-slice
    view per level, the gather maps, one [granules, 2] int32 tile map view
    per level, each level's launch on a CUDA device (the runtime-size
    kernel's PoolLaunch, or the 4x4 kernel's PoolFixedLevel; None on the
    host), and on a CUDA device at 4x4 the whole traversal's
    PoolTraversal (else None)."""
    tables: Tuple[torch.Tensor, ...]
    gl: torch.Tensor          # [sum of W] int32
    gr: torch.Tensor
    tiles: Tuple[torch.Tensor, ...]
    launches: Tuple[Optional[object], ...]
    traversal: Optional[PoolTraversal]


def schedule_pool_levels(table, operations, n_tips: int, sites: int,
                         scale_buffers: int, update_repeats: bool = True,
                         previous=None):
    """Class the op list (repeats.classify_operations; the table is
    updated unless `update_repeats` is False; `previous` is the layout the
    pool holds now) and group it into dependency levels
    (ops/levels.py:schedule_levels). Returns (layout, levels) with
    levels = [[(W, op, gl, gr), ...], ...]."""
    # copies: schedule_levels hands back the op objects, and a list may
    # hold one object twice
    ops = [copy.copy(op) for op in operations]
    layout, per_op = classify_operations(table, ops, sites, scale_buffers,
                                         update_repeats=update_repeats,
                                         previous=previous)
    entry = {id(op): e for op, e in zip(ops, per_op)}
    levels = [[entry[id(op)] for op in lv]
              for lv in schedule_levels(ops, n_tips)]
    return layout, levels


def tile_map(widths) -> np.ndarray:
    """The flat tile map of one level whose ops are `widths` class columns
    wide: [sum of ceil(W / POOL_GRANULE), 2] int32, row g = (op, its first
    column in granule g), the ops' granules one op after another. The
    runtime-size kernel cuts each granule into tiles of 32-128 columns, so
    its grid covers every op's W columns once and nothing past them but
    the last granule's rounding."""
    counts = [-(-int(w) // POOL_GRANULE) for w in widths]
    if not counts:
        return np.zeros((0, 2), np.int32)
    ops = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    starts = np.cumsum([0] + counts[:-1], dtype=np.int64)
    first = (np.arange(len(ops)) - np.repeat(starts, counts)) * POOL_GRANULE
    return np.stack([ops, first.astype(np.int32)], axis=1)


def pack_pool_levels(layout, levels) -> tuple:
    """(tables, gl, gr, tiles) in numpy: per-level [11, n_l] int64 tables
    (rows in the module docstring), the concatenated int32 gather maps
    (each op's W entries, zero-padded past its class count), and each
    level's `tile_map`. Raises PllError for an op that writes its own
    child's CLV or scaler: the kernel's lanes read and write other columns
    of one region, so such an op cannot run in place."""
    tables, gls, grs, tiles = [], [], [], []
    g_off = 0
    for lv in levels:
        t = np.zeros((POOL_ROWS, len(lv)), dtype=np.int64)
        for k, (w, op, gl, gr) in enumerate(lv):
            if (op.parent_clv_index in (op.child1_clv_index,
                                        op.child2_clv_index)
                    or (op.parent_scaler_index >= 0
                        and op.parent_scaler_index in (
                            op.child1_scaler_index,
                            op.child2_scaler_index))):
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    f"operation with parent {op.parent_clv_index} writes "
                    f"its own child's CLV or scaler, which a site-repeats "
                    f"partition cannot do in place")
            t[:8, k] = op_fields(layout, op)
            t[8:, k] = (w, g_off, 1 if op.parent_scaler_index >= 0 else 0)
            for g, out in ((gl, gls), (gr, grs)):
                padded = np.zeros(w, dtype=np.int32)
                padded[:g.size] = g
                out.append(padded)
            g_off += w
        tables.append(t)
        tiles.append(tile_map(t[8]))
    cat = (lambda a: np.concatenate(a) if a else np.zeros(0, np.int32))
    return tuple(tables), cat(gls), cat(grs), tuple(tiles)


def wait_lists(tables) -> Tuple[np.ndarray, np.ndarray]:
    """Each op's wait list, the ops of `tables` (per-level [11, n_l]
    tables) numbered in level order: CSR int32 (offsets [ops + 1], entries)
    holding, for op k, the earlier ops that must finish before it reads or
    writes: the last writer of each region it reads (read after write), the
    last writer of each region it writes (write after write) and every op
    that read one of those since (write after read). Regions are the
    tables' offsets (a node's class columns, a scaler index's counts); the
    trash region that scaler-less ops write (has_scaler 0) is no region,
    and the zero region is never written. Every entry of op k is below k,
    and running each op once its list is done gives the levels' result,
    which `schedule_levels` made the serial list's."""
    last_write, readers = {}, {}
    offsets, entries = [0], []
    k = 0
    for t in tables:
        for p, psc, c1, _, s1, c2, _, s2, _, _, has in np.asarray(
                t, dtype=np.int64).T.tolist():
            reads = {("clv", c1), ("clv", c2), ("sc", s1), ("sc", s2)}
            writes = {("clv", p)} | ({("sc", psc)} if has else set())
            deps = {last_write[r] for r in reads | writes if r in last_write}
            for r in writes:
                deps.update(readers.get(r, ()))
            for r in reads:
                readers.setdefault(r, []).append(k)
            for r in writes:
                last_write[r], readers[r] = k, []
            entries += sorted(deps)
            offsets.append(len(entries))
            k += 1
    return (np.asarray(offsets, dtype=np.int32),
            np.asarray(entries, dtype=np.int32))


def traversal_arrays(tables) -> tuple:
    """The 4x4 kernel's host arrays for the ops of `tables` in level order
    (op k is column k of the tables joined): tickets [tiles, 4] int32, one
    row (op, first column, wait-list begin, end) per POOL_FIXED_TILE class
    columns of each op, op after op; the wait lists [entries, 2] int32 (op, its
    tile count; `wait_lists`); each op's tile count [ops] int32; and each
    level's (first ticket, end ticket, first op, end op)."""
    widths = np.concatenate([np.asarray(t[8], dtype=np.int64)
                             for t in tables])
    op_tiles = -(-widths // POOL_FIXED_TILE)
    offsets, entries = wait_lists(tables)
    ops = np.repeat(np.arange(widths.size), op_tiles)
    first = np.arange(ops.size) - np.repeat(np.cumsum(op_tiles) - op_tiles,
                                            op_tiles)
    tickets = np.stack([ops, first * POOL_FIXED_TILE, offsets[ops],
                        offsets[ops + 1]], axis=1).astype(np.int32)
    waits = np.stack([entries, op_tiles[entries]], axis=1).astype(np.int32)
    op_ends = np.cumsum([t.shape[1] for t in tables])
    tile_ends = np.cumsum(op_tiles)
    bounds, k0 = [], 0
    for k1 in op_ends.tolist():
        t0 = int(tile_ends[k0 - 1]) if k0 else 0
        bounds.append((t0, int(tile_ends[k1 - 1]), k0, k1))
        k0 = k1
    return tickets, waits.reshape(-1, 2), op_tiles.astype(np.int32), \
        tuple(bounds)


def _views(parts, axis, device):
    """`parts` joined along `axis` into one tensor on `device` (one
    host-to-device copy): (that tensor, one slice view per part)."""
    if not parts:
        return None, ()
    flat = torch.as_tensor(np.concatenate(parts, axis=axis), device=device)
    bounds = np.cumsum([0] + [p.shape[axis] for p in parts])
    return flat, tuple(flat.narrow(axis, int(a), int(b - a))
                       for a, b in zip(bounds[:-1], bounds[1:]))


def level_launches(tiles, rates: int, states: int, sms: int,
                   resident: int = 0) -> tuple:
    """Each level's ops/_kernels.py:pool_plan, from its tile map, on a
    device of `sms` SMs (from 33 states on with `resident` clusters of the
    64-state body, 0 for pool_plan's count from `sms`); None at every
    level for the 4x4 size, which runs the traversal kernel."""
    if (rates, states) == (4, 4):
        return (None,) * len(tiles)
    return tuple(pool_plan(t.shape[0] * POOL_GRANULE, rates, states, sms,
                           resident=resident)
                 for t in tiles)


def _traversal(tables, table, sms: int, device):
    """The 4x4 kernel's PoolTraversal of a plan whose levels' `tables` lie
    joined in `table` [11, ops] on `device`, and each level's
    PoolFixedLevel: `pool_fixed_plan` over every op's width and
    `traversal_arrays`, copied to `device` in one int32 tensor beside the
    counters."""
    widths = np.concatenate([t[8] for t in tables])
    plan = pool_fixed_plan(widths, sms)
    tickets, waits, _, bounds = traversal_arrays(tables)
    flat = torch.as_tensor(np.concatenate(
        [tickets.ravel(), waits.ravel(),
         np.zeros((1 + widths.size) * POOL_COUNTER_STRIDE, np.int32)]),
        device=device)
    sizes = np.cumsum([0, tickets.size, waits.size])
    trav = PoolTraversal(
        plan, table, flat[:sizes[1]].view(-1, 4),
        flat[sizes[1]:sizes[2]].view(-1, 2), flat[sizes[2]:])
    return trav, tuple(PoolFixedLevel(trav, k0, k1, t0, t1)
                       for t0, t1, k0, k1 in bounds)


def plan_to_device(tables, gl, gr, tiles, device, rates: int,
                   states: int) -> PoolPlan:
    """The packed levels on `device`: the tables as column-slice views of
    one int64 tensor [11, total ops], the tile maps as row-slice views of
    one int32 tensor [granules, 2], and the gather maps. On a CUDA device
    each level gets its launch at `rates` and `states` (`level_launches`),
    so that a launch computes no layout; at 4x4 the plan also gets its
    traversal (the tickets, the wait lists built here once and the
    counters, one more copy), and each level its PoolFixedLevel."""
    device = torch.device(device)
    table, level_tables = _views(tables, 1, device)
    launches, trav = (None,) * len(tiles), None
    if device.type == "cuda":
        sms = device_sm_count(device)
        resident = (device_states64_resident(device, "pool", rates)
                    if states >= WIDE_STATES_MIN and tiles else 0)
        launches = level_launches(tiles, rates, states, sms, resident)
        if (rates, states) == (4, 4) and tables:
            trav, launches = _traversal(tables, table, sms, device)
    return PoolPlan(level_tables, torch.as_tensor(gl, device=device),
                    torch.as_tensor(gr, device=device),
                    _views(tiles, 0, device)[1], launches, trav)


def pool_update_reference(pool2d: torch.Tensor,    # [R*s, T]
                          sc: torch.Tensor,        # [T2] or [R, T2] int32
                          pmatrix: torch.Tensor,   # [E, R, s, s]
                          table,                   # [11, W] int
                          gl: torch.Tensor, gr: torch.Tensor,
                          rates: int, states: int,
                          threshold: float, factor: float,
                          tiles=None, launch=None) -> None:
    """Plain PyTorch version of one level, in the dtype of `pool2d`: each
    op's parent class columns and counts are computed and written into
    `pool2d` and `sc` in place, one op after another (the ops of a level
    are independent). `tiles` and `launch` are not read: each op has its
    own W. A scaler pool with a rate axis selects the per-rate mode."""
    rows = host_rows(table)
    dev = pool2d.device
    if pool2d.dim() == 3:
        _trials_reference(pool2d, sc, pmatrix, rows, gl, gr, rates, states,
                          threshold, factor)
        return
    for (p_off, psc_off, c1_off, m1, s1_off, c2_off, m2, s2_off, w, g_off,
         has) in zip(*rows):
        l_idx = gl[g_off:g_off + w].to(dev).long()
        r_idx = gr[g_off:g_off + w].to(dev).long()
        left = pool2d[:, c1_off + l_idx].view(rates, states, w)
        right = pool2d[:, c2_off + r_idx].view(rates, states, w)
        x = (torch.einsum('rij,rjc->ric', pmatrix[m1].to(pool2d.dtype), left)
             * torch.einsum('rij,rjc->ric', pmatrix[m2].to(pool2d.dtype),
                            right))
        if sc.dim() == 2:
            scale = (torch.amax(x, dim=1) < threshold) & bool(has)  # [R, w]
            x = torch.where(scale[:, None, :], x * factor, x)
        else:
            scale = (torch.amax(x, dim=(0, 1)) < threshold) & bool(has)
            x = torch.where(scale[None, None, :], x * factor, x)
        counts = (sc[..., s1_off + l_idx] + sc[..., s2_off + r_idx]
                  + scale.to(sc.dtype))
        pool2d[:, p_off:p_off + w] = x.reshape(rates * states, w)
        sc[..., psc_off:psc_off + w] = counts


def _trials_reference(pool2d, sc, pmatrix, rows, gl, gr, rates, states,
                      threshold, factor) -> None:
    """`pool_update_reference`'s trial form (module docstring), each op
    batched over the trials: `pool2d` [K, R*s, T], `sc` [K, (R,) T2],
    `pmatrix` [K, E, R, s, s]."""
    k, dev = pool2d.shape[0], pool2d.device
    for (p_off, psc_off, c1_off, m1, s1_off, c2_off, m2, s2_off, w, g_off,
         has) in zip(*rows):
        l_idx = gl[g_off:g_off + w].to(dev).long()
        r_idx = gr[g_off:g_off + w].to(dev).long()
        left = pool2d[:, :, c1_off + l_idx].view(k, rates, states, w)
        right = pool2d[:, :, c2_off + r_idx].view(k, rates, states, w)
        x = (torch.einsum('krij,krjc->kric', pmatrix[:, m1].to(pool2d.dtype),
                          left)
             * torch.einsum('krij,krjc->kric',
                            pmatrix[:, m2].to(pool2d.dtype), right))
        if sc.dim() == 3:
            scale = (torch.amax(x, dim=2) < threshold) & bool(has)  # [K,R,w]
            x = torch.where(scale[:, :, None, :], x * factor, x)
        else:
            scale = (torch.amax(x, dim=(1, 2)) < threshold) & bool(has)
            x = torch.where(scale[:, None, None, :], x * factor, x)
        counts = (sc[..., s1_off + l_idx] + sc[..., s2_off + r_idx]
                  + scale.to(sc.dtype))
        pool2d[:, :, p_off:p_off + w] = x.reshape(k, rates * states, w)
        sc[..., psc_off:psc_off + w] = counts


def pool_update(pool2d: torch.Tensor, sc: torch.Tensor,
                pmatrix: torch.Tensor, table, gl: torch.Tensor,
                gr: torch.Tensor, rates: int, states: int,
                threshold: float, factor: float, tiles=None,
                launch=None) -> None:
    """One level of independent ops over the pooled class columns, parent
    columns and counts written in place; `sc` [T2], or [R, T2] for the
    per-rate mode; with a leading trial axis on `pool2d`, `sc` and
    `pmatrix` the trial form, all K trials in one launch. CUDA tensors
    launch csrc/pool_update.cu (float32) on the current stream without
    synchronising, or raise; CPU tensors run `pool_update_reference`.
    `tiles` is the level's `tile_map` on the device and `launch` its
    PoolPlan.launches entry: the runtime-size variant's layout, or at 4x4
    the level of the plan's traversal, which the 4x4 kernel then runs
    alone. The table's offsets are trusted:
    callers build it with `pack_pool_levels` from ops whose indices they
    have checked (Partition and TreeEngine do)."""
    if pool2d.device.type == "cpu" and pmatrix.device.type == "cpu":
        pool_update_reference(pool2d, sc, pmatrix, table, gl, gr, rates,
                              states, threshold, factor)
        return
    from . import _kernels
    _kernels.launch_pool_update(pool2d, sc, pmatrix, table, gl, gr, rates,
                                states, threshold, factor, tiles, launch)
    pool_update.launches += 1


pool_update.launches = 0


def pool_for(pool: torch.Tensor):
    """The level function for pools like `pool`: the wrapper `pool_update`
    (the kernel for float32 CUDA tensors), or the plain version for
    float64 ones, which the kernel does not take (JAX runs them on XLA)."""
    return (pool_update_reference if pool.dtype == torch.float64
            else pool_update)


def update_partials_pool(clv_flat: torch.Tensor,   # [R, s, T]
                         sc_flat: torch.Tensor,    # [(R,) T2] int32
                         pmatrix: torch.Tensor,    # [E, R, s, s]
                         plan: PoolPlan,
                         threshold: float, factor: float, level=None):
    """Run the whole of `plan`. With no `level`: one launch of the 4x4
    kernel over the plan's traversal when the plan has one (plan_to_device
    on a CUDA device at 4x4) and the pool lies on that device in float32,
    else each level through `pool_for` (the wrapper `pool_update`, or the
    plain version for a float64 pool). A given `level` (the wrapper,
    one launch a level, or its plain version for a comparison on the card)
    runs each level. The trial form: `clv_flat` [K, R, s, T], `sc_flat` and
    `pmatrix` with the same leading K, all K trials in each launch (or
    call of `level`). Returns (clv_flat, sc_flat), updated in place."""
    *lead, rates, states, total = clv_flat.shape
    pool2d = clv_flat.view(*lead, rates * states, total)
    if (level is None and plan.traversal is not None
            and pool2d.device.type == "cuda"
            and pool2d.dtype == torch.float32):
        from . import _kernels
        _kernels.launch_pool_traversal(pool2d, sc_flat, pmatrix, plan.gl,
                                       plan.gr, threshold, factor,
                                       plan.traversal)
        pool_update.launches += 1
        return clv_flat, sc_flat
    level = level or pool_for(pool2d)
    for table, tiles, launch in zip(plan.tables, plan.tiles, plan.launches):
        level(pool2d, sc_flat, pmatrix, table, plan.gl, plan.gr, rates,
              states, threshold, factor, tiles=tiles, launch=launch)
    return clv_flat, sc_flat


def pool_work(levels) -> Tuple[int, int]:
    """(parent class columns, computed columns W) summed over the ops of
    `schedule_pool_levels`' levels: the work the class counts call for, and
    the work the bucket widths make the kernel do."""
    ops = [e for lv in levels for e in lv]
    return (sum(int(gl.size) for _, _, gl, _ in ops),
            sum(int(w) for w, _, _, _ in ops))
