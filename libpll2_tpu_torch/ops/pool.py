"""Site repeats' pooled class columns, one dependency level per launch.

Port of libpll2_tpu/ops/pallas_repeats.py, as ops/levels.py is of
pallas_partials.py: the TPU kernel `_run_kernel` becomes csrc/pool_update.cu.

The TPU kernel runs one call per (width bucket, identity profile) run of ops
and relies on the TPU's grid steps running in order, because a bucket may
hold a parent and its own child (buckets group by width, not dependency). A
CUDA grid runs its blocks in no order, so the port schedules by dependency
levels instead (ops/levels.py:schedule_levels, whose hazard check holds
unchanged: every node and every scaler index owns its own pooled region)
and launches once per level. The block-band tables, the 128-lane gather
loop, the float scaler rows and the identity-profile split of the TPU kernel
are not ported: a CUDA thread reads its child column gl[c] directly, and an
identity map is just gl[c] = c.

The host packs an op list into per-level int64 tables [11, W]
(`pack_pool_levels`), one column per op. Rows:

    0 p_off, 1 psc_off, 2 c1_off, 3 m1, 4 s1_off, 5 c2_off, 6 m2, 7 s2_off,
    8 W (the op's width), 9 g_off (its gather maps in gl/gr), 10 has_scaler

plus two int32 arrays, `gl` and `gr`, holding every op's W child class
indices one after another. For each op and parent class column c < W:

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
pool kernel and runs XLA; the port's kernel has the mode.

`pool_update` is the dispatching wrapper: CPU tensors run
`pool_update_reference`, the plain PyTorch version; CUDA tensors launch the
kernel (float32) or raise. `pool_update.launches` counts the launches.
`update_partials_pool` runs all levels of a traversal, through the wrapper
or, for `TreeEngine(pallas=False)` ('pool') and float64 references, through
the plain version.
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import constants as C
from ..repeats import classify_operations, op_fields
from .levels import schedule_levels

__all__ = ["POOL_ROWS", "PoolPlan", "schedule_pool_levels",
           "pack_pool_levels", "plan_to_device", "pool_update_reference",
           "pool_update", "update_partials_pool", "pool_work"]

POOL_ROWS = 11


class PoolPlan(NamedTuple):
    """A packed traversal on its device: one [11, W_l] int64 column-slice
    view per level, each level's widest op, and the gather maps."""
    tables: Tuple[torch.Tensor, ...]
    widths: Tuple[int, ...]
    gl: torch.Tensor          # [sum of W] int32
    gr: torch.Tensor


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


def pack_pool_levels(layout, levels) -> tuple:
    """(tables, widths, gl, gr) in numpy: per-level [11, n_l] int64 tables
    (rows in the module docstring), each level's widest op, and the
    concatenated int32 gather maps (each op's W entries, zero-padded past
    its class count). Raises PllError for an op that writes its own child's
    CLV or scaler: the kernel's threads read and write other columns of one
    region, so such an op cannot run in place."""
    tables, widths, gls, grs = [], [], [], []
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
        widths.append(int(t[8].max()) if len(lv) else 0)
    cat = (lambda a: np.concatenate(a) if a else np.zeros(0, np.int32))
    return tuple(tables), tuple(widths), cat(gls), cat(grs)


def plan_to_device(tables, widths, gl, gr, device) -> PoolPlan:
    """The packed levels in one int64 tensor [11, total ops] and the gather
    maps on `device` (three host-to-device copies), the tables returned as
    one column-slice view per level."""
    views = []
    if tables:
        flat = torch.as_tensor(np.concatenate(tables, axis=1), device=device)
        off = 0
        for t in tables:
            views.append(flat[:, off:off + t.shape[1]])
            off += t.shape[1]
    return PoolPlan(tuple(views), tuple(widths),
                    torch.as_tensor(gl, device=device),
                    torch.as_tensor(gr, device=device))


def pool_update_reference(pool2d: torch.Tensor,    # [R*s, T]
                          sc: torch.Tensor,        # [T2] or [R, T2] int32
                          pmatrix: torch.Tensor,   # [E, R, s, s]
                          table, width: int,       # [11, W] int
                          gl: torch.Tensor, gr: torch.Tensor,
                          rates: int, states: int,
                          threshold: float, factor: float) -> None:
    """Plain PyTorch version of one level, in the dtype of `pool2d`: each
    op's parent class columns and counts are computed and written into
    `pool2d` and `sc` in place, one op after another (the ops of a level
    are independent). `width` is not read: each op has its own W. A
    scaler pool with a rate axis selects the per-rate mode."""
    rows = torch.as_tensor(table).cpu().tolist()
    dev = pool2d.device
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


def pool_update(pool2d: torch.Tensor, sc: torch.Tensor,
                pmatrix: torch.Tensor, table, width: int,
                gl: torch.Tensor, gr: torch.Tensor, rates: int, states: int,
                threshold: float, factor: float) -> None:
    """One level of independent ops over the pooled class columns, parent
    columns and counts written in place; `sc` [T2], or [R, T2] for the
    per-rate mode. CUDA tensors launch
    csrc/pool_update.cu (float32) on the current stream without
    synchronising, or raise; CPU tensors run `pool_update_reference`.
    `width` is the level's widest op (the launch grid). The table's offsets
    are trusted: callers build it with `pack_pool_levels` from ops whose
    indices they have checked (Partition and TreeEngine do)."""
    if pool2d.device.type == "cpu" and pmatrix.device.type == "cpu":
        pool_update_reference(pool2d, sc, pmatrix, table, width, gl, gr,
                              rates, states, threshold, factor)
        return
    from . import _kernels
    _kernels.launch_pool_update(pool2d, sc, pmatrix, table, width, gl, gr,
                                rates, states, threshold, factor)
    pool_update.launches += 1


pool_update.launches = 0


def update_partials_pool(clv_flat: torch.Tensor,   # [R, s, T]
                         sc_flat: torch.Tensor,    # [(R,) T2] int32
                         pmatrix: torch.Tensor,    # [E, R, s, s]
                         plan: PoolPlan,
                         threshold: float, factor: float,
                         level=pool_update):
    """Run all levels of `plan` in order through `level` (the dispatching
    wrapper, or its plain version for a comparison on the card); returns
    (clv_flat, sc_flat), updated in place."""
    rates, states, total = clv_flat.shape
    pool2d = clv_flat.view(rates * states, total)
    for table, width in zip(plan.tables, plan.widths):
        level(pool2d, sc_flat, pmatrix, table, width, plan.gl, plan.gr,
              rates, states, threshold, factor)
    return clv_flat, sc_flat


def pool_work(levels) -> Tuple[int, int]:
    """(parent class columns, computed columns W) summed over the ops of
    `schedule_pool_levels`' levels: the work the class counts call for, and
    the work the bucket widths make the kernel do."""
    ops = [e for lv in levels for e in lv]
    return (sum(int(gl.size) for _, _, gl, _ in ops),
            sum(int(w) for w, _, _, _ in ops))
