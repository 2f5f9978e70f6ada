"""The whole postorder traversal in one kernel launch.

Port of libpll2_tpu/ops/pallas_fused.py. The host packs the postorder into
an op table whose inner CLVs live in a small set of reusable slots
(`pack_fused_schedule`); one launch walks the table for every site and
returns only the root edge's two CLVs and their scaler counts. Tips enter
as int32 state bitmasks (`tip_code_matrix`) and are decoded on the fly.

`fused_traversal` is the entry point. For CPU tensors it runs
`fused_traversal_reference`, the plain PyTorch version of the walk. For
CUDA tensors it launches a hand-written kernel: alphabets below
`ROWS_STATES_MIN` states take csrc/fused_traversal.cu (counted in
`fused_traversal.launches`), larger ones (proteins) take
csrc/fused_traversal_rows.cu through `fused_traversal_rows` (counted in
`fused_traversal_rows.launches`).

Semantics (per op row [pslot, l_is_tip, l_idx, m1, r_is_tip, r_idx, m2,
has_scaler]): x = (P[m1] . left) * (P[m2] . right) per rate; when
has_scaler and max over all rates and states of x < threshold, the site is
multiplied by `factor` and its count grows by one; counts of the children
are added, tips count 0.

Contraction modes (`mxu`, libpll2_tpu's names; they act on float32 with
`ROWS_STATES_MIN` or more states, as in JAX, and smaller alphabets always
contract exactly):
  'split', 'highest' -- exact float32 products and sums. On the TPU 'split'
      was a hi/lo bf16 triple pass that recovers fp32-class accuracy from a
      bf16 matrix unit; a CUDA core's float32 FMA gives that directly, so
      both names run the same code and give the same answer.
  'bf16' -- the TPU's throughput mode, numerics kept: P and every
      inner-child CLV value are rounded to bf16 (half-up, `round_bf16`, as
      libpll2_tpu's split_bf16 hi part); tip 0/1 indicators are exact;
      products and sums stay float32.
float64 (the CPU-only certified path) contracts exactly in every mode, as
libpll2_tpu's float64 path does.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["pack_fused_schedule", "tip_code_matrix", "fused_traversal",
           "fused_traversal_rows", "fused_traversal_reference",
           "round_bf16", "MXU_MODES", "ROWS_STATES_MIN"]

MXU_MODES = ("split", "bf16", "highest")
# alphabets from this size on take the row-layout kernel and the mxu modes
# (libpll2_tpu/ops/pallas_fused.py:PLANE_STATES_MAX)
ROWS_STATES_MIN = 16


def _check_mxu(mxu: str) -> None:
    if mxu not in MXU_MODES:
        raise ValueError(f"mxu must be one of {MXU_MODES}, got {mxu!r}")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bf16 precision, kept as float32: the top
    16 bits after a half-up carry, `(bits + 0x8000) & 0xFFFF0000`
    (libpll2_tpu/ops/pallas_fused.py:split_bf16's hi part). The rows
    kernel rounds with the same bit operation."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x8000, -0x10000).view(torch.float32)


def pack_fused_schedule(operations, n_tips: int, root_pair):
    """Linear-scan register allocation of the postorder onto CLV slots.

    Returns (table [n_ops+1, 8] int32, n_slots). Table rows per op:
      [parent_slot, l_is_tip, l_idx, m1, r_is_tip, r_idx, m2, has_scaler]
    where l_idx/r_idx is a tip row (is_tip=1) or a slot id (is_tip=0). The
    extra last row holds the root edge:
      [p_is_tip, p_idx, c_is_tip, c_idx, 0, 0, 0, 0].
    The JAX original's raw tip-CLV rows (is_tip=2, set_tip_clv tips) are
    not ported yet.

    Returns (None, 0) when the list is not a postorder the kernel supports
    (an op consumes a CLV that was never produced, or an inner op lacks a
    scaler buffer).
    """
    root_p, root_c = root_pair

    last_use = {}
    for k, op in enumerate(operations):
        for c in (op.child1_clv_index, op.child2_clv_index):
            if c >= n_tips:
                last_use[c] = k
    n_ops = len(operations)
    for rn in (root_p, root_c):
        if rn >= n_tips:
            last_use[rn] = n_ops          # alive until the end

    free: list = []
    slot_of: dict = {}
    n_slots = 0
    table = np.zeros((n_ops + 1, 8), dtype=np.int32)
    for k, op in enumerate(operations):
        if op.parent_scaler_index < 0:
            return None, 0                 # kernel assumes scaler per op
        row = [0] * 8
        for pos, (c, m) in enumerate(
                ((op.child1_clv_index, op.child1_matrix_index),
                 (op.child2_clv_index, op.child2_matrix_index))):
            if c < n_tips:
                row[1 + 3 * pos], row[2 + 3 * pos] = 1, c
            else:
                if c not in slot_of:
                    return None, 0         # consumed before produced
                row[1 + 3 * pos] = 0
                row[2 + 3 * pos] = slot_of[c]
            row[3 + 3 * pos] = m
        # free dying children BEFORE allocating the parent: the kernels
        # read both children completely before writing, so the parent may
        # reuse a dead child's slot
        for c in (op.child1_clv_index, op.child2_clv_index):
            if c >= n_tips and last_use.get(c) == k:
                free.append(slot_of.pop(c))
        if free:
            ps = free.pop()
        else:
            ps = n_slots
            n_slots += 1
        slot_of[op.parent_clv_index] = ps
        row[0] = ps
        row[7] = 1
        table[k] = row

    def root_entry(c):
        if c < n_tips:
            return 1, c
        if c not in slot_of:
            return None
        return 0, slot_of[c]

    pe, ce = root_entry(root_p), root_entry(root_c)
    if pe is None or ce is None:
        return None, 0
    table[n_ops] = [pe[0], pe[1], ce[0], ce[1], 0, 0, 0, 0]
    return table, max(n_slots, 1)


def tip_code_matrix(partition) -> np.ndarray:
    """int32 state-bitmask matrix [tips, sites_padded]: real sites carry
    the charmap masks, padded columns 0 (zero CLVs). The kernel needs no
    padding to a site grain, so the port passes no `pad_to`."""
    p = partition
    codes = np.zeros((p.tips, p.sites_padded), dtype=np.int32)
    codes[:, :p.sites] = p.tip_states[:, :p.sites].astype(np.int64) \
        .astype(np.int32)
    return codes


def fused_traversal_reference(tip_codes: torch.Tensor,   # [n_tips, S] int32
                              pmatrix: torch.Tensor,     # [E, R, s, s]
                              table,                     # [n_ops+1, 8] int
                              rates: int, states: int, n_slots: int,
                              threshold: float, factor: float,
                              mxu: str = "split"):
    """Plain PyTorch version of the fused traversal, in the dtype of
    `pmatrix` (float32 or float64) and on its device: the op table is
    walked in Python, each op vectorised over sites. `mxu` is the
    contraction mode (module docstring). Returns (clv_p, clv_c [R, s, S],
    sc_p, sc_c [S] int32) for the root edge."""
    _check_mxu(mxu)
    dtype, device = pmatrix.dtype, pmatrix.device
    sites = tip_codes.shape[1]
    rows = torch.as_tensor(table).cpu().tolist()
    n_ops = len(rows) - 1
    shifts = torch.arange(states, device=device, dtype=torch.int32)
    zero_sc = torch.zeros(sites, dtype=torch.int32, device=device)
    fac = torch.tensor(factor, dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    slots: list = [None] * n_slots
    bf16 = (mxu == "bf16" and states >= ROWS_STATES_MIN
            and dtype == torch.float32)
    if bf16:
        pmatrix = round_bf16(pmatrix)

    def child(is_tip, idx):
        if is_tip:
            # bit j of the code is state j; a gap sets every bit
            bits = (tip_codes[idx][None, :] >> shifts[:, None]) & 1
            return bits.to(dtype).expand(rates, states, sites), zero_sc
        return slots[idx]

    def operand(is_tip, idx):
        clv, sc = child(is_tip, idx)
        return (round_bf16(clv) if bf16 and not is_tip else clv), sc

    for row in rows[:n_ops]:
        left, lsc = operand(row[1], row[2])
        right, rsc = operand(row[4], row[5])
        x = (torch.einsum('rij,rjs->ris', pmatrix[row[3]], left)
             * torch.einsum('rij,rjs->ris', pmatrix[row[6]], right))
        sc = lsc + rsc
        if row[7]:
            scale = torch.amax(x, dim=(0, 1)) < threshold           # [S]
            x = x * torch.where(scale, fac, one)
            sc = sc + scale.to(torch.int32)
        slots[row[0]] = (x, sc)

    root = rows[n_ops]
    clv_p, sc_p = child(root[0], root[1])
    clv_c, sc_c = child(root[2], root[3])
    return (clv_p.contiguous(), clv_c.contiguous(), sc_p.clone(),
            sc_c.clone())


def fused_traversal(tip_codes: torch.Tensor,   # [n_tips, S] int32 bitmasks
                    pmatrix: torch.Tensor,     # [E, R, s, s]
                    table: torch.Tensor,       # [n_ops+1, 8] int32
                    rates: int, states: int, n_slots: int,
                    threshold: float, factor: float, mxu: str = "split"):
    """One full postorder; returns (clv_p, clv_c, sc_p, sc_c) for the root
    edge: CLVs [R, s, S], scaler counts [S] int32. `mxu` is the contraction
    mode (module docstring); below `ROWS_STATES_MIN` states it is ignored.

    CUDA tensors launch a hand-written kernel (float32 only) on the
    current stream, without synchronising, or raise: fused_traversal.cu
    below `ROWS_STATES_MIN` states, else `fused_traversal_rows`. CPU
    tensors run `fused_traversal_reference`. The table's indices are
    trusted: callers build it with `pack_fused_schedule`, whose tip and
    slot indices are in range by construction, and check its matrix
    indices against `pmatrix` (the engine does so when it packs a
    topology)."""
    _check_mxu(mxu)
    if pmatrix.device.type == "cpu" and tip_codes.device.type == "cpu":
        return fused_traversal_reference(tip_codes, pmatrix, table, rates,
                                         states, n_slots, threshold, factor,
                                         mxu)
    if states >= ROWS_STATES_MIN:
        return fused_traversal_rows(tip_codes, pmatrix, table, rates, states,
                                    n_slots, threshold, factor, mxu)
    from . import _kernels
    out = _kernels.launch_fused_traversal(tip_codes, pmatrix, table, rates,
                                          states, n_slots, threshold, factor)
    fused_traversal.launches += 1
    return out


fused_traversal.launches = 0


def fused_traversal_rows(tip_codes: torch.Tensor,   # [n_tips, S] int32
                         pmatrix: torch.Tensor,     # [E, R, s, s]
                         table: torch.Tensor,       # [n_ops+1, 8] int32
                         rates: int, states: int, n_slots: int,
                         threshold: float, factor: float,
                         mxu: str = "split"):
    """The same walk through the row-layout kernel
    (csrc/fused_traversal_rows.cu, any states <= 32, one thread block per
    tile of sites), which replaces libpll2_tpu's `_fused_kernel`.
    `fused_traversal` sends alphabets of `ROWS_STATES_MIN` or more states
    here. CUDA tensors launch the kernel (float32 only) or raise; CPU
    tensors run `fused_traversal_reference`."""
    _check_mxu(mxu)
    if pmatrix.device.type == "cpu" and tip_codes.device.type == "cpu":
        return fused_traversal_reference(tip_codes, pmatrix, table, rates,
                                         states, n_slots, threshold, factor,
                                         mxu)
    from . import _kernels
    out = _kernels.launch_fused_traversal_rows(
        tip_codes, pmatrix, table, rates, states, n_slots, threshold, factor,
        bf16=(mxu == "bf16" and states >= ROWS_STATES_MIN))
    fused_traversal_rows.launches += 1
    return out


fused_traversal_rows.launches = 0
