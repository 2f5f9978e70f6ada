"""Matrix-unit rate probe on the card: the port of tools/mxu_probe.py.

    python3 -m libpll2_tpu_torch.tools.mxu_probe [--tiles N] [--reps N]

Measures how fast csrc/mxu_probe.cu runs small dense products [m, k] @
[k, t] with float32 accumulation, in three modes: 'f32' (CUDA-core FMAs
from an 8 x 8 register tile a thread), 'bf16' (wgmma on bf16 operands, X's
fragment in registers, A's slices streamed through shared memory) and
'split' (three bf16 wgmma passes, hi.hi + hi.lo + lo.hi, float32-class
accuracy). The 20-state kernels' tensor-core questions are answered on
these numbers.

`probe(a, x, m, iters, mode, nmat, tiles)` computes, for each of `tiles`
column tiles of X [k, tiles * t] and each of its columns,
    out[:, c] = sum over i < iters of A[(i mod nmat) * m : +m] @ X[:, c]
(libpll2_tpu's `kern`, tools/mxu_probe.py:34). CUDA tensors launch two
kernels: `pack`, which lays A's slices out as the probe reads them
(counted in `pack.launches`), then the probe (one block per column tile,
counted in `probe.launches`); CPU tensors run `probe_reference`, the plain
PyTorch version. bf16 rounding is
to the nearest, ties to even (astype(bfloat16) in JAX, .to(torch.bfloat16)
here); the split's lo part is the bf16 rounding of x - hi.

The timing follows the JAX method (tools/mxu_probe.py:18-21, 58-71): a
different A slice every iteration, two trip counts timed over CUDA events
and differenced, so that launch and staging costs cancel; per product the
table gives microseconds, G columns/s and useful TFLOP/s (2 m k t FLOP),
beside a yardstick the port never calls: one torch.matmul of [m, k] @ [k,
tiles * t] divided by `tiles`, the same products per call as the probe's
launch. With 8 tiles (the TPU probe's grid) 8 SMs work; `--tiles` 264 (two
per SM) gives the card-wide rate. Needs a CUDA device: exits 2 without
one.
"""
from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

__all__ = ["MODES", "SHAPES", "probe", "probe_reference", "pack", "make",
           "time_probe", "time_matmul", "probe_table"]

MODES = ("f32", "bf16", "split")
# tools/mxu_probe.py:78-86's shapes (m, k, t) with a tenth of its trip
# counts (low, high): one product here takes one SM microseconds, so the
# TPU probe's 5000 iterations would hold a launch for a second
SHAPES = ((128, 128, 512, 50, 500), (80, 80, 512, 50, 500),
          (20, 20, 512, 50, 500), (80, 20, 512, 50, 500),
          (80, 240, 512, 50, 500), (80, 80, 2048, 20, 200))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def probe_reference(a: torch.Tensor, x: torch.Tensor, m: int, iters: int,
                    mode: str, nmat: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the probe, in float32 on the tensors'
    device: the loop over i of JAX's kernel, all column tiles at once."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    a = a.to(torch.float32)
    x = x.to(torch.float32)
    if mode == "f32":
        parts = [(a, x)]
    else:
        ah, xh = _bf16(a), _bf16(x)
        parts = [(ah, xh)]
        if mode == "split":
            al, xl = _bf16(a - ah), _bf16(x - xh)
            parts += [(ah, xl), (al, xh)]
    out = torch.zeros((m, x.shape[1]), dtype=torch.float32, device=x.device)
    for i in range(iters):
        j = (i % nmat) * m
        for aa, xx in parts:
            out = out + aa[j:j + m] @ xx
    return out


def pack(a: torch.Tensor, m: int, mode: str, t: int,
         nmat: int = 8) -> torch.Tensor:
    """A's nmat slices as the probe of tile width t reads them, as bytes
    (uint8, nmat * the plan's slice bytes: ops/_kernels.py:probe_plan).
    A CUDA tensor launches csrc/mxu_probe.cu's `pack` on the current
    stream, or raises; a CPU tensor runs its plain version,
    ops/_kernels.py:probe_packed."""
    from ..ops import _kernels
    if a.device.type == "cpu":
        plan = _kernels.probe_plan(m, a.shape[1], t, 1, mode)
        return _kernels.probe_packed(a, m, nmat, plan, mode)
    packed = _kernels.launch_mxu_probe_pack(a, m, mode, nmat, t)
    pack.launches += 1
    return packed


def probe(a: torch.Tensor, x: torch.Tensor, m: int, iters: int, mode: str,
          nmat: int = 8, tiles: int = 8) -> torch.Tensor:
    """out [m, tiles * t] (module docstring). CUDA tensors launch `pack`,
    then csrc/mxu_probe.cu's probe, on the current stream without
    synchronising, or raise; CPU tensors run `probe_reference`."""
    if a.device.type == "cpu" and x.device.type == "cpu":
        return probe_reference(a, x, m, iters, mode, nmat)
    from ..ops import _kernels
    if a.dim() != 2 or x.dim() != 2 or a.shape[1] != x.shape[0]:
        raise ValueError(f"mxu_probe: a {tuple(a.shape)} and x "
                         f"{tuple(x.shape)} are not [nmat * m, k], [k, *]")
    packed = pack(a, m, mode, x.shape[1] // tiles, nmat)
    out = _kernels.launch_mxu_probe(x, packed, m, iters, mode, nmat, tiles)
    probe.launches += 1
    return out


pack.launches = 0
probe.launches = 0


def make(m: int, k: int, t: int, tiles: int = 8, nmat: int = 8,
         seed: int = 0, device="cuda"):
    """(A [nmat * m, k], X [k, tiles * t]), uniform in [0, 1) from numpy's
    generator at `seed`, float32 on `device`."""
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.random((nmat * m, k)), dtype=torch.float32)
    x = torch.tensor(rng.random((k, t * tiles)), dtype=torch.float32)
    return a.to(device), x.to(device)


def _event_ms(fn, reps: int) -> float:
    """Median of `reps` CUDA-event timings of fn() (ms), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_probe(m: int, k: int, t: int, mode: str, lo: int, hi: int,
               tiles: int = 8, reps: int = 5, nmat: int = 8) -> dict:
    """One probe shape and mode on the card: per product (one [m, k] @
    [k, t] of one tile) the time in microseconds, G columns/s and useful
    TFLOP/s, from two trip counts differenced; and `us_call`, the longer
    call's time over its products, its fixed costs (both launches, `pack`
    included, the staging, the pipeline's fill) included. Differencing assumes those
    costs the same in both calls; where the longer call hides more of them
    behind its products, `us` reads low and `us_call` bounds it above."""
    a, x = make(m, k, t, tiles, nmat)
    ms = {it: _event_ms(lambda it=it: probe(a, x, m, it, mode, nmat, tiles),
                        reps) for it in (lo, hi)}
    dt = (ms[hi] - ms[lo]) * 1e-3 / ((hi - lo) * tiles)      # s per product
    return {"m": m, "k": k, "t": t, "mode": mode, "tiles": tiles,
            "us": dt * 1e6, "gcols": t / dt / 1e9,
            "tflops": 2 * m * k * t / dt / 1e12,
            "us_call": ms[hi] * 1e3 / (hi * tiles)}


def time_matmul(m: int, k: int, t: int, mode: str, tiles: int = 8,
                reps: int = 5, calls: int = 20) -> float:
    """ms a product [m, k] @ [k, t] of one torch.matmul [m, k] @ [k,
    tiles * t] (the probe's products of one iteration in one call), in
    the mode's operand type: float32 for 'f32' (run it with TF32 off, as
    probe_table does), bf16 for 'bf16' and 'split' (one bf16 pass, a third
    of 'split''s); averaged over `calls` calls between two CUDA events, the
    median of `reps`, divided by `tiles`."""
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    a = torch.rand(m, k, device="cuda").to(dt)
    b = torch.rand(k, t * tiles, device="cuda").to(dt)

    def run():
        for _ in range(calls):
            torch.matmul(a, b)

    return _event_ms(run, reps) / calls / tiles


def probe_table(tiles=(8,), modes=MODES, shapes=SHAPES, reps: int = 5):
    """time_probe and time_matmul for every shape, mode and tile count:
    a list of dicts (`library_us`: the yardstick's time a product)."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rows = []
        for m, k, t, lo, hi in shapes:
            for mode in modes:
                for n in tiles:
                    row = time_probe(m, k, t, mode, lo, hi, n, reps)
                    row["library_us"] = time_matmul(m, k, t, mode, n,
                                                    reps) * 1e3
                    rows.append(row)
        return rows
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def format_row(r: dict) -> str:
    return (f"{r['mode']:5s} [{r['m']:3d},{r['k']:3d}]@[...,{r['t']:4d}] "
            f"x{r['tiles']:3d} tiles: {r['us']:8.4f} us/dot "
            f"{r['gcols']:8.2f} G col/s {r['tflops']:7.3f} TF useful "
            f"({r['us_call']:.4f} us/dot in one call); "
            f"torch.matmul {r['library_us']:8.4f} us a product")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, nargs="+", default=[8, 264])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mxu_probe: no CUDA device", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    for row in probe_table(tuple(args.tiles), reps=args.reps):
        print(format_row(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
