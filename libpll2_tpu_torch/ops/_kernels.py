"""Build, load and launch the port's CUDA kernels.

The sources under `libpll2_tpu_torch/csrc/` are compiled with nvcc for
Hopper (`sm_90a`), one nvcc process per source in parallel, and linked into
one shared library with a plain C interface, at first use, into
`libpll2_tpu_torch/_build/` (listed in .gitignore). The library's file name
carries a hash of the sources and flags, so an edit rebuilds it.
It is loaded with ctypes: pointers come from `Tensor.data_ptr()`, the
stream from `torch.cuda.current_stream().cuda_stream`, and each C entry
returns `cudaGetLastError()` after its launch.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc or a GPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME or PATH)")


def library_path() -> Path:
    """Path of the built library for the current sources (built if
    missing): one nvcc per source, all started together, then one link.
    The compiler's report (`-Xptxas -v`: registers, spills) is kept beside
    it as `<name>.log`."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD / f"libpll2_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD.mkdir(exist_ok=True)
    tag = f"tmp{os.getpid()}"
    objs = [out.with_suffix(f".{src.stem}.{tag}.o") for src in sources]
    nvcc = _nvcc()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    log, failed = [], []
    for src, proc in zip(sources, procs):
        text = proc.communicate()[0]
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{text[-4000:]}")
    tmp = out.with_suffix(f".{tag}.so")
    if not failed:
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        log.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr[-4000:]}")
    out.with_suffix(".log").write_text("".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)        # atomic against a concurrent build
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(library_path()))
    lib.pll_fused_traversal.argtypes = [
        _P, _I,            # table, n_ops
        _P,                # pmatrix
        _P, _I,            # tip codes, sites
        _I, _I,            # rates, states
        _P, _P, _I,        # slots, slot scalers, n_slots
        _P, _P, _P, _P,    # out_p, out_c, sc_p, sc_c
        _F, _F,            # threshold, factor
        _P,                # stream
    ]
    lib.pll_fused_traversal.restype = _I
    lib.pll_fused_traversal_rows.argtypes = (
        lib.pll_fused_traversal.argtypes[:-1] + [_I, _P])   # + bf16 flag
    lib.pll_fused_traversal_rows.restype = _I
    lib.pll_level_update.argtypes = [
        _P, _P, _P,        # clv, scaler, pmatrix
        _P, _I, _I,        # table, its leading dimension, ops
        _I, _I, _I,        # sites, rates, states
        _F, _F,            # threshold, factor
        _P,                # stream
    ]
    lib.pll_level_update.restype = _I
    lib.pll_pool_update.argtypes = [
        _P, _P, _P,        # pool, scaler pool, pmatrix
        _P, _I, _I, _I,    # table, its leading dimension, ops, max width
        _L,                # pool columns
        _P, _P,            # gl, gr
        _I, _I,            # rates, states
        _F, _F,            # threshold, factor
        _P,                # stream
    ]
    lib.pll_pool_update.restype = _I
    return lib


def _check(cond: bool, msg: str, name: str = "fused_traversal") -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_inputs(name: str, tip_codes: torch.Tensor, pmatrix: torch.Tensor,
                  table: torch.Tensor, rates: int, states: int,
                  n_slots: int) -> None:
    """The argument checks both traversal kernels share."""
    dev = pmatrix.device
    _check(dev.type == "cuda", f"expected CUDA tensors, got {dev}", name)
    for what, t in (("tip_codes", tip_codes), ("table", table)):
        _check(isinstance(t, torch.Tensor) and t.device == dev,
               f"{what} must be a tensor on {dev}", name)
    _check(pmatrix.dtype == torch.float32,
           f"the kernel takes float32 P-matrices, got {pmatrix.dtype}", name)
    _check(tip_codes.dtype == torch.int32 and table.dtype == torch.int32,
           "tip_codes and table must be int32", name)
    _check(pmatrix.dim() == 4 and tuple(pmatrix.shape[1:])
           == (rates, states, states),
           f"pmatrix shape {tuple(pmatrix.shape)} is not [E, {rates}, "
           f"{states}, {states}]", name)
    _check(tip_codes.dim() == 2 and tip_codes.shape[1] > 0,
           f"tip_codes shape {tuple(tip_codes.shape)} is not [tips, sites]",
           name)
    _check(table.dim() == 2 and table.shape[1] == 8 and table.shape[0] >= 1,
           f"table shape {tuple(table.shape)} is not [n_ops+1, 8]", name)
    _check(1 <= states <= 32, f"states={states}: tip codes are 32-bit masks",
           name)
    _check(rates >= 1 and n_slots >= 1, "rates and n_slots must be >= 1",
           name)
    for what, t in (("tip_codes", tip_codes), ("pmatrix", pmatrix),
                    ("table", table)):
        _check(t.is_contiguous(), f"{what} must be contiguous", name)


def _outputs(rates: int, states: int, sites: int, dev):
    f32, i32 = torch.float32, torch.int32
    return (torch.empty((rates, states, sites), dtype=f32, device=dev),
            torch.empty((rates, states, sites), dtype=f32, device=dev),
            torch.empty(sites, dtype=i32, device=dev),
            torch.empty(sites, dtype=i32, device=dev))


def launch_fused_traversal(tip_codes: torch.Tensor, pmatrix: torch.Tensor,
                           table: torch.Tensor, rates: int, states: int,
                           n_slots: int, threshold: float, factor: float):
    """Launch csrc/fused_traversal.cu on the current stream; see
    ops/fused.py:fused_traversal for the contract."""
    _check_inputs("fused_traversal", tip_codes, pmatrix, table, rates,
                  states, n_slots)
    dev = pmatrix.device
    sites = tip_codes.shape[1]
    out_p, out_c, sc_p, sc_c = _outputs(rates, states, sites, dev)
    # one spare slot: the generic (runtime-size) instantiation builds each
    # parent there before copying it into its own slot
    slots = torch.empty((n_slots + 1, rates * states, sites),
                        dtype=torch.float32, device=dev)
    slot_sc = torch.empty((n_slots, sites), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = library().pll_fused_traversal(
            table.data_ptr(), table.shape[0] - 1, pmatrix.data_ptr(),
            tip_codes.data_ptr(), sites, rates, states,
            slots.data_ptr(), slot_sc.data_ptr(), n_slots,
            out_p.data_ptr(), out_c.data_ptr(), sc_p.data_ptr(),
            sc_c.data_ptr(), float(threshold), float(factor), stream)
    if err != 0:
        raise RuntimeError(f"fused_traversal kernel launch failed: CUDA "
                           f"error {err}")
    return out_p, out_c, sc_p, sc_c


# the rows kernel keeps one op's [rates * states, 32 sites] float32 output
# tile in shared memory beside its staging buffers (fused_traversal_rows.cu)
ROWS_MAX_RS = 1024


def launch_fused_traversal_rows(tip_codes: torch.Tensor,
                                pmatrix: torch.Tensor, table: torch.Tensor,
                                rates: int, states: int, n_slots: int,
                                threshold: float, factor: float,
                                bf16: bool):
    """Launch csrc/fused_traversal_rows.cu on the current stream; see
    ops/fused.py:fused_traversal_rows for the contract. `bf16` rounds P
    and inner-child CLVs to bf16 (the 'bf16' contraction mode)."""
    name = "fused_traversal_rows"
    _check_inputs(name, tip_codes, pmatrix, table, rates, states, n_slots)
    _check(rates * states <= ROWS_MAX_RS,
           f"rates * states = {rates * states} exceeds the kernel's "
           f"shared-memory tile ({ROWS_MAX_RS})", name)
    dev = pmatrix.device
    sites = tip_codes.shape[1]
    out_p, out_c, sc_p, sc_c = _outputs(rates, states, sites, dev)
    slots = torch.empty((n_slots, rates * states, sites),
                        dtype=torch.float32, device=dev)
    slot_sc = torch.empty((n_slots, sites), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = library().pll_fused_traversal_rows(
            table.data_ptr(), table.shape[0] - 1, pmatrix.data_ptr(),
            tip_codes.data_ptr(), sites, rates, states,
            slots.data_ptr(), slot_sc.data_ptr(), n_slots,
            out_p.data_ptr(), out_c.data_ptr(), sc_p.data_ptr(),
            sc_c.data_ptr(), float(threshold), float(factor), int(bf16),
            stream)
    if err != 0:
        raise RuntimeError(f"fused_traversal_rows kernel launch failed: "
                           f"CUDA error {err}")
    return out_p, out_c, sc_p, sc_c


# a level's ops are the launch grid's y dimension
LEVEL_MAX_OPS = 65535


def launch_level_update(clv2d: torch.Tensor, scaler: torch.Tensor,
                        pmatrix: torch.Tensor, table: torch.Tensor,
                        rates: int, states: int, threshold: float,
                        factor: float) -> None:
    """Launch csrc/level_update.cu on the current stream: one level, parent
    and scaler rows written into `clv2d` and `scaler` in place; see
    ops/levels.py:level_update for the contract. `table` may be a column
    slice of a larger [9, n] tensor: its row stride is passed as the
    kernel's leading dimension."""
    name = "level_update"
    dev = clv2d.device
    _check(dev.type == "cuda", f"expected CUDA tensors, got {dev}", name)
    for what, t in (("scaler", scaler), ("pmatrix", pmatrix),
                    ("table", table)):
        _check(isinstance(t, torch.Tensor) and t.device == dev,
               f"{what} must be a tensor on {dev}", name)
    _check(clv2d.dtype == torch.float32 and pmatrix.dtype == torch.float32,
           f"the kernel takes float32 CLVs and P-matrices, got "
           f"{clv2d.dtype} and {pmatrix.dtype}", name)
    _check(scaler.dtype == torch.int32 and table.dtype == torch.int32,
           "scaler and table must be int32", name)
    _check(1 <= states <= 32 and rates >= 1,
           f"rates={rates}, states={states}: needs rates >= 1 and "
           f"1 <= states <= 32", name)
    _check(clv2d.dim() == 3 and clv2d.shape[1] == rates * states
           and clv2d.shape[2] > 0,
           f"clv shape {tuple(clv2d.shape)} is not [nodes+1, "
           f"{rates * states}, sites]", name)
    sites = clv2d.shape[2]
    _check(scaler.dim() == 2 and scaler.shape[1] == sites,
           f"scaler shape {tuple(scaler.shape)} is not [K+2, {sites}]", name)
    _check(pmatrix.dim() == 4 and tuple(pmatrix.shape[1:])
           == (rates, states, states),
           f"pmatrix shape {tuple(pmatrix.shape)} is not [E, {rates}, "
           f"{states}, {states}]", name)
    _check(table.dim() == 2 and table.shape[0] == 9
           and 1 <= table.shape[1] <= LEVEL_MAX_OPS and table.stride(1) == 1,
           f"table shape {tuple(table.shape)} (strides {table.stride()}) is "
           f"not [9, W] with 1 <= W <= {LEVEL_MAX_OPS} and unit column "
           f"stride", name)
    for what, t in (("clv", clv2d), ("scaler", scaler),
                    ("pmatrix", pmatrix)):
        _check(t.is_contiguous(), f"{what} must be contiguous", name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = library().pll_level_update(
            clv2d.data_ptr(), scaler.data_ptr(), pmatrix.data_ptr(),
            table.data_ptr(), table.stride(0), table.shape[1], sites, rates,
            states, float(threshold), float(factor), stream)
    if err != 0:
        raise RuntimeError(f"level_update kernel launch failed: CUDA error "
                           f"{err}")


def launch_pool_update(pool2d: torch.Tensor, sc: torch.Tensor,
                       pmatrix: torch.Tensor, table: torch.Tensor,
                       width: int, gl: torch.Tensor, gr: torch.Tensor,
                       rates: int, states: int, threshold: float,
                       factor: float) -> None:
    """Launch csrc/pool_update.cu on the current stream: one level, parent
    columns and counts written into `pool2d` and `sc` in place; see
    ops/pool.py:pool_update for the contract. `table` may be a column slice
    of a larger [11, n] int64 tensor: its row stride is passed as the
    kernel's leading dimension. `width` (the level's widest op) sizes the
    grid."""
    name = "pool_update"
    dev = pool2d.device
    _check(dev.type == "cuda", f"expected CUDA tensors, got {dev}", name)
    for what, t in (("sc", sc), ("pmatrix", pmatrix), ("table", table),
                    ("gl", gl), ("gr", gr)):
        _check(isinstance(t, torch.Tensor) and t.device == dev,
               f"{what} must be a tensor on {dev}", name)
    _check(pool2d.dtype == torch.float32 and pmatrix.dtype == torch.float32,
           f"the kernel takes float32 pools and P-matrices, got "
           f"{pool2d.dtype} and {pmatrix.dtype}", name)
    _check(sc.dtype == torch.int32 and gl.dtype == torch.int32
           and gr.dtype == torch.int32, "sc, gl and gr must be int32", name)
    _check(table.dtype == torch.int64, "table must be int64", name)
    _check(1 <= states <= 32 and rates >= 1,
           f"rates={rates}, states={states}: needs rates >= 1 and "
           f"1 <= states <= 32", name)
    _check(pool2d.dim() == 2 and pool2d.shape[0] == rates * states
           and pool2d.shape[1] > 0,
           f"pool shape {tuple(pool2d.shape)} is not [{rates * states}, "
           f"columns]", name)
    _check(sc.dim() == 1 and gl.dim() == 1 and gr.dim() == 1
           and gl.shape == gr.shape, "sc, gl and gr must be 1-D, gl and gr "
           "of one length", name)
    _check(pmatrix.dim() == 4 and tuple(pmatrix.shape[1:])
           == (rates, states, states),
           f"pmatrix shape {tuple(pmatrix.shape)} is not [E, {rates}, "
           f"{states}, {states}]", name)
    _check(table.dim() == 2 and table.shape[0] == 11
           and 1 <= table.shape[1] <= LEVEL_MAX_OPS and table.stride(1) == 1,
           f"table shape {tuple(table.shape)} (strides {table.stride()}) is "
           f"not [11, W] with 1 <= W <= {LEVEL_MAX_OPS} and unit column "
           f"stride", name)
    _check(1 <= width <= sc.shape[0],
           f"width {width} is not in [1, {sc.shape[0]}]", name)
    for what, t in (("pool", pool2d), ("sc", sc), ("pmatrix", pmatrix),
                    ("gl", gl), ("gr", gr)):
        _check(t.is_contiguous(), f"{what} must be contiguous", name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = library().pll_pool_update(
            pool2d.data_ptr(), sc.data_ptr(), pmatrix.data_ptr(),
            table.data_ptr(), table.stride(0), table.shape[1], int(width),
            pool2d.shape[1], gl.data_ptr(), gr.data_ptr(), rates, states,
            float(threshold), float(factor), stream)
    if err != 0:
        raise RuntimeError(f"pool_update kernel launch failed: CUDA error "
                           f"{err}")
