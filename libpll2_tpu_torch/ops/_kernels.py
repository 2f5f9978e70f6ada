"""Build, load and launch the port's CUDA kernels.

The sources under `libpll2_tpu_torch/csrc/` are compiled with nvcc for
Hopper (`sm_90a`) into one shared library with a plain C interface, at first
use, into `libpll2_tpu_torch/_build/` (listed in .gitignore). The library's
file name carries a hash of the sources and flags, so an edit rebuilds it.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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
    missing). The compiler's report (`-Xptxas -v`: registers, spills) is
    kept beside it as `<name>.log`."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD / f"libpll2_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
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
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_traversal: {msg}")


def launch_fused_traversal(tip_codes: torch.Tensor, pmatrix: torch.Tensor,
                           table: torch.Tensor, rates: int, states: int,
                           n_slots: int, threshold: float, factor: float):
    """Launch csrc/fused_traversal.cu on the current stream; see
    ops/fused.py:fused_traversal for the contract."""
    dev = pmatrix.device
    _check(dev.type == "cuda", f"expected CUDA tensors, got {dev}")
    for name, t in (("tip_codes", tip_codes), ("table", table)):
        _check(isinstance(t, torch.Tensor) and t.device == dev,
               f"{name} must be a tensor on {dev}")
    _check(pmatrix.dtype == torch.float32,
           f"the kernel takes float32 P-matrices, got {pmatrix.dtype}")
    _check(tip_codes.dtype == torch.int32 and table.dtype == torch.int32,
           "tip_codes and table must be int32")
    _check(pmatrix.dim() == 4 and tuple(pmatrix.shape[1:])
           == (rates, states, states),
           f"pmatrix shape {tuple(pmatrix.shape)} is not [E, {rates}, "
           f"{states}, {states}]")
    _check(tip_codes.dim() == 2 and tip_codes.shape[1] > 0,
           f"tip_codes shape {tuple(tip_codes.shape)} is not [tips, sites]")
    _check(table.dim() == 2 and table.shape[1] == 8 and table.shape[0] >= 1,
           f"table shape {tuple(table.shape)} is not [n_ops+1, 8]")
    _check(1 <= states <= 32, f"states={states}: tip codes are 32-bit masks")
    _check(rates >= 1 and n_slots >= 1, "rates and n_slots must be >= 1")
    for name, t in (("tip_codes", tip_codes), ("pmatrix", pmatrix),
                    ("table", table)):
        _check(t.is_contiguous(), f"{name} must be contiguous")

    sites = tip_codes.shape[1]
    rs = rates * states
    f32, i32 = torch.float32, torch.int32
    out_p = torch.empty((rates, states, sites), dtype=f32, device=dev)
    out_c = torch.empty((rates, states, sites), dtype=f32, device=dev)
    sc_p = torch.empty(sites, dtype=i32, device=dev)
    sc_c = torch.empty(sites, dtype=i32, device=dev)
    # one spare slot: the generic (runtime-size) instantiation builds each
    # parent there before copying it into its own slot
    slots = torch.empty((n_slots + 1, rs, sites), dtype=f32, device=dev)
    slot_sc = torch.empty((n_slots, sites), dtype=i32, device=dev)
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
