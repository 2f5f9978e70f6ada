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
from typing import NamedTuple

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
    traversal = [
        _P, _I,            # table, n_ops
        _P,                # pmatrix
        _I, _L, _L,        # candidates, table and P strides
        _P, _P,            # tip codes, raw tip rows (or null)
        _P, _I, _I,        # query codes (or null), their tip row, queries
        _I,                # sites
        _I, _I,            # rates, states
        _P, _P, _I,        # slots, slot scalers, n_slots
        _P, _P, _P, _P,    # out_p, out_c, sc_p, sc_c
        _F, _F,            # threshold, factor
        _I,                # per-rate scalers
    ]
    lib.pll_fused_traversal.argtypes = traversal + [
        _P,                # stream
        _I, _I, _I, _L,    # fused_plan: on chip, threads a site, sites a
        _I, _I,            # block, shared-memory bytes; the generic body's
        _I,                # width and ring depth (0, 0 at 4 x 4); the
    ]                      # cluster (1 but on the 4 x 4 on-chip body)
    lib.pll_fused_traversal.restype = _I
    lib.pll_fused_traversal_rows.argtypes = traversal + [
        _I, _P,            # contraction mode, stream
        _I, _I, _I,        # rows_plan: plan, sites a thread, SP,
        _I, _I, _L,        # rate chunk, groups, shared-memory bytes
    ]
    lib.pll_fused_traversal_rows.restype = _I
    _D = ctypes.c_double
    lib.pll_fused_traversal_f64.argtypes = [
        _P, _I,            # table, n_ops
        _P, _P, _P,        # pmatrix, tip codes, raw tip rows (or null)
        _I, _I, _I,        # sites, rates, states
        _P, _P, _I,        # slots, slot scalers, n_slots
        _P, _P, _P, _P,    # out_p, out_c, sc_p, sc_c
        _D, _D,            # threshold, factor
        _P,                # stream
        _I, _I, _I, _L,    # generic_plan: on chip, threads a site, sites a
        _I, _I,            # block, shared-memory bytes, width, ring depth
    ]
    lib.pll_fused_traversal_f64.restype = _I
    lib.pll_rows_smem_optin.argtypes = []
    lib.pll_rows_smem_optin.restype = _I
    lib.pll_level_update.argtypes = [
        _P, _P, _P,        # clv, scaler, pmatrix
        _P, _I, _I,        # table, its leading dimension, ops
        _I, _I, _I,        # sites, rates, states
        _F, _F,            # threshold, factor
        _I,                # per-rate scalers
        _I, _I,            # level_fixed_plan: sites a lane, tiles a block
        _P, _I, _I,        # trial form: shared rows, their count, trials
        _I, _I, _I,        # a trial's CLV rows, scaler rows, P-matrices
        _I,                # level64_plan: blocks a cluster
        _P,                # stream
    ]
    lib.pll_level_update.restype = _I
    lib.pll_level64_resident.argtypes = [_I]
    lib.pll_level64_resident.restype = _I
    lib.pll_pool_update.argtypes = [
        _P, _P, _P,        # pool, scaler pool, pmatrix
        _P, _I, _L,        # table, its leading dimension, pool columns
        _P, _P,            # gl, gr
        _I, _I,            # rates, states
        _F, _F,            # threshold, factor
        _L, _I,            # scaler pool columns, per-rate scalers
        _P, _I,            # tile map, its granules
        _I, _I,            # pool_plan: rate warps, tiles a block
        _I, _L, _L, _L,    # trials; their strides: pool, scaler pool, P
        _I,                # pool_plan: blocks a cluster
        _P,                # stream
    ]
    lib.pll_pool_update.restype = _I
    lib.pll_pool64_resident.argtypes = [_I]
    lib.pll_pool64_resident.restype = _I
    lib.pll_pool_traversal.argtypes = [
        _P, _P, _P,        # pool, scaler pool, pmatrix
        _P, _I, _L,        # table, its leading dimension, pool columns
        _P, _P,            # gl, gr
        _F, _F,            # threshold, factor
        _L, _I,            # scaler pool columns, per-rate scalers
        _P, _I,            # tickets, their count
        _P,                # wait lists (or null)
        _P, _I,            # counters, their count
        _I,                # pool_fixed_plan: blocks
        _I, _I,            # trials, the ops their counters cover
        _L, _L, _L,        # the trials' strides: pool, scaler pool, P
        _P,                # stream
    ]
    lib.pll_pool_traversal.restype = _I
    lib.pll_mxu_probe_pack.argtypes = [
        _P, _P,            # a, packed
        _I, _I, _I, _I,    # m, k, nmat, tile width t
        _I,                # mode
        _I, _I, _I, _I,    # probe_plan: n, k_pad, chunk, cols,
        _I, _L,            # stages, shared-memory bytes
        _P,                # stream
    ]
    lib.pll_mxu_probe_pack.restype = _I
    lib.pll_mxu_probe.argtypes = [
        _P, _P, _P,        # x, packed, out
        _I, _I, _I,        # m, k, nmat
        _I, _I, _I,        # tile width t, tiles, iters
        _I,                # mode
        _I, _I, _I, _I,    # probe_plan: n, k_pad, chunk, cols,
        _I, _L,            # stages, shared-memory bytes
        _P,                # stream
    ]
    lib.pll_mxu_probe.restype = _I
    return lib


def _check(cond: bool, msg: str, name: str = "fused_traversal") -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


# the states the level and pool kernels take (their runtime-size variants,
# padded to 4, 8, 16, 20 or 32, and from WIDE_STATES_MIN to 64 in
# csrc/states64.cuh); the fused kernels' tip codes are 32-bit masks, so they
# stop at 32 (ops/fused.py:FUSED_MAX_STATES)
KERNEL_MAX_STATES = 64
WIDE_STATES_MIN = 33

# the candidates one launch of a traversal kernel takes (the grid's y), and
# the queries (the grid's z)
MAX_CANDIDATES = 65535
MAX_QUERIES = 65535


def _check_inputs(name: str, tip_codes: torch.Tensor, pmatrix: torch.Tensor,
                  table: torch.Tensor, rates: int, states: int,
                  n_slots: int, tip_clvs) -> None:
    """The argument checks both traversal kernels share, on the candidate
    form: `table` [K, n_ops+1, 8] and `pmatrix` [K, E, R, s, s]."""
    dev = pmatrix.device
    _check(dev.type == "cuda", f"expected CUDA tensors, got {dev}", name)
    for what, t in (("tip_codes", tip_codes), ("table", table)):
        _check(isinstance(t, torch.Tensor) and t.device == dev,
               f"{what} must be a tensor on {dev}", name)
    _check(pmatrix.dtype == torch.float32,
           f"the kernel takes float32 P-matrices, got {pmatrix.dtype}", name)
    _check(tip_codes.dtype == torch.int32 and table.dtype == torch.int32,
           "tip_codes and table must be int32", name)
    _check(table.dim() == 3 and table.shape[2] == 8 and table.shape[1] >= 1
           and 1 <= table.shape[0] <= MAX_CANDIDATES,
           f"table shape {tuple(table.shape)} is not [K, n_ops+1, 8] with "
           f"1 <= K <= {MAX_CANDIDATES}", name)
    _check(pmatrix.dim() == 5 and tuple(pmatrix.shape[2:])
           == (rates, states, states) and pmatrix.shape[0] == table.shape[0],
           f"pmatrix shape {tuple(pmatrix.shape)} is not [{table.shape[0]}, "
           f"E, {rates}, {states}, {states}]", name)
    _check(tip_codes.dim() == 2 and tip_codes.shape[1] > 0,
           f"tip_codes shape {tuple(tip_codes.shape)} is not [tips, sites]",
           name)
    _check(1 <= states <= 32, f"states={states}: tip codes are 32-bit masks",
           name)
    _check(rates >= 1 and n_slots >= 1, "rates and n_slots must be >= 1",
           name)
    for what, t in (("tip_codes", tip_codes), ("pmatrix", pmatrix),
                    ("table", table)):
        _check(t.is_contiguous(), f"{what} must be contiguous", name)
    if tip_clvs is not None:
        _check(isinstance(tip_clvs, torch.Tensor) and tip_clvs.device == dev
               and tip_clvs.dtype == torch.float32
               and tip_clvs.is_contiguous() and tip_clvs.dim() == 3
               and tuple(tip_clvs.shape[1:]) == (states,
                                                 tip_codes.shape[1]),
               f"tip_clvs must be a contiguous float32 tensor [n, {states}, "
               f"{tip_codes.shape[1]}] on {dev}", name)


def _check_queries(name: str, tip_codes: torch.Tensor, query_codes,
                   query_row: int) -> int:
    """The query form's operands (`query_codes` [Q, S] int32 replacing tip
    row `query_row`); returns Q, 1 without queries."""
    if query_codes is None:
        _check(query_row == -1, "query_row without query_codes", name)
        return 1
    _check(isinstance(query_codes, torch.Tensor)
           and query_codes.device == tip_codes.device
           and query_codes.dtype == torch.int32
           and query_codes.is_contiguous() and query_codes.dim() == 2
           and query_codes.shape[1] == tip_codes.shape[1]
           and 1 <= query_codes.shape[0] <= MAX_QUERIES,
           f"query_codes must be a contiguous int32 tensor [Q, "
           f"{tip_codes.shape[1]}] with 1 <= Q <= {MAX_QUERIES} on "
           f"{tip_codes.device}", name)
    _check(0 <= query_row < tip_codes.shape[0],
           f"query_row {query_row} is not a tip row of [0, "
           f"{tip_codes.shape[0]})", name)
    return query_codes.shape[0]


def _outputs(k: int, rates: int, states: int, sites: int, dev,
             rate_scalers: bool):
    """The root rows of K walks: CLVs [K, R, s, S] x 2, counts [K, S]
    ([K, R, S] per rate) x 2."""
    f32, i32 = torch.float32, torch.int32
    sc = (k, rates, sites) if rate_scalers else (k, sites)
    return (torch.empty((k, rates, states, sites), dtype=f32, device=dev),
            torch.empty((k, rates, states, sites), dtype=f32, device=dev),
            torch.empty(sc, dtype=i32, device=dev),
            torch.empty(sc, dtype=i32, device=dev))


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


# fused_traversal.cu's on-chip plan (4 states x 4 rates): compute threads a
# block (4 hold the 4 rates of one or two sites; one more warp stages the
# inputs), and the share of the SMs that blocks of 64 sites must reach for
# two sites a thread; the ops whose inputs are in flight (kDepth); the spill
# plan runs one thread a site in blocks of FUSED_SPILL_BLOCK
FUSED_COMPUTE_THREADS = 128
FUSED_SPT2_SM_SHARE = 0.5
FUSED_DEPTH = 4
FUSED_SPILL_BLOCK = 64
# the on-chip plan's thread block clusters: the sizes tried (a walk's
# subtrees side by side on the cluster's blocks, ops/fused.py:
# split_fused_schedule); an SM's shared memory (an H100's 228 KB) and what
# each resident block reserves of it, its threads and registers and the
# registers' allocation unit a warp; the cluster body's registers a thread
# at one and two sites a thread (ptxas on sm_90a: 64 and 94-96; the body
# without a cluster takes 56 and 72); and the launch time's model
# (`fused_walk_cost`): an op's time a + b x (the SM's compute warps), with
# a = FUSED_LATENCY_WARPS x b, and FUSED_CLUSTER_COST x b a block of a
# cluster for the cluster's own costs (the launch, the join, the top
# stream's reads of the peers), fitted to the walk's times at 4 to 16 warps
# an SM and 1 to 8 blocks a cluster on an H100 (PERF.md, Findings)
FUSED_CLUSTERS = (2, 4, 8)
SM_SMEM_BYTES = 233472
SMEM_BLOCK_RESERVE = 1024
SM_MAX_THREADS = 2048
SM_REGISTERS = 65536
WARP_REGISTER_UNIT = 256
FUSED_REGISTERS = {1: 64, 2: 96}
FUSED_LATENCY_WARPS = 8
FUSED_CLUSTER_COST = 40


class FusedPlan(NamedTuple):
    """How fused_traversal.cu runs a 4 states x 4 rates shape: `plan`
    'on-chip' (the block's slots and counts in shared memory, the next ops'
    P, tips and table rows prefetched; 4 threads hold the 4 rates of one
    site, `threads_per_site` 4, or of two, 2) or 'spill' (slots in device
    memory, one thread a site, where the slots do not fit);
    `sites_per_block` the block's sites; `smem_bytes` its dynamic shared
    memory (0 when spilled); `cluster` the blocks of a thread block cluster
    that walk the same sites, each its own subtrees of the walk
    (`split_fused_schedule`'s parts; 1: the whole walk a block). Other
    shapes take a GenericPlan."""
    plan: str
    threads_per_site: int
    sites_per_block: int
    smem_bytes: int
    cluster: int = 1


def fused_onchip_bytes(n_slots: int, sites_per_thread: int) -> int:
    """Shared memory of one on-chip block (fused_traversal.cu,
    onchip_smem_words): the ring's 2 x FUSED_DEPTH barriers and the
    cluster's two (8 bytes each), its FUSED_DEPTH entries of one op's
    inputs (the table row, 8 words; P[m1] and P[m2], 2 x 4 rates x 20
    words; the block's 32 * sites_per_thread sites' raw tip rows and tip
    codes, 5 words a site and child), then per slot the block's site
    columns (4 rates x 4 floats a site) and one count a site of each
    compute thread. Per-rate counts take the same bytes: each thread keeps
    one a site."""
    spt = sites_per_thread
    sites = 32 * spt
    ring = (2 * (2 * FUSED_DEPTH + 2)
            + FUSED_DEPTH * (8 + 2 * 4 * 20 + 2 * sites * 5))
    return 4 * (ring + n_slots * (sites * 16 + spt * FUSED_COMPUTE_THREADS))


def fused_resident_blocks(smem_bytes: int, sites_per_thread: int) -> int:
    """The on-chip body's blocks of `smem_bytes` that an SM holds at once,
    by its shared memory, its threads and its registers
    (FUSED_REGISTERS)."""
    warps = FUSED_COMPUTE_THREADS // 32 + 1
    unit = WARP_REGISTER_UNIT
    per_warp = -(-FUSED_REGISTERS[sites_per_thread] * 32 // unit) * unit
    return min(SM_SMEM_BYTES // (smem_bytes + SMEM_BLOCK_RESERVE),
               SM_MAX_THREADS // (32 * warps),
               SM_REGISTERS // per_warp // warps)


def fused_walk_cost(blocks: int, resident: int, critical: int, sms: int,
                    cluster: int = 1):
    """The on-chip body's launch time as the plan models it, in units of
    an op's time per compute warp an SM: `blocks` blocks (in clusters of
    `cluster`) on `sms` SMs that hold `resident` each at once all run in
    one wave (None where they do not: a second wave of clusters lost every
    time it was measured); the SM with the most blocks walks `critical`
    ops one after another, each in FUSED_LATENCY_WARPS + its compute warps
    (latency-bound with few warps, issue-bound with many), and a cluster
    adds FUSED_CLUSTER_COST a block."""
    per_sm = -(-blocks // sms)
    if per_sm > resident:
        return None
    return (critical * (FUSED_LATENCY_WARPS
                        + per_sm * FUSED_COMPUTE_THREADS // 32)
            + (FUSED_CLUSTER_COST * cluster if cluster > 1 else 0))


def _cluster_plan(plan: FusedPlan, smem_bytes: int, sites: int, sms: int,
                  candidates: int, split) -> FusedPlan:
    """The on-chip `plan` with the cluster size of FUSED_CLUSTERS (or 1)
    whose `fused_walk_cost` is least, from `split(parts)` -> (slots,
    critical ops) of the launch's walks (their largest), each size at its
    own slots' bytes where they fit `smem_bytes`; of equal costs the
    smaller size. A launch whose blocks fill every SM's block slots
    without clusters keeps one block a walk. Each size's least possible
    cost (its ops shared evenly, as many blocks an SM as one slot allows)
    comes first, and a size is split only where that could beat the best
    so far: `split` is the host's work after each topology change."""
    spt = 4 // plan.threads_per_site
    blocks = candidates * -(-sites // plan.sites_per_block)
    resident = fused_resident_blocks(plan.smem_bytes, spt)
    if blocks >= sms * resident:
        return plan
    n_ops = split(1)[1]
    best = (fused_walk_cost(blocks, resident, n_ops, sms), 1, plan)
    most = fused_resident_blocks(fused_onchip_bytes(1, spt), spt)
    lows = []
    for parts in FUSED_CLUSTERS:
        low = fused_walk_cost(blocks * parts, most, -(-n_ops // parts), sms,
                              parts)
        if low is not None:
            lows.append((low, parts))
    for low, parts in sorted(lows):
        if (low, parts) >= best[:2]:
            continue
        n_slots, critical = split(parts)
        nbytes = fused_onchip_bytes(n_slots, spt)
        if nbytes > smem_bytes:
            continue
        c = fused_walk_cost(blocks * parts,
                            fused_resident_blocks(nbytes, spt), critical,
                            sms, parts)
        if c is not None and (c, parts) < best[:2]:
            best = (c, parts,
                    plan._replace(smem_bytes=nbytes, cluster=parts))
    return best[2]


# fused_traversal.cu's runtime-size body (fused_generic): the state widths it
# is built for, by the bytes of its floating type (float32 up to 16 states,
# float64 up to 32); its compute warps a block, at most; its ring depths,
# the deeper first
GENERIC_WIDTHS = {4: (4, 8, 16), 8: (4, 8, 16, 20, 32)}
GENERIC_MAX_WARPS = 4
GENERIC_DEPTHS = (4, 2)


class GenericPlan(NamedTuple):
    """How fused_traversal.cu's runtime-size body runs one shape: a site's
    rates on `threads_per_site` neighbouring lanes (G, the power of two
    from min(R, 32); `rates_per_lane` rates a lane above 32), `warps`
    compute warps a block of `sites_per_block` sites, states padded to
    `padded_states` (the instantiated width), a ring of `depth` ops'
    inputs staged by a producer warp. `plan` 'on-chip': the block's slots
    and counts in shared memory, P staged in the ring; 'spill': the slots
    in device memory and P read through L1, where the slots and P do not
    fit a block's shared memory. `smem_bytes` the block's dynamic shared
    memory (`generic_bytes`)."""
    plan: str
    threads_per_site: int
    sites_per_block: int
    smem_bytes: int
    padded_states: int
    rates_per_lane: int
    warps: int
    depth: int


def generic_lanes(rates: int) -> int:
    """The lanes of a site in the generic body: the power of two from
    min(rates, 32)."""
    return 1 << (min(rates, 32) - 1).bit_length()


def generic_bytes(onchip: bool, rates: int, states: int, n_slots: int,
                  rate_scalers: bool, itemsize: int, padded_states: int,
                  warps: int, depth: int, raw_tips: bool) -> int:
    """Shared memory of one block of the generic body (fused_traversal.cu,
    generic_layout), in 4-byte words times 4, every part a multiple of 16
    bytes: the ring's 2 x `depth` barriers (8 bytes each); `depth` entries
    of one op's inputs (the table row, 8 words; on chip P of both sides,
    each rate's SP x SP block padded by 4 words; the block's tip codes, 2 x
    its sites rounded to 4; with `raw_tips` its raw tip rows, 2 x s x its
    sites items); on chip then the slots (n_slots x rates a lane x s x the
    block's lanes items) and the counts (n_slots x 1, or rates a lane per
    rate, x its lanes)."""
    g = generic_lanes(rates)
    rpl = -(-rates // g)
    lanes = 32 * warps
    spb = lanes // g

    def r4(n):
        return (n + 3) // 4 * 4

    prw = padded_states * padded_states * itemsize // 4 + 4
    entry = (8 + (2 * rates * prw if onchip else 0) + 2 * r4(spb)
             + (r4(2 * states * spb * itemsize // 4) if raw_tips else 0))
    words = 4 * depth + depth * entry
    if onchip:
        words += n_slots * rpl * states * lanes * itemsize // 4
        words += n_slots * (rpl if rate_scalers else 1) * lanes
    return 4 * words


def generic_plan(rates: int, states: int, n_slots: int, rate_scalers: bool,
                 smem_bytes: int, sites: int, sms: int, candidates: int = 1,
                 itemsize: int = 4, raw_tips: bool = False) -> GenericPlan:
    """The runtime-size body's plan for one shape on a device with `sms`
    SMs whose blocks may use `smem_bytes` of shared memory, for a launch of
    `candidates` walks (each its own row of blocks), in float32 (`itemsize`
    4) or float64 (8), with raw tip rows staged where `raw_tips`. Compute
    warps a block: from GENERIC_MAX_WARPS down until the launch's blocks
    (those of every walk together) reach every SM. On chip at the most of
    those warps, then the fewer, each with the deepest ring of
    GENERIC_DEPTHS that fits; else spilled at those warps. The bytes are
    fused_traversal.cu's, which refuses a launch whose count differs."""
    widths = GENERIC_WIDTHS.get(itemsize, ())
    sp = next((w for w in widths if w >= states), None)
    low = 2 if itemsize == 8 else 1
    if (sp is None or states < low or rates < 1 or n_slots < 1 or sites < 1
            or candidates < 1):
        raise ValueError(f"generic_plan: no plan for {rates} rates, {states} "
                         f"states, {n_slots} slots, {sites} sites, "
                         f"{candidates} candidates in {8 * itemsize}-bit "
                         f"floats")
    g = generic_lanes(rates)
    rpl = -(-rates // g)
    per_warp = 32 // g
    warps = GENERIC_MAX_WARPS
    while warps > 1 and candidates * -(-sites // (per_warp * warps)) < sms:
        warps //= 2
    w = warps
    while w >= 1:
        for depth in GENERIC_DEPTHS:
            nbytes = generic_bytes(True, rates, states, n_slots, rate_scalers,
                                   itemsize, sp, w, depth, raw_tips)
            if nbytes <= smem_bytes:
                return GenericPlan("on-chip", g, per_warp * w, nbytes, sp,
                                   rpl, w, depth)
        w //= 2
    depth = GENERIC_DEPTHS[0]
    nbytes = generic_bytes(False, rates, states, n_slots, rate_scalers,
                           itemsize, sp, warps, depth, raw_tips)
    if nbytes > smem_bytes:
        raise ValueError(f"generic_plan: {nbytes} bytes of shared memory "
                         f"exceed the device's {smem_bytes}")
    return GenericPlan("spill", g, per_warp * warps, nbytes, sp, rpl, warps,
                       depth)


def fused_plan(rates: int, states: int, n_slots: int, rate_scalers: bool,
               smem_bytes: int, sites: int, sms: int,
               candidates: int = 1, raw_tips: bool = False, split=None):
    """fused_traversal.cu's plan for one float32 shape on a device with
    `sms` SMs whose blocks may use `smem_bytes` of shared memory, for a
    launch of `candidates` topologies (each its own row of blocks). 4
    states x 4 rates run on chip (a FusedPlan), with two sites a thread
    where the launch's blocks of 64 sites (the candidates' together) still
    reach FUSED_SPT2_SM_SHARE of the SMs and fit, else one site; they spill
    where neither fits. On chip, `split` (parts -> the largest slots and
    critical ops of the walks' `split_fused_schedule` at that many parts;
    None: one block a walk) gives the thread block cluster
    (`_cluster_plan`). Other sizes take the runtime-size body's plan
    (`generic_plan`, a GenericPlan; `raw_tips` there). `rate_scalers` does
    not change the 4 x 4 layout."""
    if (rates < 1 or not 1 <= states <= 32 or n_slots < 1 or sites < 1
            or candidates < 1):
        raise ValueError(f"fused_plan: no plan for {rates} rates, {states} "
                         f"states, {n_slots} slots, {sites} sites, "
                         f"{candidates} candidates")
    if (rates, states) != (4, 4):
        return generic_plan(rates, states, n_slots, rate_scalers, smem_bytes,
                            sites, sms, candidates, 4, raw_tips)
    wide = candidates * -(-sites // 64) >= FUSED_SPT2_SM_SHARE * sms
    for spt in ((2, 1) if wide else (1,)):
        nbytes = fused_onchip_bytes(n_slots, spt)
        if nbytes <= smem_bytes:
            plan = FusedPlan("on-chip", 4 // spt, 32 * spt, nbytes)
            if split is None:
                return plan
            return _cluster_plan(plan, smem_bytes, sites, sms, candidates,
                                 split)
    return FusedPlan("spill", 1, FUSED_SPILL_BLOCK, 0)


def device_fused_plan(device, rates: int, states: int, n_slots: int,
                      rate_scalers: bool, sites: int,
                      candidates: int = 1, raw_tips: bool = False,
                      split=None):
    """`fused_plan` for one shape on CUDA device `device`."""
    index = _device_index(device)
    return fused_plan(rates, states, n_slots, rate_scalers,
                      smem_optin(index), sites, sm_count(index), candidates,
                      raw_tips, split)


def device_generic_plan(device, rates: int, states: int, n_slots: int,
                        rate_scalers: bool, sites: int, candidates: int = 1,
                        itemsize: int = 4,
                        raw_tips: bool = False) -> GenericPlan:
    """`generic_plan` for one shape on CUDA device `device`."""
    index = _device_index(device)
    return generic_plan(rates, states, n_slots, rate_scalers,
                        smem_optin(index), sites, sm_count(index), candidates,
                        itemsize, raw_tips)


def spill_slots(plan, n_slots: int) -> int:
    """The slots a walk of `plan` (a FusedPlan, GenericPlan or RowsPlan)
    keeps in device memory: none on chip, `n_slots` on a spill plan."""
    return n_slots if plan.plan in ("spill", "tc-spill") else 0


def generic_pmatrix(pmatrix: torch.Tensor, padded_states: int) -> torch.Tensor:
    """P [..., R, s, s] as the runtime-size body reads it: each rate's
    block zero-padded to SP x SP (`padded_states`) and then by 16 bytes, [...,
    R, SP * SP + 16 / itemsize], contiguous. The padding puts a warp's rates
    on distinct shared-memory banks and keeps one side's rates one run, a
    single bulk copy (fused_traversal.cu, generic_layout's `prw`)."""
    *lead, s, _ = pmatrix.shape
    sp = padded_states
    out = pmatrix.new_zeros(*lead, sp * sp + 16 // pmatrix.element_size())
    out[..., :sp * sp].view(*lead, sp, sp)[..., :s, :s] = pmatrix
    return out


def _generic_operands(plan, pmatrix, table):
    """P and the table as the kernel takes them: 16-byte aligned for the
    on-chip 4 x 4 plan, and for the runtime-size body P in its padded
    layout (`generic_pmatrix`)."""
    if isinstance(plan, GenericPlan):
        pmatrix = generic_pmatrix(pmatrix, plan.padded_states)
    elif plan.plan == "on-chip" and pmatrix.data_ptr() % 16:
        # the kernel copies P and the table in 16-byte units; a contiguous
        # candidate's table (8 words a row) and P (16 words a matrix) keep
        # the first one's alignment
        pmatrix = pmatrix.clone()
    if (isinstance(plan, GenericPlan) or plan.plan == "on-chip") \
            and table.data_ptr() % 16:
        table = table.clone()
    return pmatrix, table


def _plan_args(plan) -> tuple:
    """The plan's trailing arguments of pll_fused_traversal (the float64
    walk's take all but the last, the cluster)."""
    generic = isinstance(plan, GenericPlan)
    return (int(plan.plan == "on-chip"), plan.threads_per_site,
            plan.sites_per_block, plan.smem_bytes,
            plan.padded_states if generic else 0,
            plan.depth if generic else 0,
            1 if generic else plan.cluster)


def _query_outputs(out, q: int, k: int, query_codes):
    """The root rows [Q * K, ...] as [Q, K, ...] in the query form."""
    if query_codes is None:
        return out
    return tuple(o.view(q, k, *o.shape[1:]) for o in out)


def launch_fused_traversal(tip_codes: torch.Tensor, pmatrix: torch.Tensor,
                           table: torch.Tensor, rates: int, states: int,
                           n_slots: int, threshold: float, factor: float,
                           rate_scalers: bool = False, tip_clvs=None,
                           query_codes=None, query_row: int = -1,
                           plan=None, splits=None):
    """Launch csrc/fused_traversal.cu once on the current stream for K
    candidates, `table` [K, n_ops+1, 8] and `pmatrix` [K, E, R, s, s], with
    `device_fused_plan`'s plan (the 4 x 4 on-chip body's cluster from
    `splits`, the tables' ops/fused.py:FusedSplits, where given; one block a
    walk without them), or with `plan` where given (a FusedPlan whose
    cluster size is forced, which then needs `splits`: its bytes follow the
    split's slots); returns the root rows with a leading K, or [Q, K] with
    Q queries' codes `query_codes` [Q, S] in tip row `query_row` (see
    ops/fused.py:fused_traversal for the contract)."""
    _check_inputs("fused_traversal", tip_codes, pmatrix, table, rates,
                  states, n_slots, tip_clvs)
    q = _check_queries("fused_traversal", tip_codes, query_codes, query_row)
    dev = pmatrix.device
    sites = tip_codes.shape[1]
    k, n_ops = table.shape[0], table.shape[1] - 1
    if (rates, states) != (4, 4):
        splits = None
    _check(splits is None or splits.host.shape[:2] == (k, n_ops + 1),
           f"splits of tables {tuple(splits.host.shape) if splits else ()}"
           f" for tables {tuple(table.shape)}")
    if plan is None:
        plan = device_fused_plan(dev, rates, states, n_slots, rate_scalers,
                                 sites, q * k, tip_clvs is not None, splits)
    if isinstance(plan, FusedPlan) and plan.cluster > 1:
        _check(splits is not None, f"a plan of {plan.cluster} blocks a "
               f"cluster needs the tables' splits")
        # the split's table, its slots and their bytes
        n_slots = splits(plan.cluster)[0]
        plan = plan._replace(smem_bytes=fused_onchip_bytes(
            n_slots, 4 // plan.threads_per_site))
        table = splits.table(plan.cluster, dev)
    out_p, out_c, sc_p, sc_c = _outputs(q * k, rates, states, sites, dev,
                                        rate_scalers)
    pmatrix, table = _generic_operands(plan, pmatrix, table)
    slots = slot_sc = None
    if plan.plan == "spill":
        slots = torch.empty((q * k, spill_slots(plan, n_slots),
                             rates * states, sites),
                            dtype=torch.float32, device=dev)
        slot_sc = torch.empty((q * k, n_slots, rates if rate_scalers else 1,
                               sites), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = library().pll_fused_traversal(
            table.data_ptr(), n_ops, pmatrix.data_ptr(), k,
            table.stride(0), pmatrix.stride(0),
            tip_codes.data_ptr(), _ptr(tip_clvs), _ptr(query_codes),
            query_row, q, sites, rates, states,
            _ptr(slots), _ptr(slot_sc), n_slots,
            out_p.data_ptr(), out_c.data_ptr(), sc_p.data_ptr(),
            sc_c.data_ptr(), float(threshold), float(factor),
            int(rate_scalers), stream, *_plan_args(plan))
    if err != 0:
        raise RuntimeError(f"fused_traversal kernel launch failed: CUDA "
                           f"error {err}")
    return _query_outputs((out_p, out_c, sc_p, sc_c), q, k, query_codes)


def launch_fused_traversal_f64(tip_codes: torch.Tensor,
                               pmatrix: torch.Tensor, table: torch.Tensor,
                               rates: int, states: int, n_slots: int,
                               threshold: float, factor: float,
                               tip_clvs=None):
    """Launch csrc/fused_traversal.cu's float64 walk
    (pll_fused_traversal_f64) once on the current stream for one topology,
    `table` [n_ops+1, 8] int32 and `pmatrix` [E, R, s, s] float64, per-site
    counts, with `device_generic_plan`'s plan in float64; returns the root
    rows (clv_p, clv_c [R, s, S] float64, sc_p, sc_c [S] int32). The slots
    live in device memory on a spill plan only."""
    name = "fused_traversal_f64"
    dev = pmatrix.device
    _check(dev.type == "cuda", f"expected CUDA tensors, got {dev}", name)
    for what, t in (("tip_codes", tip_codes), ("table", table)):
        _check(isinstance(t, torch.Tensor) and t.device == dev
               and t.dtype == torch.int32 and t.is_contiguous(),
               f"{what} must be a contiguous int32 tensor on {dev}", name)
    _check(pmatrix.dtype == torch.float64 and pmatrix.is_contiguous(),
           f"the kernel takes contiguous float64 P-matrices, got "
           f"{pmatrix.dtype}", name)
    _check(table.dim() == 2 and table.shape[1] == 8 and table.shape[0] >= 1,
           f"table shape {tuple(table.shape)} is not [n_ops+1, 8]", name)
    _check(pmatrix.dim() == 4 and tuple(pmatrix.shape[1:])
           == (rates, states, states),
           f"pmatrix shape {tuple(pmatrix.shape)} is not [E, {rates}, "
           f"{states}, {states}]", name)
    _check(tip_codes.dim() == 2 and tip_codes.shape[1] > 0,
           f"tip_codes shape {tuple(tip_codes.shape)} is not [tips, sites]",
           name)
    _check(2 <= states <= 32, f"states={states}: tip codes are 32-bit masks",
           name)
    _check(rates >= 1 and n_slots >= 1, "rates and n_slots must be >= 1",
           name)
    sites = tip_codes.shape[1]
    if tip_clvs is not None:
        _check(isinstance(tip_clvs, torch.Tensor) and tip_clvs.device == dev
               and tip_clvs.dtype == torch.float64
               and tip_clvs.is_contiguous() and tip_clvs.dim() == 3
               and tuple(tip_clvs.shape[1:]) == (states, sites),
               f"tip_clvs must be a contiguous float64 tensor [n, {states}, "
               f"{sites}] on {dev}", name)
    f64, i32 = torch.float64, torch.int32
    plan = device_generic_plan(dev, rates, states, n_slots, False, sites,
                               itemsize=8, raw_tips=tip_clvs is not None)
    pmatrix, table = _generic_operands(plan, pmatrix, table)
    out_p = torch.empty((rates, states, sites), dtype=f64, device=dev)
    out_c = torch.empty_like(out_p)
    sc_p = torch.empty(sites, dtype=i32, device=dev)
    sc_c = torch.empty_like(sc_p)
    slots = slot_sc = None
    if plan.plan == "spill":
        slots = torch.empty((spill_slots(plan, n_slots), rates * states,
                             sites), dtype=f64, device=dev)
        slot_sc = torch.empty((n_slots, 1, sites), dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = library().pll_fused_traversal_f64(
            table.data_ptr(), table.shape[0] - 1, pmatrix.data_ptr(),
            tip_codes.data_ptr(), _ptr(tip_clvs), sites, rates, states,
            _ptr(slots), _ptr(slot_sc), n_slots, out_p.data_ptr(),
            out_c.data_ptr(), sc_p.data_ptr(), sc_c.data_ptr(),
            float(threshold), float(factor), stream, *_plan_args(plan)[:6])
    if err != 0:
        raise RuntimeError(f"fused_traversal_f64 kernel launch failed: CUDA "
                           f"error {err}")
    return out_p, out_c, sc_p, sc_c


# the largest rates * states the rows route takes (32 rates x 32 states);
# the spill plan runs every shape up to it
ROWS_MAX_RS = 1024
# fused_traversal_rows.cu: lanes (sites) and warps a block, the padded
# state counts it is built for, and the most bytes of P the spill plan
# stages at once
ROWS_LANES = 32
ROWS_WARPS = 8
ROWS_PADDED_STATES = (8, 16, 20, 24, 32)
ROWS_SPILL_P_BYTES = 64 * 1024
# two sites a thread where tiles of 64 sites give at least this share of
# the SMs a block
ROWS_SPT2_SM_SHARE = 0.9
# the tensor-core plan (fused_rows_tc): sites a block (wgmma's M), a slot
# row's words (the tile and 4 of padding), the swizzle atoms' alignment
ROWS_TC_TILE = 64
ROWS_TC_STRIDE = 68
ROWS_TC_ALIGN = 1024
# the modes the tensor-core plan runs, from ops/fused.py:ROWS_STATES_MIN
# states on (below it every mode contracts exactly)
ROWS_TC_MODES = ("bf16", "split")
ROWS_TC_STATES_MIN = 16
# the kernel's `plan` argument for each plan's name, and its `mode`
ROWS_PLAN_CODES = {"spill": 0, "on-chip": 1, "tc-on-chip": 2, "tc-spill": 3}
ROWS_MODE_CODES = {"highest": 0, "bf16": 1, "split": 2}


class RowsPlan(NamedTuple):
    """How fused_traversal_rows.cu runs one shape: `plan` 'tc-on-chip'
    ('bf16' and 'split': the tensor cores, tiles of 64 sites, two
    warpgroups, the block's slots in shared memory), 'tc-spill' (the same
    with the slots in device memory), 'on-chip' ('highest': CUDA-core
    FMAs, the block's slots in shared memory, the next op's P prefetched)
    or 'spill' (CUDA-core FMAs, every mode: slots in device memory, P
    staged `rate_chunk` rates at a time); `sites_per_thread` 1 or 2 (a block's
    tile is 32 of them per lane); `smem_bytes` the block's dynamic shared
    memory; `padded_states` SP, the kernel's instantiation (P is padded to
    SP x SP); `groups` the warp groups (on the tensor cores the
    warpgroups) that share out the rates."""
    plan: str
    sites_per_thread: int
    smem_bytes: int
    padded_states: int
    rate_chunk: int
    groups: int


def rows_tc_bytes(rates: int, states: int, padded_states: int,
                  n_slots: int, rate_scalers: bool,
                  onchip: bool = True) -> int:
    """A block's shared memory on the tensor-core plans (fused_traversal_
    rows.cu:tc_smem_bytes): the atoms' alignment, P's bf16 atoms (both
    sides, every rate, N = SP padded to 8 rows of 128 bytes), two buffers
    of two code rows, the maxima (and per rate the children's counts) and,
    `onchip`, the slots [R * s][68] with their counts [SR][64]."""
    n = -(-padded_states // 8) * 8
    tile, sr = ROWS_TC_TILE, rates if rate_scalers else 1
    words = 2 * 2 * tile + (2 * rates if rate_scalers else 2) * tile
    if onchip:
        words += n_slots * (rates * states * ROWS_TC_STRIDE + sr * tile)
    return ROWS_TC_ALIGN + 2 * rates * n * 128 + 4 * words


def rows_plan(rates: int, states: int, n_slots: int, rate_scalers: bool,
              smem_bytes: int, sites: int, sms: int,
              candidates: int = 1, mxu: str = "highest") -> RowsPlan:
    """The rows kernel's plan for one shape and contraction mode `mxu` on a
    device with `sms` SMs whose blocks may use `smem_bytes` of shared
    memory, for a launch of `candidates` topologies (each its own row of
    tiles). 'bf16' and 'split' (from ROWS_TC_STATES_MIN states) run on the
    tensor cores: with the slots on chip where they, their counts, P's
    atoms and the rest fit ('tc-on-chip'), else with the slots in device
    memory where P's atoms fit ('tc-spill'), else spilled on the CUDA
    cores ('split' staging Pl beside Ph). 'highest' (and every mode below
    ROWS_TC_STATES_MIN states) runs on chip where the slots, their counts,
    two buffers of both P-matrices and the rest fit, with two sites a
    thread (one block of 64 sites an SM) where the launch's tiles of 64
    sites (the candidates' together) still give nearly every SM a block,
    else one (two blocks of 32 an SM); else spilled. The bytes follow the layouts in fused_traversal_rows.cu
    (smem_words, tc_smem_bytes), which refuses a launch whose count
    differs."""
    sp = next((p for p in ROWS_PADDED_STATES if p >= states), None)
    if sp is None or rates < 1 or n_slots < 1 or candidates < 1:
        raise ValueError(f"rows_plan: no plan for {rates} rates, {states} "
                         f"states, {n_slots} slots, {candidates} candidates")
    if mxu not in ROWS_MODE_CODES:
        raise ValueError(f"rows_plan: mxu must be one of "
                         f"{tuple(ROWS_MODE_CODES)}, got {mxu!r}")
    tc = mxu in ROWS_TC_MODES and states >= ROWS_TC_STATES_MIN
    groups = 1 << (min(rates, ROWS_WARPS).bit_length() - 1)
    h = ROWS_WARPS // groups
    # the maxima (and per rate the children's counts) beside P and codes
    red = rates * h + rates if rate_scalers else ROWS_WARPS
    p_parts = 2 if tc and mxu == "split" else 1   # spilled 'split': Ph, Pl

    def nbytes(onchip: bool, spt: int, rc: int) -> int:
        nb, tile = (2 if onchip else 1), ROWS_LANES * spt
        words = nb * 2 * rc * sp * sp * p_parts + (nb * 2 + red) * tile
        if onchip:
            sr = rates if rate_scalers else 1
            words += n_slots * (rates * states + sr) * tile
        return 4 * words

    if tc:
        for onchip, name in ((True, "tc-on-chip"), (False, "tc-spill")):
            tc_bytes = rows_tc_bytes(rates, states, sp, n_slots,
                                     rate_scalers, onchip)
            if tc_bytes <= smem_bytes:
                return RowsPlan(name, 2, tc_bytes, sp, rates,
                                2 if rates > 1 else 1)
    else:
        wide = candidates * -(-sites // (2 * ROWS_LANES)) \
            >= ROWS_SPT2_SM_SHARE * sms
        for spt in ((2, 1) if wide else (1,)):
            if nbytes(True, spt, rates) <= smem_bytes:
                return RowsPlan("on-chip", spt, nbytes(True, spt, rates),
                                sp, rates, groups)
    rc = max(1, min(rates, ROWS_SPILL_P_BYTES
                    // (2 * sp * sp * 4 * p_parts)))
    if nbytes(False, 1, rc) > smem_bytes:
        raise ValueError(f"rows_plan: {nbytes(False, 1, rc)} bytes of "
                         f"shared memory exceed the device's {smem_bytes}")
    return RowsPlan("spill", 1, nbytes(False, 1, rc), sp, rc, groups)


@functools.lru_cache(maxsize=None)
def smem_optin(index: int) -> int:
    """The dynamic shared memory a block of CUDA device `index` may use."""
    with torch.cuda.device(index):
        got = library().pll_rows_smem_optin()
    if got < 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed: CUDA error "
                           f"{-got}")
    return got


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def device_rows_plan(device, rates: int, states: int, n_slots: int,
                     rate_scalers: bool, sites: int,
                     candidates: int = 1, mxu: str = "highest") -> RowsPlan:
    """`rows_plan` for one shape and mode on CUDA device `device`."""
    index = _device_index(device)
    return rows_plan(rates, states, n_slots, rate_scalers,
                     smem_optin(index), sites, sm_count(index), candidates,
                     mxu)


def launch_fused_traversal_rows(tip_codes: torch.Tensor,
                                pmatrix: torch.Tensor, table: torch.Tensor,
                                rates: int, states: int, n_slots: int,
                                threshold: float, factor: float,
                                mxu: str, rate_scalers: bool = False,
                                tip_clvs=None, query_codes=None,
                                query_row: int = -1):
    """Launch csrc/fused_traversal_rows.cu once on the current stream for
    K candidates, `table` [K, n_ops+1, 8] and `pmatrix` [K, E, R, s, s];
    returns the root rows with a leading K, or [Q, K] in the query form (see
    ops/fused.py:fused_traversal_rows for the contract). `mxu` is the
    contraction mode ('highest', 'bf16', 'split'; ops/fused.py's module
    docstring), which below ROWS_TC_STATES_MIN states contracts exactly;
    the plan is `device_rows_plan`'s for it."""
    name = "fused_traversal_rows"
    _check_inputs(name, tip_codes, pmatrix, table, rates, states, n_slots,
                  tip_clvs)
    q = _check_queries(name, tip_codes, query_codes, query_row)
    _check(rates * states <= ROWS_MAX_RS,
           f"rates * states = {rates * states} exceeds the kernel's "
           f"shared-memory tile ({ROWS_MAX_RS})", name)
    dev = pmatrix.device
    sites = tip_codes.shape[1]
    k = table.shape[0]
    if states < ROWS_TC_STATES_MIN:
        mxu = "highest"
    plan = device_rows_plan(dev, rates, states, n_slots, rate_scalers,
                            sites, q * k, mxu)
    sp = plan.padded_states
    # the kernel copies P in 16-byte units of zero-padded SP x SP blocks (a
    # candidate's P, E x R x SP x SP words, keeps the first one's alignment)
    if sp != states:
        pmatrix = torch.nn.functional.pad(pmatrix,
                                          (0, sp - states, 0, sp - states))
    elif pmatrix.data_ptr() % 16:
        pmatrix = pmatrix.clone()
    out_p, out_c, sc_p, sc_c = _outputs(q * k, rates, states, sites, dev,
                                        rate_scalers)
    slots = slot_sc = None
    if spill_slots(plan, n_slots):
        slots = torch.empty((q * k, spill_slots(plan, n_slots),
                             rates * states, sites),
                            dtype=torch.float32, device=dev)
        slot_sc = torch.empty((q * k, n_slots, rates if rate_scalers else 1,
                               sites), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = library().pll_fused_traversal_rows(
            table.data_ptr(), table.shape[1] - 1, pmatrix.data_ptr(), k,
            table.stride(0), pmatrix.stride(0),
            tip_codes.data_ptr(), _ptr(tip_clvs), _ptr(query_codes),
            query_row, q, sites, rates, states,
            _ptr(slots), _ptr(slot_sc), n_slots,
            out_p.data_ptr(), out_c.data_ptr(), sc_p.data_ptr(),
            sc_c.data_ptr(), float(threshold), float(factor),
            int(rate_scalers), ROWS_MODE_CODES[mxu], stream,
            ROWS_PLAN_CODES[plan.plan], plan.sites_per_thread, sp,
            plan.rate_chunk, plan.groups, plan.smem_bytes)
    if err != 0:
        raise RuntimeError(f"fused_traversal_rows kernel launch failed: "
                           f"CUDA error {err}")
    return _query_outputs((out_p, out_c, sc_p, sc_c), q, k, query_codes)


# a level's ops are the launch grid's y dimension (the runtime-size
# variant's), the trials of its trial form the z dimension
LEVEL_MAX_OPS = 65535
LEVEL_MAX_TRIALS = 65535
# level_update.cu's 4x4 variant: lanes a block (one a rate, four a site
# group); its blocks resident on an SM (the launch bounds of each
# instantiation: 4 sites a lane per site, per rate, and 1 or 2 sites a
# lane); and the tiles an SM a level must have before a lane takes more
# than one site
LEVEL_FIXED_THREADS = 128
LEVEL_FIXED_BLOCKS_PER_SM = 5
LEVEL_FIXED_BLOCKS_PER_SM_RATE = 4
LEVEL_FIXED_BLOCKS_PER_SM_NARROW = 6
LEVEL_FIXED_MIN_TILES_PER_SM = 2


def level_fixed_blocks_per_sm(sites_per_lane: int, rate_scalers: bool) -> int:
    """The 4x4 level kernel's blocks resident on one SM for one
    instantiation (its launch bounds)."""
    if sites_per_lane < 4:
        return LEVEL_FIXED_BLOCKS_PER_SM_NARROW
    return LEVEL_FIXED_BLOCKS_PER_SM_RATE if rate_scalers \
        else LEVEL_FIXED_BLOCKS_PER_SM


class LevelFixedPlan(NamedTuple):
    """How level_update.cu's 4x4 variant runs one level: four neighbouring
    lanes hold the 4 rates of `sites_per_lane` consecutive sites (4 and 2:
    16- and 8-byte accesses; 1: the scalar layout); a block's tile is
    LEVEL_FIXED_THREADS / 4 site groups, `tile` sites of one op; the
    level's `tiles` (ops x tiles an op, op-major) go to `blocks` blocks in
    runs of `tiles_per_block`, each block loading its next tile while it
    stores this one."""
    sites_per_lane: int
    tile: int
    tiles: int
    tiles_per_block: int
    blocks: int


@functools.lru_cache(maxsize=4096)
def level_fixed_plan(ops: int, sites: int, sms: int, aligned: bool = True,
                     rate_scalers: bool = False,
                     trials: int = 1) -> LevelFixedPlan:
    """The 4x4 level kernel's layout for one level of `ops` ops over
    `sites` sites on a device with `sms` SMs; `aligned` when the CLV and
    scaler buffers (and the trial form's shared rows) start on 16 bytes. A
    lane takes 4 sites where S % 4 == 0, 2 where S % 2 == 0, else 1 (a
    row's start must be aligned to the access), and fewer while the level
    would give an SM fewer than LEVEL_FIXED_MIN_TILES_PER_SM tiles (narrow
    levels: more, shorter threads). Blocks take runs of tiles, as many
    blocks as the instantiation keeps resident
    (`level_fixed_blocks_per_sm`) fill the card once. Per-rate counts take
    the same sites a lane; with 4 of them a lane their runs are longer (4
    blocks an SM, not 5). The trial form over `trials` trials lays out
    ops x trials ops (its flat list is (trial, op, tile)), so a one-op level
    of K trials is K ops wide. level_update.cu's fixed_plan computes the
    same and refuses a launch whose layout differs."""
    if (not 1 <= ops <= LEVEL_MAX_OPS or not 1 <= trials <= LEVEL_MAX_TRIALS
            or sites < 1 or sms < 1):
        raise ValueError(f"level_fixed_plan: no plan for {ops} ops, "
                         f"{trials} trials, {sites} sites, {sms} SMs")
    v = 1 if not aligned else 4 if sites % 4 == 0 else \
        2 if sites % 2 == 0 else 1
    ops *= trials

    def per_op(v):
        return -(-sites // (LEVEL_FIXED_THREADS // 4 * v))

    while v > 1 and ops * per_op(v) < LEVEL_FIXED_MIN_TILES_PER_SM * sms:
        v //= 2
    tiles = ops * per_op(v)
    per = -(-tiles // (level_fixed_blocks_per_sm(v, rate_scalers) * sms))
    return LevelFixedPlan(v, LEVEL_FIXED_THREADS // 4 * v, tiles, per,
                          -(-tiles // per))


# csrc/states64.cuh, the level and pool kernels' body for WIDE_STATES_MIN
# to 64 states: threads a block, its blocks resident on an SM (shared
# memory), the sites (class columns) of a tile, and the blocks of a cluster
# at most (the portable size)
STATES64_THREADS = 128
STATES64_BLOCKS_PER_SM = 2
STATES64_TILE = 64
STATES64_MAX_CLUSTER = 8


class States64Plan(NamedTuple):
    """How csrc/states64.cuh runs one level: one rate of one op a block,
    the rates of a tile in a thread block cluster of `cluster` blocks
    (`rates_per_block` rates each, one after another), over runs of
    `tiles_per_block` consecutive tiles of `tile` sites or class columns
    of the level's flat list of `tiles` (trial, op, tile) entries;
    `blocks` in all (the cluster size divides it)."""
    cluster: int
    rates_per_block: int
    tile: int
    tiles: int
    tiles_per_block: int
    blocks: int


def states64_resident(rates: int, sms: int) -> int:
    """The clusters of the 64-state body a card of `sms` SMs keeps
    resident if every SM holds STATES64_BLOCKS_PER_SM blocks of them; the
    device's own count (`device_states64_resident`) can be lower, where a
    cluster may not span its SM groups."""
    return max(1, STATES64_BLOCKS_PER_SM * sms
               // min(rates, STATES64_MAX_CLUSTER))


def states64_plan(tiles: int, rates: int, resident: int) -> States64Plan:
    """The 64-state body's layout of a level of `tiles` tiles (all its
    trials') at `rates` rates, on a device that keeps `resident` clusters
    of min(rates, STATES64_MAX_CLUSTER) blocks resident at once: a block
    a rate (above STATES64_MAX_CLUSTER rates, ceil(rates / that) rates a
    block, one after another), and runs of consecutive tiles, as many
    runs as fill the card once, so that a narrow level spreads its tiles
    over the card and a wide one stages P once for a long run.
    csrc/states64.cuh's `plan` computes the same."""
    if tiles < 1 or rates < 1 or resident < 1:
        raise ValueError(f"states64_plan: no plan for {tiles} tiles, {rates} "
                         f"rates, {resident} resident clusters")
    cluster = min(rates, STATES64_MAX_CLUSTER)
    per = -(-tiles // resident)
    return States64Plan(cluster, -(-rates // cluster), STATES64_TILE, tiles,
                        per, -(-tiles // per) * cluster)


@functools.lru_cache(maxsize=4096)
def level64_plan(ops: int, sites: int, rates: int, resident: int,
                 trials: int = 1) -> States64Plan:
    """`states64_plan` for one level of `ops` ops over `sites` sites
    (`trials` times in the trial form): tiles of STATES64_TILE sites, the
    flat list (trial, op, tile) with the trial outermost. level_update.cu's
    launch_generic64 recomputes it and refuses a launch whose cluster or
    run differs."""
    if (not 1 <= ops <= LEVEL_MAX_OPS or not 1 <= trials <= LEVEL_MAX_TRIALS
            or sites < 1):
        raise ValueError(f"level64_plan: no plan for {ops} ops, {trials} "
                         f"trials, {sites} sites")
    return states64_plan(trials * ops * -(-sites // STATES64_TILE), rates,
                         resident)


@functools.lru_cache(maxsize=None)
def _resident64(kernel: str, index: int, cluster: int) -> int:
    lib = library()
    fn = (lib.pll_level64_resident if kernel == "level"
          else lib.pll_pool64_resident)
    with torch.cuda.device(index):
        got = fn(cluster)
    if got < 1:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed for the "
                           f"64-state {kernel} kernel: CUDA error {-got}")
    return got


def device_states64_resident(device, kernel: str, rates: int) -> int:
    """The clusters of the 64-state `kernel` ('level' or 'pool') at `rates`
    rates that CUDA device `device` keeps resident at once, as its C entry
    counts them (cudaOccupancyMaxActiveClusters)."""
    return _resident64(kernel, _device_index(device),
                       min(rates, STATES64_MAX_CLUSTER))


def launch_level_update(clv2d: torch.Tensor, scaler: torch.Tensor,
                        pmatrix: torch.Tensor, table: torch.Tensor,
                        rates: int, states: int, threshold: float,
                        factor: float, tips=None) -> None:
    """Launch csrc/level_update.cu on the current stream: one level, parent
    and scaler rows written into `clv2d` and `scaler` in place; see
    ops/levels.py:level_update for the contract (and its trial form: a
    leading trial axis on `clv2d`, `scaler` and `pmatrix`, the shared rows
    `tips`). `table` may be a column slice of a larger [9, n] tensor: its
    row stride is passed as the kernel's leading dimension."""
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
    _check(1 <= states <= KERNEL_MAX_STATES and rates >= 1,
           f"rates={rates}, states={states}: needs rates >= 1 and "
           f"1 <= states <= {KERNEL_MAX_STATES}", name)
    trials = clv2d.shape[0] if clv2d.dim() == 4 else 0
    lead = 1 if trials else 0
    _check(clv2d.dim() in (3, 4) and clv2d.shape[-2] == rates * states
           and clv2d.shape[-1] > 0 and 1 <= clv2d.shape[0]
           and trials <= LEVEL_MAX_TRIALS,
           f"clv shape {tuple(clv2d.shape)} is not [nodes+1, "
           f"{rates * states}, sites] or, for K <= {LEVEL_MAX_TRIALS} "
           f"trials, [K, rows, {rates * states}, sites]", name)
    sites = clv2d.shape[-1]
    per_rate = scaler.dim() == 3 + lead
    _check(scaler.shape[-1] == sites and (
        scaler.dim() == 2 + lead
        or (per_rate and scaler.shape[1 + lead] == rates))
           and (not trials or scaler.shape[0] == trials),
           f"scaler shape {tuple(scaler.shape)} is not "
           f"{'[K, ' if trials else '['}K+2, {sites}] or "
           f"{'[K, ' if trials else '['}K+2, {rates}, {sites}]", name)
    _check(pmatrix.dim() == 4 + lead and tuple(pmatrix.shape[1 + lead:])
           == (rates, states, states)
           and (not trials or pmatrix.shape[0] == trials),
           f"pmatrix shape {tuple(pmatrix.shape)} is not "
           f"{'[K, ' if trials else '['}E, {rates}, {states}, {states}]",
           name)
    _check(table.dim() == 2 and table.shape[0] == 9
           and 1 <= table.shape[1] <= LEVEL_MAX_OPS and table.stride(1) == 1,
           f"table shape {tuple(table.shape)} (strides {table.stride()}) is "
           f"not [9, W] with 1 <= W <= {LEVEL_MAX_OPS} and unit column "
           f"stride", name)
    base = 0
    if tips is not None:
        _check(trials > 0, "shared rows belong to the trial form", name)
        _check(isinstance(tips, torch.Tensor) and tips.device == dev
               and tips.dtype == torch.float32 and tips.dim() == 3
               and tuple(tips.shape[1:]) == (rates * states, sites)
               and tips.is_contiguous(),
               f"tips must be a contiguous float32 [rows, "
               f"{rates * states}, {sites}] tensor on {dev}", name)
        base = tips.shape[0]
    for what, t in (("clv", clv2d), ("scaler", scaler),
                    ("pmatrix", pmatrix)):
        _check(t.is_contiguous(), f"{what} must be contiguous", name)
    layout = (0, 0)  # the runtime-size variant lays itself out
    cluster = 0
    if states >= WIDE_STATES_MIN:
        plan = level64_plan(table.shape[1], sites, rates,
                            device_states64_resident(dev, "level", rates),
                            max(trials, 1))
        layout, cluster = (0, plan.tiles_per_block), plan.cluster
    elif (rates, states) == (4, 4):
        # the 4x4 variant reads P 16 bytes at a time
        if pmatrix.data_ptr() % 16:
            pmatrix = pmatrix.clone()
        ptrs = clv2d.data_ptr() | scaler.data_ptr()
        if base:
            ptrs |= tips.data_ptr()
        plan = level_fixed_plan(
            table.shape[1], sites, device_sm_count(dev), ptrs % 16 == 0,
            per_rate, max(trials, 1))
        layout = (plan.sites_per_lane, plan.tiles_per_block)
    # a trial's rows and matrices; the kernel indexes rows across the
    # trials in an int
    per_trial = ((clv2d.shape[1], scaler.shape[1], pmatrix.shape[1])
                 if trials else (0, 0, 0))
    _check(trials * max(per_trial) < 2 ** 31, f"{trials} trials of "
           f"{max(per_trial)} rows pass 2^31", name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = library().pll_level_update(
            clv2d.data_ptr(), scaler.data_ptr(), pmatrix.data_ptr(),
            table.data_ptr(), table.stride(0), table.shape[1], sites, rates,
            states, float(threshold), float(factor), int(per_rate), *layout,
            tips.data_ptr() if base else None, base, trials, *per_trial,
            cluster, stream)
    if err != 0:
        raise RuntimeError(f"level_update kernel launch failed: CUDA error "
                           f"{err}")


# pool_update.cu's runtime-size variant: threads a block, blocks resident
# on an SM (its launch bounds), and the class columns a tile-map entry
# covers (ops/pool.py:tile_map); from WIDE_STATES_MIN states its 64-state
# instantiation (csrc/states64.cuh: `states64_plan`)
POOL_BLOCK = 128
POOL_BLOCKS_PER_SM = 4
POOL_GRANULE = 128


class PoolLaunch(NamedTuple):
    """How pool_update.cu's runtime-size variant runs one level: a thread
    a class column, `rate_threads` warps sharing a column's rates (1, 2 or
    4); a tile is `tile` columns (POOL_BLOCK over the rate warps), the
    level `tiles` of them, each block a run of `tiles_per_block`, `blocks`
    in all. From WIDE_STATES_MIN states the 64-state body: one rate warp,
    tiles of STATES64_TILE columns, a block a rate, `cluster` blocks a
    cluster, runs over every trial's tiles."""
    rate_threads: int
    tile: int
    tiles: int
    tiles_per_block: int
    blocks: int
    cluster: int = 1


@functools.lru_cache(maxsize=4096)
def pool_plan(columns: int, rates: int, states: int, sms: int,
              trials: int = 1, resident: int = 0) -> PoolLaunch:
    """The runtime-size pool kernel's layout for one level of `columns`
    class columns (its tile map's granules times POOL_GRANULE) on a device
    with `sms` SMs: a column's rates split over the largest power of two
    of warps up to 4 that the rates fill, whatever the level's width;
    blocks take runs of tiles, as many blocks as POOL_BLOCKS_PER_SM an SM
    fill. From WIDE_STATES_MIN states `states64_plan` over the level's
    tiles of STATES64_TILE columns, `trials` times over (the trial form),
    with `resident` clusters (0: `states64_resident` of `sms`; on a device
    its own count, `device_states64_resident`); pool_update.cu recomputes
    it and refuses a launch whose cluster or run differs. The 4x4 size
    runs the traversal kernel (`pool_fixed_plan`)."""
    if (rates < 1 or not 1 <= states <= KERNEL_MAX_STATES
            or (rates, states) == (4, 4) or not 1 <= trials <= LEVEL_MAX_TRIALS
            or columns < 1 or columns % POOL_GRANULE or sms < 1):
        raise ValueError(f"pool_plan: no runtime-size plan for {columns} "
                         f"columns, {rates} rates, {states} states, {sms} "
                         f"SMs, {trials} trials")
    if states >= WIDE_STATES_MIN:
        tiles = columns // STATES64_TILE
        plan = states64_plan(trials * tiles, rates,
                             resident or states64_resident(rates, sms))
        return PoolLaunch(1, STATES64_TILE, tiles, plan.tiles_per_block,
                          plan.blocks, plan.cluster)
    ty = min(4, 1 << (rates.bit_length() - 1))
    tile = POOL_BLOCK // ty
    tiles = columns // tile
    per = -(-tiles // (POOL_BLOCKS_PER_SM * sms))
    return PoolLaunch(ty, tile, tiles, per, -(-tiles // per))


# pool_update.cu's 4x4 traversal kernel: the class columns of a ticket (a
# block of 128 threads, 4 lanes a column, computes them in 2 passes of 32),
# the blocks its launch bounds keep resident on an SM, and the ints between
# two of its counters (one 128-byte line each); the ticket counter counts
# past the tickets, an int32
POOL_FIXED_TILE = 64
POOL_FIXED_BLOCKS_PER_SM = 6
POOL_COUNTER_STRIDE = 32
POOL_MAX_TICKETS = 2**31 - 1


class PoolFixedPlan(NamedTuple):
    """How pool_update.cu's 4x4 kernel runs a plan in one launch: `tiles`
    tickets of POOL_FIXED_TILE class columns of one op over the plan's
    ops, drawn by `blocks` blocks of 128 threads."""
    tiles: int
    blocks: int


def pool_fixed_plan(widths, sms: int, trials: int = 1) -> PoolFixedPlan:
    """The 4x4 traversal kernel's launch over ops `widths` class columns
    wide (every op of the plan) on a device with `sms` SMs: tickets of
    POOL_FIXED_TILE columns, each op's last one partial, `trials` times
    over in the trial form; a grid that fills the card once with the blocks
    the kernel's launch bounds keep resident (POOL_FIXED_BLOCKS_PER_SM),
    and no more blocks than tickets."""
    widths = [int(w) for w in widths]
    if sms < 1 or not widths or min(widths) < 1 or trials < 1:
        raise ValueError(f"pool_fixed_plan: no plan for {len(widths)} ops "
                         f"and {trials} trials on {sms} SMs")
    tiles = trials * sum(-(-w // POOL_FIXED_TILE) for w in widths)
    return PoolFixedPlan(tiles, min(tiles, sms * POOL_FIXED_BLOCKS_PER_SM))


class PoolTraversal(NamedTuple):
    """A plan's 4x4 traversal on the device (ops/pool.py:plan_to_device):
    its launch (`pool_fixed_plan`), the plan's whole table [11, ops], the
    tickets [tiles, 4] int32 (op, first column, wait-list range), the wait
    lists [entries, 2] int32 (op, its tile count) and the counters
    [(1 + trials * ops) * POOL_COUNTER_STRIDE] int32 (the ticket, then
    each op's finished tiles, each on a line of its own, for each trial),
    which every launch zeroes before its kernel. `trials` is 1 for the
    plan's own traversal; `trial_traversal` makes the trial form's, whose
    launch draws each ticket once a trial."""
    plan: PoolFixedPlan
    table: torch.Tensor
    tickets: torch.Tensor
    waits: torch.Tensor
    counters: torch.Tensor
    trials: int = 1


def trial_traversal(trav: PoolTraversal, trials: int) -> PoolTraversal:
    """The trial form of a plan's traversal over `trials` trials: the same
    table, tickets and wait lists, `pool_fixed_plan`'s launch over `trials`
    times the tickets, and counters of its own for every trial's ops (new
    ones: the launch's memset zeroes them)."""
    tiles = trav.tickets.shape[0]
    dev = trav.tickets.device
    plan = PoolFixedPlan(tiles * trials, min(
        tiles * trials, device_sm_count(dev) * POOL_FIXED_BLOCKS_PER_SM))
    counters = torch.empty(
        ((1 + trials * trav.table.shape[1]) * POOL_COUNTER_STRIDE,),
        dtype=torch.int32, device=dev)
    return trav._replace(plan=plan, counters=counters, trials=trials)


class PoolFixedLevel(NamedTuple):
    """One level of a 4x4 plan as its own launch of the traversal kernel:
    its ops k0 .. k1-1 and its tickets t0 .. t1-1 of `traversal`; the
    ops of one level wait on none."""
    traversal: PoolTraversal
    k0: int
    k1: int
    t0: int
    t1: int


def device_sm_count(device) -> int:
    """The SMs of CUDA device `device` (the current one if it has no
    index)."""
    return sm_count(_device_index(device))


def _check_pool_args(name: str, pool2d, sc, pmatrix, gl, gr, rates: int,
                     states: int):
    """The checks both pool kernels share; returns (whether the counts are
    per rate, the trials: 0 for the one-topology form, else K of the
    leading trial axis on `pool2d`, `sc` and `pmatrix`)."""
    dev = pool2d.device
    _check(dev.type == "cuda", f"expected CUDA tensors, got {dev}", name)
    for what, t in (("sc", sc), ("pmatrix", pmatrix), ("gl", gl),
                    ("gr", gr)):
        _check(isinstance(t, torch.Tensor) and t.device == dev,
               f"{what} must be a tensor on {dev}", name)
    _check(pool2d.dtype == torch.float32 and pmatrix.dtype == torch.float32,
           f"the kernel takes float32 pools and P-matrices, got "
           f"{pool2d.dtype} and {pmatrix.dtype}", name)
    _check(sc.dtype == torch.int32 and gl.dtype == torch.int32
           and gr.dtype == torch.int32, "sc, gl and gr must be int32", name)
    _check(1 <= states <= KERNEL_MAX_STATES and rates >= 1,
           f"rates={rates}, states={states}: needs rates >= 1 and "
           f"1 <= states <= {KERNEL_MAX_STATES}", name)
    trials = pool2d.shape[0] if pool2d.dim() == 3 else 0
    lead = 1 if trials else 0
    _check(pool2d.dim() in (2, 3) and pool2d.shape[-2] == rates * states
           and pool2d.shape[-1] > 0 and 1 <= pool2d.shape[0]
           and trials <= LEVEL_MAX_TRIALS,
           f"pool shape {tuple(pool2d.shape)} is not [{rates * states}, "
           f"columns] or, for K <= {LEVEL_MAX_TRIALS} trials, [K, "
           f"{rates * states}, columns]", name)
    per_rate = sc.dim() == 2 + lead
    _check((sc.dim() == 1 + lead or (per_rate and sc.shape[lead] == rates))
           and (not trials or sc.shape[0] == trials)
           and gl.dim() == 1 and gr.dim() == 1 and gl.shape == gr.shape,
           f"sc must be {'[K, ' if trials else '['}T2] or "
           f"{'[K, ' if trials else '['}{rates}, T2], gl and gr 1-D of one "
           f"length", name)
    _check(pmatrix.dim() == 4 + lead and tuple(pmatrix.shape[1 + lead:])
           == (rates, states, states)
           and (not trials or pmatrix.shape[0] == trials),
           f"pmatrix shape {tuple(pmatrix.shape)} is not "
           f"{'[K, ' if trials else '['}E, {rates}, {states}, {states}]",
           name)
    for what, t in (("pool", pool2d), ("sc", sc), ("pmatrix", pmatrix),
                    ("gl", gl), ("gr", gr)):
        _check(t.is_contiguous(), f"{what} must be contiguous", name)
    return per_rate, trials


def _trial_strides(pool2d, sc, pmatrix, trials: int) -> tuple:
    """The elements between two trials' pools, scaler pools and P (zeros
    for the one-topology form)."""
    if not trials:
        return 0, 0, 0
    return pool2d.stride(0), sc.stride(0), pmatrix.stride(0)


def _check_table(name: str, table, dev, max_ops: int) -> None:
    _check(isinstance(table, torch.Tensor) and table.device == dev,
           f"table must be a tensor on {dev}", name)
    _check(table.dtype == torch.int64, "table must be int64", name)
    _check(table.dim() == 2 and table.shape[0] == 11
           and 1 <= table.shape[1] <= max_ops and table.stride(1) == 1,
           f"table shape {tuple(table.shape)} (strides {table.stride()}) is "
           f"not [11, W] with 1 <= W <= {max_ops} and unit column "
           f"stride", name)


def check_traversal(trav, dev) -> None:
    """Raise ValueError unless `trav` is a PoolTraversal whose arrays lie
    on `dev` with the shapes and types the 4x4 kernel reads. The kernel
    has no grid axis over the ops, so the op count is bounded only by its
    int32 counters: the tickets and the ticket counter, which ends at the
    tickets plus the blocks."""
    name = "pool_traversal"
    _check(isinstance(trav, PoolTraversal), "needs the plan's "
           "PoolTraversal (ops/pool.py:plan_to_device)", name)
    _check(trav.plan.tiles + trav.plan.blocks <= POOL_MAX_TICKETS,
           f"{trav.plan.tiles} tickets and {trav.plan.blocks} blocks "
           f"overflow the int32 ticket counter", name)
    _check_table(name, trav.table, dev,
                 POOL_MAX_TICKETS // POOL_COUNTER_STRIDE - 1)
    for what, t in (("tickets", trav.tickets), ("waits", trav.waits),
                    ("counters", trav.counters)):
        _check(t.device == dev and t.dtype == torch.int32
               and t.is_contiguous(), f"{what} must be a contiguous int32 "
               f"tensor on {dev}", name)
    n_ops = trav.table.shape[1]
    _check(trav.trials >= 1
           and trav.tickets.shape == (trav.plan.tiles // trav.trials, 4)
           and trav.plan.tiles % trav.trials == 0
           and trav.waits.dim() == 2 and trav.waits.shape[1] == 2
           and trav.counters.shape == ((1 + trav.trials * n_ops)
                                       * POOL_COUNTER_STRIDE,),
           "the traversal's tickets, wait lists or counters do not match "
           "its plan, trials and table", name)


def launch_pool_update(pool2d: torch.Tensor, sc: torch.Tensor,
                       pmatrix: torch.Tensor, table: torch.Tensor,
                       gl: torch.Tensor, gr: torch.Tensor,
                       rates: int, states: int, threshold: float,
                       factor: float, tiles=None, launch=None) -> None:
    """Launch csrc/pool_update.cu on the current stream: one level, parent
    columns and counts written into `pool2d` and `sc` in place; see
    ops/pool.py:pool_update for the contract. `table` may be a column slice
    of a larger [11, n] int64 tensor: its row stride is passed as the
    kernel's leading dimension. The runtime-size variant's grid is the
    level's tile map `tiles` (ops/pool.py:tile_map, [granules, 2] int32 on
    the device) laid out by `launch` (its `pool_plan`, which the plan
    computed once: ops/pool.py:plan_to_device); the 4x4 size runs the
    traversal kernel over the level, `launch` its PoolFixedLevel."""
    name = "pool_update"
    dev = pool2d.device
    per_rate, trials = _check_pool_args(name, pool2d, sc, pmatrix, gl, gr,
                                        rates, states)
    _check_table(name, table, dev, LEVEL_MAX_OPS)
    if (rates, states) == (4, 4):
        _check(isinstance(launch, PoolFixedLevel)
               and table.data_ptr() == launch.traversal.table[
                   :, launch.k0].data_ptr()
               and table.shape[1] == launch.k1 - launch.k0,
               f"the 4x4 kernel runs a level of its plan's traversal: "
               f"needs the level's PoolFixedLevel (ops/pool.py:"
               f"plan_to_device)", name)
        launch_pool_traversal(pool2d, sc, pmatrix, gl, gr, threshold,
                              factor, launch.traversal, launch)
        return
    strides = _trial_strides(pool2d, sc, pmatrix, trials)
    _check(isinstance(launch, PoolLaunch)
           and isinstance(tiles, torch.Tensor) and tiles.device == dev
           and tiles.dtype == torch.int32
           and tiles.shape[0] * POOL_GRANULE == launch.tiles * launch.tile,
           f"the runtime-size variant needs the level's tile map on "
           f"{dev} and its launch (ops/pool.py:plan_to_device)", name)
    if states >= WIDE_STATES_MIN:
        # the 64-state body's runs span the trials and its clusters are
        # the device's own count
        launch = pool_plan(tiles.shape[0] * POOL_GRANULE, rates, states,
                           device_sm_count(dev), max(trials, 1),
                           device_states64_resident(dev, "pool", rates))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = library().pll_pool_update(
            pool2d.data_ptr(), sc.data_ptr(), pmatrix.data_ptr(),
            table.data_ptr(), table.stride(0), pool2d.shape[-1],
            gl.data_ptr(), gr.data_ptr(), rates, states, float(threshold),
            float(factor), sc.shape[-1], int(per_rate),
            tiles.data_ptr(), tiles.shape[0], launch.rate_threads,
            launch.tiles_per_block, trials, *strides, launch.cluster, stream)
    if err != 0:
        raise RuntimeError(f"pool_update kernel launch failed: CUDA error "
                           f"{err}")


def launch_pool_traversal(pool2d: torch.Tensor, sc: torch.Tensor,
                          pmatrix: torch.Tensor, gl: torch.Tensor,
                          gr: torch.Tensor, threshold: float, factor: float,
                          trav: PoolTraversal, level=None) -> None:
    """Launch csrc/pool_update.cu's 4x4 kernel on the current stream over
    the whole traversal `trav`, or over one level of it (`level`, a
    PoolFixedLevel, whose ops wait on none): the counters zeroed, then
    parent columns and counts written into `pool2d` [16, T] and `sc` in
    place. With a leading trial axis on `pool2d`, `sc` and `pmatrix` the
    trial form: all K trials in the one launch, over `trial_traversal`'s
    counters for K trials."""
    name = "pool_traversal"
    dev = pool2d.device
    per_rate, trials = _check_pool_args(name, pool2d, sc, pmatrix, gl, gr,
                                        4, 4)
    check_traversal(trav, dev)
    _check(trav.trials == 1, "takes the plan's own traversal (the trial "
           "form sizes its counters itself)", name)
    if trials:
        trav = trial_traversal(trav, trials)
    if level is None:
        t0, t1, waits = 0, trav.tickets.shape[0], trav.waits
    else:
        t0, t1, waits = level.t0, level.t1, None
        _check(0 <= level.k0 < level.k1 <= trav.table.shape[1]
               and 0 <= t0 < t1 <= trav.tickets.shape[0],
               f"level ops {level.k0}..{level.k1} or tickets {t0}..{t1} "
               f"out of range", name)
    # the kernel reads P 16 bytes at a time
    if pmatrix.data_ptr() % 16:
        pmatrix = pmatrix.clone()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = library().pll_pool_traversal(
            pool2d.data_ptr(), sc.data_ptr(), pmatrix.data_ptr(),
            trav.table.data_ptr(), trav.table.stride(0), pool2d.shape[-1],
            gl.data_ptr(), gr.data_ptr(), float(threshold), float(factor),
            sc.shape[-1], int(per_rate), trav.tickets[t0].data_ptr(),
            t1 - t0, _ptr(waits), trav.counters.data_ptr(),
            trav.counters.numel(), trav.plan.blocks, trials,
            trav.table.shape[1], *_trial_strides(pool2d, sc, pmatrix, trials),
            stream)
    if err != 0:
        raise RuntimeError(f"pool_traversal kernel launch failed: CUDA "
                           f"error {err}")


# the probe's contraction modes, as the C entry numbers them
PROBE_MODES = {"f32": 0, "bf16": 1, "split": 2}
# csrc/mxu_probe.cu's constants: a block's shared memory, its consumer
# threads (8 warps, 2 warpgroups; one producer warp more), wgmma's row tile
# (64 columns of X), the bf16 k values of a 128-byte swizzled row, the
# ring's most stages, the ring's alignment (the swizzle atom's) and 'f32''s
# stages
PROBE_SMEM_MAX = 232448
PROBE_CONSUMERS = 256
PROBE_ROW_TILE = 64
PROBE_ATOM = 64
PROBE_MAX_STAGES = 8
PROBE_ALIGN = 1024
PROBE_F32_STAGES = 2
# pll_mxu_probe(_pack)'s return for a plan other than its own
PROBE_REFUSED = -1


class ProbePlan(NamedTuple):
    """csrc/mxu_probe.cu's layout of one probe launch (`probe_plan`)."""
    n: int            # 'bf16'/'split': wgmma's N (m up to 8); 'f32': m up to 8
    k_pad: int        # K: k up to 16 ('bf16'/'split') or 4 ('f32')
    chunk: int        # k values a ring stage holds (a swizzle atom: 64)
    chunks: int       # stages a slice
    cols: int         # columns of a tile a pass: 64 a warpgroup, or 'f32''s
    passes: int       # passes a tile
    stages: int       # the ring's
    frag: int         # 'bf16'/'split': k steps of X's fragment, 8 or 16
    stage_bytes: int
    smem_bytes: int   # the block's dynamic shared memory
    slice_bytes: int  # a slice as `pack` lays it out
    x_bytes: int      # 'split' at frag 16: X's lo part in shared memory


def probe_plan(m: int, k: int, t: int, tiles: int, mode: str) -> ProbePlan:
    """The probe's layout of A [nmat * m, k] @ X [k, tiles * t] in `mode`
    (csrc/mxu_probe.cu's header). 'bf16'/'split': N = m and K = k rounded
    up to 8 and 16, a pass a pair of 64-column row tiles (one a
    warpgroup), a ring stage one 128-byte swizzle atom (64 k values) of a
    slice's N rows (hi, and lo for 'split'), as many stages as fit, at
    most PROBE_MAX_STAGES; X's fragment (4 registers a k step, 8 k steps
    up to K = 128 and 16 above; twice that in 'split') and the
    accumulators (N / 2) stay in registers, but for 'split''s lo part
    above K = 128, which lies in shared memory (`x_bytes`: 64 rows x 64 k
    values a warpgroup and atom).
    'f32': rows up to 8, a thread an 8 x 8 tile, a pass `cols` columns
    (as many as the consumer threads and shared memory take), X's pass
    in shared memory and the slice streamed transposed in `chunk` k values
    a stage, the largest divisor of K that fits two stages. The C entry
    recomputes it and refuses another."""
    if (mode not in PROBE_MODES or not 1 <= m <= 128 or not 1 <= k <= 256
            or t < 1 or tiles < 1):
        raise ValueError(f"probe_plan: no plan for m={m}, k={k}, t={t}, "
                         f"tiles={tiles}, mode={mode!r}")
    n = -(-m // 8) * 8
    if mode == "f32":
        k_pad = -(-k // 4) * 4
        cg = min(PROBE_CONSUMERS // (n // 8), -(-t // 8))
        bars = 2 * PROBE_F32_STAGES * 8
        while (cg > 1 and 4 * k_pad * 8 * cg + PROBE_F32_STAGES * 16 * n
               + bars > PROBE_SMEM_MAX):
            cg -= 1
        cols = 8 * cg
        room = ((PROBE_SMEM_MAX - 4 * k_pad * cols - bars)
                // (PROBE_F32_STAGES * 4 * n))
        chunk = max(d for d in range(4, min(k_pad, room) + 1, 4)
                    if k_pad % d == 0)
        stages, stage = PROBE_F32_STAGES, 4 * chunk * n
        smem = 4 * k_pad * cols + stages * stage + bars
        passes = -(-t // cols)
        frag, x_bytes = 0, 0
    else:
        parts = 2 if mode == "split" else 1
        k_pad = -(-k // 16) * 16
        chunk, stage, cols = PROBE_ATOM, 128 * n * parts, PROBE_ROW_TILE
        frag = 8 if k_pad <= 128 else 16
        lo_shared = mode == "split" and frag == 16
        x_bytes = (2 * -(-k_pad // PROBE_ATOM) * PROBE_ROW_TILE * 128
                   if lo_shared else 0)
        stages = min(PROBE_MAX_STAGES, (PROBE_SMEM_MAX - PROBE_ALIGN - x_bytes
                                        - 16 * PROBE_MAX_STAGES) // stage)
        smem = PROBE_ALIGN + x_bytes + stages * stage + 16 * stages
        passes = -(-(-(-t // PROBE_ROW_TILE)) // 2)
    chunks = -(-k_pad // chunk)
    return ProbePlan(n, k_pad, chunk, chunks, cols, passes, stages, frag,
                     stage, smem, chunks * stage, x_bytes)


def _bf16_bits(v: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 bits (int32), to nearest, ties to even."""
    return (v.to(torch.bfloat16).view(torch.int16).to(torch.int32)
            & 0xFFFF)


def _bf16_from_bits(b: torch.Tensor) -> torch.Tensor:
    return (b.to(torch.int32) << 16).view(torch.float32)


def _sw128_index(plan: ProbePlan, device=None) -> torch.Tensor:
    """[N, K'] (K' = k_pad up to 64): the bf16 element of a part (hi or
    lo) of a stage's chunks, counted from the slice's start, that holds
    (row r, k value kk): chunk kk // 64, row r at byte 128 r of it, its
    16-byte chunk q = (kk % 64) // 8 at chunk index q ^ (r % 8)."""
    kk = torch.arange(plan.chunks * PROBE_ATOM, device=device)
    r = torch.arange(plan.n, device=device)[:, None]
    q = ((kk % PROBE_ATOM) // 8) ^ (r % 8)
    return ((kk // PROBE_ATOM) * (plan.stage_bytes // 2)
            + r * 64 + q * 8 + kk % 8)


def probe_layout(a_slice: torch.Tensor, plan: ProbePlan,
                 mode: str) -> torch.Tensor:
    """One slice [m, k] (float32) as csrc/mxu_probe.cu's `pack` lays it out
    for the ring: 'bf16'/'split' int32 bf16 bits, slice_bytes / 2 of them
    (stage c: its hi block, then its lo block, each N x 64 in 128-byte
    swizzled rows), 'f32' float32, the slice transposed [k_pad, n]; zero
    past m and k; on a_slice's device."""
    m, k = a_slice.shape
    dev = a_slice.device
    if mode == "f32":
        out = torch.zeros(plan.k_pad, plan.n, dtype=torch.float32, device=dev)
        out[:k, :m] = a_slice.t()
        return out.reshape(-1)
    full = torch.zeros(plan.n, plan.chunks * PROBE_ATOM, dtype=torch.float32,
                       device=dev)
    full[:m, :k] = a_slice
    hi = _bf16_bits(full)
    out = torch.zeros(plan.slice_bytes // 2, dtype=torch.int32, device=dev)
    idx = _sw128_index(plan, dev)
    out[idx.reshape(-1)] = hi.reshape(-1)
    if mode == "split":
        lo = _bf16_bits(full - _bf16_from_bits(hi))
        out[(idx + plan.n * PROBE_ATOM).reshape(-1)] = lo.reshape(-1)
    return out


def probe_unlayout(packed: torch.Tensor, plan: ProbePlan, mode: str,
                   m: int, k: int) -> list:
    """`probe_layout`'s inverse: the slice's parts as float32 [m, k]
    tensors ([hi], [hi, lo] in 'split'; 'f32': [the slice])."""
    if mode == "f32":
        return [packed.reshape(plan.k_pad, plan.n)[:k, :m].t()]
    idx = _sw128_index(plan, packed.device)
    parts = [packed[idx]]
    if mode == "split":
        parts.append(packed[idx + plan.n * PROBE_ATOM])
    return [_bf16_from_bits(p)[:m, :k] for p in parts]


def probe_packed(a: torch.Tensor, m: int, nmat: int, plan: ProbePlan,
                 mode: str) -> torch.Tensor:
    """The plain version of csrc/mxu_probe.cu's `pack`: A's nmat slices
    laid out by `probe_layout` one after another, as the bytes the kernel
    writes (uint8, nmat * slice_bytes), on a's device."""
    out = []
    for j in range(nmat):
        s = probe_layout(a[j * m:(j + 1) * m], plan, mode)
        out.append((s if mode == "f32" else s.to(torch.int16)).view(
            torch.uint8))
    return torch.cat(out)


def _probe_result(err: int, what: str, plan: ProbePlan) -> None:
    if err == PROBE_REFUSED:
        raise RuntimeError(f"{what}: the kernel refused the plan {plan}")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def launch_mxu_probe_pack(a: torch.Tensor, m: int, mode: str, nmat: int,
                          t: int) -> torch.Tensor:
    """Launch csrc/mxu_probe.cu's `pack` on the current stream: A's nmat
    slices laid out as the probe reads them (`probe_packed`'s bytes) in a
    new uint8 tensor of nmat * slice_bytes; t is the probe's tile width
    (the plan's)."""
    name = "mxu_probe"
    _check(a.device.type == "cuda", f"expected a CUDA tensor, got "
           f"{a.device}", name)
    _check(a.dtype == torch.float32 and a.is_contiguous(),
           "a must be contiguous float32", name)
    _check(mode in PROBE_MODES, f"mode must be one of {tuple(PROBE_MODES)}",
           name)
    _check(a.dim() == 2 and a.shape[0] == nmat * m,
           f"a {tuple(a.shape)} is not [{nmat} * {m}, k]", name)
    _check(1 <= m <= 128 and 1 <= a.shape[1] <= 256,
           "the kernel takes 1 <= m <= 128, 1 <= k <= 256", name)
    plan = probe_plan(m, a.shape[1], t, 1, mode)
    packed = torch.empty(nmat * plan.slice_bytes, dtype=torch.uint8,
                         device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = library().pll_mxu_probe_pack(
            a.data_ptr(), packed.data_ptr(), m, a.shape[1], nmat, t,
            PROBE_MODES[mode], plan.n, plan.k_pad, plan.chunk, plan.cols,
            plan.stages, plan.smem_bytes, stream)
    _probe_result(err, "mxu_probe pack", plan)
    return packed


def launch_mxu_probe(x: torch.Tensor, packed: torch.Tensor, m: int,
                     iters: int, mode: str, nmat: int,
                     tiles: int) -> torch.Tensor:
    """Launch csrc/mxu_probe.cu's probe on the current stream and return
    its output [m, tiles * t]; see tools/mxu_probe.py:probe for the
    contract. A's nmat slices of [m, k] (k = x's rows) are read from
    `packed`, as `launch_mxu_probe_pack` laid them out for the same plan
    (`probe_plan`'s)."""
    name = "mxu_probe"
    dev = x.device
    _check(dev.type == "cuda" and packed.device == dev,
           f"expected CUDA tensors on one device, got {dev}, "
           f"{packed.device}", name)
    _check(x.dtype == torch.float32 and x.is_contiguous(),
           "x must be contiguous float32", name)
    _check(mode in PROBE_MODES, f"mode must be one of {tuple(PROBE_MODES)}",
           name)
    _check(x.dim() == 2 and x.shape[1] % tiles == 0,
           f"x {tuple(x.shape)} is not [k, {tiles} * t]", name)
    k = x.shape[0]
    _check(1 <= m <= 128 and 1 <= k <= 256 and iters >= 0,
           "the kernel takes 1 <= m <= 128, 1 <= k <= 256, iters >= 0",
           name)
    t = x.shape[1] // tiles
    plan = probe_plan(m, k, t, tiles, mode)
    _check(packed.dtype == torch.uint8 and packed.is_contiguous()
           and packed.numel() == nmat * plan.slice_bytes,
           f"packed must be {nmat} * {plan.slice_bytes} contiguous bytes",
           name)
    out = torch.empty((m, x.shape[1]), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = library().pll_mxu_probe(
            x.data_ptr(), packed.data_ptr(), out.data_ptr(), m, k, nmat, t,
            tiles, iters, PROBE_MODES[mode], plan.n, plan.k_pad, plan.chunk,
            plan.cols, plan.stages, plan.smem_bytes, stream)
    _probe_result(err, "mxu_probe", plan)
    return out
