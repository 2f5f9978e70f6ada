"""ctypes loader for the port's native host routines (native/pllnative.cpp).

Port of libpll2_tpu/native/__init__.py: the site-repeats classer
(`repeats_tips`, `repeats_update`), the stepwise-addition parsimony build
(`stepwise`), and the search's builders: `move_candidates` (the batched
rounds' apply + pack + rollback of every candidate in one call),
`spr_stream_enum` and `spr_stream_build` (the streamed round's targets and
schedule). The library is built with g++ at first use into
`libpll2_tpu_torch/_build/` (listed in .gitignore), its file name keyed on
a hash of the source, the flags and the compiler's version, so an edit or
another toolchain rebuilds it; nothing is written into the package
directory. When it cannot be built or loaded, `load()` prints the reason to
stderr once and returns None, and every function here returns None: the
callers then take their Python versions, which give bit-identical results.
"""
from __future__ import annotations

import ctypes as ct
import functools
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["library_path", "load", "repeats_tips", "repeats_update",
           "stepwise", "move_candidates", "spr_stream_enum",
           "spr_stream_build"]

SRC = Path(__file__).resolve().parent / "pllnative.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def library_path() -> Path:
    """Path of the built library for the current source (built if missing;
    RuntimeError when g++ is absent or fails)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    version = subprocess.run([gxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + version.encode()
                       + SRC.read_bytes())
    out = BUILD / f"libpllnative_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, out)        # atomic against a concurrent build
    return out


@functools.lru_cache(maxsize=None)
def load() -> Optional[ct.CDLL]:
    """The loaded library, built on first call; None when it cannot be
    built or loaded (the reason printed to stderr, once)."""
    try:
        lib = ct.CDLL(str(library_path()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        print(f"libpll2_tpu_torch.native: the native host routines are "
              f"unavailable; the search takes the Python builders, the "
              f"repeats classer numpy's dedup and the stepwise build its "
              f"Python loop: {exc}", file=sys.stderr, flush=True)
        return None
    i32p, i64p = ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64)
    f64p, u8p = ct.POINTER(ct.c_double), ct.POINTER(ct.c_uint8)
    u32p, u64p = ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_uint64)
    lib.pll_tpu_repeats_update.restype = ct.c_int64
    lib.pll_tpu_repeats_update.argtypes = [i32p, i32p, ct.c_int64,
                                           ct.c_int64, i32p, i32p, i32p]
    lib.pll_tpu_repeats_tips.restype = ct.c_int64
    lib.pll_tpu_repeats_tips.argtypes = [u64p, ct.c_int64, i32p, i32p]
    lib.pll_tpu_stepwise.restype = ct.c_int64
    lib.pll_tpu_stepwise.argtypes = [u32p, ct.c_int64, ct.c_int64,
                                     i64p, i64p, ct.c_int64, i32p, i32p]
    lib.pll_tpu_move_candidates.restype = ct.c_int64
    lib.pll_tpu_move_candidates.argtypes = [
        i32p, i32p, i32p, i32p, i32p, f64p,          # tree arrays
        ct.c_int64, ct.c_int64, ct.c_int64,          # H, T, n_clv
        i32p,                                        # ctip_rows (or None)
        i32p, ct.c_int64,                            # moves [K, 3]
        ct.c_int32, ct.c_int64,                      # vroot, n_matrices
        i32p, f64p, i32p, i32p, u8p]                 # outputs
    lib.pll_tpu_spr_stream_enum.restype = ct.c_int64
    lib.pll_tpu_spr_stream_enum.argtypes = [
        i32p, i32p, ct.c_int64, ct.c_int64, ct.c_int32,
        i32p, i64p, i32p, i32p, i32p, ct.c_int64, ct.c_int64]
    lib.pll_tpu_spr_stream_build.restype = ct.c_int64
    lib.pll_tpu_spr_stream_build.argtypes = [
        i32p, i32p, i32p, i32p, i32p, f64p,
        ct.c_int64, ct.c_int64, ct.c_int32, ct.c_int64,
        i32p, i64p, i32p, i32p, i32p, ct.c_int64,
        i32p, i64p,
        ct.c_int64, ct.c_int64, ct.c_int64,
        i32p, i32p, i32p, i32p, i32p, i32p,
        i32p, f64p, f64p, i32p, i32p, i32p, i32p, i64p]
    return lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ct.POINTER(typ))


def repeats_tips(codes: np.ndarray):
    """Classes of a tip's sites by state code in first-occurrence order
    (pll_tpu_repeats_tips): (site_id [sites], id_site [ids], ids), or None
    when the library is absent."""
    lib = load()
    if lib is None:
        return None
    c = np.ascontiguousarray(codes, dtype=np.uint64)
    sites = c.shape[0]
    site_id = np.empty(sites, dtype=np.int32)
    id_site = np.empty(sites, dtype=np.int32)
    ids = lib.pll_tpu_repeats_tips(_ptr(c, ct.c_uint64), sites,
                                   _ptr(site_id, ct.c_int32),
                                   _ptr(id_site, ct.c_int32))
    return site_id, id_site[:ids].copy(), int(ids)


def repeats_update(site_id_l: np.ndarray, site_id_r: np.ndarray,
                   ids_l: int, pair_space: int, lookup: np.ndarray):
    """Classes of a parent's sites by (left class, right class) pairs in
    first-occurrence order (pll_tpu_repeats_update); `pair_space` is
    ids_l * ids_r. `lookup` is the caller's int32 scratch of at least
    `pair_space` entries, all -1, which the call leaves so. (site_id,
    id_site [ids], ids), or None when the library is absent."""
    lib = load()
    if lib is None:
        return None
    if lookup.dtype != np.int32 or lookup.size < pair_space \
            or not lookup.flags.c_contiguous:
        raise ValueError("lookup must be contiguous int32 of at least "
                         f"{pair_space} entries")
    l = np.ascontiguousarray(site_id_l, dtype=np.int32)
    r = np.ascontiguousarray(site_id_r, dtype=np.int32)
    if l.shape != r.shape or l.ndim != 1:
        raise ValueError(f"class rows of shapes {l.shape} and {r.shape}")
    sites = l.shape[0]
    site_id = np.empty(sites, dtype=np.int32)
    id_site = np.empty(sites, dtype=np.int32)
    ids = lib.pll_tpu_repeats_update(
        _ptr(l, ct.c_int32), _ptr(r, ct.c_int32), ids_l, sites,
        _ptr(lookup, ct.c_int32), _ptr(site_id, ct.c_int32),
        _ptr(id_site, ct.c_int32))
    return site_id, id_site[:ids].copy(), int(ids)


def stepwise(tip_vecs: np.ndarray, states: np.ndarray, words: np.ndarray,
             order: np.ndarray):
    """The whole stepwise-addition build in one call (pll_tpu_stepwise):
    `tip_vecs` [T, stride] uint32 (each tip's partitions packed one after
    another, state k of partition p at poff[p] + k * words[p]), `states`
    and `words` [P], `order` [T] the shuffled insertion order. Returns
    (back [T + 3 (T - 2)] half-edge back-links, cost over the informative
    sites) or None when the library is absent; RuntimeError when the
    library refuses the build."""
    lib = load()
    if lib is None:
        return None
    tv = np.ascontiguousarray(tip_vecs, dtype=np.uint32)
    st = np.ascontiguousarray(states, dtype=np.int64)
    wd = np.ascontiguousarray(words, dtype=np.int64)
    od = np.ascontiguousarray(order, dtype=np.int32)
    T, stride = tv.shape
    if st.shape != wd.shape or int((st * wd).sum()) != stride \
            or od.shape != (T,):
        raise ValueError("stepwise: tip vectors, states, words and order "
                         "do not fit together")
    back = np.full(T + 3 * (T - 2), -1, dtype=np.int32)
    cost = lib.pll_tpu_stepwise(
        _ptr(tv, ct.c_uint32), T, len(st), _ptr(st, ct.c_int64),
        _ptr(wd, ct.c_int64), stride, _ptr(od, ct.c_int32),
        _ptr(back, ct.c_int32))
    if cost < 0:
        raise RuntimeError(f"pll_tpu_stepwise failed ({cost}) on {T} tips")
    return back, int(cost)


def move_candidates(back, next_, clv, scaler, pmat, length, T: int,
                    n_clv: int, ctip_rows, moves, vroot: int,
                    n_matrices: int):
    """One search round's candidate construction in one native call
    (pll_tpu_move_candidates): apply each move (kind 0 = SPR(prune,
    regraft); 1/2 = NNI-left/right on an edge), pack the fused-kernel
    candidate, roll back. Returns (tables [K, T-1, 8], blens [K, M], roots
    [K, 5], slots [K], kept [n_moves] bool) or None when the library is
    absent or a topology cannot be packed (callers fall back to the Python
    walk)."""
    lib = load()
    if lib is None:
        return None
    H = back.shape[0]
    back = np.ascontiguousarray(back, np.int32)
    next_ = np.ascontiguousarray(next_, np.int32)
    clv = np.ascontiguousarray(clv, np.int32)
    scaler = np.ascontiguousarray(scaler, np.int32)
    pmat = np.ascontiguousarray(pmat, np.int32)
    length = np.ascontiguousarray(length, np.float64)
    mv = np.ascontiguousarray(moves, np.int32)
    n_moves = mv.shape[0]
    ct_rows = (None if ctip_rows is None
               else np.ascontiguousarray(ctip_rows, np.int32))
    tables = np.zeros((n_moves, T - 1, 8), np.int32)
    blens = np.zeros((n_moves, n_matrices), np.float64)
    roots = np.zeros((n_moves, 5), np.int32)
    slots = np.zeros(n_moves, np.int32)
    kept = np.zeros(n_moves, np.uint8)
    k = lib.pll_tpu_move_candidates(
        _ptr(back, ct.c_int32), _ptr(next_, ct.c_int32),
        _ptr(clv, ct.c_int32), _ptr(scaler, ct.c_int32),
        _ptr(pmat, ct.c_int32), _ptr(length, ct.c_double),
        H, T, n_clv,
        None if ct_rows is None else _ptr(ct_rows, ct.c_int32),
        _ptr(mv, ct.c_int32), n_moves,
        vroot, n_matrices,
        _ptr(tables, ct.c_int32), _ptr(blens, ct.c_double),
        _ptr(roots, ct.c_int32), _ptr(slots, ct.c_int32),
        _ptr(kept, ct.c_uint8))
    if k < 0:
        return None
    k = int(k)
    return (tables[:k], blens[:k], roots[:k], slots[:k],
            kept.astype(bool))


def spr_stream_enum(back, next_, T: int, radius: int):
    """Radius-limited target enumeration for every internal edge in one
    native call (pll_tpu_spr_stream_enum; the order of
    search._internal_edges x spr_stream.enumerate_targets). Returns (prune
    [G], group_off [G+1], tgt, tgt_parent, tgt_sib) or None."""
    lib = load()
    if lib is None:
        return None
    H = back.shape[0]
    back = np.ascontiguousarray(back, np.int32)
    next_ = np.ascontiguousarray(next_, np.int32)
    ub_g = max(H - T, 1)
    ub_t = max(ub_g * min(2 << radius, 2 * T + 8), 16)
    for _ in range(2):
        prune = np.zeros(ub_g, np.int32)
        goff = np.zeros(ub_g + 1, np.int64)
        tgt = np.zeros(ub_t, np.int32)
        tpar = np.zeros(ub_t, np.int32)
        tsib = np.zeros(ub_t, np.int32)
        ng = lib.pll_tpu_spr_stream_enum(
            _ptr(back, ct.c_int32), _ptr(next_, ct.c_int32), H, T,
            radius, _ptr(prune, ct.c_int32), _ptr(goff, ct.c_int64),
            _ptr(tgt, ct.c_int32), _ptr(tpar, ct.c_int32),
            _ptr(tsib, ct.c_int32), ub_g, ub_t)
        if ng >= 0:
            nt = int(goff[ng])
            return (prune[:ng], goff[:ng + 1], tgt[:nt], tpar[:nt],
                    tsib[:nt])
        ub_t *= 4
    return None


def spr_stream_build(back, next_, clv, scaler, pmat, length, T: int,
                     vroot: int, width: int,
                     prune, group_off, tgt, tgt_parent, tgt_sib,
                     kept, kept_off,
                     n_nodes: int, n_scalers: int, n_edges: int):
    """Whole streamed-round schedule construction in one native call
    (pll_tpu_spr_stream_build; rows and waves bit-identical to the Python
    build_spr_stream). Returns a dict of dense arrays or None."""
    lib = load()
    if lib is None:
        return None
    H = back.shape[0]
    arrs = [np.ascontiguousarray(a, np.int32)
            for a in (back, next_, clv, scaler, pmat)]
    length = np.ascontiguousarray(length, np.float64)
    prune = np.ascontiguousarray(prune, np.int32)
    group_off = np.ascontiguousarray(group_off, np.int64)
    tgt = np.ascontiguousarray(tgt, np.int32)
    tgt_parent = np.ascontiguousarray(tgt_parent, np.int32)
    tgt_sib = np.ascontiguousarray(tgt_sib, np.int32)
    kept = np.ascontiguousarray(kept, np.int32)
    kept_off = np.ascontiguousarray(kept_off, np.int64)
    n_groups = prune.shape[0]
    ub_post = T + 2
    ub_up = 2 * T + 8
    ub_a = max(tgt.shape[0], 1)
    ub_c = max(kept.shape[0], 1)
    post_rows = np.zeros((ub_post, 8), np.int32)
    post_wave = np.zeros(ub_post, np.int32)
    up_rows = np.zeros((ub_up, 8), np.int32)
    up_wave = np.zeros(ub_up, np.int32)
    a_rows = np.zeros((ub_a, 8), np.int32)
    a_wave = np.zeros(ub_a, np.int32)
    cand = np.zeros((ub_c, 7), np.int32)
    half_len = np.zeros(ub_c, np.float64)
    merged = np.zeros(max(n_groups, 1), np.float64)
    pair_p = np.zeros(ub_c, np.int32)
    pair_t = np.zeros(ub_c, np.int32)
    rm_clv = np.full(H, -9, np.int32)
    rm_sc = np.full(H, -9, np.int32)
    counts = np.zeros(6, np.int64)
    r = lib.pll_tpu_spr_stream_build(
        _ptr(arrs[0], ct.c_int32), _ptr(arrs[1], ct.c_int32),
        _ptr(arrs[2], ct.c_int32), _ptr(arrs[3], ct.c_int32),
        _ptr(arrs[4], ct.c_int32), _ptr(length, ct.c_double),
        H, T, vroot, width,
        _ptr(prune, ct.c_int32), _ptr(group_off, ct.c_int64),
        _ptr(tgt, ct.c_int32), _ptr(tgt_parent, ct.c_int32),
        _ptr(tgt_sib, ct.c_int32), n_groups,
        _ptr(kept, ct.c_int32), _ptr(kept_off, ct.c_int64),
        n_nodes, n_scalers, n_edges,
        _ptr(post_rows, ct.c_int32), _ptr(post_wave, ct.c_int32),
        _ptr(up_rows, ct.c_int32), _ptr(up_wave, ct.c_int32),
        _ptr(a_rows, ct.c_int32), _ptr(a_wave, ct.c_int32),
        _ptr(cand, ct.c_int32), _ptr(half_len, ct.c_double),
        _ptr(merged, ct.c_double),
        _ptr(pair_p, ct.c_int32), _ptr(pair_t, ct.c_int32),
        _ptr(rm_clv, ct.c_int32), _ptr(rm_sc, ct.c_int32),
        _ptr(counts, ct.c_int64))
    if r != 0:
        return None
    n_post, n_up, n_a, n_cand, n_merged, n_aux = (int(c) for c in counts)
    return {"post_rows": post_rows[:n_post], "post_wave": post_wave[:n_post],
            "up_rows": up_rows[:n_up], "up_wave": up_wave[:n_up],
            "a_rows": a_rows[:n_a], "a_wave": a_wave[:n_a],
            "cand": cand[:n_cand], "half_len": half_len[:n_cand],
            "merged_len": merged[:n_merged],
            "pair_prune": pair_p[:n_cand], "pair_tgt": pair_t[:n_cand],
            "rowmap_clv": rm_clv, "rowmap_sc": rm_sc, "n_aux": n_aux}
