"""The matrix-unit probe's plain version (libpll2_tpu_torch/tools/mxu_probe.py)
against the JAX probe it ports (tools/mxu_probe.py), on the CPU.

The JAX probe is loaded from its file and its Pallas kernel run in interpret
mode; its `run` returns the sum of the output, which the port's plain
version must match to 1e-5 relative (float32 sums in another order). The
port's modes are also held against a float64 numpy product: 'f32' and
'split' to float32-class error, 'bf16' only to bf16-class error. The CUDA
kernel's layout (ops/_kernels.py:probe_plan, probe_layout) is checked here
too: its plan at every probe shape, the shared-memory layout of a slice and
back, and its decomposition emulated in plain PyTorch against the plain
version."""
import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libpll2_tpu_torch.ops import _kernels
from libpll2_tpu_torch.tools import mxu_probe as tprobe

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def jax_probe(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "jax_mxu_probe", REPO / "tools" / "mxu_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(20, 20, 128, 11), (16, 40, 64, 9)],
                         ids=["20x20", "16x40"])
def test_probe_plain_matches_jax_interpret(jax_probe, shape, mode):
    m, k, t, iters = shape
    dtype = jnp.float32 if mode == "f32" else jnp.bfloat16
    run, a, x = jax_probe.make(m, k, t, iters, dtype)
    want = float(run(a, x))
    a_t = torch.tensor(np.asarray(a, dtype=np.float32))
    x_t = torch.tensor(np.asarray(x, dtype=np.float32))
    out = tprobe.probe(a_t, x_t, m, iters, mode, nmat=8, tiles=8)
    assert out.shape == (m, 8 * t)
    got = float(out.double().sum())
    assert abs(got - want) / abs(want) < 1e-5


def _f64_product(a, x, m, iters, nmat=8):
    a64, x64 = a.double().numpy(), x.double().numpy()
    out = np.zeros((m, x64.shape[1]))
    for i in range(iters):
        j = (i % nmat) * m
        out += a64[j:j + m] @ x64
    return out


@pytest.mark.parametrize("m,k", [(20, 20), (80, 80), (80, 240)])
def test_probe_split_is_float32_class(m, k):
    """'split' (hi.hi + hi.lo + lo.hi in bf16) keeps float32-class error
    against the float64 product, 'bf16' does not."""
    a, x = tprobe.make(m, k, 32, tiles=2, seed=3, device="cpu")
    want = _f64_product(a, x, m, 5)
    err = {mode: np.abs(tprobe.probe(a, x, m, 5, mode, tiles=2).numpy()
                        - want).max() / np.abs(want).max()
           for mode in tprobe.MODES}
    assert err["f32"] < 1e-6 and err["split"] < 1e-5
    assert err["bf16"] > 1e-4 > 10 * err["split"]


def test_probe_cpu_runs_plain_version_without_counting():
    a, x = tprobe.make(16, 16, 8, tiles=2, device="cpu")
    before = tprobe.probe.launches
    got = tprobe.probe(a, x, 16, 3, "split", tiles=2)
    want = tprobe.probe_reference(a, x, 16, 3, "split")
    assert torch.equal(got, want) and tprobe.probe.launches == before
    with pytest.raises(ValueError, match="mode"):
        tprobe.probe_reference(a, x, 16, 3, "tf32")


def test_probe_tool_imports_no_jax_and_needs_cuda():
    """`python3 -m libpll2_tpu_torch.tools.mxu_probe` loads no jax module
    and, without a CUDA device, exits 2 printing no table."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, libpll2_tpu_torch.tools.mxu_probe; "
            "bad = [m for m in sys.modules "
            "if m == 'jax' or m.startswith('jax.')]; assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m",
                          "libpll2_tpu_torch.tools.mxu_probe"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and "us/dot" not in res.stdout


# the probe table's shapes and those of tests/test_torch_cuda.py's probe
# cases (m, k, t)
PLAN_SHAPES = sorted({(m, k, t) for m, k, t, _, _ in tprobe.SHAPES}
                     | {(80, 80, 512), (20, 20, 96), (128, 240, 64),
                        (80, 80, 100), (20, 240, 130), (128, 256, 2048),
                        (1, 1, 1), (8, 256, 4096)})


def _consumer_regs(p, mode):
    """The registers a consumer thread of csrc/mxu_probe.cu holds across a
    pass: 'f32' its 8 x 8 tile and a k step's 8 + 8 operands;
    'bf16'/'split' the N / 2 accumulators and X's fragment, 4 a k step of
    each part in registers ('split''s lo part lies in shared memory at 16
    k steps)."""
    if mode == "f32":
        return 64 + 16
    lo_shared = mode == "split" and p.frag == 16
    return p.n // 2 + 4 * p.frag * (2 if mode == "split" and not lo_shared
                                    else 1)


@pytest.mark.parametrize("mode", tprobe.MODES)
def test_probe_plan_fits_every_shape(mode):
    """csrc/mxu_probe.cu's layout at each shape: within a block's shared
    memory, wgmma's N a multiple of 8 up to 256 and K of 16, a ring of 2
    to PROBE_MAX_STAGES stages that covers K, passes that cover the tile,
    and the registers a consumer thread holds (X's fragment, 8 k steps up
    to K = 128 and 16 above, and the accumulators) at most 136: ptxas
    gives a thread 168 at 288 threads, and the wgmmas are serialized where
    they do not fit ('split''s lo part lies in shared memory above K =
    128)."""
    for m, k, t in PLAN_SHAPES:
        p = _kernels.probe_plan(m, k, t, 8, mode)
        assert p.smem_bytes <= _kernels.PROBE_SMEM_MAX, (m, k, t)
        assert p.n % 8 == 0 and m <= p.n < m + 8
        assert 2 <= p.stages <= _kernels.PROBE_MAX_STAGES
        assert p.chunks * p.chunk >= p.k_pad >= k
        assert p.slice_bytes == p.chunks * p.stage_bytes
        assert _consumer_regs(p, mode) <= 136
        if mode == "f32":
            assert p.k_pad % 4 == 0 and p.k_pad % p.chunk == 0
            assert p.cols % 8 == 0 and p.n // 8 * p.cols // 8 <= 256
            assert p.passes * p.cols >= t > (p.passes - 1) * p.cols
            assert p.smem_bytes == (4 * p.k_pad * p.cols
                                    + p.stages * p.stage_bytes + 32)
        else:
            parts = 2 if mode == "split" else 1
            assert p.n <= 256 and p.k_pad % 16 == 0 and p.k_pad < k + 16
            assert p.stage_bytes == 128 * p.n * parts and p.chunk == 64
            assert p.passes * 128 >= t > (p.passes - 1) * 128
            assert (p.stages == _kernels.PROBE_MAX_STAGES
                    or p.smem_bytes + p.stage_bytes + 16
                    > _kernels.PROBE_SMEM_MAX)
            assert p.frag == (8 if p.k_pad <= 128 else 16)
            lo_shared = mode == "split" and p.frag == 16
            assert p.x_bytes == (2 * p.chunks * 64 * 128 if lo_shared else 0)
    # the shapes the design names
    p = _kernels.probe_plan(20, 20, 512, 8, "bf16")
    assert (p.n, p.k_pad, p.chunks) == (24, 32, 1)
    p = _kernels.probe_plan(80, 240, 512, 264, "split")
    assert (p.n, p.k_pad, p.chunks, p.passes, p.x_bytes) == (
        80, 240, 4, 4, 65536)
    assert _consumer_regs(p, "split") == 104
    p = _kernels.probe_plan(80, 80, 512, 264, "split")
    assert (p.frag, p.x_bytes, p.stages) == (8, 0, 8)
    assert _consumer_regs(p, "split") == 104
    with pytest.raises(ValueError, match="probe_plan"):
        _kernels.probe_plan(129, 16, 64, 1, mode)


@pytest.mark.parametrize("mode", tprobe.MODES)
@pytest.mark.parametrize("m,k", [(20, 20), (80, 240), (128, 256), (3, 70)])
def test_probe_layout_round_trip(mode, m, k):
    """A slice laid out as the kernel's `pack` does (128-byte swizzled
    rows in 'bf16'/'split', transposed in 'f32') and read back gives its
    bf16 rounding (hi, and lo = bf16(x - hi)) or, in 'f32', itself; every
    stage's hi and lo blocks are filled once, and chunk q of row r of a
    stage lies at chunk index q ^ (r % 8) of its 128-byte row."""
    plan = _kernels.probe_plan(m, k, 64, 1, mode)
    a = torch.tensor(np.random.default_rng(m * k).random((m, k)),
                     dtype=torch.float32)
    packed = _kernels.probe_layout(a, plan, mode)
    parts = _kernels.probe_unlayout(packed, plan, mode, m, k)
    if mode == "f32":
        assert packed.numel() * 4 == plan.slice_bytes
        assert torch.equal(parts[0], a)
        return
    assert packed.numel() * 2 == plan.slice_bytes
    hi = a.to(torch.bfloat16).float()
    assert torch.equal(parts[0], hi)
    if mode == "split":
        assert torch.equal(parts[1], (a - hi).to(torch.bfloat16).float())
    idx = _kernels._sw128_index(plan)
    blocks = 2 if mode == "split" else 1
    every = torch.cat([idx.reshape(-1) + b * plan.n * 64
                       for b in range(blocks)])
    assert torch.equal(every.sort().values, torch.arange(packed.numel()))
    r, kk = 5, 64 * (plan.chunks - 1) + 8 * 3 + 2
    stage, byte = divmod(2 * int(idx[r, kk]), plan.stage_bytes)
    assert (stage, byte) == (plan.chunks - 1, 128 * r + 16 * (3 ^ 5) + 4)


@pytest.mark.parametrize("mode", tprobe.MODES)
def test_probe_pack_cpu_runs_plain_version_without_counting(mode):
    """`pack` on a CPU tensor runs the plain version of the kernel's
    `pack` (ops/_kernels.py:probe_packed), counts no launch, and gives
    the bytes of each slice's `probe_layout`, one slice after another."""
    m, k, t, nmat = 20, 70, 96, 3
    a = torch.tensor(np.random.default_rng(5).random((nmat * m, k)),
                     dtype=torch.float32)
    before = tprobe.pack.launches
    got = tprobe.pack(a, m, mode, t, nmat)
    assert tprobe.pack.launches == before
    plan = _kernels.probe_plan(m, k, t, 1, mode)
    assert got.dtype == torch.uint8
    assert got.numel() == nmat * plan.slice_bytes
    for j, s in enumerate(got.view(nmat, -1)):
        want = _kernels.probe_layout(a[j * m:(j + 1) * m], plan, mode)
        if mode == "f32":
            assert torch.equal(s.view(torch.float32), want)
        else:
            assert torch.equal(s.view(torch.int16).to(torch.int32) & 0xFFFF,
                               want)


def _emulate(a, x, m, iters, mode, nmat=8, tiles=2):
    """csrc/mxu_probe.cu's decomposition in plain float32 PyTorch: out^T =
    X^T A^T, A's slices read back from `probe_layout`, X padded with zeros
    to the plan's K (and rounded like the kernel's fragment), summed slice
    by slice, a stage's k chunk at a time, reps(j) times each."""
    k = a.shape[1]
    plan = _kernels.probe_plan(m, k, x.shape[1] // tiles, tiles, mode)
    kk = plan.chunks * plan.chunk
    xp = torch.zeros(kk, x.shape[1])
    xp[:k] = x
    if mode == "f32":
        xs = [xp]
    else:
        xh = xp.to(torch.bfloat16).float()
        xs = [xh, (xp - xh).to(torch.bfloat16).float()]
    out_t = torch.zeros(x.shape[1], plan.n)
    for j in range(nmat):
        reps = iters // nmat + (j < iters % nmat)
        if not reps:
            continue
        packed = _kernels.probe_layout(a[j * m:(j + 1) * m], plan, mode)
        parts = _kernels.probe_unlayout(packed, plan, mode, plan.n, kk)
        terms = {"f32": [(0, 0)], "bf16": [(0, 0)],
                 "split": [(0, 0), (1, 0), (0, 1)]}[mode]
        for c in range(plan.chunks):
            ks = slice(c * plan.chunk, (c + 1) * plan.chunk)
            for _ in range(reps):
                for xi, ai in terms:
                    out_t += xs[xi][ks].t() @ parts[ai][:, ks].t()
    return out_t.t()[:m]


@pytest.mark.parametrize("mode", tprobe.MODES)
@pytest.mark.parametrize("m,k,t,iters", [(20, 20, 96, 11), (80, 80, 64, 3),
                                         (13, 70, 40, 0), (128, 240, 16, 9)])
def test_probe_emulation_matches_plain_version(mode, m, k, t, iters):
    """The kernel's decomposition (transposed, padded with zeros, the
    slices' layout and back, summed in its slice and chunk order) equals
    probe_reference to 1e-6 of the largest entry in float32 (the same
    products added in another order)."""
    a, x = tprobe.make(m, k, t, tiles=2, seed=7, device="cpu")
    got = _emulate(a, x, m, iters, mode)
    want = tprobe.probe_reference(a, x, m, iters, mode)
    assert got.shape == want.shape == (m, 2 * t)
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= 1e-6 * scale
