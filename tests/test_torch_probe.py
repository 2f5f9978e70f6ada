"""The matrix-unit probe's plain version (libpll2_tpu_torch/tools/mxu_probe.py)
against the JAX probe it ports (tools/mxu_probe.py), on the CPU.

The JAX probe is loaded from its file and its Pallas kernel run in interpret
mode; its `run` returns the sum of the output, which the port's plain
version must match to 1e-5 relative (float32 sums in another order). The
port's modes are also held against a float64 numpy product: 'f32' and
'split' to float32-class error, 'bf16' only to bf16-class error."""
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
