"""The port's examples (libpll2_tpu_torch/examples/) against the JAX
package's (examples/*.py), part a: each runs on the CPU (`--device cpu`)
in the same process as its JAX twin, in a temporary working directory, and
their printed lines must agree (tests/torch_example_lines.py: equal text
and integers, each decimal within TOL_LOGL of its own magnitude plus its
printed resolution). Also: every
example module imports without loading jax."""
import json
import re
import subprocess
import sys

import pytest

from torch_example_lines import (REPO, assert_same_lines, jax_example,
                                 same_line)

EXAMPLES = ["export_svg", "flagship_1000", "full_analysis", "heterotachy",
            "load_trees_io", "model_selection", "newton",
            "partial_traversal", "placement", "protein_lg4", "rooted",
            "rooted_tacg", "sharded_multichip", "site_repeats",
            "stepwise_parsimony", "unrooted", "weighted_parsimony"]
F32_EPS = 2.0 ** -23


def _port(name):
    import importlib
    return importlib.import_module(f"libpll2_tpu_torch.examples.{name}")


def _outputs(name, capsys, monkeypatch, tmp_path):
    """(the port's printed text, JAX's), both run in `tmp_path`."""
    monkeypatch.chdir(tmp_path)
    jax_example(name).main()
    want = capsys.readouterr().out
    _port(name).main(["--device", "cpu"])
    got = capsys.readouterr().out
    return got, want


@pytest.mark.parametrize("name", ["partial_traversal", "rooted",
                                  "rooted_tacg", "unrooted", "heterotachy",
                                  "weighted_parsimony", "load_trees_io",
                                  "placement", "stepwise_parsimony"])
def test_example_prints_jax_lines(name, capsys, monkeypatch, tmp_path):
    got, want = _outputs(name, capsys, monkeypatch, tmp_path)
    assert want.strip()
    assert_same_lines(got, want)


def test_newton_prints_jax_lines(capsys, monkeypatch, tmp_path):
    """The example stops once |d1| < 1e-6, which is below float32's
    resolution of d1 at this logL (~1e-2 an ulp): the two packages' noise
    decides how many iterations print. The iterations both print agree:
    d1 is a float32 sum over sites that cancels toward 0 near the optimum,
    so its rounding noise scales with the terms summed, about float32's
    epsilon times |logL|, and not with d1 itself; it is held to that, and
    every other number to `same_number`. The longer run's extra iterations
    repeat the converged logL with |d1| within 1e-5."""
    got, want = _outputs("newton", capsys, monkeypatch, tmp_path)
    g, w = got.splitlines(), want.splitlines()
    n = min(len(g), len(w))
    assert n >= 3

    def field(line, key):
        return float(re.search(rf"{key}=(\S+)", line).group(1))

    for a, b in zip(g[:n], w[:n]):
        drop = re.compile(r"d1=\S+")
        assert same_line(drop.sub("d1=", a), drop.sub("d1=", b)), (a, b)
        d1_noise = F32_EPS * abs(field(b, "logL"))
        assert abs(field(a, "d1") - field(b, "d1")) <= d1_noise, (a, b)

    last = field(g[n - 1], "logL")
    for extra in (g[n:] or w[n:]):
        assert abs(field(extra, "logL") - last) <= 5e-5 * abs(last)
        assert abs(field(extra, "d1")) < 1e-5


def test_export_svg_writes_jax_document(capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    jax_example("export_svg").main()
    want_out = capsys.readouterr().out
    want_svg = (tmp_path / "tree.svg").read_text()
    (tmp_path / "tree.svg").unlink()
    _port("export_svg").main(["--device", "cpu"])
    assert capsys.readouterr().out == want_out
    assert (tmp_path / "tree.svg").read_text() == want_svg
    _port("export_svg").main([str(tmp_path / "given.svg")])
    assert (tmp_path / "given.svg").read_text() == want_svg


@pytest.fixture(scope="module")
def jax_after_import():
    """For each example module, the jax* modules loaded after importing
    it (with the package) in a fresh interpreter."""
    code = (
        "import importlib, json, sys\n"
        "out = {}\n"
        f"for name in {EXAMPLES!r}:\n"
        "    importlib.import_module('libpll2_tpu_torch.examples.' + name)\n"
        "    out[name] = sorted(m for m in sys.modules\n"
        "                       if m == 'jax' or m.startswith('jax.'))\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.splitlines()[-1])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax(name, jax_after_import):
    assert jax_after_import[name] == []
