"""The port's examples against the JAX package's, part b (see
tests/test_torch_examples_a.py): `site_repeats` and `protein_lg4` line by
line with their JAX twins; the slow ones run through their own functions
at a small size on the CPU, never through JAX's flagship (its `main` and
`run` write FLAGSHIP.json and a checkpoint into the repository root):
`full_analysis.run` and `model_selection.ranking` with every stage
present, and `flagship_1000.run` and `main`, whose certified logL must be
within 1e-10 of the CPU float64 evaluation of the same tree (1e-8 of the
checkpoint's, whose newick keeps six decimals of each length)."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import libpll2_tpu_torch as tp
from libpll2_tpu_torch import checkpoint
from libpll2_tpu_torch.examples import (flagship_1000, full_analysis,
                                        model_selection)
from torch_example_lines import REPO, assert_same_lines, jax_example

FLAGSHIP_STAGES = ("compress (", "stepwise starting tree (parsimony ",
                   "first evaluation (logL ",
                   "model + branch optimization (logL ",
                   "streamed SPR rounds (radius 5, ",
                   "streamed NNI rounds (", "final branch smoothing (logL ",
                   "1000 bootstrap replicates (mean ", "checkpoint",
                   "df64 certified eval (logL ")


@pytest.mark.parametrize("name", ["site_repeats", "protein_lg4"])
def test_example_prints_jax_lines(name, capsys, monkeypatch, tmp_path):
    import importlib

    monkeypatch.chdir(tmp_path)
    jax_example(name).main()
    want = capsys.readouterr().out
    importlib.import_module(f"libpll2_tpu_torch.examples.{name}").main(
        ["--device", "cpu"])
    assert_same_lines(capsys.readouterr().out, want)


def test_full_analysis_stages(capsys, tmp_path):
    ckpt = str(tmp_path / "a.ckpt.npz")
    lk = full_analysis.run(seed=42, taxa=12, sites=300, steps=4,
                           replicates=50, ckpt=ckpt, device="cpu")
    out = capsys.readouterr().out
    for stage in ("compressed 300 sites -> ", "stepwise tree: parsimony",
                  "starting logL: ", "(path: fused)",
                  "after model+brlen optimization: ", "(8 model steps)",
                  "after NNI search: ", "final logL: ",
                  "50 bootstrap replicate logLs",
                  f"checkpointed -> {ckpt}"):
        assert stage in out, stage
    part, tree, extras = checkpoint.load(ckpt, device="cpu")
    assert float(extras["best_logl"]) == pytest.approx(lk, rel=1e-12)
    assert np.isfinite(lk) and lk < 0


def test_model_selection_ranking():
    """HKY-simulated data (kappa 5): HKY beats JC by BIC, at 8 taxa x 400
    sites and 40 steps a model."""
    rows = model_selection.ranking(seed=7, taxa=8, sites=400, device="cpu",
                                   models=("JC", "HKY"), steps=40)
    assert [r["model"] for r in rows] == ["HKY", "JC"]
    assert rows[0]["BIC"] < rows[1]["BIC"]
    assert all(np.isfinite(r["logL"]) for r in rows)


def test_flagship_run_certified_logl(capsys, tmp_path):
    stages = []
    info = flagship_1000.run(taxa=16, sites=300, stages=stages,
                             device="cpu", out_dir=str(tmp_path))
    out = capsys.readouterr().out
    assert [s for s, _ in stages] == [line.split("] ", 1)[1].rsplit(
        ": ", 1)[0] for line in out.splitlines()]
    for stage, (label, secs) in zip(FLAGSHIP_STAGES, stages):
        assert label.startswith(stage), (label, stage)
        assert secs >= 0
    assert len(stages) == len(FLAGSHIP_STAGES)
    # the checkpoint's partition in float64 (its model and tips exactly)
    # on the run's own tree (the checkpoint's newick rounds the lengths)
    part64 = checkpoint.load(info["ckpt"], dtype=torch.float64,
                             device="cpu")[0]
    ref = tp.TreeEngine(part64, info["tree"], pallas=False).loglikelihood()
    assert abs(info["df64_logl"] - ref) / abs(ref) < 1e-10
    assert abs(info["logl"] - ref) / abs(ref) < 5e-5
    fp64 = flagship_1000.fp64_check(info["ckpt"])
    assert abs(info["df64_logl"] - fp64) / abs(fp64) < 1e-8
    assert os.path.dirname(info["ckpt"]) == str(tmp_path)


def test_flagship_run_writes_a_temp_dir_by_default(capsys, monkeypatch,
                                                   tmp_path):
    """Without `out_dir`, `run` puts its checkpoint in a new temporary
    directory, never into the working directory."""
    monkeypatch.chdir(tmp_path)
    info = flagship_1000.run(taxa=10, sites=200, device="cpu", depth={
        "rounds": 1, "fused_steps": 2, "round_passes": 0, "final_passes": 0,
        "replicates": 10})
    capsys.readouterr()
    ckpt_dir = os.path.dirname(info["ckpt"])
    try:
        assert os.listdir(tmp_path) == []
        assert os.path.basename(ckpt_dir).startswith("flagship_")
        assert os.listdir(ckpt_dir) == ["flagship.ckpt.npz"]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def test_flagship_main_writes_only_its_output_dir(capsys, tmp_path):
    before = set(os.listdir(REPO))
    out = flagship_1000.main(["--taxa", "12", "--sites", "200", "--device",
                              "cpu", "--out", str(tmp_path)])
    text = capsys.readouterr().out
    assert "--- pass 1" in text and "--- pass 2" in text
    assert set(os.listdir(REPO)) == before
    assert sorted(os.listdir(tmp_path)) == ["flagship.ckpt.npz",
                                           "flagship.json"]
    with open(tmp_path / "flagship.json") as fh:
        saved = json.load(fh)
    assert saved["df64_rel_err"] == out["df64_rel_err"] < 1e-8
    assert len(saved["cold_stages"]) == len(saved["warm_stages"]) == len(
        FLAGSHIP_STAGES)
    assert saved["search_split"][0]["stage"] == "spr"
    assert saved["card"] == "cpu"
