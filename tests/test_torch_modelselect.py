"""Model selection in the port (libpll2_tpu_torch.modelselect) against
libpll2_tpu's on the CPU: the same alignment (simulated once) on each
package's tree of one seed, float64. The ranking must be the same and each
model's logL and alpha within 1e-6 relative: the fits run the same Adam
steps and Brent trials and differ in summation order, and at HKY's start
(a repeated eigenvalue: equal frequencies) in the gradient's direction
that splits it (ROADMAP C), which the later steps carry only to ~1e-10."""
import numpy as np
import pytest
import torch

from libpll2_tpu import modelselect as jms
from libpll2_tpu.trees import random_utree as j_random_utree

from libpll2_tpu_torch import modelselect as tms
from libpll2_tpu_torch.models import aa_model
from libpll2_tpu_torch.trees import random_utree
from libpll2_tpu_torch.utils import simulate_alignment

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_ranking(jrows, trows):
    assert [r["model"] for r in trows] == [r["model"] for r in jrows]
    for j, t in zip(jrows, trows):
        for key in ("logL", "AIC", "AICc", "BIC"):
            assert t[key] == pytest.approx(j[key], rel=1e-6), (t["model"],
                                                               key)
        assert t["k"] == j["k"]
        if j["alpha"] is not None:
            assert t["alpha"] == pytest.approx(j["alpha"], rel=1e-6)


def test_select_dna_model_matches_jax():
    """10 x 300 DNA simulated with kappa 6 and skewed frequencies: JC, HKY
    and GTR fitted by both packages; the fitted HKY's kappa and
    frequencies too."""
    labels = [f"t{i}" for i in range(10)]
    headers, seqs = simulate_alignment(random_utree(labels, seed=21), 300,
                                       [0.4, 0.15, 0.15, 0.3],
                                       [1.0, 6.0, 1.0, 1.0, 6.0, 1.0],
                                       alpha=0.8, seed=21)
    by = dict(zip(headers, seqs))
    kw = dict(rate_cats=4, models=("JC", "HKY", "GTR"), steps=30)
    jrows = jms.select_dna_model(j_random_utree(labels, seed=21), by, **kw)
    trows = tms.select_dna_model(random_utree(labels, seed=21), by,
                                 device=CPU, dtype=torch.float64, **kw)
    _same_ranking(jrows, trows)
    assert trows[-1]["model"] == "JC"
    j_hky = next(r for r in jrows if r["model"] == "HKY")
    t_hky = next(r for r in trows if r["model"] == "HKY")
    np.testing.assert_allclose(t_hky["subst"], j_hky["subst"], rtol=1e-6)
    np.testing.assert_allclose(t_hky["freqs"], j_hky["freqs"], rtol=1e-6)
    assert t_hky["subst"][1] / t_hky["subst"][0] > 2.5
    with pytest.raises(ValueError):
        tms.select_dna_model(random_utree(labels, seed=21), by,
                             criterion="LRT", device=CPU)


def test_select_aa_model_matches_jax():
    """6 x 100 amino acids simulated under LG: LG and WAG ranked by both
    packages (branches by Adam, alpha by Brent)."""
    labels = [f"t{i}" for i in range(6)]
    rates, freqs = aa_model("lg")
    headers, seqs = simulate_alignment(random_utree(labels, seed=31), 100,
                                       freqs, rates, alpha=1.0, seed=31)
    by = dict(zip(headers, seqs))
    kw = dict(rate_cats=4, models=("lg", "wag"), steps=15)
    jrows = jms.select_aa_model(j_random_utree(labels, seed=31), by, **kw)
    trows = tms.select_aa_model(random_utree(labels, seed=31), by,
                                device=CPU, dtype=torch.float64, **kw)
    _same_ranking(jrows, trows)
