"""Named substitution models.

Port of libpll2_tpu/models/__init__.py (the same numpy code). Registry over
the empirical amino-acid replacement matrices the reference exports as
global constant arrays (reference: libpll-2 src/pll.h:546-598,
src/maps.c:226-1286), plus the LG4M/LG4X 4-matrix mixtures (one rate matrix
+ frequency vector per Gamma category). `load_mixture_model` installs a
mixture into the partition as the JAX package does; evaluating it needs
per-category params_indices, which come with the step-by-step Partition API
(ROADMAP A3).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from . import aa_data

AA_MODEL_NAMES = [
    "dayhoff", "lg", "dcmut", "jtt", "mtrev", "wag", "rtrev", "cprev", "vt",
    "blosum62", "mtmam", "mtart", "mtzoa", "pmb", "hivb", "hivw", "jttdcmut",
    "flu", "stmtrev", "den",
]
MIXTURE_MODEL_NAMES = ["lg4m", "lg4x"]


def aa_model(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """(rates[190], freqs[20]) for a named empirical AA model."""
    key = name.lower().replace("-", "").replace("_", "")
    if key == "jttdcmut" or key == "jttdc":
        key = "jttdcmut"
    if key not in AA_MODEL_NAMES:
        raise KeyError(f"unknown AA model {name!r}; available: "
                       f"{', '.join(AA_MODEL_NAMES)}")
    return (getattr(aa_data, f"AA_RATES_{key.upper()}").copy(),
            getattr(aa_data, f"AA_FREQS_{key.upper()}").copy())


def mixture_model(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """(rates[4,190], freqs[4,20]) for LG4M / LG4X."""
    key = name.lower()
    if key not in MIXTURE_MODEL_NAMES:
        raise KeyError(f"unknown mixture model {name!r}")
    return (getattr(aa_data, f"AA_RATES_{key.upper()}").copy(),
            getattr(aa_data, f"AA_FREQS_{key.upper()}").copy())


def load_aa_model(partition, name: str, params_index: int = 0,
                  model_freqs: bool = True) -> None:
    """Install a named AA model into one rate-matrix slot of a partition."""
    rates, freqs = aa_model(name)
    partition.set_subst_params(params_index, rates)
    if model_freqs:
        partition.set_frequencies(params_index, freqs)


def load_mixture_model(partition, name: str) -> None:
    """Install LG4M/LG4X: matrix k into params slot k (k = Gamma category).

    The partition must have rate_matrices == 4; evaluate with
    params_indices = [0, 1, 2, 3] (reference: examples/lg4/lg4.c:298-360).
    """
    rates, freqs = mixture_model(name)
    if partition.rate_matrices < rates.shape[0]:
        raise ValueError(
            f"{name} needs {rates.shape[0]} rate matrices, partition has "
            f"{partition.rate_matrices}")
    for k in range(rates.shape[0]):
        partition.set_subst_params(k, rates[k])
        partition.set_frequencies(k, freqs[k])


__all__ = ["AA_MODEL_NAMES", "MIXTURE_MODEL_NAMES", "aa_model",
           "mixture_model", "load_aa_model", "load_mixture_model"]
