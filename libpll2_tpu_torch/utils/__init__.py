"""Utilities of the port: the sequence simulator
(libpll2_tpu/utils/simulate.py) and the glibc-compatible RNG behind the
stepwise tip order (libpll2_tpu/utils/rng.py); the hardware probe, printers
and profiling hooks come with ROADMAP A14."""
from .rng import RAND_MAX, GlibcRandom, create_shuffled
from .simulate import simulate_alignment

__all__ = ["GlibcRandom", "create_shuffled", "RAND_MAX",
           "simulate_alignment"]
