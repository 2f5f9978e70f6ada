"""Utilities of the port. This slice carries the sequence simulator
(libpll2_tpu/utils/simulate.py); the hardware probe, printers, RNG and
profiling hooks come with ROADMAP A14."""
from .simulate import simulate_alignment

__all__ = ["simulate_alignment"]
