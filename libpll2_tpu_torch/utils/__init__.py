"""Utilities of the port (libpll2_tpu/utils/, ROADMAP A9): the sequence
simulator and the glibc-compatible RNG behind the stepwise tip order, the
hardware probe (`probe`, `dump`), the debug printers (`show_pmatrix`,
`show_clv`, `show_tree_ascii`) and the profiling hooks (`trace`,
`annotate`, `time_fn`) on torch.profiler."""
from .hardware import HardwareInfo, dump, probe
from .output import show_clv, show_pmatrix, show_tree_ascii
from .profiling import annotate, time_fn, trace
from .rng import RAND_MAX, GlibcRandom, create_shuffled
from .simulate import simulate_alignment

__all__ = ["GlibcRandom", "create_shuffled", "RAND_MAX",
           "simulate_alignment", "probe", "dump", "HardwareInfo",
           "show_pmatrix", "show_clv", "show_tree_ascii",
           "trace", "annotate", "time_fn"]
