"""The JAX package's examples (examples/*.py) on the port, one module each,
run from anywhere as

    python -m libpll2_tpu_torch.examples.<name> [--device cpu|cuda] ...

Each has a `main(argv=None)` that parses its arguments (`--device`
defaults to "cuda", as `Partition` does) and prints the JAX example's
lines. `flagship_1000` is the end-to-end analysis at 1000 taxa, with the
certified final evaluation; `sharded_multichip` waits for the port's
`parallel` module (ROADMAP A8). The examples that write files write them
into the working directory unless given a path (`export_svg`,
`full_analysis --ckpt`); `flagship_1000` writes into `--out`, a new
temporary directory by default."""
