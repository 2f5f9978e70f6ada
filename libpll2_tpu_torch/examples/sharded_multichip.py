"""Site-sharded evaluation over a mesh of devices (the multi-chip path;
port of examples/sharded_multichip.py). The reference's consumers do this
with MPI ranks; here each shard of the mesh holds a column block, the
kernels run once a shard, and the per-shard logL, d1 and d2 are summed.

`--shards N` splits the sites over N shards (default: one a visible CUDA
device), in turn over the visible cards (`make_mesh(n_devices=N)`) or all
on the CPU with `--device cpu`; the sites are 1024 a shard."""
from __future__ import annotations

import torch

from .. import Partition, TreeEngine, compute_gamma_cats
from ..io import maps
from ..parallel import make_mesh, shard_partition
from ..trees import random_utree
from ..utils import simulate_alignment
from ._cli import parser


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of the site mesh (default: every visible "
                    "CUDA device)")
    args = ap.parse_args(argv)
    on_cpu = torch.device(args.device).type == "cpu"
    mesh = make_mesh(n_devices=args.shards or (1 if on_cpu else None),
                     devices=["cpu"] if on_cpu else None)
    devices = mesh.local_devices
    n_dev = len(devices)
    kind = "cpu" if on_cpu else torch.cuda.get_device_name(devices[0])
    print(f"devices: {n_dev} x {kind}")

    tree = random_utree([f"t{i}" for i in range(16)], seed=2)
    sites = 1024 * n_dev
    headers, seqs = simulate_alignment(tree, sites, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=0.9,
                                       seed=2)
    part = Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                     tree.edge_count, 4, tree.inner_count,
                     sites_alignment=n_dev, device=devices[0])
    by_label = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    part.set_category_rates(compute_gamma_cats(0.9, 4))

    shard_partition(part, mesh)            # CLVs split on the site axis
    engine = TreeEngine(part, tree)
    print(f"sharded logL: {engine.loglikelihood():.6f}")
    lk, d1, d2 = engine.newton_step()
    print(f"newton step:  logL={lk:.6f} d1={d1:+.3e} d2={d2:+.3e}")


if __name__ == "__main__":
    main()
