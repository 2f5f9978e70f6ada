"""One process of a multi-process run of the port (not a test module):

    python torch_mh_worker.py <rank> <processes> <port> <shards> <device>
        [<taxa> <sites> [<deadline s>]]

It joins the process group through libpll2_tpu_torch.parallel.multihost
(gloo on the CPU, or when the processes share one card), builds its column
block of a deterministic problem (a seeded tree and an alignment simulated
on it, GTR+G4, float32 on a card and float64 on the CPU; the same in every
process), shards it over `shards` shards on `device`, and prints one JSON
line: logL, one Newton step's logL/d1/d2, the per-site logL of its block,
the fused kernel's launches and the median host-clock ms of
loglikelihood(), and on the CPU the gradient route's logL and gradient
and the logL after one pass of newton_smooth_all. A process still running after the deadline (100 s by
default) writes every thread's stack to stderr and exits. With one process it is the reference run
that tests/test_torch_multihost.py and chip_smoke.py compare with. Imports
no jax."""
import faulthandler
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv):
    rank, world, port, shards = (int(a) for a in argv[:4])
    device = argv[4]
    taxa, sites = (int(a) for a in argv[5:7]) if len(argv) > 5 else (12, 256)
    faulthandler.dump_traceback_later(float(argv[7]) if len(argv) > 7
                                      else 100.0, exit=True)

    import torch
    import torch.distributed as dist

    import libpll2_tpu_torch as tp
    from libpll2_tpu_torch.io import maps
    from libpll2_tpu_torch.ops import fused as ops_fused
    from libpll2_tpu_torch.parallel import (make_mesh, multihost,
                                            shard_partition)
    from libpll2_tpu_torch.trees import random_utree
    from libpll2_tpu_torch.utils import simulate_alignment

    if world > 1:
        multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                             num_processes=world, process_id=rank,
                             local_device_ids=[device] * shards,
                             platform="cpu" if device == "cpu" else None)
    mesh = make_mesh(devices=[device] * shards)
    labels = [f"t{i}" for i in range(taxa)]
    tree = random_utree(labels, seed=7)
    headers, seqs = simulate_alignment(tree, sites, [0.3, 0.2, 0.2, 0.3],
                                       [1.2, 3.0, 0.8, 1.1, 2.6, 1.0],
                                       alpha=0.6, seed=7)
    by = dict(zip(headers, seqs))
    lo, hi = multihost.process_site_block(sites)
    dtype = torch.float64 if device == "cpu" else torch.float32
    part = tp.Partition(tree.tip_count, tree.inner_count, 4, hi - lo, 1,
                        tree.edge_count, 4, tree.inner_count, device=device,
                        dtype=dtype, sites_alignment=multihost.owned(mesh))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label][lo:hi])
    part.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
    part.set_subst_params(0, [1.2, 3.0, 0.8, 1.1, 2.6, 1.0])
    part.set_category_rates(tp.compute_gamma_cats(0.6, 4))
    shard_partition(part, mesh)
    eng = tp.TreeEngine(part, tree)
    ops_fused.fused_traversal.launches = 0
    lk, per = eng.loglikelihood_persite()
    lk2, d1, d2 = eng.newton_step()
    launches = ops_fused.fused_traversal.launches
    times = []
    for _ in range(7):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.loglikelihood()
        times.append((time.perf_counter() - t0) * 1e3)
    plain = {}
    if device == "cpu":
        # the plain paths' consumers: the gradient route's value and
        # gradient, then one pass of the all-branches sweep
        from libpll2_tpu_torch.optimize import (make_loglikelihood_fn,
                                                newton_smooth_all)

        eng = tp.TreeEngine(part, tree, pallas=False)
        fn, params = make_loglikelihood_fn(eng, ("branches",))
        x = params["log_branches"].clone().requires_grad_(True)
        val = fn({"log_branches": x})
        val.backward()
        plain = {"grad_lk": float(val.detach()), "grad": x.grad.tolist(),
                 "smooth": newton_smooth_all(eng, tree, passes=1,
                                             iterations=2)}
    print(json.dumps({"rank": rank, "processes": world, "shards": shards,
                      "mesh": mesh.size, "lo": lo, "hi": hi, "lk": lk,
                      "lk2": lk2, "d1": d1, "d2": d2,
                      "persite": [float(x) for x in per[:hi - lo]],
                      "fused_launches": launches,
                      "ms": statistics.median(times[2:]), **plain}),
          flush=True)
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
