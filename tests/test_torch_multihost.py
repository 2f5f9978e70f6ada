"""Multi-process site sharding on the port (parallel/multihost.py): the
logL, d1 and d2 of 2 processes of 2 CPU shards each (torch.distributed over
gloo) equal those of one process of 4 shards bit for bit (the per-shard
sums are reduced in the same shard order: the reference MPI consumers'
rank invariance), each process's per-site logL is its block of the
one-process run's, and `process_site_block` is JAX's.

Each run spawns fresh processes (tests/torch_mh_worker.py) on a free port,
each with its own timeout: a hung rank fails its test."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from libpll2_tpu.parallel import multihost as jmultihost

from libpll2_tpu_torch.parallel import multihost

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_mh_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_group(nproc, shards, tmp, timeout=120):
    """One process group; the JSON line of each rank, in rank order. Each
    rank writes to files (a full pipe would stall it)."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["OMP_NUM_THREADS"] = "1"
    logs = [(tmp / f"{nproc}_{i}.out", tmp / f"{nproc}_{i}.err")
            for i in range(nproc)]
    procs = []
    for i, (out, err) in enumerate(logs):
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(i), str(nproc), str(port),
                 str(shards), "cpu", "12", "256", str(timeout - 10)],
                stdout=fo, stderr=fe, env=env))
    try:
        for p, (out, err) in zip(procs, logs):
            p.wait(timeout=timeout)
            assert p.returncode == 0, \
                f"worker failed:\n{err.read_text()[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.loads(out.read_text().splitlines()[-1]) for out, _ in logs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process of 4 shards and 2 processes of 2 shards each."""
    tmp = tmp_path_factory.mktemp("mh")
    one, = _run_group(1, 4, tmp)
    return one, _run_group(2, 2, tmp)


def test_two_processes_equal_one(runs):
    one, two = runs
    assert one["mesh"] == 4 and [r["mesh"] for r in two] == [4, 4]
    for rank in two:
        for key in ("lk", "lk2", "d1", "d2"):
            assert rank[key] == one[key], key
    # per-site values: each process returns its own block
    blocks = [r["persite"] for r in two]
    assert [len(b) for b in blocks] == [128, 128]
    np.testing.assert_array_equal(np.concatenate(blocks), one["persite"])


def test_two_processes_gradient_and_sweep_equal_one(runs):
    """The gradient route differentiates through the all_reduce (each
    process's gradient summed over the processes) and the sweep reduces
    each Newton iteration's d1/d2 across them: both equal the one-process
    run's (the gradient to 1e-12: the processes sum it in another
    order)."""
    one, two = runs
    for rank in two:
        assert rank["grad_lk"] == one["grad_lk"]
        np.testing.assert_allclose(rank["grad"], one["grad"], rtol=1e-12,
                                   atol=1e-12)
        assert rank["smooth"] == one["smooth"]


@pytest.mark.parametrize("total,n", [(256, 2), (1000, 8), (7, 1), (12, 3)])
def test_process_site_block_matches_jax(total, n):
    for i in range(n):
        assert multihost.process_site_block(total, n, i) == \
            jmultihost.process_site_block(total, n, i)


def test_process_site_block_refuses_an_uneven_split():
    with pytest.raises(ValueError):
        jmultihost.process_site_block(10, 3, 0)
    with pytest.raises(ValueError):
        multihost.process_site_block(10, 3, 0)


def test_backend_choice():
    """gloo for the CPU and for processes that share a card; NCCL only when
    every process on the host has a card of its own."""
    assert multihost._backend("cpu", 1) == "gloo"
    if not __import__("torch").cuda.is_available():
        assert multihost._backend(None, 1) == "gloo"
    assert multihost.process_site_block(256) == (0, 256)
