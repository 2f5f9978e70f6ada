"""Multi-process (multi-host) execution entry point, on torch.distributed.

Port of libpll2_tpu/parallel/multihost.py. The reference library is
single-process; its consumers (RAxML-NG / ExaML) scale across machines by
giving each MPI rank a contiguous slice of alignment columns and
all-reducing three scalars: logL, d1, d2 (reference pll.c:1112 pattern
weights, likelihood.c:122 per-site outputs). Here every process owns one
column block of the alignment, split over its own shards, and the
per-shard sums ride one all_reduce a reduction (parallel/sharding.py:psum).

Recipe (each process runs the same script):

    from libpll2_tpu_torch.parallel import multihost, shard_partition
    multihost.initialize()                      # torchrun: args from env
    mesh = multihost.global_mesh()
    lo, hi = multihost.process_site_block(total_sites)
    part = Partition(..., sites=hi - lo, sites_alignment=multihost.owned(mesh))
    # feed each tip sequence[lo:hi]; same model params on every process
    shard_partition(part, mesh)
    engine = TreeEngine(part, tree)
    engine.loglikelihood()                      # identical total on every rank

tests/test_torch_multihost.py runs 1 process with 4 shards against 2
processes with 2 shards each and asserts identical logL/d1/d2.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .sharding import Mesh, make_mesh, owned_shards

# this process's shard devices, from `initialize(local_device_ids=...)`;
# make_mesh() takes them when it is given none
_local_devices: Optional[list] = None


def _backend(platform: Optional[str], local_processes: int) -> str:
    if platform == "cpu" or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_processes \
        else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence] = None,
               platform: Optional[str] = None) -> None:
    """Join this process to the process group (does nothing when
    torch.distributed is already initialised).

    Arguments left out are read from torchrun's environment: MASTER_ADDR
    and MASTER_PORT (the coordinator, "host:port"), WORLD_SIZE, RANK, and
    LOCAL_RANK / LOCAL_WORLD_SIZE for the processes on this host (the JAX
    package reads the TPU metadata there). `local_device_ids` names this
    process's shard devices (CUDA indices or device strings; a device may
    repeat); by default the process takes CUDA device LOCAL_RANK, or the
    CPU with `platform="cpu"`.

    The backend: gloo with `platform="cpu"`, without CUDA, or when the
    processes on a host outnumber its cards (NCCL refuses two ranks on one
    device, and what is reduced is a few scalars a shard); NCCL when every
    process has a card of its own. With a loopback coordinator (every
    process on one host) gloo binds the loopback interface unless
    GLOO_SOCKET_IFNAME says otherwise: it would otherwise take the address
    the host name resolves to, which a host without a network may not
    reach."""
    global _local_devices
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", process_id))
    local_processes = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    if local_device_ids is not None:
        _local_devices = [torch.device("cuda", d) if isinstance(d, int)
                          else torch.device(d) for d in local_device_ids]
    elif platform == "cpu":
        _local_devices = [torch.device("cpu")]
    elif torch.cuda.is_available():
        _local_devices = [torch.device(
            "cuda", local_rank % torch.cuda.device_count())]
    backend = _backend(platform, local_processes)
    if backend == "nccl":
        torch.cuda.set_device(_local_devices[0])
    addr = coordinator_address
    if "://" not in addr:
        addr = "tcp://" + addr
    host = addr.split("://", 1)[1].rsplit(":", 1)[0]
    if backend == "gloo" and (host == "localhost" or host.startswith("127.")):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id)


def global_mesh() -> Mesh:
    """1-D 'sites' mesh over every shard of every process."""
    return make_mesh()


def owned(mesh: Mesh) -> int:
    """Shards this process feeds: the `sites_alignment` a process-local
    partition needs so that its padded width splits evenly over them."""
    return owned_shards(mesh)


def process_site_block(total_sites: int,
                       n_processes: Optional[int] = None,
                       process_index: Optional[int] = None
                       ) -> Tuple[int, int]:
    """[lo, hi) alignment-column block owned by this process (contiguous
    equal blocks in process order, matching the mesh's shard order).
    Requires total_sites divisible by the process count: pad or trim the
    alignment first (the reference's MPI consumers do the same split)."""
    initialized = dist.is_available() and dist.is_initialized()
    n = n_processes if n_processes is not None else (
        dist.get_world_size() if initialized else 1)
    i = process_index if process_index is not None else (
        dist.get_rank() if initialized else 0)
    if total_sites % n:
        raise ValueError(f"{total_sites} sites do not split evenly over "
                         f"{n} processes; pad the alignment to a multiple")
    w = total_sites // n
    return i * w, (i + 1) * w
