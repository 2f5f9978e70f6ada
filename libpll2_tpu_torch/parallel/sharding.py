"""Site-axis distribution over a mesh of devices, in PyTorch.

Port of libpll2_tpu/parallel/sharding.py. The reference library is
single-process; its consumers (RAxML-NG/ExaML) scale by giving each MPI rank
a slice of alignment columns and reducing per-rank logL/d1/d2 sums
(reference pll.c:1112 pattern weights, likelihood.c:122 per-site outputs).
Every site is independent given the shared P-matrices, so the only
communication the math needs is a few scalar sums.

The JAX package annotates shardings and lets XLA run one SPMD program with
`psum`s. The port keeps its names and their meaning and maps them so:

  * `make_mesh` returns a `Mesh`: the ordered torch devices along
    SITES_AXIS, one per shard (a device may appear more than once: each
    shard holds its own column block, as JAX's virtual CPU devices do), and
    under torch.distributed the process group, this rank and the rank that
    owns each shard;
  * `shard_partition` gives a Partition one column block per shard this
    process owns, on that shard's device (partition.py:`PartitionShard`);
    P-matrices are replicated to every shard;
  * every evaluation launches the port's kernels once per shard, on that
    shard's block, one shard after another, and `psum` reduces the
    per-shard partial sums: moved to the first shard's device and added in
    shard order, so the result does not depend on which shard finished
    first; across processes each rank writes its shards' sums into its
    rows of a [shards, ...] table of zeros, one all_reduce(SUM) fills the
    table on every rank, and every rank adds the rows in the same shard
    order (adding zeros is exact: the sums equal the one-process run's
    bit for bit);
  * `clv_sharding`, `scaler_sharding`, `site_vector_sharding` and
    `replicated` describe which axis is split; they place nothing.
    `put_global` takes a process's local array and returns its blocks, one
    per owned shard, on the shards' devices.

No collective runs inside a kernel.

`ShardedRepeatsEngine` distributes site-repeats partitions: one partition
per shard over its column slice, each with its own classes (repeats are a
compute-saving dedup, local to each rank's columns).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from ..ops.fused import FUSED_MAX_STATES

__all__ = ["SITES_AXIS", "Mesh", "NamedSharding", "make_mesh",
           "shard_partition", "clv_sharding", "scaler_sharding",
           "site_vector_sharding", "replicated", "ShardedRepeatsEngine",
           "put_global", "is_multiprocess", "owned_shards", "psum"]

SITES_AXIS = "sites"


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class Mesh:
    """A 1-D mesh over the site axis.

    `devices` are the shards' torch devices in shard order (every
    process's shards, process 0's first), `owners` the rank that owns each
    shard, `group` the torch.distributed process group (None in one
    process). Shard k of a process-local partition is its k-th owned
    shard."""

    axis_names = (SITES_AXIS,)

    def __init__(self, devices: Sequence, owners: Optional[Sequence[int]]
                 = None, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.owners = tuple(owners) if owners is not None \
            else (0,) * len(self.devices)
        if len(self.owners) != len(self.devices):
            raise ValueError("one owner a device")
        self.group = group
        self.rank = _rank() if group is not None else 0
        self.world_size = (dist.get_world_size(group) if group is not None
                           else 1)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_devices(self) -> tuple:
        """The devices of the shards this process owns, in shard order."""
        return tuple(d for d, r in zip(self.devices, self.owners)
                     if r == self.rank)

    @property
    def first_owned(self) -> int:
        """The mesh index of this process's first shard."""
        return self.owners.index(self.rank)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, owners="
                f"{list(self.owners)}, axis={SITES_AXIS!r})")


def _default_devices() -> list:
    """This process's devices when `make_mesh` is given none: those that
    multihost.initialize recorded, else every visible CUDA device. Without
    a CUDA device it raises: the CPU runs only when named."""
    from . import multihost

    if multihost._local_devices is not None:
        return list(multihost._local_devices)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("make_mesh() needs a CUDA device, and none is "
                           "available (pass devices=['cpu', ...] to shard "
                           "on the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the site axis (the library's data-parallel axis).

    `devices` lists this process's shards' devices and may name one device
    more than once (["cpu"] * 4, ["cuda:0"] * 4); by default every visible
    CUDA device. With `n_devices` the mesh has that many shards: the first
    `n_devices` devices, or, where there are fewer, the devices in turn
    again (4 shards on one card are ["cuda:0"] * 4). Under torch.distributed
    every rank calls it, and the mesh spans every rank's shards, rank 0's
    first."""
    from ..partition import resolve_device

    if devices is None:
        devices = _default_devices()
    if n_devices is not None:
        devices = [devices[i % len(devices)] for i in range(n_devices)]
    local = [resolve_device(d) for d in devices]
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(local)
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, [str(d) for d in local])
    devs = [d for ds in gathered for d in ds]
    owners = [r for r, ds in enumerate(gathered) for _ in ds]
    return Mesh(devs, owners, group=dist.group.WORLD)


class NamedSharding:
    """Which axis of an array a mesh splits: `spec` names SITES_AXIS at the
    split axis (JAX's PartitionSpec), or nothing when the array is
    replicated. A description: it places nothing."""

    def __init__(self, mesh: Mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def axis(self) -> Optional[int]:
        return self.spec.index(SITES_AXIS) if SITES_AXIS in self.spec \
            else None


def clv_sharding(mesh: Mesh) -> NamedSharding:
    """CLV layout is [node, rate, state, site]: the site axis is split."""
    return NamedSharding(mesh, (None, None, None, SITES_AXIS))


def scaler_sharding(mesh: Mesh, rate_scalers: bool) -> NamedSharding:
    spec = (None, None, SITES_AXIS) if rate_scalers else (None, SITES_AXIS)
    return NamedSharding(mesh, spec)


def site_vector_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, (SITES_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh spans shards owned by other processes."""
    return any(r != mesh.rank for r in mesh.owners)


def owned_shards(mesh: Mesh) -> int:
    """How many of the mesh's shards THIS process feeds: all of them in one
    process, its own under several."""
    n = sum(1 for r in mesh.owners if r == mesh.rank)
    return n if n else mesh.size


def put_global(x, mesh: Mesh, spec) -> list:
    """`x`, this process's array (its contiguous column block of the
    global array for a split spec, the whole array for a replicated one),
    as one tensor per owned shard on the shard's device: its equal block of
    the split axis, or a replica. `spec` is a NamedSharding or its spec
    tuple."""
    axis = (spec if isinstance(spec, NamedSharding)
            else NamedSharding(mesh, spec)).axis
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    devs = mesh.local_devices
    if axis is None:
        return [t.to(d) for d in devs]
    width = t.shape[axis]
    if width % len(devs):
        raise ValueError(f"axis {axis} of width {width} does not split over "
                         f"the {len(devs)} shards this process owns")
    return [b.contiguous().to(d)
            for b, d in zip(torch.chunk(t, len(devs), dim=axis), devs)]


class _AllReduce(torch.autograd.Function):
    """all_reduce(SUM) of a table whose gradient is the reduced table's:
    every rank computes the same result from the reduced table, so a
    rank's own rows enter it with the weight one."""

    @staticmethod
    def forward(ctx, table, group):
        out = table.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReplicatedInput(torch.autograd.Function):
    """The identity, whose gradient is summed over the processes."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def replicated_input(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """`x`, an input every process holds the same copy of, as read by its
    shards: under several processes its gradient is summed over the
    processes (each sees its own shards' part), as JAX's transpose of a
    replicated input's broadcast does; else (no mesh, or one process) `x`
    itself."""
    if mesh is None or not is_multiprocess(mesh):
        return x
    return _ReplicatedInput.apply(x, mesh.group)


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The sum over the mesh of per-shard partial sums: `parts` holds one
    tensor a shard this process owns (any one shape), in shard order. They
    are moved to the first owned shard's device and added in shard order;
    across processes one all_reduce(SUM) of a [mesh.size, ...] table, in
    which each rank filled its own shards' rows and left zeros elsewhere,
    gives every rank every shard's sums first (gloo reduces on the CPU,
    NCCL on the rank's card). The sum is differentiable (the gradient
    route, optimize.py:make_loglikelihood_fn)."""
    dev = mesh.local_devices[0]
    parts = [p.to(dev) for p in parts]
    if is_multiprocess(mesh):
        nccl = dist.get_backend(mesh.group) == "nccl"
        table = torch.zeros((mesh.size,) + tuple(parts[0].shape),
                            dtype=parts[0].dtype,
                            device=dev if nccl else "cpu")
        first = mesh.first_owned
        table[first:first + len(parts)] = torch.stack(parts).to(
            table.device)
        table = _AllReduce.apply(table, mesh.group)
        parts = list(table.to(dev).unbind(0))
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def shard_partition(partition, mesh: Mesh) -> None:
    """Give a Partition one column block per shard this process owns, in
    place: each block's dense buffers on its shard's device, P-matrices
    replicated (they are [edges, rates, states, states], independent of
    sites, and every shard needs all of them).

    Requires `sites_padded % owned_shards(mesh) == 0`; create the partition
    with `sites_alignment=owned_shards(mesh)` (or a multiple) to guarantee
    it."""
    n = owned_shards(mesh)
    if partition.repeats is not None:
        # class identity is a per-shard property: the pooled class-column
        # layout has no site axis to split
        raise ValueError(
            "site-repeats partitions cannot be sharded in place (the "
            "pooled class-column layout has no global site axis): build "
            "one per-device partition per column slice and run them "
            "through ShardedRepeatsEngine")
    if partition.sites_padded % n:
        raise ValueError(
            f"sites_padded={partition.sites_padded} not divisible by the "
            f"{n} mesh shards this process owns; create the partition "
            f"with sites_alignment={n}")
    if is_multiprocess(mesh) and partition.asc_extra:
        raise ValueError("asc bias is not supported under multi-process "
                         "site sharding (synthetic columns would be "
                         "duplicated per rank)")
    partition._shard(mesh)


class ShardedRepeatsEngine:
    """Site data-parallelism for site-repeats partitions.

    Each shard owns a contiguous column slice with its OWN class table and
    pooled class-column storage (`parts`: one site-repeats Partition per
    shard this process owns, on that shard's device, with equal widths and
    the same model). Every call runs each shard's engine on its slice and
    `psum`s the sums: 'repeats-dense-fused' (the DNA or rows fused kernel
    on the shard's dense tip codes; the pooled storage keeps its memory
    win) or the pooled path ('pool-pallas', the pool kernel on the shard's
    class columns; the plain pooled path with `pallas=False`).

    The asc corrections compose shard by shard before the reduction: each
    shard partition carries its own synthetic columns, Lewis subtracts its
    local weight sum times log(1 - base), where `base` is the same on every
    shard, and the Felsenstein/Stamatakis terms are linear in the asc
    weights set on each shard (set the global weights once across the
    shards, not repeated).

    The per-shard tables need no common shape (the JAX package's
    `pack_repeats_canonical` gives XLA one program; the port compiles
    nothing per shape). `loglikelihood_loop` and `newton_loop` run k
    chained iterations as TreeEngine's do (engine.py:choose_loop: on one
    card captured once in a CUDA graph and replayed; across processes or
    cards an eager loop). The batched search rounds drive it like a
    TreeEngine (`TreeSearch(None, tree, engine=eng)`), on the dense-fused
    path only."""

    def __init__(self, tree, parts, mesh: Mesh, params_index: int = 0,
                 pallas: Optional[bool] = None, interpret: bool = False,
                 dense_fused: Optional[bool] = None, mxu: str = "split"):
        from ..engine import TreeEngine, _Shards

        n = owned_shards(mesh)
        if len(parts) != n:
            raise ValueError(f"need {n} shard partitions (one per device "
                             f"this process owns), got {len(parts)}")
        p0 = parts[0]
        for p, dev in zip(parts, mesh.local_devices):
            if p.repeats is None:
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    "every shard partition needs site_repeats=True (and "
                    f">= {C.REPEATS_MIN_SITES} sites per shard)")
            if p.sites != p0.sites:
                raise ValueError("shard partitions must have equal widths")
            if p.asc_bias.value != p0.asc_bias.value or \
                    p.asc_extra != p0.asc_extra:
                raise C.PllError(C.ERROR_PARAM_INVALID,
                                 "every shard must carry the same asc "
                                 "configuration")
            if p.device != dev:
                raise ValueError(f"a shard partition lies on {p.device}, "
                                 f"its mesh shard on {dev}")
        self.mesh = mesh
        self.parts = list(parts)
        self.tree = tree
        self.dtype = p0.dtype
        self.rate_scalers = p0.rate_scalers
        self.asc_type = p0.asc_bias.value
        self.n_real = p0.sites if p0.asc_extra else -1
        self.mxu = mxu
        # the pool kernel runs per-rate scalers too (ROADMAP, Rules of the
        # port); `interpret` named JAX's Pallas interpret mode, which the
        # wrappers take by themselves for CPU tensors
        del interpret
        self.use_pallas = pallas is not False
        want_dense = dense_fused is not False and pallas is not False
        dense_ok = (p0.dtype == torch.float32
                    and p0.states <= FUSED_MAX_STATES
                    and (not p0.rate_scalers or p0.rate_cats <= 8)
                    and all(bool(np.all(p._tips_set)) for p in parts))
        if dense_fused and not dense_ok:
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                f"dense_fused requires float32 shards of at most "
                f"{FUSED_MAX_STATES} states with every tip set from state "
                f"codes")
        mode = "auto" if (want_dense and dense_ok) else (
            "pool" if self.use_pallas else False)
        engines = [TreeEngine(p, tree, params_index=params_index,
                              pallas=mode, mxu=mxu) for p in parts]
        self.dense_fused = all(e.repeats_dense_fused for e in engines)
        if dense_fused and not self.dense_fused:
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                "dense_fused requested but the traversal cannot be "
                "packed for the fused kernel")
        if not self.dense_fused and mode == "auto":
            # an op list the fused kernel refuses: every shard pooled
            engines = [TreeEngine(p, tree, params_index=params_index,
                                  pallas="pool", mxu=mxu) for p in parts]
        if not self.dense_fused and is_multiprocess(mesh):
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                "the pooled compute path is single-process only (as in "
                "libpll2_tpu); multi-process sharded repeats run "
                "dense-fused (float32 shards, tips from state codes)")
        self._shards = _Shards(engines, mesh)
        # no raw tip-CLV rows on the shards (state codes only); the native
        # candidate builder reads this
        self._packed_ctips = frozenset()
        self.branches = engines[0].branches

    @property
    def engines(self) -> list:
        """The per-shard TreeEngines, in shard order."""
        return self._shards.engines

    @property
    def partition(self):
        """Structural stand-in for the TreeSearch/native-builder hooks
        (prob_matrices, tips, ctip rows): every shard shares them."""
        return self.parts[0]

    @property
    def use_fused(self) -> bool:
        return self.dense_fused

    @property
    def shared_unit(self):
        """The unit whose candidate packing serves every shard (the search
        builds one table for all)."""
        return self

    @property
    def execution_path(self) -> str:
        return self.engines[0].execution_path

    def _units(self) -> list:
        """The engines that hold the columns (the loops' units)."""
        return self.engines

    def _evaluate(self, scatter: bool = True):
        """(total, per-site, each shard's root rows) of one evaluation."""
        return self._shards.evaluate(self.branches, scatter)

    def _newton_once(self):
        """Evaluate and one Newton update: (total, d1, d2, new branches,
        each shard's root rows)."""
        return self._shards.newton(self.branches)

    def loglikelihood(self) -> float:
        total, _, _ = self._evaluate()
        return float(total)

    def newton_step(self):
        """Evaluate and one Newton update of the root branch across the
        shards (summed d1/d2, one update applied on every shard); returns
        (logL, d1, d2)."""
        total, d1, d2, self.branches, _ = self._newton_once()
        return float(total), float(d1), float(d2)

    def loglikelihood_loop(self, k: int) -> float:
        """The sum of k chained sharded evaluations (libpll2_tpu/parallel/
        sharding.py:693-709), each shard's launches and the psum in every
        iteration; 0.0 for k <= 0. Runs as TreeEngine.loglikelihood_loop
        does: on one card captured once in a CUDA graph and replayed."""
        from ..engine import chained_loglikelihood

        return chained_loglikelihood(self, k)

    def newton_loop(self, k: int):
        """k chained Newton iterations on the root branch across the
        shards (summed d1/d2, one update applied on every shard): the last
        iteration's (logL, d1, d2), the branches left updated; (0.0, 0.0,
        0.0) for k <= 0."""
        from ..engine import chained_newton

        return chained_newton(self, k)

    def _require_fused(self):
        if not self.dense_fused:
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                "topology search over a ShardedRepeatsEngine needs the "
                "dense-fused path (float32 shards, every tip from state "
                "codes)")

    def set_topology(self, tree) -> None:
        """Rebind to a new topology of the same size (tip codes are
        topology-independent)."""
        self._require_fused()
        for e in self.engines:
            e.set_topology(tree)
        self.branches = self.engines[0].branches
        self.tree = tree

    def pack_candidate(self, vroot):
        """(table, blens, root_info, n_slots) for the current topology
        rooted at `vroot` (TreeEngine.pack_candidate), or None off the
        dense-fused path."""
        if not self.dense_fused:
            return None
        return self.engines[0].pack_candidate(vroot)

    def evaluate_packed_arrays(self, tables, blens, roots,
                               n_slots: int) -> np.ndarray:
        """logL of stacked fused candidates, tables [K, n_ops+1, 8], blens
        [K, E], roots [K, 5]: a launch of the candidate form a shard a
        chunk, then one psum of the [K] sums. Exactly K scores."""
        self._require_fused()
        k = len(tables)
        if k == 0:
            return np.zeros(0)
        return self._shards.score_fused(
            tables, blens, roots, np.full(k, int(n_slots))).cpu().numpy()

    def evaluate_packed(self, packed) -> np.ndarray:
        """logL of [(table, blens, root_info, n_slots)] candidates from
        pack_candidate."""
        self._require_fused()
        if not packed:
            return np.zeros(0)
        tables, blens, roots, n_slots = zip(*packed)
        return self._shards.score_fused(
            np.stack(tables), np.stack(blens), np.asarray(roots),
            np.asarray(n_slots)).cpu().numpy()
