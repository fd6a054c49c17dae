"""Rank meshes over ``torch.distributed`` and their rank-ordered reductions.

Port of ``simpleslam_tpu/parallel/mesh.py``. A ``Mesh`` is the process
group's ranks laid out on one or two named axes (two names factor the world
as evenly as possible, e.g. 8 -> 2 x 4); each axis has a process group of
its own, so collectives issued on one axis never interleave with another's.

Reductions are never ``all_reduce``: gloo's halving-doubling and NCCL's
trees may sum in different orders on different ranks, and one ulp of
difference forks the replicated state. ``Axis.gather_sum`` gathers every
rank's partial and sums them in rank order on every rank;
``Axis.gather_max`` gathers and takes the max. With one rank on the axis
both are the identity.

The collective backend follows one rule (``choose_backend``): NCCL when
every rank has a card of its own, gloo when ranks share a card or run on
the CPU. gloo gathers host tensors only, so a CUDA payload on a gloo group
is staged through the host explicitly, and those copies are counted
(``STATS``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

# collectives issued by this process and what they cost: calls and wall
# seconds of every gather (host staging included), and the host-staged
# copies of CUDA payloads on gloo groups (calls, bytes each way)
STATS = {"collectives": 0, "collective_s": 0.0, "staged_calls": 0,
         "staged_bytes": 0}
_stats_lock = threading.Lock()


def reset_stats() -> None:
    with _stats_lock:
        STATS.update(collectives=0, collective_s=0.0, staged_calls=0,
                     staged_bytes=0)


def choose_backend(world_size: int, device_type: str, n_cards: int) -> str:
    """The collective backend: "nccl" when every rank has a card of its own
    (CUDA ranks, ``world_size <= n_cards``), else "gloo" (CPU ranks, or
    ranks that share a card: NCCL refuses two ranks on one GPU)."""
    if device_type == "cuda" and 0 < world_size <= n_cards:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int, world_size: int) -> torch.device:
    """The device of a rank: ``cuda:{local_rank}`` when it has a card of its
    own, the cards shared round-robin otherwise, or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    n_cards = torch.cuda.device_count()
    if n_cards < 1:
        raise RuntimeError("a CUDA rank needs a CUDA device")
    return torch.device("cuda", local_rank % n_cards)


NO_GROUP_MESSAGE = (
    "tpu.mesh_devices = {n} needs an initialised torch.distributed process "
    "group of world size {n} (one process per rank): launch the ranks with "
    "simpleslam_tpu_torch.parallel.multihost.run_hosts, or with torchrun "
    "--nproc-per-node {n} (the CLI does either for you)")


class Axis:
    """One named axis of a mesh, as this rank sees it: what the ops'
    reduction hooks take."""

    def __init__(self, name: str, size: int, index: int,
                 group: Optional[dist.ProcessGroup], backend: str):
        self.name = name
        self.size = size      # ranks on the axis
        self.index = index    # this rank's position on it
        self.group = group
        self.backend = backend

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's ``x`` in axis order, on ``x``'s
        device. A CUDA tensor on a gloo group goes through the host."""
        if self.size == 1:
            return x[None]
        t0 = time.perf_counter()
        x = x.contiguous()
        staged = x.is_cuda and self.backend == "gloo"
        src = x.cpu() if staged else x
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.stack(parts)
        if staged:
            out = out.to(x.device)
        with _stats_lock:
            STATS["collectives"] += 1
            STATS["collective_s"] += time.perf_counter() - t0
            if staged:
                STATS["staged_calls"] += 1
                STATS["staged_bytes"] += src.numel() * src.element_size() \
                    * (1 + self.size)
        return out

    def gather_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The psum: every rank's ``x`` gathered and summed in rank order
        (the identity with one rank)."""
        if self.size == 1:
            return x
        parts = self.all_gather(x)
        acc = parts[0]
        for r in range(1, self.size):
            acc = acc + parts[r]
        return acc

    def gather_max(self, x: torch.Tensor) -> torch.Tensor:
        """The pmax: every rank's ``x`` gathered and maxed (the identity
        with one rank)."""
        if self.size == 1:
            return x
        return torch.amax(self.all_gather(x), dim=0)

    def shard(self, n: int) -> slice:
        """This rank's contiguous block of an axis of length ``n``, which
        must divide by the axis size."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks "
                             f"of axis {self.name!r}")
        m = n // self.size
        return slice(self.index * m, (self.index + 1) * m)


class Mesh:
    """The ranks of the process group on named axes (see the module doc)."""

    def __init__(self, shape: Dict[str, int], rank: int, world_size: int,
                 device: torch.device, backend: str,
                 axes: Dict[str, Axis]):
        self.shape = shape            # axis name -> size (JAX's mesh.shape)
        self.rank = rank
        self.world_size = world_size
        self.device = device
        self.backend = backend
        self.axes = axes

    def axis(self, name: str) -> Axis:
        return self.axes[name]


_meshes: Dict[tuple, Mesh] = {}
_mesh_lock = threading.Lock()


def _largest_factor_leq_sqrt(n: int) -> int:
    best = 1
    f = 1
    while f * f <= n:
        if n % f == 0:
            best = f
        f += 1
    return best


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp",),
              device: Optional[torch.device] = None) -> Mesh:
    """The mesh of this process group's ranks on ``axis_names`` (one name:
    every rank on it; two: the world factored as ``a x (n / a)`` with ``a``
    the largest factor <= sqrt(n)).

    ``n_devices`` must equal the group's world size. A world of one needs
    no process group; any other size without one raises, naming the
    launchers. Meshes are cached per (world, axis names): every rank makes
    the same calls in the same order, so the groups made for a mesh are
    made once, in the same order everywhere. ``device`` defaults to the
    current CUDA device when CUDA is available, else the CPU.
    """
    init = group_is_up()
    world_size = dist.get_world_size() if init else 1
    n = world_size if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, not {n}")
    check_world(n)
    names = tuple(axis_names)
    if len(names) not in (1, 2):
        raise ValueError(f"a mesh has one or two axes, not {names}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    key = (world_size, names, str(device),
           id(dist.group.WORLD) if init else None)
    with _mesh_lock:
        mesh = _meshes.get(key)
        if mesh is not None:
            return mesh
        rank = dist.get_rank() if init else 0
        backend = dist.get_backend() if init else "none"
        if len(names) == 1:
            shape = {names[0]: n}
            layout = [list(range(n))]          # rows: the groups of axis 0
            per_axis = {names[0]: layout}
        else:
            a = _largest_factor_leq_sqrt(n)
            b = n // a
            shape = {names[0]: a, names[1]: b}
            # rank = i * b + j: axis 0 varies i at fixed j, axis 1 j at i
            per_axis = {names[0]: [[i * b + j for i in range(a)]
                                   for j in range(b)],
                        names[1]: [[i * b + j for j in range(b)]
                                   for i in range(a)]}
        axes = {}
        for name in names:
            mine = None
            for ranks in per_axis[name]:
                # every rank makes every group, in the same order
                grp = dist.new_group(ranks=ranks) if init else None
                if rank in ranks:
                    mine = (grp, ranks)
            grp, ranks = mine
            axes[name] = Axis(name, len(ranks), ranks.index(rank), grp,
                              backend)
            if init and len(ranks) > 1:
                # a group's first collective sets up its connections (gloo
                # pairs, an NCCL communicator: 0.1-1 s); made here, so the
                # first counted gather of a run does not pay for it
                probe = torch.zeros(1, device=device if backend == "nccl"
                                    else "cpu")
                dist.all_gather([torch.empty_like(probe) for _ in ranks],
                                probe, group=grp)
        mesh = Mesh(shape, rank, world_size, device, backend, axes)
        _meshes[key] = mesh
        return mesh


def group_is_up() -> bool:
    """True once this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def check_world(n: int) -> None:
    """Raise unless a mesh of ``n`` ranks can be made here (0 asks for
    none): a process group of world size ``n`` is up, or ``n`` is 1."""
    rank, size = world()
    if n > 1 and not group_is_up():
        raise RuntimeError(NO_GROUP_MESSAGE.format(n=n))
    if n and n != size:
        raise RuntimeError(
            f"tpu.mesh_devices = {n} but the process group has world size "
            f"{size}: launch exactly {n} ranks")


def world() -> tuple:
    """(rank, world size) of this process (0, 1 outside a process group)."""
    if group_is_up():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_writer() -> bool:
    """True on the rank that writes the artifacts (rank 0, or the only
    process)."""
    return world()[0] == 0
