"""The ranks of a ``torch.distributed`` world as a ("branch", "key") mesh:
the counterpart of ``ipk_tpu/parallel/mesh.py``.

One process is one rank and holds one device: ``cuda:(rank % the local
device count)``, or the CPU when the caller asks for it. A world of N ranks
takes the place of ``ipk_tpu``'s N-device mesh:

* the **branch axis** shards the ghost matrices: each rank enumerates its
  contiguous slice of them;
* the **key axis** shards the k-mer space of the distributed mutual
  information reduction (``build_sharded._mi_reduce``).

Rank ``b * n_key + j`` sits at branch index b and key index j. A collective
over an axis runs among the ranks that differ only in that axis. Callers
move int64, int32 and float32 tensors: gloo and NCCL support little else.

Backends: NCCL for ranks on CUDA, gloo for ranks on the CPU. Gloo also takes
CUDA tensors, staging them through the host; that is how several ranks
share one GPU, which NCCL refuses.
"""

from __future__ import annotations

import socket
from typing import Optional

import torch
import torch.distributed as dist

from .. import device as device_mod

__all__ = ["Mesh", "make_mesh", "initialize_distributed", "rank_device",
           "world_size"]

AXES = ("branch", "key")


def world_size() -> int:
    """The number of ranks of the default process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank_device(device: device_mod.DeviceLike = "cuda",
                rank: Optional[int] = None) -> torch.device:
    """A rank's device: the CPU when ``device`` names it, else
    ``cuda:(rank % torch.cuda.device_count())`` (raising without CUDA).
    ``rank`` defaults to this process's rank."""
    if torch.device("cuda" if device is None else device).type == "cpu":
        return torch.device("cpu")
    device_mod.resolve("cuda")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: device_mod.DeviceLike = "cuda") -> bool:
    """Join a world of ``num_processes`` ranks as rank ``process_id``; a
    no-op when single-process.

    ``coordinator`` is rank 0's rendezvous, ``host:port`` (TCP), or a URL
    with its scheme (e.g. ``file:///shared/path``). ``backend`` None takes
    NCCL for a CUDA ``device`` and gloo for the CPU. A CUDA rank's current
    device becomes :func:`rank_device`. Under NCCL, ranks that share a GPU
    raise: run one rank per GPU, or pass ``backend="gloo"``.

    Where the default process group exists already with this world size and
    rank, it is kept. Returns True when this call created it.
    """
    if not num_processes or num_processes <= 1:
        return False
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id must be in [0, {num_processes}), got "
                         f"{process_id}")
    if not coordinator:
        raise ValueError("a coordinator address (host:port) is needed for "
                         "more than one process")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                        process_id):
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks (this is "
                f"rank {dist.get_rank()}) exists already; asked for rank "
                f"{process_id} of {num_processes}")
        return False
    dev = rank_device(device, process_id)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_method = (coordinator if "://" in coordinator
                   else f"tcp://{coordinator}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    if backend == "nccl":
        try:
            check_one_rank_per_gpu(dev)
        except RuntimeError:
            dist.destroy_process_group()
            raise
    return True


def check_one_rank_per_gpu(dev: torch.device) -> None:
    """Raise when another rank of the world holds the same GPU (host name
    and device index) as ``dev``: NCCL cannot run two ranks on one GPU.
    Collective: every rank calls it; it talks over a gloo group of its own,
    because NCCL would fail on the clash before any check could run."""
    side = dist.new_group(backend="gloo")
    try:
        held = [None] * dist.get_world_size()
        dist.all_gather_object(held, (socket.gethostname(), dev.index),
                               group=side)
    finally:
        dist.destroy_process_group(side)
    mine = (socket.gethostname(), dev.index)
    sharing = [r for r, h in enumerate(held) if h == mine]
    if len(sharing) > 1:
        raise RuntimeError(
            f"NCCL cannot run ranks {sharing} on one GPU (cuda:{dev.index} "
            f"on {mine[0]}): run one rank per GPU, or pass backend='gloo' "
            f"to initialize_distributed")


class Mesh:
    """The world's ranks laid out as ("branch", "key"): this rank's place
    (``index``), its device, and the collectives along each axis.

    Use :func:`make_mesh`. Every collective is called by every rank of the
    world in the same order; tensors of one collective have one shape and
    dtype on every rank.
    """

    def __init__(self, n_branch: int, n_key: int, device: torch.device):
        world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.shape = {"branch": n_branch, "key": n_key}
        self.device = device
        self._index = {"branch": self.rank // n_key,
                       "key": self.rank % n_key}
        lines = {
            "branch": [[b * n_key + j for b in range(n_branch)]
                       for j in range(n_key)],
            "key": [[b * n_key + j for j in range(n_key)]
                    for b in range(n_branch)]}
        self._groups = {}
        for axis in AXES:
            mine = lines[axis][self._index["key" if axis == "branch"
                                           else "branch"]]
            if len(mine) == world:
                self._groups[axis] = dist.group.WORLD
            elif len(mine) == 1:
                self._groups[axis] = None       # collectives are identities
            else:
                # new_group is collective: every rank creates every line
                made = [dist.new_group(ranks) for ranks in lines[axis]]
                self._groups[axis] = made[lines[axis].index(mine)]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self._index[axis]

    def local_rows(self, x):
        """This rank's contiguous block of the leading axis of ``x`` along
        the branch axis (whose size must divide it)."""
        n = self.size("branch")
        if x.shape[0] % n:
            raise ValueError(f"leading axis {x.shape[0]} is not a multiple "
                             f"of the branch axis {n}")
        step = x.shape[0] // n
        i = self.index("branch")
        return x[i * step:(i + 1) * step]

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' ``x`` along ``axis``, concatenated on dim 0 in axis
        order."""
        group = self._groups[axis]
        if group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size(axis))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    def all_reduce(self, x: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """``x`` reduced over ``axis`` ("sum" or "max"); returns a new
        tensor."""
        x = x.clone()
        group = self._groups[axis]
        if group is not None:
            dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                                   "max": dist.ReduceOp.MAX}[op],
                            group=group)
        return x

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Row block i of ``x`` (its leading axis cut into ``size(axis)``
        even blocks) goes to the axis's i-th rank; returns the blocks
        received, in axis order."""
        group = self._groups[axis]
        if group is None:
            return x
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out


def make_mesh(n_branch: Optional[int] = None, n_key: int = 1,
              device: device_mod.DeviceLike = None) -> Mesh:
    """A ("branch", "key") mesh over the ranks of the initialized world
    (``n_branch`` defaults to the world size over ``n_key``). ``device``
    None takes :func:`rank_device`; else the device named. Collective:
    every rank calls it."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "world (initialize_distributed or "
                           "init_process_group)")
    world = dist.get_world_size()
    if n_branch is None:
        n_branch = world // n_key
    if n_branch * n_key != world:
        raise ValueError(f"mesh {n_branch}x{n_key} does not cover {world} "
                         f"ranks")
    dev = rank_device() if device is None else device_mod.resolve(device)
    return Mesh(n_branch, n_key, dev)

