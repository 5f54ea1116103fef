"""
The fleet's process mesh, a port of ``gordo_tpu/parallel/mesh.py``
(``:83-143``).

The JAX package shards a fleet over a 2-D device mesh: ``models`` (each
device group trains a disjoint slice of the stacked members, no
collectives) and ``data`` (the devices of a group share each member's
samples, and GSPMD sums the gradients). The port runs one process a card
(``cli/cli.py``'s ``build-fleet`` spawns them), so its mesh is a grid of
``torch.distributed`` ranks: ``[world / data, data]`` with the same axis
names, this rank's coordinates in it, its device and its data group.

- :func:`initialize_backend` joins the process group over
  ``tcp://<coordinator_address>`` (``nccl`` on a card, ``gloo`` on the
  CPU; a caller may name ``gloo`` for ranks that share one card). A group
  that fails to form within ``timeout_s`` raises; nothing switches the
  backend quietly.
- :func:`make_mesh` is that grid; without a process group it is the
  one-device mesh ``(1, 1)``.
- :func:`model_sharding` and :func:`model_data_sharding` give this
  rank's slice of a member axis and of a sample axis, the blocks the JAX
  shardings place on its device.

JAX's ``configure_compile_cache`` and ``GORDO_TPU_COMPILE_CACHE`` have no
counterpart: the port compiles no program (K1's build directory is its
only cache).
"""

import logging
from datetime import timedelta
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

MODEL_AXIS = "models"
DATA_AXIS = "data"

#: seconds a join or a collective waits for the other ranks before failing,
#: unless the caller passes ``timeout_s``
DEFAULT_TIMEOUT_S = 600.0

#: this process's card among the host's visible ones (set by
#: :func:`initialize_backend`; 0 for a process alone on its host)
_local_rank = 0
_meshes: dict = {}


def initialize_backend(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceLike = None,
    local_rank: int = 0,
    timeout_s: Optional[float] = None,
) -> Optional[str]:
    """Join the fleet's process group as rank ``process_id`` of
    ``num_processes``, the store at ``coordinator_address``
    (``host:port``, served by rank 0); a no-op (None) without an address,
    as JAX's. ``device`` is this rank's (default ``cuda:<local_rank>``);
    the backend is ``nccl`` on a card and ``gloo`` on the CPU unless
    ``backend`` names one. Returns the backend joined; a group that does
    not form within ``timeout_s`` (default :data:`DEFAULT_TIMEOUT_S`)
    raises, and so does a collective that waits longer."""
    global _local_rank
    if coordinator_address is None:
        return None
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    _local_rank = int(local_rank)
    target = resolve_device(device if device is not None else "cuda")
    if backend is None:
        backend = "nccl" if target.type == "cuda" else "gloo"
    if backend == "nccl" and target.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if target.type == "cuda":
        torch.cuda.set_device(_rank_device(target))
    if timeout_s is None:
        timeout_s = DEFAULT_TIMEOUT_S
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=timedelta(seconds=timeout_s),
    )
    _meshes.clear()
    logger.info("process group joined: rank %d of %d over %s (%s)", int(process_id), int(num_processes),
                coordinator_address, backend)
    return backend


def shutdown_backend() -> None:
    """Leave the process group, if this process joined one."""
    _meshes.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_device(device: torch.device) -> torch.device:
    """A card without an index is this rank's local card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", _local_rank)
    return device


class Mesh:
    """The fleet's grid of ranks, ``devices[model, data]`` (rank numbers;
    JAX's ``mesh.devices.shape`` is ``shape``), with this rank's
    ``coords``, its ``device`` and its ``data_group`` (the ranks sharing
    its members; None when the data axis is 1)."""

    axis_names = (MODEL_AXIS, DATA_AXIS)

    def __init__(self, devices: np.ndarray, rank: int, device: torch.device, data_group: Any = None):
        self.devices = devices
        self.rank = int(rank)
        self.device = device
        self.data_group = data_group
        where = np.argwhere(devices == rank)[0]
        self.coords: Tuple[int, int] = (int(where[0]), int(where[1]))

    @property
    def shape(self) -> Tuple[int, int]:
        return int(self.devices.shape[0]), int(self.devices.shape[1])

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distributed(self) -> bool:
        return self.size > 1

    def all_gather_object(self, obj: Any) -> List[Any]:
        """``obj`` of every rank, in rank order (``[obj]`` alone); JAX's
        ``process_allgather`` of host values."""
        if not self.distributed:
            return [obj]
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, coords={self.coords}, device={self.device})"


def make_mesh(data_parallelism: int = 1, device: DeviceLike = None) -> Mesh:
    """The fleet mesh over every rank of the process group: ``[world /
    data_parallelism, data_parallelism]``, this rank's device ``device``
    (default its card, ``cuda:<local rank>``). Without a process group,
    the one-device mesh ``(1, 1)``. The data groups are made once a
    ``data_parallelism`` (every rank must make the mesh alike)."""
    target = _rank_device(resolve_device(device))
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if world % data_parallelism:
        raise ValueError(f"data_parallelism={data_parallelism} does not divide device count {world}")
    grid = np.arange(world).reshape(world // data_parallelism, data_parallelism)
    group = None
    if data_parallelism > 1:
        groups = _meshes.get(data_parallelism)
        if groups is None:
            # every rank makes every group, in the same order
            groups = _meshes[data_parallelism] = [dist.new_group([int(r) for r in row]) for row in grid]
        group = groups[rank // data_parallelism]
    return Mesh(grid, rank, target, group)


def model_sharding(mesh: Mesh, members: int, unit: int = 1) -> slice:
    """This rank's block of a member axis of ``members``: the axis is
    padded to a multiple of the model axis (in whole ``unit``s, a pack's
    members) and cut into equal contiguous blocks, JAX's ``PartitionSpec(
    "models")``; the padding is the zero-weight dummies, so the block may
    be short or empty.

    >>> mesh = Mesh(np.arange(2).reshape(2, 1), 1, torch.device("cpu"))
    >>> model_sharding(mesh, 5), model_sharding(mesh, 5, unit=2)
    (slice(3, 5, None), slice(4, 5, None))
    """
    units = -(-members // unit)
    per = -(-units // mesh.shape[0]) * unit
    lo = min(mesh.coords[0] * per, members)
    return slice(lo, min(lo + per, members))


def model_data_sharding(mesh: Mesh, members: int, samples: int, unit: int = 1) -> Tuple[slice, slice]:
    """This rank's ``(member block, sample block)`` of an ``[M, N]`` axis
    pair, JAX's ``PartitionSpec("models", "data")``: the member block of
    :func:`model_sharding` and the ``data``-th of ``data`` near-equal
    contiguous row blocks.

    >>> mesh = Mesh(np.arange(2).reshape(1, 2), 1, torch.device("cpu"))
    >>> model_data_sharding(mesh, 3, 10)
    (slice(0, 3, None), slice(5, 10, None))
    """
    data, j = mesh.shape[1], mesh.coords[1]
    return model_sharding(mesh, members, unit), slice(j * samples // data, (j + 1) * samples // data)


class DataShard:
    """A fit's share of each batch over the mesh's data axis: this rank's
    near-equal contiguous block of a batch's rows (:meth:`bounds`), and
    the in-place sum over its data group (:meth:`all_reduce`)."""

    def __init__(self, mesh: Mesh):
        self.group = mesh.data_group
        self.index = mesh.coords[1]
        self.size = mesh.shape[1]

    def bounds(self, length: int) -> Tuple[int, int]:
        return self.index * length // self.size, (self.index + 1) * length // self.size

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(tensor, group=self.group)
        return tensor
