"""Process mesh construction for data x model-shard parallelism.

One process drives one device; the mesh lays the ranks of the
``torch.distributed`` world out as a ``(data, model)`` grid, the model
axis inner, so rank ``r`` sits at ``(r // n_model, r % n_model)``.  A
process that never initialised ``torch.distributed`` is a world of one
rank.

Two model-parallel axes exist, used one at a time next to ``data``:

- ``cls``: shard the index by class word-columns (32 classes per word);
  granularity is limited to ``class_words`` and field-packed indices
  cannot use it at all.
- ``blk``: shard the index by signature blocks (hash space); any
  geometry splits to arbitrary granularity, and every block shard looks
  at every k-mer of its data shard but probes only those whose block it
  owns.
"""

from dataclasses import dataclass

import torch
import torch.distributed as dist

from xspect2_tpu_torch import resolve_device
from xspect2_tpu_torch.parallel import distributed

DATA_AXIS = "data"
CLS_AXIS = "cls"
BLK_AXIS = "blk"


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of ranks and this rank's place in it.

    ``shape`` maps each axis name to its size (data first).  ``coords``
    is this rank's ``(data, model)`` coordinate, None for a rank of the
    world that lies outside the mesh.  ``groups`` maps each axis name to
    the process group of the ranks that differ from this one along that
    axis only, or to None in a process without ``torch.distributed``.
    """

    shape: dict
    coords: tuple | None
    groups: dict
    device: torch.device

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n_data, n_model = self.shape.values()
        return n_data * n_model

    def _group(self, axis: str):
        group = self.groups.get(axis)
        if group is None and self.shape[axis] > 1:
            raise RuntimeError(
                f"this mesh has no process group for its '{axis}' axis of {self.shape[axis]} "
                "ranks: build it with make_mesh or make_block_mesh after distributed.initialize"
            )
        return group

    def all_reduce(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``tensor`` over the ranks of ``axis``, in place."""
        group = self._group(axis)
        if group is not None:
            dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
        return tensor

    def all_gather(self, tensor: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The tensors of the ranks of ``axis``, in coordinate order,
        concatenated along ``dim``."""
        group = self._group(axis)
        if group is None:
            return tensor
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(self.shape[axis])]
        dist.all_gather(parts, tensor, group=group)
        return torch.cat(parts, dim=dim)


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _make(n_data, n_model, model_axis, device) -> Mesh:
    device = resolve_device(device)
    world, rank = _world()
    if n_data is None:
        if world % n_model:
            raise ValueError(f"{world} devices not divisible by n_{model_axis}={n_model}")
        n_data = world // n_model
    needed = n_data * n_model
    if needed > world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {needed} devices, have {world}")
    coords = (rank // n_model, rank % n_model) if rank < needed else None
    groups = {DATA_AXIS: None, model_axis: None}
    if dist.is_available() and dist.is_initialized():
        # every rank of the world creates every group, in the same order
        timeout = distributed.group_timeout()
        for d in range(n_data):
            group = dist.new_group([d * n_model + m for m in range(n_model)], timeout=timeout)
            if coords is not None and coords[0] == d:
                groups[model_axis] = group
        for m in range(n_model):
            group = dist.new_group([d * n_model + m for d in range(n_data)], timeout=timeout)
            if coords is not None and coords[1] == m:
                groups[DATA_AXIS] = group
    return Mesh({DATA_AXIS: n_data, model_axis: n_model}, coords, groups, device)


def make_mesh(n_data: int | None = None, n_cls: int = 1, device=None) -> Mesh:
    """Build a (data, cls) mesh over the ranks of the world.

    ``n_data`` defaults to ``world_size // n_cls``.  The class axis is
    the inner (fastest-varying) axis, so the class shards of one data
    shard are neighbouring ranks.  ``device`` is the device each rank
    computes on: None means CUDA (and raises without a card), ``"cpu"``
    the kernels' plain versions.
    """
    return _make(n_data, n_cls, CLS_AXIS, device)


def make_block_mesh(n_data: int | None = None, n_blk: int = 1, device=None) -> Mesh:
    """Build a (data, blk) mesh over the ranks of the world.

    The block axis is the inner (fastest-varying) axis, so the block
    shards that sum each data shard's partial hit counts are
    neighbouring ranks.
    """
    return _make(n_data, n_blk, BLK_AXIS, device)
