"""The ('data', 'model') grid of ranks (counterpart of `tacotron2_tpu/parallel/mesh.py:56-121`).

The JAX package lays its devices out as `np.asarray(devices).reshape(data, model)`
(`mesh.py:86`) and lets GSPMD place every collective. Here the grid is the same
row-major layout of ranks, `mesh_layout`, a pure function of the hparams and the world
size; `make_mesh` then builds, on every rank in one order, a process group for each
column (the data group: the ranks that hold the same model shard, over which the batch
is split and the gradients summed) and for each row (the model group: the ranks of one
data index, over which the WaveNet's gate channels are split, `tensor_parallel.py`).

Collectives on device tensors are all-reduce and broadcast only, the two that gloo
also takes on CUDA tensors, so one code path runs under nccl and gloo. A gather is an
all-reduce into a zeroed buffer in which each rank has written its own rows (`gather_rows`).

Not ported: `mesh_num_slices` and the DCN-aware slice-major layout (`mesh.py:23-54`).
"""

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from ..utils import shard_rows

def mesh_layout(hp, world_size: int) -> np.ndarray:
    """The (data, model) grid of global ranks: model = hp.mesh_model_axis, data =
    hp.mesh_data_axis or, at -1, every rank the model axis leaves; ranks d*model ..
    d*model + model - 1 form the row of data index d. Raises where the sizes do not cover
    the ranks, or hp.mesh_num_slices asks for more than one slice."""
    if hp.mesh_num_slices > 1:
        raise ValueError(f'mesh_num_slices={hp.mesh_num_slices}: the multi-slice layout is '
                         'not ported (one slice only)')
    model = max(1, hp.mesh_model_axis)
    data = hp.mesh_data_axis if hp.mesh_data_axis > 0 else world_size // model
    if data * model != world_size:
        raise ValueError(f'mesh {data}x{model} does not cover {world_size} devices')
    return np.arange(world_size).reshape(data, model)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid. `data_group` spans the ranks of this rank's
    column (data_size of them), `model_group` those of its row (model_size); either is
    None where the grid is one process, and then every collective here is the
    identity. `device` is the rank's device."""
    layout: np.ndarray
    rank: int
    device: torch.device
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def data_size(self) -> int:
        return self.layout.shape[0]

    @property
    def model_size(self) -> int:
        return self.layout.shape[1]

    @property
    def data_index(self) -> int:
        return int(np.argwhere(self.layout == self.rank)[0][0])

    @property
    def model_index(self) -> int:
        return int(np.argwhere(self.layout == self.rank)[0][1])

    def rows(self, batch_size: int) -> slice:
        """This rank's contiguous rows of a global batch of `batch_size`."""
        return shard_rows(batch_size, (self.data_index, self.data_size))


def make_mesh(hp, device) -> Mesh:
    """The grid of every rank of the process group (`mesh_layout`), with its data and
    model groups. Every rank must call it, in the same order as its other group
    creations: `dist.new_group` is collective."""
    world, rank = dist.get_world_size(), dist.get_rank()
    layout = mesh_layout(hp, world)
    data_group = model_group = None
    for m in range(layout.shape[1]):
        group = dist.new_group(layout[:, m].tolist())
        if rank in layout[:, m]:
            data_group = group
    for d in range(layout.shape[0]):
        group = dist.new_group(layout[d].tolist())
        if rank in layout[d]:
            model_group = group
    return Mesh(layout, rank, torch.device(device), data_group, model_group)


def local_batch_slice(batch: Dict[str, np.ndarray], process_index: int,
                      process_count: int) -> Dict[str, np.ndarray]:
    """This process's contiguous rows of a global batch (`mesh.py:107-116`)."""
    return {k: v[shard_rows(v.shape[0], (process_index, process_count))]
            for k, v in batch.items()}


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh) -> Dict[str, Tensor]:
    """This rank's rows of a global host batch, as tensors on its device."""
    rows = local_batch_slice(batch, mesh.data_index, mesh.data_size)
    return {k: torch.as_tensor(v).to(mesh.device, non_blocking=True) for k, v in rows.items()}


@torch.no_grad()
def replicate(tensors: Iterable[Tensor], src: int = 0) -> None:
    """Overwrite every tensor of `tensors`, on every rank, with rank `src`'s (parameters,
    moments, EMA, buffers), so that a fresh or restored state is the same everywhere.
    Nothing in one process."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    for t in tensors:
        dist.broadcast(t, src=src)


def broadcast_int(value: int, device, src: int = 0) -> int:
    """Rank `src`'s integer on every rank (a restored step count)."""
    if not (dist.is_available() and dist.is_initialized()):
        return value
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, src=src)
    return int(t.item())
