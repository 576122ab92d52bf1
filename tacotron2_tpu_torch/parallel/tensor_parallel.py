"""WaveNet tensor parallelism over the model group (counterpart of
`tacotron2_tpu/parallel/sharding_rules.py:47-60` and of the GSPMD partitioning that
`make_tp_train_step`, `wavenet_trainer.py:387-394`, leaves to XLA).

Each rank of a model group of m holds a WaveNet whose residual blocks have G/m gate
channels: the r-th block of each half of G (`sharding_rules.gate_index`), so that the
GLU is local. In a block, the dilated conv and the conditioning 1x1s are
column-parallel: their input, the same on every rank, passes `copy_to_model` (identity
forward, all-reduce backward). The out and skip 1x1s are row-parallel: each rank's
product over its G/(2m) gated channels is a partial sum, `reduce_from_model` sums it
over the group (all-reduce forward, identity backward), and the bias is added once,
after the sum. Everything outside the blocks is replicated. A sharded parameter
carries `tensor_parallel = True`, which the train step reads to sum its squared norm
over the model group (the global norm and the per-tensor clip). Checkpoints hold the
full layout (`gather_state_dict`, `convert.join_wavenet_shards`).
"""

import functools
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor

from ..models.wavenet.model import WaveNet
from ..models.wavenet.modules import ResidualConv1DGLU
from .collectives import copy_to_model, reduce_from_model
from .mesh import Mesh
from .sharding_rules import shard_index, shards_gates


class TensorParallelBlock(ResidualConv1DGLU):
    """A residual block holding one rank's shard of the gate channels (built with G/m of
    them); `model_group` is the group its partial products are summed over."""

    def __init__(self, *args, model_group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.model_group = model_group

    def forward(self, x, c, g=None, train=False, generator=None, mask=None,
                dtype=torch.float32):
        residual = x
        group = self.model_group
        x = copy_to_model(self._dropout(x, train, generator, mask), group)
        c = copy_to_model(c, group) if c is not None else None
        g = copy_to_model(g, group) if g is not None else None
        return self._outputs(self.conv(x, dtype),
                             self.conv1x1c(c, dtype) if c is not None else None,
                             self.conv1x1g(g, dtype) if g is not None else None, residual,
                             dtype)

    def _project(self, conv, gated: Tensor, dtype: torch.dtype) -> Tensor:
        """Row-parallel: this rank's partial product, summed over the model group, then
        the bias, once."""
        y = reduce_from_model(F.linear(gated.to(dtype), conv.weight.to(dtype)),
                              self.model_group)
        return y + conv.bias.to(dtype) if conv.bias is not None else y

    def incremental_step(self, taps, c_proj, g_proj):
        raise NotImplementedError('a tensor-parallel block trains; generation runs on '
                                  'the full model')


def shard_hparams(hp, model_size: int):
    """The hparams of one rank's shard: G / model_size gate channels."""
    return hp.replace(gate_channels=hp.gate_channels // model_size)


def shard_wavenet(state_dict: Dict[str, Tensor], hp, mesh: Mesh) -> WaveNet:
    """This rank's tensor-parallel WaveNet, on mesh.device, from the full `state_dict`
    (`convert.split_wavenet_state`). Where the model axis does not split the gates
    (`sharding_rules.shards_gates`), the full model, replicated."""
    from ..convert import split_wavenet_state

    m = mesh.model_size
    if not shards_gates(hp, m):
        model = WaveNet(hp)
        model.load_state_dict(state_dict)
        return model.to(mesh.device)
    model = WaveNet(shard_hparams(hp, m),
                    block=functools.partial(TensorParallelBlock, model_group=mesh.model_group))
    model.load_state_dict(split_wavenet_state(state_dict, hp, m, mesh.model_index))
    for name, p in model.named_parameters():
        if shard_index(name, p.shape, hp, m, 0) is not None:
            p.tensor_parallel = True
    return model.to(mesh.device)


def shard_wavenet_state(state, hp, mesh: Mesh):
    """A WaveNetTrainState with this rank's shards of the parameters and the EMA, its
    Adam moments started afresh from them (`shard_wavenet_state`,
    `sharding_rules.py:47-60`: a mid-training state converted to tensor parallelism
    restarts its moments), and the step kept."""
    from ..training.wavenet_trainer import WaveNetTrainState

    model = shard_wavenet(state.model.state_dict(), hp, mesh)
    params = list(model.parameters())
    return WaveNetTrainState(step=state.step, model=model,
                             ema_model=shard_wavenet(state.ema_model.state_dict(), hp, mesh),
                             exp_avg=[torch.zeros_like(p) for p in params],
                             exp_avg_sq=[torch.zeros_like(p) for p in params])


def gather_state_dict(model: WaveNet, hp, mesh: Mesh) -> Dict[str, Tensor]:
    """The full WaveNet state_dict of a tensor-parallel `model`, on every rank of its
    model group (`gather_tensors`)."""
    return gather_tensors(model.state_dict(), hp, mesh)


@torch.no_grad()
def gather_tensors(tensors: Dict[str, Tensor], hp, mesh: Mesh) -> Dict[str, Tensor]:
    """{parameter name: this rank's shard, or the replicated tensor} -> the full
    tensors (a state_dict, or Adam's moments by parameter name), on every rank of the
    model group: each shard written into a zeroed full tensor, summed over the group."""
    m = mesh.model_size
    out = {}
    for name, t in tensors.items():
        where = shard_index(name, t.shape, hp, m, mesh.model_index)
        if where is None:
            out[name] = t.detach().clone()
            continue
        axis, index = where
        shape = list(t.shape)
        shape[axis] *= m
        full = torch.zeros(shape, dtype=t.dtype, device=t.device)
        full.index_copy_(axis, index.to(t.device), t)
        dist.all_reduce(full, group=mesh.model_group)
        out[name] = full
    return out

