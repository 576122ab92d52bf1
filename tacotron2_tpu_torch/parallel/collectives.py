"""The collectives of the data- and tensor-parallel steps, each the identity where its
group is None (one process).

`global_sum` all-reduces a count (a loss's denominator, BatchNorm's element count)
outside autograd. `all_reduce_sum` is a differentiable all-reduce whose backward is an
all-reduce too: each rank's loss reads the sum, so the gradient of the summed losses
with respect to one rank's term is the sum of every rank's gradient of the result
(BatchNorm's batch statistics over the data group). `copy_to_model` and
`reduce_from_model` are the two conjugate collectives of a tensor-parallel block (the
model group): the first the identity forward and an all-reduce backward, at the input
that every shard reads, the second an all-reduce forward and the identity backward,
after the row-parallel products, whose result every shard then reads alike.

Gathers are all-reduces into zeroed buffers (`gather_rows`): gloo takes only
all-reduce and broadcast on CUDA tensors.
"""

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import Tensor


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


@torch.no_grad()
def global_sum(t: Tensor, group: Optional[dist.ProcessGroup]) -> Tensor:
    """The sum of `t` over the ranks of `group`, outside autograd (a new tensor)."""
    out = t.detach().clone()
    if group is not None:
        dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(t: Tensor, group: Optional[dist.ProcessGroup]) -> Tensor:
    """Sum over `group`, differentiable: the backward sums the ranks' gradients."""
    return t if group is None else _AllReduceSum.apply(t, group)


def copy_to_model(t: Tensor, group: Optional[dist.ProcessGroup]) -> Tensor:
    """Identity forward; the backward sums the model group's partial gradients."""
    return t if group is None else _CopyToModel.apply(t, group)


def reduce_from_model(t: Tensor, group: Optional[dist.ProcessGroup]) -> Tensor:
    """Sum of the model group's partial products forward; identity backward."""
    return t if group is None else _ReduceFromModel.apply(t, group)


@torch.no_grad()
def gather_rows(local: Tensor, rows: slice, total: int,
                group: Optional[dist.ProcessGroup]) -> Tensor:
    """The (total, ...) tensor whose `rows` are this rank's `local` and whose other
    rows are the other ranks' of `group`: an all-reduce of a zeroed buffer."""
    if group is None:
        return local
    out = torch.zeros((total,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    out[rows] = local
    dist.all_reduce(out, group=group)
    return out


@torch.no_grad()
def all_reduce_flat_(tensors: Sequence[Tensor], group: Optional[dist.ProcessGroup]) -> None:
    """Sum every tensor of `tensors` in place over `group`, in one all-reduce of a flat
    buffer (the tensors share a device and a dtype)."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
