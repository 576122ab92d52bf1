"""Which WaveNet parameters the tensor-parallel step splits over the model group, and
how (counterpart of `tacotron2_tpu/parallel/sharding_rules.py:19-44`).

The rules are the JAX package's, on the flax path of each parameter (`flax_path`):
the gate-producing kernels (`causal_conv`, `conv1x1c`, `conv1x1g`) and their biases
are split on their gate axis G (column-parallel), the `conv1x1_out` and
`conv1x1_skip` kernels on their input axis G/2 (row-parallel), everything else is
replicated (`spec_for_wavenet_param`, which names the flax axis split).

The JAX package splits G contiguously and leaves the resharding to GSPMD. A
hand-written split cannot: a contiguous block of G/m gate channels gives rank 0 only
tanh inputs. Here rank r holds the r-th block of each half of G (`gate_index`), so its
gate is local, and the out and skip kernels take the matching r-th block of G/2.
That needs G/2 divisible by the model size; where it is not, every parameter stays
replicated (`shards_gates`). The JAX package falls back parameter by parameter on G or
G/2 (`sharding_rules.py:38-44`); the two agree wherever G/2 splits evenly and where G
does not split at all.
"""

from typing import Dict, Iterable, Optional

import torch
from torch import Tensor

# the port's module names inside a residual block -> the flax module names
BLOCK_NAMES = {'conv': 'causal_conv', 'conv1x1c': 'conv1x1c', 'conv1x1g': 'conv1x1g',
               'conv1x1_out': 'conv1x1_out', 'conv1x1_skip': 'conv1x1_skip'}
LEAF_NAMES = {'weight': 'kernel', 'bias': 'bias'}


def flax_path(name: str) -> str:
    """The flax path ('residual_block_3/causal_conv/kernel') of the port's WaveNet
    parameter `name` ('residual_layers.2.conv.weight')."""
    parts = name.split('.')
    leaf = LEAF_NAMES.get(parts[-1], parts[-1])
    if parts[0] == 'residual_layers':
        return 'residual_block_{}/{}/{}'.format(int(parts[1]) + 1, BLOCK_NAMES[parts[2]], leaf)
    return '/'.join([parts[0], leaf])


def spec_for_wavenet_param(path: str) -> Optional[int]:
    """The flax axis of the parameter at `path` that the model axis splits, or None
    (replicated): `_spec_for_wavenet_param`, `sharding_rules.py:19-31`."""
    if 'causal_conv' in path and path.endswith('kernel'):
        return 2                                  # (k, R, G): the gate axis
    if ('conv1x1c' in path or 'conv1x1g' in path) and path.endswith('kernel'):
        return 1                                  # (cin or gin, G)
    if ('causal_conv' in path or 'conv1x1c' in path or 'conv1x1g' in path) \
            and path.endswith('bias'):
        return 0                                  # (G,)
    if ('conv1x1_out' in path or 'conv1x1_skip' in path) and path.endswith('kernel'):
        return 0                                  # (G/2, R or S): row-parallel
    return None


def shards_gates(hp, model_size: int) -> bool:
    """Whether the model axis splits the gates: more than one rank, each half of G
    divisible by it, and no weight normalization (its norm over a row-parallel kernel's
    split axis is not ported)."""
    if model_size <= 1:
        return False
    if hp.wavenet_weight_normalization:
        raise NotImplementedError('tensor parallelism with wavenet_weight_normalization is '
                                  'not ported')
    return (hp.gate_channels // 2) % model_size == 0 and hp.gate_channels % 2 == 0


def wavenet_param_specs(names: Iterable[str], hp,
                        model_size: int) -> Dict[str, Optional[int]]:
    """{port parameter name: flax axis split, or None} for the WaveNet parameters
    `names`, with the replicated fallback of `shards_gates`."""
    split = shards_gates(hp, model_size)
    return {name: spec_for_wavenet_param(flax_path(name)) if split else None
            for name in names}


def torch_axis(flax_axis: int, ndim: int) -> int:
    """The port's axis of a flax axis: a kernel's axes run the other way round (Dense
    (in, out) -> Linear (out, in), Conv (k, in, out) -> Conv1d (out, in, k)); a bias
    keeps its one axis."""
    return 0 if ndim == 1 else ndim - 1 - flax_axis


def gate_index(G: int, model_size: int, model_index: int) -> Tensor:
    """The gate channels of rank `model_index`: the model_index-th block of G/(2m) in
    each half of G, tanh's then the sigmoid's."""
    h = G // (2 * model_size)
    block = torch.arange(model_index * h, (model_index + 1) * h)
    return torch.cat([block, G // 2 + block])


def half_index(G: int, model_size: int, model_index: int) -> Tensor:
    """The rows of G/2 that rank `model_index` holds of a row-parallel kernel: the ones
    its gate produces."""
    h = G // (2 * model_size)
    return torch.arange(model_index * h, (model_index + 1) * h)


def shard_index(name: str, shape: torch.Size, hp, model_size: int,
                model_index: int) -> Optional[tuple]:
    """(torch axis, indices) of rank `model_index`'s shard of the parameter `name`, or
    None where it is replicated."""
    axis = wavenet_param_specs([name], hp, model_size)[name]
    if axis is None:
        return None
    path = flax_path(name)
    G = hp.gate_channels
    row = 'conv1x1_out' in path or 'conv1x1_skip' in path
    index = (half_index if row else gate_index)(G, model_size, model_index)
    return torch_axis(axis, len(shape)), index
