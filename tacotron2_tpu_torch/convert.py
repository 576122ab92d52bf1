"""Map flax parameter trees (numpy) onto the port's state_dicts, and save / load them;
map the JAX AR kernel's streaming state and the JAX WaveNet train state onto the port's.

The trees are what the JAX package's `create_train_state` or a checkpoint restore
holds, with every leaf turned into a numpy array. The layout changes:
  - Dense kernel (in, out)            -> Linear.weight (out, in)
  - Conv kernel (k, in, out)          -> Conv1d.weight (out, in, k)
  - SubPixel conv kernel (3, 3, 1, s) -> Conv2d.weight (s, 1, 3, 3)  (HWIO -> OIHW),
    and a Resize conv kernel (fk, s, 1, 1) -> Conv2d.weight (1, 1, fk, s) likewise
  - 2D transpose-conv kernel (fk, s, 1, 1) -> ConvTranspose2d.weight (1, 1, fk, s),
    flipped on both spatial axes (lax.conv_transpose with transpose_kernel=False
    correlates with the kernel as it is; torch's transpose conv flips it), and a 1D
    transpose-conv kernel (s, cin, cin) -> ConvTranspose1d.weight (cin, cin, s),
    flipped in time for the same reason
  - a NearestNeighbor upsampler has no parameters
  - BatchNorm scale/bias + batch_stats mean/var -> BatchNorm1d weight/bias/running_*
  - LSTM `gates` kernels keep their i, g, f, o order (the +1.0 forget bias is applied
    by the cell, not stored)
  - a GRUCell's six Dense layers -> the port's GRU: ir, iz, in (kernels side by side,
    with their biases) -> `input`, hr, hz, hn -> `hidden`, hn's bias -> `bias_hn`
  - weight normalization is folded for inference: kernel = g * v / ||v||, the norm over
    every axis but the last (tacotron2_tpu/ops/pallas/wavenet_ar.py:80-89); for
    training (`fold=False`) it stays apart: `wn_g` -> `<conv>.parametrizations.weight.0.g`
    and the direction `kernel` -> `<conv>.parametrizations.weight.original`, the
    parameters of a WaveNet built with wavenet_weight_normalization=True.
"""

import os
from typing import Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from .models.tacotron.flax_names import GRU_GROUPS, port_name
from .models.tacotron.model import Tacotron
from .models.wavenet.model import WaveNet
from .ops.wavenet_ar import ring_layout
from .parallel.sharding_rules import shard_index
from .training import checkpoint_select
from .training.checkpointing import CheckpointManager
from .training.tacotron_trainer import TacotronTrainState
from .training.tacotron_trainer import state_from_model as tacotron_state_from_model
from .training.wavenet_trainer import WaveNetTrainState, state_from_model


def _t(x) -> Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _kernel(conv: Mapping) -> np.ndarray:
    v = np.asarray(conv['kernel'], np.float32)
    if 'wn_g' not in conv:
        return v
    axes = tuple(range(v.ndim - 1))
    norm = np.sqrt(np.sum(np.square(v), axis=axes, keepdims=True) + 1e-8)
    return (np.asarray(conv['wn_g'], np.float32) * v / norm).astype(np.float32)


def _conv(sd: Dict[str, Tensor], prefix: str, p: Mapping,
          layout: Callable[[np.ndarray], np.ndarray], fold: bool = True) -> None:
    """One conv's entries: its kernel in torch's layout (weight norm folded in, or g
    and the direction apart under the parametrization's names) and its bias."""
    if 'wn_g' in p and not fold:
        sd[prefix + '.parametrizations.weight.original'] = _t(
            layout(np.asarray(p['kernel'], np.float32)))
        sd[prefix + '.parametrizations.weight.0.g'] = _t(p['wn_g'])
    else:
        sd[prefix + '.weight'] = _t(layout(_kernel(p)))
    if 'bias' in p:
        sd[prefix + '.bias'] = _t(p['bias'])


def _dense(sd: Dict[str, Tensor], prefix: str, p: Mapping, fold: bool = True) -> None:
    _conv(sd, prefix, p, lambda k: k.T, fold)


def _conv1d(sd: Dict[str, Tensor], prefix: str, p: Mapping, fold: bool = True) -> None:
    _conv(sd, prefix, p, lambda k: k.transpose(2, 1, 0), fold)


def _flatten(tree: Mapping, prefix: str = ''):
    """(flax path, leaf) of every leaf of a flax tree, the path '/'-joined."""
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def _join_gru(leaves: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """`leaves` with the layers of each GRU_GROUPS group of a GRU joined side by side
    under the group's name: the three kernels, and the input side's three biases (hn's
    bias stays apart)."""
    out = dict(leaves)
    for group in GRU_GROUPS:
        for path in leaves:
            parent, sep, leaf = path.rpartition(f'/{group[0]}/')
            names = [f'{parent}/{g}/{leaf}' for g in group]
            if sep and '/' not in leaf and all(n in leaves for n in names):
                out[f'{parent}/{"+".join(group)}/{leaf}'] = np.concatenate(
                    [np.asarray(leaves[n]) for n in names], axis=-1)
                for n in names:
                    del out[n]
    return out


def tacotron_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, Tensor]:
    """flax Tacotron `params` + `batch_stats` -> state_dict of models.tacotron.Tacotron,
    the CBHG linear post-net included where the tree holds it (predict_linear); of a
    subtree, the state_dict of the port module it stands for. Each leaf lands on the
    port tensor `flax_names.port_name` names; a kernel in torch's layout. A tree of Adam
    moments (the params' structure) converts the same way."""
    sd: Dict[str, Tensor] = {}
    for path, x in _join_gru(dict(_flatten(params))).items():
        x = np.asarray(x, np.float32)
        if path.endswith('kernel'):
            x = x.T if x.ndim == 2 else x.transpose(2, 1, 0)
        sd[port_name(path)] = _t(x)
    for path, x in _flatten(batch_stats):
        name = port_name(path)
        sd[name] = _t(x)
        if name.endswith('running_mean'):
            sd[name.replace('running_mean', 'num_batches_tracked')] = torch.tensor(
                0, dtype=torch.long)
    return sd


def tacotron_train_state_from_jax(state: Mapping, hp, device='cpu') -> TacotronTrainState:
    """The JAX package's Tacotron `TrainState`, given as numpy, -> the port's, on
    `device`.

    `state` holds `step` (int), `params` and `batch_stats` (flax trees) and `mu` and
    `nu` (Adam's moments out of the optax state: trees of the params' structure). Each
    moment tree goes through `tacotron_state_dict`, a permutation of every leaf, so a
    moment lands on its parameter."""
    model = Tacotron(hp)
    model.load_state_dict(tacotron_state_dict(state['params'], state['batch_stats']))
    out = tacotron_state_from_model(model.to(device), int(state['step']))
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        for moments, tree in ((out.exp_avg, state['mu']), (out.exp_avg_sq, state['nu'])):
            sd = tacotron_state_dict(tree, state['batch_stats'])
            for m, name in zip(moments, names, strict=True):
                m.copy_(sd[name])
    return out


def wavenet_state_dict(params: Mapping, fold: bool = True) -> Dict[str, Tensor]:
    """flax WaveNet `params` -> state_dict of models.wavenet.WaveNet: with `fold`, of a
    model built without weight normalization (g * v / ||v|| folded into plain weights:
    an inference checkpoint); without, of a model built as the params were
    (`wn_g` and the direction apart where the params hold `wn_g`: a training state).
    The first conv is (1, R) for scalar input and (Q, R) for one-hot input; a
    multi-speaker model also holds the `gc_embedding` table and every block's
    `conv1x1g`."""
    sd: Dict[str, Tensor] = {}
    _dense(sd, 'first_conv', params['first_conv'], fold)
    if 'gc_embedding' in params:
        sd['gc_embedding.weight'] = _t(params['gc_embedding']['embedding'])
    n = len([k for k in params if k.startswith('residual_block_')])
    for i in range(n):
        blk = params[f'residual_block_{i + 1}']
        pre = f'residual_layers.{i}'
        _conv1d(sd, pre + '.conv', blk['causal_conv'], fold)
        if 'conv1x1c' in blk:
            _dense(sd, pre + '.conv1x1c', blk['conv1x1c'], fold)
        if 'conv1x1g' in blk:
            _dense(sd, pre + '.conv1x1g', blk['conv1x1g'], fold)
        _dense(sd, pre + '.conv1x1_out', blk['conv1x1_out'], fold)
        _dense(sd, pre + '.conv1x1_skip', blk['conv1x1_skip'], fold)
    _dense(sd, 'skip_conv1', params['skip_conv1'], fold)
    _dense(sd, 'skip_conv2', params['skip_conv2'], fold)
    ups = params.get('upsample_network', {})
    layouts = {'subpixel_conv': lambda k: k.transpose(3, 2, 0, 1),
               'resize_conv': lambda k: k.transpose(3, 2, 0, 1),
               'convt2d': lambda k: k[::-1, ::-1].transpose(2, 3, 0, 1),
               'convt1d': lambda k: k[::-1].transpose(1, 2, 0)}
    kinds = {name.rsplit('_', 1)[0] for name in ups}
    if len(kinds) > 1 or not kinds <= set(layouts):
        raise ValueError(f'upsample_network holds {sorted(ups)}: not one of the '
                         f'upsamplers {sorted(layouts)}')
    for kind in kinds:
        for i in range(len(ups)):
            p = ups[f'{kind}_{i + 1}']
            _conv(sd, f'upsample.convs.{i}', p, layouts[kind], fold)
    return sd


def wavenet_train_state_from_jax(state: Mapping, hp, device='cpu') -> WaveNetTrainState:
    """The JAX package's `WaveNetTrainState`, given as numpy, -> the port's, on `device`.

    `state` holds `step` (int), `params` and `ema_params` (flax trees, weight norm
    unfolded) and `mu` and `nu` (Adam's moments out of the optax state: trees of the
    params' structure). Each tree goes through `wavenet_state_dict(fold=False)`, a
    permutation of every leaf, so a moment lands on its parameter. One `train_step` of
    each package from the same state on the same batch can then be compared."""
    model = WaveNet(hp)
    model.load_state_dict(wavenet_state_dict(state['params'], fold=False))
    out = state_from_model(model.to(device), int(state['step']))
    out.ema_model.load_state_dict(wavenet_state_dict(state['ema_params'], fold=False))
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        for moments, tree in ((out.exp_avg, state['mu']), (out.exp_avg_sq, state['nu'])):
            sd = wavenet_state_dict(tree, fold=False)
            for m, name in zip(moments, names, strict=True):
                m.copy_(sd[name])
    return out


def split_wavenet_state(state_dict: Mapping[str, Tensor], hp, model_size: int,
                        model_index: int) -> Dict[str, Tensor]:
    """A full WaveNet state_dict -> the shard that rank `model_index` of a model group
    of `model_size` holds (`parallel/sharding_rules.py`: the r-th block of each half of
    the gate channels, the matching rows of the out and skip kernels); replicated
    entries as they are. The shard loads into `parallel.tensor_parallel.shard_wavenet`'s
    model. The inverse of `join_wavenet_shards`."""
    out = {}
    for name, t in state_dict.items():
        where = shard_index(name, t.shape, hp, model_size, model_index)
        out[name] = t if where is None else t.index_select(where[0], where[1].to(t.device))
    return out


def join_wavenet_shards(shards: Sequence[Mapping[str, Tensor]], hp) -> Dict[str, Tensor]:
    """The shards of every rank of a model group, in rank order -> the full WaveNet
    state_dict (the layout a checkpoint holds). The inverse of `split_wavenet_state`."""
    m = len(shards)
    out = {}
    for name, t in shards[0].items():
        where = shard_index(name, t.shape, hp, m, 0)
        if where is None:
            out[name] = t
            continue
        axis = where[0]
        shape = list(t.shape)
        shape[axis] *= m
        full = torch.zeros(shape, dtype=t.dtype, device=t.device)
        for r, shard in enumerate(shards):
            full.index_copy_(axis, shard_index(name, t.shape, hp, m, r)[1].to(t.device),
                             shard[name])
        out[name] = full
    return out


def stream_state_from_jax(state: Sequence, hp, batch: int) -> Tuple[Tensor, Tensor, int]:
    """The JAX AR kernel's streaming state -> the port's (`ops/wavenet_ar.py`).

    `state` is what `generate_ar(..., return_state=True)` returns
    (`wavenet_ar.py:709-711`): a tuple of L ring buffers (win, B_PAD, R), the
    next-step h (B_PAD, R) and the step offset t0, as numpy arrays or scalars.
    Keeps the first `batch` rows (B_PAD holds sublane padding) and lays the rings
    out as the port does: (batch, ring_floats), layer after layer, slot-major.
    Returns (rings, h, t_base)."""
    bufs, prev, t0 = state
    rings = []
    for buf, (_, win) in zip(bufs, ring_layout(hp), strict=True):
        buf = np.asarray(buf, np.float32)
        if buf.shape[0] != win or buf.shape[2] != hp.residual_channels:
            raise ValueError(f'ring of shape {buf.shape}, expected ({win}, B_PAD, '
                             f'{hp.residual_channels})')
        rings.append(buf[:, :batch].transpose(1, 0, 2).reshape(batch, -1))
    return (_t(np.concatenate(rings, axis=1)), _t(np.asarray(prev)[:batch]),
            int(np.asarray(t0)))


def save_checkpoint(path: str, kind: str, state_dict: Mapping[str, Tensor]) -> None:
    """Write a state_dict for the CLI (`kind` is 'tacotron' or 'wavenet')."""
    torch.save({'kind': kind,
                'state_dict': {k: v.detach().cpu() for k, v in state_dict.items()}}, path)


def load_checkpoint(path: str, kind: str) -> Dict[str, Tensor]:
    """Read a state_dict written by save_checkpoint, checking its kind."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    if ckpt.get('kind') != kind:
        raise ValueError(f'{path} holds a {ckpt.get("kind")!r} checkpoint, not {kind!r}')
    return ckpt['state_dict']


def load_wavenet(path: str, hp, step=None) -> WaveNet:
    """The WaveNet to synthesize with, on the CPU: from a `save_checkpoint` file, or,
    where `path` is a directory, from the checkpoints the port's trainer wrote there
    (`logs-<name>/wave_pretrained`), the EMA weights of `step`: None or 'latest', a step
    number, or 'best', the step whose natural eval scored best in the eval-history
    sidecar (`checkpoint_select.resolve_best_checkpoint`; the latest, and a message,
    where there is no history). A file whose weight normalization is folded (what
    `wavenet_state_dict` makes of a JAX checkpoint by default) loads into a model built
    without it, whatever hp.wavenet_weight_normalization says. Counterpart of
    `Synthesizer.load`, `inference/wavenet_synthesizer.py:28-69`."""
    if not os.path.isdir(path):
        if step not in (None, 'latest'):
            raise ValueError(f'--wavenet_checkpoint_step {step} needs a checkpoint '
                             f'directory of the trainer; {path} is one file')
        sd = load_checkpoint(path, 'wavenet')
        folded = not any('.parametrizations.' in k for k in sd)
        wavenet = WaveNet(hp.replace(wavenet_weight_normalization=False) if folded else hp)
        wavenet.load_state_dict(sd)
        return wavenet
    wavenet = WaveNet(hp)
    ckpt = CheckpointManager(path)
    if ckpt.latest_step() is None:
        raise FileNotFoundError(f'no checkpoint in {path}')
    if step == 'best':
        resolved = checkpoint_select.resolve_best_checkpoint(path, ckpt.all_steps())
        if resolved is None:
            print(f'No natural-eval history next to {path}: falling back to the latest '
                  'checkpoint', flush=True)
            step = None
        else:
            step, reason = resolved
            print(f'Selected WaveNet checkpoint step {step} by natural eval: {reason}',
                  flush=True)
    step = None if step in (None, 'latest') else int(step)
    state = ckpt.restore(step)
    wavenet.load_state_dict(state['ema_model'])
    print(f'Loaded WaveNet checkpoint at step {state["step"]} (EMA weights)', flush=True)
    return wavenet


def tacotron_model(state_dict: Mapping[str, Tensor], hp) -> Tacotron:
    """A Tacotron of `hp` holding `state_dict`, loaded strictly: with the CBHG linear
    post-net where `state_dict` holds it, without it where it does not (a network
    converted for synthesis alone), whatever hp.predict_linear says."""
    linear = any(k.startswith('cbhg_') for k in state_dict)
    taco = Tacotron(hp if bool(hp.predict_linear) == linear
                    else hp.replace(predict_linear=linear))
    taco.load_state_dict(state_dict)
    return taco


def load_tacotron(path: str, hp, step=None) -> Tacotron:
    """The Tacotron to synthesize with, on the CPU (`tacotron_model`): from a
    `save_checkpoint` file, or, where `path` is a directory, from the checkpoints the
    port's trainer wrote there (`logs-<name>/taco_pretrained`), those of `step`: None or
    'latest', or a step number."""
    if not os.path.isdir(path):
        if step not in (None, 'latest'):
            raise ValueError(f'--tacotron_checkpoint_step {step} needs a checkpoint '
                             f'directory of the trainer; {path} is one file')
        return tacotron_model(load_checkpoint(path, 'tacotron'), hp)
    ckpt = CheckpointManager(path)
    if ckpt.latest_step() is None:
        raise FileNotFoundError(f'no checkpoint in {path}')
    state = ckpt.restore(None if step in (None, 'latest') else int(step))
    print(f'Loaded Tacotron checkpoint at step {state["step"]}', flush=True)
    return tacotron_model(state['model'], hp)


def load_models(tacotron_checkpoint: str, wavenet_checkpoint: str, hp, device,
                wavenet_step=None, tacotron_step=None) -> Tuple[Tacotron, WaveNet]:
    """Both models on `device`, in eval mode: Tacotron as `load_tacotron` finds it, the
    WaveNet as `load_wavenet` does."""
    taco = load_tacotron(tacotron_checkpoint, hp, tacotron_step)
    wavenet = load_wavenet(wavenet_checkpoint, hp, wavenet_step)
    return taco.to(device).eval(), wavenet.to(device).eval()
