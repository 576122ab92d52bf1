"""Map flax parameter trees (numpy) onto the port's state_dicts, and save / load them;
map the JAX AR kernel's streaming state onto the port's.

The trees are what the JAX package's `create_train_state` or a checkpoint restore
holds, with every leaf turned into a numpy array. The layout changes:
  - Dense kernel (in, out)            -> Linear.weight (out, in)
  - Conv kernel (k, in, out)          -> Conv1d.weight (out, in, k)
  - SubPixel conv kernel (3, 3, 1, s) -> Conv2d.weight (s, 1, 3, 3)  (HWIO -> OIHW)
  - 2D transpose-conv kernel (fk, s, 1, 1) -> ConvTranspose2d.weight (1, 1, fk, s),
    flipped on both spatial axes (lax.conv_transpose with transpose_kernel=False
    correlates with the kernel as it is; torch's transpose conv flips it)
  - BatchNorm scale/bias + batch_stats mean/var -> BatchNorm1d weight/bias/running_*
  - LSTM `gates` kernels keep their i, g, f, o order (the +1.0 forget bias is applied
    by the cell, not stored)
  - weight normalization is folded: kernel = g * v / ||v||, the norm over every axis
    but the last (tacotron2_tpu/ops/pallas/wavenet_ar.py:80-89).
"""

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from .models.tacotron.model import Tacotron
from .models.wavenet.model import WaveNet
from .ops.wavenet_ar import ring_layout


def _t(x) -> Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _kernel(conv: Mapping) -> np.ndarray:
    v = np.asarray(conv['kernel'], np.float32)
    if 'wn_g' not in conv:
        return v
    axes = tuple(range(v.ndim - 1))
    norm = np.sqrt(np.sum(np.square(v), axis=axes, keepdims=True) + 1e-8)
    return (np.asarray(conv['wn_g'], np.float32) * v / norm).astype(np.float32)


def _dense(sd: Dict[str, Tensor], prefix: str, p: Mapping) -> None:
    sd[prefix + '.weight'] = _t(_kernel(p).T)
    if 'bias' in p:
        sd[prefix + '.bias'] = _t(p['bias'])


def _conv1d(sd: Dict[str, Tensor], prefix: str, p: Mapping) -> None:
    sd[prefix + '.weight'] = _t(_kernel(p).transpose(2, 1, 0))
    if 'bias' in p:
        sd[prefix + '.bias'] = _t(p['bias'])


def _conv_block(sd, prefix: str, p: Mapping, stats: Mapping) -> None:
    _conv1d(sd, prefix + '.conv', p['conv'])
    sd[prefix + '.bn.weight'] = _t(p['bn']['scale'])
    sd[prefix + '.bn.bias'] = _t(p['bn']['bias'])
    sd[prefix + '.bn.running_mean'] = _t(stats['bn']['mean'])
    sd[prefix + '.bn.running_var'] = _t(stats['bn']['var'])
    sd[prefix + '.bn.num_batches_tracked'] = torch.tensor(0, dtype=torch.long)


def _conv_stack(sd, prefix: str, params: Mapping, stats: Mapping) -> None:
    n = len([k for k in params if k.startswith('conv_')])
    for i in range(n):
        name = f'conv_{i + 1}'
        _conv_block(sd, f'{prefix}.convs.{i}', params[name], stats[name])


def tacotron_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, Tensor]:
    """flax Tacotron `params` + `batch_stats` -> state_dict of models.tacotron.Tacotron.
    CBHG parameters (predict_linear) are not part of the port and are ignored."""
    sd: Dict[str, Tensor] = {}
    sd['inputs_embedding.weight'] = _t(params['inputs_embedding'])
    _conv_stack(sd, 'encoder_convolutions', params['encoder_convolutions'],
                batch_stats['encoder_convolutions'])
    for d in ('fw', 'bw'):
        _dense(sd, f'encoder_lstm.{d}.gates', params['encoder_lstm'][d]['gates'])
    _dense(sd, 'attention_memory_layer', params['attention_memory_layer'])

    dec = params['decoder']
    _dense(sd, 'decoder.prenet.layers.0', dec['prenet']['dense_1'])
    _dense(sd, 'decoder.prenet.layers.1', dec['prenet']['dense_2'])
    _dense(sd, 'decoder.lstm_1.gates', dec['lstm_1']['gates'])
    _dense(sd, 'decoder.lstm_2.gates', dec['lstm_2']['gates'])
    att = dec['attention']
    _dense(sd, 'decoder.attention.query_layer', att['query_layer'])
    _conv1d(sd, 'decoder.attention.location_convolution', att['location_convolution'])
    _dense(sd, 'decoder.attention.location_layer', att['location_layer'])
    sd['decoder.attention.v_a'] = _t(att['attention_variable_projection'])
    sd['decoder.attention.b_a'] = _t(att['attention_bias'])
    _dense(sd, 'decoder.frame_projection', dec['frame_projection'])
    _dense(sd, 'decoder.stop_projection', dec['stop_projection'])

    _conv_stack(sd, 'postnet_convolutions', params['postnet_convolutions'],
                batch_stats['postnet_convolutions'])
    _dense(sd, 'postnet_projection', params['postnet_projection'])
    return sd


def wavenet_state_dict(params: Mapping) -> Dict[str, Tensor]:
    """flax WaveNet `params` -> state_dict of models.wavenet.WaveNet (weight norm
    folded). The first conv is (1, R) for scalar input and (Q, R) for one-hot input;
    a multi-speaker model also holds the `gc_embedding` table and every block's
    `conv1x1g`."""
    sd: Dict[str, Tensor] = {}
    _dense(sd, 'first_conv', params['first_conv'])
    if 'gc_embedding' in params:
        sd['gc_embedding.weight'] = _t(params['gc_embedding']['embedding'])
    n = len([k for k in params if k.startswith('residual_block_')])
    for i in range(n):
        blk = params[f'residual_block_{i + 1}']
        pre = f'residual_layers.{i}'
        _conv1d(sd, pre + '.conv', blk['causal_conv'])
        if 'conv1x1c' in blk:
            _dense(sd, pre + '.conv1x1c', blk['conv1x1c'])
        if 'conv1x1g' in blk:
            _dense(sd, pre + '.conv1x1g', blk['conv1x1g'])
        _dense(sd, pre + '.conv1x1_out', blk['conv1x1_out'])
        _dense(sd, pre + '.conv1x1_skip', blk['conv1x1_skip'])
    _dense(sd, 'skip_conv1', params['skip_conv1'])
    _dense(sd, 'skip_conv2', params['skip_conv2'])
    ups = params.get('upsample_network', {})
    layouts = {'subpixel_conv': lambda k: k.transpose(3, 2, 0, 1),
               'convt2d': lambda k: k[::-1, ::-1].transpose(2, 3, 0, 1)}
    kinds = {name.rsplit('_', 1)[0] for name in ups}
    if len(kinds) > 1 or not kinds <= set(layouts):
        raise NotImplementedError('only the SubPixel and 2D upsamplers are ported '
                                  f'(upsample_network holds {sorted(ups)})')
    for kind in kinds:
        for i in range(len(ups)):
            p = ups[f'{kind}_{i + 1}']
            sd[f'upsample.convs.{i}.weight'] = _t(layouts[kind](_kernel(p)))
            sd[f'upsample.convs.{i}.bias'] = _t(p['bias'])
    return sd


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


def load_models(tacotron_checkpoint: str, wavenet_checkpoint: str, hp, device
                ) -> Tuple[Tacotron, WaveNet]:
    """Both models from save_checkpoint files, on `device`, in eval mode."""
    taco = Tacotron(hp)
    taco.load_state_dict(load_checkpoint(tacotron_checkpoint, 'tacotron'))
    wavenet = WaveNet(hp)
    wavenet.load_state_dict(load_checkpoint(wavenet_checkpoint, 'wavenet'))
    return taco.to(device).eval(), wavenet.to(device).eval()
