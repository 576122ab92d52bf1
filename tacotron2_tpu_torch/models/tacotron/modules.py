"""Tacotron building blocks in their synthesis (eval) form
(counterpart of `tacotron2_tpu/models/tacotron/modules.py`).

Zoneout uses its expectation form, BatchNorm its running statistics, and the prenet
dropout, which stays on at synthesis, takes explicit pre-scaled masks.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn


def lstm_gates(z: Tensor, c_prev: Tensor) -> Tuple[Tensor, Tensor]:
    """LSTM nonlinearity on gate pre-activations ordered i, g, f, o, with the +1.0
    forget bias applied here (tf LSTMCell's forget_bias). Returns (c_new, h_new)."""
    i, g, f, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return c_new, h_new


class ZoneoutLSTMCell(nn.Module):
    """LSTM cell with zoneout on c and h, expectation form:
    c = (1 - z) * c_new + z * c_prev (the same for h). The step's output is h_new,
    not the zoned h. `gates` maps [x, h] to the i, g, f, o pre-activations."""

    def __init__(self, input_size: int, units: int, zoneout_cell: float = 0.1,
                 zoneout_output: float = 0.1):
        super().__init__()
        self.units = units
        self.zoneout_cell = zoneout_cell
        self.zoneout_output = zoneout_output
        self.gates = nn.Linear(input_size + units, 4 * units)

    def forward(self, state: Tuple[Tensor, Tensor], x: Tensor
                ) -> Tuple[Tuple[Tensor, Tensor], Tensor]:
        c_prev, h_prev = state
        c_new, h_new = lstm_gates(self.gates(torch.cat([x, h_prev], dim=-1)), c_prev)
        zc, zh = self.zoneout_cell, self.zoneout_output
        c = (1.0 - zc) * c_new + zc * c_prev
        h = (1.0 - zh) * h_new + zh * h_prev
        return (c, h), h_new

    def initial_state(self, batch: int, device=None) -> Tuple[Tensor, Tensor]:
        z = torch.zeros(batch, self.units, device=device)
        return z, z


class Prenet(nn.Module):
    """Dense + ReLU layers, each followed by dropout that stays on at synthesis; the
    dropout comes in as masks already scaled by 1/keep."""

    def __init__(self, in_dim: int, layer_sizes: Sequence[int] = (256, 256)):
        super().__init__()
        dims = [in_dim, *layer_sizes]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: Tensor, masks: Sequence[Tensor]) -> Tensor:
        for layer, m in zip(self.layers, masks):
            x = torch.relu(layer(x)) * m
        return x


class ConvBlock(nn.Module):
    """conv1d (SAME) -> activation -> BatchNorm for bnorm='after', BatchNorm ->
    activation for 'before'; BatchNorm eps 1e-3 over running statistics.
    Works on (B, C, T)."""

    def __init__(self, in_channels: int, kernel_size: int, channels: int,
                 activation: Optional[str] = 'relu', bnorm: str = 'after'):
        super().__init__()
        if bnorm not in ('before', 'after'):
            raise ValueError(f'unknown batch_norm_position {bnorm!r}')
        self.activation = activation
        self.bnorm = bnorm
        self.conv = nn.Conv1d(in_channels, channels, kernel_size, padding='same')
        self.bn = nn.BatchNorm1d(channels, eps=1e-3)

    def _act(self, y: Tensor) -> Tensor:
        if self.activation == 'relu':
            return torch.relu(y)
        if self.activation == 'tanh':
            return torch.tanh(y)
        return y

    def _bn(self, y: Tensor) -> Tensor:
        bn = self.bn
        return F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            training=False, eps=bn.eps)

    def forward(self, x: Tensor) -> Tensor:
        y = self.conv(x)
        if self.bnorm == 'after':
            return self._bn(self._act(y))
        return self._act(self._bn(y))


class EncoderConvolutions(nn.Module):
    """enc_conv_num_layers ReLU conv blocks over (B, T, C)."""

    def __init__(self, in_channels: int, num_layers: int = 3, kernel_size: int = 5,
                 channels: int = 512, bnorm: str = 'after'):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvBlock(in_channels if i == 0 else channels, kernel_size, channels,
                      'relu', bnorm) for i in range(num_layers))

    def forward(self, x: Tensor) -> Tensor:
        x = x.transpose(1, 2)
        for conv in self.convs:
            x = conv(x)
        return x.transpose(1, 2)


def reverse_sequences(x: Tensor, lengths: Tensor) -> Tensor:
    """Reverse each row's first lengths[b] steps of (B, T, C), padding in place."""
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)[None, :]
    lens = lengths.to(x.device)[:, None]
    rev = torch.where(pos < lens, lens - 1 - pos, pos)
    return torch.gather(x, 1, rev[..., None].expand(-1, -1, x.shape[2]))


class BiZoneoutLSTM(nn.Module):
    """Bidirectional zoneout-LSTM over the valid region of each sequence: the backward
    direction reverses only the first lengths[b] steps, the state freezes on padded
    steps, and the output there is zero."""

    def __init__(self, input_size: int, units: int = 256, zoneout: float = 0.1):
        super().__init__()
        self.fw = ZoneoutLSTMCell(input_size, units, zoneout, zoneout)
        self.bw = ZoneoutLSTMCell(input_size, units, zoneout, zoneout)

    @staticmethod
    def _run(cell: ZoneoutLSTMCell, seq: Tensor, mask: Tensor) -> Tensor:
        B, T, C = seq.shape
        K = cell.gates.weight.t()                       # (C+U, 4U)
        xp = seq @ K[:C] + cell.gates.bias              # input half, hoisted: (B, T, 4U)
        Kh = K[C:]
        zc, zh = cell.zoneout_cell, cell.zoneout_output
        c, h = cell.initial_state(B, seq.device)
        outs = []
        for t in range(T):
            c_new, h_new = lstm_gates(xp[:, t] + h @ Kh, c)
            m = mask[:, t, None] > 0
            c = torch.where(m, (1.0 - zc) * c_new + zc * c, c)
            h = torch.where(m, (1.0 - zh) * h_new + zh * h, h)
            outs.append(h_new * mask[:, t, None])
        return torch.stack(outs, dim=1)

    def forward(self, x: Tensor, lengths: Tensor) -> Tensor:
        T = x.shape[1]
        mask = (torch.arange(T, device=x.device)[None, :]
                < lengths.to(x.device)[:, None]).to(x.dtype)
        fw = self._run(self.fw, x, mask)
        bw = reverse_sequences(self._run(self.bw, reverse_sequences(x, lengths), mask),
                               lengths)
        return torch.cat([fw, bw], dim=-1)


class Postnet(nn.Module):
    """num_layers conv blocks over (B, T, C), tanh on all but the last."""

    def __init__(self, in_channels: int, num_layers: int = 5, kernel_size: int = 5,
                 channels: int = 512, bnorm: str = 'after'):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvBlock(in_channels if i == 0 else channels, kernel_size, channels,
                      'tanh' if i < num_layers - 1 else None, bnorm)
            for i in range(num_layers))

    def forward(self, x: Tensor) -> Tensor:
        x = x.transpose(1, 2)
        for conv in self.convs:
            x = conv(x)
        return x.transpose(1, 2)
