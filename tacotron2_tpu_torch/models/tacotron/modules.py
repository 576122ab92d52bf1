"""Tacotron building blocks (counterpart of `tacotron2_tpu/models/tacotron/modules.py`).

Each block runs in its synthesis form (zoneout's expectation, BatchNorm over running
statistics, no dropout but the prenet's) or, with `train=True` or explicit masks, in
its training form: dropout and zoneout from keep-masks given as bool tensors in the
layout of the JAX draws (batch-major (B, T, C) for convolutions, time-major (T, B, U)
for recurrences), BatchNorm over the batch statistics with flax's running update. Masks
are drawn by the model from a torch.Generator, or passed in where they must be shared.

`dtype` is flax's compute dtype (`models/precision.py`): each Dense, Conv and LSTM or
GRU gate product casts to it, BatchNorm computes in float32. Under data parallelism
(`sync_batch_norm`) BatchNorm's batch statistics are those of the global batch, as flax
computes them under GSPMD: the per-channel sum, sum of squares and count all-reduced
over the data group.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ...ops.gru_scan import gru_scan
from ...ops.lstm_scan import lstm_scan
from ...parallel.collectives import all_reduce_sum, global_sum
from ..precision import cast_forward, sigmoid, weak

BN_MOMENTUM = 0.99
BN_EPS = 1e-3


def lstm_gates(z: Tensor, c_prev: Tensor) -> Tuple[Tensor, Tensor]:
    """LSTM nonlinearity on gate pre-activations ordered i, g, f, o, with the +1.0
    forget bias applied here (tf LSTMCell's forget_bias). Returns (c_new, h_new)."""
    i, g, f, o = z.chunk(4, dim=-1)
    c_new = sigmoid(f + 1.0) * c_prev + sigmoid(i) * torch.tanh(g)
    h_new = sigmoid(o) * torch.tanh(c_new)
    return c_new, h_new


def dropout(x: Tensor, rate: float, keep: Tensor) -> Tensor:
    """x / (1 - rate) where `keep` (bool) holds, 0 elsewhere (`modules.py:56-61`)."""
    if rate == 0.0:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


def zoneout(new: Tensor, old: Tensor, rate: float, keep: Optional[Tensor]) -> Tensor:
    """A recurrent state under zoneout. Training, with the bool keep-mask `keep`: the
    state takes `new` where `keep` holds and keeps `old` elsewhere (the JAX cells'
    (1 - z) * dropout(new - old, z) + old but for rounding, and the fused decoder's
    keep-gates). Where `keep` is None, its expectation (1 - z) * new + z * old; in a
    reduced dtype as the JAX fused decoder forms it, k * new + (1 - k) * old with
    k = 1 - z in that dtype (`fused_decoder.py:526-544`)."""
    if keep is None:
        if new.dtype == torch.float32:
            return (1.0 - rate) * new + rate * old
        k = weak(1.0 - rate, new.dtype)
        return k * new + (1.0 - k) * old
    return torch.where(keep, new, old)


class ZoneoutLSTMCell(nn.Module):
    """LSTM cell with zoneout on c and h (`zoneout`: the expectation, or with keep-masks
    the training form). The step's output is h_new, not the zoned h. `gates` maps
    [x, h] to the i, g, f, o pre-activations."""

    def __init__(self, input_size: int, units: int, zoneout_cell: float = 0.1,
                 zoneout_output: float = 0.1):
        super().__init__()
        self.units = units
        self.zoneout_cell = zoneout_cell
        self.zoneout_output = zoneout_output
        self.gates = nn.Linear(input_size + units, 4 * units)

    def forward(self, state: Tuple[Tensor, Tensor], x: Tensor,
                keep_c: Optional[Tensor] = None, keep_h: Optional[Tensor] = None,
                dtype: torch.dtype = torch.float32) -> Tuple[Tuple[Tensor, Tensor], Tensor]:
        c_prev, h_prev = state
        c_new, h_new = lstm_gates(cast_forward(self.gates, torch.cat([x, h_prev], dim=-1),
                                               dtype), c_prev)
        c = zoneout(c_new, c_prev, self.zoneout_cell, keep_c)
        h = zoneout(h_new, h_prev, self.zoneout_output, keep_h)
        return (c, h), h_new

    def initial_state(self, batch: int, device=None,
                      dtype: torch.dtype = torch.float32) -> Tuple[Tensor, Tensor]:
        z = torch.zeros(batch, self.units, device=device, dtype=dtype)
        return z, z


class Prenet(nn.Module):
    """Dense + ReLU layers, each followed by dropout that stays on at synthesis; the
    dropout comes in as masks already scaled by 1/keep."""

    def __init__(self, in_dim: int, layer_sizes: Sequence[int] = (256, 256)):
        super().__init__()
        dims = [in_dim, *layer_sizes]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: Tensor, masks: Sequence[Tensor],
                dtype: torch.dtype = torch.float32) -> Tensor:
        for layer, m in zip(self.layers, masks, strict=True):
            x = torch.relu(cast_forward(layer, x, dtype)) * m.to(dtype)
        return x


class ConvBlock(nn.Module):
    """conv1d (SAME) -> activation -> BatchNorm for bnorm='after', BatchNorm ->
    activation for 'before', then dropout in training. Works on (B, C, T).

    BatchNorm (eps 1e-3) normalizes over the running statistics, or with `train` over
    the batch's: the mean and the biased variance mean(x^2) - mean^2 over (B, T),
    padded frames included, each running statistic then moved to
    0.99 * itself + 0.01 * the batch's (flax's BatchNorm, `modules.py:99-106`).
    `stats_group` (set by `sync_batch_norm`): the data group over which the batch
    statistics are taken, None for this process's batch alone."""

    def __init__(self, in_channels: int, kernel_size: int, channels: int,
                 activation: Optional[str] = 'relu', bnorm: str = 'after',
                 drop_rate: float = 0.0):
        super().__init__()
        if bnorm not in ('before', 'after'):
            raise ValueError(f'unknown batch_norm_position {bnorm!r}')
        self.activation = activation
        self.bnorm = bnorm
        self.drop_rate = drop_rate
        self.conv = nn.Conv1d(in_channels, channels, kernel_size, padding='same')
        self.bn = nn.BatchNorm1d(channels, eps=BN_EPS)
        self.stats_group = None

    def _act(self, y: Tensor) -> Tensor:
        if self.activation == 'relu':
            return torch.relu(y)
        if self.activation == 'tanh':
            return torch.tanh(y)
        return y

    def _bn(self, y: Tensor, train: bool) -> Tensor:
        bn = self.bn
        y = y.float()  # flax's BatchNorm(dtype=float32), whatever the conv's dtype
        if not train:
            return F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                training=False, eps=bn.eps)
        if self.stats_group is None:
            mean = y.mean(dim=(0, 2))
            mean_sq = torch.square(y).mean(dim=(0, 2))
        else:  # the global batch's: sums and count over the data group
            sums = all_reduce_sum(torch.stack([y.sum(dim=(0, 2)),
                                               torch.square(y).sum(dim=(0, 2))]),
                                  self.stats_group)
            count = global_sum(torch.tensor(float(y.shape[0] * y.shape[2]), device=y.device),
                               self.stats_group)
            mean, mean_sq = sums[0] / count, sums[1] / count
        var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return (y - mean[:, None]) * mul[:, None] + bn.bias[:, None]

    def forward(self, x: Tensor, train: bool = False, keep: Optional[Tensor] = None,
                dtype: torch.dtype = torch.float32) -> Tensor:
        """`keep`: the dropout keep-mask (B, T, C), needed with `train` when the
        block's dropout rate is nonzero. The conv and an activation before BatchNorm
        run in `dtype`; the output is float32."""
        y = cast_forward(self.conv, x, dtype)
        if self.bnorm == 'after':
            y = self._bn(self._act(y), train)
        else:
            y = self._act(self._bn(y, train))
        if train and self.drop_rate > 0.0:
            y = dropout(y, self.drop_rate, keep.transpose(1, 2))
        return y


def sync_batch_norm(model: nn.Module, group) -> nn.Module:
    """Take the batch statistics of every ConvBlock of `model` over the data `group`
    (None: this process's batch alone). Returns `model`."""
    for module in model.modules():
        if isinstance(module, ConvBlock):
            module.stats_group = group
    return model


class _ConvStack(nn.Module):
    """Conv blocks over (B, T, C); `keeps` holds one dropout keep-mask a block."""

    def forward(self, x: Tensor, train: bool = False,
                keeps: Optional[Sequence[Tensor]] = None,
                dtype: torch.dtype = torch.float32) -> Tensor:
        x = x.transpose(1, 2)
        for i, conv in enumerate(self.convs):
            x = conv(x, train, keeps[i] if keeps is not None else None, dtype)
        return x.transpose(1, 2)


class EncoderConvolutions(_ConvStack):
    """enc_conv_num_layers ReLU conv blocks over (B, T, C)."""

    def __init__(self, in_channels: int, num_layers: int = 3, kernel_size: int = 5,
                 channels: int = 512, bnorm: str = 'after', drop_rate: float = 0.0):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvBlock(in_channels if i == 0 else channels, kernel_size, channels,
                      'relu', bnorm, drop_rate) for i in range(num_layers))


class Postnet(_ConvStack):
    """num_layers conv blocks over (B, T, C), tanh on all but the last."""

    def __init__(self, in_channels: int, num_layers: int = 5, kernel_size: int = 5,
                 channels: int = 512, bnorm: str = 'after', drop_rate: float = 0.0):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvBlock(in_channels if i == 0 else channels, kernel_size, channels,
                      'tanh' if i < num_layers - 1 else None, bnorm, drop_rate)
            for i in range(num_layers))


def reverse_sequences(x: Tensor, lengths: Tensor) -> Tensor:
    """Reverse each row's first lengths[b] steps of (B, T, C), padding in place."""
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)[None, :]
    lens = lengths.to(x.device)[:, None]
    rev = torch.where(pos < lens, lens - 1 - pos, pos)
    return torch.gather(x, 1, rev[..., None].expand(-1, -1, x.shape[2]))


def length_mask(lengths: Tensor, T: int, device) -> Tensor:
    """(B, T) float mask of each row's first lengths[b] steps."""
    return (torch.arange(T, device=device)[None, :]
            < lengths.to(device)[:, None]).float()


class BiZoneoutLSTM(nn.Module):
    """Bidirectional zoneout-LSTM over the valid region of each sequence: the backward
    direction reverses only the first lengths[b] steps, the state freezes on padded
    steps, and the output there is zero. The input half of each gate product is hoisted
    out of the recurrence (`modules.py:161-170`), the backward direction's over its
    reversed sequence as the JAX scan hoists it (its gradient then sums the rows in that
    order); the recurrence of both directions runs through `ops/lstm_scan` (its kernels on
    the card, their plain versions elsewhere), which writes the backward direction's
    output back where each step's input was, in the input's dtype, as the JAX scan's state
    keeps it, its product with the kernel in `dtype` promoted."""

    def __init__(self, input_size: int, units: int = 256, zoneout: float = 0.1):
        super().__init__()
        self.fw = ZoneoutLSTMCell(input_size, units, zoneout, zoneout)
        self.bw = ZoneoutLSTMCell(input_size, units, zoneout, zoneout)

    @staticmethod
    def operands(cell: ZoneoutLSTMCell, seq: Tensor,
                 dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
        """(xp (B, T, 4U), the input half hoisted, W_hh (U, 4U)) of one cell's scan, each
        in `dtype` as flax casts the kernel and the bias."""
        C = seq.shape[-1]
        K = cell.gates.weight.t().to(dtype)                   # (C+U, 4U)
        return seq.to(dtype) @ K[:C] + cell.gates.bias.to(dtype), K[C:]

    def forward(self, x: Tensor, lengths: Tensor,
                keeps: Optional[Sequence[Tensor]] = None,
                dtype: torch.dtype = torch.float32) -> Tensor:
        """`keeps`: None (zoneout's expectation) or the four zoneout keep-masks
        (T, B, U) of training, forward c and h, then backward c and h, each indexed by
        the step of its own direction's scan."""
        cells = (self.fw, self.bw)
        xps, ws = zip(*(self.operands(cell, seq, dtype)
                        for cell, seq in zip(cells, (x, reverse_sequences(x, lengths)))))
        return lstm_scan(xps, ws, lengths, None if keeps is None else (keeps[:2], keeps[2:]),
                         [(cell.zoneout_cell, cell.zoneout_output) for cell in cells],
                         (False, True), x.dtype)


class HighwayNet(nn.Module):
    """H * T + x * (1 - T), H = relu(dense(x)), T = sigmoid(dense(x)) whose bias starts
    at -1 (`modules.py:228-239`)."""

    def __init__(self, units: int):
        super().__init__()
        self.H = nn.Linear(units, units)
        self.T = nn.Linear(units, units)

    def forward(self, x: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
        H = torch.relu(cast_forward(self.H, x, dtype))
        T = sigmoid(cast_forward(self.T, x, dtype))
        return H * T + x * (1.0 - T)


class GRU(nn.Module):
    """One direction of flax's GRUCell scanned over (B, T, C) (`modules.py:280-311`):
    r = sigmoid(W_ir x + b_ir + W_hr h), z = sigmoid(W_iz x + b_iz + W_hz h),
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn)), h' = (1 - z) * n + z * h.
    `input` holds W_ir, W_iz, W_in and their biases, `hidden` W_hr, W_hz, W_hn, and
    `bias_hn` b_hn, the one hidden-side bias. Padded steps freeze the state and output
    zero. The recurrence runs in the input's dtype promoted with `dtype` (the input's, as
    the JAX scan's state keeps it, in the model), through `ops/gru_scan`: its kernels on
    the card, their plain versions elsewhere."""

    def __init__(self, input_size: int, units: int):
        super().__init__()
        self.units = units
        self.input = nn.Linear(input_size, 3 * units)
        self.hidden = nn.Linear(units, 3 * units, bias=False)
        self.bias_hn = nn.Parameter(torch.zeros(units))

    def operands(self, seq: Tensor, dtype: torch.dtype) -> Tuple[Tensor, Tensor, Tensor]:
        """(ip (B, T, 3H), the input projection hoisted, W_hh (3H, H), b_hn) of the scan,
        each cast to `dtype` as flax casts them and then to the recurrence's dtype."""
        rd = torch.promote_types(seq.dtype, dtype)
        return (cast_forward(self.input, seq, dtype).to(rd),
                self.hidden.weight.to(dtype).to(rd), self.bias_hn.to(dtype).to(rd))

    def forward(self, seq: Tensor, mask: Tensor,
                dtype: torch.dtype = torch.float32) -> Tensor:
        ip, w, b = self.operands(seq, dtype)
        return gru_scan([ip], [w], [b], mask, None, (False,))


class BiGRU(nn.Module):
    """The CBHG's two GRUs in one `gru_scan`: `fw` over the steps, `bw` over each row's
    first lengths[b] steps backwards (its output where each step's input was), side by
    side. It holds no parameters of its own: its GRUs are the CBHG's `gru_fw` and
    `gru_bw`, referred to, not registered twice."""

    def __init__(self, fw: GRU, bw: GRU):
        super().__init__()
        self._grus = (fw, bw)

    def forward(self, seq: Tensor, mask: Tensor, lengths: Tensor,
                dtype: torch.dtype = torch.float32) -> Tensor:
        ips, ws, bs = zip(*(gru.operands(seq, dtype) for gru in self._grus))
        return gru_scan(ips, ws, bs, mask, lengths, (False, True))


class CBHG(nn.Module):
    """Conv bank (widths 1..K, ReLU, BatchNorm, no dropout) -> max-pool (width
    pool_size, stride 1, SAME: flax pads -inf on the right for a width of 2) -> two
    projection convs -> residual -> optional dense to the highway width -> highway
    layers -> bidirectional GRU (`modules.py:242-317`). Works on (B, T, C)."""

    def __init__(self, in_channels: int, K: int = 8, conv_channels: int = 128,
                 pool_size: int = 2, projections: Sequence[int] = (256, 80),
                 projection_kernel_size: int = 3, highway_layers: int = 4,
                 highway_units: int = 128, rnn_units: int = 128, bnorm: str = 'after'):
        super().__init__()
        self.pool_size = pool_size
        self.bank = nn.ModuleList(ConvBlock(in_channels, k, conv_channels, 'relu', bnorm)
                                  for k in range(1, K + 1))
        self.proj1 = ConvBlock(K * conv_channels, projection_kernel_size, projections[0],
                               'relu', bnorm)
        self.proj2 = ConvBlock(projections[0], projection_kernel_size, projections[1],
                               None, bnorm)
        self.highway_in = (nn.Linear(projections[1], highway_units)
                           if projections[1] != highway_units else None)
        self.highways = nn.ModuleList(HighwayNet(highway_units)
                                      for _ in range(highway_layers))
        self.gru_fw = GRU(highway_units, rnn_units)
        self.gru_bw = GRU(highway_units, rnn_units)
        self.bigru = BiGRU(self.gru_fw, self.gru_bw)

    def forward(self, x: Tensor, lengths: Optional[Tensor] = None,
                train: bool = False, dtype: torch.dtype = torch.float32) -> Tensor:
        B, T, _ = x.shape
        xt = x.transpose(1, 2)
        y = torch.cat([conv(xt, train, None, dtype) for conv in self.bank], dim=1)
        lo = (self.pool_size - 1) // 2
        y = F.max_pool1d(F.pad(y, (lo, self.pool_size - 1 - lo), value=float('-inf')),
                         self.pool_size, stride=1)
        y = self.proj2(self.proj1(y, train, None, dtype), train, None,
                       dtype).transpose(1, 2) + x
        if self.highway_in is not None:
            y = cast_forward(self.highway_in, y, dtype)
        for highway in self.highways:
            y = highway(y, dtype)
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.long, device=x.device)
        return self.bigru(y, length_mask(lengths, T, x.device), lengths, dtype)
