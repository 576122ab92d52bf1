"""Location-sensitive attention (counterpart of
`tacotron2_tpu/models/tacotron/attention.py`).

    energy = v_a . tanh(keys + W_query(query) + W_loc(conv(prev_alignments)) + b_a)

The memory projection (keys) is computed once per utterance by the model. The location
conv is a SAME conv1d (kernel 31 by default: 15 on each side) on the (B, 1, T_in)
alignment state. Masked positions get NEG_INF and the softmax runs in f32.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

NEG_INF = -2.0 ** 32 + 1.0


def constraint_mask(max_attention: Tensor, T: int, constraint_type: str,
                    win_size: int) -> Tensor:
    """(B, T) float 0/1: the positions the synthesis-time constraint leaves open
    around the previous alignment argmax (attention.py:75-87)."""
    pos = torch.arange(T, device=max_attention.device)[None, :]
    prev = max_attention[:, None]
    if constraint_type == 'monotonic':
        before = pos < prev
        after = pos >= prev + win_size
    else:  # window: the backward side gets the odd extra slot
        back = win_size // 2 + (win_size % 2 != 0)
        fwd = win_size // 2
        before = pos < prev - back
        after = pos >= prev + fwd
    return (~(before | after)).float()


class LocationSensitiveAttention(nn.Module):
    def __init__(self, query_dim: int, attention_dim: int = 128, filters: int = 32,
                 kernel: int = 31, cumulate: bool = True, smoothing: bool = False,
                 synthesis_constraint: bool = False, constraint_type: str = 'window',
                 win_size: int = 7):
        super().__init__()
        self.cumulate = cumulate
        self.smoothing = smoothing
        self.synthesis_constraint = synthesis_constraint
        self.constraint_type = constraint_type
        self.win_size = win_size
        self.query_layer = nn.Linear(query_dim, attention_dim, bias=False)
        self.location_convolution = nn.Conv1d(1, filters, kernel, padding='same')
        self.location_layer = nn.Linear(filters, attention_dim, bias=False)
        self.v_a = nn.Parameter(torch.zeros(1, attention_dim))
        self.b_a = nn.Parameter(torch.zeros(attention_dim))

    def forward(self, query: Tensor, prev_alignments: Tensor, prev_max_attention: Tensor,
                keys: Tensor, values: Tensor, memory_mask: Optional[Tensor]
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """One attention step.

        Args:
            query: (B, Q) decoder LSTM output.
            prev_alignments: (B, T) attention state (cumulative if cumulate).
            prev_max_attention: (B,) int argmax of the previous alignments.
            keys: (B, T, D) memory projection.
            values: (B, T, M) encoder outputs (masked if hp.mask_encoder).
            memory_mask: (B, T) float 0/1, or None.
        Returns: (context (B, M), alignments (B, T), next_state (B, T), max_attention (B,))
        """
        T = keys.shape[1]
        processed_query = self.query_layer(query)[:, None, :]
        f = self.location_convolution(prev_alignments[:, None, :]).transpose(1, 2)
        processed_location = self.location_layer(f)
        energy = torch.sum(
            self.v_a[0] * torch.tanh(keys + processed_query + processed_location + self.b_a),
            dim=2)
        mask = memory_mask
        if self.synthesis_constraint:
            win = constraint_mask(prev_max_attention, T, self.constraint_type,
                                  self.win_size)
            mask = win if mask is None else mask * win
        if mask is not None:
            energy = torch.where(mask > 0, energy, torch.full_like(energy, NEG_INF))
        energy = energy.float()
        if self.smoothing:
            sig = torch.sigmoid(energy)
            alignments = sig / sig.sum(dim=-1, keepdim=True)
        else:
            alignments = F.softmax(energy, dim=-1)
        max_attention = torch.argmax(alignments, dim=-1)
        next_state = alignments + prev_alignments if self.cumulate else alignments
        context = torch.einsum('bt,btm->bm', alignments, values)
        return context, alignments, next_state, max_attention
