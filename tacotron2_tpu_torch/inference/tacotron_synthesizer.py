"""Tacotron batch synthesis, text -> mel (counterpart of
`tacotron2_tpu/inference/tacotron_synthesizer.py`, the free-running path)."""

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from ..models.tacotron.model import Tacotron, output_range
from ..text import text_to_sequence
from ..utils import round_up


class Synthesizer:
    def __init__(self, model: Tacotron, hp, device):
        self._model = model.eval()
        self._hp = hp
        self._device = torch.device(device)
        self._cleaners = [c.strip() for c in hp.cleaners.split(',')]

    def _prepare_text_batch(self, texts: Sequence[str]) -> Tuple[List[str], np.ndarray,
                                                                 np.ndarray]:
        """Pad the batch to the synthesis batch size by repeating the last text, and
        round T_in up to pad_text_multiple (tacotron_synthesizer.py:87-100)."""
        hp = self._hp
        bs = hp.tacotron_synthesis_batch_size
        texts = list(texts)
        if len(texts) < bs:
            texts = texts + [texts[-1]] * (bs - len(texts))
        seqs = [np.asarray(text_to_sequence(t, self._cleaners), np.int64) for t in texts]
        input_lengths = np.asarray([len(s) for s in seqs], np.int64)
        T_in = round_up(int(input_lengths.max()), hp.pad_text_multiple)
        inputs = np.stack([np.pad(s, (0, T_in - len(s))) for s in seqs])
        return texts, inputs, input_lengths

    def synthesize(self, texts: Sequence[str], generator: torch.Generator
                   ) -> Tuple[Tensor, List[int], int]:
        """Free-running decode of a batch.

        Returns (mel, lengths, decoded_frames): mel is the (len(texts), T, num_mels)
        output clipped to [lo, hi] and left on the device, padded to the decode
        length; lengths are the per-text frame counts from the stop tokens;
        decoded_frames counts every frame the decoder computed, padding rows included."""
        hp = self._hp
        n_real = len(texts)
        _, inputs, input_lengths = self._prepare_text_batch(texts)
        out = self._model(torch.from_numpy(inputs).to(self._device),
                          torch.from_numpy(input_lengths).to(self._device),
                          max_iters=hp.max_iters, generator=generator)
        stop_logits = out['stop_token_prediction'].cpu().numpy()
        lengths = self._get_output_lengths(stop_logits)
        lo, hi = output_range(hp)
        mel = torch.clamp(out['mel_outputs'][:n_real], lo, hi)
        return mel, lengths[:n_real], int(np.prod(stop_logits.shape))

    def _get_output_lengths(self, stop_logits: np.ndarray) -> List[int]:
        """First frame whose stop probability exceeds 0.5, floored at 4*r frames
        (tacotron_synthesizer.py:216-225)."""
        with np.errstate(over='ignore'):  # suppressed stops: exp(-logit) -> inf, p -> 0
            probs = 1.0 / (1.0 + np.exp(-stop_logits))
        lengths = []
        for row in probs:
            idx = np.where(row > 0.5)[0]
            n = int(idx[0]) + 1 if len(idx) else len(row)
            lengths.append(max(n, 4 * self._hp.outputs_per_step))
        return lengths
