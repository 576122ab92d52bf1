"""WaveNet batch synthesis, mel -> wav (counterpart of
`tacotron2_tpu/inference/wavenet_synthesizer.py` and the generate dispatch of
`tacotron2_tpu/training/wavenet_trainer.py`).

The AR loop runs on the device of the conditioning: on a CUDA device through the
hand-written kernel, on the CPU through its plain PyTorch version. There is no batch
tiling; the kernel states its own limits.
"""

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from ..models.wavenet.model import WaveNet
from ..ops import wavenet_ar


def prepare_conditions(mels: Sequence[Tensor], hp) -> Tensor:
    """Clip to [lo, hi], pad every mel to the longest with lo, rescale to [0, 1]
    (wavenet_synthesizer.py:68-84). mels: (frames_i, num_mels) each, one device."""
    lo, hi = ((-hp.max_abs_value, hp.max_abs_value) if hp.symmetric_mels
              else (0.0, hp.max_abs_value))
    max_frames = max(int(m.shape[0]) for m in mels)
    out = []
    for m in mels:
        m = m.float()
        if hp.clip_for_wavenet:
            m = torch.clamp(m, lo, hi)
        out.append(F.pad(m, (0, 0, 0, max_frames - m.shape[0]), value=lo))
    c = torch.stack(out)
    if hp.normalize_for_wavenet:
        c = (c - lo) / (hi - lo)
    return c


class Synthesizer:
    def __init__(self, model: WaveNet, hp):
        self._model = model.eval()
        self._hp = hp
        self._weights = wavenet_ar.pack_params(model, hp)  # packed once per model

    @torch.no_grad()
    def synthesize(self, mels: Sequence[Tensor], generator: torch.Generator
                   ) -> List[np.ndarray]:
        """Vocode a batch of mels; returns one waveform of frames_i * hop samples each."""
        hp = self._hp
        hop = hp.get_hop_size()
        c = prepare_conditions(mels, hp)
        c_up = self._model.upsample_conditioning(c).contiguous()
        B, T = c_up.shape[0], c_up.shape[1]
        noise = wavenet_ar.make_noise(hp, generator, B, T, c_up.device)
        audio, _ = wavenet_ar.generate_ar(self._weights, c_up, noise, hp,
                                          return_params=False)
        audio = audio.cpu().numpy()
        return [audio[i, :int(m.shape[0]) * hop] for i, m in enumerate(mels)]
