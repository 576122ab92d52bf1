"""Streaming text -> speech: yield waveform chunks while the vocoder is still
generating (counterpart of `tacotron2_tpu/inference/streaming.py` and of
`StreamVocoder` / `stream_vocode` in `tacotron2_tpu/training/wavenet_trainer.py`).

Tacotron decodes the whole mel first and leaves it on the device; the WaveNet AR
kernel then vocodes it in state-carried chunks (`ops/wavenet_ar.py` state_in /
return_state), so the first audio arrives after the first chunk instead of after the
whole utterance. Per-chunk post-processing carries its state: the preemphasis inverse
(an IIR, y[n] = x[n] + k*y[n-1]) carries its one-pole state through
`scipy.signal.lfilter`'s zi, so the concatenated stream equals the one-shot output;
the mu-law inversion before it is pointwise.
"""

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from scipy.signal import lfilter
from torch import Tensor

from ..convert import load_models
from ..models.tacotron.model import Tacotron
from ..models.wavenet.model import WaveNet
from ..ops import wavenet_ar
from ..ops.mulaw import inv_mulaw, inv_mulaw_quantize, is_mulaw, is_mulaw_quantize
from .tacotron_synthesizer import Synthesizer as TacotronSynthesizer
from .wavenet_synthesizer import prepare_conditions

# Chunk sizes are multiples of the TPU kernel's 128-step slab, so the chunk
# boundaries are the JAX package's (the port's kernel itself takes any size).
CHUNK = 128


class StreamVocoder:
    """Prepared streaming vocoder: the model on its device and the packed kernel
    weights are made once, so a served request pays only the per-chunk AR work.

    Counterpart of `training/wavenet_trainer.py:241-330` of the JAX package; in the port
    it lives with the streaming code that uses it. The global conditioning bias of a
    batch of speaker ids is packed once and kept (`:266-274`)."""

    def __init__(self, model: WaveNet, hp):
        self._model = model.eval()
        self._hp = hp
        self._weights = wavenet_ar.pack_params(model, hp)
        self._g_cache: Dict[Tuple[int, ...], Tensor] = {}

    def _global_cond(self, g: Optional[Tensor]) -> Optional[Tensor]:
        if g is None or self._hp.gin_channels <= 0:
            return None
        key = tuple(int(i) for i in g.reshape(-1).tolist())
        if key not in self._g_cache:
            self._g_cache[key] = wavenet_ar.pack_global(self._model, self._hp,
                                                        self._model.embed_global(g))
        return self._g_cache[key]

    @torch.no_grad()
    def stream(self, generator: torch.Generator, c: Tensor, chunk_samples: int = 16384,
               first_chunk_samples: int = 4096, g: Optional[Tensor] = None
               ) -> Iterator[Tensor]:
        """Yield (B, n) audio chunks for one conditioning batch c (B, frames, cin),
        already clipped and rescaled, as they are generated; g (B,) speaker ids on
        c's device condition a multi-speaker model.

        Each chunk draws its noise from `generator` and continues from the state the
        previous chunk returned, so the chunks are exactly one long call over the
        same noise. Chunk sizes must be multiples of CHUNK; only the last chunk,
        which asks for no state, may be ragged.

        A big-vocab categorical model draws one seed from `generator` for the whole
        stream and keeps it over the chunks: its in-kernel noise is a function of
        (seed, sequence, absolute step, class), so the stream is bit-identical to one
        call with that seed. (The JAX package draws a fresh seed for every chunk,
        `wavenet_trainer.py:305-313`, because its kernel seeds one stream a call.)"""
        if chunk_samples % CHUNK or first_chunk_samples % CHUNK \
                or min(chunk_samples, first_chunk_samples) <= 0:
            raise ValueError(f'chunk sizes must be positive multiples of {CHUNK}, got '
                             f'{first_chunk_samples} and {chunk_samples}')
        hp = self._hp
        c_up = self._model.upsample_conditioning(c)
        g_cond = self._global_cond(g)
        B, T = c_up.shape[0], c_up.shape[1]
        state = None
        pos = 0
        kw = (dict(seed=wavenet_ar.draw_seed(generator)) if wavenet_ar.is_big_vocab(hp)
              else {})
        while pos < T:
            n = min(first_chunk_samples if pos == 0 else chunk_samples, T - pos)
            last = pos + n >= T
            noise = wavenet_ar.make_noise(hp, generator, B, n, c_up.device)
            out = wavenet_ar.generate_ar(self._weights, c_up[:, pos:pos + n].contiguous(),
                                         noise, hp, return_params=False, state_in=state,
                                         return_state=not last, g_cond=g_cond, **kw)
            if not last:
                state = out[2]
            pos += n
            yield out[0]


def stream_vocode(model: WaveNet, hp, generator: torch.Generator, c: Tensor,
                  chunk_samples: int = 16384, first_chunk_samples: int = 4096,
                  g: Optional[Tensor] = None) -> Iterator[Tensor]:
    """One-shot streaming vocode (see StreamVocoder.stream). Servers hold a
    StreamVocoder instead: this packs the weights on every call."""
    yield from StreamVocoder(model, hp).stream(generator, c, chunk_samples,
                                               first_chunk_samples, g)


class StreamingSynthesizer:
    """Two-stage streaming TTS (Tacotron -> streaming WaveNet) on one device."""

    def __init__(self, taco: Tacotron, wavenet: WaveNet, hp, device):
        self._hp = hp
        self._device = torch.device(device)
        self._taco = TacotronSynthesizer(taco, hp, self._device)
        self._vocoder = StreamVocoder(wavenet, hp)

    @classmethod
    def load(cls, taco_pt: str, wavenet_pt: str, hp, device, wavenet_step=None
             ) -> 'StreamingSynthesizer':
        """From the files `convert.save_checkpoint` writes; the WaveNet also from a
        trainer's checkpoint directory at `wavenet_step` (`convert.load_wavenet`)."""
        return cls(*load_models(taco_pt, wavenet_pt, hp, device, wavenet_step), hp, device)

    def stream(self, text: str, seed: int = 0, chunk_seconds: float = 0.75,
               first_chunk_seconds: float = 0.20, speaker_id: Optional[int] = None
               ) -> Iterator[np.ndarray]:
        """Yield float32 waveform chunks for `text` as they are generated, in the voice
        of `speaker_id` where the WaveNet has global conditioning.

        The mel stays on the device: the decode length comes from the stop tokens,
        and the mel is sliced to a `pad_mel_multiple` frame bucket whose tail is set to
        the mel floor, as the training feeder pads (streaming.py:89-98)."""
        hp = self._hp
        gen = torch.Generator(self._device).manual_seed(hp.tacotron_random_seed)
        mel, lengths, _ = self._taco.synthesize([text], gen)
        n_frames = int(lengths[0])
        mult = max(hp.pad_mel_multiple, hp.outputs_per_step)
        bucket = min(int(mel.shape[1]), -(-n_frames // mult) * mult)
        lo = -hp.max_abs_value if hp.symmetric_mels else 0.0
        mel_b = mel[0, :bucket].clone()
        mel_b[n_frames:] = lo
        yield from self.stream_from_mel(mel_b, n_frames=n_frames, seed=seed,
                                        chunk_seconds=chunk_seconds,
                                        first_chunk_seconds=first_chunk_seconds,
                                        speaker_id=speaker_id)

    def stream_from_mel(self, mel, n_frames: Optional[int] = None, seed: int = 0,
                        chunk_seconds: float = 0.75, first_chunk_seconds: float = 0.20,
                        speaker_id: Optional[int] = None) -> Iterator[np.ndarray]:
        """Stream waveform chunks for one (T, num_mels) mel (a tensor on any device,
        or an array); `n_frames` is the true frame count when the mel is padded.
        The noise comes from a generator on the device seeded with `seed`. Each chunk
        is mu-law decoded where the model's input type is, then de-emphasised
        (streaming.py:122-142)."""
        hp = self._hp
        chunk = max(CHUNK, int(chunk_seconds * hp.sample_rate) // CHUNK * CHUNK)
        first = max(CHUNK, int(first_chunk_seconds * hp.sample_rate) // CHUNK * CHUNK)
        mel = torch.as_tensor(mel, device=self._device)
        c = prepare_conditions([mel], hp)
        gen = torch.Generator(self._device).manual_seed(seed)
        g = (torch.tensor([speaker_id], dtype=torch.long, device=self._device)
             if speaker_id is not None and hp.gin_channels > 0 else None)
        total = (len(mel) if n_frames is None else n_frames) * hp.get_hop_size()
        emitted = 0
        zi = np.zeros(1)  # inverse-preemphasis state (zero: the one-shot filter's start)
        for y in self._vocoder.stream(gen, c, chunk_samples=chunk,
                                      first_chunk_samples=first, g=g):
            y = y[0].cpu().numpy()
            y = y[:max(0, min(len(y), total - emitted))]  # trim the bucket tail
            emitted += len(y)
            if len(y) == 0:
                break
            if is_mulaw_quantize(hp.input_type):
                y = inv_mulaw_quantize(y, hp.quantize_channels)
            elif is_mulaw(hp.input_type):
                y = inv_mulaw(y, hp.quantize_channels)
            if hp.preemphasize:
                y, zi = lfilter([1.0], [1.0, -hp.preemphasis], y, zi=zi)
            yield np.asarray(y, np.float32)
            if emitted >= total:
                break  # generate no bucket-tail chunk past the true length
