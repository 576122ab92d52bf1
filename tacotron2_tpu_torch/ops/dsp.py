"""Griffin-Lim on the device (counterpart of `tacotron2_tpu/ops/dsp_jax.py:17-133`): the
centered STFT, its inverse with the window-sum normalization, and the mel and linear
inversions the Tacotron trainer's eval wavs use when hp.GL_on_GPU. torch ops on the
spectrogram's device; the windows and filterbanks are `stft_common`'s. Like the JAX
functions these do not invert the preemphasis: the host does (`audio.inv_preemphasis`).
The numpy path of `audio.py` serves GL_on_GPU=False; `gl_invert` picks one of the two by
hp.GL_on_GPU and inverts the preemphasis."""

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from . import audio
from . import stft_common as sc


def _window(hp, device) -> Tensor:
    return torch.as_tensor(sc.padded_window(hp.get_win_size(), hp.n_fft),
                           dtype=torch.float32, device=device)


def stft(y: Tensor, hp) -> Tensor:
    """Centered STFT (zero padding) of a 1-D f32 signal -> complex (n_fft//2+1, frames)."""
    n_fft, hop = hp.n_fft, hp.get_hop_size()
    padded = F.pad(y, (n_fft // 2, n_fft // 2))
    frames = padded.unfold(0, n_fft, hop) * _window(hp, y.device)[None, :]
    return torch.fft.rfft(frames, dim=1).T


def istft(spec: Tensor, hp) -> Tensor:
    """Inverse STFT: overlap-add of the windowed frames over the summed squared window
    (floored at 1e-10), the centre padding trimmed."""
    n_fft, hop = hp.n_fft, hp.get_hop_size()
    window = _window(hp, spec.device)
    frames = torch.fft.irfft(spec.T, n=n_fft, dim=1)          # (n_frames, n_fft)
    n_frames = frames.shape[0]
    length = n_fft + hop * (n_frames - 1)

    def overlap_add(x):
        return F.fold(x.T[None], (1, length), (1, n_fft), stride=(1, hop))[0, 0, 0]

    y = overlap_add(frames * window[None, :])
    wss = overlap_add(torch.broadcast_to(window ** 2, frames.shape))
    y = y / torch.clamp(wss, min=1e-10)
    return y[n_fft // 2: length - n_fft // 2]


def griffin_lim(S: Tensor, hp) -> Tensor:
    """hp.griffin_lim_iters rounds of phase reconstruction of the magnitude `S`
    (n_freqs, frames), already raised to hp.power, from an all-ones phase."""
    mag = torch.abs(S).to(torch.complex64)
    y = istft(mag, hp)
    for _ in range(hp.griffin_lim_iters):
        est = stft(y, hp)
        angles = est / torch.clamp(torch.abs(est), min=1e-8).to(torch.complex64)
        y = istft(mag * angles, hp)
    return y


def _denormalize(D: Tensor, hp) -> Tensor:
    ma, ml = hp.max_abs_value, hp.min_level_db
    if hp.symmetric_mels:
        D = torch.clamp(D, -ma, ma) if hp.allow_clipping_in_normalization else D
        return ((D + ma) * -ml / (2 * ma)) + ml
    D = torch.clamp(D, 0, ma) if hp.allow_clipping_in_normalization else D
    return (D * -ml / ma) + ml


def _amplitude(spec: Tensor, hp) -> Tensor:
    D = _denormalize(spec, hp) if hp.signal_normalization else spec
    return torch.pow(10.0, (D + hp.ref_level_db) * 0.05) ** (1.0 / hp.magnitude_power)


def inv_mel_spectrogram(mel: Tensor, hp) -> Tensor:
    """mel (num_mels, frames) -> waveform through the mel filterbank's pseudo-inverse
    (`inv_mel_spectrogram_jax`)."""
    inv_basis = torch.as_tensor(
        sc.inv_mel_filterbank(hp.sample_rate, hp.n_fft, hp.num_mels, hp.fmin, hp.fmax),
        device=mel.device)
    S = torch.clamp(inv_basis @ _amplitude(mel.float(), hp), min=1e-10)
    return griffin_lim(S ** hp.power, hp)


def inv_linear_spectrogram(spec: Tensor, hp) -> Tensor:
    """linear (num_freq, frames) -> waveform (`inv_linear_spectrogram_jax`)."""
    return griffin_lim(_amplitude(spec.float(), hp) ** hp.power, hp)


def gl_invert(spec: Tensor, hp, linear: bool = False) -> np.ndarray:
    """(frames, bins) mel or linear spectrogram -> wav: Griffin-Lim on the tensor's
    device with hp.GL_on_GPU, else on the host in numpy."""
    if hp.GL_on_GPU:
        invert = inv_linear_spectrogram if linear else inv_mel_spectrogram
        wav = invert(spec.T.contiguous(), hp).cpu().numpy()
        return audio.inv_preemphasis(wav, hp.preemphasis, hp.preemphasize)
    invert = audio.inv_linear_spectrogram if linear else audio.inv_mel_spectrogram
    return invert(spec.float().cpu().numpy().T, hp)
