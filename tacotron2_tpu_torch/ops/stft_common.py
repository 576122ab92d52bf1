"""Shared STFT/mel constants computed host-side in numpy (the port's own copy of
`tacotron2_tpu/ops/stft_common.py`, held to it by `tests/test_torch_train.py`).

Window and mel-filterbank construction matching librosa semantics (the reference uses
``librosa.stft`` / ``librosa.filters.mel`` — datasets/audio.py:178-246 — with a periodic
Hann window, centered frames, and a Slaney-normalized mel filterbank). librosa is not
available in this environment, so these are reimplemented from the definitions; unit
tests pin golden values.
"""

from functools import lru_cache

import numpy as np


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (scipy.signal.get_window('hann', n, fftbins=True))."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Hann window zero-padded symmetrically to n_fft (librosa util.pad_center)."""
    if win_length > n_fft:
        raise ValueError('win_length must be <= n_fft')
    w = hann_window(win_length)
    lpad = (n_fft - win_length) // 2
    return np.pad(w, (lpad, n_fft - win_length - lpad))


def hz_to_mel(f):
    """Slaney mel scale (librosa htk=False): linear below 1 kHz, log above."""
    f = np.asanyarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, num_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (num_mels, n_fft//2 + 1)."""
    if fmax > sample_rate / 2:
        raise ValueError('fmax must be <= sample_rate / 2')
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style energy normalization
    enorm = 2.0 / (hz_pts[2:num_mels + 2] - hz_pts[:num_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@lru_cache(maxsize=8)
def inv_mel_filterbank(sample_rate: int, n_fft: int, num_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Pseudo-inverse of the mel filterbank (reference audio.py:231-235)."""
    return np.linalg.pinv(
        mel_filterbank(sample_rate, n_fft, num_mels, fmin, fmax).astype(np.float64)
    ).astype(np.float32)

