"""Host-side (numpy) audio DSP for artifact dumps and the trainer's evaluation: the
port's own copy of `tacotron2_tpu/ops/audio.py` (numpy and scipy only), held to the
original and to `tests/golden/dsp_golden.npz` by `tests/test_torch_train.py`; change
both sides together.

wav I/O, preemphasis (IIR), silence trim, centered STFT/iSTFT, mel/linear spectrograms
with the power→dB→normalize chain, inverse spectrograms via Griffin-Lim, and the
hop-alignment padding math, with librosa's semantics written out (librosa is not a
dependency). A Griffin-Lim in torch on the device is not ported.
"""

from typing import Tuple

import numpy as np
from scipy import signal
from scipy.io import wavfile

from ..config import Hparams
from . import stft_common as sc


# --- wav I/O (reference audio.py:9-20) ---

def load_wav(path: str, sr: int) -> np.ndarray:
    """Load a wav as float32 in [-1, 1], resampling to `sr` if needed."""
    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if file_sr != sr:
        g = np.gcd(int(file_sr), int(sr))
        wav = signal.resample_poly(wav, sr // g, file_sr // g).astype(np.float32)
    return wav


def save_wav(wav: np.ndarray, path: str, sr: int) -> None:
    wav = wav * (32767 / max(0.01, np.max(np.abs(wav))))
    wavfile.write(path, sr, wav.astype(np.int16))


def save_wavenet_wav(wav: np.ndarray, path: str, sr: int, inv_preemphasize: bool, k: float) -> None:
    save_wav(wav, path, sr)


# --- filters (reference audio.py:22-30) ---

def preemphasis(wav: np.ndarray, k: float, preemphasize: bool = True) -> np.ndarray:
    if preemphasize:
        return signal.lfilter([1, -k], [1], wav)
    return wav


def inv_preemphasis(wav: np.ndarray, k: float, inv_preemphasize: bool = True) -> np.ndarray:
    if inv_preemphasize:
        return signal.lfilter([1], [1, -k], wav)
    return wav


# --- silence handling (reference audio.py:33-52) ---

def start_and_end_indices(quantized: np.ndarray, silence_threshold: int = 2) -> Tuple[int, int]:
    nonsilent = np.abs(quantized.astype(np.int64) - 127) > silence_threshold
    idx = np.flatnonzero(nonsilent)
    if idx.size == 0:
        raise ValueError('signal is entirely silent')
    return int(idx[0]), int(idx[-1])


def trim_silence(wav: np.ndarray, hparams: Hparams) -> np.ndarray:
    """Leading/trailing silence trim (librosa.effects.trim semantics)."""
    frame_length = hparams.trim_fft_size
    hop_length = hparams.trim_hop_size
    rms = _frame_rms(wav, frame_length, hop_length)
    power = rms ** 2
    ref = np.max(power)
    if ref <= 0:
        return wav
    db = 10.0 * np.log10(np.maximum(power / ref, 1e-20))
    nonsilent = np.flatnonzero(db > -hparams.trim_top_db)
    if nonsilent.size == 0:
        return wav[0:0]
    start = int(nonsilent[0]) * hop_length
    end = min(wav.shape[0], int(nonsilent[-1] + 1) * hop_length)
    return wav[start:end]


def _frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Centered per-frame RMS (librosa.feature.rms, pad_mode='constant')."""
    padded = np.pad(y, (frame_length // 2, frame_length // 2))
    n_frames = 1 + (padded.shape[0] - frame_length) // hop_length
    starts = np.arange(n_frames) * hop_length
    frames = padded[starts[:, None] + np.arange(frame_length)[None, :]]
    return np.sqrt(np.mean(frames ** 2, axis=1))


# --- STFT (reference audio.py:178-185; librosa centered, zero pad_mode) ---

def _stft(y: np.ndarray, hparams: Hparams) -> np.ndarray:
    n_fft, hop = hparams.n_fft, hparams.get_hop_size()
    window = sc.padded_window(hparams.get_win_size(), n_fft)
    padded = np.pad(y, (n_fft // 2, n_fft // 2))
    n_frames = 1 + (padded.shape[0] - n_fft) // hop
    starts = np.arange(n_frames) * hop
    frames = padded[starts[:, None] + np.arange(n_fft)[None, :]]
    return np.fft.rfft(frames * window[None, :], axis=1).T  # (n_fft//2+1, n_frames)


def _istft(stft_matrix: np.ndarray, hparams: Hparams) -> np.ndarray:
    """Inverse STFT with NOLA window-sum normalization (librosa.istft semantics)."""
    n_fft, hop = hparams.n_fft, hparams.get_hop_size()
    window = sc.padded_window(hparams.get_win_size(), n_fft)
    frames = np.fft.irfft(stft_matrix.T, n=n_fft, axis=1)  # (n_frames, n_fft)
    n_frames = frames.shape[0]
    length = n_fft + hop * (n_frames - 1)
    y = np.zeros(length)
    wss = np.zeros(length)
    win_sq = window ** 2
    for i in range(n_frames):
        s = i * hop
        y[s:s + n_fft] += frames[i] * window
        wss[s:s + n_fft] += win_sq
    y = y / np.maximum(wss, 1e-10)
    return y[n_fft // 2: length - n_fft // 2]


# --- spectrograms (reference audio.py:61-112) ---

def linearspectrogram(wav: np.ndarray, hparams: Hparams) -> np.ndarray:
    D = _stft(wav, hparams)
    S = _amp_to_db(np.abs(D) ** hparams.magnitude_power, hparams) - hparams.ref_level_db
    if hparams.signal_normalization:
        return _normalize(S, hparams)
    return S


def melspectrogram(wav: np.ndarray, hparams: Hparams) -> np.ndarray:
    D = _stft(wav, hparams)
    S = _amp_to_db(_linear_to_mel(np.abs(D) ** hparams.magnitude_power, hparams), hparams) - hparams.ref_level_db
    if hparams.signal_normalization:
        return _normalize(S, hparams)
    return S


def inv_linear_spectrogram(linear_spectrogram: np.ndarray, hparams: Hparams) -> np.ndarray:
    D = _denormalize(linear_spectrogram, hparams) if hparams.signal_normalization else linear_spectrogram
    S = _db_to_amp(D + hparams.ref_level_db) ** (1 / hparams.magnitude_power)
    return inv_preemphasis(_griffin_lim(S ** hparams.power, hparams), hparams.preemphasis, hparams.preemphasize)


def inv_mel_spectrogram(mel_spectrogram: np.ndarray, hparams: Hparams) -> np.ndarray:
    D = _denormalize(mel_spectrogram, hparams) if hparams.signal_normalization else mel_spectrogram
    S = _mel_to_linear(_db_to_amp(D + hparams.ref_level_db) ** (1 / hparams.magnitude_power), hparams)
    return inv_preemphasis(_griffin_lim(S ** hparams.power, hparams), hparams.preemphasis, hparams.preemphasize)


def _griffin_lim(S: np.ndarray, hparams: Hparams) -> np.ndarray:
    """Griffin-Lim phase reconstruction (reference audio.py:151-161)."""
    rng = np.random.default_rng(0)
    angles = np.exp(2j * np.pi * rng.random(S.shape))
    S_complex = np.abs(S).astype(np.complex128)
    y = _istft(S_complex * angles, hparams)
    for _ in range(hparams.griffin_lim_iters):
        angles = np.exp(1j * np.angle(_stft(y, hparams)))
        y = _istft(S_complex * angles, hparams)
    return y


# --- frame/padding math (reference audio.py:189-219) ---

def num_frames(length: int, fsize: int, fshift: int) -> int:
    pad = fsize - fshift
    if length % fshift == 0:
        return (length + pad * 2 - fsize) // fshift + 1
    return (length + pad * 2 - fsize) // fshift + 2


def pad_lr(x: np.ndarray, fsize: int, fshift: int) -> Tuple[int, int]:
    M = num_frames(len(x), fsize, fshift)
    pad = fsize - fshift
    T = len(x) + 2 * pad
    r = (M - 1) * fshift + fsize - T
    return pad, pad + r


def librosa_pad_lr(x: np.ndarray, fsize: int, fshift: int, pad_sides: int = 1) -> Tuple[int, int]:
    assert pad_sides in (1, 2)
    pad = (x.shape[0] // fshift + 1) * fshift - x.shape[0]
    if pad_sides == 1:
        return 0, pad
    return pad // 2, pad // 2 + pad % 2


# --- dB / normalization chain (reference audio.py:222-298) ---

def _linear_to_mel(spectrogram: np.ndarray, hparams: Hparams) -> np.ndarray:
    basis = sc.mel_filterbank(hparams.sample_rate, hparams.n_fft, hparams.num_mels,
                              hparams.fmin, hparams.fmax)
    return np.dot(basis, spectrogram)


def _mel_to_linear(mel_spectrogram: np.ndarray, hparams: Hparams) -> np.ndarray:
    inv_basis = sc.inv_mel_filterbank(hparams.sample_rate, hparams.n_fft, hparams.num_mels,
                                      hparams.fmin, hparams.fmax)
    return np.maximum(1e-10, np.dot(inv_basis, mel_spectrogram))


def _amp_to_db(x: np.ndarray, hparams: Hparams) -> np.ndarray:
    min_level = np.exp(hparams.min_level_db / 20 * np.log(10))
    return 20 * np.log10(np.maximum(min_level, x))


def _db_to_amp(x: np.ndarray) -> np.ndarray:
    return np.power(10.0, x * 0.05)


def _normalize(S: np.ndarray, hparams: Hparams) -> np.ndarray:
    ma, ml = hparams.max_abs_value, hparams.min_level_db
    if hparams.allow_clipping_in_normalization:
        if hparams.symmetric_mels:
            return np.clip((2 * ma) * ((S - ml) / (-ml)) - ma, -ma, ma)
        return np.clip(ma * ((S - ml) / (-ml)), 0, ma)
    assert S.max() <= 0 and S.min() - ml >= 0
    if hparams.symmetric_mels:
        return (2 * ma) * ((S - ml) / (-ml)) - ma
    return ma * ((S - ml) / (-ml))


def _denormalize(D: np.ndarray, hparams: Hparams) -> np.ndarray:
    ma, ml = hparams.max_abs_value, hparams.min_level_db
    if hparams.allow_clipping_in_normalization:
        if hparams.symmetric_mels:
            return ((np.clip(D, -ma, ma) + ma) * -ml / (2 * ma)) + ml
        return (np.clip(D, 0, ma) * -ml / ma) + ml
    if hparams.symmetric_mels:
        return ((D + ma) * -ml / (2 * ma)) + ml
    return (D * -ml / ma) + ml
