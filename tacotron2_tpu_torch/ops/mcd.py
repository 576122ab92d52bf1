"""Mel-cepstral distortion (MCD) between two mel spectrograms, with DTW alignment, and the
spectral-centroid correlation along that alignment (the port's own numpy/scipy copy of
`tacotron2_tpu/ops/mcd.py`). The trainer's evaluation correlates the centroid track of
the generated audio's mel with the conditioning mel's (`training/wavenet_train.py`).

Cepstra are DCT-II coefficients of the log-amplitude mel spectrogram (MFCC-style).
Coefficients 1..K (c0, the frame energy, excluded) enter

    MCD(t) = (10 / ln 10) * sqrt(2 * sum_k (c1_k - c2_k)^2)

(Kubichek 1993), averaged over the DTW path.
"""

from typing import Tuple

import numpy as np
from scipy.fft import dct

from ..config import Hparams
from . import stft_common as sc
from .audio import _denormalize

_LN10_OVER_10 = np.log(10.0) / 10.0


def mel_cepstra(mel: np.ndarray, hparams: Hparams, n_coef: int = 13) -> np.ndarray:
    """(T, num_mels) normalized mel -> (T, n_coef) cepstra c_1..c_K: the mel mapped back
    to dB (the inverse of audio._normalize), then to natural-log amplitude, then the
    DCT."""
    db = _denormalize(np.asarray(mel, np.float64), hparams) + hparams.ref_level_db
    log_amp = db * (_LN10_OVER_10 / 2.0)  # dB = 20 log10(amp)
    c = dct(log_amp, type=2, norm='ortho', axis=-1)
    return c[:, 1:n_coef + 1]


def dtw_path_mean(dist: np.ndarray) -> Tuple[float, int]:
    """Classic DTW over a (T1, T2) frame-distance matrix; returns the mean distance
    along the optimal path and the path length."""
    mean, path = dtw_path(dist)
    return mean, len(path)


def dtw_path(dist: np.ndarray) -> Tuple[float, np.ndarray]:
    """DTW over a (T1, T2) frame-distance matrix. Returns (mean distance along the
    optimal path, the path as an (L, 2) int array of [i, j] index pairs from (0, 0) to
    (T1-1, T2-1))."""
    T1, T2 = dist.shape
    acc = np.full((T1 + 1, T2 + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, T1 + 1):
        d = dist[i - 1]
        prev = acc[i - 1]
        # acc[i, j] = d[j-1] + min(acc[i-1, j], acc[i-1, j-1], acc[i, j-1]); expanding
        # the acc[i, j-1] term gives row[j] = S[j] + min_{k<=j} (M[k] - S[k]) with
        # M[j] = d[j-1] + min(prev[j], prev[j-1]) and S = cumsum(d): a running min
        M = d + np.minimum(prev[1:], prev[:-1])
        S = np.cumsum(d)
        acc[i, 1:] = S + np.minimum.accumulate(M - S)
    i, j = T1, T2
    path = [(i - 1, j - 1)]
    while i > 1 or j > 1:
        moves = [(acc[i - 1, j - 1], i - 1, j - 1), (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1)]
        _, i, j = min(moves)
        path.append((i - 1, j - 1))
    path.reverse()
    return float(acc[T1, T2] / len(path)), np.asarray(path, np.int64)


def _cepstral_d2(ca: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """Pairwise squared Euclidean distances (T1, T2) between two cepstra tracks."""
    return np.sum(ca * ca, 1)[:, None] + np.sum(cb * cb, 1)[None, :] - 2.0 * ca @ cb.T


def mcd_dtw(mel_a: np.ndarray, mel_b: np.ndarray, hparams: Hparams,
            n_coef: int = 13) -> float:
    """MCD-DTW in dB between two normalized (T, num_mels) mels."""
    d2 = _cepstral_d2(mel_cepstra(mel_a, hparams, n_coef), mel_cepstra(mel_b, hparams, n_coef))
    dist = (10.0 / np.log(10.0)) * np.sqrt(2.0 * np.maximum(d2, 0.0))
    mean, _ = dtw_path_mean(dist)
    return mean


def mel_centroids(mel: np.ndarray, hparams: Hparams):
    """(T, num_mels) normalized mel -> (T,) spectral centroid in Hz and (T,) per-frame
    linear energy, computed from the mel filterbank's band centers."""
    mel_pts = np.linspace(sc.hz_to_mel(hparams.fmin), sc.hz_to_mel(hparams.fmax),
                          hparams.num_mels + 2)
    centers = np.asarray(sc.mel_to_hz(mel_pts[1:hparams.num_mels + 1]), np.float64)
    db = _denormalize(np.asarray(mel, np.float64), hparams) + hparams.ref_level_db
    amp = np.power(10.0, db / 20.0)
    e = amp.sum(axis=-1)
    cen = (amp * centers).sum(axis=-1) / np.maximum(e, 1e-12)
    return cen, e


def centroid_corr_dtw(mel_a: np.ndarray, mel_b: np.ndarray, hparams: Hparams) -> float:
    """Pearson r between the spectral-centroid tracks of two mels along their cepstral
    DTW path: a conditioning score that timing alone cannot move. Frames whose energy
    is below 5% of the utterance's 90th-percentile energy (the silences) are left out;
    NaN with fewer than 8 frames left or a flat track."""
    d2 = _cepstral_d2(mel_cepstra(mel_a, hparams), mel_cepstra(mel_b, hparams))
    _, path = dtw_path(np.sqrt(np.maximum(d2, 0.0)))
    cen_a, e_a = mel_centroids(mel_a, hparams)
    cen_b, e_b = mel_centroids(mel_b, hparams)
    ia, ib = path[:, 0], path[:, 1]
    keep = ((e_a[ia] > 0.05 * np.percentile(e_a, 90))
            & (e_b[ib] > 0.05 * np.percentile(e_b, 90)))
    if keep.sum() < 8:
        return float('nan')
    x, y = cen_a[ia][keep], cen_b[ib][keep]
    if x.std() < 1e-9 or y.std() < 1e-9:
        return float('nan')
    return float(np.corrcoef(x, y)[0, 1])
