"""Spectral centroids of a mel spectrogram (the port's own copy of `mel_centroids`,
`tacotron2_tpu/ops/mcd.py:91-103`; the mel-cepstral distortion and its DTW are not
ported). The trainer's evaluation correlates the centroid track of the generated
audio's mel with the conditioning mel's (`training/wavenet_train.py`).
"""

import numpy as np

from ..config import Hparams
from . import stft_common as sc
from .audio import _denormalize


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
