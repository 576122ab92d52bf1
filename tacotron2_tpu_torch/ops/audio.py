"""wav output (counterpart of `save_wav` in `tacotron2_tpu/ops/audio.py`)."""

import numpy as np
from scipy.io import wavfile


def save_wav(wav: np.ndarray, path: str, sr: int) -> None:
    """Peak-normalise to int16 and write a wav file."""
    wav = wav * (32767 / max(0.01, np.max(np.abs(wav))))
    wavfile.write(path, sr, wav.astype(np.int16))
