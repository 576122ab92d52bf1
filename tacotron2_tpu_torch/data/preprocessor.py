"""Offline dataset preprocessing: wav -> (audio, mel, linear) npy triples + metadata
(counterpart of `tacotron2_tpu/data/preprocessor.py`).

Host numpy over the port's `ops/audio.py` and `ops/mulaw.py`, as the JAX package's is:
the same audio chain (trim -> preemphasis -> rescale -> optional mu-law ->
spectrograms -> hop alignment) and the same artifacts, byte for byte
(`training_data/{audio,mels,linear}` npys with `(frames, bins)` layout and the
pipe-separated `train.txt` / `map.txt` rows), held to the JAX package's by
`tests/test_torch_preprocess.py`.

The utterances go to a pool of worker processes started with `spawn`: a forked child
of a process that holds a CUDA context (or threads) may hang, and the workers import
nothing of torch (ops/mulaw.py imports it only where a caller already has).
"""

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import Hparams
from ..ops import audio
from ..ops.mulaw import is_mulaw, is_mulaw_quantize, mulaw, mulaw_quantize


def _pool(n_jobs: int) -> ProcessPoolExecutor:
    return ProcessPoolExecutor(max_workers=n_jobs,
                               mp_context=multiprocessing.get_context('spawn'))


def build_from_path(hparams: Hparams, input_dirs: Sequence[str], mel_dir: str,
                    linear_dir: str, wav_dir: str, n_jobs: int = 12,
                    tqdm=lambda x: x) -> List[Tuple]:
    """Preprocess LJSpeech-format corpora (metadata.csv + wavs/) in parallel."""
    with _pool(n_jobs) as executor:
        futures = []
        for input_dir in input_dirs:
            with open(os.path.join(input_dir, 'metadata.csv'), encoding='utf-8') as f:
                for line in f:
                    parts = line.strip().split('|')
                    basename = parts[0]
                    wav_path = os.path.join(input_dir, 'wavs', f'{basename}.wav')
                    text = parts[2] if len(parts) > 2 else parts[1]
                    futures.append(executor.submit(partial(
                        _process_utterance, mel_dir, linear_dir, wav_dir,
                        basename, wav_path, text, hparams)))
        return [f.result() for f in tqdm(futures) if f.result() is not None]


def build_from_path_wavenet(hparams: Hparams, input_dir: str, mel_dir: str,
                            wav_dir: str, n_jobs: int = 12, tqdm=lambda x: x) -> List[Tuple]:
    """Preprocess a plain wav directory for standalone WaveNet training."""
    with _pool(n_jobs) as executor:
        futures = []
        for fname in sorted(os.listdir(input_dir)):
            if not fname.endswith('.wav'):
                continue
            wav_path = os.path.join(input_dir, fname)
            basename = fname[:-len('.wav')]
            futures.append(executor.submit(partial(
                _process_utterance_wavenet, mel_dir, wav_dir, basename, wav_path, hparams)))
        return [f.result() for f in tqdm(futures) if f.result() is not None]


def _prepare_audio(wav_path: str, hparams: Hparams):
    """Shared audio chain: load -> trim -> preemphasize -> rescale -> mu-law encode.

    Returns (wav, preem_wav, out, constant_values, out_dtype) or None on missing file.
    """
    try:
        wav = audio.load_wav(wav_path, sr=hparams.sample_rate)
    except FileNotFoundError:
        print(f'file {wav_path} present in metadata is not present on disk. skipping!')
        return None

    if hparams.trim_silence:
        wav = audio.trim_silence(wav, hparams)

    preem_wav = audio.preemphasis(wav, hparams.preemphasis, hparams.preemphasize)

    if hparams.rescale:
        wav = wav / np.abs(wav).max() * hparams.rescaling_max
        preem_wav = preem_wav / np.abs(preem_wav).max() * hparams.rescaling_max
        if (np.abs(wav) > 1.0).any() or (np.abs(preem_wav) > 1.0).any():
            raise RuntimeError(f'wav has invalid value: {wav_path}')

    if is_mulaw_quantize(hparams.input_type):
        out = mulaw_quantize(wav, hparams.quantize_channels)
        start, end = audio.start_and_end_indices(out, hparams.silence_threshold)
        wav = wav[start:end]
        preem_wav = preem_wav[start:end]
        out = out[start:end]
        constant_values = int(mulaw_quantize(np.array(0.0), hparams.quantize_channels))
        out_dtype = np.int16
    elif is_mulaw(hparams.input_type):
        out = mulaw(wav, hparams.quantize_channels)
        constant_values = float(mulaw(0.0, hparams.quantize_channels))
        out_dtype = np.float32
    else:
        out = wav
        constant_values = 0.0
        out_dtype = np.float32

    return wav, preem_wav, out, constant_values, out_dtype


def _align_audio_to_frames(wav, out, mel_frames: int, constant_values, hparams: Hparams):
    """Pad + crop audio so len(out) == mel_frames * hop."""
    hop = hparams.get_hop_size()
    l_pad, r_pad = audio.librosa_pad_lr(wav, hparams.n_fft, hop, hparams.wavenet_pad_sides)
    out = np.pad(out, (l_pad, r_pad), mode='constant', constant_values=constant_values)
    if len(out) < mel_frames * hop:
        raise ValueError(f'{len(out)} samples after padding, fewer than {mel_frames} '
                         f'frames x hop {hop}')
    return out[:mel_frames * hop]


def _process_utterance(mel_dir: str, linear_dir: str, wav_dir: str, index: str,
                       wav_path: str, text: str, hparams: Hparams) -> Optional[Tuple]:
    prepared = _prepare_audio(wav_path, hparams)
    if prepared is None:
        return None
    wav, preem_wav, out, constant_values, out_dtype = prepared

    mel_spectrogram = audio.melspectrogram(preem_wav, hparams).astype(np.float32)
    mel_frames = mel_spectrogram.shape[1]
    if mel_frames > hparams.max_mel_frames and hparams.clip_mels_length:
        return None

    linear_spectrogram = audio.linearspectrogram(preem_wav, hparams).astype(np.float32)
    if linear_spectrogram.shape[1] != mel_frames:
        raise ValueError(f'{wav_path}: {linear_spectrogram.shape[1]} linear frames, '
                         f'{mel_frames} mel frames')

    out = _align_audio_to_frames(wav, out, mel_frames, constant_values, hparams)
    time_steps = len(out)

    audio_filename = f'audio-{index}.npy'
    mel_filename = f'mel-{index}.npy'
    linear_filename = f'linear-{index}.npy'
    np.save(os.path.join(wav_dir, audio_filename), out.astype(out_dtype), allow_pickle=False)
    np.save(os.path.join(mel_dir, mel_filename), mel_spectrogram.T, allow_pickle=False)
    np.save(os.path.join(linear_dir, linear_filename), linear_spectrogram.T, allow_pickle=False)

    return (audio_filename, mel_filename, linear_filename, time_steps, mel_frames, text)


def _process_utterance_wavenet(mel_dir: str, wav_dir: str, index: str,
                               wav_path: str, hparams: Hparams) -> Optional[Tuple]:
    prepared = _prepare_audio(wav_path, hparams)
    if prepared is None:
        return None
    wav, preem_wav, out, constant_values, out_dtype = prepared

    mel_spectrogram = audio.melspectrogram(preem_wav, hparams).astype(np.float32)
    mel_frames = mel_spectrogram.shape[1]
    if mel_frames > hparams.max_mel_frames and hparams.clip_mels_length:
        return None

    out = _align_audio_to_frames(wav, out, mel_frames, constant_values, hparams)
    time_steps = len(out)

    audio_filename = f'audio-{index}.npy'
    mel_filename = f'mel-{index}.npy'
    np.save(os.path.join(wav_dir, audio_filename), out.astype(out_dtype), allow_pickle=False)
    np.save(os.path.join(mel_dir, mel_filename), mel_spectrogram.T, allow_pickle=False)

    # (audio, local condition, local condition again, global condition placeholder)
    return (audio_filename, mel_filename, mel_filename, '<no_g>', time_steps, mel_frames)
