"""Standalone WaveNet preprocessing with the port: the counterpart of
`wavenet_preprocess.py`, the same flags.

    python -m tacotron2_tpu_torch.wavenet_preprocess --base_dir . [--input_dir wavs] \\
        [--output tacotron_output/gta/] [--n_jobs 8] [--paper_profile] \\
        [--hparams 'k=v,...']

Preprocesses the wavs of `<base_dir>/<input_dir>` into `<base_dir>/<output>/{audio,mels}/`
and a `map.txt` of `audio|mel|mel|<no_g>|samples|frames` rows, then checks that every
example's audio is exactly its mel frames times the hop (`validate_alignment`, a dry
run of the feeder's alignment). Host numpy only: no device is used.
"""

import argparse
import os
from multiprocessing import cpu_count
from typing import Optional, Sequence

import numpy as np

from .config import default_hparams, paper_hparams
from .data import preprocessor


def write_metadata(metadata, out_dir, hparams):
    with open(os.path.join(out_dir, 'map.txt'), 'w', encoding='utf-8') as f:
        for m in metadata:
            f.write('|'.join([str(x) for x in m]) + '\n')
    mel_frames = sum(int(m[5]) for m in metadata)
    timesteps = sum(int(m[4]) for m in metadata)
    hours = timesteps / hparams.sample_rate / 3600
    print('Wrote {} utterances, {} mel frames, {} audio timesteps, ({:.2f} hours)'.format(
        len(metadata), mel_frames, timesteps, hours))


def validate_alignment(metadata, out_dir, hparams):
    """Check every example's audio length is exactly mel_frames * hop_size."""
    hop = hparams.get_hop_size()
    bad = 0
    for m in metadata:
        audio_path = os.path.join(out_dir, 'audio', m[0])
        mel_path = os.path.join(out_dir, 'mels', m[1])
        audio_len = len(np.load(audio_path))
        mel_frames = np.load(mel_path).shape[0]
        if audio_len != mel_frames * hop:
            print(f'misaligned: {m[0]}: audio {audio_len} != {mel_frames} * {hop}')
            bad += 1
    if bad:
        raise AssertionError(f'{bad} misaligned examples')
    print(f'alignment validated for {len(metadata)} examples')


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--base_dir', default='')
    parser.add_argument('--hparams', default='')
    parser.add_argument('--paper_profile', action='store_true',
                        help='start from the exact-paper hparams profile; --hparams '
                             'applies on top')
    parser.add_argument('--input_dir', default='wavs', help='directory of .wav files')
    parser.add_argument('--output', default='tacotron_output/gta/')
    parser.add_argument('--n_jobs', type=int, default=cpu_count())
    args = parser.parse_args(argv)

    hparams = paper_hparams() if args.paper_profile else default_hparams()
    hparams.parse(args.hparams)

    input_dir = os.path.join(args.base_dir, args.input_dir)
    out_dir = os.path.join(args.base_dir, args.output)
    mel_dir = os.path.join(out_dir, 'mels')
    wav_dir = os.path.join(out_dir, 'audio')
    os.makedirs(mel_dir, exist_ok=True)
    os.makedirs(wav_dir, exist_ok=True)

    metadata = preprocessor.build_from_path_wavenet(hparams, input_dir, mel_dir, wav_dir,
                                                    args.n_jobs)
    write_metadata(metadata, out_dir, hparams)
    validate_alignment(metadata, out_dir, hparams)
    return metadata


if __name__ == '__main__':
    main()
