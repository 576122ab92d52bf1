"""Dataset preprocessing with the port: the counterpart of `preprocess.py`, the same
flags. wavs + transcripts -> mel / linear / audio .npys and train.txt.

    python -m tacotron2_tpu_torch.preprocess --base_dir . [--dataset LJSpeech-1.1] \\
        [--output training_data] [--n_jobs 8] [--paper_profile] [--hparams 'k=v,...'] \\
        [--language en_US --voice female --reader mary_ann --merge_books False \\
         --book northandsouth]

Reads `<base_dir>/<dataset>/metadata.csv` and `wavs/` (LJSpeech), or the M-AILABS tree
that --language, --voice, --reader and --book select, and writes
`<base_dir>/<output>/{mels,linear,audio}/` and `<base_dir>/<output>/train.txt`, rows
`audio|mel|linear|samples|frames|text`. Host numpy only: no device is used.
"""

import argparse
import os
from multiprocessing import cpu_count
from typing import Optional, Sequence

from .config import default_hparams, paper_hparams
from .data import corpora, preprocessor


def write_metadata(metadata, out_dir, hparams):
    """Write train.txt (pipe-separated rows) and log corpus-level stats."""
    with open(os.path.join(out_dir, 'train.txt'), 'w', encoding='utf-8') as f:
        for m in metadata:
            f.write('|'.join(str(x) for x in m) + '\n')
    n_frames = sum(int(m[4]) for m in metadata)
    n_samples = sum(int(m[3]) for m in metadata)
    print('corpus: {} utterances | {} mel frames | {} samples | {:.2f} h of audio'.format(
        len(metadata), n_frames, n_samples, n_samples / hparams.sample_rate / 3600))
    print('longest utterance: {} chars, {} mel frames, {} samples'.format(
        max(len(m[5]) for m in metadata), max(int(m[4]) for m in metadata),
        max(int(m[3]) for m in metadata)))


def run_preprocess(args, hparams):
    input_folders = corpora.norm_data(
        args.base_dir, args.dataset, args.language, args.voice, args.reader,
        args.merge_books == 'True', args.book)
    out_dir = os.path.join(args.base_dir, args.output)
    dirs = {name: os.path.join(out_dir, name) for name in ('mels', 'audio', 'linear')}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    metadata = preprocessor.build_from_path(
        hparams, input_folders, dirs['mels'], dirs['linear'], dirs['audio'], args.n_jobs)
    write_metadata(metadata, out_dir, hparams)
    return metadata


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        description='Preprocess a speech corpus into training features.')
    parser.add_argument('--base_dir', default='')
    parser.add_argument('--hparams', default='',
                        help="comma-separated 'name=value' hyperparameter overrides")
    parser.add_argument('--paper_profile', action='store_true',
                        help='start from the exact-paper hparams profile; --hparams '
                             'applies on top')
    parser.add_argument('--dataset', default='LJSpeech-1.1')
    parser.add_argument('--language', default='en_US', help='M-AILABS language tag')
    parser.add_argument('--voice', default='female', help='M-AILABS voice group')
    parser.add_argument('--reader', default='mary_ann', help='M-AILABS reader name')
    parser.add_argument('--merge_books', default='False',
                        help="'True' pools every book of the reader (M-AILABS)")
    parser.add_argument('--book', default='northandsouth',
                        help='single M-AILABS book when not merging')
    parser.add_argument('--output', default='training_data')
    parser.add_argument('--n_jobs', type=int, default=cpu_count(),
                        help='parallel worker processes')
    args = parser.parse_args(argv)

    if args.merge_books not in ('False', 'True'):
        raise ValueError("--merge_books takes 'True' or 'False'")
    hparams = paper_hparams() if args.paper_profile else default_hparams()
    hparams.parse(args.hparams)
    return run_preprocess(args, hparams)


if __name__ == '__main__':
    main()
