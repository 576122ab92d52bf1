"""Training with the port: the counterpart of `train.py --model=Tacotron` and
`--model=WaveNet`.

    python -m tacotron2_tpu_torch.train --model Tacotron \
        --tacotron_input training_data/train.txt --base_dir . --name run1 \
        --tacotron_train_steps 100000 [--eval_interval 5000] \
        [--checkpoint_interval 2500] [--summary_interval 250] [--restore True] \
        [--hparams 'k=v,...'] [--device cuda]

    python -m tacotron2_tpu_torch.train --model WaveNet \
        --wavenet_input training_data/train.txt --base_dir . --name run1 \
        --wavenet_train_steps 500000 [--eval_interval 5000] [--checkpoint_interval 2500] \
        [--summary_interval 250] [--restore True] [--hparams 'k=v,...'] \
        [--paper_profile] [--device cuda]

Tacotron trains on a preprocessing `train.txt` (`audio|mel|linear|samples|frames|text`
rows; mels under mels/, linear spectrograms under linear/ beside it), writing into
`<base_dir>/logs-<name>/`: `taco_pretrained/ckpt-<step>.pt` (the whole train state; a
rerun with --restore True continues from the latest; `synthesize --tacotron_checkpoint`
reads the directory), `wavs/` and `mel-spectrograms/` (Griffin-Lim wav and predicted mel
of each checkpoint's last batch), `eval-dir/wavs/` (the eval's wavs from mel and from
linear), `CharacterEmbeddings.tsv`, `Terminal_train_log` (see training/tacotron_train.py;
--embedding_interval is accepted and ignored: the port has no embedding projector).

WaveNet trains on a preprocessing `train.txt` or a GTA `map.txt`
(`audio|mel|...` rows; audio and mel `.npy` files), writing into
`<base_dir>/logs-<name>/`: `wave_pretrained/ckpt-<step>.pt` (the whole train state; a
rerun with --restore True continues from the latest), `wave_pretrained_eval_history.jsonl`
(one record an eval: teacher-forced loss, and from the autoregressive eval on the EMA
weights samples/s, the natural loss with wavenet_natural_eval=True, the conditioning
correlation), `wavs/` and `eval-dir/wavs/` (pred / real wavs), `Terminal_train_log`.
The device defaults to cuda, where the WaveNet natural eval's AR loop runs in the
hand-written kernel; without a CUDA device pass --device cpu. The combined Tacotron-2
pipeline (Tacotron, GTA synthesis, WaveNet) is not ported yet.
"""

import argparse
import os
from typing import Optional, Sequence

import torch

from . import infolog
from .config import default_hparams, paper_hparams


def str2bool(v) -> bool:
    """argparse-safe bool ('--restore False' means False)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ('true', '1', 'yes', 'y'):
        return True
    if v.lower() in ('false', '0', 'no', 'n'):
        return False
    raise argparse.ArgumentTypeError(f'expected a boolean, got {v!r}')


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser(description='Train with the PyTorch port.')
    parser.add_argument('--base_dir', default='')
    parser.add_argument('--hparams', default='',
                        help="comma-separated 'name=value' hyperparameter overrides")
    parser.add_argument('--paper_profile', action='store_true',
                        help='start from the exact-paper hparams profile; --hparams '
                             'applies on top')
    parser.add_argument('--tacotron_input', default='training_data/train.txt')
    parser.add_argument('--wavenet_input', default='tacotron_output/gta/map.txt')
    parser.add_argument('--name', help='Name of logging directory.')
    parser.add_argument('--model', default='Tacotron-2',
                        choices=('Tacotron', 'WaveNet', 'Tacotron-2'))
    parser.add_argument('--restore', type=str2bool, default=True,
                        help='Set this to False to do a fresh training')
    parser.add_argument('--summary_interval', type=int, default=250,
                        help='Steps between logging loss, gradient norm and learning rate')
    parser.add_argument('--checkpoint_interval', type=int, default=2500,
                        help='Steps between writing checkpoints')
    parser.add_argument('--eval_interval', type=int, default=5000,
                        help='Steps between eval on test data')
    parser.add_argument('--embedding_interval', type=int, default=5000,
                        help='accepted for train.py\'s command line; the port writes no '
                             'embedding projection')
    parser.add_argument('--tacotron_train_steps', type=int, default=100000,
                        help='total number of tacotron training steps')
    parser.add_argument('--wavenet_train_steps', type=int, default=500000,
                        help='total number of wavenet training steps')
    parser.add_argument('--device', default='cuda', help='torch device (default cuda)')
    args = parser.parse_args(argv)

    if args.model == 'Tacotron-2':
        raise NotImplementedError(
            '--model Tacotron-2: the GTA synthesis between the two trainers and the '
            '3-phase pipeline are not ported yet (ROADMAP.md, open items A6 and A11); '
            'train each model with --model Tacotron and --model WaveNet')
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda, but torch finds no CUDA device '
                           '(pass --device cpu to train on the CPU)')
    hp = paper_hparams() if args.paper_profile else default_hparams()
    hp.parse(args.hparams)
    run_name = args.name or args.model
    log_dir = os.path.join(args.base_dir, 'logs-{}'.format(run_name))
    os.makedirs(log_dir, exist_ok=True)
    infolog.init(os.path.join(log_dir, 'Terminal_train_log'), run_name)

    if args.model == 'Tacotron':
        from .training.tacotron_train import train as tacotron_train
        return tacotron_train(log_dir, args, hp, device)
    from .training.wavenet_train import train
    return train(log_dir, args, hp, args.wavenet_input, device)


if __name__ == '__main__':
    main()
