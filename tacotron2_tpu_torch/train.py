"""Training with the port: the counterpart of `train.py`: `--model Tacotron`,
`--model WaveNet` and the 3-phase `--model Tacotron-2` pipeline (the default).

    python -m tacotron2_tpu_torch.train [--model Tacotron-2] --base_dir . --name run1 \
        [--tacotron_input training_data/train.txt] [--input_dir training_data] \
        [--output_dir output] [--GTA True] [--tacotron_train_steps 100000] \
        [--wavenet_train_steps 500000] [--hparams 'k=v,...'] [--device cuda]

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
Tacotron-2 runs three phases in order into `<base_dir>/logs-<name>/`: Tacotron training
on --tacotron_input, GTA synthesis (`synthesize --model Tacotron --mode synthesis`) of
`<input_dir>/train.txt` into `<base_dir>/tacotron_<output_dir>/gta/` with its map.txt
(natural mels with --GTA False), then WaveNet training on that map. Progress lives in
`logs-<name>/state_log`, byte-compatible with `train.py`'s (`<t>|<g>|<w>|<map_path>`,
three 0/1 flags and the GTA map's path, no newline), so a rerun resumes at the first
unfinished phase, whichever package wrote it; with all three done it returns.
--profile_step, --slack_url and --tf_log_level are accepted for `train.py`'s command
line and ignored.

The device defaults to cuda, where the WaveNet natural eval's AR loop runs in the
hand-written kernel; without a CUDA device pass --device cpu.

Under several ranks (`parallel/distributed.py`), one process a rank:

    torchrun --nproc_per_node=N -m tacotron2_tpu_torch.train --model Tacotron ... \
        [--dist_backend nccl|gloo] [--device cuda]

each rank runs on `cuda:LOCAL_RANK` (or on the device --device names: 'cpu', or one card
for every rank with --dist_backend gloo; nccl refuses two ranks on one card), the
backend is nccl on CUDA and gloo on the CPU unless --dist_backend names one, and the
trainers run data-parallel over every rank (`parallel/mesh.py`): each rank reads its
rows of the global batch and the update is the global batch's. Only rank 0 writes the
log, the checkpoints, the eval wavs, the eval-history sidecar and the state_log; the
WaveNet's natural eval and the pipeline's GTA synthesis run on rank 0 alone while the
other ranks wait. The ranks share one filesystem. A failed start of the process group
raises; nothing falls back to one process.
"""

import argparse
import os
from typing import Optional, Sequence

import torch

from . import infolog
from .config import default_hparams, paper_hparams
from .infolog import log
from .parallel import distributed


def write_state(path: str, done_flags, gta_map_path: str) -> None:
    """Persist pipeline progress: '<t>|<g>|<w>|<map_path>' (train.py:25-30)."""
    fields = [str(int(bool(f))) for f in done_flags]
    with open(path, 'w') as f:
        f.write('|'.join(fields + [gta_map_path]))


def read_state(path: str):
    """Load pipeline progress written by write_state; fresh state if absent."""
    if not os.path.isfile(path):
        return [False, False, False], ''
    with open(path, 'r') as f:
        fields = f.read().split('|')
    return [bool(int(x)) for x in fields[:-1]], fields[-1]


def str2bool(v) -> bool:
    """argparse-safe bool ('--restore False' means False)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ('true', '1', 'yes', 'y'):
        return True
    if v.lower() in ('false', '0', 'no', 'n'):
        return False
    raise argparse.ArgumentTypeError(f'expected a boolean, got {v!r}')


def _banner(title: str) -> None:
    rule = '#' * 64
    log('\n{}\n# {}\n{}\n'.format(rule, title, rule))


def run_pipeline(args, log_dir: str, hparams, device) -> str:
    """The resumable 3-phase Tacotron-2 pipeline (train.py:69-113). Returns the path of
    the state_log."""
    from .inference.tacotron_synthesizer import tacotron_synthesize
    from .training import tacotron_train, wavenet_train

    state_file = os.path.join(log_dir, 'state_log')
    done, gta_map = read_state(state_file)

    if all(done):
        log('Pipeline state shows all three phases finished; nothing to do. '
            'Delete {} to retrain.'.format(state_file))
        return state_file

    lead = distributed.is_lead()
    if not done[0]:
        _banner('Phase 1/3: Tacotron training')
        checkpoint = tacotron_train.train(log_dir, args, hparams, device)
        done[0] = True
        if lead:
            write_state(state_file, done, gta_map)
    else:
        checkpoint = os.path.join(log_dir, 'taco_pretrained')

    if not done[1]:
        _banner('Phase 2/3: ground-truth-aligned synthesis')
        args.mode = 'synthesis'
        if lead:  # rank 0 alone; the other ranks wait for its map
            gta_map = tacotron_synthesize(args, hparams, checkpoint, device=device)
        gta_map = distributed.broadcast_str(gta_map)
        done[1] = True
        if lead:
            write_state(state_file, done, gta_map)

    if not gta_map:
        raise RuntimeError('No GTA map path recorded after phase 2; cannot start '
                           'WaveNet training. state_log may be corrupt: ' + state_file)

    if not done[2]:
        _banner('Phase 3/3: WaveNet training')
        wavenet_train.train(log_dir, args, hparams, gta_map, device)
        done[2] = True
        if lead:
            write_state(state_file, done, gta_map)

    log('Pipeline complete: all three phases finished.')
    return state_file


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
    parser.add_argument('--input_dir', default='training_data',
                        help='folder to contain inputs sentences/targets (the GTA '
                             'synthesis of the Tacotron-2 pipeline reads its train.txt)')
    parser.add_argument('--output_dir', default='output',
                        help='folder to contain synthesized mel spectrograms')
    parser.add_argument('--mode', default='synthesis',
                        help='mode for synthesis of tacotron after training')
    parser.add_argument('--GTA', default='True',
                        help='Ground truth aligned synthesis, defaults to True, only '
                             'considered in Tacotron synthesis mode')
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
    parser.add_argument('--tf_log_level', type=int, default=1,
                        help='accepted for train.py\'s command line; ignored')
    parser.add_argument('--slack_url', default=None,
                        help='accepted for train.py\'s command line; ignored (the port '
                             'sends no notification)')
    parser.add_argument('--profile_step', type=int, default=0,
                        help='accepted for train.py\'s command line; ignored (the port '
                             'captures no profiler trace)')
    parser.add_argument('--device', default='cuda',
                        help='torch device (default cuda: cuda:LOCAL_RANK under torchrun)')
    parser.add_argument('--dist_backend', default=None, choices=('nccl', 'gloo'),
                        help='process-group backend under torchrun (default nccl on CUDA, '
                             'gloo on the CPU)')
    args = parser.parse_args(argv)

    device = distributed.rank_device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda, but torch finds no CUDA device '
                           '(pass --device cpu to train on the CPU)')
    distributed.maybe_initialize(args.dist_backend, device=args.device)
    hp = paper_hparams() if args.paper_profile else default_hparams()
    hp.parse(args.hparams)
    run_name = args.name or args.model
    log_dir = os.path.join(args.base_dir, 'logs-{}'.format(run_name))
    os.makedirs(log_dir, exist_ok=True)
    if distributed.is_lead():
        infolog.init(os.path.join(log_dir, 'Terminal_train_log'), run_name)
    else:
        infolog.mute()

    if args.model == 'Tacotron':
        from .training.tacotron_train import train as tacotron_train
        return tacotron_train(log_dir, args, hp, device)
    if args.model == 'WaveNet':
        from .training.wavenet_train import train
        return train(log_dir, args, hp, args.wavenet_input, device)
    return run_pipeline(args, log_dir, hp, device)


if __name__ == '__main__':
    main()
