"""Streaming TTS HTTP service with the port (counterpart of `serve.py`).

    python -m tacotron2_tpu_torch.serve --taco_checkpoint taco.pt \\
        --wave_checkpoint wavenet.pt [--device cuda] [--port 8000] [--paper_profile] \\
        [--hparams 'k=v,...']

    curl -N 'http://localhost:8000/tts?text=Hello+world' --output hello.wav
    curl    'http://localhost:8000/healthz'

The checkpoints are the files `convert.save_checkpoint` writes. Endpoints: GET/POST
/tts (text, seed, format=wav|pcm16|f32), GET /healthz. Clients receive waveform
chunks while the WaveNet AR kernel is still generating; one utterance generates at a
time, and concurrent requests queue behind the device lock, bounded by --max-waiters
(then 503). --paper_profile starts from `config.paper_hparams()` and --hparams applies
on top. The device defaults to cuda.
"""

import argparse
from typing import Optional, Sequence

import torch

from .config import default_hparams, paper_hparams
from .inference.server import TTSServer
from .inference.streaming import StreamingSynthesizer


def build_server(argv: Optional[Sequence[str]] = None) -> TTSServer:
    """Parse the flags, load both models, warm up, and return the (not yet started)
    server: call `.start()` for a background thread or `.serve_forever()`."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--taco_checkpoint', required=True,
                   help='Tacotron state_dict written by convert.save_checkpoint')
    p.add_argument('--wave_checkpoint', required=True,
                   help='WaveNet state_dict written by convert.save_checkpoint')
    p.add_argument('--device', default='cuda', help='torch device (default cuda)')
    p.add_argument('--hparams', default='',
                   help='comma-separated name=value hparam overrides')
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=8000)
    p.add_argument('--max-waiters', type=int, default=8, dest='max_waiters')
    p.add_argument('--chunk_seconds', type=float, default=0.75)
    p.add_argument('--first_chunk_seconds', type=float, default=0.20,
                   help='smaller first chunk = faster time-to-first-audio')
    p.add_argument('--no-warmup', action='store_true',
                   help='skip the warmup synthesis (the first request pays the kernel '
                        'build and the CUDA start-up)')
    p.add_argument('--warmup_buckets', type=int, default=1,
                   help="accepted for serve.py's command line and ignored: eager PyTorch "
                        'compiles nothing per text bucket, so one warmup stream serves all')
    p.add_argument('--wavenet_checkpoint_step', default=None,
                   help="where the WaveNet checkpoint is a trainer's directory "
                        "(logs-<name>/wave_pretrained): a step number, 'latest' "
                        "(default), or 'best' (the step whose natural eval scored "
                        'best in the eval-history sidecar)')
    p.add_argument('--paper_profile', action='store_true',
                   help='start from the exact-paper hparams profile (reference '
                        'paper_hparams.py swap-in); --hparams applies on top')
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda, but torch finds no CUDA device '
                           '(pass --device cpu to run the plain PyTorch path)')
    hp = paper_hparams() if args.paper_profile else default_hparams()
    hp.parse(args.hparams)
    synth = StreamingSynthesizer.load(args.taco_checkpoint, args.wave_checkpoint, hp,
                                      device, args.wavenet_checkpoint_step)

    def stream_fn(text, seed):
        return synth.stream(text, seed=seed, chunk_seconds=args.chunk_seconds,
                            first_chunk_seconds=args.first_chunk_seconds)

    if not args.no_warmup:
        # one stream builds the kernel and starts CUDA; eager PyTorch compiles nothing
        # per text length, so unlike serve.py there is no warmup per text bucket
        for _ in stream_fn('All work and no play makes Jack a dull boy.', 0):
            pass
        print('warmed up with one stream', flush=True)
    return TTSServer(stream_fn, sample_rate=hp.sample_rate, host=args.host,
                     port=args.port, max_waiters=args.max_waiters)


def main(argv: Optional[Sequence[str]] = None) -> None:
    server = build_server(argv)
    print('Streaming TTS service on http://{}:{}  (GET /tts?text=..., /healthz)'
          .format(*server.address), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print('Shutting down.', flush=True)
        server.close()


if __name__ == '__main__':
    main()
