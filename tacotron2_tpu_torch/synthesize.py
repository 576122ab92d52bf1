"""Text -> mel -> wav with the port: the counterpart of `synthesize.py --model=Tacotron-2`
(eval mode), run in memory.

    python -m tacotron2_tpu_torch.synthesize \\
        --tacotron_checkpoint taco.pt --wavenet_checkpoint wavenet.pt \\
        [--text_list sentences.txt] [--hparams 'k=v,...'] [--output_dir output/] \\
        [--device cuda]

The checkpoints are the files `convert.save_checkpoint` writes. Writes one wav per
sentence and a `map.txt` of `text|wav` lines into --output_dir. The device defaults to
cuda; on a CUDA device the WaveNet AR loop runs in the hand-written kernel.
"""

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence

import torch

from tacotron2_tpu.config import default_hparams

from .convert import load_checkpoint
from .inference.tacotron_synthesizer import Synthesizer as TacotronSynthesizer
from .inference.wavenet_synthesizer import Synthesizer as WaveNetSynthesizer
from .models.tacotron.model import Tacotron
from .models.wavenet.model import WaveNet
from .ops.audio import save_wav


def get_sentences(text_list: str, hp) -> List[str]:
    """`text_list` file (one sentence per line), or hp.sentences."""
    if text_list:
        with open(text_list, encoding='utf-8') as f:
            return [line.rstrip('\n') for line in f if line.strip()]
    return list(hp.sentences)


def load_models(tacotron_checkpoint: str, wavenet_checkpoint: str, hp, device):
    taco = Tacotron(hp)
    taco.load_state_dict(load_checkpoint(tacotron_checkpoint, 'tacotron'))
    wavenet = WaveNet(hp)
    wavenet.load_state_dict(load_checkpoint(wavenet_checkpoint, 'wavenet'))
    return taco.to(device).eval(), wavenet.to(device).eval()


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def synthesize(hp, sentences: Sequence[str], taco: Tacotron, wavenet: WaveNet,
               output_dir: str, device) -> Dict:
    """Run the two stages over `sentences` in batches of tacotron_synthesis_batch_size.

    Returns what was written and what it took: wav_paths, wavs (float arrays),
    decoded_frames (mel frames the decoder computed), ar_samples (samples the AR loop
    generated), and host-clock seconds for each stage and in all."""
    device = torch.device(device)
    os.makedirs(output_dir, exist_ok=True)
    taco_synth = TacotronSynthesizer(taco, hp, device)
    wave_synth = WaveNetSynthesizer(wavenet, hp)
    gen_taco = torch.Generator(device).manual_seed(hp.tacotron_random_seed)
    gen_wave = torch.Generator(device).manual_seed(hp.wavenet_random_seed)
    hop = hp.get_hop_size()
    stats = dict(wav_paths=[], wavs=[], decoded_frames=0, ar_samples=0,
                 tacotron_seconds=0.0, wavenet_seconds=0.0)
    bs = hp.tacotron_synthesis_batch_size
    wbs = hp.wavenet_synthesis_batch_size
    t_start = time.perf_counter()
    rows = []
    for i in range(0, len(sentences), bs):
        batch = list(sentences[i:i + bs])
        _sync(device)
        t0 = time.perf_counter()
        mel, lengths, decoded = taco_synth.synthesize(batch, gen_taco)
        _sync(device)
        t1 = time.perf_counter()
        mels = [mel[j, :lengths[j]] for j in range(len(batch))]
        wavs = []
        for w in range(0, len(mels), wbs):
            part = mels[w:w + wbs]
            wavs += wave_synth.synthesize(part, gen_wave)
            stats['ar_samples'] += len(part) * max(int(m.shape[0]) for m in part) * hop
        _sync(device)
        t2 = time.perf_counter()
        stats['tacotron_seconds'] += t1 - t0
        stats['wavenet_seconds'] += t2 - t1
        stats['decoded_frames'] += decoded
        for j, (text, wav) in enumerate(zip(batch, wavs)):
            path = os.path.join(output_dir, f'wav-batch_{i // bs}_sentence_{j}.wav')
            save_wav(wav, path, hp.sample_rate)
            stats['wav_paths'].append(path)
            stats['wavs'].append(wav)
            rows.append(f'{text}|{path}\n')
    with open(os.path.join(output_dir, 'map.txt'), 'w', encoding='utf-8') as f:
        f.writelines(rows)
    stats['seconds'] = time.perf_counter() - t_start
    stats['audio_seconds'] = sum(len(w) for w in stats['wavs']) / hp.sample_rate
    return stats


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(
        description='Synthesize speech (text -> mel -> wav) with the PyTorch port.')
    parser.add_argument('--tacotron_checkpoint', required=True,
                        help='Tacotron state_dict written by convert.save_checkpoint')
    parser.add_argument('--wavenet_checkpoint', required=True,
                        help='WaveNet state_dict written by convert.save_checkpoint')
    parser.add_argument('--hparams', default='',
                        help="comma-separated 'name=value' hyperparameter overrides")
    parser.add_argument('--text_list', default='',
                        help='file of sentences, one per line (default: hparams.sentences)')
    parser.add_argument('--output_dir', default='output/',
                        help='where the wavs and map.txt are written')
    parser.add_argument('--device', default='cuda', help='torch device (default cuda)')
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda, but torch finds no CUDA device '
                           '(pass --device cpu to run the plain PyTorch path)')
    hp = default_hparams()
    hp.parse(args.hparams)
    taco, wavenet = load_models(args.tacotron_checkpoint, args.wavenet_checkpoint, hp,
                                device)
    stats = synthesize(hp, get_sentences(args.text_list, hp), taco, wavenet,
                       args.output_dir, device)
    print(f'wrote {len(stats["wav_paths"])} wavs and map.txt to {args.output_dir}: '
          f'{stats["audio_seconds"]:.2f} s of audio in {stats["seconds"]:.2f} s')
    return stats


if __name__ == '__main__':
    main()
