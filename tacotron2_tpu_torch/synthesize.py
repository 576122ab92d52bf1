"""Synthesis with the port: the counterpart of `synthesize.py --model=Tacotron-2` (text
-> mel -> wav, in eval mode, run in memory, and in stream mode) and of
`synthesize.py --model=WaveNet` (the standalone vocoder over a directory of mels).

    python -m tacotron2_tpu_torch.synthesize \\
        --tacotron_checkpoint taco.pt --wavenet_checkpoint wavenet.pt \\
        [--mode eval|stream] [--text_list sentences.txt] [--paper_profile] \\
        [--hparams 'k=v,...'] [--output_dir output/] [--speaker_id 1,3] [--device cuda]
    python -m tacotron2_tpu_torch.synthesize --model WaveNet \\
        --wavenet_checkpoint wavenet.pt --mels_dir mels/ [--speaker_id 1,3] \\
        [--base_dir .] [--hparams 'k=v,...'] [--device cuda]

The checkpoints are the files `convert.save_checkpoint` writes. eval (the default)
decodes every sentence, vocodes them in batches of wavenet_synthesis_batch_size, and
writes one wav per sentence and a `map.txt` of `text|wav` lines into --output_dir.
stream vocodes each sentence in state-carried chunks, prints the time to its first
chunk, and writes `stream/stream-{i}.wav`. --model WaveNet vocodes the `mel-*.npy`
files of --mels_dir (or the mels its `map.txt` lists) into
`<base_dir>/wavenet_output/wavs/wav-*.wav` with a `map.txt` of `text|mel|wav` rows.
--speaker_id gives a multi-speaker WaveNet (gin_channels > 0) one speaker id for
each mel or sentence. --paper_profile starts from `config.paper_hparams()` (MoL-10
WaveNet, 24 layers, 2D upsampler) and --hparams applies on top. The device defaults
to cuda; on a CUDA device the WaveNet AR loop runs in the hand-written kernel.
"""

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .config import default_hparams, paper_hparams
from .convert import load_checkpoint, load_models
from .inference.streaming import StreamingSynthesizer
from .inference.tacotron_synthesizer import Synthesizer as TacotronSynthesizer
from .inference.wavenet_synthesizer import Synthesizer as WaveNetSynthesizer
from .inference.wavenet_synthesizer import parse_speaker_ids, wavenet_synthesize
from .models.tacotron.model import Tacotron
from .models.wavenet.model import WaveNet
from .ops.audio import save_wav


def get_sentences(text_list: str, hp) -> List[str]:
    """`text_list` file (one sentence per line), or hp.sentences."""
    if text_list:
        with open(text_list, encoding='utf-8') as f:
            return [line.rstrip('\n') for line in f if line.strip()]
    return list(hp.sentences)


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def synthesize(hp, sentences: Sequence[str], taco: Tacotron, wavenet: WaveNet,
               output_dir: str, device, speaker_id: Optional[str] = None) -> Dict:
    """Decode every sentence in batches of tacotron_synthesis_batch_size, then vocode
    the mels in batches of wavenet_synthesis_batch_size, in sentence order (the
    grouping of `wavenet_synthesizer.run_synthesis:189-200`), with the comma-separated
    `speaker_id`, one id a sentence, where the WaveNet is multi-speaker.

    Returns what was written and what it took: wav_paths, wavs (float arrays),
    decoded_frames (mel frames the decoder computed), ar_samples (samples the AR loop
    generated), and host-clock seconds for each stage and in all."""
    device = torch.device(device)
    speaker_ids = parse_speaker_ids(speaker_id, len(sentences))
    os.makedirs(output_dir, exist_ok=True)
    taco_synth = TacotronSynthesizer(taco, hp, device)
    wave_synth = WaveNetSynthesizer(wavenet, hp)
    gen_taco = torch.Generator(device).manual_seed(hp.tacotron_random_seed)
    gen_wave = torch.Generator(device).manual_seed(hp.wavenet_random_seed)
    hop = hp.get_hop_size()
    stats = dict(wav_paths=[], wavs=[], decoded_frames=0, ar_samples=0)
    bs = hp.tacotron_synthesis_batch_size
    wbs = hp.wavenet_synthesis_batch_size
    t_start = time.perf_counter()
    mels = []  # one (frames, num_mels) mel per sentence, on the device
    for i in range(0, len(sentences), bs):
        mel, lengths, decoded = taco_synth.synthesize(sentences[i:i + bs], gen_taco)
        mels += [mel[j, :n] for j, n in enumerate(lengths)]
        stats['decoded_frames'] += decoded
    _sync(device)
    t_taco = time.perf_counter()
    for w in range(0, len(mels), wbs):
        part = mels[w:w + wbs]
        sids = speaker_ids[w:w + wbs] if speaker_ids is not None else None
        stats['wavs'] += wave_synth.synthesize(part, gen_wave, sids)
        stats['ar_samples'] += len(part) * max(int(m.shape[0]) for m in part) * hop
    _sync(device)
    stats['tacotron_seconds'] = t_taco - t_start
    stats['wavenet_seconds'] = time.perf_counter() - t_taco
    rows = []
    for n, (text, wav) in enumerate(zip(sentences, stats['wavs'])):
        path = os.path.join(output_dir, f'wav-batch_{n // bs}_sentence_{n % bs}.wav')
        save_wav(wav, path, hp.sample_rate)
        stats['wav_paths'].append(path)
        rows.append(f'{text}|{path}\n')
    with open(os.path.join(output_dir, 'map.txt'), 'w', encoding='utf-8') as f:
        f.writelines(rows)
    stats['seconds'] = time.perf_counter() - t_start
    stats['audio_seconds'] = sum(len(w) for w in stats['wavs']) / hp.sample_rate
    return stats


def stream_synthesize(hp, sentences: Sequence[str], taco: Tacotron, wavenet: WaveNet,
                      output_dir: str, device) -> Dict:
    """One stream per sentence, with seed i (`synthesize.py:39-70`): prints the
    time to the first chunk and writes `output_dir/stream/stream-{i}.wav` from the
    concatenated chunks. Returns wav_paths, wavs, and per sentence the host-clock
    seconds to the first chunk (ttfa_seconds) and in all (seconds)."""
    out_dir = os.path.join(output_dir, 'stream')
    os.makedirs(out_dir, exist_ok=True)
    synth = StreamingSynthesizer(taco, wavenet, hp, device)
    stats = dict(wav_paths=[], wavs=[], ttfa_seconds=[], seconds=[])
    for i, text in enumerate(sentences):
        t0 = time.perf_counter()
        chunks = []
        for chunk in synth.stream(text, seed=i):
            if not chunks:
                stats['ttfa_seconds'].append(time.perf_counter() - t0)
                print(f'sentence {i}: first audio chunk ({len(chunk)} samples, '
                      f'{len(chunk) / hp.sample_rate:.2f} s of audio) after '
                      f'{stats["ttfa_seconds"][-1]:.3f} s', flush=True)
            chunks.append(chunk)
        wav = np.concatenate(chunks)
        stats['seconds'].append(time.perf_counter() - t0)
        print(f'sentence {i}: {len(wav) / hp.sample_rate:.2f} s of audio in '
              f'{stats["seconds"][-1]:.3f} s wall ({len(chunks)} chunks)', flush=True)
        path = os.path.join(out_dir, f'stream-{i}.wav')
        save_wav(wav, path, hp.sample_rate)
        stats['wav_paths'].append(path)
        stats['wavs'].append(wav)
    return stats


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(
        description='Synthesize speech (text -> mel -> wav, or mel -> wav) with the '
                    'PyTorch port.')
    parser.add_argument('--model', default='Tacotron-2', choices=('Tacotron-2', 'WaveNet'),
                        help='Tacotron-2: text -> mel -> wav (default); WaveNet: the '
                             'standalone vocoder over --mels_dir')
    parser.add_argument('--tacotron_checkpoint', default=None,
                        help='Tacotron state_dict written by convert.save_checkpoint '
                             '(required unless --model WaveNet)')
    parser.add_argument('--wavenet_checkpoint', required=True,
                        help='WaveNet state_dict written by convert.save_checkpoint')
    parser.add_argument('--hparams', default='',
                        help="comma-separated 'name=value' hyperparameter overrides")
    parser.add_argument('--paper_profile', action='store_true',
                        help='start from the exact-paper hparams profile (reference '
                             'paper_hparams.py swap-in); --hparams applies on top')
    parser.add_argument('--text_list', default='',
                        help='file of sentences, one per line (default: hparams.sentences)')
    parser.add_argument('--output_dir', default='output/',
                        help='where the wavs and map.txt are written (Tacotron-2)')
    parser.add_argument('--mels_dir', default='tacotron_output/eval/',
                        help='dir of mel .npys, or a map.txt, to vocode with --model WaveNet')
    parser.add_argument('--speaker_id', default=None,
                        help='comma-separated speaker ids for a multi-speaker WaveNet, '
                             'one for each mel (or sentence)')
    parser.add_argument('--base_dir', default='',
                        help='--model WaveNet writes into <base_dir>/wavenet_output and '
                             'looks for a relative --mels_dir there too')
    parser.add_argument('--device', default='cuda', help='torch device (default cuda)')
    parser.add_argument('--mode', default='eval', choices=('eval', 'stream'),
                        help='eval: batched text -> wav with map.txt (default); stream: '
                             'state-carried chunks per sentence, into output_dir/stream')
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda, but torch finds no CUDA device '
                           '(pass --device cpu to run the plain PyTorch path)')
    hp = paper_hparams() if args.paper_profile else default_hparams()
    hp.parse(args.hparams)
    if args.model == 'WaveNet':
        if args.mode != 'eval':
            parser.error('stream mode needs both stages (--model Tacotron-2)')
        wavenet = WaveNet(hp)
        wavenet.load_state_dict(load_checkpoint(args.wavenet_checkpoint, 'wavenet'))
        stats = wavenet_synthesize(args, hp, wavenet.to(device).eval())
        print(f'wrote {len(stats["wav_paths"])} wavs and map.txt to {stats["output_dir"]}: '
              f'{stats["audio_seconds"]:.2f} s of audio in {stats["seconds"]:.2f} s')
        return stats
    if args.tacotron_checkpoint is None:
        parser.error('--tacotron_checkpoint is required with --model Tacotron-2')
    taco, wavenet = load_models(args.tacotron_checkpoint, args.wavenet_checkpoint, hp,
                                device)
    sentences = get_sentences(args.text_list, hp)
    if args.mode == 'stream':
        stats = stream_synthesize(hp, sentences, taco, wavenet, args.output_dir, device)
        print(f'wrote {len(stats["wav_paths"])} streamed wavs to '
              f'{os.path.join(args.output_dir, "stream")}')
        return stats
    stats = synthesize(hp, sentences, taco, wavenet, args.output_dir, device,
                       args.speaker_id)
    print(f'wrote {len(stats["wav_paths"])} wavs and map.txt to {args.output_dir}: '
          f'{stats["audio_seconds"]:.2f} s of audio in {stats["seconds"]:.2f} s')
    return stats


if __name__ == '__main__':
    main()
