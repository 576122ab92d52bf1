"""WaveNet batch synthesis, mel -> wav (counterpart of
`tacotron2_tpu/inference/wavenet_synthesizer.py` and of the generate dispatch of
`tacotron2_tpu/training/wavenet_trainer.py:171-238`).

The vocoder stands alone (`run_synthesis` over a directory of mel .npy files or a
map.txt, `python -m tacotron2_tpu_torch.synthesize --model WaveNet`) or follows
Tacotron in memory. The AR loop runs on the device of the conditioning: on a CUDA
device through the hand-written kernel, on the CPU through its plain PyTorch version;
teacher forcing and a model without local conditioning, which the JAX package's kernel
does not take either, run `WaveNet.incremental`; a configuration whose kernel is not
ported (more classes than MAX_CLASSES) raises. There is no batch tiling; the kernel
states its own limits. The waveplots of the JAX package are not written.
"""

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from ..models.wavenet.model import WaveNet
from ..ops import wavenet_ar
from ..ops.audio import save_wav
from ..ops.mulaw import inv_mulaw, inv_mulaw_quantize, is_mulaw, is_mulaw_quantize


def prepare_conditions(mels: Sequence[Tensor], hp) -> Tensor:
    """Clip to [lo, hi], pad every mel to the longest with lo, rescale to [0, 1]
    (wavenet_synthesizer.py:68-84). mels: (frames_i, num_mels) each, one device."""
    lo, hi = ((-hp.max_abs_value, hp.max_abs_value) if hp.symmetric_mels
              else (0.0, hp.max_abs_value))
    max_frames = max(int(m.shape[0]) for m in mels)
    out = []
    for m in mels:
        m = m.float()
        if hp.clip_for_wavenet:
            m = torch.clamp(m, lo, hi)
        out.append(F.pad(m, (0, 0, 0, max_frames - m.shape[0]), value=lo))
    c = torch.stack(out)
    if hp.normalize_for_wavenet:
        c = (c - lo) / (hi - lo)
    return c


@torch.no_grad()
def generate(model: WaveNet, hp, generator: torch.Generator, c: Optional[Tensor],
             g: Optional[Tensor] = None, synthesis_length: Optional[int] = None,
             targets: Optional[Tensor] = None, return_params: bool = True,
             use_kernel: Optional[bool] = None,
             weights: Optional[Dict[str, Tensor]] = None) -> Dict[str, Tensor]:
    """Autoregressive generation (counterpart of `generate`,
    `wavenet_trainer.py:171-238`, without its batch tiling and in-kernel NLL).

    Takes the packed-weight AR path (`wavenet_ar.generate_ar`: the kernel on a CUDA
    device, its plain version on the CPU) when the call is free-running with local
    conditioning, and raises there on a configuration `wavenet_ar.check_supported`
    rejects. Teacher forcing (`targets`), `c is None` and use_kernel=False run the
    sample-by-sample `WaveNet.incremental`, the oracle that shares no packed weights.

    Args:
        c: (B, frames, cin) conditioning, clipped and rescaled (`prepare_conditions`).
        g: (B,) speaker ids, used when the model has global conditioning.
        targets: (B, T) audio or class ids for teacher-forced generation.
        weights: `wavenet_ar.pack_params(model, hp)`, when the caller holds them.
    Returns: dict with 'audio' (B, T) and, when asked for, 'params' (B, T, out)."""
    if g is not None and hp.gin_channels <= 0:
        g = None
    if use_kernel is None:
        use_kernel = targets is None and c is not None
    if not use_kernel:
        out = model.incremental(c, g, synthesis_length, targets=targets, generator=generator)
        return out if return_params else dict(audio=out['audio'])
    c_up = model.upsample_conditioning(c).contiguous()
    noise = wavenet_ar.make_noise(hp, generator, c_up.shape[0], c_up.shape[1], c_up.device)
    if weights is None:
        weights = wavenet_ar.pack_params(model, hp)
    g_cond = (wavenet_ar.pack_global(model, hp, model.embed_global(g))
              if g is not None else None)
    audio, params = wavenet_ar.generate_ar(weights, c_up, noise, hp,
                                           return_params=return_params, g_cond=g_cond)
    return dict(audio=audio, params=params) if return_params else dict(audio=audio)


class Synthesizer:
    def __init__(self, model: WaveNet, hp):
        self._model = model.eval()
        self._hp = hp
        # packed once per model; teacher forcing does not read them
        self._weights = None if hp.wavenet_synth_debug else wavenet_ar.pack_params(model, hp)

    def _debug_targets(self, B: int, T: int, device) -> Tensor:
        """The wavs of hp.wavenet_debug_wavs as (B, T) targets, cut or zero-padded to T
        (wavenet_synthesizer.py:95-105)."""
        tgt = np.zeros((B, T), np.float32)
        for i, path in enumerate(self._hp.wavenet_debug_wavs[:B]):
            w = np.asarray(np.load(path), np.float32)
            n = min(len(w), T)
            tgt[i, :n] = w[:n]
        return torch.from_numpy(tgt).to(device)

    @torch.no_grad()
    def synthesize(self, mels: Sequence[Tensor], generator: torch.Generator,
                   speaker_ids: Optional[Sequence[int]] = None) -> List[np.ndarray]:
        """Vocode a batch of mels; returns one waveform of frames_i * hop samples each,
        mu-law decoded where the model's input type is (wavenet_synthesizer.py:86-131).
        `speaker_ids`, one a mel, condition a multi-speaker model. With
        hp.wavenet_synth_debug the generation is teacher-forced on
        hp.wavenet_debug_wavs."""
        hp = self._hp
        hop = hp.get_hop_size()
        c = prepare_conditions(mels, hp)
        g = (torch.as_tensor(list(speaker_ids), dtype=torch.long, device=c.device)
             if speaker_ids is not None else None)
        targets = (self._debug_targets(c.shape[0], c.shape[1] * hop, c.device)
                   if hp.wavenet_synth_debug else None)
        audio = generate(self._model, hp, generator, c, g, targets=targets,
                         return_params=False, weights=self._weights)['audio']
        audio = audio.cpu().numpy()
        if is_mulaw_quantize(hp.input_type):
            audio = inv_mulaw_quantize(audio, hp.quantize_channels)
        elif is_mulaw(hp.input_type):
            audio = inv_mulaw(audio, hp.quantize_channels)
        return [audio[i, :int(m.shape[0]) * hop] for i, m in enumerate(mels)]


def resolve_mels_input(mels_input: Union[str, Sequence[str]]) -> Tuple[List[str], List[str]]:
    """(texts, mel_files) from a map.txt path, a dir (with or without map.txt), or a
    list of mel files (wavenet_synthesizer.py:134-167). A dir that holds a map.txt is
    read as a map, so the text column survives. Map rows: `text|mel_path` (an eval
    map), `wav|gt_mel|gta_mel|g|text` (a GTA map; the GTA mel is taken), or
    `audio|mel|mel|g|timesteps|mel_frames` (a preprocessing map, no text).

    A relative mel path in a map is looked for in the map's own directory (and its
    `mels/`) before the working directory. The JAX package takes a file of that name
    in the working directory first (`:151-159`), so a stray file there shadows the
    map's mel; that order is not reproduced."""
    if isinstance(mels_input, str) and os.path.isdir(mels_input) \
            and not os.path.isfile(os.path.join(mels_input, 'map.txt')):
        mel_files = [os.path.join(mels_input, f) for f in sorted(os.listdir(mels_input))
                     if f.endswith('.npy')]
        return [''] * len(mel_files), mel_files
    if not isinstance(mels_input, str):
        return [''] * len(mels_input), list(mels_input)
    map_file = mels_input if os.path.isfile(mels_input) \
        else os.path.join(mels_input, 'map.txt')
    with open(map_file, encoding='utf-8') as f:
        rows = [line.strip().split('|') for line in f if line.strip()]
    if not rows:
        raise ValueError(f'{map_file} lists no mel')
    map_dir = os.path.dirname(os.path.abspath(map_file))

    def _resolve(p: str) -> str:
        if os.path.isabs(p):
            return p
        for cand in (os.path.join(map_dir, p), os.path.join(map_dir, 'mels', p)):
            if os.path.exists(cand):
                return cand
        return p

    if len(rows[0]) == 2:
        return [r[0] for r in rows], [_resolve(r[1]) for r in rows]
    if len(rows[0]) >= 6 and rows[0][4].isdigit() and rows[0][5].isdigit():
        return [''] * len(rows), [_resolve(r[1]) for r in rows]
    return [r[-1] for r in rows], [_resolve(r[2]) for r in rows]


def parse_speaker_ids(speaker_id: Optional[str], n: int) -> Optional[List[int]]:
    """'1,3' -> [1, 3]; None stays None. Raises unless there is one id for each of the
    n mels."""
    if speaker_id is None:
        return None
    ids = [int(s) for s in speaker_id.split(',')]
    if len(ids) != n:
        raise ValueError(f'--speaker_id names {len(ids)} speakers for {n} mels')
    return ids


def run_synthesis(model: WaveNet, hp, output_dir: str,
                  mels_input: Union[str, Sequence[str]],
                  speaker_id: Optional[str] = None) -> Dict:
    """Vocode the mels of `mels_input` (see resolve_mels_input) in batches of
    wavenet_synthesis_batch_size on the model's device (wavenet_synthesizer.py:170-202):
    `output_dir/wavs/wav-{basename}.wav` for `mel-{basename}.npy`, and
    `output_dir/map.txt` rows `text|mel_path|wav_path`. `speaker_id` is the
    comma-separated ids, one a mel. The noise comes from one generator seeded with
    hp.wavenet_random_seed.

    Returns output_dir, wav_paths, wavs (float arrays), ar_samples (samples the AR loop
    generated, padding included) and host-clock seconds, in all and of audio."""
    wav_dir = os.path.join(output_dir, 'wavs')
    os.makedirs(wav_dir, exist_ok=True)
    texts, mel_files = resolve_mels_input(mels_input)
    speaker_ids = parse_speaker_ids(speaker_id, len(mel_files))
    device = next(model.parameters()).device
    synth = Synthesizer(model, hp)
    generator = torch.Generator(device).manual_seed(hp.wavenet_random_seed)
    hop = hp.get_hop_size()
    bs = hp.wavenet_synthesis_batch_size
    stats = dict(output_dir=output_dir, wav_paths=[], wavs=[], ar_samples=0)
    t_start = time.perf_counter()
    with open(os.path.join(output_dir, 'map.txt'), 'w', encoding='utf-8') as f:
        for i in range(0, len(mel_files), bs):
            files = mel_files[i:i + bs]
            mels = [torch.from_numpy(np.load(p)).to(device) for p in files]
            sids = speaker_ids[i:i + bs] if speaker_ids is not None else None
            wavs = synth.synthesize(mels, generator, sids)
            stats['ar_samples'] += len(mels) * max(int(m.shape[0]) for m in mels) * hop
            for mel_path, wav, text in zip(files, wavs, texts[i:i + bs]):
                basename = os.path.basename(mel_path).replace('.npy', '').replace('mel-', '')
                path = os.path.join(wav_dir, f'wav-{basename}.wav')
                save_wav(wav, path, hp.sample_rate)
                f.write(f'{text}|{mel_path}|{path}\n')
                stats['wav_paths'].append(path)
                stats['wavs'].append(wav)
    stats['seconds'] = time.perf_counter() - t_start
    stats['audio_seconds'] = sum(len(w) for w in stats['wavs']) / hp.sample_rate
    return stats


def wavenet_synthesize(args, hp, model: WaveNet,
                       mels_input: Union[None, str, Sequence[str]] = None) -> Dict:
    """The standalone vocoder of the CLI (wavenet_synthesizer.py:205-212): the mels of
    args.mels_dir (looked for under args.base_dir when it is relative and not found),
    with args.speaker_id, into `<args.base_dir>/wavenet_output`."""
    output_dir = os.path.join(args.base_dir, 'wavenet_output')
    if mels_input is None:
        mels_input = args.mels_dir
    if isinstance(mels_input, str) and not os.path.isabs(mels_input) \
            and not os.path.exists(mels_input):
        mels_input = os.path.join(args.base_dir, mels_input)
    return run_synthesis(model, hp, output_dir, mels_input,
                         getattr(args, 'speaker_id', None))
