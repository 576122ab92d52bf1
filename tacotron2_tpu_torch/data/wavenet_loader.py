"""Host-side input pipeline for WaveNet training (counterpart of
`tacotron2_tpu/data/wavenet_loader.py`; numpy only).

Semantics kept:
  - consumes the GTA map.txt (train_with_GTA) or ground-truth train.txt metadata
  - deterministic train/test split (random_state 1234)
  - hop-aligned random crop to max_time_steps (feeder.py:368-401, _ensure_divisible)
  - mel conditioning clipped to the Tacotron output range then rescaled to [0, 1]
    (feeder.py:319-340)
  - audio targets as raw floats (scalar input) or int ids (mulaw-quantize)

When max_time_steps is set, every train batch is padded to exactly that
(hop-divisible) length, as in the JAX package; masks carry true lengths. Batches are
float32 audio (int64 class ids for mulaw-quantize), float32 mels and int64 lengths and
speaker ids: the JAX loader's float16 transfer option (`transfer_dtype`) is not kept.
The train/test split is `train_test_split`, sklearn's shuffle split written with numpy.
"""

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..config import Hparams
from ..ops.mulaw import is_mulaw_quantize, mulaw_quantize
from ..utils import round_down as _round_down
from ..utils import shard_rows


def train_test_split(indices: np.ndarray, test_size, random_state: int):
    """(train, test) as `sklearn.model_selection.train_test_split(indices,
    test_size=test_size, random_state=random_state)` gives them: the first n_test of
    `np.random.RandomState(random_state).permutation(n)` are the test set, the rest
    the train set, in that order; n_test is `test_size` as a count, or ceil(test_size
    * n) for a float share."""
    n = len(indices)
    if isinstance(test_size, (int, np.integer)):
        n_test = int(test_size)
    else:
        n_test = int(np.ceil(test_size * n))
    if not 0 < n_test < n:
        raise ValueError(f'test_size={test_size} leaves no train or no test example '
                         f'of {n}')
    perm = np.random.RandomState(random_state).permutation(n)
    return indices[perm[n_test:]], indices[perm[:n_test]]


def _ensure_divisible(length: int, divisible_by: int, lower: bool = True) -> int:
    if length % divisible_by == 0:
        return length
    if lower:
        return length - length % divisible_by
    return length + (divisible_by - length % divisible_by)


class WaveNetDataset:
    def __init__(self, metadata_filename: str, hparams: Hparams,
                 base_dir: Optional[str] = None):
        self._hp = hparams
        self._base_dir = base_dir if base_dir is not None else ''
        self._meta_dir = os.path.dirname(os.path.abspath(metadata_filename))
        with open(metadata_filename, encoding='utf-8') as f:
            self._metadata = [line.strip().split('|') for line in f]

        self.local_condition = hparams.cin_channels > 0
        self.global_condition = hparams.gin_channels > 0

        if hparams.wavenet_test_size is None:
            assert hparams.wavenet_test_batches is not None
        test_size = (hparams.wavenet_test_size if hparams.wavenet_test_size is not None
                     else hparams.wavenet_test_batches * hparams.wavenet_batch_size)
        indices = np.arange(len(self._metadata))
        train_idx, test_idx = train_test_split(
            indices, test_size=test_size, random_state=hparams.wavenet_data_random_state)
        keep = _round_down(len(test_idx), hparams.wavenet_batch_size)
        train_idx = np.concatenate([train_idx, test_idx[keep:]])
        test_idx = test_idx[:keep]
        self._train_meta = [self._metadata[i] for i in train_idx]
        self._test_meta = [self._metadata[i] for i in test_idx]
        self.test_steps = max(1, len(self._test_meta) // hparams.wavenet_batch_size)

        if is_mulaw_quantize(hparams.input_type):
            self._audio_pad = int(mulaw_quantize(np.array(0.0), hparams.quantize_channels))
        else:
            self._audio_pad = 0.0
        # audio lengths are immutable per row; memoized so the per-group sort and
        # per-batch crop draws don't re-open thousands of npy headers per epoch
        self._len_cache: Dict[str, int] = {}

    def __len__(self):
        return len(self._train_meta)

    # ------------------------------------------------------------------
    def _load_example(self, meta):
        hp = self._hp
        if hp.train_with_GTA and len(meta) > 2 and meta[2].endswith('.npy'):
            mel_file = meta[2]
            if 'linear' in mel_file:
                raise RuntimeError('Linear spectrogram selected instead of GTA mels; '
                                   'wrong metadata?')
        else:
            mel_file = meta[1]
        audio_data = np.load(self._resolve(meta[0], 'audio'))
        c = np.load(self._resolve(mel_file, 'mels')) if self.local_condition else None
        g = None
        if self.global_condition:
            g = meta[3]
            if g == '<no_g>':
                raise RuntimeError('global conditioning enabled but metadata has no '
                                   'speaker ids; redo preprocessing/GTA synthesis')
            g = int(g)
        return (audio_data, c, g, len(audio_data))

    def _resolve(self, path: str, subdir: str) -> str:
        """Resolve a metadata path: joined with base_dir, as written (map rows may
        already embed base_dir), or — for bare filenames — under the artifact
        subdir next to the metadata file (wavenet_preprocess layout) or under
        base_dir (train.txt layout)."""
        cand = os.path.join(self._base_dir, path)
        if os.path.isfile(cand):
            return cand
        if os.path.isfile(path):
            return path
        # base_dir layout wins over the metadata-dir fallback when both exist
        cand = os.path.join(self._base_dir, subdir, path)
        if os.path.isfile(cand):
            return cand
        cand = os.path.join(self._meta_dir, subdir, path)
        if os.path.isfile(cand):
            return cand
        return os.path.join(self._base_dir, subdir, path)

    def _max_time_steps(self) -> Optional[int]:
        hp = self._hp
        if hp.max_time_sec is not None:
            return int(hp.max_time_sec * hp.sample_rate)
        return hp.max_time_steps

    # ------------------------------------------------------------------
    def _audio_len(self, meta) -> int:
        """Audio sample count from the npy header (no data read). Cached: lengths
        never change, and each epoch asks for every row's length several times (group
        sort + per-batch crop draws)."""
        length = self._len_cache.get(meta[0])
        if length is None:
            length = int(np.load(self._resolve(meta[0], 'audio'), mmap_mode='r').shape[0])
            self._len_cache[meta[0]] = length
        return length

    def train_batches(self, seed: int = 0, group_batches: int = 64,
                      process_shard: Optional[Tuple[int, int]] = None
                      ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite generator of bucketed, cropped, padded train batches. With
        process_shard=(index, count) (`wavenet_loader.py:132-195`) the composition and
        every row's crop are drawn for the whole global batch from one RNG stream, the
        pad length from all its rows, and only this process's contiguous rows are read
        from disk and returned."""
        hp = self._hp
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self._train_meta))
        offset = 0
        n = hp.wavenet_batch_size
        while True:
            group = []
            for _ in range(n * group_batches):
                if offset >= len(order):
                    order = rng.permutation(len(self._train_meta))
                    offset = 0
                group.append(int(order[offset]))
                offset += 1
            group.sort(key=lambda i: self._audio_len(self._train_meta[i]))
            batches = [group[i:i + n] for i in range(0, len(group), n)]
            rng.shuffle(batches)
            for bidx in batches:
                yield self._prepare_batch_indices(bidx, rng, process_shard=process_shard)

    def test_batches(self) -> List[Dict[str, np.ndarray]]:
        hp = self._hp
        rng = np.random.default_rng(hp.wavenet_data_random_state)
        idxs = list(range(len(self._test_meta)))
        idxs.sort(key=lambda i: self._audio_len(self._test_meta[i]))
        n = hp.wavenet_batch_size
        batches = [idxs[i:i + n] for i in range(0, len(idxs), n)]
        return [self._prepare_batch_indices(b, rng, meta=self._test_meta)
                for b in batches]

    # ------------------------------------------------------------------
    def _prepare_batch_indices(self, bidx, rng, meta=None, process_shard=None
                               ) -> Dict[str, np.ndarray]:
        hp = self._hp
        hop = hp.get_hop_size()
        meta = self._train_meta if meta is None else meta
        metas = [meta[i] for i in bidx]

        # crop decisions for every row first, lengths from the npy headers (the order
        # of the rng draws that the JAX loader makes), then the data loads
        mts = self._max_time_steps()
        lens, starts = [], []
        for m in metas:
            n_samples = self._audio_len(m)
            if mts is not None and n_samples > mts:
                if self.local_condition:
                    max_steps = _ensure_divisible(mts, hop, True)
                    n_frames = n_samples // hop
                    starts.append(int(rng.integers(0, n_frames - max_steps // hop)))
                    lens.append(max_steps)
                else:
                    starts.append(int(rng.integers(0, n_samples - mts)))
                    lens.append(mts)
            else:
                starts.append(0)
                lens.append(n_samples)

        rows = shard_rows(len(metas), process_shard)
        cropped, gs = [], []
        for m, start, length in zip(metas[rows], starts[rows], lens[rows]):
            x, c, g, _ = self._load_example(m)
            if self.local_condition:
                assert len(x) % len(c) == 0 and len(x) // len(c) == hop
                x = x[start * hop: start * hop + length]
                c = c[start: start + length // hop, :]
            else:
                x = x[start: start + length]
            cropped.append((x, c))
            gs.append(g)

        input_lengths = np.asarray(lens[rows], np.int64)
        if mts is not None:
            # static shape: always the hop-divisible crop length
            max_len = _ensure_divisible(mts, hop, True)
        else:  # the global batch's longest row: every process pads to one shape
            max_len = _ensure_divisible(int(max(lens)), hop, False)

        audio_batch = np.stack([
            np.pad(x, (0, max_len - len(x)), constant_values=self._audio_pad)
            for x, _ in cropped]).astype(
                np.int64 if is_mulaw_quantize(hp.input_type) else np.float32)

        out = dict(audio=audio_batch, input_lengths=input_lengths)

        if self.local_condition:
            lo, hi = ((-hp.max_abs_value, hp.max_abs_value) if hp.symmetric_mels
                      else (0.0, hp.max_abs_value))
            max_frames = max_len // hop
            cs = []
            for _, c in cropped:
                if hp.clip_for_wavenet:
                    c = np.clip(c, lo, hi)
                c = np.pad(c, [(0, max_frames - len(c)), (0, 0)], constant_values=lo)
                cs.append(c)
            c_batch = np.stack(cs).astype(np.float32)
            if hp.normalize_for_wavenet:
                c_batch = (c_batch - lo) / (hi - lo)
            out['mel_conditions'] = c_batch
        if self.global_condition:
            out['speaker_ids'] = np.asarray(gs, np.int64)
        return out
