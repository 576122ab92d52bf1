"""Host-side input pipeline for Tacotron training (counterpart of
`tacotron2_tpu/data/loader.py`): the background prefetch of batches, and the Tacotron
dataset. numpy only."""

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..text import text_to_sequence
from ..utils import round_down, round_up, shard_rows
from .wavenet_loader import train_test_split


class Prefetcher:
    """Background-thread batch prefetch (replaces feeder threads + FIFOQueue(8))."""

    def __init__(self, iterator: Iterator, depth: int = 8):
        self._it = iterator
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # propagate to consumer
            self._err = e

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            # drain queued items before surfacing a producer error
            try:
                return self._q.get(timeout=0.2)
            except queue.Empty:
                if self._err is not None:
                    raise self._err
                if not self._thread.is_alive():
                    raise StopIteration

    def close(self):
        self._stop.set()


class TacotronDataset:
    """Metadata and batching for a preprocessing `train.txt` (counterpart of
    `TacotronDataset`, `tacotron2_tpu/data/loader.py:33-171`): rows
    `audio|mel|linear|samples|frames|text`, mels under <base>/mels, linear spectrograms
    under <base>/linear.

    Kept: the train/test split (sklearn's shuffle split, `wavenet_loader.train_test_split`,
    random_state tacotron_data_random_state; the test set rounded down to whole batches,
    the rest returned to train); the bucketing (bucket_group_batches x batch examples
    sorted by mel length, cut into batches, the batches shuffled, each batch's order
    shuffled, all from `default_rng(seed)`); the pad values (inputs 0, mel and linear
    -max_abs_value when symmetric, else 0, stop token 1 with the target 0 over
    len(mel) - 1 frames); the lengths rounded up to pad_text_multiple and to
    pad_mel_multiple (itself rounded to outputs_per_step). Batches are float32 (the JAX
    loader's float16 transfer option is not kept). With process_shard=(index, count)
    (`loader.py:78-150`) the batch's composition, order and pad sizes are still decided
    for the whole global batch, from metadata and one RNG stream, and only this
    process's contiguous rows are read from disk and returned: every rank's rows have
    the global padded shape."""

    def __init__(self, metadata_filename: str, hparams, base_dir: Optional[str] = None):
        self._hp = hparams
        base = base_dir or os.path.dirname(metadata_filename)
        self._mel_dir = os.path.join(base, 'mels')
        self._linear_dir = os.path.join(base, 'linear')
        self._cleaner_names = [c.strip() for c in hparams.cleaners.split(',')]
        with open(metadata_filename, encoding='utf-8') as f:
            self._metadata = [line.strip().split('|') for line in f]
        frame_shift_ms = hparams.get_hop_size() / hparams.sample_rate
        self.hours = sum(int(x[4]) for x in self._metadata) * frame_shift_ms / 3600

        if hparams.tacotron_test_size is None and hparams.tacotron_test_batches is None:
            raise ValueError('set tacotron_test_size or tacotron_test_batches')
        test_size = (hparams.tacotron_test_size if hparams.tacotron_test_size is not None
                     else hparams.tacotron_test_batches * hparams.tacotron_batch_size)
        indices = np.arange(len(self._metadata))
        train_idx, test_idx = train_test_split(
            indices, test_size=test_size, random_state=hparams.tacotron_data_random_state)
        keep = round_down(len(test_idx), hparams.tacotron_batch_size)
        train_idx = np.concatenate([train_idx, test_idx[keep:]])
        test_idx = test_idx[:keep]
        self._train_meta = [self._metadata[i] for i in train_idx]
        self._test_meta = [self._metadata[i] for i in test_idx]
        self.test_steps = len(self._test_meta) // hparams.tacotron_batch_size
        self._target_pad = -hparams.max_abs_value if hparams.symmetric_mels else 0.0

    def __len__(self):
        return len(self._train_meta)

    def train_batches(self, seed: int = 0, process_shard: Optional[Tuple[int, int]] = None
                      ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite generator of bucketed, padded train batches; with process_shard,
        this process's rows of each."""
        hp = self._hp
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self._train_meta))
        offset = 0
        n = hp.tacotron_batch_size
        while True:
            group = []
            for _ in range(n * hp.bucket_group_batches):
                if offset >= len(order):
                    order = rng.permutation(len(self._train_meta))
                    offset = 0
                group.append(int(order[offset]))
                offset += 1
            # stable sort by the mel length of the metadata: ties keep the draw order
            group.sort(key=lambda i: int(self._train_meta[i][4]))
            batches = [group[i:i + n] for i in range(0, len(group), n)]
            rng.shuffle(batches)
            for bidx in batches:
                yield self._batch(bidx, rng, self._train_meta, process_shard)

    def test_batches(self) -> List[Dict[str, np.ndarray]]:
        """The eval batches, bucketed once by mel length."""
        hp = self._hp
        rng = np.random.default_rng(hp.tacotron_data_random_state)
        idxs = sorted(range(len(self._test_meta)), key=lambda i: int(self._test_meta[i][4]))
        n = hp.tacotron_batch_size
        return [self._batch(idxs[i:i + n], rng, self._test_meta)
                for i in range(0, len(idxs), n)]

    def _batch(self, bidx: List[int], rng, meta: List,
               process_shard: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
        hp = self._hp
        r = hp.outputs_per_step
        metas = [meta[bidx[int(i)]] for i in rng.permutation(len(bidx))]
        seqs = [np.asarray(text_to_sequence(m[5], self._cleaner_names), np.int32)
                for m in metas]
        input_lengths = np.asarray([len(s) for s in seqs], np.int32)
        targets_lengths = np.asarray([int(m[4]) for m in metas], np.int32)
        # the pad sizes of the global batch, from metadata alone
        in_max = round_up(int(input_lengths.max()), hp.pad_text_multiple)
        mel_max = round_up(round_up(int(targets_lengths.max()), r),
                           round_up(hp.pad_mel_multiple, r))
        rows = shard_rows(len(metas), process_shard)
        metas, seqs = metas[rows], seqs[rows]
        input_lengths, targets_lengths = input_lengths[rows], targets_lengths[rows]
        mels = [np.load(os.path.join(self._mel_dir, m[1])) for m in metas]

        def pad_frames(x, value):
            return np.pad(x, [(0, mel_max - len(x)), (0, 0)], constant_values=value)

        out = dict(
            inputs=np.stack([np.pad(s, (0, in_max - len(s))) for s in seqs]),
            input_lengths=input_lengths,
            mel_targets=np.stack([pad_frames(m, self._target_pad)
                                  for m in mels]).astype(np.float32),
            stop_token_targets=np.stack([
                np.pad(np.zeros(len(m) - 1, np.float32), (0, mel_max - len(m) + 1),
                       constant_values=1.0) for m in mels]),
            targets_lengths=targets_lengths)
        if hp.predict_linear:
            out['linear_targets'] = np.stack([
                pad_frames(np.load(os.path.join(self._linear_dir, m[2])), self._target_pad)
                for m in metas]).astype(np.float32)
        return out
