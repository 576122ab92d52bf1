"""Background prefetch of batches (counterpart of `Prefetcher`,
`tacotron2_tpu/data/loader.py:172-214`; the Tacotron dataset is not ported)."""

import queue
import threading
from typing import Iterator, Optional


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
