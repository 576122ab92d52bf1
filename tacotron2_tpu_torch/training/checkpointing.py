"""Checkpoint save / restore (counterpart of `tacotron2_tpu/training/checkpointing.py`):
the whole train state as one `torch.save` file a step, `ckpt-<step>.pt`, the newest
`max_to_keep` kept."""

import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r'^ckpt-(\d+)\.pt$')


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 20):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f'ckpt-{step}.pt')

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self._dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Write `state` (tensors are saved as they are: move them to the CPU first) and
        drop the oldest checkpoints past max_to_keep."""
        tmp = self._path(step) + '.tmp'
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))  # a crash leaves no half-written checkpoint
        for old in self.all_steps()[:-self._max_to_keep]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The state saved at `step` (default: the latest), on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f'no checkpoint found in {self._dir}')
        return torch.load(self._path(step), map_location='cpu', weights_only=True)
