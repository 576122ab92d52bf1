"""Pieces the WaveNet and the Tacotron trainers share: the compute dtype, flax's
lecun-normal initializer, Adam as optax computes it, the gradients' sum over the data
group, the seed of a step's random draws, a loader batch on the device, and the
per-step log line of the training loops."""

import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor, nn

from ..infolog import log
from ..parallel.collectives import all_reduce_flat_
from ..utils import ValueWindow


def resolve_compute_dtype(hp, device) -> torch.dtype:
    """The dtype the trainers compute in on `device` (counterpart of
    `resolve_compute_dtype`, `tacotron_trainer.py:130-135`): bfloat16 on a CUDA device
    where hp.compute_dtype is 'bfloat16' (the default), else float32. The CPU stays
    float32, as the JAX package keeps it."""
    on_card = torch.device(device).type == 'cuda'
    return torch.bfloat16 if on_card and hp.compute_dtype == 'bfloat16' else torch.float32


def lecun_normal_(w: Tensor, generator: torch.Generator) -> None:
    # flax's lecun_normal: a normal truncated at two deviations whose variance after
    # the cut is 1 / fan_in
    std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def adam_update_(params: Sequence[Tensor], grads: Sequence[Tensor],
                 exp_avg: Sequence[Tensor], exp_avg_sq: Sequence[Tensor], lr: float,
                 b1: float, b2: float, eps: float, t: int) -> None:
    """Adam's update of `params` and its moments in place, as optax computes it: the
    moments bias-corrected for update number `t` (1 for the first), epsilon added
    outside the root, params -= lr * m_hat / (sqrt(v_hat) + eps)."""
    torch._foreach_mul_(exp_avg, b1)
    torch._foreach_add_(exp_avg, grads, alpha=1.0 - b1)
    torch._foreach_mul_(exp_avg_sq, b2)
    torch._foreach_addcmul_(exp_avg_sq, grads, grads, value=1.0 - b2)
    denom = torch._foreach_div(exp_avg_sq, 1.0 - b2 ** t)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_addcdiv_(params, exp_avg, denom, value=-lr / (1.0 - b1 ** t))


def all_reduce_grads(grads: Sequence[Tensor], group) -> None:
    """Sum the gradients in place over the data `group` (None: one process), in one
    all-reduce of a flat buffer, after the backward and before the norm, the clip, Adam
    and the EMA. Each rank's loss is its share of the global batch's (its sum over the
    group's count), so the sum is the global batch's gradient. The trainers take their
    gradients with `torch.autograd.grad`, which DDP's reducer does not see."""
    all_reduce_flat_(grads, group)


def step_seed(seed: int, step: int) -> int:
    """The seed of the random draws of the update from `step`: a function of (seed,
    step) alone, as `fold_in(rng, state.step)` keys them (`wavenet_trainer.py:81`), so
    that a run resumed at step N draws at N + 1 the masks an uninterrupted run draws
    there. The bits are not JAX's."""
    return (seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Tensor]:
    """A loader batch (numpy) as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


class StepLog:
    """The loop's line for each step: its time and loss, and their averages over the
    last 100 steps; a NaN loss or one above 100 aborts the run.

    A step's loss is read one step late, after the next step is dispatched, as the JAX
    loops do, so that the read waits for a step that has long finished while the device
    works on the next; `flush` reads it at once where an interval needs it. A step's
    time runs from its start to the start of the next step, or, where its loss is read
    at once, to that read, which waits for the step's work on the device. So the times
    sum to the loop's wall less what runs between steps (evals, checkpoints)."""

    def __init__(self):
        self.time_window, self.loss_window = ValueWindow(100), ValueWindow(100)
        self.pending: Optional[Tuple[int, Dict[str, Any], float]] = None

    def add(self, step: int, metrics: Dict[str, Any], start: float) -> None:
        """Record the step `step` that started at `start` (time.time()); the step
        before it, if its loss is not read yet, ends at `start`."""
        if self.pending is not None:
            self._resolve(*self.pending, end=start)
        self.pending = (step, metrics, start)

    def flush(self) -> None:
        """Read the pending step's loss now."""
        if self.pending is not None:
            self._resolve(*self.pending, end=None)
            self.pending = None

    def _resolve(self, step: int, metrics: Dict[str, Any], start: float,
                 end: Optional[float]) -> None:
        loss = float(metrics['loss'])
        self.time_window.append((time.time() if end is None else end) - start)
        self.loss_window.append(loss)
        log('Step {:7d} [{:.3f} sec/step, loss={:.5f}, avg_loss={:.5f}]'.format(
            step, self.time_window.average, loss, self.loss_window.average), end='\r')
        if np.isnan(loss) or loss > 100.0:
            log('Loss exploded to {:.5f} at step {}'.format(loss, step))
            raise RuntimeError('Loss exploded')
