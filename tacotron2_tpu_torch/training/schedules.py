"""The WaveNet learning-rate schedule (counterpart of `wavenet_learning_rate`,
`tacotron2_tpu/training/schedules.py:42-52`), a plain function of the step. The
trainer reads it at the step count before the update's increment."""

import numpy as np


def wavenet_learning_rate(hp, step: int) -> float:
    """noam: lr * warmup^0.5 * min(step * warmup^-1.5, step^-0.5) with step at least 1;
    exponential: lr * decay_rate^(step / decay_steps). Computed in float32, as the JAX
    schedule is."""
    step = np.float32(step)
    if hp.wavenet_lr_schedule == 'noam':
        step = np.maximum(step, np.float32(1.0))
        w = hp.wavenet_warmup
        return float(np.float32(hp.wavenet_learning_rate * (w ** 0.5)) * np.minimum(
            step * np.float32(w ** -1.5), np.power(step, np.float32(-0.5))))
    return float(np.float32(hp.wavenet_learning_rate) * np.power(
        np.float32(hp.wavenet_decay_rate), step / np.float32(hp.wavenet_decay_steps)))
