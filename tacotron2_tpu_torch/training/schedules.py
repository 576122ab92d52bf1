"""Learning-rate and teacher-forcing schedules (counterpart of
`tacotron2_tpu/training/schedules.py`), plain functions of the step computed in float32
as the JAX schedules are. The trainers read them at the step count before the update's
increment."""

import numpy as np


def tacotron_learning_rate(hp, step: int) -> float:
    """Exponential decay after tacotron_start_decay, clipped to [final_lr, init_lr]
    (`schedules.py:12-19`); constant init_lr without tacotron_decay_learning_rate."""
    step = np.float32(step)
    if not hp.tacotron_decay_learning_rate:
        return float(np.float32(hp.tacotron_initial_learning_rate))
    lr = np.float32(hp.tacotron_initial_learning_rate) * np.power(
        np.float32(hp.tacotron_decay_rate),
        (step - np.float32(hp.tacotron_start_decay)) / np.float32(hp.tacotron_decay_steps))
    return float(np.clip(lr, np.float32(hp.tacotron_final_learning_rate),
                         np.float32(hp.tacotron_initial_learning_rate)))


def teacher_forcing_ratio(hp, step: int) -> float:
    """'constant': tacotron_teacher_forcing_ratio; 'scheduled': init_ratio until
    start_decay, then a narrow cosine decay to init * alpha over decay_steps, alpha the
    final ratio over the initial one, or decay_alpha where there is no final ratio
    (`schedules.py:22-39`)."""
    step = np.float32(step)
    if hp.tacotron_teacher_forcing_mode == 'constant':
        return float(np.float32(hp.tacotron_teacher_forcing_ratio))
    init = np.float32(hp.tacotron_teacher_forcing_init_ratio)
    if hp.tacotron_teacher_forcing_final_ratio is not None:
        alpha = np.float32(hp.tacotron_teacher_forcing_final_ratio / hp.tacotron_teacher_forcing_init_ratio)
    else:
        if hp.tacotron_teacher_forcing_decay_alpha is None:
            raise ValueError('scheduled teacher forcing needs a final ratio or a decay alpha')
        alpha = np.float32(hp.tacotron_teacher_forcing_decay_alpha)
    start = np.float32(hp.tacotron_teacher_forcing_start_decay)
    if step < start:
        return float(init)
    t = np.clip((step - start) / np.float32(hp.tacotron_teacher_forcing_decay_steps),
                np.float32(0.0), np.float32(1.0))
    cosine = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(np.pi) * t))
    return float(init * ((np.float32(1.0) - alpha) * cosine + alpha))


def wavenet_learning_rate(hp, step: int) -> float:
    """noam: lr * warmup^0.5 * min(step * warmup^-1.5, step^-0.5) with step at least 1;
    exponential: lr * decay_rate^(step / decay_steps) (`schedules.py:42-52`)."""
    step = np.float32(step)
    if hp.wavenet_lr_schedule == 'noam':
        step = np.maximum(step, np.float32(1.0))
        w = hp.wavenet_warmup
        return float(np.float32(hp.wavenet_learning_rate * (w ** 0.5)) * np.minimum(
            step * np.float32(w ** -1.5), np.power(step, np.float32(-0.5))))
    return float(np.float32(hp.wavenet_learning_rate) * np.power(
        np.float32(hp.wavenet_decay_rate), step / np.float32(hp.wavenet_decay_steps)))
