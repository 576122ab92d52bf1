"""Mu-law companding and quantization on numpy arrays and torch tensors alike
(counterpart of `tacotron2_tpu/ops/mulaw.py:22-63`), and the input-type predicates.
"""

import math
from typing import Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor, float]


def _xp(x):
    # tensors use torch; numpy arrays and python scalars use numpy
    return torch if isinstance(x, torch.Tensor) else np


def mulaw(x: Array, mu: int = 256) -> Array:
    """Mu-law companding: [-1, 1] -> [-1, 1]."""
    xp = _xp(x)
    return xp.sign(x) * xp.log1p(mu * xp.abs(x)) / math.log1p(float(mu))


def inv_mulaw(y: Array, mu: int = 256) -> Array:
    xp = _xp(y)
    return xp.sign(y) * (1.0 / mu) * ((1.0 + mu) ** xp.abs(y) - 1.0)


def mulaw_quantize(x: Array, mu: int = 256) -> Array:
    """Mu-law companding + quantize: [-1, 1] -> [0, mu] (int32, truncated)."""
    y = (mulaw(x, mu) + 1) / 2 * mu
    return y.to(torch.int32) if isinstance(y, torch.Tensor) else np.asarray(y).astype(np.int32)


def inv_mulaw_quantize(y: Array, mu: int = 256) -> Array:
    if isinstance(y, torch.Tensor):
        yf = 2.0 * y.to(torch.float32) / mu - 1.0
    else:
        yf = 2.0 * np.asarray(y, dtype=np.float32) / mu - 1.0
    return inv_mulaw(yf, mu)


# --- input-type predicates ---

def is_mulaw_quantize(input_type: str) -> bool:
    return input_type == 'mulaw-quantize'


def is_mulaw(input_type: str) -> bool:
    return input_type == 'mulaw'


def is_raw(input_type: str) -> bool:
    return input_type == 'raw'


def is_scalar_input(input_type: str) -> bool:
    return is_raw(input_type) or is_mulaw(input_type)
