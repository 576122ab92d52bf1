"""Mu-law companding and quantization on numpy arrays and torch tensors alike
(counterpart of `tacotron2_tpu/ops/mulaw.py:22-63`), and the input-type predicates.

The module imports no torch: a tensor exists only once its caller has imported torch,
and the preprocessing workers (`data/preprocessor.py`), which use the numpy forms, never
do.
"""

import math
import sys
from typing import Union

import numpy as np

Array = Union[np.ndarray, 'torch.Tensor', float]


def _torch_of(x):
    """torch where x is a tensor, else None (numpy arrays and python scalars)."""
    torch = sys.modules.get('torch')
    return torch if torch is not None and isinstance(x, torch.Tensor) else None


def _xp(x):
    return _torch_of(x) or np


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
    torch = _torch_of(y)
    return y.to(torch.int32) if torch is not None else np.asarray(y).astype(np.int32)


def inv_mulaw_quantize(y: Array, mu: int = 256) -> Array:
    torch = _torch_of(y)
    if torch is not None:
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
