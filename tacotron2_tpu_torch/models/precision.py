"""flax's compute dtype in PyTorch (the `dtype` field of the JAX package's modules).

Parameters stay float32 masters. A Dense or Conv built with `dtype` casts its input,
its kernel and its bias to `dtype`, computes in it and returns it (`cast_forward`).
Every other operation computes in the dtype its operands promote to, as in JAX: a
bfloat16 tensor against a float32 one gives float32 (BatchNorm's float32 statistics,
the attention's float32 energy parameters). A Python float against a bfloat16 tensor
is weakly typed in JAX, rounded to bfloat16 before the operation; torch keeps it in
float32, so the port rounds it first (`weak`). JAX's sigmoid is 1 / (1 + exp(-x)), each
step rounded to the dtype, where torch's rounds once (`sigmoid`). At float32 each
helper is the plain operation, bit for bit.
"""

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import Tensor, nn


def cast_forward(module: nn.Module, x: Tensor, dtype: torch.dtype) -> Tensor:
    """`module` (a Linear, a Conv or a ConvTranspose) applied to `x` with its input,
    weight and bias cast to `dtype`; at float32, `module(x)` without its hooks. In a
    reduced dtype the bias is added to the rounded product, as flax adds it, so that
    the output is rounded twice where a fused bias would round it once. Within
    `precast`, the product runs in float32 on the rounded input and precast weight and
    is then rounded: the same numbers as a product in `dtype` that accumulates in
    float32, with the weight's gradient summed over the loop's steps in float32."""
    cast = getattr(module, '_precast', None)
    if cast is not None and cast[0] == dtype:
        _, w, b = cast
        y = _apply(module, x.to(dtype).float(), w, None).to(dtype)
        if b is None:
            return y
        b = b.to(dtype)
        return y + (b if isinstance(module, nn.Linear) else b.view(-1, *[1] * (y.dim() - 2)))
    w = module.weight.to(dtype)
    b = None if module.bias is None else module.bias.to(dtype)
    if dtype == torch.float32 or b is None:
        return _apply(module, x.to(dtype), w, b)
    y = _apply(module, x.to(dtype), w, None)
    # a Linear's bias runs along the last axis, a conv's along the channels, axis 1
    return y + (b if isinstance(module, nn.Linear) else b.view(-1, *[1] * (y.dim() - 2)))


@contextlib.contextmanager
def precast(module: nn.Module, dtype: torch.dtype):
    """Within the block, `cast_forward` takes every Linear and Conv of `module` from one
    cast to `dtype` made on entry, as the JAX fused decoder casts its weights once a
    scan (`_weights`, `fused_decoder.py:96`): a loop over steps then keeps one copy of
    each for the backward, not one a step. The copy holds the rounded values in float32,
    so that the gradient that every step adds to it is summed in float32 (as that
    decoder's hand-written backward sums it) and rounded to `dtype` once. Nothing to do
    at float32."""
    layers = ([m for m in module.modules() if isinstance(m, (nn.Linear, nn.Conv1d))]
              if dtype != torch.float32 else [])
    for m in layers:
        m._precast = (dtype, m.weight.to(dtype).float(),
                      None if m.bias is None else m.bias.to(dtype).float())
    try:
        yield
    finally:
        for m in layers:
            del m._precast


def _apply(module: nn.Module, x: Tensor, w: Tensor, b) -> Tensor:
    if isinstance(module, nn.Linear):
        return F.linear(x, w, b)
    if isinstance(module, nn.ConvTranspose1d):
        return F.conv_transpose1d(x, w, b, module.stride, module.padding,
                                  module.output_padding, module.groups, module.dilation)
    if isinstance(module, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, module.stride, module.padding,
                                  module.output_padding, module.groups, module.dilation)
    return module._conv_forward(x, w, b)


def sigmoid(x: Tensor) -> Tensor:
    """jax.nn.sigmoid in x's dtype: torch.sigmoid at float32, else 1 / (1 + exp(-x))
    rounded step by step, as JAX lowers it. torch.sigmoid, rounded once, fails
    tests/test_torch_compute_dtype.py in the LSTM gates
    (test_bf16_teacher_forced_model_is_nearer_jax_bf16), the CBHG's highways and GRUs
    (test_bf16_conv_modules_match_flax[cbhg_postnet]) and WaveNet's gate
    (test_bf16_wavenet_train_step_is_nearer_jax_bf16[gaussian])."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return torch.reciprocal(torch.exp(-x) + 1.0)


@functools.lru_cache(maxsize=None)
def weak(value: float, dtype: torch.dtype) -> float:
    """The Python float `value` as JAX applies it to an array of `dtype`: rounded to
    `dtype` (unchanged in effect at float32, where torch rounds it the same way), once
    for each value and dtype."""
    return float(torch.tensor(value, dtype=dtype))
