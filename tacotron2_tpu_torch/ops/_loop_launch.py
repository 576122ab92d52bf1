"""What the recurrences' wrappers (`gru_scan`, `lstm_scan`) share: a direction's step order,
the refusal of what a build does not take, and the launch of a C entry through ctypes.

Each loop library exports its kernels as `int t2_<name>(void **ptrs, const int *ints,
cudaStream_t stream)`: the device pointers in the order of the entry's pointer enum (null
where absent), the ints it takes, and the stream; it returns the CUDA error of the launch,
0 where it launched.
"""

import ctypes
from typing import Dict, MutableMapping, NoReturn, Optional, Sequence

import torch
from torch import Tensor


def order(x: Tensor, lengths: Optional[Tensor], rev: bool) -> Tensor:
    """(B, T, C) from sequence positions to a direction's step order, or back: each row's
    first lengths[b] steps reversed for a reversed direction, else x."""
    if not rev:
        return x
    from ..models.tacotron.modules import reverse_sequences
    return reverse_sequences(x, lengths)


def refuse(kernels: str, what: str) -> NoReturn:
    raise ValueError(f'the {kernels} kernels do not take {what}')


def check(kernels: str, name: str, xs: Sequence[Tensor], shape, dt: torch.dtype, dev) -> None:
    """Refuse, with the numbers, any of `xs` not of `shape` in `dt` on `dev`."""
    for x in xs:
        if x.shape != shape or x.dtype != dt or x.device != dev:
            refuse(kernels, f'a {name} of shape {tuple(x.shape)} in {x.dtype} on {x.device}, '
                            f'where {tuple(shape)} in {dt} on {dev} is due')


def launch(lib: ctypes.CDLL, launches: MutableMapping[str, int], name: str,
           tensors: Dict[str, Optional[Tensor]], names: Sequence[str], ints: Sequence[int],
           dev) -> None:
    """Launch the C entry t2_<name> of `lib` with the device pointers of `tensors` in the
    order of `names` (null where absent) and `ints`, on the current stream of `dev`; count
    it in launches[name]; raise where the launch failed."""
    fn = getattr(lib, f't2_{name}')
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    ptrs = (ctypes.c_void_p * len(names))(
        *(None if tensors.get(k) is None else tensors[k].data_ptr() for k in names))
    with torch.cuda.device(dev):
        err = fn(ptrs, (ctypes.c_int * len(ints))(*ints),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f'the {name} kernel did not launch: CUDA error {err}')
    launches[name] += 1
