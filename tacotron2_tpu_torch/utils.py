"""Small helpers shared by the port (counterpart of `tacotron2_tpu/utils/__init__.py`)."""

from typing import Dict

import torch
from torch import Tensor, nn


@torch.no_grad()
def randomize_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Overwrite every float parameter and buffer of `module` in place with seeded
    noise: weights ~ N(0, 1/fan_in), vectors ~ N(0, 0.1), BatchNorm running
    variances in [0.5, 1.5]. Returns `module`.

    torch's default init keeps the WaveNet head's outputs well below 0.1, where a
    comparison with an absolute bound passes a wrong result; these weights give
    outputs of order 1 (and nonzero biases, which hide no transpose). `generator`
    must be on the module's device."""
    for name, t in module.state_dict().items():
        if not t.is_floating_point():
            continue
        if name.endswith('running_var'):
            t.uniform_(0.5, 1.5, generator=generator)
        elif t.dim() >= 2:
            t.normal_(0.0, t[0].numel() ** -0.5, generator=generator)
        else:
            t.normal_(0.0, 0.1, generator=generator)
    return module


def round_up(x: int, multiple: int) -> int:
    """Round x up to the next multiple."""
    r = x % multiple
    return x if r == 0 else x + multiple - r


def suppress_stop_tokens(state_dict: Dict[str, Tensor], push: float = -100.0
                         ) -> Dict[str, Tensor]:
    """Push the Tacotron stop-projection bias so stop tokens never fire.

    Runs on random weights need the decode to go exactly `max_iters` steps: an
    untrained stop token is a coin flip that would stop it at the 4r-frame floor.
    Returns a new state_dict; the input is left as it was."""
    out = dict(state_dict)
    key = 'decoder.stop_projection.bias'
    out[key] = state_dict[key] + push
    return out
