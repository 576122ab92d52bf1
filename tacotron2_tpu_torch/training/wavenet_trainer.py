"""WaveNet train and eval steps (counterpart of
`tacotron2_tpu/training/wavenet_trainer.py:26-118`; its `generate`, `StreamVocoder` and
`stream_vocode` live in `inference/wavenet_synthesizer.py` and `inference/streaming.py`).

The optimization is the JAX package's: each gradient's norm clipped to
wavenet_gradient_max_norm (with sqrt(sum + 1e-12)), then its values to
+-wavenet_gradient_max_value, then Adam with the noam or exponential learning rate read
at the step count before the increment, then an exponential moving average of every
trainable parameter (weight-norm g and v included), updated after the parameters. Adam
is written out, as optax computes it: bias-corrected moments, epsilon added outside the
root, update = lr * m_hat / (sqrt(v_hat) + eps). The JAX train step is
`jax.value_and_grad` over XLA ops and has no hand-written backward kernel; here it is
autograd over the modules, in float32 (the JAX package's bf16 compute option is not
ported).
"""

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import Tensor, nn

from ..models.wavenet.model import WaveNet, compute_wavenet_loss
from ..models.wavenet.modules import is_weight_normalized
from ..ops.mulaw import is_mulaw_quantize
from . import schedules


@dataclasses.dataclass
class WaveNetTrainState:
    """step: updates made so far. model: the live parameters. ema_model: their moving
    average, a model of its own so that generation can run on it. exp_avg, exp_avg_sq:
    Adam's moments, one tensor for each of `model.parameters()`, in that order."""
    step: int
    model: WaveNet
    ema_model: WaveNet
    exp_avg: List[Tensor]
    exp_avg_sq: List[Tensor]

    def state_dict(self) -> Dict[str, Any]:
        """Everything a restore needs, on the CPU."""
        def cpu(sd):
            return {k: v.detach().cpu() for k, v in sd.items()}
        return dict(step=self.step, model=cpu(self.model.state_dict()),
                    ema_model=cpu(self.ema_model.state_dict()),
                    exp_avg=[m.cpu() for m in self.exp_avg],
                    exp_avg_sq=[m.cpu() for m in self.exp_avg_sq])

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step = int(sd['step'])
        self.model.load_state_dict(sd['model'])
        self.ema_model.load_state_dict(sd['ema_model'])
        with torch.no_grad():
            for name in ('exp_avg', 'exp_avg_sq'):
                for mine, theirs in zip(getattr(self, name), sd[name], strict=True):
                    mine.copy_(theirs)


def _lecun_normal_(w: Tensor, generator: torch.Generator) -> None:
    # flax's lecun_normal: a normal truncated at two deviations whose variance after
    # the cut is 1 / fan_in
    std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_parameters(model: WaveNet, hp, generator: torch.Generator) -> WaveNet:
    """Initialize `model` in place as the flax modules do: truncated-normal kernels of
    variance 1 / fan_in, zero biases, weight-norm g = 1, speaker embeddings N(0, 0.1),
    and, with hp.NN_init, upsampling kernels that start as a nearest-neighbour
    upsampling scaled by NN_scaler^(1 / layers) (`modules.py:237-263, 382-392`): zero
    but for the centre row in frequency, where a SubPixel kernel holds 1 in its middle
    column and a 2D transpose kernel 1 in every column. `generator` is a CPU generator.
    The draws are torch's, not flax's: the two packages agree in distribution."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)):
            w = (module.parametrizations.weight.original if is_weight_normalized(module)
                 else module.weight)
            fresh = torch.empty(w.shape)
            if isinstance(module, nn.ConvTranspose2d):  # (in, out, kh, kw): fan_in by out
                _lecun_normal_(fresh.transpose(0, 1), generator)
            else:
                _lecun_normal_(fresh, generator)
            w.copy_(fresh)
            if module.bias is not None:
                module.bias.zero_()
            if is_weight_normalized(module):
                module.parametrizations.weight[0].g.fill_(1.0)
        elif isinstance(module, nn.Embedding):
            module.weight.copy_(0.1 * torch.randn(module.weight.shape, generator=generator))
    if model.upsample is not None and hp.NN_init:
        scale = hp.NN_scaler ** (1.0 / len(hp.upsample_scales))
        for conv in model.upsample.convs:
            w = (conv.parametrizations.weight.original if is_weight_normalized(conv)
                 else conv.weight)
            w.zero_()
            fk = w.shape[2]
            if hp.upsample_type == '2D':
                w[:, :, fk // 2, :] = scale
            else:
                w[:, :, fk // 2, 1] = scale
    return model


def create_train_state(hp, device, seed: Optional[int] = None) -> WaveNetTrainState:
    """A fresh state on `device`: parameters from `init_parameters` seeded with `seed`
    (default hp.wavenet_random_seed), the EMA a copy of them, zero moments, step 0."""
    gen = torch.Generator().manual_seed(hp.wavenet_random_seed if seed is None else seed)
    model = init_parameters(WaveNet(hp), hp, gen).to(device)
    return state_from_model(model)


def state_from_model(model: WaveNet, step: int = 0) -> WaveNetTrainState:
    """A state around `model` as it stands: the EMA a copy, zero moments."""
    params = list(model.parameters())
    return WaveNetTrainState(step=step, model=model, ema_model=copy.deepcopy(model),
                             exp_avg=[torch.zeros_like(p) for p in params],
                             exp_avg_sq=[torch.zeros_like(p) for p in params])


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Tensor]:
    """A loader batch (numpy) as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def _batch_mask(batch: Dict[str, Tensor]) -> Tensor:
    T = batch['audio'].shape[1]
    steps = torch.arange(T, device=batch['audio'].device)
    return (steps[None, :] < batch['input_lengths'][:, None]).float()


def _forward_loss(model: WaveNet, batch: Dict[str, Tensor], hp, **kw):
    """(loss, y_hat) of the teacher-forced pass over a batch. One-hot input goes in as
    class ids: the first conv looks its columns up, the same arithmetic as the one-hot
    product without the (B, T, Q) tensor."""
    y = batch['audio']
    x = y if is_mulaw_quantize(hp.input_type) else model.encode_input(y)
    y_hat = model(x, batch.get('mel_conditions'), batch.get('speaker_ids'), **kw)
    return compute_wavenet_loss(hp, y_hat, y, _batch_mask(batch)), y_hat


def clip_gradients(grads: Sequence[Tensor], hp) -> List[Tensor]:
    """Each gradient's norm clipped to wavenet_gradient_max_norm, then its values to
    +-wavenet_gradient_max_value (`wavenet_trainer.py:36-44`)."""
    out = []
    for g in grads:
        norm = torch.sqrt(torch.sum(torch.square(g)) + 1e-12)
        g = g * torch.clamp(hp.wavenet_gradient_max_norm / norm, max=1.0)
        out.append(torch.clamp(g, -hp.wavenet_gradient_max_value,
                               hp.wavenet_gradient_max_value))
    return out


def step_seed(seed: int, step: int) -> int:
    """The seed of the dropout masks of the update from `step`: a function of (seed,
    step) alone, as `fold_in(rng, state.step)` keys them (`wavenet_trainer.py:81`), so
    that a run resumed at step N draws at N + 1 the masks an uninterrupted run draws
    there. The bits are not JAX's."""
    return (seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF)


def train_step(state: WaveNetTrainState, batch: Dict[str, Tensor], hp,
               generator: Optional[torch.Generator] = None,
               dropout_masks: Optional[Sequence[Tensor]] = None) -> Dict[str, Any]:
    """One update of `state`, in place (counterpart of `train_step`,
    `wavenet_trainer.py:76-104`). `generator` (on the batch's device) draws the dropout
    masks unless `dropout_masks` gives them. Returns the metrics: `loss` and
    `grad_norm` (the global norm of the unclipped gradients) as 0-d tensors on the
    device, not read back here, and `learning_rate`, read at the step before the
    increment."""
    params = list(state.model.parameters())
    loss, _ = _forward_loss(state.model, batch, hp, train=True, generator=generator,
                            dropout_masks=dropout_masks)
    # the last layer's residual 1x1 feeds nothing: its gradient is zero, as in JAX
    grads = [g if g is not None else torch.zeros_like(p) for g, p in
             zip(torch.autograd.grad(loss, params, allow_unused=True), params)]
    with torch.no_grad():
        grad_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        if hp.wavenet_clip_gradients:
            grads = clip_gradients(grads, hp)
        lr = schedules.wavenet_learning_rate(hp, state.step)
        b1, b2 = hp.wavenet_adam_beta1, hp.wavenet_adam_beta2
        t = state.step + 1
        torch._foreach_mul_(state.exp_avg, b1)
        torch._foreach_add_(state.exp_avg, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.exp_avg_sq, b2)
        torch._foreach_addcmul_(state.exp_avg_sq, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(state.exp_avg_sq, 1.0 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, hp.wavenet_adam_epsilon)
        torch._foreach_addcdiv_(params, state.exp_avg, denom, value=-lr / (1.0 - b1 ** t))
        # the EMA after the update, as ema.apply chained after Adam
        decay = hp.wavenet_ema_decay
        ema = list(state.ema_model.parameters())
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, params, alpha=1.0 - decay)
    state.step = t
    return dict(loss=loss.detach(), grad_norm=grad_norm, learning_rate=lr)


@torch.no_grad()
def eval_teacher_forced_step(state: WaveNetTrainState, batch: Dict[str, Tensor], hp
                             ) -> Dict[str, Tensor]:
    """Teacher-forced loss and params on the live (not the EMA) weights, without
    dropout (`wavenet_trainer.py:107-118`)."""
    loss, y_hat = _forward_loss(state.model, batch, hp)
    return dict(loss=loss, y_hat=y_hat)
