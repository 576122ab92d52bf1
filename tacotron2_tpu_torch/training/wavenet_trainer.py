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
autograd over the modules, in a compute dtype, by default `common.resolve_compute_dtype`'s
for the batch's device (bfloat16 on the card at the default hparams, float32 on the
CPU): the convs cast where flax's do, the parameters, the loss, the clip, Adam and the
EMA stay float32.

Under a mesh (`parallel/mesh.py`) each rank takes its rows of the global batch and the
step is the global batch's, as the JAX package's GSPMD step computes it
(`make_jitted_steps`, `wavenet_trainer.py:372-384`): the dropout masks are drawn for the
global batch and sliced, the loss's denominator counts every rank's rows, and the
gradients are summed over the data group in one flat all-reduce before the norm, the
clip, Adam and the EMA. A tensor-parallel model (`parallel/tensor_parallel.py`) also
sums the squared norms of its sharded tensors over the model group.
"""

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import Tensor, nn

from ..models.wavenet.model import WaveNet, compute_wavenet_loss
from ..models.wavenet.modules import is_weight_normalized
from ..ops.mulaw import is_mulaw_quantize
from ..parallel.collectives import global_sum
from ..parallel.mesh import Mesh
from . import schedules
from .common import adam_update_, all_reduce_grads, lecun_normal_, resolve_compute_dtype


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


@torch.no_grad()
def init_parameters(model: WaveNet, hp, generator: torch.Generator) -> WaveNet:
    """Initialize `model` in place as the flax modules do: truncated-normal kernels of
    variance 1 / fan_in, zero biases, weight-norm g = 1, speaker embeddings N(0, 0.1),
    and, with hp.NN_init, upsampling kernels that start as a nearest-neighbour
    upsampling scaled by NN_scaler^(1 / layers) (`modules.py:237-263, 340-392`): a 1D
    kernel the identity over channels at every tap; the others zero but for the centre
    row in frequency, where a SubPixel kernel holds 1 in its middle column, a Resize
    kernel 1 in its middle column (the two middle ones for an even scale) and a 2D
    transpose kernel 1 in every column. `generator` is a CPU generator. The draws are
    torch's, not flax's: the two packages agree in distribution."""
    transposed = (nn.ConvTranspose1d, nn.ConvTranspose2d)
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d) + transposed):
            w = (module.parametrizations.weight.original if is_weight_normalized(module)
                 else module.weight)
            fresh = torch.empty(w.shape)
            if isinstance(module, transposed):  # (in, out, k...): fan_in by out
                lecun_normal_(fresh.transpose(0, 1), generator)
            else:
                lecun_normal_(fresh, generator)
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
            if hp.upsample_type == '1D':                    # (cin, cin, s)
                w[:] = scale * torch.eye(w.shape[0])[:, :, None]
                continue
            fk, kw = w.shape[2], w.shape[3]
            if hp.upsample_type == '2D':
                w[:, :, fk // 2, :] = scale
            else:  # SubPixel (kw 3), Resize (kw the scale)
                cols = [kw // 2 - 1, kw // 2] if kw % 2 == 0 else [kw // 2]
                w[:, :, fk // 2, cols] = scale
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


def _batch_mask(batch: Dict[str, Tensor]) -> Tensor:
    T = batch['audio'].shape[1]
    steps = torch.arange(T, device=batch['audio'].device)
    return (steps[None, :] < batch['input_lengths'][:, None]).float()


def _forward_loss(model: WaveNet, batch: Dict[str, Tensor], hp, group=None, **kw):
    """(loss, y_hat) of the teacher-forced pass over a batch, the loss's denominator
    counted over the data `group`. One-hot input goes in as class ids: the first conv
    looks its columns up, the same arithmetic as the one-hot product without the
    (B, T, Q) tensor."""
    y = batch['audio']
    x = y if is_mulaw_quantize(hp.input_type) else model.encode_input(y)
    y_hat = model(x, batch.get('mel_conditions'), batch.get('speaker_ids'), **kw)
    return compute_wavenet_loss(hp, y_hat, y, _batch_mask(batch), group), y_hat


def _square_sums(grads: Sequence[Tensor], params: Sequence[Tensor],
                 mesh: Optional[Mesh]) -> List[Tensor]:
    """Each gradient's sum of squares over the whole tensor: a tensor-parallel shard's
    (`tensor_parallel` set on its parameter) summed over the model group."""
    sums = [torch.sum(torch.square(g)) for g in grads]
    if mesh is None or mesh.model_group is None:
        return sums
    sharded = [i for i, p in enumerate(params) if getattr(p, 'tensor_parallel', False)]
    if sharded:
        total = global_sum(torch.stack([sums[i] for i in sharded]), mesh.model_group)
        for j, i in enumerate(sharded):
            sums[i] = total[j]
    return sums


def clip_gradients(grads: Sequence[Tensor], hp,
                   square_sums: Optional[Sequence[Tensor]] = None) -> List[Tensor]:
    """Each gradient's norm clipped to wavenet_gradient_max_norm, then its values to
    +-wavenet_gradient_max_value (`wavenet_trainer.py:36-44`). `square_sums`: each
    tensor's sum of squares where it is not this rank's gradient alone (a shard's)."""
    out = []
    for i, g in enumerate(grads):
        sq = torch.sum(torch.square(g)) if square_sums is None else square_sums[i]
        norm = torch.sqrt(sq + 1e-12)
        g = g * torch.clamp(hp.wavenet_gradient_max_norm / norm, max=1.0)
        out.append(torch.clamp(g, -hp.wavenet_gradient_max_value,
                               hp.wavenet_gradient_max_value))
    return out


def global_dropout_masks(model: WaveNet, hp, batch: Dict[str, Tensor],
                         generator: torch.Generator, mesh: Mesh) -> Optional[List[Tensor]]:
    """This rank's rows of the dropout masks of the global batch (data_size times this
    rank's rows), drawn from `generator` layer by layer as the one-process pass draws
    them; None without dropout."""
    if not hp.wavenet_dropout > 0:
        return None
    B, T = batch['audio'].shape
    rows = mesh.rows(B * mesh.data_size)
    shape = (B * mesh.data_size, T, hp.residual_channels)
    return [layer.dropout_mask(shape, generator)[rows] for layer in model.residual_layers]


def train_step(state: WaveNetTrainState, batch: Dict[str, Tensor], hp,
               generator: Optional[torch.Generator] = None,
               dropout_masks: Optional[Sequence[Tensor]] = None,
               dtype: Optional[torch.dtype] = None,
               mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """One update of `state`, in place (counterpart of `train_step`,
    `wavenet_trainer.py:76-104`), its pass in the compute dtype `dtype` (None: the one
    `resolve_compute_dtype` gives the batch's device). `generator`
    (on the batch's device) draws the dropout masks unless `dropout_masks` gives them.
    With a `mesh`, `batch` is this rank's rows of the global batch, `dropout_masks`
    (when given) are this rank's rows too, and the update is the global batch's (see
    the module's docstring). Returns the metrics: `loss` and
    `grad_norm` (the global norm of the unclipped gradients) as 0-d tensors on the
    device, not read back here, and `learning_rate`, read at the step before the
    increment."""
    params = list(state.model.parameters())
    dtype = dtype or resolve_compute_dtype(hp, batch['audio'].device)
    group = mesh.data_group if mesh is not None else None
    if mesh is not None and dropout_masks is None and generator is not None:
        dropout_masks = global_dropout_masks(state.model, hp, batch, generator, mesh)
    loss, _ = _forward_loss(state.model, batch, hp, group, train=True, generator=generator,
                            dropout_masks=dropout_masks, dtype=dtype)
    # the last layer's residual 1x1 feeds nothing: its gradient is zero, as in JAX
    grads = [g if g is not None else torch.zeros_like(p) for g, p in
             zip(torch.autograd.grad(loss, params, allow_unused=True), params)]
    with torch.no_grad():
        all_reduce_grads(grads, group)
        square_sums = _square_sums(grads, params, mesh) if mesh is not None else None
        grad_norm = torch.sqrt(sum(square_sums) if square_sums is not None else
                               sum(torch.sum(torch.square(g)) for g in grads))
        if hp.wavenet_clip_gradients:
            grads = clip_gradients(grads, hp, square_sums)
        lr = schedules.wavenet_learning_rate(hp, state.step)
        t = state.step + 1
        adam_update_(params, grads, state.exp_avg, state.exp_avg_sq, lr,
                     hp.wavenet_adam_beta1, hp.wavenet_adam_beta2, hp.wavenet_adam_epsilon, t)
        # the EMA after the update, as ema.apply chained after Adam
        decay = hp.wavenet_ema_decay
        ema = list(state.ema_model.parameters())
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, params, alpha=1.0 - decay)
    state.step = t
    return dict(loss=global_sum(loss, group), grad_norm=grad_norm, learning_rate=lr)


def make_tp_train_step(hp, mesh: Mesh):
    """The tensor-parallel train step over `mesh` (counterpart of `make_tp_train_step`,
    `wavenet_trainer.py:387-394`), in float32: `train_step` on a state that
    `parallel.tensor_parallel.shard_wavenet_state` placed, each rank on its rows of the
    batch. The model's blocks sum their partial products over the model group; the step
    sums the gradients over the data group and the sharded tensors' norms over the
    model group."""
    def step(state: WaveNetTrainState, batch: Dict[str, Tensor],
             generator: Optional[torch.Generator] = None,
             dropout_masks: Optional[Sequence[Tensor]] = None) -> Dict[str, Any]:
        return train_step(state, batch, hp, generator, dropout_masks, torch.float32, mesh)
    return step


@torch.no_grad()
def eval_teacher_forced_step(state: WaveNetTrainState, batch: Dict[str, Tensor], hp,
                             dtype: Optional[torch.dtype] = None,
                             mesh: Optional[Mesh] = None) -> Dict[str, Tensor]:
    """Teacher-forced loss and params on the live (not the EMA) weights, without
    dropout, in the compute dtype `dtype` (None: as `train_step` resolves it;
    `wavenet_trainer.py:107-118`). With a `mesh`, `batch` is this rank's rows: the loss
    is the global batch's, y_hat this rank's rows'."""
    dtype = dtype or resolve_compute_dtype(hp, batch['audio'].device)
    group = mesh.data_group if mesh is not None else None
    loss, y_hat = _forward_loss(state.model, batch, hp, group, dtype=dtype)
    return dict(loss=global_sum(loss, group), y_hat=y_hat)
