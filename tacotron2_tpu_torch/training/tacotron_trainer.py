"""Tacotron train and eval steps (counterpart of
`tacotron2_tpu/training/tacotron_trainer.py`, without its mesh and jit).

The optimization is the JAX package's optax chain: the global norm of the gradients
(the reported grad_norm, taken before clipping), then, with tacotron_clip_gradients,
every gradient scaled by 1 / max(1, norm) (optax's clip_by_global_norm(1.0), no
epsilon), then Adam as optax computes it with the learning rate of
`schedules.tacotron_learning_rate` at the step before the increment. With
tacotron_fine_tuning the embedding and the encoder are frozen: they take no update and
hold no moments, and the clip's norm runs over the other gradients alone, as under
optax's multi_transform. The backward is autograd over the modules and the decoder's
step loop. The steps run in a compute dtype, by default `common.resolve_compute_dtype`'s
for the batch's device (bfloat16 on the card at the default hparams, float32 on the
CPU): the modules cast where flax's do, the parameters, the losses, the clip and Adam
stay float32.

Under a mesh (`parallel/mesh.py`) each rank takes its rows of the global batch and the
step is the global batch's, as the JAX package's GSPMD step computes it
(`make_jitted_steps`): the noise (dropout, zoneout, the teacher-forcing coins) is drawn
for the global batch and sliced (`shard_noise`), the losses' denominators count every
rank's rows (`losses.py`), BatchNorm's batch statistics are the global batch's
(`modules.sync_batch_norm`), and the gradients are summed over the data group in one
flat all-reduce before the norm, the clip and Adam.
"""

import dataclasses
import re
from typing import Any, Dict, List, Optional

import torch
from torch import Tensor, nn

from ..models.tacotron.flax_names import flax_name
from ..models.tacotron.losses import compute_losses, l2_parameters
from ..models.tacotron.model import Tacotron
from ..models.tacotron.modules import GRU, HighwayNet, sync_batch_norm
from ..parallel.collectives import global_sum
from ..parallel.mesh import Mesh
from . import schedules
from .common import adam_update_, all_reduce_grads, lecun_normal_, resolve_compute_dtype


@dataclasses.dataclass
class TacotronTrainState:
    """step: updates made so far. model: the parameters and BatchNorm's running
    statistics. exp_avg, exp_avg_sq: Adam's moments, one tensor for each of
    `model.parameters()`, in that order (zero for a frozen one)."""
    step: int
    model: Tacotron
    exp_avg: List[Tensor]
    exp_avg_sq: List[Tensor]

    def state_dict(self) -> Dict[str, Any]:
        """Everything a restore needs, on the CPU."""
        return dict(step=self.step,
                    model={k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                    exp_avg=[m.cpu() for m in self.exp_avg],
                    exp_avg_sq=[m.cpu() for m in self.exp_avg_sq])

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step = int(sd['step'])
        self.model.load_state_dict(sd['model'])
        with torch.no_grad():
            for name in ('exp_avg', 'exp_avg_sq'):
                for mine, theirs in zip(getattr(self, name), sd[name], strict=True):
                    mine.copy_(theirs)


def trainable(hp, name: str) -> bool:
    """Whether the parameter `name` of a port Tacotron takes updates: all of them, but
    the embedding and the encoder under tacotron_fine_tuning (`tacotron_trainer.py:39-47`)."""
    if not hp.tacotron_fine_tuning:
        return True
    path = flax_name(name).lower()
    return not ('inputs_embedding' in path or 'encoder_' in path)


@torch.no_grad()
def init_parameters(model: Tacotron, generator: torch.Generator) -> Tacotron:
    """Initialize `model` in place with the flax initializers' distributions: kernels
    lecun-normal (a normal cut at two deviations with variance 1 / fan_in), zero
    biases, the embedding N(0, 0.5^2), the attention's v_a Xavier-uniform and b_a zero,
    each highway's T bias -1, each GRU hidden kernel orthogonal gate by gate (flax's
    GRUCell), BatchNorm scale 1, bias 0, running mean 0 and variance 1. `generator` is
    a CPU generator; the draws are torch's, not flax's."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv1d)):
            fresh = torch.empty(module.weight.shape)
            lecun_normal_(fresh, generator)
            module.weight.copy_(fresh)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.copy_(0.5 * torch.randn(module.weight.shape, generator=generator))
        elif isinstance(module, nn.BatchNorm1d):
            module.reset_parameters()
    for module in model.modules():
        if isinstance(module, HighwayNet):
            module.T.bias.fill_(-1.0)
        elif isinstance(module, GRU):
            module.bias_hn.zero_()
            for block in module.hidden.weight.view(3, module.units, module.units):
                fresh = torch.empty(block.shape)
                nn.init.orthogonal_(fresh, generator=generator)
                block.copy_(fresh)
    att = model.decoder.attention
    D = att.v_a.shape[1]
    bound = (6.0 / (1 + D)) ** 0.5
    att.v_a.copy_(torch.rand(att.v_a.shape, generator=generator) * 2 * bound - bound)
    att.b_a.zero_()
    return model


def create_train_state(hp, device, seed: Optional[int] = None) -> TacotronTrainState:
    """A fresh state on `device`: parameters from `init_parameters` seeded with `seed`
    (default hp.tacotron_random_seed), zero moments, step 0."""
    gen = torch.Generator().manual_seed(hp.tacotron_random_seed if seed is None else seed)
    return state_from_model(init_parameters(Tacotron(hp), gen).to(device))


def state_from_model(model: Tacotron, step: int = 0) -> TacotronTrainState:
    """A state around `model` as it stands, with zero moments."""
    params = list(model.parameters())
    return TacotronTrainState(step=step, model=model,
                              exp_avg=[torch.zeros_like(p) for p in params],
                              exp_avg_sq=[torch.zeros_like(p) for p in params])


# the batch axis of each entry of `Tacotron.draw_noise` (the coins have none)
NOISE_BATCH_AXIS = {'encoder_convolutions': 0, 'postnet_convolutions': 0,
                    'encoder_lstm': 1, 'zo': 1}


def shard_noise(noise: Dict, rows: slice) -> Dict:
    """The rows `rows` of the noise of a global batch: the prenet masks (m1, m2, ...),
    the encoder's zoneout and the decoder's gates are time-major (batch axis 1), the
    conv blocks' masks batch-major; the coins are shared."""
    out = {}
    for k, v in noise.items():
        axis = 1 if re.fullmatch(r'm\d+', k) else NOISE_BATCH_AXIS.get(k)
        if axis is None:
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = [t.narrow(axis, rows.start, rows.stop - rows.start) for t in v]
        else:
            out[k] = v.narrow(axis, rows.start, rows.stop - rows.start)
    return out


def _noise(model: Tacotron, batch: Dict[str, Tensor], generator, deterministic: bool,
           noise: Optional[Dict] = None, mesh: Optional[Mesh] = None):
    """The draws of a pass over `batch`, `noise` where given, else drawn from
    `generator`; under a mesh those of the global batch (this rank's rows times the data
    size), sliced to this rank's rows."""
    B, T_in = batch['inputs'].shape
    size = mesh.data_size if mesh is not None else 1
    if noise is None:
        if generator is None:
            raise ValueError('a train or eval step needs a generator or its noise')
        noise = model.draw_noise(B * size, T_in, batch['mel_targets'].shape[1], generator,
                                 deterministic, batch['mel_targets'].device)
    return shard_noise(noise, mesh.rows(B * size)) if mesh is not None else noise


def _global_metrics(metrics: Dict[str, Tensor], group) -> Dict[str, Tensor]:
    """Each loss term summed over the data group: the global batch's."""
    if group is None:
        return metrics
    keys = list(metrics)
    total = global_sum(torch.stack([metrics[k].detach().float() for k in keys]), group)
    return {k: total[i] for i, k in enumerate(keys)}


def train_step(state: TacotronTrainState, batch: Dict[str, Tensor], hp,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Dict] = None,
               dtype: Optional[torch.dtype] = None,
               mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """One update of `state`, in place (counterpart of `train_step`,
    `tacotron_trainer.py:70-101`): dropout, zoneout and the teacher-forcing coins at
    the ratio of this step, drawn from `generator` (on the batch's device) unless
    `noise` gives them (`Tacotron.draw_noise`), in the compute dtype `dtype` (None: the
    one `resolve_compute_dtype` gives the batch's device). BatchNorm's running
    statistics move with the batch's. With a `mesh`, `batch` is this rank's rows of the
    global batch, `noise` (when given) the global batch's, and the update is the
    global batch's (see the module's docstring). Returns the metrics: each loss term
    (the global batch's) and `grad_norm` as 0-d
    tensors on the device, not read back here, and `learning_rate` and
    `teacher_forcing_ratio`, read at the step before the increment."""
    model = state.model
    names, params = zip(*model.named_parameters())
    ratio = schedules.teacher_forcing_ratio(hp, state.step)
    dtype = dtype or resolve_compute_dtype(hp, batch['mel_targets'].device)
    group = mesh.data_group if mesh is not None else None
    sync_batch_norm(model, group)
    noise = _noise(model, batch, generator, False, noise, mesh)
    outputs = model.teacher_forced(batch['inputs'], batch['input_lengths'],
                                   batch['mel_targets'], noise, deterministic=False,
                                   teacher_forcing_ratio=ratio, dtype=dtype)
    loss, metrics = compute_losses(outputs, batch, l2_parameters(model), hp, group)
    # a parameter the pass does not reach (none with the default hparams) gets zero
    grads = [g if g is not None else torch.zeros_like(p) for g, p in
             zip(torch.autograd.grad(loss, params, allow_unused=True), params)]
    lr = schedules.tacotron_learning_rate(hp, state.step)
    with torch.no_grad():
        all_reduce_grads(grads, group)
        grad_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        keep = [i for i, n in enumerate(names) if trainable(hp, n)]
        grads = [grads[i] for i in keep]
        if hp.tacotron_clip_gradients:
            norm = (grad_norm if len(keep) == len(names)
                    else torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads)))
            scale = torch.clamp(norm, min=1.0)
            grads = [g / scale for g in grads]
        adam_update_([params[i] for i in keep], grads, [state.exp_avg[i] for i in keep],
                     [state.exp_avg_sq[i] for i in keep], lr, hp.tacotron_adam_beta1,
                     hp.tacotron_adam_beta2, hp.tacotron_adam_epsilon, state.step + 1)
    state.step += 1
    metrics = _global_metrics({k: v.detach() for k, v in metrics.items()}, group)
    metrics.update(grad_norm=grad_norm, learning_rate=lr, teacher_forcing_ratio=ratio)
    return metrics


@torch.no_grad()
def eval_step(state: TacotronTrainState, batch: Dict[str, Tensor], hp,
              generator: Optional[torch.Generator] = None,
              noise: Optional[Dict] = None,
              dtype: Optional[torch.dtype] = None,
              mesh: Optional[Mesh] = None) -> Dict[str, Tensor]:
    """The teacher-forced pass in the compute dtype `dtype` (None: as `train_step`
    resolves it), without zoneout or encoder and post-net dropout, over BatchNorm's
    running statistics; the prenet's dropout stays on. The coins compare
    with 0 under tacotron_natural_eval (every step reads the decoder's own frame), else
    with this step's ratio (`tacotron_trainer.py:104-124`). Returns each loss term and
    the outputs: mel_outputs, alignments, stop_token_prediction (and linear_outputs).
    With a `mesh`, `batch` is this rank's rows, `noise` (when given) the global
    batch's: the loss terms are the global batch's, the outputs this rank's rows'."""
    model = state.model
    ratio = (0.0 if hp.tacotron_natural_eval
             else schedules.teacher_forcing_ratio(hp, state.step))
    dtype = dtype or resolve_compute_dtype(hp, batch['mel_targets'].device)
    group = mesh.data_group if mesh is not None else None
    noise = _noise(model, batch, generator, True, noise, mesh)
    outputs = model.teacher_forced(batch['inputs'], batch['input_lengths'],
                                   batch['mel_targets'], noise, deterministic=True,
                                   teacher_forcing_ratio=ratio, dtype=dtype)
    _, metrics = compute_losses(outputs, batch, l2_parameters(model), hp, group)
    metrics = _global_metrics(metrics, group)
    for k in ('mel_outputs', 'alignments', 'stop_token_prediction', 'linear_outputs'):
        if k in outputs:
            metrics[k] = outputs[k]
    return metrics
