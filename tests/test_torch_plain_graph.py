"""The plain AR version's step index on the device (`generate_ar_reference`): the Philox
noise of a step given as a tensor, and the step replayed as a CUDA graph.

The plain version reads each step's inputs, ring slots and noise from a step index held
in a tensor, so that one step captured in a CUDA graph serves every step after it. On
the CPU it runs eagerly, and the JAX-parity tests of the AR path hold it there; here the
noise of a tensor step against an int step (exact), the refusal of a graph off the card,
and, on the card, the graph against the eager run bit for bit across chunks of a
state-carried stream.
"""

import pytest
import torch

from tacotron2_tpu_torch.config import default_hparams
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.ops import wavenet_ar
from tacotron2_tpu_torch.utils import randomize_weights

# test_torch_wavenet.py's tiny WaveNet (not imported from there: it imports JAX, which
# the card's machine lacks)
TINY = ("layers=4,stacks=2,residual_channels=8,gate_channels=16,skip_out_channels=8,"
        "upsample_scales=[4,8],hop_size=32,win_size=128,n_fft=256,num_freq=129,"
        "cin_channels=80")
HEADS = {'gaussian-fused': '', 'gaussian-plain': ',wavenet_fused_ar=False',
         'categorical': ",input_type='mulaw-quantize',quantize_channels=256,out_channels=256",
         'big-vocab': ",input_type='mulaw-quantize',quantize_channels=2048,out_channels=2048"}


@pytest.mark.parametrize('t_abs', [0, 7, 2 ** 32 - 1, 2 ** 32 + 5, 2 ** 61 + 12345])
def test_philox_of_a_step_tensor_equals_that_of_the_int(t_abs):
    """philox_gumbel of an int64 tensor step: the very noise of the int step, both
    32-bit words of the step counted."""
    want = wavenet_ar.philox_gumbel(99, 3, t_abs, 1030, 'cpu')
    got = wavenet_ar.philox_gumbel(99, 3, torch.tensor(t_abs), 1030, 'cpu')
    assert torch.equal(got, want)


def _inputs(extra, B, frames, device, seed=0):
    hp = default_hparams()
    hp.parse(TINY + extra)
    model = randomize_weights(WaveNet(hp), torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    gen = torch.Generator(device).manual_seed(seed + 1)
    mel = torch.rand(B, frames, hp.num_mels, generator=gen, device=device)
    with torch.no_grad():
        c_up = model.upsample_conditioning(mel).contiguous()
    noise = wavenet_ar.make_noise(hp, gen, B, c_up.shape[1], device)
    return hp, wavenet_ar.pack_params(model, hp), c_up, noise


def test_graph_off_the_card_is_refused():
    hp, weights, c_up, noise = _inputs('', 2, 2, 'cpu')
    with pytest.raises(ValueError, match='CUDA graph'):
        wavenet_ar.generate_ar_reference(weights, c_up, noise, hp, graph=True)


def _chunked(hp, weights, c_up, noise, targets, graph, cut, **kw):
    """The plain version teacher-forced in two state-carried chunks split at `cut`."""
    a, second, state = wavenet_ar.generate_ar_reference(
        weights, c_up[:, :cut].contiguous(), noise[:, :cut].contiguous(), hp,
        targets=targets[:, :cut], return_state=True, graph=graph,
        **{k: v[:, :cut].contiguous() if k == 'y_eval' else v for k, v in kw.items()})
    state = (state[0].clone(), state[1].clone(), state[2])
    a2, second2, state2 = wavenet_ar.generate_ar_reference(
        weights, c_up[:, cut:].contiguous(), noise[:, cut:].contiguous(), hp,
        targets=targets[:, cut:], state_in=state, return_state=True, graph=graph,
        **{k: v[:, cut:].contiguous() if k == 'y_eval' else v for k, v in kw.items()})
    return torch.cat([a, a2], 1), torch.cat([second, second2], 1), state2


@pytest.mark.cuda
@pytest.mark.parametrize('head', list(HEADS))
def test_graph_replays_the_eager_steps_bit_for_bit(head):
    """On the card: the plain version with its step captured in a CUDA graph and
    replayed gives the eager run's audio, params (the big-vocab head: its NLL and the
    ids it draws) and carried state bit for bit, over two chunks at an odd cut."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    hp, weights, c_up, noise = _inputs(HEADS[head], 2, 8, 'cuda')
    T = c_up.shape[1]
    gen = torch.Generator('cuda').manual_seed(3)
    kw = {}
    if wavenet_ar.is_big_vocab(hp):
        kw = dict(seed=77, return_params=False, return_drawn=True,
                  y_eval=torch.randint(0, hp.out_channels, (2, T), device='cuda',
                                       generator=gen))
        targets = torch.randint(0, hp.out_channels, (2, T), device='cuda', generator=gen)
    else:
        targets, _ = wavenet_ar.generate_ar_reference(weights, c_up, noise, hp,
                                                      return_params=False, graph=False)
    eager = _chunked(hp, weights, c_up, noise, targets, False, T // 2 + 1, **kw)
    graphed = _chunked(hp, weights, c_up, noise, targets, True, T // 2 + 1, **kw)
    assert torch.equal(eager[0], graphed[0]) and torch.equal(eager[1], graphed[1])
    assert torch.equal(eager[2][0], graphed[2][0]) and torch.equal(eager[2][1], graphed[2][1])
    assert eager[2][2] == graphed[2][2] == T


@pytest.mark.cuda
def test_graphs_hold_no_memory_between_calls():
    """On the card: a second and a third graphed call leave the device's allocated
    memory where the first left it (every capture runs on one side stream a device, and
    a stream keeps a cuBLAS workspace for the rest of the process)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    hp, weights, c_up, noise = _inputs('', 2, 4, 'cuda')
    held = []
    for _ in range(3):
        wavenet_ar.generate_ar_reference(weights, c_up, noise, hp, graph=True)
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert held[1] == held[0] and held[2] == held[0], held
