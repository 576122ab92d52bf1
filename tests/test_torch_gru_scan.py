"""The CBHG's bidirectional GRU recurrence (`ops/gru_scan.py`: `GRUScan`, its plain versions
`_gru_step_loop` and `_gru_step_loop_bwd`; the kernels, csrc/gru_loop/gru_loop.cu, run only on
the card) on the CPU at small widths: the Function against the JAX CBHG's GRU scan and its
VJP, the hand-written reverse recurrence against autograd, the bf16 loop against the port's
GRU loop as it stood, the dispatch, the parameter names, and the source's limits, pointers
and planted faults against the wrapper and the smoke run. Inputs are made with numpy from a
seed; each test states its tolerance.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tacotron2_tpu.config import default_hparams
from tacotron2_tpu.models.tacotron import modules as jmod
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.models.precision import cast_forward, sigmoid
from tacotron2_tpu_torch.models.tacotron import modules as tmod
from tacotron2_tpu_torch.ops import _build
from tacotron2_tpu_torch.ops import gru_scan as gs

from test_torch_tacotron import TINY, randomize

T_MEL = 20
LENGTH_CASES = {'B=3, ragged': [20, 13, 6], 'B=1': [20]}


def _source():
    with open(os.path.join(_build.GRU_LOOP_DIR, 'gru_loop.cu'), encoding='utf-8') as f:
        return f.read()


def _rel(a, b):
    """The largest error of a against b, relative to b's largest entry."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jax_cbhg(hp):
    return jmod.CBHG(hp.cbhg_kernels, hp.cbhg_conv_channels, hp.cbhg_pool_size,
                     (hp.cbhg_projection, hp.num_mels), hp.cbhg_projection_kernel_size,
                     hp.cbhg_highwaynet_layers, hp.cbhg_highway_units, hp.cbhg_rnn_units)


@pytest.mark.parametrize('case', list(LENGTH_CASES))
def test_gru_scan_matches_jax_cbhg_gru(case):
    """Both directions through `BiGRU` (GRUScan on its plain versions) on the JAX CBHG's own
    GRU input (its last highway's output), the JAX CBHG's parameters carried across by
    convert.py: the output within 1e-6 of the JAX output's largest entry (padding zero);
    the gradients of a seeded projection of the output, through jax.vjp of the JAX CBHG,
    for each GRU's input kernel and bias (dip), hidden kernels (dW_hh) and b_hn, within
    1e-5 of each gradient's largest entry (read 1.6e-7 and 2.3e-7: f32 sums in another
    order)."""
    hp = default_hparams()
    hp.parse(TINY)
    lengths = np.asarray(LENGTH_CASES[case], np.int32)
    B = len(lengths)
    rng = np.random.default_rng(19)
    x = rng.normal(size=(B, T_MEL, hp.num_mels)).astype(np.float32)
    jc = _jax_cbhg(hp)
    v = randomize(jax.eval_shape(lambda: jc.init(jax.random.PRNGKey(0), x, lengths)), rng)
    out, inter = jc.apply(v, x, lengths, capture_intermediates=True, mutable=['intermediates'])
    y = np.array(inter['intermediates'][f'highway_{hp.cbhg_highwaynet_layers}']['__call__'][0])
    cot = rng.normal(size=out.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jc.apply({**v, 'params': p}, x, lengths), v['params'])
    jgrads = vjp(jnp.asarray(cot))[0]

    cbhg = tmod.CBHG(hp.num_mels, hp.cbhg_kernels, hp.cbhg_conv_channels, hp.cbhg_pool_size,
                     (hp.cbhg_projection, hp.num_mels), hp.cbhg_projection_kernel_size,
                     hp.cbhg_highwaynet_layers, hp.cbhg_highway_units, hp.cbhg_rnn_units)
    cbhg.load_state_dict(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    lt = torch.from_numpy(lengths).long()
    mask = tmod.length_mask(lt, T_MEL, 'cpu')
    got = cbhg.bigru(torch.from_numpy(y), mask, lt)
    assert _rel(got.detach().numpy(), out) <= 1e-6
    for b, n in enumerate(lengths):
        assert not got[b, n:].any()
    (got * torch.from_numpy(cot)).sum().backward()
    for name in ('gru_fw', 'gru_bw'):
        gru, j = getattr(cbhg, name), jgrads[name]
        want = {'input.weight': np.concatenate([j[g]['kernel'] for g in ('ir', 'iz', 'in')], 1).T,
                'input.bias': np.concatenate([j[g]['bias'] for g in ('ir', 'iz', 'in')]),
                'hidden.weight': np.concatenate([j[g]['kernel'] for g in ('hr', 'hz', 'hn')],
                                                1).T,
                'bias_hn': j['hn']['bias']}
        params = dict(gru.named_parameters())
        for k, w in want.items():
            assert _rel(params[k].grad.numpy(), w) <= 1e-5, (name, k)


def _operands(rng, B, T, H, C, dtype):
    """ip (B, T, 3H) from a seeded input through a Linear, W_hh (3H, H), b_hn, a ragged
    mask and its lengths, in `dtype`."""
    lin = torch.nn.Linear(C, 3 * H)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(rng.normal(0, C ** -0.5, (3 * H, C))))
        lin.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, 3 * H)))
    y = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32))
    ip = cast_forward(lin, y.to(dtype), dtype)
    w = torch.from_numpy(rng.normal(0, H ** -0.5, (3 * H, H)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(0, 0.3, H).astype(np.float32)).to(dtype)
    lengths = torch.from_numpy(np.asarray([T] + [max(1, T - 4 * i) for i in range(1, B)]))
    return ip, w, b, tmod.length_mask(lengths, T, 'cpu'), lengths


def _pre_loop(ip, Kh, bias_hn, mask):
    """The port's GRU loop before it went through ops/gru_scan (`GRU.forward`'s body on
    the operands its casts made), kept here to hold `_gru_step_loop` to it bit for bit."""
    B, T, _ = ip.shape
    H = Kh.shape[0]
    mask = mask.to(Kh.dtype)
    h = torch.zeros(B, H, dtype=Kh.dtype)
    outs = []
    for t in range(T):
        ip_t, hh = ip[:, t], h @ Kh
        r = sigmoid(ip_t[:, :H] + hh[:, :H])
        z = sigmoid(ip_t[:, H:2 * H] + hh[:, H:2 * H])
        n = torch.tanh(ip_t[:, 2 * H:] + r * (hh[:, 2 * H:] + bias_hn))
        new_h = (1.0 - z) * n + z * h
        m = mask[:, t, None]
        h = torch.where(m > 0, new_h, h)
        outs.append(h * m)
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_step_loop_is_the_loop_it_replaced(dtype):
    """`_gru_step_loop` bit for bit the port's GRU loop as it stood (ragged mask, B=3), in
    bf16 and f32, and the CBHG's BiGRU bit for bit that loop run forward and, on each row's
    reversed sequence (reverse_sequences before and after), backward; one GRU's forward
    bit for bit its direction."""
    rng = np.random.default_rng(20)
    B, T, H, C = 3, 18, 24, 16
    ip, w, b, mask, lengths = _operands(rng, B, T, H, C, dtype)
    got, _ = gs._gru_step_loop(ip, w, b, mask)
    assert got.dtype == dtype and torch.equal(got, _pre_loop(ip, w.t(), b, mask))

    fw, bw = tmod.GRU(C, H), tmod.GRU(C, H)
    for g in (fw, bw):
        with torch.no_grad():
            g.bias_hn.copy_(torch.from_numpy(rng.normal(0, 0.3, H)))
    y = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32)).to(dtype)
    with torch.no_grad():
        got = tmod.BiGRU(fw, bw)(y, mask, lengths, dtype)
        one = fw(y, mask, dtype)
        want = []
        for g, seq in ((fw, y), (bw, tmod.reverse_sequences(y, lengths))):
            o = _pre_loop(cast_forward(g.input, seq, dtype), g.hidden.weight.t().to(dtype),
                          g.bias_hn.to(dtype), mask)
            want.append(o if g is fw else tmod.reverse_sequences(o, lengths))
    assert torch.equal(got, torch.cat(want, dim=-1)) and torch.equal(one, want[0])


def test_step_loop_bwd_matches_autograd():
    """`_gru_step_loop_bwd` on `_gru_step_loop`'s residuals against autograd through
    `_gru_step_loop` (f32, ragged mask, a seeded cotangent): dip, and dW_hh = dg^T hp and
    db_hn as GRUScan forms them, within 1e-6 of each autograd gradient's largest entry
    (read up to 3.3e-7: the same terms, summed in another order)."""
    rng = np.random.default_rng(21)
    ip, w, b, mask, _ = _operands(rng, 3, 16, 20, 12, torch.float32)
    ip, w, b = (t.detach().requires_grad_() for t in (ip, w, b))
    out, res = gs._gru_step_loop(ip, w, b, mask, save=True)
    cot = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    want = torch.autograd.grad((out * cot).sum(), (ip, w, b))
    dip, dg = gs._gru_step_loop_bwd(cot, res.detach(), w.detach(), mask)
    got = (dip, *gs.weight_grads(dg, res.detach()))
    for g, a in zip(got, want):
        assert _rel(g.numpy(), a.numpy()) <= 1e-6


def test_function_matches_autograd_both_directions():
    """GRUScan of both directions (the second reversed within ragged lengths, B=3) against
    autograd through the plain forward: the output bit for bit, every gradient within
    1e-6 of its largest entry (f32; read 3.3e-7)."""
    rng = np.random.default_rng(22)
    B, T, H, C = 3, 14, 16, 12
    ops = [_operands(rng, B, T, H, C, torch.float32) for _ in range(2)]
    mask, lengths = ops[0][3], ops[0][4]
    leaves = [t.detach().requires_grad_() for o in ops for t in o[:3]]
    ips, ws, bs = leaves[0::3], leaves[1::3], leaves[2::3]
    got = gs.gru_scan(ips, ws, bs, mask, lengths, (False, True))
    want, _ = gs._gru_fwd_loop_plain(ips, ws, bs, mask, lengths, (False, True), False)
    assert torch.equal(got, want)
    cot = torch.from_numpy(rng.normal(size=got.shape).astype(np.float32))
    g1 = torch.autograd.grad((got * cot).sum(), leaves)
    g2 = torch.autograd.grad((want * cot).sum(), leaves)
    for a, b in zip(g1, g2):
        assert _rel(a.numpy(), b.numpy()) <= 1e-6


def test_no_grad_forward_saves_nothing(monkeypatch):
    """Without a gradient to take, gru_scan runs the forward alone without residuals; with
    one, through GRUScan with them. On CPU tensors both run the plain version."""
    rng = np.random.default_rng(23)
    ip, w, b, mask, _ = _operands(rng, 2, 8, 8, 8, torch.float32)
    saves = []
    plain = gs._gru_fwd_loop_plain

    def counted(*a):
        saves.append(a[-1])
        return plain(*a)
    monkeypatch.setattr(gs, '_gru_fwd_loop_plain', counted)
    with torch.no_grad():
        gs.gru_scan([ip], [w.requires_grad_()], [b], mask, None, (False,))
    gs.gru_scan([ip], [w], [b], mask, None, (False,))
    assert saves == [False, True]


def test_gru_loop_applies():
    """The kernels take the default cbhg_rnn_units (128) in f32 and bf16 on the card only;
    a wider or narrower H, another dtype or the CPU take the plain versions."""
    H = default_hparams().cbhg_rnn_units
    assert H == gs.GRU_LOOP_UNITS == 128
    for dt in (torch.float32, torch.bfloat16):
        assert gs.gru_loop_applies(H, dt, 'cuda')
        assert not gs.gru_loop_applies(H, dt, 'cpu')
        assert not gs.gru_loop_applies(256, dt, 'cuda')
        assert not gs.gru_loop_applies(16, dt, 'cuda')
    assert not gs.gru_loop_applies(H, torch.float16, 'cuda')


def test_wrapper_refuses_what_the_build_does_not_take():
    """The launch's checks name the numbers: another width, a third direction, a reversed
    direction without lengths."""
    H = gs.GRU_LOOP_UNITS
    w, mask = torch.zeros(3 * H, H), torch.ones(2, 5)
    with pytest.raises(ValueError, match=r'\(384, 128\)'):
        gs._prepared(2, 5, torch.float32, w.device, [torch.zeros(3 * 64, 64)], mask, None,
                     (False,))
    with pytest.raises(ValueError, match='3 directions'):
        gs._prepared(2, 5, torch.float32, w.device, [w] * 3, mask, None, (False,) * 3)
    with pytest.raises(ValueError, match='lengths'):
        gs._prepared(2, 5, torch.float32, w.device, [w], mask, None, (True,))
    ws, m, lengths, ints = gs._prepared(2, 5, torch.bfloat16, w.device, [w.bfloat16()] * 2,
                                        mask, torch.tensor([5, 3]), (False, True))
    assert ints == (2, 5, 2, 0, 1, 1) and lengths.dtype == torch.int32 and m.dtype == torch.float32


def test_parameter_names_are_unchanged():
    """The CBHG's GRU parameters keep their names (a checkpoint of the port before the
    GRU went through BiGRU loads): BiGRU registers nothing."""
    hp = default_hparams()
    hp.parse(TINY)
    cbhg = tmod.CBHG(hp.num_mels, hp.cbhg_kernels, hp.cbhg_conv_channels, hp.cbhg_pool_size,
                     (hp.cbhg_projection, hp.num_mels), hp.cbhg_projection_kernel_size,
                     hp.cbhg_highwaynet_layers, hp.cbhg_highway_units, hp.cbhg_rnn_units)
    keys = [k for k in cbhg.state_dict() if 'gru' in k]
    assert keys == [f'gru_{d}.{p}' for d in ('fw', 'bw')
                    for p in ('bias_hn', 'input.weight', 'input.bias', 'hidden.weight')]
    assert not list(cbhg.bigru.parameters(recurse=False)) and not list(cbhg.bigru.children())


def test_limits_and_pointers_follow_the_source():
    """The wrapper's width, directions, residual planes, entry names and pointer names, in
    order, are the source's."""
    source = _source()

    def const(name):
        return int(re.search(rf'\bconstexpr int {name} = (\d+)', source).group(1))

    def enum(name):
        body = source[source.index(f'enum {name} {{') + len(f'enum {name} {{'):]
        return [n.strip() for n in body[:body.index('}')].replace('\n', ' ').split(',')]
    assert const('H') == gs.GRU_LOOP_UNITS and const('MAX_DIRS') == gs.GRU_LOOP_MAX_DIRS
    assert enum('FwdPtr') == ['FWD_' + n.upper() for n in gs._FWD_PTRS] + ['N_FWD_PTRS']
    assert enum('BwdPtr') == ['BWD_' + n.upper() for n in gs._BWD_PTRS] + ['N_BWD_PTRS']
    assert enum('Res') == ['R_' + n.upper() for n in gs.RESIDUALS] + ['N_RES']
    assert [m for m in re.findall(r'extern "C" int t2_(\w+)\(', source)] == list(gs.KERNELS)


@pytest.mark.parametrize('fault', list(chip_smoke.GRU_MUTANTS))
def test_gru_mutants_apply_to_the_source(fault):
    """Each planted fault of the smoke run (GRU_MUTANTS, built on the card with its macro
    set) names a macro that guards code in csrc/gru_loop/gru_loop.cu and is listed in its
    note."""
    macro = chip_smoke.GRU_MUTANTS[fault]
    source = _source()
    assert re.search(rf'^#if(n?def)? {macro}$', source, re.M), macro
    assert source.count(macro) >= 2
