"""The fused decoder's float32 forward recurrence as one launch (`ops/decoder_vjp.py`:
`decoder_fwd_loop` at float32, its plain version `_decoder_fwd_loop_plain` on the conv
location tier, the dispatch `loop_applies`; the kernel,
csrc/decoder_loop_f32/decoder_loop_f32.cu, runs only on the card) on the CPU: the wrapper's
CPU route against the JAX fused decoder's `decoder_scan` forward at the TINY widths of
test_torch_tacotron_train.py (and at an input length past JAX's float32 fold, where it
runs the conv), the Function's gradients through the loop's residuals against JAX's VJP,
the dispatch case by case at the default widths, the GTA synthesizer's call, and the smoke
run's planted faults, the wrapper's pointers and its limits against the source. Inputs
are made with numpy from a seed.
"""

import collections
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tacotron2_tpu.ops import fused_decoder as jfd
from tacotron2_tpu_torch.config import default_hparams
from tacotron2_tpu_torch.inference.tacotron_synthesizer import Synthesizer
from tacotron2_tpu_torch.models.tacotron.model import DecoderCell, Tacotron
from tacotron2_tpu_torch.ops import _build
from tacotron2_tpu_torch.ops import decoder_vjp as dv

from test_torch_fused_decoder import _inputs, _jax_run, _pair, _port_run, _within
from test_torch_tacotron_train import B, T_IN, _max_abs, _np, _t

F32 = np.float32
# past JAX's float32 budget for its banded location matrices at the TINY widths (D=16,
# F=8: T_in * T_in * F * 4 bytes above LOC_MAT_BYTES from 513 input steps on), so that the
# JAX side runs the conv, as the port's float32 loop does
T_IN_CONV = 528


def _source():
    with open(os.path.join(_build.DECODER_LOOP_F32_DIR, 'decoder_loop_f32.cu'),
              encoding='utf-8') as f:
        return f.read()


def _counted(monkeypatch, *names):
    """Count the calls of each of dv's functions `names`, which still run."""
    calls = collections.Counter()
    for name in names:
        def counted(*a, fn=getattr(dv, name), name=name, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(dv, name, counted)
    return calls


def _inputs_at(hp, t_in, gates, mask=True, seed=7):
    """`_inputs` of test_torch_fused_decoder.py over `t_in` input steps: new keys, values
    and alignment cotangents, and a ragged mask (every step of row 0, two thirds of row
    1's) or none."""
    d = _inputs(hp, 1.0, gates, seed)
    rng = np.random.default_rng(seed + t_in)
    T = d['teacher'].shape[0]
    d['keys'] = rng.normal(size=(B, t_in, hp.attention_dim)).astype(F32)
    d['values'] = rng.normal(size=(B, t_in, 2 * hp.encoder_lstm_units)).astype(F32)
    lengths = np.asarray([t_in, 2 * t_in // 3])
    d['mask'] = (np.arange(t_in)[None] < lengths[:, None]).astype(F32) if mask else None
    d['cot'][2] = rng.normal(size=(T, B, t_in)).astype(F32)
    return d


# (an extra hparam, keep-gates, input steps, a mask)
FORWARD_CASES = {'gates': ('', True, T_IN, True),
                 'expectation': ('', False, T_IN, True),
                 'no-cumulate': (',cumulative_weights=False', True, T_IN, True),
                 'smoothing': (',smoothing=True', True, T_IN, True),
                 'no-mask': ('', True, T_IN, False),
                 'T_in528-conv': ('', True, T_IN_CONV, True)}


@pytest.mark.parametrize('case', list(FORWARD_CASES))
def test_f32_loop_matches_jax_decoder_scan(case, monkeypatch):
    """`fused_decoder_scan` at float32 without a gradient, the dispatch held to the forward
    loop (on CPU tensors `decoder_fwd_loop` runs its plain version), against the JAX
    custom VJP `decoder_scan`'s forward over 8 teacher-forced steps with prenet masks:
    the frames, stops and alignments within 1e-5 (the bound of
    test_fused_decoder_scan_matches_jax); with keep-gates and with zoneout's expectation,
    without cumulative weights, with smoothing, with a ragged mask and without one, and at
    528 input steps, where the JAX side leaves its banded location matrices for the conv."""
    extra, gates, t_in, mask = FORWARD_CASES[case]
    hp, v, model = _pair(extra)
    d = _inputs_at(hp, t_in, gates, mask)
    monkeypatch.setattr(dv, 'loop_applies', lambda *a: True)
    calls = _counted(monkeypatch, 'decoder_fwd_loop', '_step_loop')
    with torch.no_grad():
        got = dv.fused_decoder_scan(
            model.decoder, _t(d['keys']), _t(d['values']),
            None if d['mask'] is None else _t(d['mask']), _t(d['teacher']), _t(d['use']),
            [_t(d['m1']), _t(d['m2'])], None if d['zo'] is None else [_t(z) for z in d['zo']],
            torch.float32)
    assert calls == {'decoder_fwd_loop': 1}
    cfg = jfd.config_from_hp(hp, jnp.float32, d['zo'] is None)
    want = jax.jit(jfd.decoder_scan, static_argnums=0)(
        cfg, v['params']['decoder'], d['keys'], d['values'], d['mask'], d['teacher'], d['use'],
        d['m1'], d['m2'], d['zo'])
    for w, g in zip(want, got, strict=True):
        assert g.dtype == torch.float32 and _max_abs(np.asarray(w), _np(g)) <= 1e-5


GRAD_CASES = {'gates': ('', True), 'expectation': ('', False), 'smoothing': (',smoothing=True', True)}


@pytest.mark.parametrize('case', list(GRAD_CASES))
def test_f32_loop_gradients_match_jax(case, monkeypatch):
    """`FusedDecoderScan` at float32 with its forward through the loop and its backward
    through the step loop `_step_loop_bwd` on the loop's residuals (the dispatch held to
    the loop where the forward asks and to the step loop where the backward does; both
    loops: test_torch_decoder_bwd_loop_f32.py), against the JAX custom VJP
    `decoder_scan` over 8 teacher-forced steps with a ragged mask: the outputs within 1e-5
    and the gradient of a projection of them with respect to every decoder weight, the
    keys, the values and the teacher frames within 2e-5 of each one's largest entry (the
    bound of test_fused_decoder_scan_matches_jax); with keep-gates, with zoneout's
    expectation, with smoothing."""
    extra, gates = GRAD_CASES[case]
    hp, v, model = _pair(extra)
    d = _inputs(hp, 1.0, gates)
    answers = iter((True, False))  # the forward asks first, the backward second
    monkeypatch.setattr(dv, 'loop_applies', lambda *a: next(answers))
    calls = _counted(monkeypatch, 'decoder_fwd_loop', 'decoder_bwd_loop', '_step_loop',
                     '_step_loop_bwd')
    got = _port_run(model, d)
    assert calls == {'decoder_fwd_loop': 1, '_step_loop_bwd': 1}
    _within(_jax_run(hp, v, d, jfd.decoder_scan), got)


# the dispatch at the default widths: (compute dtype, B, T_in, every second step on its
# own frame) -> (whether the forward loop runs, whether the reverse loop runs)
DISPATCH = {'f32-B1-T_in100': ('float32', 1, 100, False, (True, True)),
            'f32-B32-T_in100': ('float32', 32, 100, False, (True, True)),
            'f32-B1-T_in200': ('float32', 1, 200, False, (True, True)),
            'f32-B32-T_in200': ('float32', 32, 200, False, (True, True)),
            'f32-T_in256': ('float32', 32, 256, False, (True, True)),
            'f32-T_in257': ('float32', 32, 257, False, (False, False)),
            'f32-ratio0.5': ('float32', 32, 100, True, (False, False)),
            'f32-B33': ('float32', 33, 100, False, (False, False)),
            'bf16-B32-T_in100': ('bfloat16', 32, 100, False, (True, True)),
            'bf16-B32-T_in200': ('bfloat16', 32, 200, False, (False, False))}


@pytest.fixture(scope='module')
def cell():
    """The decoder cell at the default widths, seeded."""
    hp = default_hparams()
    torch.manual_seed(0)
    return hp, DecoderCell(hp, 2 * hp.encoder_lstm_units)


@pytest.mark.parametrize('case', list(DISPATCH))
def test_f32_dispatch(case, cell):
    """`loop_applies` case by case at LOOP_WIDTHS, for both loops: float32 with
    every step on its teacher frame takes both loops (the float32 ones) at B = 1 and 32 and
    up to LOOP_F32_MAX_T_IN (256) input steps, past the bf16 fold's 181; float32 at teacher
    forcing 0.5, past 256 input steps or at B=33 takes neither; bf16 takes both on the
    folded tier (T_in=100) and neither off it (T_in=200)."""
    dtype, b, t_in, own_frames, (fwd, bwd) = DISPATCH[case]
    hp, c = cell
    dt = getattr(torch, dtype)
    cfg = dv._config(c, dt)
    W = dv._weights(cfg, c, [c.get_parameter(n) for _, n in dv.PARAMS], b, t_in)
    keys = torch.zeros(b, t_in, hp.attention_dim, dtype=dt)
    values = torch.zeros(b, t_in, 2 * hp.encoder_lstm_units)
    use = torch.ones(8)
    if own_frames:
        use[1::2] = 0
    assert fwd is bwd and dv.loop_applies(cfg, W, keys, values, use) is fwd


def test_gta_synthesizer_runs_the_f32_loop(tmp_path, monkeypatch):
    """GTA (`Synthesizer.synthesize_batch` with gta, the model at float32 and the default
    hparams: batch 1, 31 location taps of 32 filters) runs its decoder through
    `decoder_fwd_loop` at float32, once a batch, and not through the step loop; the mel
    it writes has the target's frames, finite."""
    hp = default_hparams()
    torch.manual_seed(0)
    model = Tacotron(hp)
    rng = np.random.default_rng(3)
    mel = rng.uniform(-4, 4, (20, hp.num_mels)).astype(F32)
    np.save(tmp_path / 'mel-0.npy', mel)
    seen = []
    real = dv.decoder_fwd_loop

    def spy(cfg, W, keys, values, mask, p2, gates, save, **k):
        seen.append((cfg.dtype, tuple(p2.shape), save))
        return real(cfg, W, keys, values, mask, p2, gates, save, **k)
    monkeypatch.setattr(dv, 'decoder_fwd_loop', spy)
    calls = _counted(monkeypatch, '_step_loop')
    synth = Synthesizer(model, hp, 'cpu', gta=True)
    out = synth.synthesize_batch(['Printing, in the only sense.'], ['0'], str(tmp_path), None,
                                 [str(tmp_path / 'mel-0.npy')], torch.Generator())
    T = -(-64 // hp.outputs_per_step)  # the targets padded to pad_mel_multiple frames
    assert seen == [(torch.float32, (T, 1, hp.prenet_layers[-1]), False)] and not calls
    got = np.load(out[0])
    assert got.shape == mel.shape and np.isfinite(got).all()


def test_f32_loop_pointers_follow_the_source():
    """The wrapper's pointer names, in order, are the C entry's `Ptr` enum."""
    source = _source()
    enum = source[source.index('enum Ptr {') + len('enum Ptr {'):source.index('N_PTRS')]
    names = [n.strip() for n in enum.replace('\n', ' ').split(',') if n.strip()]
    py = (dv._F32_INPUTS + dv._LOOP_OUTPUTS + dv._LOOP_RESIDUALS + dv._LOOP_SCRATCH
          + dv._LOOP_PROFILE)
    assert names == ['P_' + n.upper() for n in py]


def test_f32_loop_limits_follow_the_source():
    """The limits the wrapper and the dispatch check are those the kernel is built for:
    the widths, the location filters, the widest location kernel, the batch and the input
    steps (at least 256: a corpus's longest line, about 190 characters, padded to 16)."""
    source = _source()

    def const(name):
        return int(re.search(rf'\b{name} = (\d+)', source).group(1))
    assert tuple(const(n) for n in ('U', 'P', 'E', 'D')) == dv.LOOP_WIDTHS
    assert const('F') == dv.LOOP_FILTERS and const('MAX_K') == dv.LOOP_MAX_KERNEL
    assert const('MAX_B') == dv.LOOP_MAX_BATCH
    assert const('MAX_T_IN') == dv.LOOP_F32_MAX_T_IN >= 256


@pytest.mark.parametrize('fault', list(chip_smoke.F32_LOOP_MUTANTS))
def test_f32_loop_mutants_apply_to_the_source(fault):
    """Each planted fault of the float32 forward loop (the smoke run's F32_LOOP_MUTANTS,
    built on the card) changes exactly one place of
    csrc/decoder_loop_f32/decoder_loop_f32.cu."""
    source = _source()
    old, new = chip_smoke.F32_LOOP_MUTANTS[fault]
    text = chip_smoke.mutated_loop_f32_source(fault)
    assert source.count(old) == 1 and text != source and text == source.replace(old, new)
