"""The port on a CUDA card: the hand-written AR kernel against its plain PyTorch
version, its input checks, and the slice end to end. Marked `cuda`; each test skips
without a card. On the card: `python -m pytest tests/test_torch_cuda.py -m cuda -q`.
"""

import http.client

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import (CATEGORICAL, FIRST_STEPS_TOL, KERNEL_MUTANTS, KERNEL_TOL,
                        MOL_KERNEL_TOL, MOL_NO_FAULT, SAMPLE_TOL, SPEAKERS, first_steps_err,
                        mol_fault_errors, mol_planted_faults, params_err, planted_faults,
                        speaker_rows, state_carry, vocoder_model)
from tacotron2_tpu.config import default_hparams
from tacotron2_tpu_torch.config import paper_hparams
from tacotron2_tpu_torch import convert, serve, synthesize
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.ops import wavenet_ar
from tacotron2_tpu_torch.utils import randomize_weights, suppress_stop_tokens

pytestmark = pytest.mark.cuda

TINY = ("embedding_dim=32,enc_conv_channels=32,enc_conv_num_layers=1,encoder_lstm_units=16,"
        "attention_dim=16,attention_filters=8,attention_kernel=[7],prenet_layers=[16,16],"
        "decoder_lstm_units=32,postnet_channels=32,postnet_num_layers=2,outputs_per_step=2,"
        "layers=4,stacks=2,residual_channels=8,gate_channels=16,skip_out_channels=8,"
        "upsample_scales=[4,8],hop_size=32,win_size=128,n_fft=256,num_freq=129,"
        "max_iters=8,tacotron_synthesis_batch_size=2")
# the paper profile (MoL-30, 2D upsampler, no legacy scalings) at tiny widths
PAPER_TINY = "layers=8,stacks=4,residual_channels=8,gate_channels=16,skip_out_channels=8"


def paper_hp():
    hp = paper_hparams()
    hp.parse(PAPER_TINY)
    return hp


@pytest.fixture()
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _wavenet_inputs(hp, B, frames, device, seed=0):
    """Packed weights of a WaveNet with seeded random weights of order 1, c_up through
    its upsampler, and noise."""
    model = randomize_weights(WaveNet(hp), torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    gen = torch.Generator(device).manual_seed(seed + 1)
    mel = torch.rand(B, frames, hp.num_mels, generator=gen, device=device)
    with torch.no_grad():
        c_up = model.upsample_conditioning(mel).contiguous()
    noise = wavenet_ar.make_noise(hp, gen, B, c_up.shape[1], device)
    return wavenet_ar.pack_params(model, hp), c_up, noise


@pytest.mark.parametrize('config,B,frames', [(TINY, 3, 8), ('', 2, 1), (TINY, 17, 8)],
                         ids=['tiny', 'default', 'tiny-b17'])
def test_kernel_matches_plain_version(device, config, B, frames):
    """Free-running kernel vs the plain version teacher-forced on its audio: per-step
    params within KERNEL_TOL (chip_smoke.py's bound), samples drawn from those params
    and the shared noise. At B=17 the conditioning row stays f32, as in the TPU
    kernel past its 16-row bf16 slab."""
    hp = default_hparams()
    hp.parse(config)
    weights, c_up, noise = _wavenet_inputs(hp, B, frames, device)
    before = wavenet_ar.LAUNCHES
    audio, params = wavenet_ar.generate_ar(weights, c_up, noise, hp)
    torch.cuda.synchronize()
    assert wavenet_ar.LAUNCHES == before + 1
    _, ref = wavenet_ar.generate_ar_reference(weights, c_up, noise, hp, targets=audio)
    assert (params - ref).abs().max().item() <= KERNEL_TOL
    logs = torch.clamp(params[..., 1], min=hp.log_scale_min_gauss)
    drawn = torch.clamp(params[..., 0] + torch.exp(logs) * noise, -1, 1)
    assert (drawn - audio).abs().max().item() <= 1e-5
    assert torch.isfinite(audio).all() and audio.abs().max() <= 1.0
    again, none = wavenet_ar.generate_ar(weights, c_up, noise, hp, return_params=False)
    assert none is None and torch.equal(again, audio)


@pytest.mark.parametrize('fault', list(planted_faults(default_hparams())))
def test_kernel_check_catches_planted_faults(device, fault):
    """Packed weights as a kernel with one bug would read them take the kernel's params
    beyond KERNEL_TOL of the plain version's on the true weights."""
    hp = default_hparams()
    hp.parse(TINY)
    weights, c_up, noise = _wavenet_inputs(hp, 3, 8, device)
    name, plant = planted_faults(hp)[fault]
    audio, params = wavenet_ar.generate_ar({**weights, name: plant(weights[name])},
                                           c_up, noise, hp)
    _, ref = wavenet_ar.generate_ar_reference(weights, c_up, noise, hp, targets=audio)
    assert (params - ref).abs().max().item() > KERNEL_TOL


def test_state_carry_on_the_card(device):
    """Three state-carried kernel chunks (boundaries 97 and 197: not multiples of the
    tiny config's 2- and 4-slot rings) are bit-identical to one fresh call, within
    KERNEL_TOL of the plain version run in the same chunks (params, and the state
    after chunk 1), and both planted state faults miss it by more than KERNEL_TOL."""
    hp = default_hparams()
    hp.parse(TINY)
    weights, c_up, noise = _wavenet_inputs(hp, 3, 8, device)
    before = wavenet_ar.LAUNCHES
    r = state_carry(weights, c_up, noise, hp, (97, 197, 256))
    assert wavenet_ar.LAUNCHES == before + 1 + 3 + 2
    assert r['bit_identical']
    assert r['max_abs_err'] <= KERNEL_TOL and r['state_err'] <= KERNEL_TOL
    assert r['t_base'] == (97, 97)
    assert all(e > KERNEL_TOL for e in r['faults'].values()), r['faults']


def test_kernel_rejects_what_it_does_not_take(device):
    hp = default_hparams()
    hp.parse(TINY)
    weights, c_up, noise = _wavenet_inputs(hp, 2, 2, device)
    before = wavenet_ar.LAUNCHES
    with pytest.raises(ValueError):  # not contiguous
        wavenet_ar.generate_ar(weights, c_up.transpose(0, 1).contiguous().transpose(0, 1),
                               noise, hp)
    with pytest.raises(TypeError):
        wavenet_ar.generate_ar(weights, c_up.double(), noise, hp)
    with pytest.raises(ValueError):  # weights left on the CPU
        wavenet_ar.generate_ar({k: v.cpu() for k, v in weights.items()}, c_up, noise, hp)
    with pytest.raises(NotImplementedError):  # more classes than the kernel takes
        wavenet_ar.generate_ar(weights, c_up, noise, hp.replace(
            input_type='mulaw-quantize', quantize_channels=2048, out_channels=2048))
    with pytest.raises(ValueError):  # g_cond of another batch
        wavenet_ar.generate_ar(weights, c_up, noise, hp,
                               g_cond=torch.zeros(3, hp.layers * hp.gate_channels,
                                                  device=device))
    with pytest.raises(ValueError):  # MoL noise for a Gaussian head
        wavenet_ar.generate_ar(weights, c_up, noise[..., None].expand(-1, -1, 11).contiguous(),
                               hp)
    _, _, state = wavenet_ar.generate_ar(weights, c_up, noise, hp, return_state=True)
    with pytest.raises(ValueError):  # state left on the CPU
        wavenet_ar.generate_ar(weights, c_up, noise, hp,
                               state_in=(state[0].cpu(), state[1].cpu(), state[2]))
    assert wavenet_ar.LAUNCHES == before + 1


def test_tacotron_on_the_card_matches_cpu(device):
    hp = default_hparams()
    hp.parse(TINY)
    torch.manual_seed(0)
    model = Tacotron(hp).eval()
    gen = torch.Generator().manual_seed(1)
    inputs = torch.randint(2, 60, (2, 16), generator=gen)
    lengths = torch.tensor([16, 11])
    masks = tuple(torch.bernoulli(torch.full((8, 2, n), 0.5), generator=gen) * 2
                  for n in hp.prenet_layers)
    ref = model(inputs, lengths, max_iters=8, masks=masks)
    got = model.to(device)(inputs.to(device), lengths.to(device), max_iters=8,
                           masks=tuple(m.to(device) for m in masks))
    for key in ('mel_outputs', 'stop_token_prediction', 'alignments'):
        assert (got[key].cpu() - ref[key]).abs().max().item() <= 1e-4, key


def test_synthesize_cli_on_the_card(device, tmp_path):
    hp = default_hparams()
    hp.parse(TINY)
    torch.manual_seed(0)
    taco, wave = str(tmp_path / 'taco.pt'), str(tmp_path / 'wavenet.pt')
    convert.save_checkpoint(taco, 'tacotron', suppress_stop_tokens(Tacotron(hp).state_dict()))
    convert.save_checkpoint(wave, 'wavenet', WaveNet(hp).state_dict())
    texts = tmp_path / 'texts.txt'
    texts.write_text('Hello world.\nHe reads books.\n', encoding='utf-8')
    before = wavenet_ar.LAUNCHES
    stats = synthesize.main(['--tacotron_checkpoint', taco, '--wavenet_checkpoint', wave,
                             '--hparams', TINY, '--text_list', str(texts),
                             '--output_dir', str(tmp_path / 'out')])
    assert wavenet_ar.LAUNCHES > before
    n = hp.max_iters * hp.outputs_per_step * hp.get_hop_size()
    assert [len(w) for w in stats['wavs']] == [n, n]
    assert all(np.isfinite(w).all() for w in stats['wavs'])


def test_stream_service_on_the_card(device, tmp_path):
    """The port's service at the tiny size on the card: one GET returns the WAV header
    and max_iters * r * hop samples, generated by the kernel."""
    hp = default_hparams()
    hp.parse(TINY)
    torch.manual_seed(0)
    taco, wave = str(tmp_path / 'taco.pt'), str(tmp_path / 'wavenet.pt')
    convert.save_checkpoint(taco, 'tacotron', suppress_stop_tokens(Tacotron(hp).state_dict()))
    convert.save_checkpoint(wave, 'wavenet', WaveNet(hp).state_dict())
    server = serve.build_server(['--taco_checkpoint', taco, '--wave_checkpoint', wave,
                                 '--hparams', TINY, '--port', '0', '--no-warmup']).start()
    before = wavenet_ar.LAUNCHES
    try:
        conn = http.client.HTTPConnection(*server.address, timeout=120)
        conn.request('GET', '/tts?text=Hello+world.&format=f32')
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
    finally:
        server.close()
    n = hp.max_iters * hp.outputs_per_step * hp.get_hop_size()
    assert resp.status == 200 and len(data) == 4 * n
    assert np.isfinite(np.frombuffer(data, np.float32)).all()
    assert wavenet_ar.LAUNCHES > before


def test_mol_kernel_matches_plain_version(device):
    """The MoL head at the tiny paper config: params within MOL_KERNEL_TOL of the plain
    version teacher-forced on the kernel's audio, samples within SAMPLE_TOL of the
    MoL draw from the kernel's own params, one launch."""
    hp = paper_hp()
    weights, c_up, noise = _wavenet_inputs(hp, 3, 2, device)
    assert noise.shape == (3, 550, 11)
    before = wavenet_ar.LAUNCHES
    audio, params = wavenet_ar.generate_ar(weights, c_up, noise, hp)
    torch.cuda.synchronize()
    assert wavenet_ar.LAUNCHES == before + 1 and params.shape == (3, 550, 30)
    _, ref = wavenet_ar.generate_ar_reference(weights, c_up, noise, hp, targets=audio)
    assert (params - ref).abs().max().item() <= MOL_KERNEL_TOL
    drawn = wavenet_ar.mol_sample(params, noise, hp)
    assert (drawn - audio).abs().max().item() <= SAMPLE_TOL
    assert torch.isfinite(audio).all() and audio.abs().max() <= 1.0
    again, none = wavenet_ar.generate_ar(weights, c_up, noise, hp, return_params=False)
    assert none is None and torch.equal(again, audio)


@pytest.mark.parametrize('fault', list(mol_planted_faults(paper_hparams())))
def test_mol_kernel_check_catches_planted_faults(device, fault):
    """Each planted MoL fault takes the params beyond MOL_KERNEL_TOL or the samples
    beyond SAMPLE_TOL; the true kernel on the same low log-scale weights passes."""
    hp = paper_hp()
    weights, c_up, noise = _wavenet_inputs(hp, 3, 1, device)
    errs = mol_fault_errors(weights, c_up, noise, hp)
    clean = errs[MOL_NO_FAULT]
    assert clean[0] <= MOL_KERNEL_TOL and clean[1] <= SAMPLE_TOL
    assert errs[fault][0] > MOL_KERNEL_TOL or errs[fault][1] > SAMPLE_TOL, errs[fault]


def test_mol_tie_averages_on_the_card(device):
    """Logits tied by construction (zero logit weights, equal biases, two equal Gumbel
    columns): the kernel draws from the average of the two mixtures, as the plain
    version does."""
    hp = paper_hp()
    weights, c_up, noise = _wavenet_inputs(hp, 2, 1, device)
    weights['w_s2'][:, :10] = 0.0
    weights['b_s2'][:10] = 0.3
    noise[..., 1:] = -2.0
    noise[..., 1 + 3] = noise[..., 1 + 7] = 1.0
    audio, params = wavenet_ar.generate_ar(weights, c_up, noise, hp)
    _, ref = wavenet_ar.generate_ar_reference(weights, c_up, noise, hp, targets=audio)
    assert (params - ref).abs().max().item() <= MOL_KERNEL_TOL
    assert (params[..., :10] == 0.3).all()
    mean = 0.5 * (params[..., 13] + params[..., 17])
    logs = torch.clamp(0.5 * (params[..., 23] + params[..., 27]), min=hp.log_scale_min)
    want = torch.clamp(mean + torch.exp(logs) * noise[..., 0], -1, 1)
    assert (want - audio).abs().max().item() <= SAMPLE_TOL


def test_mol_state_carry_on_the_card(device):
    """The MoL kernel in three state-carried chunks (boundaries 97 and 197 against the
    2- and 4-slot rings of 4 stacks) is bit-identical to one call, within
    MOL_KERNEL_TOL of the plain version in the same chunks, and both planted state
    faults miss."""
    hp = paper_hp()
    weights, c_up, noise = _wavenet_inputs(hp, 1, 1, device)
    r = state_carry(weights, c_up, noise, hp, (97, 197, 275))
    assert r['bit_identical']
    assert r['max_abs_err'] <= MOL_KERNEL_TOL and r['state_err'] <= MOL_KERNEL_TOL
    assert r['t_base'] == (97, 97)
    assert all(e > MOL_KERNEL_TOL for e in r['faults'].values()), r['faults']


# --- the standalone vocoder's instantiations ------------------------------------------

WAVENET_TINY = ("layers=4,stacks=2,residual_channels=8,gate_channels=16,skip_out_channels=8,"
                "upsample_scales=[4,8],hop_size=32,win_size=128,n_fft=256,num_freq=129")
VOCODER_VARIANTS = {'gaussian-plain': ('wavenet_fused_ar=False', 3, None),
                    'categorical-fused': (CATEGORICAL, 3, None),
                    'categorical-plain': (CATEGORICAL + ',wavenet_fused_ar=False', 3, None),
                    'gaussian-fused+g': (SPEAKERS, 3, [1, 3, 0]),
                    'gaussian-plain+g': (SPEAKERS + ',wavenet_fused_ar=False', 3, [1, 3, 0]),
                    'gaussian-fused+g-b17': (SPEAKERS, 17, [i % 5 for i in range(17)])}


def _vocoder_inputs(extra, B, frames, speakers=None, seed=2):
    """chip_smoke.vocoder_model at the tiny width, its conditioning, noise and g_cond."""
    hp, model, weights, _ = vocoder_model(WAVENET_TINY + ',' + extra)
    gen = torch.Generator('cuda').manual_seed(seed)
    c_up = chip_smoke._conditioning(model, hp, B, frames, gen)
    noise = wavenet_ar.make_noise(hp, gen, B, c_up.shape[1])
    g_cond = speaker_rows(model, hp, speakers) if speakers is not None else None
    return hp, model, weights, c_up, noise, g_cond


@pytest.mark.parametrize('variant', list(VOCODER_VARIANTS))
def test_vocoder_variant_matches_plain_version(device, variant):
    """Each new instantiation in three state-carried chunks (boundaries 97 and 197): one
    launch each of that instantiation, bit-identical to one call, params and carried
    state within KERNEL_TOL of the plain version, both planted state faults seen,
    samples the draw from the kernel's own params (class ids exactly)."""
    extra, B, speakers = VOCODER_VARIANTS[variant]
    hp, _, weights, c_up, noise, g_cond = _vocoder_inputs(extra, B, 8, speakers)
    name = wavenet_ar.variant(hp, g_cond is not None)
    assert variant.startswith(name)
    before = wavenet_ar.LAUNCHES_BY_VARIANT[name]
    r = state_carry(weights, c_up, noise, hp, (97, 197, 256), g_cond)
    assert wavenet_ar.LAUNCHES_BY_VARIANT[name] == before + 1 + 3 + 2
    assert r['bit_identical'] and r['audio_ok']
    assert r['max_abs_err'] <= KERNEL_TOL and r['state_err'] <= KERNEL_TOL
    assert all(e > KERNEL_TOL for e in r['faults'].values()), r['faults']
    drawn = wavenet_ar.sample(r['params'], r['noise'], hp)
    if wavenet_ar.is_categorical(hp):
        assert r['audio'].dtype == torch.int64 and torch.equal(drawn, r['audio'])
    else:
        assert (drawn - r['audio']).abs().max().item() <= SAMPLE_TOL


@pytest.fixture(scope='module')
def mutants(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return chip_smoke.build_kernels(str(tmp_path_factory.mktemp('mutants')))


@pytest.mark.parametrize('fault', list(KERNEL_MUTANTS))
def test_kernel_mutants_are_seen(device, mutants, fault):
    """A build of the kernel's source with one planted fault misses the bound of the
    check that holds the true kernel: the ring fault KERNEL_TOL on the params, the two
    small ones FIRST_STEPS_TOL over the first steps at B=16."""
    if 'ring' in fault:
        hp, _, weights, c_up, noise, g_cond = _vocoder_inputs('wavenet_fused_ar=False', 3, 8)
        assert params_err(weights, c_up, noise, hp).max().item() <= KERNEL_TOL
        assert params_err(weights, c_up, noise, hp, library=mutants[fault]).max().item() \
            > KERNEL_TOL
        return
    extra, speakers = ((SPEAKERS, [i % 5 for i in range(16)]) if 'g_cond' in fault
                       else (CATEGORICAL, None))
    hp, _, weights, c_up, noise, g_cond = _vocoder_inputs(extra, 16, 1, speakers)
    assert first_steps_err(weights, c_up, noise, hp, g_cond) <= FIRST_STEPS_TOL
    assert first_steps_err(weights, c_up, noise, hp, g_cond, library=mutants[fault]) \
        > FIRST_STEPS_TOL


def test_categorical_tie_on_the_card(device):
    """chip_smoke's forced tie at the tiny width: the lower id, the mean of the two bf16
    rows fed back (it exits on a miss)."""
    hp, model, weights, _ = vocoder_model(WAVENET_TINY + ',' + CATEGORICAL)
    chip_smoke.categorical_tie(hp, model, weights, torch.Generator('cuda').manual_seed(3))


@pytest.mark.parametrize('extra,speaker_id', [(SPEAKERS, '1,3'),
                                              (CATEGORICAL + ',wavenet_fused_ar=False', None)])
def test_wavenet_cli_on_the_card(device, extra, speaker_id):
    """`synthesize --model WaveNet` on the card at the tiny width, run and checked by
    chip_smoke.vocoder_cli: wavs, map.txt, one launch of the right instantiation. Then
    that launch's own inputs through state_carry: the kernel repeats the entry point's
    audio bit for bit, and its params are within KERNEL_TOL of the plain version's."""
    hp, _, weights, state = vocoder_model(WAVENET_TINY + ',' + extra)
    stats = chip_smoke.vocoder_cli(WAVENET_TINY + ',' + extra, hp, state, speaker_id)
    assert stats['launches'] == 1 and len(stats['wavs']) == 2
    call = stats['ar_call']
    assert (call['g_cond'] is not None) == (speaker_id is not None)
    r = state_carry(weights, call['c_up'], call['noise'], hp,
                    (97, 197, call['c_up'].shape[1]), call['g_cond'])
    assert r['bit_identical'] and torch.equal(r['audio'], call['audio'])
    assert r['max_abs_err'] <= KERNEL_TOL and r['state_err'] <= KERNEL_TOL


def test_big_vocab_raises_on_the_card(device):
    """More classes than the kernel takes raise on a CUDA model, from the Synthesizer
    and from generate: the plain PyTorch loop does not stand in for the unported
    big-vocab kernel."""
    from tacotron2_tpu_torch.inference import wavenet_synthesizer

    hp, model, _, _ = vocoder_model(WAVENET_TINY + ',wavenet_fused_ar=False')
    big = default_hparams()
    big.parse(WAVENET_TINY + ",input_type='mulaw-quantize',quantize_channels=2048,"
              'out_channels=2048')
    big_model = WaveNet(big).cuda().eval()
    c = torch.rand(1, 1, big.num_mels, device='cuda')
    gen = torch.Generator('cuda').manual_seed(0)
    with pytest.raises(NotImplementedError, match='big-vocab'):
        wavenet_synthesizer.Synthesizer(big_model, big)
    with pytest.raises(NotImplementedError, match='big-vocab'):
        wavenet_synthesizer.generate(big_model, big, gen, c, return_params=False)
