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


@pytest.mark.parametrize('config', ['', 'wavenet_fused_ar=False', CATEGORICAL, TINY],
                         ids=['gaussian-fused', 'gaussian-plain', 'categorical-fused', 'tiny'])
def test_every_cluster_size_gives_the_same_outputs(device, config):
    """The kernel forced onto each cluster size the widths admit (at the default width
    all of 1-16; the tiny one's 8 gate pairs stop at 8), B=2 over one frame: audio,
    params and carried state bit-identical across N, and within KERNEL_TOL of the plain
    version."""
    hp = default_hparams()
    hp.parse(config)
    weights, c_up, noise = _wavenet_inputs(hp, 2, 1 if config != TINY else 8, device)
    table, auto = chip_smoke.occupancy(hp)
    sizes = [n for n in wavenet_ar.CLUSTER_SIZES if table[n] > 0]
    assert sizes[0] == (8 if config == TINY else 16) and auto == sizes[0]
    runs = {n: wavenet_ar.generate_ar(weights, c_up, noise, hp, return_state=True, cluster=n)
            for n in sizes}
    audio, params, state = runs[sizes[0]]
    for n, (a, p, st) in runs.items():
        assert torch.equal(a, audio) and torch.equal(p, params), n
        assert torch.equal(st[0], state[0]) and torch.equal(st[1], state[1]), n
    _, ref = wavenet_ar.generate_ar_reference(weights, c_up, noise, hp, targets=audio)
    assert (params - ref).abs().max().item() <= KERNEL_TOL


PAIR_CONFIGS = {'gaussian-fused': ('', False), 'gaussian-plain': ('wavenet_fused_ar=False', False),
                'mol': ('out_channels=30', False), 'categorical': (CATEGORICAL, False),
                'categorical+nll': (CATEGORICAL, True)}


@pytest.mark.parametrize('B', [132, 131])
@pytest.mark.parametrize('config', list(PAIR_CONFIGS))
def test_two_sequences_a_cluster_are_bit_identical_to_one(device, config, B):
    """At the defaults' widths two sequences a cluster of two (P = 2: the choice at B=132
    and 131 on the fused chain, forced here) give the audio, the params (or the NLL) and
    the carried state of one sequence a cluster (P = 1, forced) bit for bit over 300
    steps, for every head of the large batch's layout and both chains; B=131 leaves the
    last cluster one sequence."""
    extra, nll = PAIR_CONFIGS[config]
    hp = default_hparams()
    hp.parse(extra)
    weights, c_up, noise = _wavenet_inputs(hp, B, 2, device)
    c_up, noise = c_up[:, :300].contiguous(), noise[:, :300].contiguous()
    kw = dict(return_params=not nll, return_state=True)
    if nll:
        kw['y_eval'] = torch.randint(0, hp.out_channels, c_up.shape[:2], device=device,
                                     generator=torch.Generator(device).manual_seed(3))
    table, _ = chip_smoke.occupancy(hp, B, nll)
    fused = bool(hp.wavenet_fused_ar)  # the plain chain takes two only when forced
    assert wavenet_ar.cluster_layout(B, table, fused) == \
        ((2, 2) if fused else (1, 1))
    wavenet_ar.LAUNCHES_BY_LAYOUT.clear()
    one = wavenet_ar.generate_ar(weights, c_up, noise, hp, sequences=1, **kw)
    two = wavenet_ar.generate_ar(weights, c_up, noise, hp, sequences=2, **kw)
    assert dict(wavenet_ar.LAUNCHES_BY_LAYOUT) == {(1, 1): 1, (2, 2): 1}
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    assert torch.equal(one[2][0], two[2][0]) and torch.equal(one[2][1], two[2][1])


def test_two_sequences_a_cluster_raise_where_not_admitted(device):
    """The paper width and the big head have no layout of two sequences a cluster."""
    hp = default_hparams()
    hp.parse(PAPER_TINY)
    weights, c_up, noise = _wavenet_inputs(hp, 2, 1, device)
    with pytest.raises(ValueError, match='two sequences a cluster are not admitted'):
        wavenet_ar.generate_ar(weights, c_up, noise, hp, sequences=2)


def test_first_steps_at_every_cluster_size(device):
    """The first-steps reading (FIRST_STEPS_TOL: the lower quartile over B=16 sequences
    of the params error over the first two steps) holds at every cluster size."""
    hp = default_hparams()
    weights, c_up, noise = _wavenet_inputs(hp, chip_smoke.FIRST_STEPS_BATCH, 1, device)
    for n in wavenet_ar.CLUSTER_SIZES:
        assert first_steps_err(weights, c_up, noise, hp, cluster=n) <= FIRST_STEPS_TOL, n


def test_a_cluster_the_widths_do_not_split_raises(device):
    hp = default_hparams()
    hp.parse(TINY)
    weights, c_up, noise = _wavenet_inputs(hp, 2, 8, device)
    with pytest.raises(ValueError, match='not admitted'):
        wavenet_ar.generate_ar(weights, c_up, noise, hp, cluster=16)


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
            input_type='mulaw-quantize', quantize_channels=65537, out_channels=65537))
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


@pytest.mark.parametrize('fault', list(chip_smoke.CLUSTER_MUTANTS))
def test_cluster_mutants_are_seen(device, mutants, fault):
    """A build with a planted fault of the cluster layout misses KERNEL_TOL at the
    default width, B=2 over one frame, on the clusters B=2 gets (16) or on the size
    chip_smoke.FAULT_CLUSTER names (one, for the large batch's instantiation; two with
    two sequences a cluster, FAULT_SEQUENCES), where the true kernel holds."""
    hp = default_hparams()
    weights, c_up, noise = _wavenet_inputs(hp, 2, 1, device)
    cluster = chip_smoke.FAULT_CLUSTER.get(fault)
    sequences = chip_smoke.FAULT_SEQUENCES.get(fault)
    assert cluster is not None or chip_smoke.occupancy(hp)[1] > 1
    assert params_err(weights, c_up, noise, hp, cluster=cluster,
                      sequences=sequences).max().item() <= KERNEL_TOL
    assert params_err(weights, c_up, noise, hp, library=mutants[fault], cluster=cluster,
                      sequences=sequences).max().item() > KERNEL_TOL


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
    path = f'synthesize --model WaveNet ({extra})'
    chip_smoke.LAYOUTS_BY_PATH.pop(path, None)
    stats = chip_smoke.vocoder_cli(WAVENET_TINY + ',' + extra, hp, state, speaker_id, path)
    assert stats['launches'] == 1 and len(stats['wavs']) == 2
    # the path's one launch (B=2) counted by the cluster size the rule gives it
    assert chip_smoke.cluster_counts(path) == {chip_smoke.occupancy(hp, 2)[1]: 1}
    call = stats['ar_call']
    assert (call['g_cond'] is not None) == (speaker_id is not None)
    r = state_carry(weights, call['c_up'], call['noise'], hp,
                    (97, 197, call['c_up'].shape[1]), call['g_cond'])
    assert r['bit_identical'] and torch.equal(r['audio'], call['audio'])
    assert r['max_abs_err'] <= KERNEL_TOL and r['state_err'] <= KERNEL_TOL


def test_big_vocab_raises_on_the_card(device):
    """A big-vocab model (2,048 classes) runs on a CUDA model through the kernel, from
    the Synthesizer and from generate, and returns no params; more classes than the
    kernel takes (65,537) raise from both: the plain PyTorch loop stands in for no
    kernel."""
    from tacotron2_tpu_torch.inference import wavenet_synthesizer

    big = default_hparams()
    big.parse(WAVENET_TINY + ",input_type='mulaw-quantize',quantize_channels=2048,"
              'out_channels=2048')
    big_model = WaveNet(big).cuda().eval()
    c = torch.rand(1, 1, big.num_mels, device='cuda')
    gen = torch.Generator('cuda').manual_seed(0)
    before = wavenet_ar.LAUNCHES_BY_VARIANT['categorical_big-fused']
    out = wavenet_synthesizer.generate(big_model, big, gen, c, return_params=False)
    assert out['audio'].shape == (1, 32) and out['audio'].dtype == torch.int64
    wavs = wavenet_synthesizer.Synthesizer(big_model, big).synthesize(
        [torch.zeros(2, 80, device='cuda')], gen)
    assert [len(w) for w in wavs] == [64]
    assert wavenet_ar.LAUNCHES_BY_VARIANT['categorical_big-fused'] == before + 2
    with pytest.raises(ValueError, match='no params'):
        wavenet_synthesizer.generate(big_model, big, gen, c)
    over = big.replace(quantize_channels=65537, out_channels=65537)
    with pytest.raises(NotImplementedError, match='65536 classes'):
        wavenet_synthesizer.Synthesizer(big_model, over)
    with pytest.raises(NotImplementedError, match='65536 classes'):
        wavenet_synthesizer.generate(big_model, over, gen, c, return_params=False)


# --- the big-vocab head, the in-kernel NLL and the trainer ----------------------------

BIG_VARIANTS = {'fused-greedy': (2048, '', None, False), 'fused-sampled': (2048, '', 77, False),
                'plain-sampled': (2048, 'wavenet_fused_ar=False', 77, False),
                'fused-sampled+g': (2048, SPEAKERS, 77, True),
                'fused-sampled-q1025': (1025, '', 77, False),
                'fused-sampled-q65536': (65536, '', 77, False)}


@pytest.mark.parametrize('variant', list(BIG_VARIANTS))
def test_big_vocab_kernel_matches_plain_version(device, variant):
    """The big-vocab head with the NLL flag at the tiny width, B=3 in three
    state-carried chunks (boundaries 97 and 197): bit-identical to one call, the NLL
    within NLL_TOL and the carried state within KERNEL_TOL of the plain version
    teacher-forced on the kernel's ids, which draws another id at no more than
    MAX_IDS_OFF of the steps (chip_smoke.py's bounds)."""
    Q, extra, seed, speakers = BIG_VARIANTS[variant]
    hp, model, weights, _ = chip_smoke.big_vocab_model(Q, WAVENET_TINY + (',' + extra if extra
                                                                         else ''))
    gen = torch.Generator('cuda').manual_seed(4)
    c_up, y = chip_smoke.big_vocab_inputs(hp, model, 3, 8, gen)
    g_cond = speaker_rows(model, hp, [1, 3, 0]) if speakers else None
    name = wavenet_ar.variant(hp, speakers, True)
    before = wavenet_ar.LAUNCHES_BY_VARIANT[name]
    r = chip_smoke.big_vocab_vs_plain(hp, weights, c_up, y, (97, 197, 256), g_cond, seed)
    assert wavenet_ar.LAUNCHES_BY_VARIANT[name] == before + 1 + 3
    assert r['bit_identical'] and r['audio_ok'] and r['t_base'] == (97, 97)
    assert r['nll_err'] <= chip_smoke.NLL_TOL and r['state_err'] <= KERNEL_TOL
    assert r['ids_off'] <= chip_smoke.MAX_IDS_OFF * r['steps']
    assert r['distinct'] > (3 if seed is None else 100)


def test_big_vocab_cluster_sizes(device):
    """The big-vocab head with the NLL flag, Q = 65,536, split over each cluster size
    the tiny width admits, B=2: ids, NLL and carried state bit-identical across N (the
    NLL's log-sum-exp is merged in fixed blocks of classes; the bound of 1e-6 would
    allow one f32 step at an NLL of 11)."""
    hp, model, weights, _ = chip_smoke.big_vocab_model(65536, WAVENET_TINY)
    gen = torch.Generator('cuda').manual_seed(4)
    c_up, y = chip_smoke.big_vocab_inputs(hp, model, 2, 4, gen)
    noise = torch.zeros(2, c_up.shape[1], 1, device=device)
    table, _ = chip_smoke.occupancy(hp, nll=True)
    runs = {n: wavenet_ar.generate_ar(weights, c_up, noise, hp, return_params=False, seed=5,
                                      y_eval=y, return_state=True, cluster=n)
            for n in wavenet_ar.CLUSTER_SIZES if table[n] > 0}
    assert len(runs) == 4
    ids, nll, state = runs[8]
    for n, (i, e, st) in runs.items():
        assert torch.equal(i, ids) and torch.equal(st[0], state[0]), n
        assert torch.equal(e, nll), n


def test_small_head_nll_on_the_card(device):
    """The NLL flag on the small head (Q = 256) at the tiny width: the ids of a launch
    with params on the same noise, and -log_softmax of those params to 1e-5."""
    hp, model, weights, c_up, noise, _ = _vocoder_inputs(CATEGORICAL, 3, 8)
    y = torch.randint(0, 256, c_up.shape[:2], device='cuda')
    ids, nll = wavenet_ar.generate_ar(weights, c_up, noise, hp, return_params=False, y_eval=y)
    ids2, params = wavenet_ar.generate_ar(weights, c_up, noise, hp)
    want = -torch.log_softmax(params, -1).gather(-1, y[..., None])[..., 0]
    assert torch.equal(ids, ids2) and (nll - want).abs().max().item() <= 1e-5
    with pytest.raises(ValueError, match='outside'):
        wavenet_ar.generate_ar(weights, c_up, noise, hp, return_params=False, y_eval=y + 200)


def test_big_vocab_noise_on_the_card(device):
    """chip_smoke's check of the in-kernel noise at the tiny width and Q = 2,048: uniform
    ids under flat logits, other ids for another seed or sequence, the arg-max of
    philox_gumbel (it exits on a miss)."""
    hp, _, weights, _ = chip_smoke.big_vocab_model(2048, WAVENET_TINY)
    chip_smoke.big_vocab_noise(hp, weights, torch.Generator('cuda').manual_seed(5))


TRAIN_TINY = WAVENET_TINY + ',wavenet_batch_size=2,wavenet_dropout=0.0,wavenet_ema_decay=0.9'


@pytest.mark.parametrize('extra', ['', ',out_channels=30', ",wavenet_weight_normalization=True,"
                                   "input_type='mulaw-quantize',quantize_channels=2048,"
                                   'out_channels=2048'],
                         ids=['gaussian', 'mol', 'categorical_big-wn'])
def test_train_steps_cuda_vs_cpu(device, extra):
    """Three train steps from the same seeded state on the same batch, dropout 0, on the
    card and on the CPU: loss and grad_norm within 1e-4 relative, every parameter, EMA
    value and Adam moment within 1e-3 of its tensor's largest magnitude (f32 on both,
    TF32 off; only the order of the sums differs, but Adam's division by sqrt(nu)
    amplifies that where a gradient is near zero, read 2e-4 on a bias, and the MoL
    loss's log(sigmoid(a) - sigmoid(b)) keeps few digits at its 1e-5 threshold, read
    1.2e-4 on a moment)."""
    from tacotron2_tpu_torch.training import wavenet_trainer as wt

    hp = default_hparams()
    hp.parse(TRAIN_TINY + extra)
    rng = np.random.default_rng(0)
    T = 4 * hp.get_hop_size()
    audio = (rng.integers(0, hp.quantize_channels, (2, T)) if 'quantize' in extra
             else rng.uniform(-1, 1, (2, T)).astype(np.float32))
    batch = dict(audio=audio, input_lengths=np.array([T, T - 40]),
                 mel_conditions=rng.uniform(0, 1, (2, 4, hp.num_mels)).astype(np.float32))
    states = {d: wt.create_train_state(hp, d, seed=3) for d in ('cpu', 'cuda')}
    for _ in range(3):
        m = {d: wt.train_step(st, wt.to_device(batch, d), hp) for d, st in states.items()}
        for key in ('loss', 'grad_norm'):
            a, b = m['cpu'][key].item(), m['cuda'][key].item()
            assert abs(a - b) <= 1e-4 * abs(a), key
    for kind in ('model', 'ema_model'):
        for (n, a), (_, b) in zip(getattr(states['cpu'], kind).named_parameters(),
                                  getattr(states['cuda'], kind).named_parameters()):
            assert (a - b.cpu()).abs().max().item() <= 1e-3 * max(a.abs().max().item(), 1e-3), n
    for kind in ('exp_avg', 'exp_avg_sq'):
        for a, b in zip(getattr(states['cpu'], kind), getattr(states['cuda'], kind)):
            assert (a - b.cpu()).abs().max().item() <= 1e-3 * max(a.abs().max().item(), 1e-6)


@pytest.mark.parametrize('head', ['gaussian', 'categorical_big'])
def test_train_cli_on_the_card(device, tmp_path, head):
    """`python -m tacotron2_tpu_torch.train --model WaveNet` on the card at the tiny
    width, run by chip_smoke.run_trainer: 4 steps with evals at 2 and 4, each of which
    launches the AR kernel once (with params, or with the NLL flag for a big-vocab
    model); the evals' launches through chip_smoke's checks on their own inputs (a
    further launch repeats each bit for bit, the plain version follows in chunks; they
    exit on a miss); then a rerun that restores step 4 and goes on to 6."""
    from tacotron2_tpu_torch.training import checkpoint_select

    extra = TRAIN_TINY.replace('upsample_scales=[4,8],hop_size=32,win_size=128,n_fft=256,'
                               'num_freq=129', 'upsample_scales=[5,55]') \
        + ',max_time_steps=2200,wavenet_natural_eval=True,wavenet_ema_decay=0.5'
    if head == 'categorical_big':
        extra += ",input_type='mulaw-quantize',quantize_channels=2048,out_channels=2048"
    hp = default_hparams()
    hp.parse(extra)
    meta = chip_smoke.make_corpus(str(tmp_path), hp, 8, seed=1)
    run = chip_smoke.run_trainer(str(tmp_path), meta, 'run', extra, 4, 2, 4, restore=False)
    variant = 'categorical_big-fused+nll' if head == 'categorical_big' else 'gaussian-fused'
    assert run['launches'] == {variant: 2} and sorted(run['steps']) == [1, 2, 3, 4]
    assert all(np.isfinite(loss) for _, loss in run['steps'].values())
    assert ('(in-kernel)' in run['out']) == (head == 'categorical_big')
    history = checkpoint_select.load_eval_history(run['save_dir'])
    assert [r['step'] for r in history] == [2, 4]
    assert all(np.isfinite(r['natural_loss']) for r in history)
    assert len(run['calls']) == 2
    if head == 'categorical_big':
        r = chip_smoke.big_eval_launch_vs_plain(run['calls'])
        assert r['steps'] == 2200 and r['nll_err'] <= (
            chip_smoke.EVAL_NLL_TOL_PER_SPAN * max(1.0, r['nll_span']))
    else:
        r = chip_smoke.eval_launch_vs_plain(run['calls'][-1])
        assert r['full_steps'] == 2200 and r['max_abs_err'] <= KERNEL_TOL
    again = chip_smoke.run_trainer(str(tmp_path), meta, 'run', extra, 6, 2, 4)
    assert 'Restored WaveNet checkpoint at step 4' in again['out']
    assert sorted(again['steps']) == [5, 6] and again['launches'] == {variant: 1}


# ---------------------------------------------------------------- the probes (B9-B12)

def test_prng_probe_kernel_matches_plain_version(device):
    """B12 at a small odd size (Q = 1,001: the last Philox block is ragged): ids exact,
    stats within GUMBEL_STATS_TOL; on a forced tie the first class."""
    from tacotron2_tpu_torch.probes import prng_probe as m

    inp = m.make_inputs(seed=2, B=3, Q=1001, random_scores=True, device=device)
    ids, stats = m.kernel('gumbel_argmax', inp)
    pids, pstats = m.plain('gumbel_argmax', inp)
    torch.cuda.synchronize()
    assert torch.equal(ids, pids)
    assert (stats - pstats).abs().max().item() <= chip_smoke.GUMBEL_STATS_TOL
    inp['scores'][:, [4, 700]] = 1e30
    assert m.kernel('gumbel_argmax', inp)[0].ravel().tolist() == [4, 4, 4]
    with pytest.raises(ValueError, match='CUDA tensors'):
        m.kernel('gumbel_argmax', m.make_inputs(B=1, Q=8))


@pytest.mark.parametrize('variant', ['base', 'fused', 'fused_bf16glu', 'fused_tanhsig',
                                     'fused_tanhfold', 'fused_tf_bf16o'])
def test_ar_critpath_kernel_matches_plain_version(device, variant):
    """B9 at L=4, B=2 and full widths over 9 steps (every ring wraps)."""
    from tacotron2_tpu_torch.probes import ar_critpath as m

    inp = m.make_inputs(L=4, B=2, device=device)
    got, want = m.kernel(variant, inp, 9), m.plain(variant, inp, 9)
    torch.cuda.synchronize()
    assert chip_smoke.rel_err(got, want) <= chip_smoke.PROBE_TOL['ar_critpath']


@pytest.mark.parametrize('variant', ['indep', 'dep_f32', 'dep_bf16', 'dep_T', 'ksplit',
                                     'k4split', 'nsplit'])
def test_matmul_probe_kernel_matches_plain_version(device, variant):
    """B10 at U=64, IN1=128 (8 co-resident blocks) over 3 steps: the output and the last
    step's whole product."""
    from tacotron2_tpu_torch.probes import matmul_probe as m

    inp = m.make_inputs(U=64, IN1=128, device=device)
    (got, prod), (want, want_prod) = m.kernel(variant, inp, 3), m.plain(variant, inp, 3)
    first, want_first = m.kernel(variant, inp, 1)[1], m.plain(variant, inp, 1)[1]
    torch.cuda.synchronize()
    tol = chip_smoke.PROBE_TOL['matmul_probe']
    assert chip_smoke.rel_err(got, want) <= tol and chip_smoke.rel_err(prod, want_prod) <= tol
    assert chip_smoke.rel_err(first, want_first) <= (
        tol if variant == 'dep_bf16' else chip_smoke.PRODUCT_TOL)


@pytest.mark.parametrize('variant', ['lstm', 'attlite', 'att'])
def test_microbench_kernel_matches_plain_version(device, variant):
    """B11 at U=256 (16 clusters of 2 CTAs, 2 attention rows a cluster) over 3 steps, `lstm`
    from a seeded nonzero state: h2, the cells and the accumulated alignments."""
    from tacotron2_tpu_torch.probes import microbench as m

    inp = m.make_inputs(U=256, device=device)
    start = m.random_state(inp) if variant == 'lstm' else None
    (got, fin), (want, pfin) = m.kernel(variant, inp, 3, start=start), \
        m.plain(variant, inp, 3, start=start)
    torch.cuda.synchronize()
    tol = chip_smoke.PROBE_TOL['microbench']
    assert chip_smoke.rel_err(got, want) <= tol
    for k in ('c1', 'c2', 'h1', 'ctx'):
        assert chip_smoke.rel_err(fin[k].float(), pfin[k].float()) <= tol, k
    assert (fin['state'] - pfin['state']).abs().max().item() <= chip_smoke.STATE_TOL


@pytest.mark.parametrize('B', [1, 2, 8])
def test_prng_probe_kernel_at_each_batch_gives_the_same_bits_twice(device, B):
    """B12 at Q = 65,536 on the script's scores and on random ones at B = 1, 2, 8: ids
    exactly the plain version's (on random scores but at a near-tie, TIE_GAP), stats
    within GUMBEL_STATS_TOL, and the same bits on a second launch."""
    from tacotron2_tpu_torch.probes import prng_probe as m

    for rnd in (False, True):
        inp = m.make_inputs(seed=4, B=B, random_scores=rnd, device=device)
        (ids, stats), (ids2, stats2) = [tuple(x.clone() for x in m.kernel('gumbel_argmax', inp))
                                        for _ in range(2)]
        pids, pstats = m.plain('gumbel_argmax', inp)
        torch.cuda.synchronize()
        assert torch.equal(ids, ids2) and torch.equal(stats, stats2)
        assert (stats - pstats).abs().max().item() <= chip_smoke.GUMBEL_STATS_TOL
        noised = inp['scores'] + m.gumbel_from_bits(m.philox_bits(inp['seed'], B, 0, m.Q, device))
        top2 = noised.topk(2, dim=1).values
        for row in (ids != pids).ravel().nonzero().ravel().tolist():
            assert rnd and top2[row, 0] - top2[row, 1] <= chip_smoke.TIE_GAP


@pytest.mark.parametrize('B', [1, 2, 8])
@pytest.mark.parametrize('variant', ['base', 'fused', 'fused_bf16glu', 'fused_tanhsig',
                                     'fused_tanhfold', 'fused_tf_bf16o'])
def test_ar_critpath_kernel_at_each_batch_gives_the_same_bits_twice(device, variant, B):
    """B9 at full width, L=20, over 16 steps at B = 1, 2, 8 (one cluster of 16 CTAs):
    within PROBE_TOL of the plain version, and the same bits on a second launch."""
    from tacotron2_tpu_torch.probes import ar_critpath as m

    inp = m.make_inputs(B=B, device=device)
    got, again = m.kernel(variant, inp, 16).clone(), m.kernel(variant, inp, 16)
    want = m.plain(variant, inp, 16)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert chip_smoke.rel_err(got, want) <= chip_smoke.PROBE_TOL['ar_critpath']


@pytest.mark.parametrize('fault', list(chip_smoke.PROBE_MUTANTS))
def test_probe_mutants_are_seen(device, mutants, fault):
    """Each probe kernel's planted fault, built in the phase-2 pool, misses the check that
    holds the true kernel (small sizes as above; B11's dropped k-tile at phase 11's size,
    U=1,024 over 16 steps, where it moves h2 by 0.17 of its largest value: at U=256 over
    3 steps it stays inside PROBE_TOL)."""
    from tacotron2_tpu_torch.probes import ar_critpath, matmul_probe, microbench, prng_probe

    lib = mutants[fault]
    if fault.startswith('prng_probe'):
        inp = prng_probe.make_inputs(B=2, Q=64, device=device)
        inp['scores'][:, [5, 9]] = 1e30
        assert prng_probe.kernel('gumbel_argmax', inp)[0].ravel().tolist() == [5, 5]
        assert prng_probe.kernel('gumbel_argmax', inp, library=lib)[0].ravel().tolist() == [9, 9]
    elif fault.startswith('ar_critpath'):
        inp = ar_critpath.make_inputs(L=4, B=2, device=device)
        want = ar_critpath.plain('base', inp, 9)
        tol = chip_smoke.PROBE_TOL['ar_critpath']
        assert chip_smoke.rel_err(ar_critpath.kernel('base', inp, 9), want) <= tol
        assert chip_smoke.rel_err(ar_critpath.kernel('base', inp, 9, library=lib), want) > tol
    elif fault.startswith('matmul_probe'):
        inp = matmul_probe.make_inputs(U=64, IN1=128, device=device)
        want = matmul_probe.plain('dep_f32', inp, 3)[0]
        got = matmul_probe.kernel('dep_f32', inp, 3, library=lib)[0]
        assert chip_smoke.rel_err(got, want) > chip_smoke.PROBE_TOL['matmul_probe']
    elif 'k-tile' in fault:
        inp = microbench.make_inputs(device=device)
        steps, start = chip_smoke.PROBE_STEPS['microbench'], microbench.random_state(inp)
        want = microbench.plain('lstm', inp, steps, start=start)[0]
        got = microbench.kernel('lstm', inp, steps, start=start, library=lib)[0]
        assert chip_smoke.rel_err(got, want) > chip_smoke.PROBE_TOL['microbench']
    else:
        inp = microbench.make_inputs(U=256, device=device)
        want = microbench.plain('att', inp, 3)[1]['state']
        got = microbench.kernel('att', inp, 3, library=lib)[1]['state']
        assert chip_smoke.rel_err(got, want) > chip_smoke.STATE_TOL
