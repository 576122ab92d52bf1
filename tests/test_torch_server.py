"""The port's streaming TTS service: its HTTP server against the JAX package's
(`tacotron2_tpu/inference/server.py`, the cases of tests/test_server.py run on both,
with byte-identical responses), and `python -m tacotron2_tpu_torch.serve` and
`synthesize --mode stream` end to end on the CPU at the tiny size.
"""

import http.client
import importlib.util
import json
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tacotron2_tpu.config import default_hparams
from tacotron2_tpu.inference import server as jax_server
from tacotron2_tpu_torch import convert, serve, synthesize
from tacotron2_tpu_torch.inference import server as port_server
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.utils import suppress_stop_tokens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVERS = {'jax': jax_server, 'port': port_server}
SR = 8000
TINY = ("embedding_dim=32,enc_conv_channels=32,enc_conv_num_layers=1,encoder_lstm_units=16,"
        "attention_dim=16,attention_filters=8,attention_kernel=[7],prenet_layers=[16,16],"
        "decoder_lstm_units=32,postnet_channels=32,postnet_num_layers=2,outputs_per_step=2,"
        "layers=4,stacks=2,residual_channels=8,gate_channels=16,skip_out_channels=8,"
        "upsample_scales=[4,8],hop_size=32,win_size=128,n_fft=256,num_freq=129,max_iters=8")


def make_chunks(n=3, size=160):
    rng = np.random.default_rng(7)
    return [rng.uniform(-0.9, 0.9, size).astype(np.float32) for _ in range(n)]


def start_server(module):
    """A started TTSServer of `module` over the fake stream_fn of tests/test_server.py."""
    chunks = make_chunks()
    state = dict(in_flight=0, max_in_flight=0)

    def stream_fn(text, seed):
        state['in_flight'] += 1
        state['max_in_flight'] = max(state['max_in_flight'], state['in_flight'])
        try:
            for c in chunks:
                time.sleep(0.01)  # emulate per-chunk generation latency
                yield c * (1.0 if seed == 0 else 0.5)
        finally:
            state['in_flight'] -= 1

    srv = module.TTSServer(stream_fn, sample_rate=SR, max_waiters=2).start()
    srv.chunks = chunks
    srv.state = state
    return srv


@pytest.fixture(params=list(SERVERS))
def server(request):
    srv = start_server(SERVERS[request.param])
    srv.module = SERVERS[request.param]
    yield srv
    srv.close()


def get(srv, path, method='GET', body=None):
    conn = http.client.HTTPConnection(*srv.address, timeout=10)
    headers = {'Content-Type': 'application/json'} if body else {}
    conn.request(method, path, body=body, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


def test_healthz(server):
    resp, data = get(server, '/healthz')
    assert resp.status == 200
    obj = json.loads(data)
    assert obj['ok'] and obj['sample_rate'] == SR and obj['served'] == 0


def test_wav_stream_bytes_exact(server):
    resp, data = get(server, '/tts?text=hello&seed=0')
    assert resp.status == 200
    assert resp.getheader('Content-Type') == 'audio/wav'
    assert resp.getheader('Transfer-Encoding') == 'chunked'
    header = server.module.wav_stream_header(SR)
    assert data[:44] == header == jax_server.wav_stream_header(SR)
    fmt = struct.unpack('<IHHIIHH', header[16:36])
    assert fmt[1:4] == (1, 1, SR)
    expected = b''.join(jax_server.float_to_pcm16(c) for c in server.chunks)
    assert data[44:] == expected


def test_f32_roundtrip_and_seed(server):
    resp, data = get(server, '/tts?text=hello&seed=1&format=f32')
    assert resp.status == 200
    got = np.frombuffer(data, np.float32)
    np.testing.assert_allclose(got, np.concatenate([c * 0.5 for c in server.chunks]),
                               rtol=1e-6)


def test_post_json(server):
    body = json.dumps({'text': 'hi', 'format': 'pcm16'})
    resp, data = get(server, '/tts', method='POST', body=body)
    assert resp.status == 200
    assert data == b''.join(server.module.float_to_pcm16(c) for c in server.chunks)


def test_bad_requests(server):
    assert get(server, '/tts')[0].status == 400                      # empty text
    assert get(server, '/tts?text=x&format=mp3')[0].status == 400    # bad format
    assert get(server, '/nope')[0].status == 404
    assert get(server, '/tts', method='POST', body='{not json')[0].status == 400
    assert get(server, f'/tts?text={"x" * 3000}')[0].status == 400


def test_chunks_stream_before_generation_finishes(server):
    """First audio bytes arrive while the generator is still producing."""
    conn = http.client.HTTPConnection(*server.address, timeout=10)
    conn.request('GET', '/tts?text=hello')
    resp = conn.getresponse()
    first = resp.read(44 + len(jax_server.float_to_pcm16(server.chunks[0])))
    assert server.state['in_flight'] == 1
    assert first[:4] == b'RIFF'
    resp.read()
    conn.close()


def test_concurrent_requests_serialize_on_device_lock(server):
    """Two parallel requests both succeed; generation never overlaps."""
    results = []

    def one(seed):
        resp, data = get(server, f'/tts?text=hello&seed={seed}&format=f32')
        results.append((resp.status, len(data)))

    threads = [threading.Thread(target=one, args=(0,)) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
        assert not t.is_alive()
    assert [r[0] for r in results] == [200, 200]
    assert all(r[1] == sum(len(c) * 4 for c in server.chunks) for r in results)
    assert server.state['max_in_flight'] == 1
    assert json.loads(get(server, '/healthz')[1])['served'] >= 2


def _measure_ttfa():
    spec = importlib.util.spec_from_file_location(
        'measure_ttfa', os.path.join(REPO, 'scripts', 'measure_ttfa.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_measure_ttfa_client_parses_stream(server):
    """scripts/measure_ttfa.py decodes the chunked stream: all audio bytes counted,
    first audio before the end."""
    r = _measure_ttfa().one_request('hello', *server.address)
    n_samples = sum(len(c) for c in server.chunks)
    assert r['audio_seconds'] == round(n_samples * 2 / 2 / 22050, 3)
    assert r['ttfa_first_audio_s'] is not None
    assert r['ttfa_first_audio_s'] <= r['total_wall_s']
    assert r['n_chunks'] >= 1


def _raw(srv, request: bytes) -> bytes:
    """Every byte of the response, the Date header taken out."""
    with socket.create_connection(srv.address, timeout=10) as sock:
        sock.sendall(request)
        out = b''
        while True:
            data = sock.recv(65536)
            if not data:
                break
            out += data
    return b'\r\n'.join(line for line in out.split(b'\r\n')
                        if not line.startswith(b'Date: '))


RAW_REQUESTS = [
    b'GET /healthz HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n',
    b'GET /tts?text=hello HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n',
    b'GET /tts?text=hello&seed=3&format=f32 HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n',
    b'POST /tts HTTP/1.1\r\nHost: x\r\nConnection: close\r\nContent-Length: 34\r\n\r\n'
    b'{"text": "hi", "format": "pcm16"}\n',
    b'GET /tts?text=x&format=mp3 HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n',
    b'GET /nope HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n',
]


@pytest.mark.parametrize('request_bytes', RAW_REQUESTS,
                         ids=['healthz', 'wav', 'f32', 'post', 'bad-format', '404'])
def test_responses_byte_identical_to_jax(request_bytes):
    """The same request to the JAX server and to the port's, over the same fake
    stream_fn, gets the same bytes back: status line, headers (but the date), the
    chunk framing and the audio."""
    got = {}
    for name, module in SERVERS.items():
        srv = start_server(module)
        try:
            got[name] = _raw(srv, request_bytes)
        finally:
            srv.close()
    assert got['port'] == got['jax']
    assert got['port'].startswith(b'HTTP/1.1 ')


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """Tiny Tacotron (stop tokens suppressed: every text decodes max_iters steps) and
    WaveNet checkpoints, as convert.save_checkpoint writes them."""
    hp = default_hparams()
    hp.parse(TINY)
    tmp = tmp_path_factory.mktemp('ckpt')
    torch.manual_seed(0)
    taco, wave = str(tmp / 'taco.pt'), str(tmp / 'wavenet.pt')
    convert.save_checkpoint(taco, 'tacotron', suppress_stop_tokens(Tacotron(hp).state_dict()))
    convert.save_checkpoint(wave, 'wavenet', WaveNet(hp).state_dict())
    return hp, taco, wave


@pytest.mark.parametrize('warmup', [['--no-warmup'], [], ['--warmup_buckets', '3']],
                         ids=['no-warmup', 'warmup', 'warmup_buckets'])
def test_serve_cli_on_cpu(checkpoints, warmup):
    """build_server at the tiny size on the CPU: one GET /tts returns the WAV header
    and max_iters * r * hop pcm16 samples. serve.py's --warmup_buckets is accepted."""
    hp, taco, wave = checkpoints
    server = serve.build_server(['--taco_checkpoint', taco, '--wave_checkpoint', wave,
                                 '--device', 'cpu', '--hparams', TINY, '--port', '0',
                                 *warmup]).start()
    try:
        conn = http.client.HTTPConnection(*server.address, timeout=60)
        conn.request('GET', '/tts?text=Hello+world.')
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        health = json.loads(get(server, '/healthz')[1])
    finally:
        server.close()
    n = hp.max_iters * hp.outputs_per_step * hp.get_hop_size()
    assert resp.status == 200 and len(data) == 44 + 2 * n
    assert data[:44] == port_server.wav_stream_header(hp.sample_rate)
    assert health['served'] == 1 and health['sample_rate'] == hp.sample_rate


def test_synthesize_stream_mode_on_cpu(checkpoints, tmp_path):
    hp, taco, wave = checkpoints
    texts = tmp_path / 'texts.txt'
    texts.write_text('Hello world.\nHe reads books.\n', encoding='utf-8')
    stats = synthesize.main(['--tacotron_checkpoint', taco, '--wavenet_checkpoint', wave,
                             '--hparams', TINY, '--text_list', str(texts), '--mode',
                             'stream', '--output_dir', str(tmp_path), '--device', 'cpu'])
    n = hp.max_iters * hp.outputs_per_step * hp.get_hop_size()
    for i in range(2):
        path = tmp_path / 'stream' / f'stream-{i}.wav'
        sr, data = wavfile.read(path)
        assert str(path) == stats['wav_paths'][i]
        assert sr == hp.sample_rate and len(data) == len(stats['wavs'][i]) == n
        assert np.isfinite(stats['wavs'][i]).all()
    assert len(stats['ttfa_seconds']) == 2


def test_serve_cli_has_no_silent_cpu_choice():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: --device cuda is usable')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serve.build_server(['--taco_checkpoint', 'x', '--wave_checkpoint', 'y',
                            '--device', 'cuda'])
