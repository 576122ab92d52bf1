"""Streaming TTS HTTP service: text in, waveform chunks out while the vocoder is still
generating (the port's copy of `tacotron2_tpu/inference/server.py`, which the port
cannot import: that package's `inference/__init__.py` imports jax).

Framework-free, and byte for byte the JAX package's behaviour:
  - One device, one AR stream: generation is serialized behind a lock; concurrent
    requests queue (bounded by `max_waiters`, then 503).
  - The synthesizer is injected as `stream_fn(text, seed) -> iter[np.float32]`;
    tests drive the full HTTP path with a fake, and `serve.py` binds the port's
    StreamingSynthesizer.
  - HTTP/1.1 chunked transfer, so a client starts playback on the first chunk. WAV
    streaming uses the unknown-length convention (RIFF/data sizes 0xFFFFFFFF);
    pcm16 and f32 raw formats skip the header.
"""

import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterator, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

StreamFn = Callable[[str, int], Iterator[np.ndarray]]

_STREAM_SIZE = 0xFFFFFFFF  # RIFF "unknown length" convention for live streams


def wav_stream_header(sample_rate: int, bits: int = 16, channels: int = 1) -> bytes:
    """44-byte PCM WAV header with streaming (unknown) sizes."""
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    return b'RIFF' + struct.pack('<I', _STREAM_SIZE) + b'WAVEfmt ' + struct.pack(
        '<IHHIIHH', 16, 1, channels, sample_rate, byte_rate, block_align, bits
    ) + b'data' + struct.pack('<I', _STREAM_SIZE)


def float_to_pcm16(x: np.ndarray) -> bytes:
    return (np.clip(np.asarray(x, np.float32), -1.0, 1.0) * 32767.0).astype(
        '<i2').tobytes()


class TTSServer:
    """HTTP front-end for a streaming synthesizer.

    GET /healthz                 -> JSON {ok, sample_rate, busy, served}
    GET /tts?text=...&seed=0&format=wav|pcm16|f32
                                 -> chunked audio stream
    POST /tts  (JSON {text, seed, format})
    """

    def __init__(self, stream_fn: StreamFn, sample_rate: int,
                 host: str = '127.0.0.1', port: int = 0, max_waiters: int = 8,
                 max_text_len: int = 2000):
        self._stream_fn = stream_fn
        self.sample_rate = sample_rate
        self._gen_lock = threading.Lock()
        self._waiters = 0
        self._stats_lock = threading.Lock()
        self.max_waiters = max_waiters
        self.max_text_len = max_text_len
        self.served = 0
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    @property
    def address(self):
        return self._httpd.server_address  # (host, port) — port resolved if 0

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self._httpd.serve_forever()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # ------------------------------------------------------------------
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = 'HTTP/1.1'  # required for chunked encoding

            def log_message(self, fmt, *args):  # quiet; stats via /healthz
                pass

            # -- helpers ------------------------------------------------
            def _json(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _chunk(self, data: bytes):
                self.wfile.write(f'{len(data):X}\r\n'.encode())
                self.wfile.write(data)
                self.wfile.write(b'\r\n')

            # -- endpoints ---------------------------------------------
            def do_GET(self):
                url = urlparse(self.path)
                if url.path == '/healthz':
                    busy = server._gen_lock.locked()
                    return self._json(200, dict(
                        ok=True, sample_rate=server.sample_rate, busy=busy,
                        waiters=server._waiters, served=server.served))
                if url.path == '/tts':
                    q = parse_qs(url.query)
                    return self._tts(
                        text=(q.get('text') or [''])[0],
                        seed=int((q.get('seed') or ['0'])[0]),
                        fmt=(q.get('format') or ['wav'])[0])
                self._json(404, dict(ok=False, error='not found'))

            def do_POST(self):
                url = urlparse(self.path)
                if url.path != '/tts':
                    return self._json(404, dict(ok=False, error='not found'))
                try:
                    n = int(self.headers.get('Content-Length', 0))
                    req = json.loads(self.rfile.read(n) or b'{}')
                except (ValueError, json.JSONDecodeError):
                    return self._json(400, dict(ok=False, error='bad JSON body'))
                return self._tts(text=req.get('text', ''),
                                 seed=int(req.get('seed', 0)),
                                 fmt=req.get('format', 'wav'))

            def _tts(self, text: str, seed: int, fmt: str):
                if not text:
                    return self._json(400, dict(ok=False, error='empty text'))
                if len(text) > server.max_text_len:
                    return self._json(400, dict(
                        ok=False, error=f'text over {server.max_text_len} chars'))
                if fmt not in ('wav', 'pcm16', 'f32'):
                    return self._json(400, dict(ok=False, error=f'bad format {fmt!r}'))
                with server._stats_lock:
                    if server._waiters >= server.max_waiters:
                        return self._json(503, dict(ok=False, error='queue full'))
                    server._waiters += 1
                try:
                    with server._gen_lock:  # one AR stream on the device at a time
                        self.send_response(200)
                        self.send_header('Content-Type',
                                         'audio/wav' if fmt == 'wav'
                                         else 'application/octet-stream')
                        self.send_header('Transfer-Encoding', 'chunked')
                        self.send_header('X-Sample-Rate', str(server.sample_rate))
                        self.end_headers()
                        if fmt == 'wav':
                            self._chunk(wav_stream_header(server.sample_rate))
                        for chunk in server._stream_fn(text, seed):
                            data = (np.asarray(chunk, np.float32).tobytes()
                                    if fmt == 'f32' else float_to_pcm16(chunk))
                            if data:
                                self._chunk(data)
                        # count completion before the terminator write: the client
                        # may hang up the moment it has the last audio chunk
                        with server._stats_lock:
                            server.served += 1
                        self._chunk(b'')  # terminator: _chunk emits "0\r\n" + "\r\n"
                except BrokenPipeError:
                    pass  # client hung up mid-stream; nothing to clean up
                finally:
                    with server._stats_lock:
                        server._waiters -= 1

        return Handler
