"""HTTP serving front end (standard library only) over a ``ServingEngine``
(the port's own copy of ``serving/server.py``). Endpoints:

  POST /v1/transcribe     {"audio": [floats @16 kHz]} or
                          {"audio_b64": base64(float32 LE)}           ->
                          {"text", "tokens", "queue_ms", "decode_ms",
                           "total_ms", "bucket"}
  GET  /healthz           {"ok": true}
  GET  /metrics           engine.stats() (request, batch and bucket counts,
                          latency percentiles, warmed buckets)

``ThreadingHTTPServer`` gives one handler thread per connection; a handler
blocks only on its own request's future, so concurrency in the HTTP layer
feeds the micro-batcher the way a load balancer would. The engine's dispatch
thread serialises the device work.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from mocov2_whisper_flamingo_torch.serving.engine import ServingEngine, canonical_wav


def _parse_audio(body: dict, seconds: float, sample_rate: int) -> np.ndarray:
    if "audio" in body:
        wav = np.asarray(body["audio"], np.float32)
    elif "audio_b64" in body:
        wav = np.frombuffer(base64.b64decode(body["audio_b64"]), np.float32).copy()
    else:
        raise ValueError("body needs 'audio' (float list) or 'audio_b64'")
    return canonical_wav(wav, seconds=seconds, sample_rate=sample_rate)


def make_handler(engine: ServingEngine, seconds: float = 30.0,
                 sample_rate: int = 16_000, timeout_s: float = 600.0):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, payload: dict) -> None:
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/metrics":
                self._send(200, engine.stats())
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/transcribe":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                wav = _parse_audio(body, seconds, sample_rate)
            except Exception as e:  # any malformed body is the client's fault
                self._send(400, {"error": str(e)})
                return
            try:
                res = engine.transcribe(wav, timeout=timeout_s)
            except Exception as e:  # the decode failed or timed out: report, keep serving
                self._send(503, {"error": str(e)})
                return
            self._send(200, {
                "text": res.text,
                "tokens": [int(t) for t in res.tokens],
                "queue_ms": round(res.queue_ms, 3),
                "decode_ms": round(res.decode_ms, 3),
                "total_ms": round(res.total_ms, 3),
                "bucket": res.bucket,
            })

    return Handler


class TranscriptionServer:
    """Owns the HTTP listener; ``serve_forever`` runs in a background thread
    so tests (and the command's signal handling) stay in control."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0, seconds: float = 30.0,
                 sample_rate: int = 16_000):
        self.engine = engine
        self._httpd = ThreadingHTTPServer(
            (host, port), make_handler(engine, seconds, sample_rate))
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> "TranscriptionServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
