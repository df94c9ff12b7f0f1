"""HTTP vocoder server: mel in, WAV out (``fastdiff_tpu/serving/server.py``).

Requests carry a mel spectrogram as an ``.npy`` body, shape (T, n_mels) or
(n_mels, T), float32; the response is a 16-bit PCM WAV of T * hop samples.
Vocode requests are serialized on the device and at most ``max_queue`` may
wait; beyond that the server answers 503 with ``Retry-After``. Connections
are handled on threads, so health and metrics probes answer during a long
vocode.

    python -m fastdiff_tpu_torch.serving.server --device cuda --port 8300 \
        --config fastdiff_tpu/configs/ljspeech.yaml --hparams 'N=4'
    python -m fastdiff_tpu_torch.serving.server --hparams '{"N": 4}'

With ``--config`` (or ``--exp_name``) the hparams come from the YAML cascade
(``utils/hparams.py:set_hparams``, as JAX's server reads them) and
``--hparams`` holds ``a=1,b=2`` overrides; without either, ``--hparams`` is
the whole hparams dict as a JSON object.

``use_pallas_block`` in the hparams picks the route (``ncl_fh``, true for
the NWC route with ``use_pallas_down``, false for the plain route); see
``vocoders/fastdiff_vocoder.py``. The vocoder runs a mel frame count's
first request eagerly, captures one CUDA graph of the sampler on its
second and replays it from then on; ``--max_graphs`` bounds how many frame
counts are kept (least recently used evicted), and warm-up runs the
warm-up shape twice, so that it is captured.

Endpoints:
    POST /vocode    body: .npy mel -> audio/wav (503 while cold or full)
    GET  /healthz   200 once the model is warm
    GET  /metrics   JSON: request counts, queue depth, RTF, audio seconds,
                    graphs_cached, graph_captures, graph_warmups,
                    graph_evictions and graph_recaptures (counts), and
                    queue_wait_seconds (summed time requests waited for
                    the device; a ``server.queue_wait`` span under
                    ``torch.profiler``)
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from fastdiff_tpu_torch.utils.hparams import set_hparams
from fastdiff_tpu_torch.utils.profiling import span
from fastdiff_tpu_torch.vocoders.base import get_vocoder_cls


class VocoderService:
    """Wraps a vocoder built from a plain hparams dict on ``device`` (the
    CUDA card unless the caller names another; no card raises).

    ``max_queue`` bounds how many vocode requests may wait on the device
    lock; an over-limit request raises ``Busy`` (mapped to 503).
    ``max_graphs`` bounds the sampler's cache of CUDA graphs."""

    class Busy(RuntimeError):
        pass

    def __init__(self, hparams: dict, device="cuda", max_queue: int = 4,
                 max_graphs: int = 8):
        self.hparams = hparams
        self.sample_rate = int(hparams.get("audio_sample_rate", 22050))
        self.num_mels = int(hparams.get("audio_num_mel_bins", 80))
        self.vocoder = get_vocoder_cls(hparams)(hparams, device=device,
                                                max_graphs=max_graphs)
        self.max_queue = max_queue
        self._lock = threading.Lock()
        self._depth_lock = threading.Lock()
        self.queue_depth = 0
        self.warm = False
        self.requests_ok = 0
        self.requests_rejected = 0
        self.requests_failed = 0
        self.gen_seconds = 0.0
        self.audio_seconds = 0.0
        self.queue_wait_seconds = 0.0

    def warmup(self, frames: int = 128):
        """Vocode ``frames`` of silence twice: the first run builds the
        kernels, the second captures the shape's graph."""
        for _ in range(2):
            self._vocode_locked(np.zeros((frames, self.num_mels), np.float32))
        self.warm = True

    def vocode(self, mel: np.ndarray) -> np.ndarray:
        with self._depth_lock:
            if self.queue_depth >= self.max_queue:
                self.requests_rejected += 1
                raise self.Busy(
                    f"queue full ({self.queue_depth}/{self.max_queue})")
            self.queue_depth += 1
        try:
            return self._vocode_locked(mel)
        finally:
            with self._depth_lock:
                self.queue_depth -= 1

    def _vocode_locked(self, mel: np.ndarray) -> np.ndarray:
        if mel.ndim != 2:
            raise ValueError(f"mel must be 2-D, got {mel.shape}")
        if mel.shape[1] != self.num_mels and mel.shape[0] == self.num_mels:
            mel = mel.T                       # accept (n_mels, T) too
        if mel.shape[1] != self.num_mels:
            raise ValueError(f"expected {self.num_mels} mel bins, "
                             f"got shape {mel.shape}")
        waited = time.perf_counter()
        with span("server.queue_wait"):
            self._lock.acquire()              # one device: serialize
        try:
            t0 = time.perf_counter()
            self.queue_wait_seconds += t0 - waited
            wav = self.vocoder.spec2wav(mel.astype(np.float32))
            self.gen_seconds += time.perf_counter() - t0
            self.audio_seconds += len(wav) / self.sample_rate
            return wav
        finally:
            self._lock.release()

    def metrics(self) -> dict:
        gen = self.gen_seconds
        return {
            "warm": self.warm,
            "queue_depth": self.queue_depth,
            "max_queue": self.max_queue,
            "requests_ok": self.requests_ok,
            "requests_rejected": self.requests_rejected,
            "requests_failed": self.requests_failed,
            "audio_seconds": round(self.audio_seconds, 3),
            "gen_seconds": round(gen, 3),
            "x_realtime": round(self.audio_seconds / gen, 2) if gen else None,
            "graphs_cached": self.vocoder.sampler.graphs_cached,
            "graph_captures": self.vocoder.sampler.captures,
            "graph_warmups": self.vocoder.sampler.warmups,
            "graph_evictions": self.vocoder.sampler.evictions,
            "graph_recaptures": self.vocoder.sampler.recaptures,
            "queue_wait_seconds": round(self.queue_wait_seconds, 6),
        }


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """Float waveform -> 16-bit PCM mono WAV (x 32767, clipped)."""
    pcm = (np.clip(np.asarray(wav, np.float32), -1.0, 1.0) * 32767.0
           ).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as out:
        out.setnchannels(1)
        out.setsampwidth(2)
        out.setframerate(sample_rate)
        out.writeframes(pcm.tobytes())
    return buf.getvalue()


def make_handler(service: VocoderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # quiet default stderr spam
            pass

        def _send(self, code: int, body: bytes, ctype: str,
                  headers: dict | None = None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for key, val in (headers or {}).items():
                self.send_header(key, val)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj, headers: dict | None = None):
            self._send(code, json.dumps(obj).encode(), "application/json",
                       headers)

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200 if service.warm else 503,
                                {"warm": service.warm})
            elif self.path == "/metrics":
                self._send_json(200, service.metrics())
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/vocode":
                self._send(404, b"not found", "text/plain")
                return
            if not service.warm:
                self._send_json(503, {"error": "not warm"},
                                {"Retry-After": "10"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                mel = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
                wav = service.vocode(mel)
                service.requests_ok += 1
                self._send(200, wav_bytes(wav, service.sample_rate),
                           "audio/wav")
            except service.Busy as e:        # backpressure, not an error
                self._send_json(503, {"error": str(e)}, {"Retry-After": "5"})
            except Exception as e:           # report, never crash the server
                service.requests_failed += 1
                self._send_json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def start_server(service: VocoderService, host: str = "127.0.0.1",
                 port: int = 0):
    """Serve on a daemon thread; returns (httpd, thread). ``port=0`` picks
    a free port (``httpd.server_address[1]``). Stop with
    ``httpd.shutdown(); httpd.server_close()``."""
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


def serve(hparams: dict, device="cuda", host: str = "0.0.0.0",
          port: int = 8300, warmup_frames: int = 128, max_queue: int = 4,
          max_graphs: int = 8):
    service = VocoderService(hparams, device=device, max_queue=max_queue,
                             max_graphs=max_graphs)
    # listen before warmup so /healthz answers 503 while the kernels build
    httpd, thread = start_server(service, host, port)
    print(f"| vocoder server on {host}:{port} ({device}); warming up...")
    service.warmup(warmup_frames)
    print("| warm; serving.")
    thread.join()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="")
    parser.add_argument("--exp_name", type=str, default="")
    parser.add_argument("--hparams", type=str, default="",
                        help="with --config / --exp_name: 'a=1,b=2' "
                        "overrides; without: hparams as a JSON object")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8300)
    parser.add_argument("--max_queue", type=int, default=4)
    parser.add_argument("--max_graphs", type=int, default=8,
                        help="mel frame counts whose sampler runner (and "
                        "CUDA graph) is kept")
    args = parser.parse_args(argv)
    if args.config or args.exp_name:
        hp = set_hparams(config=args.config, exp_name=args.exp_name,
                         hparams_str=args.hparams)
    else:
        hp = json.loads(args.hparams or "{}")
    serve(hp, device=args.device, host=args.host,
          port=args.port, max_queue=args.max_queue,
          max_graphs=args.max_graphs)


if __name__ == "__main__":
    main()
