"""Per-request latency of the port's HTTP vocoder server on a stream of mel
frame counts, as speech requests arrive.

    python -m fastdiff_tpu_torch.scripts.serve_lengths [--route ncl]
        [--distinct 24] [--repeating 24] [--counts 4] [--seed 0]

Builds ``serving/server.py:VocoderService`` (N = 4, seed-0 random weights
at full width) on the card, serves it on 127.0.0.1, warms it up with its
own warm-up, then POSTs two streams of random mels (normal, mean -4) and
times each request on the client's clock (request sent to WAV read):

- ``distinct``: ``--distinct`` requests, every frame count different,
  drawn from 86-864 frames (1-10 s of audio at hop 256 and 22.05 kHz);
- ``repeating``: ``--repeating`` requests whose frame counts are drawn
  with replacement from ``--counts`` counts of the same range.

Prints one JSON object: per stream every request's (frames, ms), the mean,
median, 90th percentile and largest ms, audio seconds over wall seconds,
and the server's ``/metrics`` after the stream, with the card's name and
``nvidia-smi``'s name and power limit. It uses only what the server module
has had since before the graph sampler, so the same script times a tree
without it.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import subprocess
import time

import numpy as np
import torch

from fastdiff_tpu_torch.serving.server import VocoderService, start_server

HOP, SAMPLE_RATE, N_MELS = 256, 22050, 80
MIN_FRAMES, MAX_FRAMES = 86, 864


def _post(port: int, path: str, body: bytes | None = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST" if body is not None else "GET", path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _stream(port: int, counts, rng) -> dict:
    rows = []
    for frames in counts:
        mel = (rng.normal(size=(int(frames), N_MELS)) - 4.0).astype(
            np.float32)
        buf = io.BytesIO()
        np.save(buf, mel)
        t0 = time.perf_counter()
        status, data = _post(port, "/vocode", buf.getvalue())
        ms = (time.perf_counter() - t0) * 1e3
        if status != 200:
            raise RuntimeError(f"/vocode {frames} frames: HTTP {status} "
                               f"{data[:200]!r}")
        rows.append((int(frames), ms))
    ms = np.array([r[1] for r in rows])
    audio_s = sum(r[0] for r in rows) * HOP / SAMPLE_RATE
    _, metrics = _post(port, "/metrics")
    return {"requests": rows, "mean_ms": float(ms.mean()),
            "p50_ms": float(np.percentile(ms, 50)),
            "p90_ms": float(np.percentile(ms, 90)),
            "max_ms": float(ms.max()),
            "x_realtime": audio_s / (ms.sum() / 1e3),
            "metrics": json.loads(metrics)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--route", default="ncl",
                        choices=("ncl", "ncl_fh", "nwc", "plain"))
    parser.add_argument("--distinct", type=int, default=24)
    parser.add_argument("--repeating", type=int, default=24)
    parser.add_argument("--counts", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    block = {"ncl": "auto", "ncl_fh": "ncl_fh", "nwc": True,
             "plain": False}[args.route]
    hp = {"N": 4, "seed": 1234, "use_pallas_block": block,
          "use_pallas_down": args.route == "nwc"}
    service = VocoderService(hp, device="cuda")
    httpd, thread = start_server(service, "127.0.0.1", 0)
    port = httpd.server_address[1]
    try:
        t0 = time.perf_counter()
        service.warmup()
        warmup_s = time.perf_counter() - t0
        rng = np.random.default_rng(args.seed)
        span = np.arange(MIN_FRAMES, MAX_FRAMES + 1)
        distinct = rng.choice(span, args.distinct, replace=False)
        pool = rng.choice(span, args.counts, replace=False)
        repeating = rng.choice(pool, args.repeating, replace=True)
        report = {"device": torch.cuda.get_device_name(0),
                  "smi": subprocess.run(
                      ["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip(),
                  "route": args.route, "warmup_s": warmup_s,
                  "distinct": _stream(port, distinct, rng),
                  "repeating": _stream(port, repeating, rng)}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
