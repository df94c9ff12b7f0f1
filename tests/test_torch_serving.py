"""The port's HTTP vocoder server on CPU at a small config."""

import http.client
import io
import json
import wave

import numpy as np
import pytest
import torch

from fastdiff_tpu_torch.serving.server import VocoderService, start_server
from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import FastDiffVocoder

HP = {"inner_channels": 8, "cond_channels": 16, "upsample_ratios": [4, 2, 2],
      "kpnet_hidden_channels": 8, "diffusion_step_embed_dim_in": 16,
      "diffusion_step_embed_dim_mid": 32, "diffusion_step_embed_dim_out": 32,
      "compute_dtype": "float32", "audio_num_mel_bins": 16,
      "audio_sample_rate": 22050, "N": 4, "seed": 3}
HOP = 16


@pytest.fixture(scope="module")
def server():
    service = VocoderService(dict(HP), device="cpu")
    httpd, thread = start_server(service)
    service.warmup(frames=4)
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def test_healthz(server):
    status, _, body = _request(server, "GET", "/healthz")
    assert status == 200 and json.loads(body) == {"warm": True}


def test_vocode_and_metrics(server):
    mel = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, mel)
    status, ctype, body = _request(server, "POST", "/vocode", buf.getvalue())
    assert status == 200 and ctype == "audio/wav"
    with wave.open(io.BytesIO(body)) as wav:
        assert wav.getframerate() == 22050 and wav.getnchannels() == 1
        assert wav.getnframes() == 8 * HOP
    status, _, body = _request(server, "GET", "/metrics")
    metrics = json.loads(body)
    assert status == 200 and metrics["requests_ok"] >= 1
    assert metrics["audio_seconds"] > 0


def test_bad_mel_is_400(server):
    buf = io.BytesIO()
    np.save(buf, np.zeros((8, 7), np.float32))
    status, _, body = _request(server, "POST", "/vocode", buf.getvalue())
    assert status == 400 and b"mel bins" in body


def test_vocoder_loads_checkpoint(tmp_path):
    """``vocoder_ckpt`` names a saved state_dict; the vocoder serves it."""
    seeded = FastDiffVocoder(dict(HP), device="cpu")
    path = tmp_path / "fastdiff.pt"
    sd = {k: v + 0.01 for k, v in seeded.model.state_dict().items()}
    torch.save(sd, path)
    loaded = FastDiffVocoder(dict(HP, vocoder_ckpt=str(path)), device="cpu")
    for name, value in loaded.model.state_dict().items():
        torch.testing.assert_close(value, sd[name], rtol=0, atol=0)
    wav = loaded.spec2wav(np.zeros((4, 16), np.float32))
    assert wav.shape == (4 * HOP,) and np.isfinite(wav).all()
