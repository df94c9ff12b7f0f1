"""The readings that the limits of ``correct`` of a ``tts`` cell are set
from, on the card:

    python3 portbench/control_tts.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--out <file.jsonl>]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` at its load, then, over the sentences a run compares, the
program's readings against the plain reference (the lower readings) and the
control's (the upper readings): ``ControlTask``, the reference in the
program's place with FastSpeech 2's product operands and results rounded to
bfloat16, the precision below the configuration's float32, taking its own
decisions, into the reference vocoder with every product in per-tensor
scaled float8 e4m3 (``control.py``'s control of the vocoder cells), held to
the same reference from the same tokens and noise. Besides the compared
values, the worst gaps of the continuous values behind each decision (the
bands of ``decision_bands`` come from the program's). One JSON line a seed.
"""

import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.harness import resolve  # noqa: E402
from portbench.reference import common, diffusion, fastdiff  # noqa: E402
from portbench.reference import fastspeech2 as fs2ref  # noqa: E402


class ControlTask:
    """The plain reference in the place of the port's task, with the text-to-
    wav entry's contract: FastSpeech 2 in bfloat16 at ``t_mel =
    max_frames`` taking its own decisions, the mel zero-padded to its
    bucket, the call's generator drawn in DDPM's order, the vocoder in
    float8, the waveform trimmed."""

    def __init__(self, hp: dict, weights: dict, device):
        self.hp, self.device = hp, torch.device(device)
        self.acoustic, self.vocoder = fs2ref.split(weights)
        self.bucket = int(hp["infer_frame_bucket"])
        self.hop = int(hp["hop_size"])
        self.counters = {"calls": 0, "tokens": 0, "frames": 0}
        self._vocoder = types.SimpleNamespace(
            sampler=types.SimpleNamespace(warmups=0, captures=0))
        self.acoustic_graphs = types.SimpleNamespace(warmups=0, captures=0)

    def tts_vocoder(self):
        return self._vocoder

    def synthesize(self, state, tokens, generator=None):
        hp, dev = self.hp, self.device
        with torch.inference_mode(), common.exact_float32():
            tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                     device=dev)[None]
            ref = fs2ref.forward(self.acoustic, hp, tokens, fs2ref.bf16_round)
            frames = int(ref["mel_mask"][0].sum())
            padded = -(-frames // self.bucket) * self.bucket
            shape = (1, padded * self.hop, 1)
            x_t = torch.empty(shape, device=dev).normal_(generator=generator)
            zs = [torch.empty(shape, device=dev).normal_(
                generator=generator)[..., 0] for _ in range(int(hp["N"]) - 1)]
            mel = torch.zeros(1, padded, int(hp["audio_num_mel_bins"]),
                              device=dev)
            mel[0, :frames] = ref["mel"][0, :frames]
            wav = diffusion.reverse(fastdiff.forward, self.vocoder, hp, mel,
                                    x_t[..., 0], zs, common.fp8_round)
        self.counters["calls"] += 1
        self.counters["tokens"] += tokens.shape[1]
        self.counters["frames"] += frames
        out = {"dur_pred": ref["d"], "mel2ph": ref["mel2ph"],
               "f0_pred": ref["f0"], "uv_pred": ref["uv"],
               "f0_denorm": fs2ref.f0_hz(ref["f0"], ref["uv"],
                                         ref["mel_mask"]),
               "mel": ref["mel"], "mel_mask": ref["mel_mask"]}
        return wav[0, : frames * self.hop].cpu().numpy(), out


def control_kept(driver, kept: list) -> list:
    """The control's sentences from the same tokens and noise as ``kept``."""
    from portbench.drivers.tts import record
    task = ControlTask(driver.hp, driver.weights, driver.device)
    gen = torch.Generator(device=driver.device)
    out = []
    for k in kept:
        gen.manual_seed(k.noise_seed)
        wav, fwd = task.synthesize(None, k.tokens, generator=gen)
        out.append(record(k.noise_seed, k.tokens,
                          driver.padded(len(wav) // driver.hop), wav, fwd))
    return out


def readings(driver) -> dict:
    kept = driver.sample()
    program, program_gaps = driver.compare(kept)
    control, control_gaps = driver.compare(control_kept(driver, kept))
    line = {"compared": len(kept),
            "longest_frames": max(k.mel.shape[0] for k in kept)}
    for name, value in {**program, **program_gaps}.items():
        line[f"program_{name}"] = value
    for name, value in {**control, **control_gaps}.items():
        line[f"control_{name}"] = value
    return line


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("control_tts: no CUDA card", file=sys.stderr)
        return 2
    _, cell, config, traffic = resolve(ROOT, args.workload)
    from portbench.drivers.tts import Driver
    for seed in args.seeds:
        t0 = time.perf_counter()
        driver = Driver(config, traffic, seed, torch.device("cuda:0"))
        driver.setup()
        calls = driver.window(args.seconds, False)
        driver.free_program()
        line = dict(workload=args.workload, seed=seed, calls=len(calls),
                    attempted=driver.attempted, failed=driver.failed,
                    frames=[min(c.frames[0] for c in calls),
                            max(c.frames[0] for c in calls)],
                    **readings(driver), seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
