"""The graph sampler's short, launch-bound callers of two source trees raced
on one card.

    python -m fastdiff_tpu_torch.scripts.race_sampler_paths OTHER_TREE
        [--reps 20] [--steps 4 200 1000]

``OTHER_TREE`` is another checkout of the repository, as for
``race_trees`` (for a parent commit: ``git archive <commit> | tar -x -C
build/parent``). The same probe runs in a process of its own from each
tree in turns (other, this, this, other), through names both trees have:

- ``VocoderService({"N": 4, "seed": 1234}).vocode`` of 100 and 256 frames
  (the server's request shapes), after the shape's eager first call and
  its capture;
- ``StreamingVocoder`` on the vocoder's graph sampler at (chunk, halo)
  (48, 8) and (32, 8): one chunk a ``feed`` of its core frames;
- ``FastSpeech2Task.infer_to_wav`` of one sentence at
  ``fs2_ljspeech.yaml``'s widths, seed-0 weights, the FastDiff vocoder
  at N = 4;
- the vocoder's sampler alone at 864 frames, a vocoder of its own for
  each N of ``--steps`` (an N named twice gets two, ``#1`` and ``#2``).

Each is timed as a mean over ``--reps`` calls after two untimed ones
(the shape's eager first call and its capture): the requests, chunks and
``infer_to_wav`` by the host's clock (each ends in a copy of the
waveform to the host), the sampler by CUDA events. Prints one JSON
object: ms a call of each tree (the mean of its two runs, and the runs),
with the card's name and power limit. Needs the card and the CUDA
toolkit.
"""

from __future__ import annotations

import argparse
import json
import pathlib

from fastdiff_tpu_torch.scripts.race_trees import turns

PROBE = r"""
import json, os, sys, tempfile, time
import numpy as np
import torch
from fastdiff_tpu_torch.diffusion.sampler import inference_generator
from fastdiff_tpu_torch.serving.server import VocoderService
from fastdiff_tpu_torch.serving.streaming_vocoder import StreamingVocoder
from fastdiff_tpu_torch.text.encoder import build_token_encoder
from fastdiff_tpu_torch.text.processors import get_txt_processor_cls
from fastdiff_tpu_torch.training.tts_task import FastSpeech2Task
from fastdiff_tpu_torch.utils.hparams import set_hparams
from fastdiff_tpu_torch.utils.timing import cuda_ms

reps = int(sys.argv[1])
steps = [int(n) for n in sys.argv[2].split(",")]
dev = torch.device("cuda", 0)
rng = np.random.default_rng(0)
ms = {}

def wall_ms(fn):
    fn()
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps

service = VocoderService({"N": 4, "seed": 1234}, device=dev)
for frames in (100, 256):
    mel = rng.standard_normal((frames, 80)).astype(np.float32) - 4.0
    ms[f"server request {frames} frames"] = wall_ms(
        lambda: service.vocode(mel))

voc = service.vocoder
for chunk, halo in ((48, 8), (32, 8)):
    core = chunk - 2 * halo
    stream = StreamingVocoder(voc.sample, 256, chunk_frames=chunk,
                              halo_frames=halo,
                              generator=inference_generator(0, dev))
    stream.feed(rng.standard_normal((core + halo, 80)).astype(np.float32))
    piece = rng.standard_normal((core, 80)).astype(np.float32)
    ms[f"stream chunk {chunk}/{halo}"] = wall_ms(lambda: stream.feed(piece))

root = tempfile.mkdtemp(prefix="race_sampler_paths_")
phones = get_txt_processor_cls("en").process(
    "The examination and testimony of the experts enabled the commission "
    "to conclude.")[0]
with open(os.path.join(root, "phone_set.json"), "w") as f:
    json.dump(sorted(set(phones)), f)
hp = set_hparams(config=os.path.join("fastdiff_tpu", "configs",
                                     "fs2_ljspeech.yaml"),
                 hparams_str=f"binary_data_dir={root},N=4",
                 print_hparams=False, global_hparams=False)
tokens = np.asarray(build_token_encoder(os.path.join(
    root, "phone_set.json")).encode(" ".join(phones)))
task = FastSpeech2Task(hp, device=dev)
state = task.build_state(seed=0)
state.model.eval()
ms["infer_to_wav"] = wall_ms(lambda: task.infer_to_wav(state, tokens, ""))

for i, n in enumerate(steps):
    service = VocoderService({"N": n, "seed": 1234}, device=dev)
    mel = torch.from_numpy(rng.standard_normal((1, 864, 80)).astype(
        np.float32) - 4.0)
    gen = torch.Generator(device=dev).manual_seed(1)
    sample = lambda: service.vocoder.sample(gen, mel, 864 * 256)
    sample()
    name = f"sampler 864 frames N={n}"
    if steps.count(n) > 1:
        name += f" #{steps[:i].count(n) + 1}"
    ms[name] = cuda_ms(sample, 2 if n > 4 else reps)
print("RESULT " + json.dumps({"ms": ms}))
"""


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=pathlib.Path)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--steps", type=int, nargs="+",
                        default=[4, 200, 1000])
    args = parser.parse_args()
    print(json.dumps(turns(args.other, PROBE, [
        str(args.reps), ",".join(map(str, args.steps))], timeout=900),
        indent=1))


if __name__ == "__main__":
    main()
