#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100, sm_90a).

    python3 chip_smoke.py

Drives ``fastdiff_tpu_torch`` on the card, one line per phase:

1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit (fails when no CUDA device is present: nothing falls back
   to the CPU);
2. builds the CUDA kernels from ``fastdiff_tpu_torch/csrc`` (``nvcc``) and
   prints the build time, each kernel's registers / spills, the head
   GEMM's (K3 and K7) shared memory and persistent grid at 864 frames, and
   the tensor-core Kernel B's (K1, K2) registers and spills and its tile,
   waves and shared memory at each hop, K9 ``lvc_stage``'s and
   ``conv_stage``'s tensor-core kernels' registers, spills and shared
   memory (``conv_stage``'s also its ring stages and its grid at 221,184
   rows), the tensor-core K5's two
   instantiations (with and without the epilogue; no cluster) and its
   tile, head frames, grid, shared memory and reckoned w_head bytes at each
   hop, the tensor-core K6's registers, tile and shared memory, the
   tensor-core K4's two instantiations (hop 8 and the others) and its tile
   at each recipe hop, and K8's two stage kernels with their grids and
   shared memory at 10 s (fails on any spill of any of these);
3. Kernel A (predictor head GEMM, wgmma + TMA) against its plain PyTorch
   version at K = 192, N = 4 * 64 * rows_p and every row count its paths
   give it (M = 100, 256 and 864 frames, 20 x 100 in training, 4 x 864),
   within one bf16 ulp of the largest output; timed against ``torch.addmm``
   raced in turns (CUDA-graph replay: device time alone), with the
   achieved TB/s and share of the bound at each M;
4. Kernel B (LVC block) on the tensor cores against its plain version,
   at hops 8, 64 and 256 with 864 frames (hop 256 with and without the
   final-conv epilogue), and at 100 frames of hop 8 (a block the JAX
   kernel cannot tile); the two timed in turns (the kernel by CUDA-graph
   replay), with the tensor cores' share of the bound;
5. a full-width bf16 denoiser forward at 864 frames, kernel path against
   plain path, bounded by a relative L2 error;
6. the N=4 sampler on 10 s of audio (864 frames, 221,184 samples, b = 1),
   kernel and plain paths, each as a CUDA graph (``make_sampler``) raced
   in turns against the eager loop with CUDA events;
7. the port's HTTP server on 127.0.0.1 (the NCL route): three mels of 100,
   256 and 864 frames, each sent three times (the frame count's first
   request runs eagerly, the second captures its CUDA graph, the third
   replays it), each answered with a WAV of frames * 256 finite samples,
   each raising Kernel A's launch count by exactly 3 blocks x 4 steps,
   K1's by 8, K2's by 4 and K8's (the NCL layout) by 4 at 256 and 864
   frames, 0 at 100 (not a multiple of 2,048 samples: the module chain)
   (a replay adds the launches its graph holds, which phase 20 holds
   against a profile of a replay);
8. Kernel B-SR (K4, the training block, which also writes s, y and z) on
   the tensor cores against its plain version at the training recipe's
   shapes (b = 20, 100 frames, hops 8, 64 and 256), with phase 4's bounds
   on out, s, y and z; the two timed in turns (the kernel by CUDA-graph
   replay), with the tensor cores' share of each hop's bound;
9. gradients on the card at the hop-256 recipe shape, bf16: the
   saved-residual block (``LVCBlockSR``), the recompute block
   (``LVCBlockRecompute``) and the trainable head (``TaugHead``) against
   autograd through their plain versions (relative L2 <= 5e-2 each);
10. one full-width train step (loss, backward, clip, AdamW) on a fixed
    batch of 20 x 25,600 samples through ``FastDiffTask.train_step``, the
    ``ncl_sr``, ``ncl_vjp``, ``nwc_vjp`` (``use_pallas_block: true``) and
    ``plain`` routes raced in turns with CUDA events: ms per step, peak
    memory, loss and gradient norm, and the kernel routes' gradients
    against the plain route's; one ``nwc_vjp`` step launches K7 and the
    tensor-core K6 exactly twice each and no other kernel;
11. ``Trainer(task, work_dir).fit()`` on a synthetic binarized dataset (24
    train and 4 valid items of 120-200 frames, written to a temporary
    directory): 6 updates at the recipe's batch with validation and a
    checkpoint every 3, then a second ``fit`` to 8 that resumes from step
    6; every train step launches Kernel A and Kernel B-SR exactly 3
    times;
12. K7 (the NWC route's row-major head GEMM, the same kernel) against its
    plain version at 256 and 864 x 192 @ 192 x 24,832, as phase 3;
13. K6 (the NWC LVC block) on the tensor cores against its plain version,
    at hops 64 and 256 with 864 frames and at b = 2 x 100 frames of hop 64
    (a multi-tile edge case), with phase 4's bounds; the two timed in
    turns (the kernel by CUDA-graph replay), with the tensor cores' share
    of the bound;
14. K8 (the fused down path, two launches), each layout against its plain
    version: NWC at 221,184 samples (b = 1) and at two 2,048-sample halo
    units (b = 2); NCL (the ncl route's cast points, against its module
    chain) at those and at the offline cell's b 16 x 896 frames; each
    output within 4 bf16 ulps of its largest value, timed by CUDA-graph
    replay in turns with the plain version (the NCL chain also replayed),
    with its share of the bound;
15. the NWC route (``use_pallas_block: true``, ``use_pallas_down: true``):
    a full-width bf16 denoiser forward, kernels against plain (relative L2
    <= 5e-2); the N=4 sampler at 864 frames, kernel and plain paths as
    CUDA graphs raced against the eager loop; the HTTP server built from
    those hparams answering
    100, 256 and 864 frames, each request raising K6 and K7 by exactly 8,
    K8 by 4 (256 and 864 frames) or 0 (100 frames: not a multiple of
    2,048 samples, so the plain down path runs, as in JAX), K1 and K3 by 0.

16. K5 (the fused-head LVC block) on the tensor cores against its plain
    version, at hops 8, 64 and 256 with 864 frames (hop 256 with the
    final-conv epilogue too) and at b = 2 x 100 frames of hop 64, with
    phase 4's bounds; raced by CUDA-graph replay against K3 + K1 on the
    same inputs, with its share of the bound;
17. the fused-head route (``use_pallas_block: ncl_fh``): a full-width bf16
    denoiser forward, kernels against plain (relative L2 <= 5e-2) and
    against the NCL route; the N=4 sampler at 864 frames, b = 1 and b = 4,
    raced against the NCL route as CUDA graphs, the eager loop beside them
    (``scripts/exp_r4b.py``'s experiment D);
    the HTTP server built from ``{"N": 4, "use_pallas_block": "ncl_fh"}``
    answering 100, 256 and 864 frames, each request raising K5 by 8 and K5
    final by 4 at 256 and 864 frames, K1 and K3 by 0; at 100 frames the
    hop-8 block is not fusable (100 % 16 != 0), so K5 +4, K5 final +4, K1
    +4 and K3 +4; K8 as in phase 7; then the server of
    ``use_pallas_block: false`` (the plain route), whose request launches
    no kernel at all;
18. K10 (Kernel A's kernel on the walk of each grid order and M tile of
    ``scripts/exp_r4b.py``'s experiment B) at 100, 256 and 864 rows, every
    variant against its plain version within one bf16 ulp of the largest
    output, each raced against ``torch.addmm`` by CUDA-graph replay, with
    its share of the bound, beside Kernel A raced the same way
    (``fastdiff_tpu_torch/scripts/exp_r4b.py:exp_b``);
19. K9 (the block's conv and LVC stages alone, both on the tensor cores)
    at the hop-256 block's shape against their plain versions
    (``conv_stage`` at every ``tile_s``, ``lvc_stage`` at every ``tf``),
    each setting's output identical to the others', ``conv_stage`` also at
    every ``tile_s`` on a ragged b 2 x 1,000 rows against plain, each
    setting raced against its library call (chained ``torch.matmul``,
    ``torch.bmm``) by CUDA-graph replay, with its share of the bound
    (``fastdiff_tpu_torch/scripts/bench_mosaic_micro.py:run``);
20. the graph sampler (``diffusion/sampler.py:make_sampler``) at full width,
    N = 4, 864 frames, b = 1: on each route (``ncl``, ``nwc`` with the down
    kernel, ``ncl_fh``, ``plain``) the graph against the eager loop with a
    generator of the same seed and with injected noise (relative L2 <=
    1e-6, and whether the bits agree), raced in turns (eager, graph, graph,
    eager) with CUDA events, and one replay profiled (``torch.profiler``):
    the hand-written kernels it ran, counted by name, must equal the
    launches the sampler adds to the counters per replay; the ``ncl`` line
    again at torch's default settings (cuDNN TF32 on, as the vocoder
    runs); a ``load_state_dict`` after capture replayed against the eager
    loop on the new weights with no recapture and every parameter's and
    buffer's storage kept, then ``assign=True``, which must drop the graph
    and capture once more and match again; the chunked vocoder on 3,000
    frames (34.8 s) in chunks of 256 frames (all 14 in one call, so one
    graph of batch 14), with its wall ms per call (first: eager; second:
    capture; third: replay) and ``memory_reserved`` around the capture;
    ``max_graphs`` + 2 frame counts, each sent twice, of which the cache
    keeps ``max_graphs`` with no growth of ``memory_reserved`` past the
    first ``max_graphs``; and a capture that reads the device from the
    host, which must raise and leave nothing cached, followed on the same
    sampler by a good capture whose replay matches the eager loop;
21. the entry path, in a temporary work dir, at the full width of
    ``fastdiff_tpu/configs/ljspeech.yaml`` (N = 4): four synthesized wavs
    of 1.2, 3.0, 3.3 and 10 s (104, 259, 285 and 862 frames; the 3.0 and
    3.3 s files share the 384-frame bucket) and their ``.npy`` mels through
    ``fastdiff_tpu_torch.run.main([... '--infer'])``: every ``_pred.wav``
    of frames * 256 finite samples, K3 +12, K1 +8, K2 +4 and K8 +4 per
    utterance (every bucket a K8 length), one capture for the shared
    bucket, each
    utterance's RTF and the mean; ``use_pallas_block=false`` against
    ``auto`` on the same seed (written wavs, rel L2 <= 5e-2, no kernel
    launched); ``--infer`` on the work dir of a 2-step ``fit`` with an EMA
    (``micro_lj.yaml``, its saved ``config.yaml`` read back); the CLI,
    ``python -m fastdiff_tpu_torch.run``, as a subprocess; no PyYAML
    imported; ``vocoder: GLMel`` on the card against the CPU (3 iterations
    from one phase within 1e-4 rel L2, 60 iterations' spectral
    convergence within 5 %); ``scripts/vocode.py`` on the mel dir;
22. the TTS serving path at the full width of
    ``fastdiff_tpu/configs/fs2_ljspeech.yaml`` (FastSpeech 2 seed-0 weights,
    the FastDiff vocoder's seed weights, N = 4, ``auto``), a phone set
    written from the ``en`` processor's output on four LJSpeech-style
    sentences (23-152 tokens): ``FastSpeech2Task. infer_to_wav`` of each
    (predicted durations): frames, wav length, K3 +12, K1 +8 and K2 +4 per
    call (K8 +4 where the frame count is a multiple of 8, at least 16),
    warm-ups and captures; teacher durations of 6 frames a phone: the
    card's mel against the CPU's (TF32 off, rel L2 <= 1e-4), the predicted
    mel2ph card against CPU (equal); FastSpeech 2 ms (t_mel = max_frames),
    vocoder ms and the RTF of ``infer_to_wav`` on a replayed graph by CUDA
    events; ``python -m fastdiff_tpu_torch.scripts.demo_tts`` as a
    subprocess on the teacher mels against ``TTSPipeline`` with
    ``use_pallas_block: false`` (written wavs, rel L2 <= 5e-2, no kernel
    launched);
23. BDDM and the evaluation tools at the full width of
    ``fastdiff_tpu/configs/ljspeech.yaml`` (seed-0 weights, weight norm
    fused, ``auto`` -> NCL and ``false`` -> plain through
    ``FastDiffTask.inference_model``) on phase 11's synthetic dataset:
    (a) 20 Adam(1e-4) steps of the phi noise predictor at the recipe
    batch (20 x 25,600 samples): ms per step by CUDA events, loss and
    every phi gradient finite, K3 +3, K1 +2 and K2 +1 per step (K8 0: no
    multiple of 2,048 samples); on one batch with injected t and z the
    kernel
    route against the plain route (loss rel 1e-2, phi gradients rel L2
    5e-2) and the plain route on the card (TF32 off) against the CPU (loss
    rel 1e-4); (b) the reverse search for N = 8, 6, 4 and 3 at 864 frames,
    b 1, from one injected x on both routes: each schedule, its length,
    steps and wall, K3 +3 / K1 +2 / K2 +1 / K8 +1 per step (plain: no
    launch),
    the first reverse step's x (rel L2 5e-2) and the first predicted beta
    (rel 5e-2) kernel against plain; (c) every searched and every
    published schedule through ``make_param_sampler`` at 864 frames: ms per
    sample by graph replay (one capture each), K3 3N / K1 2N / K2 N / K8 N
    per replay, MCD, MR-STFT and PESQ against the synthetic wav (seed weights,
    not quality); (d) ``python -m fastdiff_tpu_torch.scripts.demo_vocoder``
    then ``evaluate`` on a 2 s wav, and beside them ``bddm_search
    --phi_steps 5`` on the synthetic dataset, as subprocesses: exit 0,
    their files written (the search's under its work dir) and
    ``docs/BDDM.md`` unchanged;
24. FastSpeech 2 training at the full width of
    ``fastdiff_tpu/configs/fs2_ljspeech.yaml`` (hidden 256, 4 + 4 layers,
    FFN 1024 k 9, ``max_sentences`` 48), TF32 off but for the vocoder:
    (a) 56 synthesized utterances of 1-6 s with ``.txt`` sidecars through
    ``pre_align_cli`` (``TTSPreAlign``, ``en``), an MFA-style TextGrid each
    and the ``binarize`` CLI (alignment, f0): items per split, aligned
    records, walls; (b) one ``train_step`` on the card against one on the
    CPU (same weights and batch: loss terms rel 1e-5, gradients rel L2
    1e-4); (c) ``run.main`` fit for 30 updates (ms per step by CUDA events,
    peak memory, the last learning rate, checkpoints, validation losses,
    figures or the trainer's warning), then 20 steps on one batch at lr
    2e-4 lower the loss; (d) a fresh task restores the newest checkpoint
    (state equal) and ``infer_to_wav`` vocodes two sentences on ``auto``
    -> ncl with K3 +12 / K1 +8 / K2 +4 per utterance, K8 +4 at a fusable
    frame count and every other kernel 0;
25. the speaker encoder (seed weights): 16 ``synth_voice`` mels embedded
    on the card and on the CPU (TF32 off, max abs <= 1e-5), ms per
    ``embed``; ``train_spk_encoder`` for 100 steps at 8 speakers x 4
    utterances x 80 frames (the loss must fall), ms per step and the
    verification EER (all pairs and held-out transforms) trained against
    the seed weights; phase 24's corpus through the ``binarize`` CLI with
    ``with_spk_embed``: every record's ``spk_embed`` a 256-d unit vector;
26. the diffusion zoo at the configs' full widths through
    ``FastDiffTask``: the diffusion PWG of ``micro_lj_pwg.yaml`` and the
    WaveNet of ``micro_lj.yaml`` + ``denoiser: wavenet, multiband: false``,
    seed weights but WaveNet's zero output conv drawn: 5 ``train_step``s at
    20 x 25,600 in bf16 by CUDA events with the peak memory; one step card
    vs CPU at 2 x 2,560 in f32 (loss rel 1e-5, gradients rel L2 1e-4; the
    loss must move off a zero output's and most gradient leaves outside the
    output conv must be non-zero); the N = 4 graph sampler at 864 frames, its
    warm-up, capture and replay bit-equal to the eager loop, ms per
    utterance, and the launches of one replayed call: 30 x 4 of
    ``wavenet_block`` (phase 37's kernel) for the WaveNet and none for the
    PWG; the PWG vocoder's ``spec2wav`` at 864 frames; every other kernel
    counter 0 (training and the PWG launch no hand-written kernel);
27. the MoL WaveNet at ``micro_lj_armol.yaml``'s full width: a 20-update
    ``run.main`` fit at 8 x 12,800 (ms per step by CUDA events, peak
    memory; the loss must fall); one step card vs CPU in f32 (1e-5 /
    1e-4); ``wavenet_incremental_logits`` (the CUDA-graph loop) against the
    teacher-forced forward (1e-5); the generation loop for 2,048 steps with
    injected draws, CUDA graph equal to the eager loop; ``wavenet_generate``
    of an 864-frame mel (17 folds of 12,800 + 2 x 512): wall, samples / s,
    RTF; no kernel launched;
28. the trainable NWC route's Functions at the recipe's fused shapes (b
    20 x 100 frames, bf16): ``AugHead`` (K7) and ``LVCBlockNWCRecompute``
    (K6, hops 64 and 256) against autograd through their plain versions
    (relative L2 <= 5e-2 per input);
29. the C++ mmap loader (``data/native_io.py``): a cold ``g++`` build and
    its wall; ``scripts/e2e_sanity.py``'s 24 tones through the
    ``VocoderBinarizer`` (pickle shards and v2 files); 20 native batches of
    16 x 12,800 bit-equal to the pickle path's on the same draws; batches
    per second on the host, native against pickle raced in turns; a 3-step
    ``Trainer.fit`` whose native batch counter rose;
30. ``torchrun --standalone --nproc_per_node 1`` of
    ``scripts/ddp_steps.py`` (NCCL, world size 1, DDP): 3 recipe steps
    against the same 3 in this process without a process group, cuDNN
    deterministic (the flags printed): losses and parameters within 1e-6
    relative; ``DistributedChunkedVocoder`` at one card against
    ``ChunkedVocoder`` on 3,000 frames (rel L2 <= 1e-6);
31. ``utils/profiling`` on the NCL graph sampler at 864 frames:
    ``device_timer_slope`` and ``device_timer`` beside phase 6's CUDA-event
    time; ``trace()`` writes a Chrome trace that names K1, K2 and K3;
    ``RTFMeter`` over four replayed utterances;
32. the learning check's cut (``scripts/e2e_sanity.py``'s data and
    hparams, ``ncl_sr``, the native loader): ``SANITY_STEPS`` updates of 16
    x 12,800; fails unless the mean train loss of the last 50 is at most
    ``SANITY_RATIO`` x that of the first 10 and every step launched K3 and
    K4 exactly 3 times;
33. the reference's full reverse process, N = 200 and N = 1000, on the NCL
    route at 864 frames, b 1, through ``make_param_sampler``
    (``scripts/bench_n1000.py``'s ``build`` and ``measure``): the first
    (eager) call's wall; the second's (the capture of a block of eight
    reverse steps, two graphs, and one sample's N / 8 replays) with each
    graph's nodes and instantiation,
    ``memory_reserved`` around it and the runner's buffer and draw bytes;
    the replay bit-equal to the first call, launching exactly 3N K3, 2N
    K1, N K2 and N K8, finite; replay ms by CUDA events and x realtime; the
    kernel route against the plain route at 100 frames on injected noise
    at both N (relative L2 <= 0.1); ``run.main --infer --hparams N=200`` on
    two utterances of one 128-frame bucket;
34. ``scripts/streaming_latency_curve.py`` on phase 32's checkpoint and the
    tones' valid split (the five settings, latency and finite MCD, mel-L2,
    MR-STFT), then ``scripts/drive_ncl_sr.py`` at the recipe (exit 0);
35. ``scripts/graft_entry.py``: ``entry()``'s full-width forward on the
    card, and ``dryrun_multichip`` over every card (NCCL ranks);
37. DiffWave's residual block kernel (``ops/wavenet_block.py``,
    ``csrc/wavenet_block.cu``): both instantiations' registers and spills
    (fails on a spill), shared memory and grid; against its plain version
    at b 16 x 896 and b 1 x 864 frames at each dilation 1-512 (block 0's
    kind at 1, the last block's at 512: each update within 1e-2 relative
    L2), and against float64 at b 1 x 864 beside the plain version's error;
    three ms per launch at each shape, each the mean over the ten
    dilations: the kernel by CUDA-graph replay, its bound (x and the skip
    sum, f32, read and written at 3.35 TB/s) and the plain version (the
    library's ops) by CUDA-graph replay too; a DiffWave BASE N = 6 graph
    sampler call launching it 30 x 6 = 180 times and no other kernel, and
    the profile of a replay holding 180 ``wavenet_block_kernel`` and no
    other hand-written kernel.

Phase 10 runs through ``scripts/bench_trainstep.py``. Each phase from 21
on prints its wall. Any failed check exits non-zero. The line before the last is a JSON object
with each of the fourteen kernels' launches (from the run of its path: phase
7 for K1-K3 and K8's NCL layout, ``downpath_ncl``, 11 for K4, 15 for K6-K8,
17 for K5, 18 for K10, 19 for K9, 37 for ``wavenet_block``: one DiffWave
BASE sampler call),
its largest error against its plain version, its time beside the plain
version's, the least time the card could take for the same work
(``bound_ms``: bytes at 3.35 TB/s or FLOPs at 989 TFLOP/s bf16, whichever is
larger, ``bound_by`` says which) and the time of one PyTorch call that
computes the same function where there is one (``library_ms``, else null);
``entry`` holds phase 21's RTF per utterance and GLMel's
wall, ``tts`` phase 22's rows per utterance (frames, FastSpeech 2 ms,
vocoder ms, RTF) and its wall, ``bddm`` phase 23's (phi step ms and
launches, the route checks, each search and each schedule's sample ms and
metrics, the CLIs' walls), ``fs2_train`` phase 24's (pipeline counts and
walls, card vs CPU errors, fit ms per step, peak memory, losses, launches
per utterance), and each kernel carries
``fs2_infer_launches_per_utterance``, its launches per ``infer_to_wav`` of
the trained FastSpeech 2 in phase 24, and K7 and K6 also
``train_launches_per_step`` from one ``nwc_vjp`` step of phase 10; ``zoo``
holds phases 25-27's rows (``spk``, ``diffusion``, ``mol``),
``native_loader``, ``ddp``, ``profiling`` and ``learning_check`` phases
29-32's, ``full_reverse`` phase 33's and ``script_twins`` phases 34-35's;
K1-K3 also carry ``full_reverse_launches_per_sample`` from phase 33. The
last line is ``{"ok": true, "device": {...}}``.
"""

import io
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

from fastdiff_tpu_torch.utils.timing import cuda_ms, graph_ms, race_graph

AUDIO_SECONDS_PER_SAMPLE = 1.0 / 22050
FRAMES_10S = 864                 # 864 * 256 = 221,184 samples, ~10.03 s
HOP_SIZE = 256
# the training recipe: batch 20 x 25,600 samples (100 mel frames)
TRAIN_BATCH, TRAIN_FRAMES = 20, 100
# model FLOPs of one train step at the recipe (3 x forward), from
# 2.369e5 FLOP per sample per forward
STEP_FLOP = 3 * 2.369e5 * TRAIN_FRAMES * HOP_SIZE * TRAIN_BATCH
H100_BF16_PEAK = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
HEAD_K = 192                     # predictor head contraction (3 x 64)


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(n: int, msg: str):
    print(f"[phase {n}] {msg}", flush=True)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(works) -> tuple:
    """The least time the card could take for a run of calls, each
    (FLOP, bytes): the sum over calls of the larger of bytes / 3.35 TB/s and
    FLOP / 989 TFLOP/s, in ms, and which of the two bounds the run."""
    by_bytes = by_ops = 0.0
    for flop, nbytes in works:
        t_b = nbytes / H100_HBM_BYTES_PER_S * 1e3
        t_o = flop / H100_BF16_PEAK * 1e3
        if t_b >= t_o:
            by_bytes += t_b
        else:
            by_ops += t_o
    return by_bytes + by_ops, ("bytes" if by_bytes >= by_ops
                               else "operations")


def gemm_work(m: int, k: int, n: int) -> tuple:
    """(FLOP, bytes) of (M, K) @ (K, N) + f32 bias (N,) -> (M, N), bf16."""
    return 2.0 * m * k * n, 2.0 * (m * k + k * n + m * n) + 4.0 * n


def block_work(b: int, c: int, length: int, kern_bytes: float = 0.0,
               final: bool = False, save: bool = False,
               layers: int = 4) -> tuple:
    """(FLOP, bytes) of one LVC block call: per sample and layer the
    dilated conv (2 C (3C+1)) and the LVC (2 2C (3C+1)); x and skip read and
    out written once, plus the kernel operand, the final conv's f32 output
    and the saved s, y, z residuals where the call has them."""
    rows = 3 * c + 1
    flop = b * length * layers * 2.0 * 3 * c * rows
    nbytes = 3 * 2.0 * b * c * length + kern_bytes
    if final:
        flop += 2.0 * 7 * c * b * length
        nbytes += 4.0 * b * length
    if save:
        nbytes += 2.0 * b * layers * 4 * c * length
    return flop, nbytes


def entry(max_abs_err, ms, plain_ms, works, library_ms=None) -> dict:
    """One kernel's numbers for the JSON line."""
    b_ms, by = bound(works)
    return dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, library_ms=library_ms)


def check_pairs(pairs, what: str):
    """Phase 4's bounds on (kernel, plain) pairs: rel L2 <= 1e-2 and max
    abs <= 4 bf16 ulps of the largest plain value; returns the errors."""
    errs = [(max_abs(a, b), rel_l2(a, b)) for a, b in pairs]
    for (e, r), (a, b) in zip(errs, pairs):
        if not (r <= 1e-2 and e <= 2.0 ** -5 * float(b.float().abs().max())):
            fail(f"{what} disagrees with its plain version")
        if not bool(a.isfinite().all()):
            fail(f"{what} output is not finite")
    return errs


def race_sampler(run_graph, run_eager, reps: int = 3) -> dict:
    """The graph sampler against the eager one, raced in turns (eager,
    graph, graph, eager) by CUDA events: ms per call of each (the mean of
    its two turns) and every turn. Two graph calls come first: a shape's
    first call runs eagerly and its second captures."""
    run_graph()
    run_graph()
    runs = {"eager": [cuda_ms(run_eager, reps)]}
    runs["graph"] = [cuda_ms(run_graph, reps), cuda_ms(run_graph, reps)]
    runs["eager"].append(cuda_ms(run_eager, reps))
    return {k: dict(ms=sum(v) / len(v), runs=v) for k, v in runs.items()}


def sampler_line(label: str, race: dict, audio_s: float) -> str:
    """'graph X ms (Y x realtime), eager ...' of one ``race_sampler``."""
    return f"{label}: " + ", ".join(
        f"{k} {r['ms']:.3f} ms per utterance ({audio_s / (r['ms'] / 1e3):.1f}"
        f" x realtime; runs {', '.join(f'{v:.3f}' for v in r['runs'])})"
        for k, r in race.items())


def grad_errors(torch, fn, plain, args, gout):
    """Relative L2 of fn's input gradients against autograd through plain,
    for the same output gradient."""
    def grads(f):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        return torch.autograd.grad(f(*leaves), leaves, gout)
    return [rel_l2(a, b) for a, b in zip(grads(fn), grads(plain))]


def request_and_count(n, port, frames, body, rises, turn, counts, finite):
    """POST one .npy mel of ``frames`` frames to /vocode on ``port``: the
    answer must be a WAV of frames * 256 finite samples, and each label of
    ``rises`` ({label: (counter keys, rise)}) must raise its counters by
    exactly its rise."""
    import http.client
    before = counts()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", "/vocode", body=body)
    resp = conn.getresponse()
    answer = resp.read()
    conn.close()
    ms = (time.perf_counter() - t0) * 1e3
    if resp.status != 200:
        fail(f"/vocode {frames} frames: HTTP {resp.status} {answer[:200]!r}")
    with wave.open(io.BytesIO(answer)) as w:
        n_samples = w.getnframes()
    after = counts()
    got = {label: sum(after[k] - before[k] for k in keys)
           for label, (keys, _) in rises.items()}
    print(f"  [phase {n}] /vocode {frames} frames ({turn}): HTTP 200, "
          f"{n_samples} samples, {ms:.1f} ms wall, launches "
          + " ".join(f"{label} +{v}" for label, v in got.items()),
          flush=True)
    if n_samples != frames * HOP_SIZE:
        fail(f"WAV has {n_samples} samples, expected {frames * HOP_SIZE}")
    if not finite or not finite[-1]:
        fail("vocoded waveform is not finite")
    want = {label: rise for label, (_, rise) in rises.items()}
    if got != want:
        fail(f"kernel launches rose by {got}; expected {want}")


def serve_and_count(n, service, start_server, counters, expected,
                    cond_channels):
    """The port's HTTP server on 127.0.0.1 with ``service``: after a
    16-frame warm-up, every counter in ``counters`` is set to 0 and one mel
    per entry of ``expected`` ({frames: {label: (counter keys, rise)}}) is
    POSTed to /vocode three times: the frame count's first request runs
    eagerly, the second captures its graph (one capture more) and the
    third replays it. Each answer must be a WAV of frames * 256 finite
    samples, and each label's counters must rise by exactly its rise on
    each request. Returns the counts after the requests."""
    import http.client
    finite = []
    spec2wav = service.vocoder.spec2wav

    def checked_spec2wav(m):
        wav = spec2wav(m)
        finite.append(bool(np.isfinite(wav).all()))
        return wav

    service.vocoder.spec2wav = checked_spec2wav
    httpd, thread = start_server(service, "127.0.0.1", 0)
    port = httpd.server_address[1]

    def counts():
        merged = {}
        for counter in counters:
            merged.update(counter)
        return merged

    try:
        service.warmup(frames=16)
        for counter in counters:
            for key in counter:
                counter[key] = 0
        rng = np.random.default_rng(0)
        sampler = service.vocoder.sampler
        for frames, rises in expected.items():
            mel_np = (rng.normal(size=(frames, cond_channels)) - 4.0
                      ).astype(np.float32)
            buf = io.BytesIO()
            np.save(buf, mel_np)
            for turn in ("first request, eager", "capture", "replay"):
                captures = sampler.captures
                request_and_count(n, port, frames, buf.getvalue(), rises,
                                  turn, counts, finite)
                if sampler.captures != captures + (turn == "capture"):
                    fail(f"/vocode {frames} frames ({turn}): captures "
                         f"{captures} -> {sampler.captures}")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = conn.getresponse()
        health.read()
        conn.close()
        if health.status != 200:
            fail(f"/healthz answered {health.status}")
        return counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def ptxas_entry(log: str, mangled: str) -> str:
    """ptxas's registers, spills and static shared memory for the first
    kernel whose mangled name contains ``mangled``, from ``build.log``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and mangled in line:
            info = []
            for nxt in lines[i + 1:]:
                if "Compiling entry function" in nxt:
                    break
                if "spill" in nxt or "registers" in nxt:
                    info.append(nxt.split(":", 1)[-1].strip())
            return "; ".join(info)
    return "not in the build log"


def check_no_spill(info: str, what: str):
    """Fail unless ptxas's line reports 0 bytes of spill stores and loads."""
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       info)
    if not spills or spills.groups() != ("0", "0"):
        fail(f"{what} spills registers (or has no ptxas line)")


def head_gemm_cases(n_phase, label, torch, fn, plain, randn, k, n, rows):
    """A head GEMM kernel (K3 or K7) against its plain version at each row
    count of ``rows``: within one bf16 ulp of the largest output (f32 sums
    in another order, then one rounding), timed against ``torch.addmm`` (a
    yardstick the port never calls) raced in turns, both by CUDA-graph
    replay (device time alone), and against the plain version (eager). The
    eager per-call time of the kernel's wrapper, host included, is printed
    beside it. Returns {M: (max_abs_err, ms, plain_ms, addmm_ms)}."""
    out = {}
    for m in rows:
        tap = randn(m, k)
        w = randn(k, n, scale=0.05)
        b = randn(n, scale=0.1, dtype=torch.float32)
        got, ref = fn(tap, w, b), plain(tap, w, b)
        torch.cuda.synchronize()
        err = max_abs(got, ref)
        bound_err = 2.0 ** -7 * float(ref.float().abs().max()) + 1e-6
        if not err <= bound_err or not bool(got.isfinite().all()):
            fail(f"{label} disagrees with its plain version at M = {m}")
        b_bf16 = b.to(torch.bfloat16)
        reps = 20 if m <= FRAMES_10S else 10
        ms_k, ms_lib = race_graph(lambda: torch.addmm(b_bf16, tap, w),
                                  lambda: fn(tap, w, b), reps)
        ms_eager = cuda_ms(lambda: fn(tap, w, b), reps)
        ms_p = cuda_ms(lambda: plain(tap, w, b), 5)
        flop, nbytes = gemm_work(m, k, n)
        b_ms, _ = bound([(flop, nbytes)])
        phase(n_phase, f"{label} ({m}x{k} @ {k}x{n}): max_abs_err "
                       f"{err:.3e} (bound {bound_err:.3e}); kernel "
                       f"{ms_k:.4f} ms, torch.addmm {ms_lib:.4f} ms (raced, "
                       f"CUDA graphs), plain {ms_p:.4f} ms, kernel eager "
                       f"with its wrapper {ms_eager:.4f} ms; "
                       f"{nbytes / ms_k / 1e9:.3f} TB/s, {b_ms / ms_k:.1%} "
                       f"of the bound {b_ms:.4f} ms")
        out[m] = (err, ms_k, ms_p, ms_lib)
        del tap, w, b, b_bf16, got, ref
    return out


def phase4_block(torch, lvc_block_ncl, randn, c, layers, rows, rows_p, dev,
                 smi_line):
    """Kernel B on the tensor cores against its plain version at the model's
    hops with 864 frames (hop 256 with and without the epilogue) and at 100
    frames of hop 8, timed in turns (the kernel by CUDA-graph replay);
    returns the entries of K1 and K2 per denoiser forward."""
    wstack_t = randn(layers, c, rows, scale=0.1)
    final_wb = randn(8, c, scale=0.1)
    per_forward = {"lvc_block_ncl": [0.0, 0.0, 0.0, []],
                   "lvc_block_ncl_final": [0.0, 0.0, 0.0, []]}
    cases = [(8, FRAMES_10S, False, True), (64, FRAMES_10S, False, True),
             (256, FRAMES_10S, False, False),
             (256, FRAMES_10S, True, True), (8, 100, False, False)]
    for hop, frames, final, on_path in cases:
        length = frames * hop
        x = randn(1, c, length)
        skip = randn(1, c, length)
        kern = torch.zeros((1, frames, layers, 2 * c, rows_p),
                           dtype=torch.bfloat16, device=dev)
        kern[..., :rows] = randn(1, frames, layers, 2 * c, rows, scale=0.05)
        fwb = final_wb if final else None

        def run_k():
            return lvc_block_ncl.lvc_block_ncl(x, skip, kern, wstack_t, hop,
                                               fwb)

        def run_p():
            return lvc_block_ncl.lvc_block_ncl_plain(x, skip, kern, wstack_t,
                                                     hop, fwb)

        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        what = "with epilogue" if final else "block only"
        both = (lambda a, b: [(a[0], b[0]), (a[1], b[1])] if final
                else [(a, b)])
        # bf16 carries: a flipped rounding in s or y moves later layers by a
        # few bf16 ulps (2^-5 relative to the largest value is four ulps of
        # it); a wrong kernel is off by O(1)
        errs = check_pairs(both(got, ref), f"Kernel B tensor cores (hop "
                                           f"{hop}, {frames} frames, {what})")
        # plain, kernel, plain: the kernel by CUDA-graph replay (device
        # time alone)
        ms_p1 = cuda_ms(run_p, 3)
        ms_k = graph_ms(run_k, 10)
        ms_p = (ms_p1 + cuda_ms(run_p, 3)) / 2
        work = block_work(1, c, length, 2.0 * kern.numel(), final=final)
        b_ms, by = bound([work])
        phase(4, f"Kernel B hop {hop}, {frames} frames ({what}): tensor "
                 "cores " + ", ".join(f"max_abs_err {e:.3e} rel_l2 {r:.3e}"
                                      for e, r in errs)
                 + f"; tensor cores {ms_k:.4f} ms, plain {ms_p:.4f} ms; bound "
                 f"{b_ms:.4f} ms ({by}), tensor cores at {b_ms / ms_k:.1%} of "
                 f"it [{smi_line}]")
        acc = per_forward["lvc_block_ncl_final" if final else "lvc_block_ncl"]
        acc[0] = max(acc[0], max(e for e, _ in errs))
        if on_path:
            acc[1] += ms_k
            acc[2] += ms_p
            acc[3].append(work)
        del x, skip, kern, got, ref
    return {name: entry(*acc) for name, acc in per_forward.items()}


def phase8_sr_block(torch, lvc_block_ncl, randn, c, layers, rows, rows_p,
                    dev, smi_line):
    """Kernel B-SR on the tensor cores against its plain version at the
    recipe's shapes (phase 4's bounds on out, s, y, z), timed in turns (the
    kernel by CUDA-graph replay)."""
    wstack_t = randn(layers, c, rows, scale=0.1)
    worst, ms_k, ms_p, works = 0.0, 0.0, 0.0, []
    for hop in (8, 64, 256):
        length = TRAIN_FRAMES * hop
        x = randn(TRAIN_BATCH, c, length)
        skip = randn(TRAIN_BATCH, c, length)
        kern = torch.zeros((TRAIN_BATCH, TRAIN_FRAMES, layers, 2 * c, rows_p),
                           dtype=torch.bfloat16, device=dev)
        kern[..., :rows] = randn(TRAIN_BATCH, TRAIN_FRAMES, layers, 2 * c,
                                 rows, scale=0.05)

        def run_k():
            return lvc_block_ncl.lvc_block_ncl_sr(x, skip, kern, wstack_t, hop)

        def run_p():
            return lvc_block_ncl.lvc_block_ncl_sr_plain(x, skip, kern,
                                                        wstack_t, hop)

        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        errs = check_pairs(list(zip(got, ref)),
                           f"Kernel B-SR tensor cores (hop {hop})")
        del got, ref
        ms_p1 = cuda_ms(run_p, 2)
        k = graph_ms(run_k, 5)
        p = (ms_p1 + cuda_ms(run_p, 2)) / 2
        work = block_work(TRAIN_BATCH, c, length, 2.0 * kern.numel(),
                          save=True)
        b_ms, by = bound([work])
        phase(8, f"Kernel B-SR hop {hop}, b {TRAIN_BATCH} x {TRAIN_FRAMES} "
                 "frames: tensor cores " + ", ".join(
                     f"{n} max_abs_err {e:.3e} rel_l2 {r:.3e}" for n, (e, r)
                     in zip(("out", "s", "y", "z"), errs))
                 + f"; tensor cores {k:.4f} ms, plain {p:.4f} ms; bound "
                 f"{b_ms:.4f} ms ({by}), tensor cores at {b_ms / k:.1%} of it "
                 f"[{smi_line}]")
        worst = max([worst] + [e for e, _ in errs])
        ms_k += k
        ms_p += p
        works.append(work)
        del x, skip, kern
    return entry(worst, ms_k, ms_p, works)


def phase9_gradients(torch, lvc_block_ncl, lvc_head, randn, c, layers, rows,
                     rows_p, dev):
    """The trainable block and head against autograd through their plain
    versions at the hop-256 recipe shape, bf16."""
    wstack_t = randn(layers, c, rows, scale=0.1)
    hop = 256
    length = TRAIN_FRAMES * hop
    x = randn(TRAIN_BATCH, c, length)
    skip = randn(TRAIN_BATCH, c, length)
    kern = torch.zeros((TRAIN_BATCH, TRAIN_FRAMES, layers, 2 * c, rows_p),
                       dtype=torch.bfloat16, device=dev)
    kern[..., :rows] = randn(TRAIN_BATCH, TRAIN_FRAMES, layers, 2 * c, rows,
                             scale=0.05)
    gout = randn(TRAIN_BATCH, c, length)
    plain = (lambda *a: lvc_block_ncl.lvc_block_ncl_plain(*a, hop))
    checks = {
        "LVCBlockSR": grad_errors(
            torch, lambda *a: lvc_block_ncl.LVCBlockSR.apply(*a, hop), plain,
            (x, skip, kern, wstack_t), gout),
        "LVCBlockRecompute": grad_errors(
            torch, lambda *a: lvc_block_ncl.LVCBlockRecompute.apply(*a, hop),
            plain, (x, skip, kern, wstack_t), gout),
    }
    m, k, n = TRAIN_BATCH * TRAIN_FRAMES, 192, layers * 2 * c * rows_p
    checks["TaugHead"] = grad_errors(
        torch, lvc_head.TaugHead.apply, lvc_head.taug_head_matmul_plain,
        (randn(m, k), randn(k, n, scale=0.05),
         randn(n, scale=0.1, dtype=torch.float32)), randn(m, n))
    torch.cuda.synchronize()
    for name, errs in checks.items():
        phase(9, f"{name} input gradients vs autograd through the plain "
                 f"version (bf16, hop-256 recipe shape): rel_l2 "
                 + ", ".join(f"{e:.3e}" for e in errs) + " (bound 5e-2)")
        if not all(e <= 5e-2 for e in errs):
            fail(f"{name} gradients disagree with the plain version")


def phase10_train_step(torch, FastDiffTask, smi_line, dev, all_counters):
    """One full-width train step per route, raced in turns
    (``fastdiff_tpu_torch/scripts/bench_trainstep.py``); the launches of
    one ``nwc_vjp`` step: K7 and K6 twice each (the hop-64 and hop-256
    blocks), every other kernel never."""
    from fastdiff_tpu_torch.scripts import bench_trainstep
    routes = ("ncl_sr", "ncl_vjp", "nwc_vjp", "plain")
    try:
        race = bench_trainstep.setup(dev, routes, TRAIN_BATCH, TRAIN_FRAMES)
    except ValueError as e:
        fail(str(e))
    # gradients of the identical initial weights, same draws
    grad_rel = bench_trainstep.gradient_errors(race)
    metrics, peak = bench_trainstep.warm(race)       # warm-up, peak memory
    zero_counters(all_counters)
    race.step("nwc_vjp")
    torch.cuda.synchronize()
    nwc_launches = launched(all_counters)
    phase(10, f"one nwc_vjp step launched {nwc_launches} (K7 aug_head and "
              "the tensor-core K6 lvc_block_nwc 2 each, nothing else)")
    if nwc_launches != {"aug_head": 2, "lvc_block_nwc": 2}:
        fail("an nwc_vjp train step did not launch K7 and the tensor-core "
             "K6 exactly twice each (and no other kernel)")
    times = bench_trainstep.race(race, 3)
    report = {"nwc_vjp_launches_per_step": nwc_launches}
    for r in routes:
        ms = sum(times[r]) / len(times[r])
        share = STEP_FLOP / (ms / 1e3) / H100_BF16_PEAK
        m = metrics[r]
        line = (f"route {r}: {ms:.2f} ms per step (runs "
                + ", ".join(f"{t:.2f}" for t in times[r])
                + f"), {STEP_FLOP / (ms / 1e3) / 1e12:.1f} TFLOP/s = "
                f"{100 * share:.2f} % of the bf16 peak, peak memory "
                f"{peak[r] / 2 ** 30:.2f} GiB, loss {m['loss']:.5f}, "
                f"grad_norm {m['grad_norm']:.4f}")
        if r in grad_rel:
            rel, (w, k) = grad_rel[r]
            line += (f", gradients vs plain rel_l2 {rel:.3e} (bound 5e-2; "
                     f"worst tensor {k} {w:.3e})")
        phase(10, line + f" [{smi_line}]")
        if not all(np.isfinite(v) for v in m.values()) or m["nonfinite"]:
            fail(f"train step on route {r}: loss or gradient norm not finite")
        if r in grad_rel and not grad_rel[r][0] <= 5e-2:
            fail(f"route {r}: gradients disagree with the plain route")
        report[r] = dict(ms=ms, peak_bytes=peak[r], bf16_peak_share=share)
    return report


def write_synthetic_dataset(binary_dir: str, seed: int = 0) -> None:
    """24 train and 4 valid items of 120-200 random frames, binarized the
    way ``fastdiff_tpu_torch/data`` (and the JAX package) reads them."""
    from fastdiff_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder
    rng = np.random.default_rng(seed)
    for prefix, n_items in (("train", 24), ("valid", 4)):
        builder = IndexedDatasetBuilder(os.path.join(binary_dir, prefix))
        lengths = []
        for i in range(n_items):
            frames = int(rng.integers(120, 201))
            builder.add_item({
                "item_name": f"{prefix}{i}", "len": frames,
                "mel": (rng.normal(size=(frames, 80)) - 4.0).astype(
                    np.float32),
                "wav": (0.3 * rng.normal(size=frames * HOP_SIZE)).astype(
                    np.float32)})
            lengths.append(frames)
        builder.finalize()
        np.save(os.path.join(binary_dir, f"{prefix}_lengths.npy"), lengths)


def phase11_fit(torch, FastDiffTask, Trainer, counters, dev):
    """Trainer.fit through the normal entry point, then a resumed fit."""
    root = tempfile.mkdtemp(prefix="fastdiff_fit_")
    try:
        binary = os.path.join(root, "binary")
        os.makedirs(binary)
        write_synthetic_dataset(binary)
        hp = {"binary_data_dir": binary, "hop_size": HOP_SIZE,
              "max_samples": TRAIN_FRAMES * HOP_SIZE,
              "max_sentences": TRAIN_BATCH,
              "use_pallas_block": "auto", "max_updates": 6,
              "val_check_interval": 3, "tb_log_interval": 1,
              "num_ckpt_keep": 1}
        work = os.path.join(root, "work")
        steps = []

        def counted_task(hparams):
            """A task whose train steps record their metrics and the launches
            of Kernel A and Kernel B-SR they made."""
            task = FastDiffTask(hparams, device=dev)
            if task.route != "ncl_sr":
                fail(f"use_pallas_block auto resolved to {task.route} on "
                     f"{dev}")
            train_step = task.train_step

            def counted(state, batch, generator=None, **kw):
                before = (counters[0]["taug_head"],
                          counters[1]["lvc_block_ncl_sr"])
                out = train_step(state, batch, generator, **kw)
                steps.append(dict(
                    {k: float(v) for k, v in out.items()},
                    a=counters[0]["taug_head"] - before[0],
                    sr=counters[1]["lvc_block_ncl_sr"] - before[1]))
                return out
            task.train_step = counted
            return task

        task = counted_task(hp)
        state = task.build_state()
        before = {k: p.detach().clone()
                  for k, p in state.model.named_parameters()}
        for counter in counters:
            for key in counter:
                counter[key] = 0
        t0 = time.perf_counter()
        result = Trainer(task, work).fit(state)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {**counters[0], **counters[1]}
        changed = sum(not torch.equal(before[k], p) for k, p in
                      result["state"].model.named_parameters())
        files = sorted(os.listdir(work))
        phase(11, f"fit: {result['step']} steps in {fit_s:.1f} s, losses "
                  + ", ".join(f"{s['loss']:.4f}" for s in steps)
                  + "; grad norms "
                  + ", ".join(f"{s['grad_norm']:.3f}" for s in steps)
                  + f"; val {result['val']}; {changed} parameter tensors "
                  f"changed; files {files}; launches per step A "
                  f"{[s['a'] for s in steps]} B-SR {[s['sr'] for s in steps]}")
        if result["step"] != 6 or len(steps) != 6:
            fail(f"fit ran {len(steps)} steps to step {result['step']}")
        if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
                   for s in steps) or not np.isfinite(result["val"]["loss"]):
            fail("fit: a loss or gradient norm is not finite")
        if changed == 0:
            fail("fit: no parameter changed")
        if any(s["a"] != 3 or s["sr"] != 3 for s in steps):
            fail("fit: a train step did not launch Kernel A and Kernel B-SR "
                 "exactly 3 times")
        if not {"model_ckpt_steps_6.ckpt", "model_ckpt_best.pt"} <= set(
                files) or "model_ckpt_steps_3.ckpt" in files or any(
                f.endswith(".part") for f in files):
            fail(f"fit: checkpoints on disk are {files}")

        # resume: a second run to 8 starts from the step-6 checkpoint
        n_before = len(steps)
        result2 = Trainer(counted_task(dict(hp, max_updates=8)), work).fit()
        files2 = sorted(os.listdir(work))
        phase(11, f"resumed fit: {len(steps) - n_before} more steps to step "
                  f"{result2['step']}; files {files2}")
        if result2["step"] != 8 or len(steps) - n_before != 2:
            fail("the second fit did not resume from step 6")
        if "model_ckpt_steps_8.ckpt" not in files2:
            fail(f"resumed fit: checkpoints on disk are {files2}")
        return launches, fit_s
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase12_aug_head(torch, nwc_ops, randn, c, layers, hid):
    """K7 against its plain version at the NWC route's head shapes (the
    hop-64 and hop-256 blocks at 256 and 864 frames)."""
    k, n = 3 * hid, layers * (3 * c + 1) * 2 * c
    cases = head_gemm_cases(12, "K7 aug_head", torch, nwc_ops.aug_head_matmul,
                            nwc_ops.aug_head_matmul_plain, randn, k, n,
                            (256, FRAMES_10S))
    _, ms_k, ms_p, ms_lib = cases[FRAMES_10S]
    # two fused blocks (hops 64 and 256) per denoiser forward at 864 frames
    return entry(max(v[0] for v in cases.values()), 2 * ms_k, 2 * ms_p,
                 [gemm_work(FRAMES_10S, k, n)] * 2, 2 * ms_lib)


def phase13_nwc_block(torch, nwc_ops, randn, c, layers, smi_line):
    """K6 on the tensor cores against its plain version (phase 4's bounds),
    at the route's hops with 864 frames and at b = 2 x 100 frames of hop
    64; timed in turns (the kernel by CUDA-graph replay)."""
    rows = 3 * c + 1
    wstack = randn(layers, rows, c, scale=0.1)
    worst, ms_k, ms_p, works = 0.0, 0.0, 0.0, []
    for hop, frames, b, on_path in ((64, FRAMES_10S, 1, True),
                                    (256, FRAMES_10S, 1, True),
                                    (64, 100, 2, False)):
        length = frames * hop
        x = randn(b, length, c)
        skip = randn(b, length, c)
        kern_aug = randn(b, frames, layers, rows, 2 * c, scale=0.05)

        def run_k():
            return nwc_ops.lvc_block_nwc(x, skip, kern_aug, wstack, hop)

        def run_p():
            return nwc_ops.lvc_block_nwc_plain(x, skip, kern_aug, wstack, hop)

        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        what = f"hop {hop}, {frames} frames, b {b}"
        (e, r), = check_pairs([(got, ref)], f"K6 tensor cores ({what})")
        ms_p1 = cuda_ms(run_p, 3)
        k = graph_ms(run_k, 10)
        p = (ms_p1 + cuda_ms(run_p, 3)) / 2
        work = block_work(b, c, length, 2.0 * kern_aug.numel())
        b_ms, by = bound([work])
        phase(13, f"K6 lvc_block_nwc {what}: tensor cores max_abs_err "
                  f"{e:.3e} rel_l2 {r:.3e}; tensor cores {k:.4f} ms, plain "
                  f"{p:.4f} ms; bound {b_ms:.4f} ms ({by}), tensor cores at "
                  f"{b_ms / k:.1%} of it [{smi_line}]")
        worst = max(worst, e)
        if on_path:
            ms_k += k
            ms_p += p
            works.append(work)
    return entry(worst, ms_k, ms_p, works)


def phase14_downpath(torch, down_ops, model, ncl_model, dev, smi_line):
    """K8 against its plain versions, with each model's packed weights:
    the NWC flag (``downpath_fused`` vs ``downpath_plain``) at 10 s (b = 1)
    and at two halo units (b = 2); the NCL flag (``downpath_ncl`` vs
    ``downpath_ncl_plain``, the ncl route's module chain) at 10 s, at the
    offline cell's b 16 x 896 frames and at two halo units. Each output
    within 4 bf16 ulps of its largest value. Each flag timed by CUDA-graph
    replay (device time of both launches) in turns with its plain version.
    Returns the NWC and the NCL kernel's entries (ms at 10 s, b = 1)."""
    gen = torch.Generator(device=dev).manual_seed(14)
    factors = tuple(model.cfg.upsample_ratios[::-1])
    c = model.cfg.inner_channels
    flags = {
        "NWC": (down_ops.downpath_fused, down_ops.downpath_plain,
                (model.down_first, model.down_res, model.down_conv)),
        "NCL": (down_ops.downpath_ncl, down_ops.downpath_ncl_plain,
                (ncl_model.down_first, ncl_model.down_res,
                 ncl_model.down_conv, ncl_model.down_bias)),
    }
    out = {}
    for flag, (kernel, plain, packs) in flags.items():
        worst, ms_k, ms_p, works = 0.0, 0.0, 0.0, []
        shapes = ((1, FRAMES_10S * HOP_SIZE, True), (2, 2 * 2048, False))
        if flag == "NCL":
            shapes += ((16, 896 * HOP_SIZE, False),)
        for b, length, on_path in shapes:
            audio = torch.randn((b, length, 1), generator=gen, device=dev)

            def run_k():
                return kernel(audio, *packs, factors)

            def run_p():
                return plain(audio, *packs, factors)

            got, ref = run_k(), run_p()
            torch.cuda.synchronize()
            errs = []
            for i, (a, r) in enumerate(zip(got, ref)):
                e = max_abs(a, r)
                bound_err = 2.0 ** -5 * float(r.float().abs().max())
                errs.append(e)
                if a.shape != r.shape or not e <= bound_err or not bool(
                        a.isfinite().all()):
                    fail(f"K8 {flag} output {i} disagrees with its plain "
                         f"version (b {b}, {length} samples): {e:.3e} > "
                         f"{bound_err:.3e}")
            p1 = cuda_ms(run_p, 5)
            k = (graph_ms(run_k, 20) + graph_ms(run_k, 20)) / 2
            p = (p1 + cuda_ms(run_p, 5)) / 2
            k_eager = cuda_ms(run_k, 20)
            # the NCL chain as the route's captured graph runs it
            p_graph = (f", replayed {graph_ms(run_p, 5):.4f} ms"
                       if flag == "NCL" else "")
            lengths = [length // r for r in (4, 32, 256)]
            # first conv (7 taps, 1 -> C), then per DBlock output sample
            # the 1x1 residual and three k=3 convs; audio in, four outputs
            # out
            flop = b * (2.0 * 7 * c * length + sum(
                n * (2.0 * c * (c + 1) + 3 * 2.0 * c * (3 * c + 1))
                for n in lengths))
            nbytes = b * (4.0 * length + 2.0 * c * (length + sum(lengths)))
            b_ms, by = bound([(flop, nbytes)])
            plan = down_ops.downpath_plan(b, length)
            phase(14, f"K8 {flag} downpath b {b} x {length} samples: "
                      "max_abs_err " + ", ".join(f"{e:.3e}" for e in errs)
                      + " (skip0, skip1, skip2, x; bound 4 bf16 ulps of "
                      f"each); raced: kernel {k:.4f} ms (CUDA graphs, both "
                      f"stages; eager with its wrapper {k_eager:.4f} ms), "
                      f"plain {p:.4f} ms{p_graph}; bound {b_ms:.4f} ms "
                      f"({by}), kernel at {b_ms / k:.1%} of it; "
                      f"{plan.stage1_blocks} + {plan.stage2_blocks} blocks "
                      f"[{smi_line}]")
            worst = max([worst] + errs)
            if on_path:
                ms_k, ms_p = k, p
                works = [(flop, nbytes)]
        out[flag] = entry(worst, ms_k, ms_p, works)
    return out["NWC"], out["NCL"]


def phase15_nwc_route(torch, model, sample, make_sampler, const, gen, dev,
                      smi_line):
    """The NWC route's full-width forward, kernels against plain, and its
    N = 4 sampler at 864 frames, kernel and plain paths, each as a CUDA
    graph raced against the eager loop."""
    cfg = model.cfg
    length = FRAMES_10S * HOP_SIZE
    audio = torch.randn((1, length, 1), generator=gen, device=dev)
    mel = torch.randn((1, FRAMES_10S, cfg.cond_channels), generator=gen,
                      device=dev)
    t = torch.full((1, 1), 498.0, device=dev)
    model.use_kernels = True
    eps_k = model(audio, mel, t)
    model.use_kernels = False
    eps_p = model(audio, mel, t)
    torch.cuda.synchronize()
    err = rel_l2(eps_k, eps_p)
    phase(15, f"NWC denoiser forward (1, {length}, 1) bf16: kernel vs plain "
              f"rel_l2 {err:.3e} (bound 5e-2), max_abs_err "
              f"{max_abs(eps_k, eps_p):.3e}")
    if eps_k.shape != (1, length, 1) or not torch.isfinite(eps_k).all():
        fail("NWC denoiser output has the wrong shape or is not finite")
    if not err <= 5e-2:
        fail("NWC denoiser kernel path disagrees with the plain path")
    run = make_sampler(model, const)
    races, wavs = {}, {}
    for use, label in ((True, "kernel"), (False, "plain")):
        model.use_kernels = use

        def graph():
            g = torch.Generator(device=dev).manual_seed(1)
            return run(g, mel, length)

        def eager():
            g = torch.Generator(device=dev).manual_seed(1)
            return sample(model, mel, const, length, generator=g)

        races[label] = race_sampler(graph, eager)
        wavs[label] = graph()
    model.use_kernels = True
    audio_s = length * AUDIO_SECONDS_PER_SAMPLE
    for label, race in races.items():
        line = sampler_line("NWC sampler " + label, race, audio_s)
        print(f"  [phase 15] {line}", flush=True)
    for wav in wavs.values():
        if wav.shape != (1, length, 1) or not torch.isfinite(wav).all():
            fail("NWC sampler output has the wrong shape or is not finite")
    out = {label: race["graph"]["ms"] for label, race in races.items()}
    out.update({f"{label}_eager": race["eager"]["ms"]
                for label, race in races.items()})
    phase(15, f"NWC N=4 sampler, {FRAMES_10S} frames ({audio_s:.2f} s), CUDA "
              f"graph (eager beside it): kernel {out['kernel']:.3f} ms "
              f"({out['kernel_eager']:.3f}), plain {out['plain']:.3f} ms "
              f"({out['plain_eager']:.3f}); kernel vs plain waveform rel_l2 "
              f"{rel_l2(wavs['kernel'], wavs['plain']):.3e} [{smi_line}]")
    return out


def phase16_fh_block(torch, block_ops, lvc_head, randn, c, layers, rows,
                     rows_p, smi_line):
    """K5 on the tensor cores against its plain version (phase 4's bounds),
    at the route's hops with 864 frames and at b = 2 x 100 frames of hop
    64; raced in turns by CUDA-graph replay against K3 + K1 on the same
    inputs."""
    n = layers * 2 * c * rows_p
    wstack_t = randn(layers, c, rows, scale=0.1)
    final_wb = randn(8, c, scale=0.1)
    # head weights scaled so the kernels come out near phase 4's (~0.05)
    w_head = randn(HEAD_K, n, scale=0.004)
    b_head = randn(n, scale=0.01, dtype=torch.float32)
    per_forward = {name: dict(err=0.0, ms=0.0, plain=0.0, works=[])
                   for name in ("lvc_block_ncl_fh", "lvc_block_ncl_fh_final")}
    cases = [(8, FRAMES_10S, 1, False, True), (64, FRAMES_10S, 1, False, True),
             (256, FRAMES_10S, 1, False, False),
             (256, FRAMES_10S, 1, True, True), (64, 100, 2, False, False)]
    for hop, frames, b, final, on_path in cases:
        length = frames * hop
        x = randn(b, c, length)
        skip = randn(b, c, length)
        tap_c = randn(b, frames, HEAD_K)
        fwb = final_wb if final else None

        def run_k():
            return block_ops.lvc_block_ncl_fh(x, skip, tap_c, w_head, b_head,
                                              wstack_t, hop, fwb)

        def run_p():
            return block_ops.lvc_block_ncl_fh_plain(x, skip, tap_c, w_head,
                                                    b_head, wstack_t, hop,
                                                    fwb)

        def run_two():
            kern = lvc_head.taug_head_matmul(
                tap_c.view(b * frames, HEAD_K), w_head, b_head).view(
                    b, frames, layers, 2 * c, rows_p)
            return block_ops.lvc_block_ncl(x, skip, kern, wstack_t, hop, fwb)

        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        both = (lambda a, r: list(zip(a, r))) if final else (
            lambda a, r: [(a, r)])
        what = f"hop {hop}, {frames} frames, b {b}" + (
            ", with epilogue" if final else "")
        errs = check_pairs(both(got, ref), f"K5 tensor cores ({what})")
        ms_p1 = cuda_ms(run_p, 3)
        ms_k, ms_two = race_graph(run_two, run_k, 10)
        ms_p = (ms_p1 + cuda_ms(run_p, 3)) / 2
        head_flop, head_bytes = gemm_work(b * frames, HEAD_K, n)
        flop, nbytes = block_work(b, c, length, final=final)
        # the head's output never reaches memory: taps and weights in
        work = (flop + head_flop, nbytes + head_bytes - 2.0 * b * frames * n)
        b_ms, by = bound([work])
        plan = block_ops.fh_tile_plan(b, frames, hop)
        phase(16, f"K5 {what}: tensor cores " + ", ".join(
            f"max_abs_err {e:.3e} rel_l2 {r:.3e}" for e, r in errs)
            + f"; raced (CUDA graphs): tensor cores {ms_k:.4f} ms, K3 + K1 "
            f"{ms_two:.4f} ms; plain {ms_p:.4f} ms; "
            f"bound {b_ms:.4f} ms ({by}), tensor cores at {b_ms / ms_k:.1%} "
            f"of it; tile {plan.tile}, {plan.blocks} CTAs in {plan.waves} "
            f"wave(s), w_head {plan.l2_bytes / 1e9:.2f} GB from L2 into the "
            f"SMs ({plan.l2_bytes / 1e9 / ms_k:.2f} TB/s) [{smi_line}]")
        acc = per_forward["lvc_block_ncl_fh_final" if final
                          else "lvc_block_ncl_fh"]
        acc["err"] = max([acc["err"]] + [e for e, _ in errs])
        if on_path:
            acc["ms"] += ms_k
            acc["plain"] += ms_p
            acc["works"].append(work)
    return {name: entry(a["err"], a["ms"], a["plain"], a["works"])
            for name, a in per_forward.items()}


def phase17_fh_route(torch, FastDiff, exp_r4b, cfg, gen, dev):
    """The fused-head route's full-width forward, kernels against plain and
    against the NCL route, then its N = 4 sampler raced against the NCL
    route at b = 1 and b = 4 (experiment D)."""
    length = FRAMES_10S * HOP_SIZE
    audio = torch.randn((1, length, 1), generator=gen, device=dev)
    mel = torch.randn((1, FRAMES_10S, cfg.cond_channels), generator=gen,
                      device=dev)
    t = torch.full((1, 1), 498.0, device=dev)
    eps = {}
    for route in ("ncl_fh", "ncl"):
        model = FastDiff(cfg, seed=0, device=dev, infer_route=route).eval()
        for use in (True, False) if route == "ncl_fh" else (True,):
            model.use_kernels = use
            eps[route, use] = model(audio, mel, t)
        del model
    torch.cuda.synchronize()
    err = rel_l2(eps["ncl_fh", True], eps["ncl_fh", False])
    err_ncl = rel_l2(eps["ncl_fh", True], eps["ncl", True])
    phase(17, f"ncl_fh denoiser forward (1, {length}, 1) bf16: kernel vs "
              f"plain rel_l2 {err:.3e} (bound 5e-2), max_abs_err "
              f"{max_abs(eps['ncl_fh', True], eps['ncl_fh', False]):.3e}; "
              f"vs the ncl route rel_l2 {err_ncl:.3e} (bound 5e-2)")
    out = eps["ncl_fh", True]
    if out.shape != (1, length, 1) or not torch.isfinite(out).all():
        fail("ncl_fh denoiser output has the wrong shape or is not finite")
    if not (err <= 5e-2 and err_ncl <= 5e-2):
        fail("ncl_fh denoiser disagrees with its plain path or the ncl route")
    del eps
    report = exp_r4b.exp_d(dev, batches=(1, 4))
    for batch, row in report["batches"].items():
        phase(17, f"N=4 sampler, b {batch} x {FRAMES_10S} frames, CUDA "
                  "graphs raced in turns (eager beside them): " + ", ".join(
                      f"{r} {row[r]['ms']:.3f} ms ({row[r]['ms_per_item']:.3f}"
                      f" per item, {row[r]['x_realtime']:.1f} x realtime; "
                      f"runs {', '.join(f'{v:.3f}' for v in row[r]['runs'])};"
                      f" eager {row[r]['eager_ms']:.3f} ms)"
                      for r in ("ncl", "ncl_fh"))
                  + f"; max |ncl - ncl_fh| {row['max_abs_diff']:.3e}")
        if not np.isfinite(row["max_abs_diff"]):
            fail("the ncl_fh sampler output is not finite")
    return report


def phase18_head_variants(exp_r4b, dev, smi_line):
    """K10: every walk of experiment B at 100, 256 and 864 rows against its
    plain version, each raced against ``torch.addmm`` (CUDA graphs); the
    JSON keeps the script's first variant at 864 rows."""
    entries = {}
    for m in (100, 256, FRAMES_10S):
        report = exp_r4b.exp_b(dev, m=m)
        bound_err = report["err_bound"]
        b_ms, _ = bound([gemm_work(*report["shape"])])
        for row in report["variants"]:
            shape = "x".join(map(str, report["shape"]))
            phase(18, f"K10 {row['name']} ({shape}): max_abs_err {row['max_abs_err']:.3e} (bound "
                      f"{bound_err:.3e}); raced: kernel {row['ms']:.4f} ms, "
                      f"torch.addmm {row['library_ms']:.4f} ms; plain "
                      f"{row['plain_ms']:.4f} ms; {b_ms / row['ms']:.1%} of "
                      f"the bound {b_ms:.4f} ms [{smi_line}]")
            if not row["max_abs_err"] <= bound_err:
                fail(f"K10 {row['name']} disagrees with its plain version "
                     f"at M = {m}")
        phase(18, f"M = {m}: Kernel A (N-major walk) "
                  f"{report['taug_head_ms']:.4f} ms, torch.addmm {report['library_ms']:.4f} ms (raced, "
                  "CUDA graphs)")
        entries[m] = report
    report = entries[FRAMES_10S]
    shipped = report["variants"][0]
    return entry(max(r["max_abs_err"] for rep in entries.values()
                     for r in rep["variants"]),
                 shipped["ms"], shipped["plain_ms"],
                 [gemm_work(*report["shape"])], shipped["library_ms"])


def phase19_stages(micro, dev, smi_line):
    """K9: the conv and LVC stages at the hop-256 block's shape against
    their plain versions, each setting raced against its library call; the
    JSON keeps the wrappers' default settings."""
    report = micro.run(dev)
    defaults = {"conv_stage": ("tile_s", micro.CONV_TILE_S),
                "lvc_stage": ("tf", 1)}
    out = {}
    for name, (key, default) in defaults.items():
        stage = report[name]
        b_ms = stage["bound_ms"]
        phase(19, f"K9 {name}: every {key}'s output identical: "
                  f"{stage['identical']}")
        if not stage["identical"]:
            fail(f"K9 {name}'s output depends on {key}")
        for row in stage.get("ragged", ()):
            phase(19, f"K9 {name} {key}={row[key]} at (B, E) = "
                      f"{micro.RAGGED}: max_abs_err {row['max_abs_err']:.3e} "
                      f"(bound {row['err_bound']:.3e}) rel_l2 "
                      f"{row['rel_l2']:.3e}")
            if not (row["max_abs_err"] <= row["err_bound"]
                    and row["rel_l2"] <= 1e-2):
                fail(f"K9 {name} ({key}={row[key]}) disagrees with its plain "
                     f"version at {micro.RAGGED}")
        for row in stage["rows"]:
            phase(19, f"K9 {name} {key}={row[key]} (L {report['length']}): "
                      f"max_abs_err {row['max_abs_err']:.3e} (bound "
                      f"{row['err_bound']:.3e}) rel_l2 {row['rel_l2']:.3e}; "
                      f"raced: kernel {row['ms']:.4f} ms, library "
                      f"{row['library_ms']:.4f} ms; plain "
                      f"{row['plain_ms']:.4f} ms; {b_ms / row['ms']:.1%} of "
                      f"the bound {b_ms:.4f} ms ({stage['bound_by']}) "
                      f"[{smi_line}]")
            if not (row["max_abs_err"] <= row["err_bound"]
                    and row["rel_l2"] <= 1e-2):
                fail(f"K9 {name} ({key}={row[key]}) disagrees with its plain "
                     "version")
        row = next(r for r in stage["rows"] if r[key] == default)
        out[name] = dict(max_abs_err=max(r["max_abs_err"]
                                         for r in stage["rows"]),
                         ms=row["ms"], plain_ms=row["plain_ms"],
                         bound_ms=b_ms, bound_by=stage["bound_by"],
                         library_ms=row["library_ms"])
    phase(19, f"gate_stage (plain, f32) {report['gate_stage_ms']:.4f} ms")
    return out


# the hand-written kernels a denoiser forward can reach, by the name the
# profiler gives them, and the launch counters that count them (one count of
# either K8 layout, downpath (NWC) or downpath_ncl, launches both of its
# stage kernels)
KERNEL_COUNTERS = {
    "head_gemm_kernel": ("taug_head", "aug_head", "taug_head_variant"),
    "lvc_block_tc_kernel": ("lvc_block_ncl", "lvc_block_ncl_final",
                            "lvc_block_ncl_sr"),
    "lvc_block_fh_tc_kernel": ("lvc_block_ncl_fh", "lvc_block_ncl_fh_final"),
    "lvc_block_nwc_tc_kernel": ("lvc_block_nwc",),
    "down_stage1": ("downpath", "downpath_ncl"),
    "down_stage2": ("downpath", "downpath_ncl"),
    "wavenet_block_kernel": ("wavenet_block",),
}


def k8_per_call(frames: int, steps: int = 1) -> int:
    """K8's NCL count (``downpath_ncl``) on the ncl / ncl_fh routes for one
    call of ``steps`` denoiser forwards at ``frames`` frames: one a forward
    where the length is ``downpath_fusable`` (a multiple of 2048 samples, at
    least two)."""
    from fastdiff_tpu_torch.ops.downpath_pallas import (KERNEL_FACTORS,
                                                        downpath_fusable)
    return steps if downpath_fusable(frames * HOP_SIZE, KERNEL_FACTORS) \
        else 0


def replayed_kernels(torch, call, per_replay: dict, what: str) -> dict:
    """Profile one ``call`` (one replay of a captured graph) and count the
    hand-written kernels it ran by name; fail unless each count equals
    what the launch counters gain per replay (``per_replay``, {counter
    key: launches}, as the sampler recorded it at capture)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        fail(f"{what}: the profile of a replay holds no device event")
    seen = {kernel: sum(bool(re.search(rf"(?<![A-Za-z_]){kernel}", name))
                        for name in names)
            for kernel in KERNEL_COUNTERS}
    want = {kernel: sum(per_replay.get(key, 0) for key in keys)
            for kernel, keys in KERNEL_COUNTERS.items()}
    if seen != want:
        fail(f"{what}: a replay ran kernels {seen}; the counters add {want}")
    return {k: v for k, v in seen.items() if v}


def phase20_graph_sampler(torch, FastDiff, sampler_mod, FastDiffVocoder,
                          cfg, dev, smi_line) -> dict:
    """The graph sampler at full width, N = 4, 864 frames, b = 1: (a) graph
    against eager per route (seeded generator and injected noise, rel L2
    <= 1e-6), raced in turns, and one replay's kernels, profiled, against
    the launches it adds to the counters; (b) a reload after capture
    follows the new weights with no recapture, and ``assign=True`` drops
    the graph and captures again; (c) the NCL line again at torch's
    default settings (cuDNN TF32 on); (d) the chunked vocoder on 3,000
    frames through one graph; (e) the cache bound of ``max_graphs``; (f)
    a capture that syncs with the host raises, and the same sampler then
    captures and replays a good one."""
    const = sampler_mod.constants_for_hparams({"N": 4})
    length = FRAMES_10S * HOP_SIZE
    audio_s = length * AUDIO_SECONDS_PER_SAMPLE
    mel = torch.randn((1, FRAMES_10S, cfg.cond_channels),
                      generator=torch.Generator(device=dev).manual_seed(20),
                      device=dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def make(route, seed=0):
        return FastDiff(cfg, seed=seed, device=dev, infer_route=route,
                        down_kernel=route == "nwc").eval()

    def eager(model, **kw):
        with torch.inference_mode():
            return sampler_mod.sample(model, mel, const, length, **kw)

    def checked(what, got, want):
        torch.cuda.synchronize()
        if got.shape != (1, length, 1) or not torch.isfinite(got).all():
            fail(f"{what}: graph output has the wrong shape or is not finite")
        err = rel_l2(got, want)
        if not err <= 1e-6:
            fail(f"{what}: graph vs eager rel_l2 {err:.3e} > 1e-6")
        return f"rel_l2 {err:.3e} (bound 1e-6), bit-identical " \
               f"{bool(torch.equal(got, want))}"

    x_t = torch.randn((1, length, 1), generator=gen(2), device=dev)
    zs = [torch.randn((1, length, 1), generator=gen(3 + i), device=dev)
          for i in range(const.n_steps)]
    out = {}

    def against_eager(route, settings):
        model = make(route)
        run = sampler_mod.make_sampler(model, const)
        want = eager(model, generator=gen(1))
        first = checked(f"{route} first call (eager warm-up)",
                        run(gen(1), mel, length), want)
        seeded = checked(f"{route} seeded", run(gen(1), mel, length), want)
        injected = checked(f"{route} injected noise",
                           run(None, mel, length, noise=(x_t, zs)),
                           eager(model, noise=(x_t, zs)))
        race = race_sampler(lambda: run(gen(1), mel, length),
                            lambda: eager(model, generator=gen(1)))
        if run.captures != 1 or run.warmups != 1:
            fail(f"{route}: {run.warmups} warm-ups and {run.captures} "
                 "captures at one shape")
        kernels = replayed_kernels(
            torch, lambda: run(gen(1), mel, length),
            run.replay_launches(mel, length), f"{route} replay")
        phase(20, f"{route} [{settings}]: first call {first}; graph seeded "
                  f"{seeded}; injected noise {injected}; one replay ran "
                  f"{kernels or 'no hand-written kernel'}, as the counters "
                  "add; " + sampler_line("raced", race, audio_s)
                  + f" [{smi_line}]")
        return {k: r["ms"] for k, r in race.items()}

    script = "chip_smoke settings: TF32 off in matmuls and cuDNN"
    for route in ("ncl", "nwc", "ncl_fh", "plain"):
        out[route] = against_eager(route, script)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        out["ncl_torch_defaults"] = against_eager(
            "ncl", "torch defaults, as the vocoder runs: cuDNN TF32 on, "
            "matmul TF32 off")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved

    # (b) a reload after capture
    model = make("ncl")
    prun = sampler_mod.make_param_sampler(model, const)
    for _ in range(2):
        prun(None, gen(1), mel, length)
    ptrs = [t.data_ptr() for t in list(model.parameters())
            + list(model.buffers())]
    in_place = checked("reload seed 1",
                       prun(make("ncl", 1).state_dict(), gen(1), mel, length),
                       eager(make("ncl", 1), generator=gen(1)))
    kept = ptrs == [t.data_ptr() for t in list(model.parameters())
                    + list(model.buffers())]
    if prun.captures != 1 or not kept:
        fail(f"a reload recaptured ({prun.captures} captures) or moved "
             f"storage (kept: {kept})")
    model.load_state_dict({k: v.clone() for k, v in
                           make("ncl", 2).state_dict().items()}, assign=True)
    want = eager(make("ncl", 2), generator=gen(1))
    checked("assign=True seed 2, first call", prun(None, gen(1), mel, length),
            want)
    if prun.recaptures != 1 or prun.graphs_cached != 0:
        fail(f"assign=True: {prun.recaptures} drops, {prun.graphs_cached} "
             "graphs held; expected 1 and 0")
    assigned = checked("assign=True seed 2", prun(None, gen(1), mel, length),
                       want)
    if prun.captures != 2:
        fail(f"assign=True: {prun.captures} captures; expected 2")
    phase(20, f"reload after capture (seed 1, in place): {in_place}, every "
              "storage kept, captures 1; load_state_dict(assign=True) "
              f"(seed 2): graph dropped ({prun.recaptures}), first call "
              f"eager, second captured: {assigned}, captures {prun.captures}")
    del model, prun

    # (d) the chunked vocoder on a long utterance
    voc = FastDiffVocoder({"N": 4, "chunked_infer_frames": 256}, device=dev)
    frames = 3000
    long_mel = (np.random.default_rng(20).normal(
        size=(frames, cfg.cond_channels)) - 4.0).astype(np.float32)
    walls, reserved = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev))
        t0 = time.perf_counter()
        wav = voc.spec2wav(long_mel)
        walls.append((time.perf_counter() - t0) * 1e3)
        if wav.shape != (frames * HOP_SIZE,) or not np.isfinite(wav).all():
            fail("chunked vocoder output has the wrong shape or is not "
                 "finite")
    if voc.sampler.captures != 1 or voc.sampler.warmups != 1:
        fail(f"the chunked vocoder warmed {voc.sampler.warmups} and "
             f"captured {voc.sampler.captures} graphs")
    core = voc.chunked.chunk - 2 * voc.chunked.halo
    long_s = frames * HOP_SIZE * AUDIO_SECONDS_PER_SAMPLE
    phase(20, f"chunked vocoder, {frames} frames ({long_s:.2f} s), chunks "
              f"of 256 frames (halo 16): {-(-frames // core)} chunks in one "
              f"call, one graph ({voc.sampler.captures} capture); wall per "
              f"call: first (eager) {walls[0]:.1f} ms, second (capture) "
              f"{walls[1]:.1f} ms, third (replay) {walls[2]:.1f} ms "
              f"({long_s / (walls[2] / 1e3):.1f} x realtime); "
              f"memory_reserved around the capture {reserved[1] / 2**20:.0f}"
              f" -> {reserved[2] / 2**20:.0f} MiB "
              f"(+{(reserved[2] - reserved[1]) / 2**20:.0f}) [{smi_line}]")
    out["chunked_3000_ms"] = walls[2]
    del voc, wav

    # (e) the cache bound
    voc = FastDiffVocoder({"N": 4}, device=dev)
    cap = voc.sampler.max_graphs
    counts = [FRAMES_10S - 8 * i for i in range(cap + 2)]
    reserved = []
    for n in counts:
        for _ in range(2):
            voc.spec2wav(long_mel[:n])
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev))
    if voc.sampler.graphs_cached != cap or voc.sampler.captures != cap + 2:
        fail(f"cache holds {voc.sampler.graphs_cached} graphs after "
             f"{voc.sampler.captures} captures; expected {cap} of {cap + 2}")
    if max(reserved[cap:]) > reserved[cap - 1]:
        fail(f"memory_reserved grew past the first {cap} graphs: "
             f"{reserved[cap - 1]} -> {max(reserved[cap:])}")
    phase(20, f"cache bound: {cap + 2} frame counts ({counts[0]} down to "
              f"{counts[-1]}), each twice -> {voc.sampler.graphs_cached} "
              f"graphs kept, {voc.sampler.captures} captures; "
              "memory_reserved after each (MiB) "
              + ", ".join(f"{r / 2**20:.0f}" for r in reserved))
    del voc

    # (f) a failed capture raises; nothing falls back to the eager loop, and
    # the same sampler captures again on a new stream and pool
    class HostSync(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner, self.sync = inner, True

        def forward(self, x, m, t):
            if self.sync:                     # a host read: not capturable
                x = x * float(x.abs().max() >= 0)
            return self.inner(x, m, t)

    model = HostSync(make("ncl"))
    run = sampler_mod.make_sampler(model, const)
    want = eager(model.inner, generator=gen(1))
    checked("host-syncing model, first call", run(gen(1), mel, length), want)
    try:
        run(gen(1), mel, length)
    except RuntimeError as e:
        raised = f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"
    else:
        fail("a capture that reads the device from the host did not raise")
    if run.graphs_cached or run.captures:
        fail("a failed capture left a graph in the cache")
    if torch.cuda.current_stream(dev) != torch.cuda.default_stream(dev):
        fail("a failed capture left its stream current")
    torch.cuda.synchronize()
    model.sync = False
    checked("after the failed capture, first call", run(gen(1), mel, length),
            want)
    recovered = checked("after the failed capture, graph",
                        run(gen(1), mel, length), want)
    if run.captures != 1 or run.graphs_cached != 1:
        fail(f"after a failed capture: {run.captures} captures, "
             f"{run.graphs_cached} graphs held; expected 1 and 1")
    phase(20, f"a capture that reads the device from the host raised "
              f"({raised}); nothing cached, the default stream current; "
              "then the same sampler warmed, "
              f"captured and replayed the NCL model: {recovered}")
    return out


def synth_wav(seconds: float, seed: int) -> np.ndarray:
    """A swept sine with two harmonics, vibrato and noise at 22.05 kHz (the
    repository holds no audio)."""
    rng = np.random.default_rng(seed)
    sr = int(round(1 / AUDIO_SECONDS_PER_SAMPLE))
    t = np.arange(int(round(seconds * sr))) / sr
    f0 = 110 + 60 * seed + 80 * t / seconds + 6 * np.sin(2 * np.pi * 5 * t)
    ph = 2 * np.pi * np.cumsum(f0) / sr
    wav = 0.35 * np.sin(ph) + 0.12 * np.sin(2 * ph) + 0.06 * np.sin(3 * ph)
    return (wav + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def phase21_entry(torch, counters, dev, smi_line) -> dict:
    """The port's entry path at full width (``fastdiff_tpu/configs/
    ljspeech.yaml``, N = 4): ``run.main([... '--infer'])`` on a wav dir and
    on a mel dir (K3 +12, K1 +8, K2 +4, K8 +4 per utterance; the two
    utterances of the 384-frame bucket add one capture), ``use_pallas_block=false``
    against ``auto`` (rel L2 <= 5e-2),
    ``--infer`` on the work dir of a 2-step ``fit`` with an EMA, the CLI as
    a subprocess, ``vocoder: GLMel`` on the card against the CPU, and
    ``scripts/vocode.py``."""
    from fastdiff_tpu_torch import run
    from fastdiff_tpu_torch.config import AudioConfig
    from fastdiff_tpu_torch.ops import dsp
    from fastdiff_tpu_torch.scripts import vocode
    from fastdiff_tpu_torch.utils import audio_io
    from fastdiff_tpu_torch.vocoders.base import get_vocoder_cls

    repo = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(repo, "fastdiff_tpu", "configs", "ljspeech.yaml")
    yaml_before = "yaml" in sys.modules
    root = tempfile.mkdtemp(prefix="fastdiff_entry_")
    cwd = os.getcwd()
    report = {}
    try:
        os.chdir(root)
        wav_dir, mel_dir = os.path.join(root, "wavs"), os.path.join(root,
                                                                    "mels")
        os.makedirs(wav_dir)
        os.makedirs(mel_dir)
        cfg = AudioConfig()
        frames = {}
        for i, sec in enumerate((1.2, 3.0, 3.3, 10.0)):
            wav = synth_wav(sec, i)
            name = f"utt{i}_{sec:g}s"
            audio_io.save_wav(wav, os.path.join(wav_dir, f"{name}.wav"),
                              cfg.sample_rate)
            mel = dsp.wav2mel_np(wav, cfg)[1].T
            np.save(os.path.join(mel_dir, f"{name}.npy"), mel)
            frames[name] = mel.shape[0]
        # every mel is padded to a 128-frame bucket, a K8 (NCL) length
        per = {"taug_head": 12, "lvc_block_ncl": 8, "lvc_block_ncl_final": 4,
               "downpath_ncl": k8_per_call(128, 4), "downpath": 0}

        def infer(exp, source, path, extra="", rise=per):
            for counter in counters:
                for key in counter:
                    counter[key] = 0
            t0 = time.perf_counter()
            results = run.main(["--config", config, "--exp_name", exp,
                                "--infer", "--hparams",
                                f"{source}={path},N=4{extra}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for counter in counters
                        for k, v in counter.items() if k in per}
            gen = os.path.join(root, "checkpoints", exp)
            (gen,) = [os.path.join(gen, d) for d in os.listdir(gen)
                      if d.startswith("generated_")]
            wavs = {}
            for r in results:
                key = r["item_name"].rsplit(".", 1)[0]
                wav, _ = audio_io.load_wav(os.path.join(
                    gen, f"{r['item_name']}_pred.wav"))
                if len(wav) != frames[key] * HOP_SIZE or r["frames"] != \
                        frames[key] or not np.isfinite(wav).all():
                    fail(f"{exp}: {r['item_name']} wrote {len(wav)} "
                         f"samples for {frames[key]} frames, or non-finite")
                wavs[key] = wav
            if sorted(wavs) != sorted(frames):
                fail(f"{exp}: wrote {sorted(wavs)}, expected {sorted(frames)}")
            want = {k: v * len(results) for k, v in rise.items()}
            if launches != want:
                fail(f"{exp}: launches {launches}, expected {want}")
            phase(21, f"{exp} ({source}): " + ", ".join(
                f"{r['item_name']} {r['frames']} -> {r['padded_frames']} "
                f"frames rtf {r['rtf']:.5f}" for r in results)
                + f"; mean RTF (excl. first) "
                f"{np.mean([r['rtf'] for r in results[1:]]):.5f}; captures "
                f"{[r['captures'] for r in results]}; launches {launches}; "
                f"wall {wall:.2f} s [{smi_line}]")
            return results, wavs, os.path.basename(gen)

        for source, path in (("test_input_dir", wav_dir),
                             ("test_mel_dir", mel_dir)):
            exp = "wavs" if source == "test_input_dir" else "mels"
            results, wavs, _ = infer(exp, source, path)
            # utt1 (259 frames) and utt2 (285) share the 384-frame bucket:
            # the first warms, the second captures; the others warm alone
            if [r["captures"] for r in results] != [0, 0, 1, 1]:
                fail(f"{exp}: captures {[r['captures'] for r in results]}, "
                     "expected one capture for the 384-frame bucket")
            report[exp] = [dict(item=r["item_name"], frames=r["frames"],
                                rtf=r["rtf"]) for r in results]
            if source == "test_mel_dir":
                auto_wavs = wavs
        _, plain_wavs, _ = infer("mels_plain", "test_mel_dir", mel_dir,
                                 ",use_pallas_block=False",
                                 rise={k: 0 for k in per})
        errs = {k: rel_l2(torch.from_numpy(plain_wavs[k]),
                          torch.from_numpy(auto_wavs[k])) for k in frames}
        phase(21, "use_pallas_block=False vs auto, same seed, written "
                  "wavs: rel_l2 " + ", ".join(f"{k} {v:.3e}"
                                              for k, v in errs.items())
                  + " (bound 5e-2)")
        if not max(errs.values()) <= 5e-2:
            fail("the plain route's wavs disagree with the kernel route's")

        # a 2-step fit with an EMA, then --infer on its work dir, which
        # reads the config.yaml the fit saved
        binary = os.path.join(root, "binary")
        os.makedirs(binary)
        write_synthetic_dataset(binary)
        micro = os.path.join(repo, "fastdiff_tpu", "configs", "micro_lj.yaml")
        fit = run.main(["--config", micro, "--exp_name", "trained", "--reset",
                        "--hparams", f"binary_data_dir={binary},max_updates=2,"
                        "val_check_interval=2,num_sanity_val_steps=0,"
                        "tb_log_interval=1,eval_max_batches=1"])
        if fit["step"] != 2 or not np.isfinite(fit["val"]["loss"]):
            fail(f"fit ended at step {fit['step']}, val {fit['val']}")
        for counter in counters:
            for key in counter:
                counter[key] = 0
        results = run.main(["--exp_name", "trained", "--infer", "--hparams",
                            f"test_mel_dir={mel_dir},N=4"])
        gens = os.listdir(os.path.join(root, "checkpoints", "trained"))
        launches = {k: v for counter in counters for k, v in counter.items()
                    if k in per}
        phase(21, f"trained: fit 2 steps (ema_decay 0.999), loss "
                  f"{fit['val']['loss']:.4f}; --infer on its work dir (saved "
                  f"config.yaml) wrote {len(results)} items into "
                  f"{[g for g in gens if g.startswith('generated_')]}, "
                  f"launches {launches}")
        if "generated_2_" not in gens or len(results) != len(frames) or \
                launches != {k: v * len(frames) for k, v in per.items()}:
            fail("--infer on the trained work dir did not restore step 2 "
                 "or launch the kernels of its path")
        if "yaml" in sys.modules and not yaml_before:
            fail("set_hparams imported PyYAML")

        # the real CLI in its own process
        env = dict(os.environ, PYTHONPATH=repo)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fastdiff_tpu_torch.run", "--config",
             config, "--exp_name", "cli", "--infer", "--hparams",
             f"test_mel_dir={mel_dir},N=4"], cwd=root, env=env,
            capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        cli_dir = os.path.join(root, "checkpoints", "cli", "generated_0_")
        written = sorted(os.listdir(cli_dir)) if os.path.isdir(cli_dir) \
            else []
        phase(21, f"python -m fastdiff_tpu_torch.run (subprocess): exit "
                  f"{proc.returncode} in {cli_s:.1f} s, wrote {written}; "
                  f"{[ln for ln in proc.stdout.splitlines() if 'RTF' in ln]}")
        if proc.returncode != 0 or len(written) != len(frames):
            fail(f"the CLI failed: {proc.stderr[-2000:]}")

        # vocoder: GLMel on the card against the CPU
        hp = {"vocoder": "GLMel"}
        mel = np.load(os.path.join(mel_dir, "utt0_1.2s.npy"))
        gl_gpu = get_vocoder_cls(hp)(hp, device=dev)
        gl_cpu = get_vocoder_cls(hp)(hp, device="cpu")
        gl_gpu.spec2wav(mel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_gpu = gl_gpu.spec2wav(mel)
        gl_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        y_cpu = gl_cpu.spec2wav(mel)
        gl_cpu_ms = (time.perf_counter() - t0) * 1e3
        linear = torch.from_numpy(dsp.mel_to_linear_np(mel.T, cfg))[None]
        phase0 = (torch.rand(linear.shape,
                             generator=torch.Generator().manual_seed(0))
                  * 2 - 1) * np.pi
        short = [dsp.griffin_lim(linear.to(d), cfg, n_iters=3,
                                 phase=phase0).cpu() for d in (dev, "cpu")]
        short_err = rel_l2(short[0], short[1])

        def convergence(y):
            spec = dsp.stft_magnitude_np(y, cfg.fft_size, cfg.hop_size,
                                         cfg.win_size)
            n = min(spec.shape[1], linear.shape[2])
            want = linear[0, :, :n].numpy()
            return float(np.linalg.norm(spec[:, :n] - want)
                         / np.linalg.norm(want))
        sc_gpu, sc_cpu = convergence(y_gpu), convergence(y_cpu)
        phase(21, f"GLMel, {mel.shape[0]} frames, 60 iterations: card "
                  f"{gl_ms:.1f} ms wall, CPU {gl_cpu_ms:.1f} ms; spectral "
                  f"convergence card {sc_gpu:.4f} vs CPU {sc_cpu:.4f} "
                  f"(bound: within 5 %); 3 iterations from one phase, card "
                  f"vs CPU rel_l2 {short_err:.3e} (bound 1e-4); 60: rel_l2 "
                  f"{rel_l2(torch.from_numpy(y_gpu), torch.from_numpy(y_cpu)):.3e} "
                  f"[{smi_line}]")
        if y_gpu.shape != (mel.shape[0] * HOP_SIZE,) or \
                not np.isfinite(y_gpu).all():
            fail("GLMel on the card: wrong shape or not finite")
        if not (short_err <= 1e-4 and sc_gpu <= 1.05 * sc_cpu):
            fail("GLMel on the card disagrees with the CPU")
        report["glmel_ms"] = gl_ms

        # scripts/vocode.py on the mel dir
        t0 = time.perf_counter()
        code = vocode.main(["--config", config, "--input", mel_dir, "--out",
                            os.path.join(root, "vocoded"), "--hparams",
                            "N=4", "--batch", "1"])
        voc_s = time.perf_counter() - t0
        out = sorted(os.listdir(os.path.join(root, "vocoded")))
        for name in out:
            wav, _ = audio_io.load_wav(os.path.join(root, "vocoded", name))
            if len(wav) != frames[name[:-4]] * HOP_SIZE:
                fail(f"vocode.py wrote {len(wav)} samples for {name}")
        phase(21, f"scripts/vocode.py: exit {code}, wrote {out} in "
                  f"{voc_s:.2f} s")
        if code != 0 or len(out) != len(frames):
            fail("scripts/vocode.py failed")
        return report
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)


# LJSpeech-style sentences (LJ001-0001 the longest); the grapheme fallback
# of the ``en`` processor (no g2p_en) gives 23 to 152 tokens
TTS_SENTENCES = (
    "Good morning, everyone.",
    "The examination and testimony of the experts enabled the commission "
    "to conclude.",
    "He likewise indicated he was disenchanted with Russia and that he "
    "wanted to go back to the United States.",
    "Printing, in the only sense with which we are at present concerned, "
    "differs from most if not from all the arts and crafts represented in "
    "the Exhibition.")
TEACHER_FRAMES_PER_PHONE = 6     # about LJSpeech's mean phone at hop 256


def phase22_tts(torch, counters, all_counters, dev, smi_line) -> dict:
    """The TTS serving path at the full width of ``fastdiff_tpu/configs/
    fs2_ljspeech.yaml`` (FastSpeech 2 seed-0 weights; the FastDiff vocoder
    at ``ljspeech.yaml``'s settings, seed weights, N = 4, ``auto`` ->
    ``ncl``), with a phone set written from the ``en`` processor's output on
    the sentences, as the binarizer would: (a) ``FastSpeech2Task.
    infer_to_wav`` of each sentence (predicted durations): frames, wav
    length, K3 +12 / K1 +8 / K2 +4 per call and K8 +4 where the frame count
    is ``downpath_fusable``, the graph sampler's warm-ups
    and captures; (b) teacher durations of 6 frames a phone: the card's mel
    against the CPU's (TF32 off, rel L2 <= 1e-4), the predicted mel2ph card
    against CPU (equal), the written wavs of ``use_pallas_block: false``
    against ``auto`` (rel L2 <= 5e-2, no kernel under false); (c) FastSpeech
    2 ms (t_mel = max_frames), vocoder ms and the RTF of ``infer_to_wav`` by
    CUDA events; (d) ``python -m fastdiff_tpu_torch.scripts.demo_tts`` as a
    subprocess on the teacher mels, and no jax, ``fastdiff_tpu`` or PyYAML
    imported."""
    from fastdiff_tpu_torch.models.fastspeech2 import (FastSpeech2,
                                                       dur_to_mel2ph,
                                                       mel2ph_to_dur)
    from fastdiff_tpu_torch.text.encoder import build_token_encoder
    from fastdiff_tpu_torch.text.processors import get_txt_processor_cls
    from fastdiff_tpu_torch.training.tts_task import FastSpeech2Task
    from fastdiff_tpu_torch.tts.infer import NpyMelSource, TTSPipeline
    from fastdiff_tpu_torch.utils import audio_io
    from fastdiff_tpu_torch.utils.hparams import set_hparams

    repo = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(repo, "fastdiff_tpu", "configs",
                          "fs2_ljspeech.yaml")
    yaml_before = "yaml" in sys.modules
    root = tempfile.mkdtemp(prefix="fastdiff_tts_")
    per = {"taug_head": 12, "lvc_block_ncl": 8, "lvc_block_ncl_final": 4,
           "downpath_ncl": 0, "downpath": 0}

    def per_utt(frames):
        """A call's launches: K8 (NCL) only at a fusable length (the mel
        is vocoded at its own frame count), the NWC layout never."""
        return {**per, "downpath_ncl": k8_per_call(frames, 4)}

    def zero():
        for counter in all_counters:
            for key in counter:
                counter[key] = 0

    def read():
        return {k: v for counter in counters for k, v in counter.items()
                if k in per}

    try:
        en = get_txt_processor_cls("en")
        phones = [en.process(text)[0] for text in TTS_SENTENCES]
        binary = os.path.join(root, "binary")
        os.makedirs(binary)
        with open(os.path.join(binary, "phone_set.json"), "w") as f:
            json.dump(sorted({p for ph in phones for p in ph}), f)
        hp = set_hparams(config=config, hparams_str=f"binary_data_dir="
                         f"{binary},N=4", print_hparams=False,
                         global_hparams=False)
        encoder = build_token_encoder(os.path.join(binary, "phone_set.json"))
        tokens = [np.asarray(encoder.encode(" ".join(ph))) for ph in phones]
        task = FastSpeech2Task(hp, device=dev)
        state = task.build_state(seed=0)
        model = state.model.eval()
        cfg = task.model_cfg
        n_params = sum(p.numel() for p in model.parameters())
        tf32 = (f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
                f"cuDNN {torch.backends.cudnn.allow_tf32}")
        phase(22, f"fs2_ljspeech.yaml: FastSpeech 2 hidden {cfg.hidden}, "
                  f"{cfg.enc_layers} + {cfg.dec_layers} layers, "
                  f"{cfg.num_heads} heads, FFN {cfg.ffn_hidden} k "
                  f"{cfg.ffn_kernel}, vocab {cfg.vocab_size}, max_frames "
                  f"{cfg.max_len}, {n_params / 1e6:.2f} M params (seed 0); "
                  f"vocoder fastdiff, use_pallas_block "
                  f"{hp.get('use_pallas_block')}, N = 4; {tf32} (chip_smoke "
                  f"settings, as the served path below runs)")

        def forward(tok, **kw):
            t = torch.as_tensor(tok, device=dev)[None]
            return model(t, **kw)

        # (a) predicted durations, through infer_to_wav
        rows = []
        sampler = None
        for i, tok in enumerate(tokens):
            zero()
            t0 = time.perf_counter()
            wav = task.infer_to_wav(state, tok, os.path.join(
                root, f"pred_{i}.wav"))
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launches = read()
            sampler = task.vocoder.sampler
            with torch.no_grad():
                out = forward(tok)
            frames = int(out["mel_mask"].sum())
            dur = mel2ph_to_dur(out["mel2ph"], len(tok))[0]
            x = torch.exp(out["dur_pred"][0]) - 1.0
            ties = int(((x - torch.floor(x) - 0.5).abs() < 1e-4).sum())
            audio_s = frames * HOP_SIZE * AUDIO_SECONDS_PER_SAMPLE
            if len(wav) != frames * HOP_SIZE or not np.isfinite(wav).all():
                fail(f"utterance {i}: {len(wav)} samples for {frames} "
                     "frames, or not finite")
            if launches != per_utt(frames):
                fail(f"utterance {i}: launches {launches}, expected "
                     f"{per_utt(frames)}")
            rows.append(dict(words=len(TTS_SENTENCES[i].split()),
                             tokens=len(tok), frames=frames,
                             frames_gt_1=int((dur > 1).sum()), ties=ties,
                             first_s=first_s, first_rtf=first_s / audio_s,
                             warmups=sampler.warmups,
                             captures=sampler.captures))
        phase(22, "(a) infer_to_wav, predicted durations: " + "; ".join(
            f"{r['words']} words, {r['tokens']} tokens -> {r['frames']} "
            f"frames ({r['frames_gt_1']} phones longer than 1 frame, "
            f"{r['ties']} durations within 1e-4 of a rounding tie), first "
            f"call {r['first_s'] * 1e3:.1f} ms (RTF {r['first_rtf']:.4f}), "
            f"warm-ups {r['warmups']}, captures {r['captures']}"
            for r in rows) + f"; launches per utterance {per} (K8 4 at "
            f"a multiple of 8 frames, at least 16). Seed "
            f"weights: {sum(r['frames_gt_1'] for r in rows)} of "
            f"{sum(r['tokens'] for r in rows)} phones get more than one "
            "frame (exp(dur_pred) - 1 rounds to about 0), so the mels are "
            "short; each new frame count is a new graph shape (its first "
            "call eager, none captured: JAX's infer_to_wav pads no mel) "
            f"[{smi_line}]")

        # (b) teacher durations; the card against the CPU, TF32 off
        cpu_model = FastSpeech2(cfg).eval()
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        mel_dir = os.path.join(root, "mels")
        os.makedirs(mel_dir)
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            for i, (tok, row) in enumerate(zip(tokens, rows)):
                dur = torch.full((1, len(tok)), float(
                    TEACHER_FRAMES_PER_PHONE))
                mel2ph = dur_to_mel2ph(dur, TEACHER_FRAMES_PER_PHONE
                                       * len(tok))
                t = torch.as_tensor(tok)[None]
                with torch.no_grad():
                    card = forward(tok, mel2ph=mel2ph.to(dev))
                    cpu = cpu_model(t, mel2ph=mel2ph)
                    pred_card = forward(tok)["mel2ph"].cpu()
                    pred_cpu = cpu_model(t)["mel2ph"]
                row["teacher_frames"] = mel2ph.shape[1]
                row["teacher_rel_l2"] = rel_l2(card["mel"].cpu(), cpu["mel"])
                row["mel2ph_equal"] = bool(torch.equal(pred_card, pred_cpu))
                np.save(os.path.join(mel_dir, f"utt{i}.npy"),
                        card["mel"][0].cpu().numpy())
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
        phase(22, f"(b) teacher durations ({TEACHER_FRAMES_PER_PHONE} frames "
                  "a phone), TF32 off: " + "; ".join(
                      f"{r['teacher_frames']} frames: card vs CPU mel rel_l2 "
                      f"{r['teacher_rel_l2']:.3e}, predicted mel2ph equal "
                      f"{r['mel2ph_equal']}" for r in rows)
                  + " (bounds 1e-4, equal)")
        if not all(r["teacher_rel_l2"] <= 1e-4 and r["mel2ph_equal"]
                   for r in rows):
            fail("FastSpeech 2 on the card disagrees with the CPU")

        # (c) times on the replayed shape, by CUDA events
        for tok, row in zip(tokens, rows):
            zero()
            row["infer_ms"] = cuda_ms(
                lambda: task.infer_to_wav(state, tok, ""), 2)
            if read() != {k: 3 * v for k, v in
                          per_utt(row["frames"]).items()}:
                fail(f"steady-state infer_to_wav launched {read()}")
            row["captures_after"] = sampler.captures
            with torch.no_grad():
                row["fs2_ms"] = cuda_ms(lambda: forward(tok), 3)
                mel = task.infer_mel(state, tok)
            row["vocoder_ms"] = cuda_ms(lambda: task.vocoder.spec2wav(mel),
                                        2)
            audio_ms = row["frames"] * HOP_SIZE * AUDIO_SECONDS_PER_SAMPLE \
                * 1e3
            row["rtf"] = row["infer_ms"] / audio_ms
        phase(22, "(c) per utterance, replayed graph: " + "; ".join(
            f"{r['frames']} frames: FastSpeech 2 forward (t_mel "
            f"{cfg.max_len}) {r['fs2_ms']:.3f} ms, vocoder {r['vocoder_ms']:.3f}"
            f" ms, infer_to_wav {r['infer_ms']:.3f} ms, RTF {r['rtf']:.5f}"
            for r in rows) + f"; captures {[r['captures_after'] for r in rows]}"
            f"; {tf32} [{smi_line}]")

        # (d) demo_tts in its own process on the teacher mels (auto), and
        # the plain route (use_pallas_block: false) in this one
        env = dict(os.environ, PYTHONPATH=repo)
        demo_out = os.path.join(root, "demo")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fastdiff_tpu_torch.scripts.demo_tts",
             "--config", config, "--mel_dir", mel_dir, "--out_dir", demo_out,
             "--hparams", "N=4"], cwd=root, env=env, capture_output=True,
            text=True, timeout=300)
        demo_s = time.perf_counter() - t0
        written = sorted(os.listdir(demo_out)) if os.path.isdir(demo_out) \
            else []
        phase(22, f"python -m fastdiff_tpu_torch.scripts.demo_tts "
                  f"(subprocess, auto): exit {proc.returncode} in "
                  f"{demo_s:.1f} s, wrote {written}")
        if proc.returncode != 0 or len(written) != len(tokens):
            fail(f"demo_tts failed: {proc.stderr[-2000:]}")
        zero()
        plain_hp = dict(hp, use_pallas_block=False)
        pipeline = TTSPipeline(plain_hp, NpyMelSource(plain_hp, mel_dir),
                               device=dev)
        plain_dir = os.path.join(root, "plain")
        errs = []
        for i, row in enumerate(rows):
            name = f"utt{i}.wav"
            pipeline.synthesize("", out_wav=os.path.join(plain_dir, name))
            plain, _ = audio_io.load_wav(os.path.join(plain_dir, name))
            auto, _ = audio_io.load_wav(os.path.join(demo_out, name))
            if len(auto) != row["teacher_frames"] * HOP_SIZE or \
                    len(plain) != len(auto):
                fail(f"{name}: {len(auto)} / {len(plain)} samples for "
                     f"{row['teacher_frames']} frames")
            row["false_vs_auto"] = rel_l2(torch.from_numpy(plain),
                                          torch.from_numpy(auto))
            errs.append(row["false_vs_auto"])
        launched = {k: v for counter in all_counters
                    for k, v in counter.items() if v}
        phase(22, "use_pallas_block=False (TTSPipeline) vs auto (demo_tts), "
                  "same seed, written wavs of the teacher mels: rel_l2 "
                  + ", ".join(f"{e:.3e}" for e in errs)
                  + f" (bound 5e-2); kernels launched under false: "
                  f"{launched or 'none'}")
        if launched or not max(errs) <= 5e-2:
            fail("the plain route launched a kernel or disagrees with auto")
        if "yaml" in sys.modules and not yaml_before:
            fail("set_hparams imported PyYAML")
        return {"sentences": len(rows), "rows": rows,
                "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
                "device": smi_line}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 24: 48 training utterances (one batch of fs2_ljspeech.yaml's
# max_sentences) and 8 for validation (test_num), of 1-6 s
FS2_TRAIN, FS2_VALID = 48, 8
FS2_SENTENCES = TTS_SENTENCES + (
    "It was a bright cold day in April.",
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "These days a chicken leg is a rare dish.",
    "The commission also found that the procedures were not adequate.",
    "A large crowd gathered near the old stone bridge at noon.",
    "Rice is often served in round bowls.",
    "He wrote a long letter to the editor of the local paper, asking "
    "for an apology.")
FS2_STEPS, FS2_VAL_EVERY, FS2_FIXED_STEPS = 30, 15, 20
# per-tensor gradient bound of the card-vs-CPU step: a few ReLU inputs of
# the 154 M land across 0 from float64 in float32 (on the card 4 of the
# 7.5 M in encoder.1's FFN), each switching its unit's gradient on or off;
# the LayerNorm before that FFN then takes ~2e-4 of error into its scale's
# gradient, while every op alone errs < 1e-6 (phase 24(b) prints both)
FS2_TENSOR_BOUND = 1e-3


def synth_voice(seconds: float, rng) -> np.ndarray:
    """A voiced tone at 22.05 kHz with a wandering f0 (90-240 Hz, jitter
    and a slow contour), five harmonics, unvoiced gaps of breath noise and
    background noise (the repository holds no audio)."""
    sr = int(round(1 / AUDIO_SECONDS_PER_SAMPLE))
    n = int(round(seconds * sr))
    t = np.arange(n) / sr
    knots = rng.normal(0.0, 0.1, int(seconds * 4) + 2)
    contour = np.interp(t, np.linspace(0, seconds, len(knots)), knots)
    f0 = rng.uniform(90, 240) * np.exp(contour) \
        * (1 + 0.01 * rng.standard_normal(n))
    ph = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(0.3 / k * np.sin(k * ph + rng.uniform(0, 6.28))
                 for k in range(1, 6))
    gate = np.ones(n)
    for _ in range(int(seconds * 2)):
        a = rng.integers(0, n)
        gate[a: a + int(rng.uniform(0.04, 0.12) * sr)] = 0.0
    gate = np.convolve(gate, np.ones(256) / 256, mode="same")
    noise = rng.standard_normal(n)
    wav = voiced * gate + noise * (0.005 + 0.05 * (1 - gate))
    return (0.8 * wav / np.abs(wav).max()).astype(np.float32)


def fs2_stations(cfg) -> list:
    """Where phase 24(b) reads FastSpeech 2's gradient, from the loss back
    to the embeddings: (label, module path, what: "out" or "in", the
    gradient of its output or of its first input, which is that tensor's
    whole gradient; "value" or "arg", its output or its first input
    itself; "frames" or "phones": the axis of its rows). ``frames`` is the
    length regulator's output, ``phones`` the encoder's."""
    frames = ("pitch_predictor" if cfg.use_pitch else "energy_predictor"
              if cfg.use_energy else None)
    regulator = ([("frames value", frames, "arg", "frames"),
                  (f"{frames} value", frames, "value", "frames"),
                  (f"{frames} out", frames, "out", "frames"),
                  ("frames", frames, "in", "frames")] if frames else [])
    return ([("mel_out", "mel_out", "out", "frames"),
             ("dec_ln", "dec_ln", "out", "frames")]
            + [(f"decoder.{i}", f"decoder.{i}", "out", "frames")
               for i in reversed(range(cfg.dec_layers))]
            + [("decoder.0 in", "decoder.0", "in", "frames")] + regulator
            + [("dur_predictor out", "dur_predictor", "out", "phones"),
               ("phones", "dur_predictor", "in", "phones"),
               ("enc_ln", "enc_ln", "out", "phones")]
            + [(f"encoder.{i}", f"encoder.{i}", "out", "phones")
               for i in reversed(range(cfg.enc_layers))]
            + [("encoder.0 in", "encoder.0", "in", "phones")])


def relu_inputs(model) -> list:
    """The paths of FastSpeech 2's convolutions whose outputs go through a
    ReLU: each FFN's first, both of each variance predictor's."""
    return [name for name, _ in model.named_modules()
            if name.endswith("ffn.conv1") or "_predictor.conv" in name]


def catch_values(model, paths) -> tuple:
    """({path: output}, hook handles): forward hooks that keep each output
    of ``model``'s modules at ``paths``."""
    values = {}
    handles = [model.get_submodule(path).register_forward_hook(
        lambda m, a, out, path=path: values.__setitem__(path, out.detach()))
        for path in paths]
    return values, handles


def catch_grads(torch, model, paths, keep_args: bool = False) -> tuple:
    """({path: {"out": grad, "in": grad, "value": output, "arg": first
    input, "args": inputs}}, hook handles): forward hooks on ``model``'s
    modules at ``paths`` that keep each one's output and first input, the
    gradients of both once the backward reaches them, and with
    ``keep_args`` all its inputs."""
    caught = {path: {} for path in paths}

    def hook(module, args, out, got):
        got["value"], got["arg"] = out.detach(), args[0].detach()
        if keep_args:
            got["args"] = [a.detach() if torch.is_tensor(a) else a
                           for a in args]
        out.register_hook(lambda g: got.__setitem__("out", g.detach()))
        if torch.is_tensor(args[0]) and args[0].requires_grad:
            args[0].register_hook(lambda g: got.__setitem__("in",
                                                            g.detach()))
    handles = [model.get_submodule(path).register_forward_hook(
        lambda m, a, o, got=caught[path]: hook(m, a, o, got))
        for path in paths]
    return caught, handles


def module_alone(torch, module, got, dtype, device,
                 params: bool = True) -> tuple:
    """(input gradient, {parameter name: gradient}) of ``module``'s
    backward alone, a copy of it in ``dtype`` on ``device``, fed ``got``'s
    inputs and output gradient (``catch_grads`` with ``keep_args``); no
    parameter gradients unless ``params``."""
    import copy
    module = copy.deepcopy(module).to(device, dtype)
    args = [a.to(device, dtype if a.is_floating_point() else a.dtype)
            if torch.is_tensor(a) else a for a in got["args"]]
    x = args[0].requires_grad_()
    params = dict(module.named_parameters()) if params else {}
    out = torch.autograd.grad(module(x, *args[1:]),
                              [x] + list(params.values()),
                              got["out"].to(device, dtype))
    return out[0], dict(zip(params, out[1:]))


def regulator_path(torch, model64, mel2ph, caught64, frames: str,
                   dev) -> dict:
    """The backward at the encoder's output, op by op: the length
    regulator's gather (its backward sums each frame's gradient, the
    ``frames`` station's, into its phone) and the duration and pitch
    predictors' input gradients, each alone in float32 on the card and on
    the CPU, fed the float64 pass's tensors (``caught64``), against the
    same backward in float64."""
    f32, f64 = torch.float32, torch.float64
    phones = caught64["dur_predictor"]["args"][0].shape[1]

    def gather(dtype, device):
        gy = caught64[frames]["in"].to(device, dtype)
        b, _, h = gy.shape
        padded = torch.zeros((b, phones + 1, h), dtype=dtype, device=device,
                             requires_grad=True)
        idx = mel2ph.to(device)[..., None].expand(-1, -1, h)
        return torch.autograd.grad(torch.gather(padded, 1, idx), padded,
                                   gy)[0][:, 1:]

    ops = {"gather": gather}
    for path in ("dur_predictor", frames):
        if path != "decoder.0":
            ops[path] = (lambda dtype, device, path=path: module_alone(
                torch, model64.get_submodule(path), caught64[path], dtype,
                device, params=False)[0])
    report = {}
    for name, op in ops.items():
        ref = op(f64, dev)
        report[name] = {side: rel_l2(op(f32, d).to(dev), ref)
                        for side, d in (("card", dev), ("cpu", "cpu"))}
    return report


def fs2_layer_parts(cfg) -> list:
    """Each transformer layer's LayerNorms and the modules they feed."""
    return [f"{stack}.{i}.{part}"
            for stack, n in (("encoder", cfg.enc_layers),
                             ("decoder", cfg.dec_layers))
            for i in range(n) for part in ("ln1", "attn", "ln2", "ffn")]


def grad_error_path(torch, model64, caught, caught64, name: str,
                    dev) -> dict:
    """Where the card's float32 error in the gradient of parameter
    ``name`` comes from, when the module that owns it (``owner``, a
    transformer layer's LayerNorm, say) was hooked in the card's float32
    pass (``caught``) and the float64 pass (``caught64``), both with
    ``keep_args``. ``owner_alone``: the owner's backward alone in float32,
    on the card and on the CPU, fed the float64 pass's inputs and output
    gradient, against the same backward in float64 (the error the op
    itself makes). ``carried``: the owner's float64 backward fed the
    card's own float32 inputs and output gradient (the error that reaches
    it); ``dy_vs_f64``: that output gradient's error. For a layer's
    ``ln1`` / ``ln2``, the same for the module its output feeds (``attn``
    / ``ffn``), whose input gradient is the owner's output gradient."""
    f32, f64 = torch.float32, torch.float64
    sides = (("card", dev), ("cpu", "cpu"))
    owner, key = name.rsplit(".", 1)
    report = {"name": name, "owner": owner, "owner_type": type(
        model64.get_submodule(owner)).__name__, "hooked": owner in caught64}
    if not report["hooked"]:
        return report

    def alone(path, got, dtype, device, params=True):
        return module_alone(torch, model64.get_submodule(path), got, dtype,
                            device, params)

    ref = alone(owner, caught64[owner], f64, dev)[1][key]
    report.update(
        owner_alone={side: rel_l2(alone(owner, caught64[owner], f32, d)[1][
            key].to(dev), ref) for side, d in sides},
        carried=rel_l2(alone(owner, caught[owner], f64, dev)[1][key], ref),
        dy_vs_f64=rel_l2(caught[owner]["out"], caught64[owner]["out"]))
    parent, _, leaf = owner.rpartition(".")
    feeds = {"ln1": "attn", "ln2": "ffn"}.get(leaf)
    consumer = f"{parent}.{feeds}"
    if feeds and consumer in caught64:
        ref = alone(consumer, caught64[consumer], f64, dev, False)[0]
        report.update(
            consumer=consumer,
            consumer_alone={side: rel_l2(alone(
                consumer, caught64[consumer], f32, d, False)[0].to(dev), ref)
                for side, d in sides},
            consumer_dy_vs_f64=rel_l2(caught[consumer]["out"],
                                      caught64[consumer]["out"]))
    return report


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.copy = out, io.StringIO()

    def write(self, text):
        self.copy.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


FS2_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "fastdiff_tpu", "configs", "fs2_ljspeech.yaml")


def run_cli(module: str, config: str, cwd: str, hparams: str,
            *extra) -> float:
    """``python -m module --config config --hparams hparams [extra]`` in
    ``cwd``, the repo on the path; fails on a non-zero exit; its wall s."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", module, "--config", config, "--hparams",
         hparams, *extra], cwd=cwd, env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"{module} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return time.perf_counter() - t0


def make_tts_corpus(root: str, n_items: int, n_valid: int, rng,
                    walls: dict) -> tuple:
    """``n_items`` synthesized utterances of 1-6 s with ``.txt`` sidecars
    under ``root/raw`` -> ``pre_align_cli`` (``TTSPreAlign``, ``en``) ->
    an MFA-style TextGrid each (a ``tg_fn`` column): the corpus the
    ``binarize`` CLI reads. Returns (the paths' hparams, seconds, rows);
    each stage's wall goes to ``walls``."""
    import csv

    from fastdiff_tpu_torch.data.align import mfa_textgrid
    from fastdiff_tpu_torch.data.pre_align import TTSPreAlign
    from fastdiff_tpu_torch.text.processors import get_txt_processor_cls
    from fastdiff_tpu_torch.utils import audio_io

    raw, processed, binary = (os.path.join(root, d) for d in
                              ("raw", "processed", "binary"))
    os.makedirs(raw)
    en = get_txt_processor_cls("en")
    t0 = time.perf_counter()
    seconds = []
    for i in range(n_items):
        text = FS2_SENTENCES[i % len(FS2_SENTENCES)]
        n_ph = len(TTSPreAlign.process_text(en, text, {})[0].split())
        sec = float(np.clip(n_ph / 14 * rng.uniform(0.8, 1.2), 1, 6))
        seconds.append(sec)
        audio_io.save_wav(synth_voice(sec, rng),
                          os.path.join(raw, f"utt{i:02d}.wav"), 22050)
        with open(os.path.join(raw, f"utt{i:02d}.txt"), "w") as f:
            f.write(text)
    walls["synthesize"] = time.perf_counter() - t0
    paths = (f"raw_data_dir={raw},processed_data_dir={processed},"
             f"binary_data_dir={binary},test_num={n_valid}")
    walls["pre_align"] = run_cli(
        "fastdiff_tpu_torch.data.pre_align_cli", FS2_CONFIG, root,
        paths + ",pre_align_cls=fastdiff_tpu.data.pre_align.TTSPreAlign")
    t0 = time.perf_counter()
    meta_fn = os.path.join(processed, "metadata_phone.csv")
    with open(meta_fn, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        wav, sr = audio_io.load_wav(r["wav_fn"])
        r["tg_fn"] = os.path.splitext(r["wav_fn"])[0] + ".TextGrid"
        with open(r["tg_fn"], "w") as f:
            f.write(mfa_textgrid(r["ph"].split(), len(wav) / sr, rng))
    with open(meta_fn, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    walls["textgrids"] = time.perf_counter() - t0
    return paths, seconds, rows


def phase24_fs2_train(torch, all_counters, dev, smi_line, root) -> dict:
    """FastSpeech 2 training at ``fastdiff_tpu/configs/fs2_ljspeech.yaml``'s
    full width (hidden 256, 4 + 4 layers, 2 heads, FFN 1024 k 9,
    ``max_sentences`` 48), from raw audio to a vocoded wav, TF32 off but
    for the vocoder (torch's defaults): (a) 56 synthesized utterances of
    1-6 s with ``.txt`` sidecars -> ``pre_align_cli`` (``TTSPreAlign``, the
    ``en`` processor) -> an MFA-style TextGrid per utterance from its
    phones -> ``python -m fastdiff_tpu_torch.data.binarize`` (``with_align``,
    ``with_f0``), both as subprocesses: items per split, records with a
    TextGrid ``mel2ph``, each stage's wall; (b) one ``train_step`` on the
    card and one on the CPU from the same seed-0 weights and first batch:
    the loss and each term (rel <= 1e-5) and the gradients (global rel L2 <=
    1e-4; each tensor's, card against CPU and each against float64 on the
    card, <= ``FS2_TENSOR_BOUND``); (c) ``run.main`` (``--device cuda``)
    for 30 updates, validating every 15: ms per ``train_step`` by CUDA
    events (median of steps 4-30) with each batch's padded shape, peak
    memory, the last update's learning rate against
    ``optim.learning_rate``, the checkpoints, the validation losses and
    whether the figures were written or the trainer warned; then 20 steps
    on one batch at ``scheduler: none`` (lr 2e-4) must lower the total
    loss; (d) a fresh task restores the newest checkpoint (equal to the
    fit's state) and ``infer_to_wav`` vocodes two sentences through the
    FastDiff vocoder on ``auto`` -> ``ncl``: K3 +12 / K1 +8 / K2 +4 per
    utterance and K8 +4 where the frame count is ``downpath_fusable``,
    every other kernel 0, finite wavs of frames * 256 samples."""
    import contextlib
    import importlib.util

    from fastdiff_tpu_torch import run
    from fastdiff_tpu_torch.data.indexed_dataset import IndexedDataset
    from fastdiff_tpu_torch.data.pre_align import TTSPreAlign
    from fastdiff_tpu_torch.text.encoder import build_token_encoder
    from fastdiff_tpu_torch.text.processors import get_txt_processor_cls
    from fastdiff_tpu_torch.training import checkpoint as ckpt
    from fastdiff_tpu_torch.training.optim import learning_rate
    from fastdiff_tpu_torch.training.trainer import Trainer
    from fastdiff_tpu_torch.training.tts_task import FastSpeech2Task
    from fastdiff_tpu_torch.utils.hparams import set_hparams
    from fastdiff_tpu_torch.vocoders import get_vocoder_cls

    config = FS2_CONFIG
    cwd = os.getcwd()
    per = {"taug_head": 12, "lvc_block_ncl": 8, "lvc_block_ncl_final": 4}
    report = {"device": smi_line}
    walls = report["walls_s"] = {}

    @contextlib.contextmanager
    def tf32(matmul: bool, cudnn: bool):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    try:
        os.chdir(root)
        # (a) raw wavs -> pre-align -> TextGrids -> binarize
        rng = np.random.default_rng(24)
        en = get_txt_processor_cls("en")
        paths, seconds, rows = make_tts_corpus(root, FS2_TRAIN + FS2_VALID,
                                               FS2_VALID, rng, walls)
        binary = os.path.join(root, "binary")
        walls["binarize"] = run_cli("fastdiff_tpu_torch.data.binarize",
                                    FS2_CONFIG, root, paths)
        splits, aligned, frames = {}, 0, []
        for prefix in ("train", "valid", "test"):
            ds = IndexedDataset(os.path.join(binary, prefix))
            items = [ds[i] for i in range(len(ds))]
            splits[prefix] = len(items)
            aligned += sum("mel2ph" in it and int(it["dur"].sum()) == it["len"]
                           for it in items if prefix != "test")
            frames += [it["len"] for it in items]
        report.update(paths=paths, splits=splits, aligned=aligned,
                      seconds=[min(seconds), max(seconds)],
                      frames=[min(frames), max(frames)])
        phase(24, f"(a) {len(rows)} utterances of {min(seconds):.2f}-"
                  f"{max(seconds):.2f} s ({min(frames)}-{max(frames)} "
                  f"frames) -> pre_align_cli (TTSPreAlign, en) -> TextGrids "
                  f"-> binarize: items per split {splits}, {aligned} records "
                  f"with a TextGrid mel2ph; walls " + ", ".join(
                      f"{k} {v:.2f} s" for k, v in walls.items()))
        if splits != {"train": FS2_TRAIN, "valid": FS2_VALID,
                      "test": FS2_VALID} or aligned != FS2_TRAIN + FS2_VALID:
            fail(f"binarized {splits}, {aligned} aligned")

        hp = set_hparams(config=config, hparams_str=paths, print_hparams=False,
                         global_hparams=False)
        with tf32(False, False):
            # (b) one step on the card and one on the CPU
            t0 = time.perf_counter()
            steps = {}
            for name, device in (("card", dev), ("cpu", "cpu")):
                task = FastSpeech2Task(hp, device=device)
                state = task.build_state(seed=0)
                batch = next(task.train_dataloader())
                grads = []
                state.optimizer.step = lambda g, update=state.optimizer.step: (
                    grads.append([x.detach().cpu() for x in g]), update(g))
                at = fs2_stations(task.model_cfg)
                hooked = sorted({module for _, module, _, _ in at}
                                | set(fs2_layer_parts(task.model_cfg)))
                caught, handles = catch_grads(torch, state.model, hooked,
                                              keep_args=name == "card")
                pre_relu, more = catch_values(state.model,
                                              relu_inputs(state.model))
                handles += more
                t1 = time.perf_counter()
                losses = task.train_step(state, batch)
                steps[name] = dict(losses=losses, grads=grads[0],
                                   s=time.perf_counter() - t1,
                                   names=[n for n, _ in
                                          state.model.named_parameters()],
                                   stations=caught, pre_relu=pre_relu)
                for h in handles:
                    h.remove()
            # the same gradients in float64 on the card: how far each
            # device's float32 lies from them
            task = FastSpeech2Task(hp, device=dev)
            model64 = task.build_state(seed=0).model.double()
            batch64 = {k: v.double() if v.is_floating_point() else v
                       for k, v in task._to_device(batch).items()}
            caught64, handles = catch_grads(torch, model64, hooked,
                                            keep_args=True)
            pre_relu64, more = catch_values(model64, relu_inputs(model64))
            handles += more
            grads64 = [g.cpu() for g in torch.autograd.grad(
                task.loss(model64, batch64)["total"],
                list(model64.parameters()))]
            for h in handles:
                h.remove()
            # each station's gradient against float64, card and CPU, over
            # all rows and over the rows that are not padding
            valid = {"frames": torch.as_tensor(batch["mel2ph"]) > 0,
                     "phones": torch.as_tensor(batch["tokens"]) > 0}
            stations = {}
            for label, module, end, axis in at:
                ref = caught64[module][end]
                rows = valid[axis].to(dev)
                stations[label] = {
                    side + suffix: rel_l2(got[rows], ref[rows]) if suffix
                    else rel_l2(got, ref)
                    for side in ("card", "cpu")
                    for got in [steps[side]["stations"][module][end].to(dev)]
                    for suffix in ("", "_valid")}
            t1 = time.perf_counter()
            # ReLU units on the other side of 0 from float64: each turns
            # its unit's gradient on or off
            flips = {side: {path: int(((v.to(dev) > 0) != (
                pre_relu64[path] > 0)).sum()) for path, v in
                steps[side]["pre_relu"].items()} for side in ("card", "cpu")}
            units = sum(v.numel() for v in pre_relu64.values())
            regulator = regulator_path(
                torch, model64, torch.as_tensor(batch["mel2ph"]), caught64,
                {label: module for label, module, _, _ in at}.get(
                    "frames", "decoder.0"), dev)
            del pre_relu64
            cfg = task.model_cfg
            card, cpu = steps["card"], steps["cpu"]
            loss_err = {k: abs(card["losses"][k] - v) / max(abs(v), 1e-30)
                        for k, v in cpu["losses"].items()}

            def flat(grads):
                return torch.cat([g.double().flatten() for g in grads])

            grad_err = rel_l2(flat(card["grads"]), flat(cpu["grads"]))
            errs = {side: {n: rel_l2(a.double(), b.double()) for n, a, b in
                           zip(card["names"], card[ga], other)}
                    for side, ga, other in (
                        ("card_cpu", "grads", cpu["grads"]),
                        ("card_f64", "grads", grads64))}
            errs["cpu_f64"] = {n: rel_l2(a.double(), b) for n, a, b in zip(
                card["names"], cpu["grads"], grads64)}
            worst = {side: max(e, key=e.get) for side, e in errs.items()}
            path = grad_error_path(torch, model64, steps["card"]["stations"],
                                   caught64, worst["card_f64"], dev)
            del model64, batch64, caught64
            for side in ("card", "cpu"):
                del steps[side]["stations"], steps[side]["pre_relu"]
            walls["error_path"] = time.perf_counter() - t1
            n_params = sum(g.numel() for g in card["grads"])
            vs_f64 = {"card": rel_l2(flat(card["grads"]), flat(grads64)),
                      "cpu": rel_l2(flat(cpu["grads"]), flat(grads64))}
            report["card_vs_cpu"] = dict(
                loss_rel=loss_err, grad_rel_l2=grad_err,
                grad_rel_l2_vs_f64=vs_f64,
                worst={side: [n, errs[side][n]] for side, n in worst.items()},
                worst_path=path, stations_vs_f64=stations,
                regulator_vs_f64=regulator, relu_flips=flips,
                relu_units=units,
                batch=[list(batch["tokens"].shape),
                       list(batch["mels"].shape)],
                card_s=card["s"], cpu_s=cpu["s"])
            walls["card_vs_cpu"] = time.perf_counter() - t0
            phase(24, f"(b) fs2_ljspeech.yaml: hidden {cfg.hidden}, "
                      f"{cfg.enc_layers} + {cfg.dec_layers} layers, "
                      f"{cfg.num_heads} heads, FFN {cfg.ffn_hidden} k "
                      f"{cfg.ffn_kernel}, vocab {cfg.vocab_size}, "
                      f"{n_params / 1e6:.2f} M params (seed 0), TF32 off; "
                      f"first batch tokens {tuple(batch['tokens'].shape)} "
                      f"mels {tuple(batch['mels'].shape)}: card vs CPU "
                      "train_step, loss terms rel " + ", ".join(
                          f"{k} {v:.2e}" for k, v in loss_err.items())
                      + f" (bound 1e-5); gradients global rel L2 "
                      f"{grad_err:.2e} (bound 1e-4), against float64 on the "
                      f"card: card {vs_f64['card']:.2e}, CPU "
                      f"{vs_f64['cpu']:.2e}"
                      "; worst tensor " + ", ".join(
                          f"{side} {n} {errs[side][n]:.2e}"
                          for side, n in worst.items())
                      + f" (bound {FS2_TENSOR_BOUND:g}); step wall card "
                      f"{card['s']:.2f} s (first, with cuDNN's plans), CPU "
                      f"{cpu['s']:.2f} s")
            phase(24, "(b) along the backward, against float64, card / "
                      "CPU, all rows (rows that are not padding), each a "
                      "gradient but the values: " + ", ".join(
                          f"{k} {v['card']:.1e} ({v['card_valid']:.1e}) / "
                          f"{v['cpu']:.1e} ({v['cpu_valid']:.1e})"
                          for k, v in stations.items())
                      + "; at the encoder's output, each backward alone in "
                      "float32 fed float64's tensors, card / CPU: "
                      + ", ".join(f"{k} {v['card']:.1e} / {v['cpu']:.1e}"
                                  for k, v in regulator.items())
                      + f"; ReLU inputs on the other side of 0 from "
                      f"float64, of {units}: " + "; ".join(
                          f"{side} {sum(f.values())} (" + ", ".join(
                              f"{k} {v}" for k, v in f.items() if v) + ")"
                          for side, f in flips.items()))
            phase(24, f"(b) where the card's error in {path['name']} "
                      f"({path['owner_type']}; the CPU's "
                      f"{errs['cpu_f64'][path['name']]:.2e}) comes from, "
                      "each against float64: " + (
                          f"{path['owner']}'s backward alone, fed float64's "
                          f"inputs: card {path['owner_alone']['card']:.2e}, "
                          f"CPU {path['owner_alone']['cpu']:.2e}; float64's "
                          "backward fed the card's float32 inputs "
                          f"{path['carried']:.2e} (its output gradient off "
                          f"by {path['dy_vs_f64']:.2e})"
                          if path["hooked"] else
                          f"{path['owner']} was not hooked")
                      + (f"; that gradient is {path['consumer']}'s input "
                         f"gradient: its backward alone, card "
                         f"{path['consumer_alone']['card']:.2e}, CPU "
                         f"{path['consumer_alone']['cpu']:.2e} (its own "
                         f"output gradient off by "
                         f"{path['consumer_dy_vs_f64']:.2e})"
                         if "consumer" in path else ""))
            if max(loss_err.values()) > 1e-5 or grad_err > 1e-4 or \
                    max(errs[side][n] for side, n in worst.items()) > \
                    FS2_TENSOR_BOUND:
                fail("FastSpeech 2's train step on the card disagrees with "
                     "the CPU")

            # (c) run.py fit, each train_step timed by CUDA events
            t0 = time.perf_counter()
            timed, original = [], FastSpeech2Task.train_step

            def train_step(self, state, batch, generator=None):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = original(self, state, batch, generator)
                end.record()
                end.synchronize()
                timed.append((start.elapsed_time(end),
                              tuple(batch["tokens"].shape[1:]) +
                              tuple(batch["mels"].shape[1:2])))
                return out

            FastSpeech2Task.train_step = train_step
            torch.cuda.reset_peak_memory_stats()
            tee = _Tee(sys.stdout)
            try:
                with contextlib.redirect_stdout(tee):
                    fit = run.main([
                        "--config", config, "--exp_name", "fs2", "--reset",
                        "--device", "cuda", "--hparams", paths +
                        f",max_updates={FS2_STEPS},val_check_interval="
                        f"{FS2_VAL_EVERY},num_sanity_val_steps=1,"
                        "tb_log_interval=5"])
            finally:
                FastSpeech2Task.train_step = original
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            walls["fit"] = time.perf_counter() - t0
            work = os.path.join(root, "checkpoints", "fs2")
            state = fit["state"]
            opt = state.optimizer
            last_lr = learning_rate(opt.cfg, opt.count - 1,
                                    opt.warmup_updates, opt.hidden_size)
            s = max(opt.count - 1, 1)
            formula = max(2e-4 * min(s / 8000, 1) * max(8000, s) ** -0.5
                          * 256 ** -0.5, 1e-7)
            ms = [t for t, _ in timed[3:]]
            shapes = sorted({shape for _, shape in timed})
            ckpts = sorted(f for f in os.listdir(work) if f.endswith(".ckpt"))
            with open(os.path.join(work, "tb_logs", "metrics.jsonl")) as f:
                logged = [json.loads(line) for line in f]
            val = {r["step"]: r["val/loss"] for r in logged
                   if "val/loss" in r}
            fig_dir = os.path.join(work, "tb_logs", "figures")
            pngs = sorted(os.listdir(fig_dir)) if os.path.isdir(fig_dir) \
                else []
            warned = "WARNING: val_figures failed" in tee.copy.getvalue()
            has_mpl = importlib.util.find_spec("matplotlib") is not None
            report["fit"] = dict(
                steps=fit["step"], ms_median=float(np.median(ms)),
                ms_min=float(np.min(ms)), ms_max=float(np.max(ms)),
                shapes=shapes, peak_gib=peak, last_lr=last_lr,
                checkpoints=ckpts, val_loss=val, pngs=pngs, warned=warned,
                final_val=fit["val"]["loss"])
            phase(24, f"(c) run.main fit --device cuda: {fit['step']} "
                      f"updates, train_step {np.median(ms):.2f} ms median of "
                      f"steps 4-{len(timed)} (min {np.min(ms):.2f}, max "
                      f"{np.max(ms):.2f}) by CUDA events, padded (tokens, "
                      f"frames) {shapes} x {hp['max_sentences']}; peak "
                      f"memory {peak:.2f} GiB; last update's lr {last_lr:.3e}"
                      f" (optim.learning_rate; the formula gives "
                      f"{formula:.3e}, warm-up {opt.warmup_updates}, hidden "
                      f"{opt.hidden_size}); checkpoints {ckpts}; val loss "
                      f"{val}; figures: " + (f"{len(pngs)} PNGs {pngs}"
                                             if pngs else
                                             "none, the trainer warned "
                                             "'val_figures failed'"
                                             f" (matplotlib importable: "
                                             f"{has_mpl})")
                      + f"; wall {walls['fit']:.1f} s [{smi_line}]")
            if fit["step"] != FS2_STEPS or len(timed) != FS2_STEPS or \
                    abs(last_lr - formula) > 1e-6 * formula or \
                    not all(np.isfinite(v) for v in val.values()) or \
                    sorted(val) != [FS2_VAL_EVERY, FS2_STEPS] or \
                    ckpts[-1] != f"model_ckpt_steps_{FS2_STEPS}.ckpt" or \
                    (not pngs) != warned or (not pngs and has_mpl):
                fail("the FastSpeech 2 fit did not run as configured")

            t0 = time.perf_counter()
            task = FastSpeech2Task(dict(hp, scheduler="none"), device=dev)
            fixed = task.build_state(seed=0)
            batch = next(task.train_dataloader())
            curve = [task.train_step(fixed, batch)["total"]
                     for _ in range(FS2_FIXED_STEPS)]
            walls["fixed_batch"] = time.perf_counter() - t0
            report["fixed_batch_total"] = curve
            phase(24, f"{FS2_FIXED_STEPS} steps on one batch at lr "
                      f"{task.train_cfg.lr:g} (scheduler none): total loss "
                      f"{curve[0]:.4f} -> {curve[-1]:.4f} (each step's "
                      f"{[round(c, 4) for c in curve]})")
            if not curve[-1] < curve[0]:
                fail("the total loss did not fall on a fixed batch")

        # (d) restore the newest checkpoint and vocode two sentences
        t0 = time.perf_counter()
        task = FastSpeech2Task(hp, device=dev)
        restored, step = Trainer(task, work).restore(task.build_state(seed=7))
        saved = ckpt.load_checkpoint(os.path.join(work, ckpts[-1]))
        trained = state.model.state_dict()
        equal = all(torch.equal(v, saved["params"][k]) and
                    torch.equal(v, trained[k])
                    for k, v in restored.model.state_dict().items())
        vocoder = get_vocoder_cls(hp)(hp, device=dev)

        class DefaultFlags:
            """The vocoder at torch's default TF32 flags."""

            def spec2wav(self, mel):
                with tf32(False, True):
                    return vocoder.spec2wav(mel)

        encoder = build_token_encoder(os.path.join(binary, "phone_set.json"))
        utts = []
        with tf32(False, False):
            for i, text in enumerate(FS2_SENTENCES[:2]):
                ph = TTSPreAlign.process_text(en, text, {})[0]
                tokens = np.asarray(encoder.encode(ph))
                for counter in all_counters:
                    for key in counter:
                        counter[key] = 0
                wav = task.infer_to_wav(restored, tokens, os.path.join(
                    root, f"fs2_{i}.wav"), vocoder=DefaultFlags())
                torch.cuda.synchronize()
                # every kernel's count, so that a stray launch of a kernel
                # off this route (NWC, down path, fused head, ...) shows
                launches = {k: v for counter in all_counters
                            for k, v in counter.items()}
                n_frames = len(wav) // HOP_SIZE
                # K8 (NCL) where the vocoded length is a fusable one
                expected = {k: {**per, "downpath_ncl": k8_per_call(
                    n_frames, 4)}.get(k, 0) for k in launches}
                utts.append(dict(tokens=len(tokens), frames=n_frames,
                                 launches=launches, launched={
                                     k: v for k, v in launches.items() if v}))
                if launches != expected or \
                        len(wav) != n_frames * HOP_SIZE or \
                        not np.isfinite(wav).all() or n_frames < len(tokens):
                    fail(f"infer_to_wav of sentence {i}: {len(wav)} samples, "
                         f"launches {launches}, expected {expected}")
        walls["restore_vocode"] = time.perf_counter() - t0
        report.update(restored_step=step, restored_equal=equal, utts=utts,
                      launches_per_utterance=utts[-1]["launches"])
        phase(24, f"(d) restored {ckpts[-1]} (step {step}) into a fresh "
                  f"task: state equal to the saved and the trained "
                  f"{equal}; infer_to_wav (auto -> ncl, vocoder at cuDNN "
                  "TF32 on): " + "; ".join(
                      f"{u['tokens']} tokens -> {u['frames']} frames, "
                      f"launches {u['launched']} (every other kernel 0)"
                      for u in utts)
                  + f"; wall {walls['restore_vocode']:.1f} s")
        if step != FS2_STEPS or not equal:
            fail("the restored FastSpeech 2 state differs from the saved one")
        return report
    finally:
        os.chdir(cwd)


BDDM_N = (8, 6, 4, 3)            # the published schedules' step counts
PHI_STEPS = 20


def event_ms(torch, fn) -> tuple:
    """(fn's result, its ms by CUDA events around it, synchronized)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase23_bddm(torch, counters, all_counters, dev, smi_line) -> dict:
    """BDDM and the evaluation tools at the full width of ``fastdiff_tpu/
    configs/ljspeech.yaml`` (seed-0 weights fused by
    ``inference_state_dict``; ``auto`` -> ``ncl`` and ``false`` -> ``plain``
    through ``FastDiffTask.inference_model``) on the synthetic binarized
    dataset: (a) 20 Adam steps of the phi predictor at the recipe batch (20
    x 25,600 samples): ms per step by CUDA events, loss and every phi
    gradient finite, K3 +3 / K1 +2 / K2 +1 per step (K8 0: 25,600 samples
    is no multiple of 2048); on one batch with
    injected t and z the kernel route against the plain route (loss rel
    1e-2, gradients rel L2 5e-2) and the plain route on the card (TF32 off)
    against the CPU (loss 1e-4); (b) the reverse search for N = 8, 6, 4, 3
    at 864 frames, b 1, from one injected x on both routes: schedules,
    steps, wall, launches per step (K8 1), the first reverse step's x (rel
    L2 5e-2)
    and first predicted beta (rel 5e-2) kernel against plain; (c) every
    non-empty searched and every published schedule through
    ``make_param_sampler`` at 864 frames: ms per sample by graph replay (one
    capture each), launches 3N / 2N / N / N (K8), MCD, MR-STFT and PESQ
    against the
    synthetic wav (seed weights, not quality); (d) ``demo_vocoder`` then
    ``evaluate`` as subprocesses on a 2 s wav, beside them ``bddm_search
    --phi_steps 5`` on the synthetic dataset (its JSON under the work dir,
    ``docs/BDDM.md`` unchanged; its wall is read when the other two are
    done)."""
    import hashlib

    from fastdiff_tpu_torch.config import AudioConfig
    from fastdiff_tpu_torch.diffusion import schedules
    from fastdiff_tpu_torch.diffusion.noise_predictor import (
        NoisePredictor, phi_loss, phi_train_step, search_noise_schedule)
    from fastdiff_tpu_torch.diffusion.sampler import (inference_generator,
                                                      make_param_sampler)
    from fastdiff_tpu_torch.ops import dsp
    from fastdiff_tpu_torch.scripts.bddm_search import PUBLISHED
    from fastdiff_tpu_torch.training.task import FastDiffTask
    from fastdiff_tpu_torch.utils import audio_io, metrics
    from fastdiff_tpu_torch.utils.hparams import set_hparams
    from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import \
        inference_state_dict

    repo = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(repo, "fastdiff_tpu", "configs", "ljspeech.yaml")
    bddm_doc = os.path.join(repo, "docs", "BDDM.md")
    root = tempfile.mkdtemp(prefix="fastdiff_bddm_")
    # a denoiser forward at the phi batch's length, and at 864 frames (the
    # search and the samplers), where K8 (NCL) runs too
    per = {"taug_head": 3, "lvc_block_ncl": 2, "lvc_block_ncl_final": 1,
           "downpath_ncl": k8_per_call(TRAIN_FRAMES), "downpath": 0}
    per_864 = {**per, "downpath_ncl": k8_per_call(FRAMES_10S)}

    def zero():
        for counter in all_counters:
            for key in counter:
                counter[key] = 0

    def read():
        return {k: v for counter in counters for k, v in counter.items()
                if k in per}

    def times(n):
        return {k: v * n for k, v in per_864.items()}

    def launched():
        return {k: v for counter in all_counters for k, v in counter.items()
                if v}

    try:
        binary = os.path.join(root, "binary")
        os.makedirs(binary)
        write_synthetic_dataset(binary)
        hp = set_hparams(config=config, hparams_str=f"binary_data_dir="
                         f"{binary}", print_hparams=False,
                         global_hparams=False)
        task = FastDiffTask(hp, device=dev)
        plain_hp = dict(hp, use_pallas_block=False)
        fused = inference_state_dict(
            task.build_state(seed=0).model.state_dict(), task.model_cfg)
        score = task.inference_model(fused)
        plain = FastDiffTask(plain_hp, device=dev).inference_model(fused)
        cfg = task.model_cfg
        if (score.infer_route, plain.infer_route) != ("ncl", "plain"):
            fail(f"routes {score.infer_route} / {plain.infer_route}, "
                 "expected ncl / plain")
        n_params = sum(p.numel() for p in score.parameters())
        phase(23, f"ljspeech.yaml: C {cfg.inner_channels}, ratios "
                  f"{cfg.upsample_ratios}, {n_params / 1e6:.2f} M params "
                  f"(seed 0, weight norm fused), {cfg.compute_dtype}; "
                  "use_pallas_block auto -> ncl, false -> plain; TF32 "
                  f"matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
                  f"{torch.backends.cudnn.allow_tf32}")

        # (a) phi training at the recipe batch
        phi = NoisePredictor(seed=0, device=dev)
        opt = torch.optim.Adam(phi.parameters(), lr=1e-4)
        gen = torch.Generator(device=dev).manual_seed(1)
        batches = []
        for i, batch in enumerate(task.train_dataloader()):
            if i == PHI_STEPS:
                break
            batches.append(tuple(torch.as_tensor(
                np.asarray(batch[k]), dtype=torch.float32, device=dev)
                for k in ("mels", "wavs")))
        shapes = {tuple(t.shape) for b in batches for t in b}
        if shapes != {(TRAIN_BATCH, TRAIN_FRAMES, 80),
                      (TRAIN_BATCH, TRAIN_FRAMES * HOP_SIZE, 1)}:
            fail(f"phi batches {shapes}")
        step_ms, losses = [], []
        for mels, wavs in batches:
            zero()
            loss, ms = event_ms(torch, lambda: phi_train_step(
                phi, opt, score, mels, wavs, task.alpha, generator=gen))
            if read() != per:
                fail(f"phi step launched {read()}, expected {per}")
            if not (bool(torch.isfinite(loss)) and all(
                    bool(torch.isfinite(p.grad).all())
                    for p in phi.parameters())):
                fail("phi step: loss or a phi gradient is not finite")
            step_ms.append(ms)
            losses.append(float(loss))
        steady = float(np.median(step_ms[1:]))
        phase(23, f"(a) phi training, {PHI_STEPS} Adam(1e-4) steps at "
                  f"{TRAIN_BATCH} x {TRAIN_FRAMES * HOP_SIZE} samples "
                  f"(auto -> ncl, denoiser under no_grad): first step "
                  f"{step_ms[0]:.3f} ms, then median {steady:.3f} ms "
                  f"(min {min(step_ms[1:]):.3f}, max {max(step_ms[1:]):.3f})"
                  f"; loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches per "
                  f"step {per} [{smi_line}]")

        mels, wavs = batches[0]
        draw = torch.Generator().manual_seed(3)
        ts = torch.randint(200, 800, (TRAIN_BATCH,), generator=draw)
        z = torch.randn(tuple(wavs.shape), generator=draw)

        def loss_grads(model, denoiser, mels, wavs, alpha):
            loss = phi_loss(model, denoiser, mels, wavs, alpha, ts=ts, z=z)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            return loss.item(), [g.detach().float().cpu() for g in grads]

        k_loss, k_grads = loss_grads(phi, score, mels, wavs, task.alpha)
        zero()
        p_loss, p_grads = loss_grads(phi, plain, mels, wavs, task.alpha)
        if launched():
            fail(f"the plain route launched {launched()}")
        cpu_task = FastDiffTask(plain_hp, device="cpu")
        cpu_phi = NoisePredictor(seed=None)
        cpu_phi.load_state_dict({k: v.cpu()
                                 for k, v in phi.state_dict().items()})
        c_loss, c_grads = loss_grads(cpu_phi, cpu_task.inference_model(
            {k: v.cpu() for k, v in fused.items()}), mels.cpu(),
            wavs.cpu(), cpu_task.alpha)
        kp_grad = max(rel_l2(a, b) for a, b in zip(k_grads, p_grads))
        pc_grad = max(rel_l2(a, b) for a, b in zip(p_grads, c_grads))
        kp_loss = abs(k_loss - p_loss) / abs(p_loss)
        pc_loss = abs(p_loss - c_loss) / abs(c_loss)
        phase(23, f"(a) one batch, injected t and z: loss kernel "
                  f"{k_loss:.6f}, plain {p_loss:.6f}, CPU plain "
                  f"{c_loss:.6f}; kernel vs plain loss rel {kp_loss:.3e} "
                  f"(bound 1e-2), worst phi gradient rel L2 {kp_grad:.3e} "
                  f"(bound 5e-2); plain card vs CPU loss rel {pc_loss:.3e} "
                  f"(bound 1e-4), worst gradient rel L2 {pc_grad:.3e}")
        if not (kp_loss <= 1e-2 and kp_grad <= 5e-2 and pc_loss <= 1e-4):
            fail("phi loss / gradients disagree between routes or devices")

        # (b) the reverse search at 864 frames, b 1, from one x
        acfg = AudioConfig()
        gt, mel_np = dsp.wav2mel_np(synth_wav(
            (FRAMES_10S - 1) * HOP_SIZE * AUDIO_SECONDS_PER_SAMPLE, 5), acfg)
        if mel_np.shape[1] != FRAMES_10S:
            fail(f"the 10 s wav gave {mel_np.shape[1]} frames")
        mel = torch.from_numpy(np.ascontiguousarray(mel_np.T))[None].to(dev)
        length = FRAMES_10S * HOP_SIZE
        x0 = torch.randn((1, length, 1), generator=torch.Generator()
                         .manual_seed(4)).to(dev)
        hyper = schedules.compute_hyperparams_given_schedule(
            schedules.linear_beta_schedule(task.diff_cfg))
        search = {}
        for n in BDDM_N:
            rows = {}
            for name, model in (("kernel", score), ("plain", plain)):
                seen = []

                def denoiser(x, m, t, model=model, seen=seen):
                    seen.append(x)
                    return model(x, m, t)

                zero()
                t0 = time.perf_counter()
                sched = search_noise_schedule(
                    phi, denoiser, mel, hyper, length, max_steps=n,
                    beta_start=PUBLISHED[n][-1], alpha_start=0.3, rho=1e-9,
                    x=x0)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                want = times(len(seen)) if name == "kernel" else {}
                got = read() if name == "kernel" else launched()
                if got != want:
                    fail(f"search N={n} on {name}: launches {got}, "
                         f"expected {want} for {len(seen)} steps")
                if len(sched) < 2 or len(seen) < 2:
                    fail(f"search N={n} on {name} stopped after "
                         f"{len(seen)} steps: {sched}")
                rows[name] = dict(schedule=[float(b) for b in sched],
                                  length=len(sched), steps=len(seen),
                                  wall_ms=wall, x1=seen[1])
            k, p = rows["kernel"], rows["plain"]
            x1_err = rel_l2(k.pop("x1"), p.pop("x1"))
            beta_err = abs(k["schedule"][-2] - p["schedule"][-2]) / \
                abs(p["schedule"][-2])
            search[n] = dict(kernel=k, plain=p, x1_rel_l2=x1_err,
                             beta1_rel=beta_err)
            phase(23, f"(b) search N={n} from beta {PUBLISHED[n][-1]:.4g}: "
                      f"kernel {k['length']} betas "
                      f"{[f'{b:.3e}' for b in k['schedule']]} in "
                      f"{k['steps']} steps, {k['wall_ms']:.1f} ms "
                      f"({k['wall_ms'] / k['steps']:.2f} ms a step); plain "
                      f"{p['length']} betas "
                      f"{[f'{b:.3e}' for b in p['schedule']]} in "
                      f"{p['steps']} steps, {p['wall_ms']:.1f} ms; lengths "
                      f"{'equal' if k['length'] == p['length'] else 'DIFFER'}"
                      f"; first step's x rel L2 {x1_err:.3e}, first predicted"
                      f" beta rel {beta_err:.3e} (bounds 5e-2); launches "
                      f"per step {per_864} [{smi_line}]")
            if not (x1_err <= 5e-2 and beta_err <= 5e-2):
                fail(f"search N={n}: kernel and plain routes disagree")

        # (c) each schedule through the graph sampler
        evals = []
        for n in BDDM_N:
            for kind, sched in (("searched", search[n]["kernel"]["schedule"]),
                                ("published", PUBLISHED[n])):
                steps = len(sched)
                const = schedules.sampler_constants_for_schedule(
                    np.asarray(sched, np.float64), hyper)
                sampler = make_param_sampler(score, const)
                g = inference_generator(7, dev)
                for _ in range(2):              # eager, then the capture
                    sampler(None, g, mel, length)
                zero()
                wav = sampler(None, g, mel, length)
                if read() != times(steps):
                    fail(f"{kind} N={n}: a replay launched {read()}, "
                         f"expected {times(steps)}")
                ms = cuda_ms(lambda: sampler(None, g, mel, length), 3)
                wav = wav[0, :, 0].cpu().numpy()
                if len(wav) != length or not np.isfinite(wav).all() or \
                        sampler.captures != 1:
                    fail(f"{kind} N={n}: {len(wav)} samples, finite "
                         f"{np.isfinite(wav).all()}, captures "
                         f"{sampler.captures}")
                evals.append(dict(
                    n=n, kind=kind, steps=steps, ms=ms,
                    mcd=metrics.mcd(wav, gt, acfg),
                    mrstft=metrics.multi_resolution_stft_distance(wav, gt),
                    pesq=metrics.pesq_mos(gt, wav, acfg.sample_rate)))
                del sampler
        phase(23, "(c) graph sampler per schedule, 864 frames, b 1 (one "
                  "capture each; launches per replay K3 3N, K1 2N, K2 N, "
                  "K8 N): "
                  + "; ".join(
                      f"N={r['n']} {r['kind']} ({r['steps']} steps) "
                      f"{r['ms']:.3f} ms, MCD {r['mcd']:.2f} dB, MR-STFT "
                      f"{r['mrstft']:.3f}, PESQ {r['pesq']:.2f}"
                      for r in evals)
                  + f" (seed weights, not quality) [{smi_line}]")

        # (d) the CLIs as subprocesses: bddm_search beside demo_vocoder
        # and then evaluate (most of each is its process's start)
        env = dict(os.environ, PYTHONPATH=repo)
        doc_hash = hashlib.sha256(open(bddm_doc, "rb").read()).hexdigest()
        demo_in = os.path.join(root, "demo_in.wav")
        audio_io.save_wav(synth_wav(2.0, 6), demo_in, acfg.sample_rate)
        demo_out = os.path.join(root, "demo_out")

        def cli(name, *args):
            return [sys.executable, "-m",
                    f"fastdiff_tpu_torch.scripts.{name}", *args]

        def report_cli(name, rc, wall, stdout, stderr):
            clis[name] = dict(rc=rc, wall_s=wall)
            if rc != 0:
                fail(f"{name} exited {rc}: {stderr[-2000:]}")
            tail = [line for line in stdout.splitlines() if line]
            phase(23, f"(d) python -m fastdiff_tpu_torch.scripts.{name}: "
                      f"exit 0 in {wall:.1f} s; " + " | ".join(tail[-3:]))

        clis = {}
        t_search = time.perf_counter()
        with open(os.path.join(root, "bddm.out"), "w+") as out, \
                open(os.path.join(root, "bddm.err"), "w+") as err:
            search_proc = subprocess.Popen(
                cli("bddm_search", "--config", config, "--exp_name", "bddm",
                    "--hparams", f"binary_data_dir={binary}",
                    "--phi_steps", "5"),
                cwd=root, env=env, stdout=out, stderr=err, text=True)
            try:
                for name, args in (("demo_vocoder", ["--wav", demo_in, "--N",
                                                     "4", "--out", demo_out]),
                                   ("evaluate", [demo_out])):
                    t0 = time.perf_counter()
                    proc = subprocess.run(cli(name, *args), cwd=root,
                                          env=env, capture_output=True,
                                          text=True, timeout=600)
                    report_cli(name, proc.returncode,
                               time.perf_counter() - t0, proc.stdout,
                               proc.stderr)
                rc = search_proc.wait(timeout=600)
            finally:
                if search_proc.poll() is None:
                    search_proc.kill()
                    search_proc.wait()
            out.seek(0)
            err.seek(0)
            report_cli("bddm_search", rc, time.perf_counter() - t_search,
                       out.read(), err.read())
        pred, _ = audio_io.load_wav(os.path.join(demo_out,
                                                 "demo_in_pred.wav"))
        gt2, _ = audio_io.load_wav(os.path.join(demo_out, "demo_in_gt.wav"))
        if len(pred) != len(gt2) or len(pred) % HOP_SIZE or \
                not np.isfinite(pred).all():
            fail(f"demo_vocoder wrote {len(pred)} / {len(gt2)} samples")
        work = os.path.join(root, "checkpoints", "bddm")
        with open(os.path.join(work, "bddm_schedules.json")) as f:
            written = json.load(f)
        if sorted(written, key=int) != [str(n) for n in sorted(BDDM_N)] or \
                not os.path.exists(os.path.join(work, "bddm_report.md")):
            fail(f"bddm_search wrote {sorted(written)} under {work}")
        if hashlib.sha256(open(bddm_doc, "rb").read()).hexdigest() != \
                doc_hash:
            fail("bddm_search changed docs/BDDM.md")
        phase(23, f"(d) demo_vocoder wrote {len(pred)} samples; "
                  f"bddm_search wrote bddm_schedules.json (N "
                  f"{sorted(written, key=int)}) and bddm_report.md under "
                  "its work dir; docs/BDDM.md unchanged")
        return {"phi_step_ms": steady, "phi_first_step_ms": step_ms[0],
                "phi_step_ms_all": step_ms, "phi_losses": losses,
                "launches_per_phi_step": per,
                "route_check": dict(kernel_loss=k_loss, plain_loss=p_loss,
                                    cpu_loss=c_loss, kernel_vs_plain=kp_loss,
                                    kernel_vs_plain_grad=kp_grad,
                                    card_vs_cpu=pc_loss,
                                    card_vs_cpu_grad=pc_grad),
                "search": search, "eval": evals, "clis": clis,
                "device": smi_line}
    finally:
        shutil.rmtree(root, ignore_errors=True)


ZOO_FRAMES = 864                 # 10 s at hop 256: the sampler's and AR cells
SPK_STEPS = 100


def zero_counters(all_counters) -> None:
    for counter in all_counters:
        for key in counter:
            counter[key] = 0


def launched(all_counters) -> dict:
    return {k: v for counter in all_counters for k, v in counter.items()
            if v}


def phase25_spk(torch, all_counters, dev, smi_line, root: str,
                paths: str) -> dict:
    """The speaker encoder (``models/spk_encoder.py``, seed weights): (a)
    16 ``synth_voice`` mels of 1-3 s embedded on the card and on the CPU
    (TF32 off, max abs <= 1e-5), ms per ``embed``; (b) ``train_spk_encoder``
    for 100 steps at n_spk 8 x n_utt 4 x crop 80 on those mels (the loss
    must fall: mean of the last 10 below the first 10), ms per step, the
    verification EER on held-out transforms, trained against the seed
    weights; (c) phase 24's corpus through the ``binarize`` CLI with
    ``binarization_args.with_spk_embed`` (on the card): every record's
    ``spk_embed`` a 256-d unit vector."""
    from fastdiff_tpu_torch.config import AudioConfig
    from fastdiff_tpu_torch.data.indexed_dataset import IndexedDataset
    from fastdiff_tpu_torch.models.spk_encoder import EMBED_DIM, SpeakerEncoder
    from fastdiff_tpu_torch.ops.dsp import wav2mel_np
    from fastdiff_tpu_torch.training import spk_task

    zero_counters(all_counters)
    report = {"device": smi_line}
    rng = np.random.default_rng(25)
    audio = AudioConfig()
    mels = [wav2mel_np(synth_voice(float(rng.uniform(1, 3)), rng), audio)[1].T
            for _ in range(16)]
    card, cpu = SpeakerEncoder(device=dev), SpeakerEncoder(device="cpu")
    card.eval()
    cpu.eval()
    emb_card = np.stack([card.embed(m) for m in mels])
    emb_cpu = np.stack([cpu.embed(m) for m in mels])
    err = float(np.abs(emb_card - emb_cpu).max())
    _, ms = event_ms(torch, lambda: [card.embed(m) for m in mels])
    embed_ms = ms / len(mels)
    frames = [m.shape[0] for m in mels]
    report["embed"] = dict(max_abs_err=err, ms_per_embed=embed_ms,
                           frames=[min(frames), max(frames)])
    phase(25, f"(a) SpeakerEncoder (seed weights) on {len(mels)} synth_voice "
              f"mels of {min(frames)}-{max(frames)} frames: card vs CPU max "
              f"abs {err:.2e} (bound 1e-5, TF32 off); embed "
              f"{embed_ms:.3f} ms per mel (CUDA events, host included) "
              f"[{smi_line}]")
    if not err <= 1e-5 or emb_card.shape != (len(mels), EMBED_DIM):
        fail("speaker embeddings: card and CPU disagree")

    t0 = time.perf_counter()
    model, history = spk_task.train_spk_encoder(
        mels, steps=SPK_STEPS, n_spk=8, n_utt=4, crop=80, seed=0, device=dev)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / SPK_STEPS
    eers = {name: {holdout: spk_task.verification_eer(m, mels,
                                                     holdout=holdout)
                   for holdout in (False, True)}
            for name, m in (("trained", model.eval()),
                            ("seed", SpeakerEncoder(device=dev).eval()))}
    first, last = float(np.mean(history[:10])), float(np.mean(history[-10:]))
    report["train"] = dict(steps=SPK_STEPS, ms_per_step=step_ms,
                           loss_first10=first, loss_last10=last,
                           eer=eers)
    phase(25, f"(b) train_spk_encoder {SPK_STEPS} steps (8 speakers x 4 "
              f"utterances x 80 frames, Adam 1e-3): {step_ms:.2f} ms per "
              f"step (host wall, a loss read back each step); loss mean of "
              f"the first 10 {first:.4f} -> last 10 {last:.4f}; "
              f"verification EER trained {eers['trained'][False]:.4f} / "
              f"held-out transforms {eers['trained'][True]:.4f}, seed "
              f"weights {eers['seed'][False]:.4f} / {eers['seed'][True]:.4f}"
              f" [{smi_line}]")
    if not last < first:
        fail("speaker-encoder training did not lower the loss")

    binary = os.path.join(root, "binary_spk")
    spk_paths = re.sub(r"binary_data_dir=[^,]*", f"binary_data_dir={binary}",
                       paths) + ",binarization_args.with_spk_embed=True"
    wall = run_cli("fastdiff_tpu_torch.data.binarize", FS2_CONFIG, root,
                   spk_paths, "--device", dev.type)
    norms = []
    for prefix in ("train", "valid", "test"):
        ds = IndexedDataset(os.path.join(binary, prefix))
        for i in range(len(ds)):
            e = ds[i].get("spk_embed")
            if e is None or e.shape != (EMBED_DIM,) or e.dtype != np.float32:
                fail(f"binarized record {prefix}/{i} has no 256-d spk_embed")
            norms.append(float(np.linalg.norm(e)))
    norm_err = float(np.max(np.abs(np.asarray(norms) - 1.0)))
    report["binarize"] = dict(records=len(norms), wall_s=wall,
                              norm_err=norm_err)
    phase(25, f"(c) binarize --device {dev.type} with_spk_embed on the TTS "
              f"corpus: {len(norms)} records, each spk_embed (256,) float32, "
              f"max |norm - 1| {norm_err:.2e}; wall {wall:.2f} s")
    if not norm_err <= 1e-5:
        fail("binarized speaker embeddings are not unit vectors")
    report["launched"] = launched(all_counters)
    if report["launched"]:
        fail(f"the speaker encoder launched kernels: {report['launched']}")
    return report


def zoo_configs() -> dict:
    """The two diffusion-zoo configurations at their configs' full width:
    ``micro_lj_pwg.yaml`` and ``micro_lj.yaml`` with ``denoiser: wavenet,
    multiband: false`` (WaveNetConfig's defaults)."""
    from fastdiff_tpu_torch.utils.hparams import set_hparams
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fastdiff_tpu", "configs")

    def load(name):
        return set_hparams(config=os.path.join(configs, name),
                           print_hparams=False, global_hparams=False)
    return {"pwg": load("micro_lj_pwg.yaml"),
            "wavenet": dict(load("micro_lj.yaml"), denoiser="wavenet",
                            multiband=False)}


def grad_report(torch, names, card, cpu) -> tuple:
    """(global rel L2 of the card's gradients against the CPU's, (worst
    tensor's rel L2, its name))."""
    flat = [torch.cat([g.double().flatten().cpu() for g in gs])
            for gs in (card, cpu)]
    worst = max((rel_l2(a.cpu().double(), b.double()), n)
                for n, a, b in zip(names, card, cpu)
                if float(b.double().norm()) > 0)
    return rel_l2(flat[0], flat[1]), worst


def draw_out_conv(torch, model, seed: int = 26) -> None:
    """WaveNet's seed weights zero its output conv, which makes its output,
    and every gradient but that conv's, 0. Draw the conv U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) from a CPU generator instead: the same values on the
    card and on the CPU. A model with no ``out_conv`` (PWG) is left as
    drawn."""
    conv = getattr(model, "out_conv", None)
    if conv is None:
        return
    gen = torch.Generator().manual_seed(seed)
    bound = conv.weight[0].numel() ** -0.5
    with torch.no_grad():
        for p in (conv.weight, conv.bias):
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                  generator=gen))


def phase26_zoo(torch, all_counters, dev, smi_line) -> dict:
    """The diffusion zoo at the configs' full widths (diffusion PWG of
    ``micro_lj_pwg.yaml``: 30 layers, 3 stacks, 64 / 128 / 64, scales 4^4;
    WaveNet: 30 layers, 64 channels, 512-d embedding, x256) through
    ``FastDiffTask``, seed weights with WaveNet's output conv drawn
    (``draw_out_conv``): (a) 5 ``train_step``s at 20 x 25,600 (bf16, the
    configs' EMA) by CUDA events after one warm-up, with the peak memory;
    (b) one step card vs CPU at 2 x 2,560 in f32 with the same draws (loss
    rel 1e-5, gradients global rel L2 1e-4); the loss must differ from a
    zero output's, mean(z^2), by more than 1e-4 relative, and more than
    half of the gradient leaves outside ``out_conv`` must be non-zero on
    both sides; (c) the N = 4
    graph sampler at 864 frames (``make_test_sampler``): the third call (a
    replay) bit-equal to the eager ``sample`` with the same injected noise,
    ms per utterance by CUDA events; (d) the PWG vocoder's ``spec2wav`` at
    864 frames. One replayed sampler call must launch ``wavenet_block``
    (phase 37's kernel) once a block and step for the WaveNet, and nothing
    for the PWG; every kernel counter must read 0 across the rest (the
    training steps, the eager and graph sampler calls of the PWG, its
    vocoder)."""
    from fastdiff_tpu_torch.diffusion.sampler import sample
    from fastdiff_tpu_torch.training.task import FastDiffTask
    from fastdiff_tpu_torch.vocoders import get_vocoder_cls

    zero_counters(all_counters)
    report = {"device": smi_line}
    length = TRAIN_FRAMES * HOP_SIZE
    for name, hp in zoo_configs().items():
        row = report[name] = {}
        gen = torch.Generator(device=dev).manual_seed(26)
        batch = {"wavs": torch.randn((TRAIN_BATCH, length, 1), generator=gen,
                                     device=dev).mul_(0.3).cpu().numpy(),
                 "mels": torch.randn((TRAIN_BATCH, TRAIN_FRAMES, 80),
                                     generator=gen, device=dev).sub_(4.0)
                 .cpu().numpy()}
        ts = torch.randint(0, 1000, (TRAIN_BATCH, 1, 1), generator=gen,
                           device=dev)
        z = torch.randn((TRAIN_BATCH, length, 1), generator=gen, device=dev)
        task = FastDiffTask(hp, device=dev)
        state = task.build_state(seed=0)
        draw_out_conv(torch, state.model)
        n_params = sum(p.numel() for p in state.model.parameters())
        metrics = task.train_step(state, batch, ts=ts, z=z)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(5):
            metrics, ms = event_ms(torch, lambda: task.train_step(
                state, batch, ts=ts, z=z))
            times.append(ms)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        loss = float(metrics["loss"])
        row["train"] = dict(ms=times, ms_mean=float(np.mean(times)),
                            peak_gib=peak, loss=loss,
                            params=n_params, dtype=task.model_cfg.compute_dtype)
        phase(26, f"{name} ({n_params / 1e6:.3f} M params, "
                  f"{task.model_cfg.compute_dtype}, EMA "
                  f"{task.ema_decay}): train_step at {TRAIN_BATCH} x "
                  f"{length} {np.mean(times):.2f} ms (steps "
                  + ", ".join(f"{t:.2f}" for t in times) + f"), peak memory "
                  f"{peak:.2f} GiB, loss {loss:.5f} [{smi_line}]")
        if not np.isfinite(loss) or float(metrics["nonfinite"]):
            fail(f"{name}: the train step is not finite")
        del state, task, batch, z

        # (b) card vs CPU, f32
        f32 = dict(hp, compute_dtype="float32")
        gen = torch.Generator().manual_seed(27)
        small = {"wavs": (torch.randn((2, 2560, 1), generator=gen) * 0.3)
                 .numpy(), "mels": (torch.randn((2, 10, 80), generator=gen)
                                    - 4.0).numpy()}
        ts = torch.randint(0, 1000, (2, 1, 1), generator=gen)
        z = torch.randn((2, 2560, 1), generator=gen)
        sides = {}
        for side, device in (("card", dev), ("cpu", "cpu")):
            t = FastDiffTask(f32, device=device)
            model = t.build_state(seed=0).model
            draw_out_conv(torch, model)
            names, params = zip(*model.named_parameters())
            value = t.loss(model, small, ts=ts.to(device), z=z.to(device))
            grads = torch.autograd.grad(value, params,
                                        materialize_grads=True)
            sides[side] = (float(value.detach()), grads)
        loss_rel = abs(sides["card"][0] - sides["cpu"][0]) / abs(
            sides["cpu"][0])
        g_rel, (w_rel, w_name) = grad_report(torch, names, sides["card"][1],
                                             sides["cpu"][1])
        # a network whose output is 0 has the loss mean(z^2) and gradients
        # only in its output conv
        zero_loss = float(z.double().pow(2).mean())
        from_zero = abs(sides["cpu"][0] - zero_loss) / zero_loss
        inner = [bool(a.any()) and bool(b.any()) for n, a, b in
                 zip(names, sides["card"][1], sides["cpu"][1])
                 if not n.startswith("out_conv.")]
        live = sum(inner)
        row["card_vs_cpu"] = dict(loss_rel=loss_rel, grad_rel_l2=g_rel,
                                  worst=[w_name, w_rel],
                                  loss_rel_to_zero_output=from_zero,
                                  live_leaves=[live, len(inner)])
        phase(26, f"{name} f32 one step card vs CPU at 2 x 2,560: loss rel "
                  f"{loss_rel:.2e} (bound 1e-5), gradients global rel L2 "
                  f"{g_rel:.2e} (bound 1e-4; worst tensor {w_name} "
                  f"{w_rel:.2e}); loss {sides['cpu'][0]:.5f} against a zero "
                  f"output's {zero_loss:.5f} (rel {from_zero:.2e}), "
                  f"{live} / {len(inner)} gradient leaves outside out_conv "
                  f"non-zero on both sides")
        if not (loss_rel <= 1e-5 and g_rel <= 1e-4):
            fail(f"{name}: the card's step disagrees with the CPU's")
        if not (from_zero > 1e-4 and 2 * live > len(inner)):
            fail(f"{name}: the loss does not depend on the network")
        del sides

        if launched(all_counters):
            fail(f"{name}: the training steps launched kernels: "
                 f"{launched(all_counters)}")

        # (c) the N = 4 graph sampler
        task = FastDiffTask(hp, device=dev)
        model = task.build_state(seed=0).model
        draw_out_conv(torch, model)
        state_dict = task.inference_state_dict(model.state_dict())
        const = task.sampler_constants()
        sampler = task.make_test_sampler(state_dict, const)
        frames = ZOO_FRAMES
        audio_len = frames * HOP_SIZE
        gen = torch.Generator(device=dev).manual_seed(28)
        mel = torch.randn((1, frames, 80), generator=gen, device=dev) - 4.0
        noise = (torch.randn((1, audio_len, 1), generator=gen, device=dev),
                 [torch.randn((1, audio_len, 1), generator=gen, device=dev)
                  for _ in range(const.n_steps)])
        outs = [sampler(None, None, mel, audio_len, noise=noise)
                for _ in range(3)]            # warm-up, capture, replay
        with torch.inference_mode():
            eager = sample(sampler.model, mel, const, audio_len, noise=noise)
        equal = [bool(torch.equal(o, eager)) for o in outs]
        ms = cuda_ms(lambda: sampler(None, None, mel, audio_len,
                                     noise=noise), 3)
        # the launches of one replayed call: the WaveNet's blocks each step,
        # each block one launch of the block kernel
        want = ({"wavenet_block": len(model.blocks) * const.n_steps}
                if name == "wavenet" else {})
        other = {k: v for k, v in launched(all_counters).items()
                 if k not in want}
        if other:
            fail(f"{name}: the sampler calls launched {other}")
        zero_counters(all_counters)
        sampler(None, None, mel, audio_len, noise=noise)
        torch.cuda.synchronize()
        per_call = launched(all_counters)
        zero_counters(all_counters)
        audio_s = audio_len * AUDIO_SECONDS_PER_SAMPLE
        row["sampler"] = dict(ms=ms, rtf=ms / 1e3 / audio_s,
                              bit_equal=equal, captures=sampler.captures,
                              max_abs_err=max_abs(outs[-1], eager),
                              launches_per_call=per_call)
        phase(26, f"{name} N = {const.n_steps} graph sampler at {frames} "
                  f"frames ({audio_s:.2f} s): {ms:.2f} ms per utterance by "
                  f"CUDA events (RTF {ms / 1e3 / audio_s:.4f}), captures "
                  f"{sampler.captures}; warm-up / capture / replay bit-equal "
                  f"to the eager loop {equal}; one replayed call launches "
                  f"{per_call or 'no kernel'} [{smi_line}]")
        if not all(equal) or sampler.captures != 1 or \
                not bool(outs[-1].isfinite().all()):
            fail(f"{name}: the graph sampler differs from the eager loop")
        if per_call != want:
            fail(f"{name}: one sampler call launched {per_call}, not {want}")
        del sampler, task, model, outs, eager, noise

    # (d) the PWG vocoder
    voc = get_vocoder_cls({"vocoder": "pwg"})({}, device=dev)
    mel = np.random.default_rng(29).standard_normal(
        (ZOO_FRAMES, 80)).astype(np.float32) - 4.0
    wav = voc.spec2wav(mel)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        wav = voc.spec2wav(mel)
        walls.append((time.perf_counter() - t0) * 1e3)
    report["pwg_vocoder"] = dict(ms=walls, samples=len(wav),
                                 dtype=voc.cfg.compute_dtype)
    phase(26, f"PWG vocoder (seed-0 weights, {voc.cfg.compute_dtype}) "
              f"spec2wav at {ZOO_FRAMES} frames: {len(wav)} samples, "
              + ", ".join(f"{t:.2f}" for t in walls) + " ms (host wall, "
              f"read back included) [{smi_line}]")
    if len(wav) != ZOO_FRAMES * HOP_SIZE or not np.isfinite(wav).all():
        fail("the PWG vocoder's waveform is wrong")
    report["launched"] = launched(all_counters)
    phase(26, f"kernel launches across the zoo paths but the WaveNet "
              f"sampler's: {report['launched'] or 'none'}")
    if report["launched"]:
        fail(f"the zoo paths launched kernels: {report['launched']}")
    return report


MOL_STEPS = 20


def phase27_mol(torch, all_counters, dev, smi_line) -> dict:
    """The MoL WaveNet at ``micro_lj_armol.yaml``'s full width (18 layers,
    3 stacks, 64 / 128 / 64, 30 outputs, scales 4 x 8 x 8, f32): (a)
    ``run.main`` fits 20 updates at 8 x 12,800 on phase 11's synthetic
    dataset (ms per ``train_step`` by CUDA events, peak memory; the loss
    must fall); (b) one step card vs CPU at 2 x 12,800 (loss rel 1e-5,
    gradients global rel L2 1e-4); (c) on the card
    ``wavenet_incremental_logits`` (the CUDA-graph loop) against the
    teacher-forced forward (1e-5); (d) the generation loop for 2,048 steps
    at 4 streams with injected draws, CUDA graph against eager (equal);
    (e) ``wavenet_generate`` of an 864-frame mel with the trained weights
    (folds 12,800 / 512): wall s, samples / s, RTF; no kernel launched."""
    from fastdiff_tpu_torch import run
    from fastdiff_tpu_torch.models import wavenet_mol as mol
    from fastdiff_tpu_torch.training.armol_task import MoLWaveNetTask
    from fastdiff_tpu_torch.utils.hparams import set_hparams

    zero_counters(all_counters)
    report = {"device": smi_line}
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "fastdiff_tpu", "configs", "micro_lj_armol.yaml")
    root = tempfile.mkdtemp(prefix="fastdiff_mol_")
    cwd = os.getcwd()
    try:
        os.chdir(root)
        os.makedirs(os.path.join(root, "binary"))
        write_synthetic_dataset(os.path.join(root, "binary"), seed=27)
        overrides = (f"binary_data_dir={os.path.join(root, 'binary')},"
                     f"max_updates={MOL_STEPS},val_check_interval="
                     f"{MOL_STEPS},num_sanity_val_steps=0,tb_log_interval=1")
        timed = []
        original = MoLWaveNetTask.train_step

        def train_step(self, state, batch, generator=None):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = original(self, state, batch, generator)
            end.record()
            end.synchronize()
            timed.append(start.elapsed_time(end))
            return out

        MoLWaveNetTask.train_step = train_step
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        try:
            fit = run.main(["--config", config, "--exp_name", "mol",
                            "--device", dev.type, "--hparams", overrides])
        finally:
            MoLWaveNetTask.train_step = original
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        with open(os.path.join("checkpoints", "mol", "tb_logs",
                               "metrics.jsonl")) as f:
            losses = [r["tr/loss"] for r in map(json.loads, f)
                      if "tr/loss" in r]
        model = fit["state"].model
        cfg = model.cfg
        hp = set_hparams(config=config, hparams_str=overrides,
                         print_hparams=False, global_hparams=False)
        ms = timed[1:]
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        report["fit"] = dict(steps=fit["step"], ms=timed,
                             ms_median=float(np.median(ms)), peak_gib=peak,
                             losses=losses, wall_s=wall,
                             val_loss=fit["val"]["loss"])
        phase(27, f"(a) run.main fit on micro_lj_armol.yaml ({cfg.layers} "
                  f"layers, {cfg.stacks} stacks, {cfg.residual_channels} / "
                  f"{cfg.gate_channels} / {cfg.skip_channels}, "
                  f"{cfg.out_channels} outputs, {cfg.compute_dtype}): "
                  f"{fit['step']} updates at {hp['max_sentences']} x "
                  f"{hp['max_samples']}, train_step {np.median(ms):.2f} ms "
                  f"median of steps 2-{len(timed)} by CUDA events, peak "
                  f"memory {peak:.2f} GiB; loss mean of the first 5 "
                  f"{first:.4f} -> last 5 {last:.4f}; val "
                  f"{fit['val']['loss']:.4f}; wall {wall:.1f} s "
                  f"[{smi_line}]")
        if fit["step"] != MOL_STEPS or not last < first:
            fail("the MoL WaveNet fit did not lower the loss")

        # (b) card vs CPU
        gen = torch.Generator().manual_seed(27)
        small = {"wavs": torch.tanh(torch.randn((2, 12800, 1), generator=gen))
                 .numpy(), "mels": (torch.randn((2, 50, 80), generator=gen)
                                    - 4.0).numpy()}
        sides = {}
        for side, device in (("card", dev), ("cpu", "cpu")):
            task = MoLWaveNetTask(hp, device=device)
            m = task.build_state(seed=0).model
            names, params = zip(*m.named_parameters())
            value = task.loss(m, small)
            sides[side] = (float(value.detach()), torch.autograd.grad(
                value, params, materialize_grads=True))
        loss_rel = abs(sides["card"][0] - sides["cpu"][0]) / abs(
            sides["cpu"][0])
        g_rel, (w_rel, w_name) = grad_report(torch, names, sides["card"][1],
                                             sides["cpu"][1])
        report["card_vs_cpu"] = dict(loss_rel=loss_rel, grad_rel_l2=g_rel,
                                     worst=[w_name, w_rel])
        phase(27, f"(b) one step card vs CPU at 2 x 12,800 f32: loss rel "
                  f"{loss_rel:.2e} (bound 1e-5), gradients global rel L2 "
                  f"{g_rel:.2e} (bound 1e-4; worst tensor {w_name} "
                  f"{w_rel:.2e})")
        if not (loss_rel <= 1e-5 and g_rel <= 1e-4):
            fail("the MoL WaveNet's card step disagrees with the CPU's")
        del sides

        # (c) the one-sample loop against the teacher-forced forward
        model.eval()
        gen = torch.Generator(device=dev).manual_seed(30)
        x = torch.tanh(torch.randn((2, 2 * cfg.hop, 1), generator=gen,
                                   device=dev))
        mel = torch.randn((2, 2, 80), generator=gen, device=dev) - 4.0
        with torch.no_grad():
            want = model(x, mel)
        t0 = time.perf_counter()
        got = mol.wavenet_incremental_logits(model, x, mel)
        torch.cuda.synchronize()
        inc_s = time.perf_counter() - t0
        inc_err = max_abs(got, want)
        report["incremental"] = dict(steps=x.shape[1], max_abs_err=inc_err,
                                     wall_s=inc_s)
        phase(27, f"(c) wavenet_incremental_logits (CUDA graph of 64-step "
                  f"chunks) over {x.shape[1]} steps x 2 against the "
                  f"teacher-forced forward: max abs {inc_err:.2e} (bound "
                  f"1e-5); wall {inc_s:.2f} s")
        if not inc_err <= 1e-5:
            fail("the incremental logits disagree with the forward")

        # (d) the generation loop, graph against eager, injected draws
        steps, streams = 2048, 4
        cond = torch.randn((streams, steps, 80), generator=gen, device=dev)
        draws = mol.make_draws(cfg, steps, streams, gen, dev)
        runs = {}
        for mode in ("graph", "eager"):
            t0 = time.perf_counter()
            runs[mode] = mol.wavenet_generate_batched(
                model, cond, draws=draws, graph=mode == "graph")
            torch.cuda.synchronize()
            runs[mode + "_s"] = time.perf_counter() - t0
        equal = bool(torch.equal(runs["graph"], runs["eager"]))
        report["graph_vs_eager"] = dict(
            steps=steps, streams=streams, equal=equal,
            max_abs_err=max_abs(runs["graph"], runs["eager"]),
            graph_s=runs["graph_s"], eager_s=runs["eager_s"])
        phase(27, f"(d) generation loop {steps} steps x {streams} streams, "
                  f"injected draws: CUDA graph equal to the eager loop "
                  f"{equal}; graph {runs['graph_s']:.2f} s (capture "
                  f"included), eager {runs['eager_s']:.2f} s "
                  f"[{smi_line}]")
        if not equal:
            fail("the graphed AR loop differs from the eager loop")

        # (e) wavenet_generate of 10 s
        mel = (torch.randn((1, ZOO_FRAMES, 80), generator=gen, device=dev)
               - 4.0)
        t0 = time.perf_counter()
        wav = mol.wavenet_generate(model, mel, gen, target=12800,
                                   overlap=512)
        gen_s = time.perf_counter() - t0
        audio_s = len(wav) * AUDIO_SECONDS_PER_SAMPLE
        folds = mol.fold_with_overlap(torch.zeros(1, ZOO_FRAMES * cfg.hop, 1),
                                      12800, 512).shape[0]
        report["generate"] = dict(frames=ZOO_FRAMES, samples=len(wav),
                                  folds=folds, wall_s=gen_s,
                                  samples_per_s=len(wav) / gen_s,
                                  rtf=gen_s / audio_s)
        phase(27, f"(e) wavenet_generate of {ZOO_FRAMES} frames ({folds} "
                  f"folds of 12,800 + 2 x 512 as one batch, trained "
                  f"weights): {len(wav)} samples in {gen_s:.2f} s, "
                  f"{len(wav) / gen_s:.0f} samples/s, RTF "
                  f"{gen_s / audio_s:.3f} [{smi_line}]")
        if len(wav) != ZOO_FRAMES * cfg.hop or not np.isfinite(wav).all():
            fail("wavenet_generate's waveform is wrong")
        report["launched"] = launched(all_counters)
        if report["launched"]:
            fail(f"the MoL paths launched kernels: {report['launched']}")
        return report
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)


def phase28_nwc_gradients(torch, nwc_ops, randn, c, layers, hid,
                          smi_line) -> dict:
    """The trainable NWC route's Functions against autograd through their
    plain versions at the recipe's fused shapes (b 20 x 100 frames, hops
    64 and 256), bf16; the forward kernels' ms per ``nwc_vjp`` step (K7
    twice at 2,000 rows, K6 at hops 64 and 256) by CUDA-graph replay,
    beside their plain versions and their bound."""
    rows = nwc_ops.aug_rows(c)
    m, k, n = TRAIN_BATCH * TRAIN_FRAMES, 3 * hid, layers * rows * 2 * c
    tap, w = randn(m, k), randn(k, n, scale=0.05)
    b = randn(n, scale=0.1, dtype=torch.float32)
    checks = {"AugHead (K7)": grad_errors(
        torch, nwc_ops.AugHead.apply, nwc_ops.aug_head_matmul_plain,
        (tap, w, b), randn(m, n))}
    with torch.no_grad():
        ms_k = 2 * graph_ms(lambda: nwc_ops.aug_head_matmul(tap, w, b), 10)
        ms_p = 2 * cuda_ms(lambda: nwc_ops.aug_head_matmul_plain(tap, w, b),
                           3)
    per_step = {"aug_head": [ms_k, ms_p, [gemm_work(m, k, n)] * 2],
                "lvc_block_nwc": [0.0, 0.0, []]}
    del tap, w, b
    wstack = randn(layers, rows, c, scale=0.1)
    for hop in (64, HOP_SIZE):
        length = TRAIN_FRAMES * hop
        x = randn(TRAIN_BATCH, length, c)
        skip = randn(TRAIN_BATCH, length, c)
        kern = randn(TRAIN_BATCH, TRAIN_FRAMES, layers, rows, 2 * c,
                     scale=0.05)
        checks[f"LVCBlockNWCRecompute (K6) hop {hop}"] = grad_errors(
            torch, lambda *a, hop=hop: nwc_ops.LVCBlockNWCRecompute.apply(
                *a, hop),
            lambda *a, hop=hop: nwc_ops.lvc_block_nwc_plain(*a, hop),
            (x, skip, kern, wstack), randn(TRAIN_BATCH, length, c))
        with torch.no_grad():
            acc = per_step["lvc_block_nwc"]
            acc[0] += graph_ms(lambda hop=hop: nwc_ops.lvc_block_nwc(
                x, skip, kern, wstack, hop), 10)
            acc[1] += cuda_ms(lambda hop=hop: nwc_ops.lvc_block_nwc_plain(
                x, skip, kern, wstack, hop), 3)
            acc[2].append(block_work(TRAIN_BATCH, c, length,
                                     2.0 * kern.numel()))
        del x, skip, kern
    torch.cuda.synchronize()
    out = {}
    for name, (ms, plain, works) in per_step.items():
        b_ms, by = bound(works)
        out[name] = dict(train_ms_per_step=ms, train_plain_ms_per_step=plain,
                         train_bound_ms_per_step=b_ms)
        phase(28, f"{name} forward per nwc_vjp step at the recipe: {ms:.4f} "
                  f"ms (CUDA-graph replay), plain {plain:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({by}), at {b_ms / ms:.1%} of it "
                  f"[{smi_line}]")
    for name, errs in checks.items():
        phase(28, f"{name} input gradients vs autograd through the plain "
                  f"version (bf16, b {TRAIN_BATCH} x {TRAIN_FRAMES} "
                  "frames): rel_l2 " + ", ".join(f"{e:.3e}" for e in errs)
                  + " (bound 5e-2)")
        if not all(e <= 5e-2 for e in errs):
            fail(f"{name} gradients disagree with the plain version")
    return out


SANITY_STEPS = 300               # the learning check's cut (of 2,500)
SANITY_RATIO = 0.5               # last-50 mean loss <= this x first-10 mean


def make_tones_dataset(root: str, walls: dict) -> dict:
    """``scripts/e2e_sanity.py``'s 24 tones binarized under ``root`` by the
    port's ``VocoderBinarizer`` (pickle shards and v2 files); its hparams."""
    from fastdiff_tpu_torch.data.binarizer import VocoderBinarizer
    from fastdiff_tpu_torch.scripts import e2e_sanity
    t0 = time.perf_counter()
    e2e_sanity.write_tones(root)
    hp = e2e_sanity.sanity_hparams(root)
    VocoderBinarizer(hp).process()
    walls["binarize"] = time.perf_counter() - t0
    return hp


def phase29_native_loader(torch, FastDiffTask, Trainer, root: str, dev,
                          smi_line) -> dict:
    """The C++ mmap loader: (a) its build, (b) the binarizer's v2 files and
    native batches bit-equal to the pickle path's on the same draws, (c)
    batches per second native vs pickle at the learning check's 16 x 12,800,
    (d) a 3-step fit fed by it."""
    from fastdiff_tpu_torch.data import dataset as pds
    from fastdiff_tpu_torch.data import native_io
    report = {}
    # (a) a cold build into a fresh directory
    build_dir = native_io.BUILD_DIR
    with tempfile.TemporaryDirectory(prefix="fastdiff_native_") as tmp:
        native_io.BUILD_DIR = pathlib.Path(tmp)
        native_io.library.cache_clear()
        t0 = time.perf_counter()
        native_io.library()
        report["build_s"] = time.perf_counter() - t0
        native_io.BUILD_DIR = build_dir
        native_io.library.cache_clear()
    native_io.library()
    phase(29, f"(a) g++ built {native_io.library_path().name} in "
              f"{report['build_s']:.2f} s")
    # (b) the binarizer's files, native batches against pickle batches
    walls = {}
    hp = make_tones_dataset(root, walls)
    binary = hp["binary_data_dir"]
    files = sorted(f for f in os.listdir(binary) if f.endswith((".bin",
                                                               ".bidx")))
    if files != ["test.bidx", "test.bin", "train.bidx", "train.bin",
                 "valid.bidx", "valid.bin"]:
        fail(f"the binarizer wrote v2 files {files}")
    bare = os.path.join(root, "binary_pickle")
    shutil.copytree(binary, bare, ignore=shutil.ignore_patterns("*.bi*"))
    frames = hp["max_samples"] // hp["hop_size"]
    batch = hp["max_sentences"]

    def batches(data_dir):
        ds = pds.VocoderDataset(dict(hp, binary_data_dir=data_dir), "train",
                                shuffle=True)
        return pds.train_batch_iterator(ds, batch, frames, seed=0)

    before = native_io.BATCHES
    nat, pic = batches(binary), batches(bare)
    for i in range(20):
        a, b = next(nat), next(pic)
        if not all(np.array_equal(a[k], b[k]) for k in ("mels", "wavs")):
            fail(f"native batch {i} differs from the pickle path's")
    if native_io.BATCHES - before != 20:
        fail("the native loader did not serve the native stream")
    phase(29, f"(b) VocoderBinarizer on 24 tones in {walls['binarize']:.2f} "
              f"s wrote {files}; 20 batches of {batch} x "
              f"{frames * hp['hop_size']} samples bit-equal to the pickle "
              "path's (same items, same crop starts)")

    # (c) batches per second on the host, pickle, native, native, pickle
    def rate(data_dir, n=200):
        it = batches(data_dir)
        next(it)
        t0 = time.perf_counter()
        for _ in range(n):
            next(it)
        return n / (time.perf_counter() - t0)
    runs = {"pickle": [rate(bare)], "native": [rate(binary), rate(binary)]}
    runs["pickle"].append(rate(bare))
    report["batches_per_s"] = {k: sum(v) / 2 for k, v in runs.items()}
    report["batches_per_s_runs"] = runs
    phase(29, f"(c) {batch} x {frames * hp['hop_size']} batches per second "
              "on the host: native "
              f"{report['batches_per_s']['native']:.1f} (runs "
              + ", ".join(f"{v:.1f}" for v in runs["native"])
              + f"), pickle {report['batches_per_s']['pickle']:.1f} (runs "
              + ", ".join(f"{v:.1f}" for v in runs["pickle"]) + ")")
    # (d) a short fit through the trainer on the native path
    before = native_io.BATCHES
    work = os.path.join(root, "work_fit3")
    fit_hp = dict(hp, work_dir=work, max_updates=3, val_check_interval=3,
                  num_sanity_val_steps=0, tb_log_interval=1)
    t0 = time.perf_counter()
    result = Trainer(FastDiffTask(fit_hp, device=dev), work).fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    served = native_io.BATCHES - before
    phase(29, f"(d) fit of {result['step']} steps in {fit_s:.1f} s, val "
              f"{result['val']['loss']:.4f}; native batches {served} "
              f"[{smi_line}]")
    if result["step"] != 3 or served < 3:
        fail("the 3-step fit did not train on the native loader")
    report.update(fit_s=fit_s, fit_native_batches=served,
                  binarize_s=walls["binarize"])
    shutil.rmtree(bare, ignore_errors=True)
    return report, hp


def phase30_ddp(torch, FastDiff, cfg, dev, smi_line) -> dict:
    """(a) ``torchrun --nproc_per_node 1`` (NCCL, world size 1): 3 steps of
    FastDiffTask under DDP against the same 3 steps in this process, which
    has no process group; (b) ``DistributedChunkedVocoder`` at one device
    against ``ChunkedVocoder`` on 3,000 frames."""
    from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                      inference_generator,
                                                      make_sampler)
    from fastdiff_tpu_torch.scripts import ddp_steps
    from fastdiff_tpu_torch.serving.chunked_vocoder import (
        ChunkedVocoder, DistributedChunkedVocoder)
    from fastdiff_tpu_torch.training.task import FastDiffTask
    report = {}
    flags_before = (torch.backends.cudnn.deterministic,
                    torch.backends.cudnn.benchmark)
    flags = ddp_steps.deterministic()
    steps = 3
    with tempfile.TemporaryDirectory(prefix="fastdiff_ddp_") as tmp:
        out = os.path.join(tmp, "steps.npz")
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m",
             "fastdiff_tpu_torch.scripts.ddp_steps", "--out", out,
             "--steps", str(steps)], cwd=repo, env=env, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
            fail(f"torchrun exited {proc.returncode}")
        got = dict(np.load(out))
    task = FastDiffTask({"use_pallas_block": "auto"}, device=dev)
    if task.mesh.distributed:
        fail("this process has a process group")
    losses, params, ddp = ddp_steps.run_steps(task, steps, TRAIN_BATCH,
                                              TRAIN_FRAMES)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        flags_before
    if ddp or not bool(got["ddp"]) or int(got["world_size"]) != 1:
        fail("the torchrun side did not run DDP at world size 1, or this "
             "side did")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                       losses))
    param_rel = max(rel_l2(torch.from_numpy(got["p:" + k]),
                           torch.from_numpy(v)) for k, v in params.items())
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("| rank")]
    phase(30, f"(a) torchrun --nproc_per_node 1 ({line[-1] if line else '?'}"
              f"; {wall:.1f} s) vs the same {steps} steps without DDP: "
              "losses " + ", ".join(f"{v:.6f}" for v in losses)
              + f"; max loss rel {loss_rel:.2e}, max parameter rel_l2 "
              f"{param_rel:.2e} (bound 1e-6); flags {flags}")
    if not (loss_rel <= 1e-6 and param_rel <= 1e-6):
        fail("DDP at world size 1 differs from the step without it")
    report.update(torchrun_s=wall, loss_rel=loss_rel, param_rel=param_rel)

    # (b) one device: the distributed chunked vocoder is the chunked one
    model = FastDiff(cfg, seed=0, device=dev).eval()
    run = make_sampler(model, constants_for_hparams({"N": 4}))
    mel = (np.random.default_rng(30).normal(
        size=(3000, cfg.cond_channels)) - 4.0).astype(np.float32)
    local = ChunkedVocoder(run, HOP_SIZE).vocode(
        mel, generator=inference_generator(0, dev))
    shard = DistributedChunkedVocoder(run, HOP_SIZE, devices=[dev])
    wav = shard.vocode(mel, generator=inference_generator(0, dev))
    err = rel_l2(torch.from_numpy(wav), torch.from_numpy(local))
    phase(30, f"(b) DistributedChunkedVocoder on {len(shard.devices)} "
              f"device(s) vs ChunkedVocoder, 3,000 frames: rel_l2 {err:.2e} "
              f"(bound 1e-6), bit-equal {np.array_equal(wav, local)} "
              f"[{smi_line}]")
    if wav.shape != (3000 * HOP_SIZE,) or not err <= 1e-6:
        fail("the distributed chunked vocoder differs at one device")
    report["chunked_rel_l2"] = err
    return report


def phase31_profiling(torch, FastDiff, cfg, dev, sampler_ms: float,
                      smi_line) -> dict:
    """``utils/profiling`` on phase 6's NCL graph sampler: the slope and
    median timers beside phase 6's CUDA-event time, a trace that names K1,
    K2 and K3, and ``RTFMeter`` over four utterances."""
    from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                      inference_generator,
                                                      make_sampler)
    from fastdiff_tpu_torch.utils import profiling
    model = FastDiff(cfg, seed=0, device=dev).eval()
    run = make_sampler(model, constants_for_hparams({"N": 4}))
    gen = inference_generator(1, dev)
    mel = torch.randn((1, FRAMES_10S, cfg.cond_channels), generator=gen,
                      device=dev) - 4.0
    length = FRAMES_10S * HOP_SIZE

    def call():
        return run(gen, mel, length)
    call()
    call()                                   # eager, then the capture
    slope = profiling.device_timer_slope(call, n1=5, n2=25, reps=3)
    median = profiling.device_timer(call, iters=10, pipeline=5)
    report = dict(slope_ms=slope, median_ms=median, phase6_ms=sampler_ms)
    phase(31, f"N=4 NCL graph sampler at {FRAMES_10S} frames: "
              f"device_timer_slope {slope:.3f} ms, device_timer "
              f"{median:.3f} ms, phase 6's CUDA events {sampler_ms:.3f} ms "
              f"[{smi_line}]")
    with tempfile.TemporaryDirectory(prefix="fastdiff_trace_") as tmp:
        with profiling.trace(tmp):
            profiling.force(call())
        text = (pathlib.Path(tmp) / "trace.json").read_text()
    names = {"K1": (r"lvc_block_tc_kernel<false", r"lvc_block_tc_kernelILb0"),
             "K2": (r"lvc_block_tc_kernel<true", r"lvc_block_tc_kernelILb1"),
             "K3": (r"head_gemm_kernel",)}
    seen = {k: sum(len(re.findall(p, text)) for p in pats)
            for k, pats in names.items()}
    report["trace_kernel_mentions"] = seen
    phase(31, f"trace() wrote trace.json ({len(text)} bytes) naming "
              + ", ".join(f"{k} {v} times" for k, v in seen.items()))
    if not all(seen.values()):
        fail("the trace does not name K1, K2 and K3")
    meter = profiling.RTFMeter()
    for frames in (100, 256, 500, FRAMES_10S):
        m = torch.randn((1, frames, cfg.cond_channels), generator=gen,
                        device=dev) - 4.0
        run(gen, m, frames * HOP_SIZE)
        run(gen, m, frames * HOP_SIZE)       # warm: eager, then capture
        with meter.measure(frames * HOP_SIZE):
            profiling.force(run(gen, m, frames * HOP_SIZE))
    report["rtf"] = meter.rtf
    phase(31, f"RTFMeter over 100 / 256 / 500 / {FRAMES_10S} frames "
              f"(replays): {meter.summary()}")
    if not 0 < meter.rtf < 1:
        fail("RTFMeter's RTF is not in (0, 1)")
    return report


def phase32_learning(torch, FastDiffTask, Trainer, counters, hp: dict, dev,
                     smi_line) -> dict:
    """The learning check's cut: ``scripts/e2e_sanity.py``'s data and
    hparams for ``SANITY_STEPS`` updates on ``ncl_sr``, fed by the native
    loader; the mean train loss of the last 50 updates must be at most
    ``SANITY_RATIO`` of the first 10's, every step launching K3 and the
    tensor-core K4 3 times each."""
    from fastdiff_tpu_torch.data import native_io
    work = os.path.join(os.path.dirname(hp["binary_data_dir"]), "work_cut")
    hp = dict(hp, work_dir=work, max_updates=SANITY_STEPS,
              val_check_interval=SANITY_STEPS, tb_log_interval=SANITY_STEPS,
              num_sanity_val_steps=0)
    steps = []
    task = FastDiffTask(hp, device=dev)
    if task.route != "ncl_sr":
        fail(f"the learning check resolved to route {task.route}")
    train_step = task.train_step

    def counted(state, batch, generator=None, **kw):
        before = (counters[0]["taug_head"], counters[1]["lvc_block_ncl_sr"])
        out = train_step(state, batch, generator, **kw)
        steps.append((out["loss"],
                      counters[0]["taug_head"] - before[0],
                      counters[1]["lvc_block_ncl_sr"] - before[1]))
        return out
    task.train_step = counted
    before = native_io.BATCHES
    t0 = time.perf_counter()
    result = Trainer(task, work).fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(s[0]) for s in steps]
    served = native_io.BATCHES - before
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-50:]))
    bad = [i for i, s in enumerate(steps) if s[1:] != (3, 3)]
    report = dict(steps=len(steps), wall_s=wall, first10=first, last50=last,
                  ratio=last / first, val=result["val"]["loss"],
                  native_batches=served,
                  losses=losses[:10] + losses[-50:])
    phase(32, f"learning check cut: {len(steps)} updates of "
              f"{hp['max_sentences']} x {hp['max_samples']} "
              f"(bf16, ncl_sr, native batches {served}) in {wall:.1f} s "
              f"({wall / max(len(steps), 1) * 1e3:.1f} ms an update with "
              f"validation); mean loss first 10 {first:.4f}, last 50 "
              f"{last:.4f}, ratio {last / first:.3f} (bound {SANITY_RATIO}); "
              f"val {result['val']['loss']:.4f}; steps not launching K3 3 / "
              f"K4 3: {bad[:5]} [{smi_line}]")
    if len(steps) != SANITY_STEPS or served < SANITY_STEPS:
        fail("the learning check did not run its updates on the native "
             "loader")
    if not np.all(np.isfinite(losses)) or not last <= SANITY_RATIO * first:
        fail("the vocoder did not learn: the last 50 updates' mean loss is "
             f"above {SANITY_RATIO} x the first 10's")
    if bad:
        fail("a learning-check step did not launch K3 and the tensor-core "
             "K4 exactly 3 times each")
    return report


FULL_REVERSE = (200, 1000)      # the reference's full reverse processes
CHECK_FRAMES = 100              # kernel route vs plain route, injected noise
REVERSE_BOUND = 0.1             # their waveforms' relative L2


def phase33_full_reverse(torch, FastDiff, all_counters, cfg, dev,
                         smi_line) -> dict:
    """The reference's full reverse process, N = 200 and N = 1000, on the
    NCL route at 864 frames, b 1, through ``make_param_sampler``
    (``fastdiff_tpu_torch/scripts/bench_n1000.py``'s ``build`` and
    ``measure``): the first (eager) call's wall; the second call's (the
    capture of the blocks of reverse steps and one sample's replays), each
    graph's nodes and instantiation, the pool's ``memory_reserved`` around
    it and the runner's buffer and draw bytes; the replay bit-equal to the
    first call with a generator of the same seed, launching exactly 3N K3,
    2N K1, N K2 and N K8 (``replay_launches`` and the counters of one call),
    finite; the replays' ms by CUDA events and x realtime. Then at 100
    frames the kernel route (``ncl``) against the plain route on the same
    seed-0 weights and injected noise, eagerly, at both N (relative L2 <=
    0.1); and ``run.main --infer --hparams N=200`` on two utterances of one
    128-frame bucket (K3 +600, K1 +400, K2 +200, K8 +200 each; the second
    captures)."""
    from fastdiff_tpu_torch import run
    from fastdiff_tpu_torch.config import AudioConfig
    from fastdiff_tpu_torch.diffusion.sampler import constants_for_hparams
    from fastdiff_tpu_torch.diffusion.sampler import sample as eager_sample
    from fastdiff_tpu_torch.ops import dsp
    from fastdiff_tpu_torch.scripts import bench_n1000
    from fastdiff_tpu_torch.utils import audio_io
    report = {}
    for n in FULL_REVERSE:
        want = {"taug_head": 3 * n, "lvc_block_ncl": 2 * n,
                "lvc_block_ncl_final": n,
                "downpath_ncl": k8_per_call(FRAMES_10S, n)}
        sampler, mel, length = bench_n1000.build(n, FRAMES_10S, dev, cfg)
        row = bench_n1000.measure(sampler, mel, length, 2)
        phase(33, f"N={n}, {FRAMES_10S} frames ({row['audio_s']:.2f} s), b "
                  f"1, NCL graph sampler: first call (eager) "
                  f"{row['first_s']:.2f} s; second (capture + one sample's "
                  f"replays) {row['capture_s']:.2f} s, graphs of "
                  f"{row['block']} steps "
                  + ", ".join(f"{nodes} nodes instantiated in {s_:.4f} s"
                              for nodes, s_ in row["graphs"])
                  + f"; memory_reserved {row['reserved_before'] / 2 ** 30:.3f}"
                  f" -> {row['reserved_after'] / 2 ** 30:.3f} GiB; runner "
                  f"buffers {row['buffer_bytes'] / 2 ** 20:.2f} MiB, draws "
                  f"{row['draw_bytes'] / 2 ** 20:.3f} MiB; replay "
                  f"{row['replay_ms']:.2f} ms = {row['ms_per_step']:.4f} "
                  f"ms/step -> {row['x_realtime']:.2f}x realtime; replay "
                  f"bit-equal to the first call: {row['bit_equal']}; "
                  f"launches per replay {row['launches']}, the second "
                  f"call's {row['second_launches']} [{smi_line}]")
        if not (row["finite"] and row["shape_ok"]):
            fail(f"N={n}: the replay is not finite or has the wrong shape")
        if not row["bit_equal"]:
            fail(f"N={n}: the replay differs from the first (eager) call")
        if row["launches"] != want or row["second_launches"] != want:
            fail(f"N={n}: a replay launched {row['launches']} (the second "
                 f"call {row['second_launches']}), expected {want}")
        report[n] = row
        del sampler

    # the kernel route against the plain route, injected noise, 100 frames
    models = {route: FastDiff(cfg, seed=0, infer_route=route,
                              device=dev).eval() for route in ("ncl", "plain")}
    length = CHECK_FRAMES * HOP_SIZE
    gen = torch.Generator(device=dev).manual_seed(33)
    mel = torch.randn((1, CHECK_FRAMES, cfg.cond_channels), generator=gen,
                      device=dev) - 4.0
    for n in FULL_REVERSE:
        const = constants_for_hparams({"N": n})
        draws = torch.randn((n + 1, 1, length, 1), generator=gen,
                            device=dev)
        noise = (draws[0], list(draws[1:]))
        outs = {}
        for route, model in models.items():
            with torch.inference_mode():
                outs[route] = eager_sample(model, mel, const, length,
                                           noise=noise)
        err = rel_l2(outs["ncl"], outs["plain"])
        report[n]["kernel_vs_plain_rel_l2"] = err
        phase(33, f"N={n}, {CHECK_FRAMES} frames, injected noise: kernel "
                  f"route vs plain route rel_l2 {err:.3e} (bound "
                  f"{REVERSE_BOUND}), max_abs {max_abs(outs['ncl'], outs['plain']):.3e}")
        if not all(torch.isfinite(o).all() for o in outs.values()):
            fail(f"N={n}: a route's waveform is not finite")
        if not err <= REVERSE_BOUND:
            fail(f"N={n}: the kernel route drifts from the plain route")
    del models

    # run.main --infer at N = 200 on two utterances of one bucket
    repo = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(repo, "fastdiff_tpu", "configs", "ljspeech.yaml")
    root = tempfile.mkdtemp(prefix="fastdiff_n200_")
    cwd = os.getcwd()
    try:
        os.chdir(root)
        mel_dir = os.path.join(root, "mels")
        os.makedirs(mel_dir)
        acfg = AudioConfig()
        frames = {}
        for i, sec in enumerate((1.2, 1.4)):
            name = f"utt{i}_{sec:g}s"
            mel_i = dsp.wav2mel_np(synth_wav(sec, i), acfg)[1].T
            np.save(os.path.join(mel_dir, f"{name}.npy"), mel_i)
            frames[name] = mel_i.shape[0]
        zero_counters(all_counters)
        t0 = time.perf_counter()
        results = run.main(["--config", config, "--exp_name", "n200",
                            "--infer", "--hparams",
                            f"test_mel_dir={mel_dir},N=200"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launched(all_counters)
        (gen_dir,) = [os.path.join(root, "checkpoints", "n200", d)
                      for d in os.listdir(os.path.join(root, "checkpoints",
                                                       "n200"))
                      if d.startswith("generated_")]
        for r in results:
            wav, _ = audio_io.load_wav(os.path.join(
                gen_dir, f"{r['item_name']}_pred.wav"))
            if len(wav) != r["frames"] * HOP_SIZE or \
                    not np.isfinite(wav).all():
                fail(f"N=200 --infer: {r['item_name']} wrote {len(wav)} "
                     f"samples for {r['frames']} frames, or non-finite")
        want = {"taug_head": 600 * len(frames),
                "lvc_block_ncl": 400 * len(frames),
                "lvc_block_ncl_final": 200 * len(frames),
                "downpath_ncl": k8_per_call(128, 200) * len(frames)}
        phase(33, "run.main --infer --hparams N=200: " + ", ".join(
            f"{r['item_name']} {r['frames']} -> {r['padded_frames']} frames "
            f"rtf {r['rtf']:.4f}" for r in results)
            + f"; captures {[r['captures'] for r in results]}; launches "
            f"{launches} (expected {want}); wall {wall:.1f} s "
            f"[{smi_line}]")
        if len(results) != len(frames) or launches != want or \
                [r["captures"] for r in results] != [0, 1]:
            fail("N=200 --infer did not vocode both utterances through one "
                 "bucket's graph on the kernels of its path")
        report["infer_n200"] = dict(wall_s=wall, rtf=[r["rtf"]
                                                      for r in results])
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    return report


def phase34_curve_and_drive(torch, hp: dict, dev, smi_line) -> dict:
    """The streaming curve twin (``scripts/streaming_latency_curve.py``) on
    the learning check's checkpoint (phase 32's work dir, its hparams
    written beside it as ``config.yaml``) and the tones' valid split: the
    five settings, each row's latency and metrics finite; then
    ``scripts/drive_ncl_sr.py`` at the recipe (exit 0)."""
    from fastdiff_tpu_torch.config import AudioConfig
    from fastdiff_tpu_torch.scripts import drive_ncl_sr
    from fastdiff_tpu_torch.scripts import streaming_latency_curve as curve
    from fastdiff_tpu_torch.utils.hparams import dump_yaml
    work = os.path.join(os.path.dirname(hp["binary_data_dir"]), "work_cut")
    with open(os.path.join(work, "config.yaml"), "w") as f:
        f.write(dump_yaml(dict(hp, work_dir=work)))
    t0 = time.perf_counter()
    rows = curve.main([work, "--device", str(dev)])
    curve_s = time.perf_counter() - t0
    audio = AudioConfig.from_hparams(hp)
    report = {"curve": [{k: v for k, v in r.items() if k != "pairs"}
                        for r in rows], "curve_s": curve_s}
    phase(34, f"streaming curve on {work} in {curve_s:.1f} s: " + "; ".join(
        f"({r['chunk']}, {r['halo']}) {r['latency_ms']:.0f} ms MCD "
        f"{r['mcd']:.2f} mel-L2 {r['mel_l2']:.3f} MR-STFT {r['mr_stft']:.3f}"
        for r in rows) + f" [{smi_line}]")
    if [(r["chunk"], r["halo"]) for r in rows] != curve.SETTINGS or any(
            r["latency_ms"] != (r["chunk"] - r["halo"]) * audio.hop_size
            / audio.sample_rate * 1e3
            or not all(np.isfinite(r[k]) for k in ("mcd", "mel_l2",
                                                   "mr_stft"))
            for r in rows):
        fail("the streaming curve's rows are not the five settings with "
             "finite metrics")
    t0 = time.perf_counter()
    code = drive_ncl_sr.main([])
    report["drive_ncl_sr"] = dict(exit=code, wall_s=time.perf_counter() - t0)
    phase(34, f"drive_ncl_sr at the recipe: exit {code} in "
              f"{report['drive_ncl_sr']['wall_s']:.1f} s")
    if code != 0:
        fail("drive_ncl_sr: the ncl_sr step is not finite or disagrees "
             "with the plain route")
    return report


def phase35_graft(torch, dev, smi_line) -> dict:
    """``scripts/graft_entry.py``: ``entry()`` on the card (the full-width
    forward at 25 frames, b 2: finite, its shape) and
    ``dryrun_multichip(torch.cuda.device_count())`` (NCCL ranks)."""
    from fastdiff_tpu_torch.scripts import graft_entry
    fn, example = graft_entry.entry()
    out = fn(*example)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: fn(*example), 5)
    phase(35, f"graft_entry.entry(): forward {tuple(out.shape)} on "
              f"{out.device}, finite {bool(torch.isfinite(out).all())}, "
              f"{ms:.3f} ms a call [{smi_line}]")
    if out.shape != (2, 25 * HOP_SIZE, 1) or not out.is_cuda or \
            not torch.isfinite(out).all():
        fail("graft_entry.entry()'s forward is not a finite (2, 6400, 1) "
             "waveform on the card")
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    try:
        results = graft_entry.dryrun_multichip(n, dev, timeout=600)
    except RuntimeError as e:
        fail(f"dryrun_multichip({n}): {str(e)[-2000:]}")
    wall = time.perf_counter() - t0
    phase(35, f"dryrun_multichip({n}) in {wall:.1f} s: " + "; ".join(
        f"rank {r['rank']}/{r['world']} ({r['backend']}) toy loss "
        f"{r['toy_loss']:.4f}, ncl_vjp {r['ncl_vjp_loss']:.4f}, full size "
        f"{r['full_loss']:.4f}" for r in results))
    if [r["backend"] for r in results] != ["nccl"] * n or \
            results[0].get("chunked_samples") != 16 * n * HOP_SIZE:
        fail("the dry run did not run NCCL ranks or vocode its chunks")
    return dict(entry_ms=ms, dryrun_s=wall, ranks=results)


WAVENET_SHAPES = ((16, 896), (1, FRAMES_10S))   # (batch, frames)
WAVENET_BLOCK_DILATIONS = tuple(2 ** k for k in range(10))


def wavenet_block_operands(torch, wb, gen, dev, batch, frames, first):
    """(x, skip_sum, part_t, mel, weights) at DiffWave BASE's widths, the
    weights drawn as the seed model draws them: block 0's kind (bf16 x, no
    skip sum) where ``first``, else a later block's (f32 x, a skip sum)."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(n, fan_in):
        return (torch.rand((n,), generator=gen, device=dev) * 2 - 1) \
            * fan_in ** -0.5

    c, m, s = wb.C, wb.N_MELS, 16
    w = wb.BlockWeights(
        randn(2 * c, c, 3, scale=(2 / (3 * c)) ** 0.5), uniform(2 * c, 3 * c),
        [(randn(1, 1, 3, 2 * s, scale=(2 / (6 * s)) ** 0.5),
          randn(1, scale=0.1)) for _ in range(2)],
        randn(2 * c, m, 1, scale=(2 / m) ** 0.5), uniform(2 * c, m),
        randn(c, c, 1, scale=(2 / c) ** 0.5), uniform(c, c),
        randn(c, c, 1, scale=(2 / c) ** 0.5), uniform(c, c))
    length = frames * s * s
    mel = (randn(batch, frames, m) - 4.0).to(torch.bfloat16)
    part_t = randn(batch, c)
    if first:
        return (torch.relu(randn(batch, c, length)).to(torch.bfloat16), None,
                part_t, mel, w)
    return randn(batch, c, length), randn(batch, c, length, scale=3.0), \
        part_t, mel, w


def wavenet_block_errors(torch, wb, got, want, x, skip):
    """Relative L2 gaps of x' and of the skip sum, each over what the block
    added (x' None: the last block's kind, the skip sum's gap alone)."""
    base_s = 0 if skip is None else skip
    es = float((got[1] - want[1]).norm() / (want[1] - base_s).norm())
    if got[0] is None:
        return None, es
    base_x = x.float() * wb.SQRT_HALF
    return float((got[0] - want[0]).norm() / (want[0] - base_x).norm()), es


def wavenet_block_f64(torch, wb, wc, x, skip, part_t, mel, w, dilation):
    """The block in float64 from the same bf16-rounded weights, mel and
    conditioning: the exact values both routes round."""
    import torch.nn.functional as F
    bf16, d64, c = torch.bfloat16, torch.float64, wb.C
    eye = torch.eye(wb.N_MELS, device=x.device)[:, :, None]
    cond = wc.wavenet_cond_plain(
        torch.zeros(x.shape[0], wb.N_MELS, x.shape[-1], dtype=bf16,
                    device=x.device), mel, w.ups, eye,
        torch.zeros(wb.N_MELS, device=x.device), stride=16).to(d64)
    pt = part_t.to(bf16) if x.dtype == bf16 else part_t
    a = (x.to(d64) + pt.to(d64)[:, :, None]).to(bf16).to(d64)
    z = F.conv1d(a, w.w_dil.to(bf16).to(d64), w.b_dil.to(d64),
                 padding=dilation, dilation=dilation)
    z = z + F.conv1d(cond, w.mel_w.to(bf16).to(d64), w.mel_b.to(d64))
    out = torch.tanh(z[:, :c]) * torch.sigmoid(z[:, c:])
    r = F.conv1d(out, w.w_res.to(bf16).to(d64), w.b_res.to(d64))
    sk = F.conv1d(out, w.w_skip.to(bf16).to(d64), w.b_skip.to(d64))
    return ((x.to(d64) + r) * math.sqrt(0.5),
            sk + (0 if skip is None else skip.to(d64)))


def phase37_wavenet_block(torch, all_counters, dev, smi_line) -> dict:
    """DiffWave's residual block kernel alone (phase 37 of the module
    docstring); returns its entry of the kernels' JSON line, at b 16 x 896
    frames (the DiffWave cell's longest call)."""
    from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                      make_sampler)
    from fastdiff_tpu_torch.models.wavenet import WaveNet, WaveNetConfig
    from fastdiff_tpu_torch.ops import _build
    from fastdiff_tpu_torch.ops import wavenet_block as wb
    from fastdiff_tpu_torch.ops import wavenet_cond as wc

    _build.library()
    log = (_build.BUILD_DIR / "build.log").read_text()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    regs = {}
    for s in wb.STRIDES:
        info = ptxas_entry(log, f"wavenet_block_kernelILi{s}E")
        regs[s] = info
        phase(37, f"wavenet_block_kernel<{s}>: {info}; {wb.smem_bytes(s)} "
                  f"bytes of dynamic shared memory, {wb.THREADS} threads "
                  f"({wb.GROUPS} groups), grid "
                  f"{wb.launch_grid(16, 896 * HOP_SIZE, sms)} at b 16 x "
                  f"{896 * HOP_SIZE} samples")
        check_no_spill(info, f"wavenet_block_kernel<{s}>")
    gen = torch.Generator(device=dev).manual_seed(37)
    report = {}
    for batch, frames in WAVENET_SHAPES:
        length = frames * 256
        worst = [0.0, 0.0]
        with torch.inference_mode():
            for d in WAVENET_BLOCK_DILATIONS:
                first, last = d == 1, d == 512
                x, skip, pt, mel, w = wavenet_block_operands(
                    torch, wb, gen, dev, batch, frames, first)
                want = wb.wavenet_block_plain(
                    x, None if skip is None else skip.clone(), pt, mel, w,
                    dilation=d, stride=16)
                got = wb.wavenet_block(
                    x, None if skip is None else skip.clone(), pt, mel, w,
                    dilation=d, stride=16, want_x=not last)
                torch.cuda.synchronize()
                finite = bool(got[1].isfinite().all()) and (
                    got[0] is None or bool(got[0].isfinite().all()))
                ex, es = wavenet_block_errors(torch, wb, got, want, x, skip)
                worst = [max(worst[0], ex or 0.0), max(worst[1], es)]
                if not finite or (ex or 0.0) >= 1e-2 or es >= 1e-2:
                    fail(f"wavenet_block at b {batch} x {frames}, dilation "
                         f"{d}: x' gap {ex}, skip gap {es}, finite {finite}")
                del x, skip, want, got
            f64 = {}
            if batch == 1:
                for d in (1, 16, 512):
                    x, skip, pt, mel, w = wavenet_block_operands(
                        torch, wb, gen, dev, batch, frames, d == 1)
                    exact = wavenet_block_f64(torch, wb, wc, x, skip, pt,
                                              mel, w, d)
                    plain = wb.wavenet_block_plain(
                        x, None if skip is None else skip.clone(), pt, mel,
                        w, dilation=d, stride=16)
                    kern = wb.wavenet_block(
                        x, None if skip is None else skip.clone(), pt, mel,
                        w, dilation=d, stride=16)
                    row = []
                    for i, base in enumerate((
                            x.double() * math.sqrt(0.5),
                            0 if skip is None else skip.double())):
                        size = (exact[i] - base).norm()
                        row.append([float((kern[i].double() - exact[i]).norm()
                                          / size),
                                    float((plain[i].double() - exact[i])
                                          .norm() / size)])
                    f64[d] = row
                    phase(37, f"dilation {d} against float64: x' kernel "
                              f"{row[0][0]:.3e} / plain {row[0][1]:.3e}, skip "
                              f"kernel {row[1][0]:.3e} / plain "
                              f"{row[1][1]:.3e}")
                    del x, skip, exact, plain, kern
            # ms per launch, the mean over the ten dilations of a later block
            x, skip, pt, mel, w = wavenet_block_operands(
                torch, wb, gen, dev, batch, frames, False)
            work = skip.clone()

            def kernel():
                for d in WAVENET_BLOCK_DILATIONS:
                    wb.wavenet_block(x, work, pt, mel, w, dilation=d,
                                     stride=16)

            def plain():
                for d in WAVENET_BLOCK_DILATIONS:
                    wb.wavenet_block_plain(x, skip, pt, mel, w, dilation=d,
                                           stride=16)

            n = len(WAVENET_BLOCK_DILATIONS)
            reps = 2 if batch > 1 else 20
            kernel_ms = graph_ms(kernel, reps) / n
            plain_ms = graph_ms(plain, 1, 3) / n
            kernel_ms2 = graph_ms(kernel, reps) / n
            del x, skip, work
        torch.cuda.empty_cache()
        nbytes = 4.0 * 4 * wb.C * batch * length
        ms = (kernel_ms + kernel_ms2) / 2
        row = dict(max_rel_l2_x=worst[0], max_rel_l2_skip=worst[1],
                   f64=f64, ms=ms, ms_runs=[kernel_ms, kernel_ms2],
                   bound_ms=nbytes / H100_HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes", plain_ms=plain_ms,
                   library_ms=None)        # no PyTorch call computes a block
        report[f"b{batch}x{frames}"] = row
        phase(37, f"wavenet_block at b {batch} x {frames} frames ({length} "
                  f"samples), ten dilations: updates within {worst[0]:.2e} "
                  f"(x') and {worst[1]:.2e} (skip) relative L2 of plain; "
                  f"kernel {ms:.4f} ms a launch by graph replay (runs "
                  f"{kernel_ms:.4f}, {kernel_ms2:.4f}; bound "
                  f"{row['bound_ms']:.4f} ms, x and skip f32 read + written "
                  f"at 3.35 TB/s: {row['bound_ms'] / ms:.1%}), plain (the "
                  f"library's ops) {plain_ms:.4f} ms (cudnn TF32 "
                  f"{torch.backends.cudnn.allow_tf32}) [{smi_line}]")

    # a DiffWave BASE graph sampler call at N = 6: 30 blocks x 6 steps
    model = WaveNet(WaveNetConfig(multiband=False), seed=0, device=dev).eval()
    const = constants_for_hparams({"T": 1000, "beta_0": 1e-6, "beta_T": 0.01,
                                   "noise_schedule": "", "N": 6})
    sampler = make_sampler(model, const)
    mel = torch.randn((1, 64, wb.N_MELS), generator=gen, device=dev) - 4.0
    length = 64 * HOP_SIZE
    sgen = torch.Generator(device=dev)
    for _ in range(2):
        sampler(sgen.manual_seed(1), mel, length)
    zero_counters(all_counters)
    wav = sampler(sgen.manual_seed(1), mel, length)
    torch.cuda.synchronize()
    launches = launched(all_counters)
    per_replay = sampler.replay_launches(mel, length)
    seen = replayed_kernels(torch, lambda: sampler(sgen.manual_seed(1), mel,
                                                   length),
                            per_replay, "DiffWave BASE sampler")
    zero_counters(all_counters)
    phase(37, f"DiffWave BASE N = {const.n_steps} graph sampler at 64 frames:"
              f" a replayed call launches {launches}, the profile of a "
              f"replay holds {seen}, finite {bool(wav.isfinite().all())}")
    if launches != {"wavenet_block": 30 * const.n_steps} or \
            seen != {"wavenet_block_kernel": 30 * const.n_steps} or \
            not bool(wav.isfinite().all()):
        fail("the DiffWave sampler call did not launch wavenet_block once a "
             "block and step, and nothing else")
    entry = dict(report[f"b{WAVENET_SHAPES[0][0]}x"
                        f"{WAVENET_SHAPES[0][1]}"])
    entry.update(shapes=report, registers=regs,
                 launches_per_sampler_call=launches["wavenet_block"])
    return entry


def check_no_jax():
    """Fail if jax or any module of the JAX package was imported."""
    bad = sorted(m for m in sys.modules if m in ("jax", "fastdiff_tpu")
                 or m.startswith(("jax.", "jaxlib", "fastdiff_tpu.")))
    if bad:
        fail(f"the port imported the JAX side: {bad[:8]}")


def main():
    import torch

    # --- phase 1: the card -------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA "
             "card and never falls back to the CPU")
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from fastdiff_tpu_torch.config import ModelConfig
        from fastdiff_tpu_torch.diffusion import sampler as sampler_mod
        from fastdiff_tpu_torch.diffusion.sampler import (
            constants_for_hparams, make_sampler, sample)
        from fastdiff_tpu_torch.models.fastdiff import FastDiff
        from fastdiff_tpu_torch.ops import (_build, downpath_pallas,
                                            lvc_block_ncl, lvc_block_pallas,
                                            lvc_head, wavenet_block)
        from fastdiff_tpu_torch.scripts import bench_mosaic_micro, exp_r4b
        from fastdiff_tpu_torch.serving.server import (VocoderService,
                                                       start_server)
        from fastdiff_tpu_torch.training.task import FastDiffTask
        from fastdiff_tpu_torch.training.trainer import Trainer
        from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import \
            FastDiffVocoder
    except ImportError as e:
        fail(f"cannot import the port (run from a checkout of the repo): {e}")
    check_no_jax()
    # f32 references: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    phase(1, f"device {kind}; torch {torch.__version__} cuda "
             f"{torch.version.cuda}")
    smi_line = (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
                and smi.stdout.strip() else "nvidia-smi: not available")
    print(smi_line, flush=True)
    # --- phase 2: build ----------------------------------------------------
    cfg = ModelConfig()
    c, layers = cfg.inner_channels, cfg.lvc_layers_each_block
    rows = 3 * c + 1
    rows_p = lvc_head.rows_padded(c)
    t0 = time.perf_counter()
    _build.library()
    log = (_build.BUILD_DIR / "build.log")
    phase(2, f"built {_build.library_path().name} in "
             f"{time.perf_counter() - t0:.1f} s")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
        plan = lvc_head.head_gemm_plan(
            FRAMES_10S, layers * 2 * c * rows_p, HEAD_K,
            torch.cuda.get_device_properties(0).multi_processor_count)
        info = ptxas_entry(log.read_text(), "head_gemm_kernelILi3E")
        phase(2, f"K3/K7/K10 head GEMM (head_gemm_kernel<3>, K = {HEAD_K}): "
                 f"{info}; dynamic shared memory {plan.smem_bytes} bytes "
                 f"({plan.stages} tap stages), {plan.grid} persistent blocks "
                 f"for {plan.units} units at {FRAMES_10S} frames")
        check_no_spill(info, "the head GEMM")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for final, wide, save in ((0, 0, 0), (0, 1, 0), (1, 0, 0),
                                  (1, 1, 0), (0, 0, 1), (0, 1, 1)):
            info = ptxas_entry(log.read_text(), f"lvc_block_tc_kernelILb"
                                                f"{final}ELb{wide}ELb{save}E")
            name = "K4 Kernel B-SR" if save else (
                "K2 Kernel B" if final else "K1 Kernel B")
            phase(2, f"{name} on the tensor cores (lvc_block_tc_kernel<"
                     f"{bool(final)}, {bool(wide)}, {bool(save)}>, "
                     f"{'hop 8' if wide else 'hops 16, 24, ...'}): {info}")
            check_no_spill(info, f"the tensor-core {name}")
        for hop in (8, 64, HOP_SIZE):
            bp = lvc_block_ncl.block_tile_plan(
                TRAIN_BATCH, TRAIN_FRAMES * hop, sms)
            phase(2, f"tensor-core K4 at hop {hop}, b {TRAIN_BATCH} x "
                     f"{TRAIN_FRAMES} frames: tile {bp.tile}, {bp.blocks} "
                     f"blocks in {bp.waves} wave(s) of "
                     f"{lvc_block_ncl.TC_BLOCKS_PER_SM} per SM, "
                     f"{bp.smem_bytes} bytes of dynamic shared memory")
        for stage in ("down_stage1", "down_stage2"):
            for ncl in (0, 1):
                info = ptxas_entry(log.read_text(), f"{stage}ILb{ncl}E")
                phase(2, f"K8 {stage}<{bool(ncl)}> ({'NCL' if ncl else 'NWC'}"
                         f") on the tensor cores: {info}")
                check_no_spill(info, f"K8's {stage}<{bool(ncl)}>")
        dpl = downpath_pallas.downpath_plan(1, FRAMES_10S * HOP_SIZE)
        phase(2, f"K8 at {FRAMES_10S * HOP_SIZE} samples, b 1: stage 1 "
                 f"{dpl.stage1_blocks} blocks ({dpl.smem1} bytes of dynamic "
                 f"shared memory), stage 2 {dpl.stage2_blocks} blocks "
                 f"({dpl.smem2} bytes), {downpath_pallas.THREADS} threads, "
                 f"{downpath_pallas.BLOCKS_PER_SM} blocks per SM")
        info = ptxas_entry(log.read_text(), "lvc_stage_kernel")
        phase(2, f"K9 lvc_stage on the tensor cores (lvc_stage_kernel): "
                 f"{info}; dynamic shared memory "
                 f"{bench_mosaic_micro.LVC_SMEM_BYTES} bytes, "
                 f"{bench_mosaic_micro.LVC_STAGES} ring stages of "
                 f"{bench_mosaic_micro.LVC_PIECE_ROWS} rows, K padded to "
                 f"{bench_mosaic_micro.LVC_K_PAD}, "
                 f"{bench_mosaic_micro.lvc_stage_grid(1, FRAMES_10S, 1, sms)}"
                 f" persistent blocks at {FRAMES_10S} frames (tf 1)")
        check_no_spill(info, "K9 lvc_stage")
        info = ptxas_entry(log.read_text(), "conv_stage_kernel")
        conv_rows = FRAMES_10S * HOP_SIZE
        phase(2, f"K9 conv_stage on the tensor cores (conv_stage_kernel): "
                 f"{info}; dynamic shared memory "
                 f"{bench_mosaic_micro.CONV_SMEM_BYTES} bytes, "
                 f"{bench_mosaic_micro.CONV_STAGES} ring stages of "
                 f"{bench_mosaic_micro.LVC_PIECE_ROWS} rows, "
                 + ", ".join(
                     f"{bench_mosaic_micro.conv_stage_grid(conv_rows, t, sms)}"
                     f" persistent blocks at tile_s {t}"
                     for t in bench_mosaic_micro.CONV_TILES)
                 + f" ({conv_rows} rows; default tile_s "
                   f"{bench_mosaic_micro.CONV_TILE_S})")
        check_no_spill(info, "K9 conv_stage")
        for final in (0, 1):
            info = ptxas_entry(log.read_text(), f"lvc_block_fh_tc_kernelILb"
                                                f"{final}E")
            phase(2, f"{'K5 final' if final else 'K5'} on the tensor cores "
                     f"(lvc_block_fh_tc_kernel<{bool(final)}>, "
                     f"{lvc_block_ncl.FH_THREADS} threads, no cluster): "
                     f"{info}")
            check_no_spill(info, "the tensor-core K5")
        for hop in (8, 64, HOP_SIZE):
            fp = lvc_block_ncl.fh_tile_plan(1, FRAMES_10S, hop, sms)
            phase(2, f"tensor-core K5 at hop {hop}, {FRAMES_10S} frames: tile "
                     f"{fp.tile} + 2 x {lvc_block_ncl.TC_HALO} halo, head "
                     f"over {fp.npad} frames, grid {fp.grid_x} x 1, no "
                     f"cluster ({fp.blocks} CTAs, {fp.waves} wave(s) of one "
                     f"per SM), {fp.smem_bytes} bytes of dynamic shared "
                     f"memory; w_head {fp.l2_bytes / 1e9:.3f} GB from L2 "
                     f"into the SMs per call")
        info = ptxas_entry(log.read_text(), "lvc_block_nwc_tc_kernel")
        phase(2, f"K6 on the tensor cores (lvc_block_nwc_tc_kernel): {info}")
        check_no_spill(info, "the tensor-core K6")
        for hop in (64, HOP_SIZE):
            np_ = lvc_block_pallas.nwc_tile_plan(1, FRAMES_10S * hop, sms)
            phase(2, f"tensor-core K6 at hop {hop}, {FRAMES_10S} frames: tile "
                     f"{np_.tile}, {np_.blocks} blocks of "
                     f"{lvc_block_ncl.TC_THREADS} threads (no cluster) in "
                     f"{np_.waves} wave(s) of "
                     f"{lvc_block_ncl.TC_BLOCKS_PER_SM} per SM, "
                     f"{np_.smem_bytes} bytes of dynamic shared memory, "
                     f"{lvc_block_pallas.NWC_STAGES} TMA slots of K_(i,f)")
        for hop in (8, 64, HOP_SIZE):
            bp = lvc_block_ncl.block_tile_plan(1, FRAMES_10S * hop, sms)
            phase(2, f"tensor-core Kernel B at hop {hop}, {FRAMES_10S} "
                     f"frames: tile {bp.tile} + 2 x {lvc_block_ncl.TC_HALO} "
                     f"halo ({1 - bp.tile / bp.ext:.1%} of the extent "
                     f"recomputed), {bp.blocks} blocks of "
                     f"{lvc_block_ncl.TC_THREADS} threads in {bp.waves} "
                     f"wave(s) of {lvc_block_ncl.TC_BLOCKS_PER_SM} per SM, "
                     f"{bp.smem_bytes} bytes of dynamic shared memory")

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    report = {}

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    with torch.inference_mode():
        # --- phase 3: Kernel A ---------------------------------------------
        # its row counts on the main paths: 100, 256, 864 frames (b 1),
        # the training recipe's 20 x 100 and 864 frames at b 4
        k, n = 3 * cfg.kpnet_hidden_channels, layers * 2 * c * rows_p
        cases = head_gemm_cases(3, "Kernel A taug_head", torch,
                                lvc_head.taug_head_matmul,
                                lvc_head.taug_head_matmul_plain, randn, k, n,
                                (100, 256, FRAMES_10S,
                                 TRAIN_BATCH * TRAIN_FRAMES, 4 * FRAMES_10S))
        _, ms_k, ms_p, ms_lib = cases[FRAMES_10S]
        report["taug_head"] = entry(max(v[0] for v in cases.values()),
                                    3 * ms_k, 3 * ms_p,
                                    [gemm_work(FRAMES_10S, k, n)] * 3,
                                    3 * ms_lib)

        # --- phase 4: Kernel B ---------------------------------------------
        report.update(phase4_block(torch, lvc_block_ncl, randn, c, layers,
                                   rows, rows_p, dev, smi_line))

        # --- phase 5: full-width denoiser forward --------------------------
        model = FastDiff(cfg, seed=0, device=dev).eval()
        length = FRAMES_10S * HOP_SIZE
        audio = torch.randn((1, length, 1), generator=gen, device=dev)
        mel = torch.randn((1, FRAMES_10S, cfg.cond_channels), generator=gen,
                          device=dev)
        t = torch.full((1, 1), 498.0, device=dev)
        model.use_kernels = True
        eps_k = model(audio, mel, t)
        model.use_kernels = False
        eps_p = model(audio, mel, t)
        torch.cuda.synchronize()
        err = rel_l2(eps_k, eps_p)
        phase(5, f"denoiser forward (1, {length}, 1) bf16: kernel vs plain "
                 f"rel_l2 {err:.3e} (bound 5e-2), max_abs_err "
                 f"{max_abs(eps_k, eps_p):.3e}")
        if eps_k.shape != (1, length, 1) or not torch.isfinite(eps_k).all():
            fail("denoiser output has the wrong shape or is not finite")
        if not err <= 5e-2:
            fail("denoiser kernel path disagrees with the plain path")

        # --- phase 6: N=4 sampler, 10 s, b=1 --------------------------------
        const = constants_for_hparams({"N": 4})
        run = make_sampler(model, const)
        races, wavs = {}, {}
        for use, label in ((True, "kernel"), (False, "plain")):
            model.use_kernels = use

            def graph():
                g = torch.Generator(device=dev).manual_seed(1)
                return run(g, mel, length)

            def eager():
                g = torch.Generator(device=dev).manual_seed(1)
                return sample(model, mel, const, length, generator=g)

            races[label] = race_sampler(graph, eager)
            wavs[label] = graph()
        model.use_kernels = True
        audio_s = length * AUDIO_SECONDS_PER_SAMPLE
        for label, race in races.items():
            report[f"sampler_{label}_ms"] = race["graph"]["ms"]
            report[f"sampler_{label}_eager_ms"] = race["eager"]["ms"]
            print(f"  {sampler_line('sampler ' + label, race, audio_s)}",
                  flush=True)
        for wav in wavs.values():
            if wav.shape != (1, length, 1) or not torch.isfinite(wav).all():
                fail("sampler output has the wrong shape or is not finite")
        phase(6, f"N=4 sampler, {FRAMES_10S} frames ({audio_s:.2f} s), CUDA "
                 f"graph (eager beside it): kernel "
                 f"{report['sampler_kernel_ms']:.3f} ms "
                 f"({report['sampler_kernel_eager_ms']:.3f}), plain "
                 f"{report['sampler_plain_ms']:.3f} ms "
                 f"({report['sampler_plain_eager_ms']:.3f}); {run.captures} "
                 f"graphs captured; kernel vs plain waveform rel_l2 "
                 f"{rel_l2(wavs['kernel'], wavs['plain']):.3e} [{smi_line}]")
        del model, run, eps_k, eps_p, wavs

    # --- phase 7: HTTP server, main path -----------------------------------
    counters = (lvc_head.LAUNCHES, lvc_block_ncl.LAUNCHES,
                downpath_pallas.LAUNCHES)
    per_step = len(cfg.upsample_ratios) * const.n_steps
    # K1 on the hop-8 and hop-64 blocks and K2 on the hop-256 block of every
    # step; K8 (NCL) once a step where the length is a multiple of 2048
    # (256 and 864 frames, not 100)
    rises = {"A": (("taug_head",), per_step),
             "K1": (("lvc_block_ncl",), (len(cfg.upsample_ratios) - 1)
                    * const.n_steps),
             "K2": (("lvc_block_ncl_final",), const.n_steps)}
    served = serve_and_count(
        7, VocoderService({"N": 4, "seed": 1234}, device=dev), start_server,
        counters, {frames: {**rises, "K8": (("downpath_ncl",), k8_per_call(
            frames, const.n_steps)), "K8 NWC": (("downpath",), 0)}
            for frames in (100, 256, FRAMES_10S)},
        cfg.cond_channels)
    launches = {k: served[k] for k in
                ("taug_head", "lvc_block_ncl", "lvc_block_ncl_final",
                 "downpath_ncl")}
    phase(7, f"server answered 3 requests; launches in the main path: "
             f"{launches}")
    if any(v == 0 for v in launches.values()):
        fail("a kernel of the main path was never launched")

    # --- phases 8-11: the training slice -----------------------------------
    report["lvc_block_ncl_sr"] = phase8_sr_block(
        torch, lvc_block_ncl, randn, c, layers, rows, rows_p, dev, smi_line)
    phase9_gradients(torch, lvc_block_ncl, lvc_head, randn, c, layers, rows,
                     rows_p, dev)
    all_counters = (lvc_head.LAUNCHES, lvc_block_ncl.LAUNCHES,
                    lvc_block_pallas.LAUNCHES, downpath_pallas.LAUNCHES,
                    bench_mosaic_micro.LAUNCHES, wavenet_block.LAUNCHES)
    train_report = phase10_train_step(torch, FastDiffTask, smi_line, dev,
                                      all_counters)
    train_launches, fit_s = phase11_fit(torch, FastDiffTask, Trainer,
                                        counters, dev)
    if any(train_launches[k] == 0 for k in ("taug_head", "lvc_block_ncl_sr")):
        fail("a kernel of the training path was never launched")
    launches["lvc_block_ncl_sr"] = train_launches["lvc_block_ncl_sr"]

    # --- phases 12-15: the NWC route ---------------------------------------
    nwc_model = FastDiff(cfg, seed=0, device=dev, infer_route="nwc",
                         down_kernel=True).eval()
    with torch.inference_mode():
        report["aug_head"] = phase12_aug_head(
            torch, lvc_block_pallas, randn, c, layers,
            cfg.kpnet_hidden_channels)
        report["lvc_block_nwc"] = phase13_nwc_block(
            torch, lvc_block_pallas, randn, c, layers, smi_line)
        report["downpath"], report["downpath_ncl"] = phase14_downpath(
            torch, downpath_pallas, nwc_model,
            FastDiff(cfg, seed=0, device=dev).eval(), dev, smi_line)
        nwc_sampler = phase15_nwc_route(torch, nwc_model, sample,
                                        make_sampler, const, gen, dev,
                                        smi_line)
    del nwc_model
    steps = const.n_steps
    # per request: K6 and K7 on the hop-64 and hop-256 blocks of every step;
    # K8 once a step where the length is a multiple of 2048 (256 and 864
    # frames, not 100); nothing of the NCL route
    nwc_launches = serve_and_count(
        15, VocoderService({"N": 4, "seed": 1234, "use_pallas_block": True,
                            "use_pallas_down": True}, device=dev),
        start_server, (lvc_head.LAUNCHES, lvc_block_ncl.LAUNCHES,
                       lvc_block_pallas.LAUNCHES, downpath_pallas.LAUNCHES),
        {frames: {"K6": (("lvc_block_nwc",), 2 * steps),
                  "K7": (("aug_head",), 2 * steps),
                  "K8": (("downpath",), k8),
                  "K8 NCL": (("downpath_ncl",), 0),
                  "K1": (("lvc_block_ncl", "lvc_block_ncl_final"), 0),
                  "K3": (("taug_head",), 0)}
         for frames, k8 in ((100, 0), (256, steps), (FRAMES_10S, steps))},
        cfg.cond_channels)
    nwc_launches = {k: nwc_launches[k] for k in
                    ("lvc_block_nwc", "aug_head", "downpath")}
    phase(15, f"NWC server answered 3 requests; launches in the main path: "
              f"{nwc_launches}")
    if any(v == 0 for v in nwc_launches.values()):
        fail("a kernel of the NWC route was never launched")
    launches.update(nwc_launches)

    # --- phases 16-17: the fused-head route ----------------------------------
    with torch.inference_mode():
        report.update(phase16_fh_block(torch, lvc_block_ncl, lvc_head, randn,
                                       c, layers, rows, rows_p, smi_line))
        fh_sampler = phase17_fh_route(torch, FastDiff, exp_r4b, cfg, gen, dev)
    k1_keys = ("lvc_block_ncl", "lvc_block_ncl_final")
    # per request: K5 on the hop-8 and hop-64 blocks of every step and K5
    # final on the hop-256 block; at 100 frames the hop-8 block is not
    # fusable (100 % 16 != 0) and runs K3 + K1, as the ncl route does; K8
    # (NCL) as on the ncl route
    fh_launches = serve_and_count(
        17, VocoderService({"N": 4, "seed": 1234,
                            "use_pallas_block": "ncl_fh"}, device=dev),
        start_server, all_counters,
        {frames: {"K5": (("lvc_block_ncl_fh",), fused * steps),
                  "K5 final": (("lvc_block_ncl_fh_final",), steps),
                  "K1": (k1_keys, (2 - fused) * steps),
                  "K3": (("taug_head",), (2 - fused) * steps),
                  "K8": (("downpath_ncl",), k8_per_call(frames, steps)),
                  "K8 NWC": (("downpath",), 0)}
         for frames, fused in ((100, 1), (256, 2), (FRAMES_10S, 2))},
        cfg.cond_channels)
    fh_launches = {k: fh_launches[k] for k in
                   ("lvc_block_ncl_fh", "lvc_block_ncl_fh_final")}
    phase(17, f"ncl_fh server answered 3 requests; launches in the main "
              f"path: {fh_launches}")
    if any(v == 0 for v in fh_launches.values()):
        fail("a kernel of the ncl_fh route was never launched")
    launches.update(fh_launches)
    every_kernel = [k for counter in all_counters for k in counter]
    serve_and_count(
        17, VocoderService({"N": 4, "seed": 1234, "use_pallas_block": False},
                           device=dev),
        start_server, all_counters,
        {256: {"all kernels": (every_kernel, 0)}}, cfg.cond_channels)
    phase(17, "plain-route server (use_pallas_block: false) answered with no "
              "kernel launched")

    # --- phases 18-19: the experiment scripts' kernels ---------------------
    for counter in all_counters:
        for key in counter:
            counter[key] = 0
    report["taug_head_variant"] = phase18_head_variants(exp_r4b, dev,
                                                        smi_line)
    launches["taug_head_variant"] = lvc_head.LAUNCHES["taug_head_variant"]
    report.update(phase19_stages(bench_mosaic_micro, dev, smi_line))
    launches.update(bench_mosaic_micro.LAUNCHES)
    if any(launches[k] == 0 for k in ("taug_head_variant", "conv_stage",
                                      "lvc_stage")):
        fail("a kernel of the experiment scripts was never launched")

    # --- phase 20: the graph sampler ----------------------------------------
    graph_report = phase20_graph_sampler(torch, FastDiff, sampler_mod,
                                         FastDiffVocoder, cfg, dev, smi_line)

    # --- phase 21: the entry path (run.py --infer) ------------------------
    t0 = time.perf_counter()
    entry_report = phase21_entry(torch, counters, dev, smi_line)
    phase(21, f"done in {time.perf_counter() - t0:.1f} s")
    check_no_jax()

    # --- phase 22: the TTS serving path -------------------------------------
    t0 = time.perf_counter()
    tts_report = phase22_tts(torch, counters, all_counters, dev, smi_line)
    tts_report["wall_s"] = time.perf_counter() - t0
    phase(22, f"done in {tts_report['wall_s']:.1f} s")
    check_no_jax()

    # --- phase 23: BDDM and evaluation --------------------------------------
    t0 = time.perf_counter()
    bddm_report = phase23_bddm(torch, counters, all_counters, dev, smi_line)
    bddm_report["wall_s"] = time.perf_counter() - t0
    phase(23, f"done in {bddm_report['wall_s']:.1f} s")
    check_no_jax()

    # --- phase 24: FastSpeech 2 training, raw audio to a vocoded wav --------
    # (its corpus stays for phase 25's speaker embeddings)
    corpus = tempfile.mkdtemp(prefix="fastdiff_fs2_")
    try:
        t0 = time.perf_counter()
        fs2_report = phase24_fs2_train(torch, all_counters, dev, smi_line,
                                       corpus)
        fs2_report["wall_s"] = time.perf_counter() - t0
        phase(24, f"done in {fs2_report['wall_s']:.1f} s")
        check_no_jax()

        # --- phase 25: the speaker encoder ----------------------------------
        t0 = time.perf_counter()
        zoo_report = {"spk": phase25_spk(torch, all_counters, dev, smi_line,
                                         corpus, fs2_report["paths"])}
        phase(25, f"done in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(corpus, ignore_errors=True)
    check_no_jax()

    # --- phase 26: the diffusion zoo (WaveNet, PWG) -------------------------
    t0 = time.perf_counter()
    zoo_report["diffusion"] = phase26_zoo(torch, all_counters, dev, smi_line)
    phase(26, f"done in {time.perf_counter() - t0:.1f} s")
    check_no_jax()

    # --- phase 27: the MoL WaveNet ------------------------------------------
    t0 = time.perf_counter()
    zoo_report["mol"] = phase27_mol(torch, all_counters, dev, smi_line)
    phase(27, f"done in {time.perf_counter() - t0:.1f} s")
    check_no_jax()

    # --- phase 28: the trainable NWC route's Functions ----------------------
    t0 = time.perf_counter()
    nwc_train = phase28_nwc_gradients(torch, lvc_block_pallas, randn, c,
                                      layers, cfg.kpnet_hidden_channels,
                                      smi_line)
    phase(28, f"done in {time.perf_counter() - t0:.1f} s")

    # --- phases 29-32: the loader, DDP, profiling, the learning check -------
    # (phase 29 binarizes the learning check's tones; phase 32 trains on
    # them)
    tones = tempfile.mkdtemp(prefix="fastdiff_tones_")
    try:
        t0 = time.perf_counter()
        loader_report, sanity_hp = phase29_native_loader(
            torch, FastDiffTask, Trainer, tones, dev, smi_line)
        phase(29, f"done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ddp_report = phase30_ddp(torch, FastDiff, cfg, dev, smi_line)
        phase(30, f"done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        prof_report = phase31_profiling(torch, FastDiff, cfg, dev,
                                        report["sampler_kernel_ms"], smi_line)
        phase(31, f"done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        learn_report = phase32_learning(torch, FastDiffTask, Trainer,
                                        counters, sanity_hp, dev, smi_line)
        phase(32, f"done in {time.perf_counter() - t0:.1f} s")

        # --- phase 33: the full reverse process, N = 200 and N = 1000 -----
        t0 = time.perf_counter()
        reverse_report = phase33_full_reverse(torch, FastDiff, all_counters,
                                              cfg, dev, smi_line)
        reverse_report["wall_s"] = time.perf_counter() - t0
        phase(33, f"done in {reverse_report['wall_s']:.1f} s")
        check_no_jax()

        # --- phase 34: the streaming curve (phase 32's checkpoint) and
        # drive_ncl_sr
        t0 = time.perf_counter()
        twins_report = phase34_curve_and_drive(torch, sanity_hp, dev,
                                               smi_line)
        phase(34, f"done in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tones, ignore_errors=True)
    check_no_jax()

    # --- phase 35: the graft entry and the data-parallel dry run ----------
    t0 = time.perf_counter()
    twins_report["graft"] = phase35_graft(torch, dev, smi_line)
    phase(35, f"done in {time.perf_counter() - t0:.1f} s")
    check_no_jax()

    # --- phase 37: DiffWave's residual block kernel ------------------------
    t0 = time.perf_counter()
    wavenet_block_report = phase37_wavenet_block(torch, all_counters, dev,
                                                 smi_line)
    phase(37, f"done in {time.perf_counter() - t0:.1f} s")
    check_no_jax()

    sources = {
        "taug_head": ("fastdiff_tpu_torch/csrc/taug_head.cu",
                      "fastdiff_tpu/ops/lvc_block_pallas.py:292"),
        "lvc_block_ncl": ("fastdiff_tpu_torch/csrc/lvc_block_ncl_tc.cu",
                          "fastdiff_tpu/ops/lvc_block_ncl.py:431"),
        "lvc_block_ncl_final": ("fastdiff_tpu_torch/csrc/lvc_block_ncl_tc.cu",
                                "fastdiff_tpu/ops/lvc_block_ncl.py:422"),
        "lvc_block_ncl_sr": ("fastdiff_tpu_torch/csrc/lvc_block_ncl_tc.cu",
                             "fastdiff_tpu/ops/lvc_block_ncl.py:468"),
        "lvc_block_nwc": ("fastdiff_tpu_torch/csrc/lvc_block_nwc_tc.cu",
                          "fastdiff_tpu/ops/lvc_block_pallas.py:238"),
        "aug_head": ("fastdiff_tpu_torch/csrc/taug_head.cu",
                     "fastdiff_tpu/ops/lvc_block_pallas.py:396"),
        "downpath": ("fastdiff_tpu_torch/csrc/downpath.cu",
                     "fastdiff_tpu/ops/downpath_pallas.py:230"),
        # the same kernel's NCL layout replaces no TPU kernel: JAX's
        # _fastdiff_apply_ncl leaves this down path to XLA
        "downpath_ncl": ("fastdiff_tpu_torch/csrc/downpath.cu", None),
        "lvc_block_ncl_fh": ("fastdiff_tpu_torch/csrc/lvc_block_ncl_fh.cu",
                             "fastdiff_tpu/ops/lvc_block_ncl.py:584"),
        "lvc_block_ncl_fh_final": (
            "fastdiff_tpu_torch/csrc/lvc_block_ncl_fh.cu",
            "fastdiff_tpu/ops/lvc_block_ncl.py:575"),
        "taug_head_variant": ("fastdiff_tpu_torch/csrc/taug_head.cu",
                              "scripts/exp_r4b.py:140"),
        "conv_stage": ("fastdiff_tpu_torch/csrc/stage_micro.cu",
                       "scripts/bench_mosaic_micro.py:68"),
        "lvc_stage": ("fastdiff_tpu_torch/csrc/stage_micro.cu",
                      "scripts/bench_mosaic_micro.py:104"),
    }
    print("  kernel ms (and bound_ms, library_ms) below are per denoiser "
          "forward at 864 frames: taug_head 3 calls, lvc_block_ncl hops 8 + "
          "64, lvc_block_ncl_final hop 256, aug_head 2 calls, "
          "lvc_block_nwc hops 64 + 256, downpath 1 call (two launches), "
          "downpath_ncl 1 call (two launches, the NCL layout), "
          "lvc_block_ncl_fh "
          "hops 8 + 64, lvc_block_ncl_fh_final hop 256; lvc_block_ncl_sr per "
          "train-step forward at the recipe (hops 8 + 64 + 256, b 20 x 100 "
          "frames); "
          "taug_head_variant per call at 864 rows (m_outer, m_tile 216); "
          f"conv_stage (tile_s {bench_mosaic_micro.CONV_TILE_S}) and "
          "lvc_stage (tf 1) per call at 221,184 "
          "samples; library_ms of K9/K10 raced with the kernel. "
          "Launches from the run of each kernel's path: phase 7 (taug_head, "
          "lvc_block_ncl*, downpath_ncl), 11 (lvc_block_ncl_sr), 15 "
          "(lvc_block_nwc, "
          "aug_head, downpath), 17 (lvc_block_ncl_fh*), 18 "
          "(taug_head_variant), 19 (conv_stage, lvc_stage); "
          "fs2_infer_launches_per_utterance from phase 24's infer_to_wav of "
          "the trained FastSpeech 2; train_launches_per_step (aug_head, "
          "lvc_block_nwc) from one nwc_vjp step of phase 10 and "
          "train_*_ms_per_step from phase 28 (the recipe's shapes); "
          "full_reverse_launches_per_sample (taug_head, lvc_block_ncl*) "
          "from one replayed sample of phase 33 at N = 200 and N = 1000",
          flush=True)
    fs2_launches = fs2_report["launches_per_utterance"]
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name],
                    fs2_infer_launches_per_utterance=fs2_launches[name],
                    **report[name])
               for name, (src, rep) in sources.items()]
    nwc_launches = train_report["nwc_vjp_launches_per_step"]
    for k in kernels:
        if k["name"] in ("taug_head", "lvc_block_ncl",
                         "lvc_block_ncl_final"):
            k["full_reverse_launches_per_sample"] = {
                n: reverse_report[n]["launches"][k["name"]]
                for n in FULL_REVERSE}
        if k["name"] in nwc_launches:
            k["train_launches_per_step"] = nwc_launches[k["name"]]
            k.update(nwc_train[k["name"]])
    # replaces no TPU kernel: the DiffWave zoo path's XLA chain
    kernels.append(dict(
        name="wavenet_block", route="cuda",
        source="fastdiff_tpu_torch/csrc/wavenet_block.cu",
        replaces=None,
        launches=wavenet_block_report.pop("launches_per_sampler_call"),
        **wavenet_block_report))
    fh = fh_sampler["batches"]
    print(json.dumps({"kernels": kernels,
                      "sampler_ms": report["sampler_kernel_ms"],
                      "sampler_eager_ms": report["sampler_kernel_eager_ms"],
                      "sampler_plain_ms": report["sampler_plain_ms"],
                      "sampler_plain_eager_ms":
                          report["sampler_plain_eager_ms"],
                      "nwc_sampler_ms": nwc_sampler["kernel"],
                      "nwc_sampler_eager_ms": nwc_sampler["kernel_eager"],
                      "nwc_sampler_plain_ms": nwc_sampler["plain"],
                      "fh_sampler_ms": {b: row["ncl_fh"]["ms"]
                                        for b, row in fh.items()},
                      "fh_race_ncl_ms": {b: row["ncl"]["ms"]
                                         for b, row in fh.items()},
                      "graph_vs_eager_ms": graph_report,
                      "train_step": train_report, "fit_s": fit_s,
                      "entry": entry_report, "tts": tts_report,
                      "bddm": bddm_report, "fs2_train": fs2_report,
                      "zoo": zoo_report, "native_loader": loader_report,
                      "ddp": ddp_report, "profiling": prof_report,
                      "learning_check": learn_report,
                      "full_reverse": reverse_report,
                      "script_twins": twins_report}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
