"""K4, K5, K6, K8, K9 (``lvc_stage``, ``conv_stage``), K10, the head GEMM and
Kernel B of two source trees raced on one card.

    python -m fastdiff_tpu_torch.scripts.race_trees OTHER_TREE [--reps 20]

``OTHER_TREE`` is another checkout of the repository (for a parent commit:
``git archive <commit> | tar -x -C build/parent``; ``build/`` is
gitignored). The same probe runs in a process of its own from each tree in
turns (other, this, this, other); each builds that tree's kernels and
calls that tree's wrappers, whose signatures are the same in both:

- ``bench_mosaic_micro.lvc_stage`` at hop 256, 221,184 samples, for each
  ``--tfs`` value, beside ``torch.bmm`` over frames, and
  ``bench_mosaic_micro.conv_stage`` on the same tap at each of this
  tree's ``CONV_TILES``, beside chained ``torch.matmul``;
- ``lvc_head.taug_head_variant`` at 864 x 192 @ 192 x 26,624 for every
  (order, M tile) of ``exp_r4b.VARIANTS``, beside Kernel A
  (``taug_head_matmul``, K3), K7 (``aug_head_matmul`` at 24,832 columns)
  and ``torch.addmm``;
- the block kernels at 864 frames, b 1: K5 (``lvc_block_ncl.
  lvc_block_ncl_fh``) at hops 8 and 64 and with the final conv at hop 256,
  K6 (``lvc_block_pallas.lvc_block_nwc``) at hops 64 and 256, and K1
  (``lvc_block_ncl.lvc_block_ncl``) at hop 64, each by the kernel its
  tree's wrapper launches for that hop;
- K4 (``lvc_block_ncl.lvc_block_ncl_sr``) at the training recipe, b 20 x
  100 frames of hops 8, 64 and 256, and K8 (``downpath_pallas.
  downpath_fused``, both of its launches) at 221,184 samples, b 1.

Every call is timed by CUDA-graph replay (``utils/timing.graph_ms``:
device time alone) on inputs made from one seed, and checked against its
plain version (max abs error). Prints one JSON object: ms per call of each
tree (the mean of its two runs, and the runs), with the card's name and
power limit. Needs the card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[2]

# Runs in a fresh process from the root of one tree: only names that both
# trees' packages have.
PROBE = r"""
import json, sys
import torch
from fastdiff_tpu_torch.ops import lvc_block_pallas, lvc_head
from fastdiff_tpu_torch.scripts import bench_mosaic_micro as micro
from fastdiff_tpu_torch.utils.timing import graph_ms

reps, tfs = int(sys.argv[1]), [int(t) for t in sys.argv[2].split(",")]
variants = [(o, int(t)) for o, t in
            (v.split(":") for v in sys.argv[3].split(","))]
tiles = [int(t) for t in sys.argv[4].split(",")]
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)

def randn(*shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).bfloat16()

def err(out, ref):
    return float((out.float() - ref.float()).abs().max())

ms, errs = {}, {}
with torch.inference_mode():
    tap = randn(1, 221184, 97, scale=0.1)
    kern = randn(1, 864, 97, 64, scale=0.1)
    ref = micro.lvc_stage_plain(tap, kern, 256)
    for tf in tfs:
        stage = lambda: micro.lvc_stage(tap, kern, 256, tf)
        errs[f"lvc_stage tf {tf}"] = err(stage(), ref)
        ms[f"lvc_stage tf {tf}"] = graph_ms(stage, reps)
    ms["torch.bmm"] = graph_ms(lambda: torch.bmm(
        tap.view(864, 256, 97), kern.view(864, 97, 64)), reps)
    w = randn(4, 97, 32, scale=0.1)
    ref = micro.conv_stage_plain(tap, w)
    for tile in tiles:
        stage = lambda: micro.conv_stage(tap, w, tile)
        errs[f"conv_stage tile_s {tile}"] = err(stage(), ref)
        ms[f"conv_stage tile_s {tile}"] = graph_ms(stage, reps)
    ms["chained torch.matmul"] = graph_ms(
        lambda: micro._conv_library(tap, w), reps)
    del tap, kern, w, ref
    tap = randn(864, 192)
    for n, name in ((26624, "K3 taug_head"), (24832, "K7 aug_head")):
        w = randn(192, n, scale=0.05)
        b = torch.randn((n,), generator=gen, device=dev) * 0.1
        ref = lvc_head.taug_head_matmul_plain(tap, w, b)
        fn = (lvc_head.taug_head_matmul if n == 26624
              else lvc_block_pallas.aug_head_matmul)
        errs[name] = err(fn(tap, w, b), ref)
        ms[name] = graph_ms(lambda: fn(tap, w, b), reps)
    w = randn(192, 26624, scale=0.05)
    b = torch.randn((26624,), generator=gen, device=dev) * 0.1
    ref = lvc_head.taug_head_matmul_plain(tap, w, b)
    for order, m_tile in variants:
        key = f"K10 {order} m{m_tile}"
        run = lambda: lvc_head.taug_head_variant(tap, w, b, order=order,
                                                 m_tile=m_tile)
        errs[key] = err(run(), ref)
        ms[key] = graph_ms(run, reps)
    b_bf16 = b.bfloat16()
    ms["torch.addmm"] = graph_ms(lambda: torch.addmm(b_bf16, tap, w), reps)
    del tap, w, b, ref

    # the block kernels, 864 frames, b 1; errors against the plain versions
    from fastdiff_tpu_torch.ops import lvc_block_ncl as ncl
    wstack_t = randn(4, 32, 97, scale=0.1)
    final_wb = randn(8, 32, scale=0.1)
    w_head = randn(192, 26624, scale=0.004)
    b_head = torch.randn((26624,), generator=gen, device=dev) * 0.01
    for hop, final in ((8, False), (64, False), (256, True)):
        x, skip = randn(1, 32, 864 * hop), randn(1, 32, 864 * hop)
        tap_c = randn(1, 864, 192)
        fwb = final_wb if final else None
        args = (x, skip, tap_c, w_head, b_head, wstack_t, hop, fwb)
        key = f"K5 hop {hop}" + (" final" if final else "")
        out = ncl.lvc_block_ncl_fh(*args)
        ref = ncl.lvc_block_ncl_fh_plain(*args)
        errs[key] = err(out[0] if final else out, ref[0] if final else ref)
        ms[key] = graph_ms(lambda: ncl.lvc_block_ncl_fh(*args), reps)
        if hop == 64:
            kern = randn(1, 864, 4, 64, 104, scale=0.05)
            errs["K1 hop 64"] = err(
                ncl.lvc_block_ncl(x, skip, kern, wstack_t, hop),
                ncl.lvc_block_ncl_plain(x, skip, kern, wstack_t, hop))
            ms["K1 hop 64"] = graph_ms(
                lambda: ncl.lvc_block_ncl(x, skip, kern, wstack_t, hop), reps)
            del kern
        del x, skip, tap_c, args, out, ref
    wstack = randn(4, 97, 32, scale=0.1)
    for hop in (64, 256):
        x, skip = randn(1, 864 * hop, 32), randn(1, 864 * hop, 32)
        kern_aug = randn(1, 864, 4, 97, 64, scale=0.05)
        args = (x, skip, kern_aug, wstack, hop)
        errs[f"K6 hop {hop}"] = err(lvc_block_pallas.lvc_block_nwc(*args),
                                    lvc_block_pallas.lvc_block_nwc_plain(*args))
        ms[f"K6 hop {hop}"] = graph_ms(
            lambda: lvc_block_pallas.lvc_block_nwc(*args), reps)
        del x, skip, kern_aug, args

    # K4 at the training recipe (b 20 x 100 frames), the worst of out, s,
    # y, z; at most 5 calls per graph (each call allocates 0.56 GB at hop
    # 256)
    for hop in (8, 64, 256):
        x, skip = randn(20, 32, 100 * hop), randn(20, 32, 100 * hop)
        kern = randn(20, 100, 4, 64, 104, scale=0.05)
        args = (x, skip, kern, wstack_t, hop)
        errs[f"K4 hop {hop}"] = max(
            err(g, r) for g, r in zip(ncl.lvc_block_ncl_sr(*args),
                                      ncl.lvc_block_ncl_sr_plain(*args)))
        ms[f"K4 hop {hop}"] = graph_ms(lambda: ncl.lvc_block_ncl_sr(*args),
                                       min(reps, 5))
        del x, skip, kern, args

    # K8 at 10 s, b 1, on packed weights of the model's shapes
    from fastdiff_tpu_torch.ops import downpath_pallas as down
    audio = torch.randn((1, 221184, 1), generator=gen, device=dev)
    packs = (randn(8, 32, scale=0.3), randn(3, 33, 32, scale=0.15),
             randn(3, 3, 97, 32, scale=0.1))
    errs["K8"] = max(err(g, r) for g, r in zip(
        down.downpath_fused(audio, *packs, (4, 8, 8)),
        down.downpath_plain(audio, *packs, (4, 8, 8))))
    ms["K8"] = graph_ms(lambda: down.downpath_fused(audio, *packs, (4, 8, 8)),
                        reps)
print("RESULT " + json.dumps({"ms": ms, "max_abs_err": errs}))
"""


def probe(tree: pathlib.Path, source: str, args: list,
          timeout: float = 600) -> dict:
    """The result of the probe ``source`` (its ``RESULT`` line) from a
    fresh process at the root of ``tree``, called with ``args``."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", source, *args], cwd=tree,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"probe failed in {tree} ({proc.returncode}):\n"
                       f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")


def turns(other: pathlib.Path, source: str, args: list,
          timeout: float = 600) -> dict:
    """The probe run from ``other`` and from this tree in turns (other,
    this, this, other): per tree the mean of its two runs of each ``ms``
    entry, the runs, and the first run's other entries; with the card's
    name and power limit."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    trees = {"other": other.resolve(), "this": HERE}
    runs = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        runs[name].append(probe(trees[name], source, args, timeout))
    report = {"card": smi.stdout.strip(), "trees": {
        k: str(v) for k, v in trees.items()}}
    for name, results in runs.items():
        keys = results[0]["ms"]
        report[name] = dict(
            {k: v for k, v in results[0].items() if k != "ms"},
            ms={k: sum(r["ms"][k] for r in results) / len(results)
                for k in keys},
            runs={k: [r["ms"][k] for r in results] for k in keys})
    return report


def run(other: pathlib.Path, reps: int = 20, tfs=(1, 8)) -> dict:
    from fastdiff_tpu_torch.scripts.bench_mosaic_micro import CONV_TILES
    from fastdiff_tpu_torch.scripts.exp_r4b import VARIANTS
    variants = [(order, m_tile) for _, order, m_tile in VARIANTS]
    return turns(other, PROBE, [
        str(reps), ",".join(map(str, tfs)),
        ",".join(f"{o}:{t}" for o, t in variants),
        ",".join(map(str, CONV_TILES))])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=pathlib.Path)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--tfs", type=int, nargs="*", default=[1, 8])
    args = parser.parse_args()
    print(json.dumps(run(args.other, args.reps, tuple(args.tfs)), indent=1))


if __name__ == "__main__":
    main()
