"""The readings that the limits of ``correct`` are set from, on the card:

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--out <file.jsonl>]

For each seed, in one process (the program set up once, then given each
seed's weights and mels): a window of ``--seconds`` at the cell's load,
then, over the utterances a run compares, the program's gap to the plain
reference (the lower reading) and the control's: the reference with every
product's operands rounded to per-tensor scaled float8 e4m3, the next
precision below the configurations' bfloat16, against the same reference
(the upper reading). One JSON line a seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.drivers.vocode import rel_l2  # noqa: E402
from portbench.harness import resolve  # noqa: E402


def readings(driver) -> dict:
    kept = driver.sample()
    want = driver.reference(kept, "float32")
    low = driver.reference(kept, "fp8")
    program = [rel_l2(k.wav.astype(np.float64), r) for k, r in zip(kept, want)]
    control = [rel_l2(c, r) for c, r in zip(low, want)]
    return {"compared": len(kept), "program_wav_rel_l2": max(program),
            "control_wav_rel_l2": min(control),
            "control_wav_rel_l2_max": max(control),
            "longest_frames": max(k.mel.shape[0] for k in kept)}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    _, cell, config, traffic = resolve(ROOT, args.workload)
    from portbench.drivers.vocode import Driver
    driver = Driver(config, traffic, args.seeds[0], torch.device("cuda:0"))
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        if i == 0:
            driver.setup()
        else:
            driver.reseed(seed)
        calls = driver.window(args.seconds, False)
        line = dict(workload=args.workload, seed=seed, calls=len(calls),
                    attempted=driver.attempted, failed=driver.failed,
                    **readings(driver),
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
