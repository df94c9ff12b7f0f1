"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers compared, each with its limit, are the last
lines of standard error.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every compile cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "portbench",
                                              "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "portbench",
                                                  "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
