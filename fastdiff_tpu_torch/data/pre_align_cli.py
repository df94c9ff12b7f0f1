"""Pre-align CLI (stage 1), the twin of ``fastdiff_tpu/data/pre_align_cli.py``:

    python -m fastdiff_tpu_torch.data.pre_align_cli --config C [--hparams ...] [--device cpu]

``pre_align_cls`` names the class (a ``fastdiff_tpu.`` path resolves to the
port's class of the same name, ``data/dataset.py:resolve_class``). Only
``pre_align_args.denoise`` uses a device (``--device``, the CUDA card by
default); the rest is numpy and ``sox`` on the host.
"""

import argparse

from fastdiff_tpu_torch.data.dataset import resolve_class
from fastdiff_tpu_torch.utils.hparams import set_hparams


def main():
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", type=str, default="cuda")
    args, _ = parser.parse_known_args()
    hparams = set_hparams(print_hparams=False)
    cls = resolve_class(hparams.get(
        "pre_align_cls", "fastdiff_tpu.data.pre_align.VocoderPreAlign"))
    print(f"| pre-aligner: {cls.__name__}")
    cls(hparams, device=args.device).process()


if __name__ == "__main__":
    main()
