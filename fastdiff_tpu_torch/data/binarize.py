"""Binarization CLI (stage 2), the twin of ``fastdiff_tpu/data/binarize.py``:

    python -m fastdiff_tpu_torch.data.binarize --config fastdiff_tpu/configs/ljspeech.yaml [--device cpu]

``binarizer_cls`` names the class (a ``fastdiff_tpu.`` path resolves to the
port's class of the same name, ``data/dataset.py:resolve_class``). Numpy on
the host; only the TTS binarizers' ``with_spk_embed`` uses a device (the
speaker encoder on ``--device``, the CUDA card by default).
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
        "binarizer_cls", "fastdiff_tpu.data.binarizer.VocoderBinarizer"))
    print(f"| binarizer: {cls.__name__}")
    cls(hparams, device=args.device).process()


if __name__ == "__main__":
    main()
