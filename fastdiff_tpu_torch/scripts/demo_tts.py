"""TTS demo: precomputed acoustic-model mels -> FastDiff -> wav files
(``scripts/demo_tts.py``).

Point it at a directory of ``.npy`` mels (T, n_mels) produced by any
acoustic model and a FastDiff checkpoint:

    python -m fastdiff_tpu_torch.scripts.demo_tts \
        --config fastdiff_tpu/configs/fs2_ljspeech.yaml \
        --mel_dir infer_out --out_dir demo_out \
        --hparams 'vocoder_ckpt=checkpoints/.../model_ckpt_steps_X.ckpt,N=4'

Each mel is vocoded by ``tts/infer.py:TTSPipeline`` and written as
``<name>.wav``. ``--device`` defaults to ``cuda`` and raises without a
card.
"""

import argparse
import os

from fastdiff_tpu_torch.tts.infer import NpyMelSource, TTSPipeline
from fastdiff_tpu_torch.utils.hparams import set_hparams


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--mel_dir", required=True)
    parser.add_argument("--out_dir", default="demo_out")
    parser.add_argument("--hparams", default="")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    hparams = set_hparams(config=args.config, hparams_str=args.hparams,
                          print_hparams=False, global_hparams=False)
    source = NpyMelSource(hparams, args.mel_dir)
    pipeline = TTSPipeline(hparams, source, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in source.mel_paths:
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.out_dir, f"{name}.wav")
        pipeline.synthesize("", out_wav=out)
        print(f"| wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
