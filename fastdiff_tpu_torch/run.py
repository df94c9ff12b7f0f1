"""CLI entry point: train, validate or infer a task from a YAML config
(``fastdiff_tpu/run.py``).

    python -m fastdiff_tpu_torch.run --config fastdiff_tpu/configs/ljspeech.yaml \
        --exp_name my_exp --reset
    python -m fastdiff_tpu_torch.run --config fastdiff_tpu/configs/ljspeech.yaml \
        --exp_name my_exp --infer --hparams 'test_input_dir=wavs,N=4'

``--infer`` runs ``Trainer.test`` (``test_input_dir`` for wav -> wav,
``test_mel_dir`` for ``.npy`` mels, else the binarized test split),
``--validate`` one validation pass over the restored checkpoint, and no flag
``Trainer.fit``. The task class comes from ``hparams['task_cls']``
(``data/dataset.py:resolve_class`` maps the configs' ``fastdiff_tpu.`` paths
to the port). ``--device`` (default ``cuda``) names the device; without a
card ``cuda`` raises, so a CPU run asks for ``--device cpu``.

Data-parallel training runs one process per card under ``torchrun``
(``parallel/mesh.py:maybe_initialize_distributed`` starts the process
group from its environment, as JAX's entry point starts its distributed
runtime):

    torchrun --nproc_per_node 4 -m fastdiff_tpu_torch.run --config ... \
        --exp_name my_exp
"""

from __future__ import annotations

import argparse

import numpy as np

from fastdiff_tpu_torch.data.dataset import resolve_class
from fastdiff_tpu_torch.models.fastdiff import checked_device
from fastdiff_tpu_torch.parallel.mesh import maybe_initialize_distributed
from fastdiff_tpu_torch.training.trainer import Trainer
from fastdiff_tpu_torch.utils.hparams import add_config_args, set_hparams


def run_task(hparams: dict, device="cuda"):
    task_cls = resolve_class(hparams["task_cls"])
    task = task_cls(hparams, device=device)
    np.random.seed(int(hparams.get("seed", 1234)))
    trainer = Trainer(task, hparams.get("work_dir") or
                      f"checkpoints/{hparams.get('exp_name') or 'default'}")
    if hparams.get("infer"):
        return trainer.test()
    if hparams.get("validate"):
        state, _ = trainer.restore(task.build_state())
        val = trainer.evaluate(state, task.train_cfg.eval_max_batches)
        print(f"| validation: {val}")
        return val
    return trainer.fit()


def main(argv=None):
    parser = argparse.ArgumentParser(description="fastdiff_tpu_torch")
    add_config_args(parser)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = checked_device(args.device)
    hparams = set_hparams(args=args)
    maybe_initialize_distributed(hparams, device)
    print(f"| device: {device}")
    return run_task(hparams, device)


if __name__ == "__main__":
    main()
