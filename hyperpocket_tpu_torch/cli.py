"""CLI entry: ``python -m hyperpocket_tpu_torch.cli --config settings/<x>.json``.

Port of ``hyperpocket_tpu/cli.py``, the reference's mode switch
(core/main.py:24-190). ``experiments`` restores the checkpoint the config's
results tree holds (JAX layout, ``train/checkpoint.py``) and runs each
experiment whose config has ``execute: true``; its results go to
``<results_root>/experiments/...``. ``training`` is not ported yet.
``--device`` defaults to ``cuda`` and raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import logging
import sys
from os import makedirs

import torch

from hyperpocket_tpu_torch.train.config import get_results_dir_path, parse_config


def main(config: dict, device: str | torch.device = "cuda"):
    """Run the config's mode on ``device``; experiments mode returns its context."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    run_mode = config["mode"]
    if run_mode == "training":
        raise NotImplementedError(
            "mode 'training' needs the Trainer, checkpoint saving and the epoch loops, "
            "not ported yet (ROADMAP.md, slice 4: 'Trainer, checkpoint saving and the "
            "CLI's training mode')")
    if run_mode == "experiments":
        from hyperpocket_tpu_torch.eval.experiments import run_experiments
        from hyperpocket_tpu_torch.utils.logging_setup import logging_setup

        result_dir = get_results_dir_path(config, "experiments")
        makedirs(result_dir, exist_ok=True)
        logging_setup(result_dir)
        logging.getLogger("hyperpocket_tpu_torch").info("Current mode experiments on %s",
                                                        device)
        return run_experiments(config, result_dir, device=device)
    raise ValueError("mode should be `training` or `experiments`")


def _entry(argv=None) -> None:
    """console entry point: ``-c/--config <json>`` and ``--device``."""
    ap = argparse.ArgumentParser(prog="python -m hyperpocket_tpu_torch.cli")
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    main(parse_config(rest), device=args.device)


if __name__ == "__main__":
    _entry(sys.argv[1:])
