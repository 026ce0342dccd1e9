"""CLI entry: ``python -m hyperpocket_tpu_torch.cli --config settings/<x>.json``.

Port of ``hyperpocket_tpu/cli.py``, the reference's mode switch
(core/main.py:24-190). ``training`` runs ``train/trainer.py::Trainer``:
it trains, validates and saves checkpoints under
``<results_root>/training/...`` in the JAX package's layout, and resumes
from the newest complete one. ``experiments`` restores the checkpoint the
config's results tree holds and runs each experiment whose config has
``execute: true``; its results go to ``<results_root>/experiments/...``.
``--device`` defaults to ``cuda`` and raises when CUDA is absent. The
Telegram logger (``telegram_logger.enable: true``) is not ported and raises.
"""

from __future__ import annotations

import argparse
import logging
import sys
from os import makedirs

import torch

from hyperpocket_tpu_torch.train.config import get_results_dir_path, parse_config


def main(config: dict, device: str | torch.device = "cuda"):
    """Run the config's mode on ``device``; training returns the Trainer,
    experiments mode its context."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    run_mode = config["mode"]
    if run_mode == "training":
        from hyperpocket_tpu_torch.train.trainer import Trainer

        if config.get("telegram_logger", {}).get("enable"):
            raise NotImplementedError("the Telegram logger is not ported (ROADMAP.md, "
                                      "'utils/telegram.py')")
        trainer = Trainer(config, device=device)
        trainer.log.info("Current mode training on %s", device)
        trainer.run()
        return trainer
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
