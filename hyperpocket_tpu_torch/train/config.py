"""JSON config system with the reference's schema and results-dir naming.

Port of ``hyperpocket_tpu/train/config.py`` (importing it would import
jax: the JAX ``train`` package loads its Trainer).

``parse_config`` matches core/arg_parser.py:5-17 (``-c/--config`` pointing at
a ``.json`` file). The results-directory layout encodes the config exactly as
the reference does (core/setup.py:22-24, utils/util.py:26-61):
``<results_root>/<mode>/<distribution>/<dataset>/<classes>/<model_name>``.
"""

from __future__ import annotations

import argparse
import json
from os.path import join


def parse_config(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", default=None, type=str, help="config file path")
    args = parser.parse_args(argv)
    config = None
    if args.config is not None and args.config.endswith(".json"):
        with open(args.config) as fh:
            config = json.load(fh)
    if config is None:
        raise ValueError("a .json config must be provided via -c/--config")
    return config


def get_classes_dir(dataset_config: dict) -> str:
    classes = dataset_config.get("classes")
    return "all" if not classes else "_".join(classes)


def get_distribution_dir(full_model_config: dict) -> str:
    norm = full_model_config["target_network_input"]["normalization"]
    suffix = ""
    if norm.get("enable") and norm.get("type") == "progressive":
        suffix = "_normed_progressive_to_epoch_%d" % norm["epoch"]
    return "uniform" + suffix


def get_model_name(config: dict) -> str:
    name = ""
    encoders = 0
    real = config["full_model"]["real_encoder"]["output_size"]
    random = config["full_model"]["random_encoder"]["output_size"]
    if real > 0:
        encoders += 1
        name += str(real)
    if random > 0:
        encoders += 1
        name += ("x" + str(random)) if real > 0 else str(random)
    name = f"{encoders}e{name}"
    sched = config["training"]["lr_scheduler"]
    name += sched["type"]
    for k, v in sched["hyperparams"].items():
        name += "_" + k + str(v).replace(" ", "")
    return name


def get_results_dir_path(config: dict, mode: str) -> str:
    return join(
        config["results_root"],
        mode,
        get_distribution_dir(config["full_model"]),
        config["dataset"]["name"],
        get_classes_dir(config["dataset"]),
        get_model_name(config),
    )
