"""Run setup: seeding and file+console logging.

Port of ``hyperpocket_tpu/utils/logging_setup.py``: ``seed_setup`` seeds
Python's ``random``, numpy's global legacy RNG and torch's default
generator; ``logging_setup`` writes a DEBUG ``log.txt`` in the results
directory and logs INFO to the console (reference core/setup.py:12-54).
The port's own draws take explicit ``torch.Generator``s; the global seeds
serve the dataset code that reads numpy's global RNG, as in the JAX package.
"""

from __future__ import annotations

import logging
import random
from os import makedirs
from os.path import exists, join

import numpy as np
import torch


def seed_setup(seed: int = 0) -> int:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def logging_setup(log_dir: str) -> None:
    makedirs(log_dir, exist_ok=True)
    logpath = join(log_dir, "log.txt")
    logging.basicConfig(
        level=logging.DEBUG,
        format="%(asctime)s %(message)s",
        datefmt="%m-%d %H:%M:%S",
        filename=logpath,
        filemode="a" if exists(logpath) else "w",
        force=True,
    )
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(logging.Formatter("%(asctime)s: %(levelname)-8s %(message)s"))
    logging.getLogger("").addHandler(console)
    # DEBUG is for the package's own loggers; libraries stay at INFO
    for noisy in ("torch", "urllib3"):
        logging.getLogger(noisy).setLevel(logging.INFO)
