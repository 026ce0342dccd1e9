"""hyperpocket_tpu_torch: the PyTorch/CUDA port of hyperpocket_tpu.

Plain tensor code is PyTorch; the JAX package's Pallas TPU kernels become
CUDA kernels for Hopper under ``csrc/``, built at first use
(``ops/_build.py``). The JAX package stays the reference the port is
tested against. Ported so far: the completion-serving path
(``serving.py``), with the encoder trunk kernel ``ops/trunk_pool.py``; the
train and val steps (``train/trainer.py``), with the nearest-neighbour
kernels of the Chamfer loss in ``ops/nn.py``; the CLI (``cli.py``) in
experiments mode, with the EMD kernels in ``ops/emd.py``, and in training
mode (the ``Trainer``, JAX-layout checkpoints), with the fused training
trunk (``ops/trunk_pool.py``) and the fused head-Adam update
(``ops/head_adam.py``).
"""

__version__ = "0.1.0"
