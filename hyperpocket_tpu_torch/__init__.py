"""hyperpocket_tpu_torch: the PyTorch/CUDA port of hyperpocket_tpu.

Plain tensor code is PyTorch; the JAX package's Pallas TPU kernels become
CUDA kernels for Hopper under ``csrc/``, built at first use
(``ops/_build.py``). The JAX package stays the reference the port is
tested against. Ported so far: the completion-serving path
(``serving.py``), with the encoder trunk kernel ``ops/trunk_pool.py``, and
the train and val steps (``train/trainer.py``), with the nearest-neighbour
kernels of the Chamfer loss in ``ops/nn.py``.
"""

__version__ = "0.1.0"
