"""hyperpocket_tpu_torch: the PyTorch/CUDA port of hyperpocket_tpu.

Plain tensor code is PyTorch; the JAX package's Pallas TPU kernels become
CUDA kernels for Hopper under ``csrc/``, built at first use
(``ops/_build.py``). The JAX package stays the reference the port is
tested against, and the port now does everything it does: completion
serving (``serving.py``, with the encoder trunk kernel
``ops/trunk_pool.py`` and the decode kernel ``ops/decoder.py``), training
(``train/trainer.py``, with the nearest-neighbour kernels of the Chamfer
loss in ``ops/nn.py``, the fused training trunk and the fused head-Adam
update), experiments mode (``eval/``, with the EMD kernels in
``ops/emd.py``), and the parallel layer (``parallel/``): one process per
card in a ``torch.distributed`` group, data- and tensor-parallel training,
the point-sharded ring Chamfer, data-parallel eval and serving.
"""

__version__ = "0.1.0"
