"""FullModel: mode resolution, latent fusion, hypernetwork -> batched decode.

Port of ``hyperpocket_tpu/models/full_model.py``. The mode follows the
encoders' output sizes: both > 0 is HyperPocket (VAE random encoder on the
missing half, deterministic real encoder on the existing half), only random
is HyperCloud (VAE on existing), only real is HyperRec.

The module holds fp32 master parameters. With ``compute_dtype="bfloat16"``
``apply`` casts parameters and inputs to bf16 at use, so gradients reach the
fp32 masters through the casts, and returns fp32, as the JAX package does;
``serving_params`` makes the cast once for serving. ``apply(training=True)``
is the training forward, with autograd alive: the encoders run their
differentiable trunk (``fast=False``) and it returns ``(reconstruction, mu,
sigma)``. ``apply(training=False)`` is the inference forward, under
``torch.no_grad``, with the encoders' fused trunk kernel and, in fp32 and
bf16, the fused decode K10 (the op ``hyperpocket::decode_batch``) in place
of the training forward's ``bmm`` chain: the JAX package keeps the chain in
both modes, because its Pallas decode lost on the TPU; on the H100 the
kernel is the faster of the two (PERF.md). fp64 and fp16 keep the chain.
"""

from __future__ import annotations

import copy
from typing import Any

import torch
from torch import nn

from hyperpocket_tpu_torch.models.encoder import Encoder
from hyperpocket_tpu_torch.models.hyper_network import HyperNetwork
from hyperpocket_tpu_torch.models.target_network import batched_target_network_forward
from hyperpocket_tpu_torch.ops import decoder
from hyperpocket_tpu_torch.ops.sampling import generate_target_network_input_batch

MODE_HYPER_POCKET = "hyper_pocket"
MODE_HYPER_REC = "hyper_rec"
MODE_HYPER_CLOUD = "hyper_cloud"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


class FullModel(nn.Module):
    def __init__(self, *, random_encoder_output_size: int, real_encoder_output_size: int,
                 encoder_use_bias: bool, hyper_use_bias: bool,
                 target_layer_out_channels: tuple[int, ...], target_use_bias: bool,
                 freeze_heads: bool, target_network_input: dict,
                 ball_method: str = "exact", compute_dtype: str = "float32",
                 generator: torch.Generator | None = None):
        super().__init__()
        if random_encoder_output_size <= 0 and real_encoder_output_size <= 0:
            raise ValueError("at least one encoder should have non zero output")
        self.random_encoder_output_size = random_encoder_output_size
        self.real_encoder_output_size = real_encoder_output_size
        self.target_layer_out_channels = tuple(target_layer_out_channels)
        self.target_use_bias = target_use_bias
        self.freeze_heads = freeze_heads
        self.target_network_input = dict(target_network_input)
        self.ball_method = ball_method
        self.compute_dtype = compute_dtype
        generator = generator if generator is not None else torch.Generator()
        if random_encoder_output_size > 0:
            self.random_encoder = Encoder(random_encoder_output_size, encoder_use_bias,
                                          generator)
        if real_encoder_output_size > 0:
            self.real_encoder = Encoder(real_encoder_output_size, encoder_use_bias, generator)
        self.hyper_network = HyperNetwork(
            self.latent_size, list(self.target_layer_out_channels), use_bias=hyper_use_bias,
            target_network_use_bias=target_use_bias, freeze_heads=freeze_heads,
            generator=generator)

    @classmethod
    def from_config(cls, config: dict[str, Any],
                    generator: torch.Generator | None = None) -> "FullModel":
        """Build from a config's ``full_model`` section; init draws from ``generator``."""
        return cls(
            random_encoder_output_size=int(config["random_encoder"]["output_size"]),
            real_encoder_output_size=int(config["real_encoder"]["output_size"]),
            encoder_use_bias=bool(config["random_encoder"].get("use_bias", True)),
            hyper_use_bias=bool(config["hyper_network"].get("use_bias", True)),
            target_layer_out_channels=tuple(config["target_network"]["layer_out_channels"]),
            target_use_bias=bool(config["target_network"]["use_bias"]),
            freeze_heads=bool(config["target_network"].get("freeze_layers_learning", False)),
            target_network_input=dict(config["target_network_input"]),
            ball_method=str(config.get("ball_method", "exact")),
            compute_dtype=str(config.get("compute_dtype", "float32")),
            generator=generator,
        )

    @property
    def mode(self) -> str:
        if self.random_encoder_output_size > 0 and self.real_encoder_output_size > 0:
            return MODE_HYPER_POCKET
        if self.random_encoder_output_size > 0:
            return MODE_HYPER_CLOUD
        return MODE_HYPER_REC

    @property
    def has_generativity(self) -> bool:
        """Only HyperPocket trains with the KLD term."""
        return self.mode == MODE_HYPER_POCKET

    def get_noise_size(self) -> int:
        return self.random_encoder_output_size

    @property
    def latent_size(self) -> int:
        return self.random_encoder_output_size + self.real_encoder_output_size

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def serving_params(self) -> "FullModel":
        """This model with its parameters cast once to ``compute_dtype``.

        ``apply`` casts fp32 master parameters at every call, which re-reads
        the 156 MB fp32 head each time; serving makes the same single
        rounding once. Returns ``self`` for fp32.
        """
        cd = self.compute_torch_dtype
        return self if cd == torch.float32 else copy.deepcopy(self).to(cd)

    def fused_decode(self, training: bool) -> bool:
        """Whether the forward decodes through K10: inference in fp32 or bf16.
        Decided from these two alone, before any launch: on a card, widths
        the kernel cannot take and a failing kernel raise."""
        return not training and self.compute_torch_dtype in (torch.float32, torch.bfloat16)

    def _get_latent(self, existing, missing, generator, training, noise, eps):
        """Mode-specific ``(latent, mu, sigma)``; mu and sigma only when training a VAE.

        Training runs the encoders' differentiable trunk; inference runs the
        fused trunk kernel (``fast=True``) and takes the VAE's mu as its
        latent when no ``noise`` is given.
        """
        mode = self.mode
        fast = not training
        if mode == MODE_HYPER_POCKET:
            if training:
                z, mu, sigma = self.random_encoder(missing, is_vae=True, generator=generator,
                                                   eps=eps)
                real_mu = self.real_encoder(existing, is_vae=False)
                return torch.cat([z, real_mu], dim=1), mu, sigma
            if noise is None:
                _, noise, _ = self.random_encoder(missing, is_vae=True, generator=generator,
                                                  fast=True, eps=eps)
            real_mu = self.real_encoder(existing, is_vae=False, fast=True)
            return torch.cat([noise, real_mu], dim=1), None, None
        if mode == MODE_HYPER_REC:
            return self.real_encoder(existing, is_vae=False, fast=fast), None, None
        # HyperCloud: the VAE encoder runs on the existing half
        if training:
            return self.random_encoder(existing, is_vae=True, generator=generator, eps=eps)
        if noise is None:
            _, noise, _ = self.random_encoder(existing, is_vae=True, generator=generator,
                                              fast=True, eps=eps)
        return noise, None, None

    def apply(self, existing: torch.Tensor, missing: torch.Tensor | None,
              generator: torch.Generator | None, epoch, *, num_output_points: int = 2048,
              training: bool = True, noise: torch.Tensor | None = None,
              vae_eps: torch.Tensor | None = None,
              ball_points: torch.Tensor | None = None,
              head_delta: torch.Tensor | None = None, return_trunk: bool = False):
        """The forward pass.

        existing/missing: (B, N, 3) clouds. Training returns
        ``(reconstruction (B, num_output_points, 3), mu, sigma)`` with sigma =
        exp(std head), or mu and sigma None for HyperRec; inference returns
        the reconstruction only. ``vae_eps`` (B, Z_rand) and ``ball_points``
        (B, num_output_points, 3) replace the two random draws with given
        values. Sub-fp32 compute returns fp32; fp32 and fp64 return their own
        dtype.

        ``head_delta`` and ``return_trunk`` are the fused head-Adam taps
        (``HyperNetwork.forward``): with either set the head weight gets no
        autograd gradient (unless the heads are frozen anyway), and with
        ``return_trunk`` the hypernetwork's trunk activations are returned
        last: ``(reconstruction, mu, sigma, h)`` or ``(reconstruction, h)``.
        Production forwards set neither.
        """
        args = (existing, missing, generator, epoch, num_output_points, training, noise,
                vae_eps, ball_points, head_delta, return_trunk)
        if not training:
            with torch.no_grad():
                return self._forward(*args)
        return self._forward(*args)

    def _forward(self, existing, missing, generator, epoch, num_output_points, training,
                 noise, vae_eps, ball_points, head_delta, return_trunk):
        cd = self.compute_torch_dtype

        def cast(a):
            return a if a is None else a.to(cd)

        existing, missing, noise = cast(existing), cast(missing), cast(noise)
        latent, mu, sigma = self._get_latent(existing, missing, generator, training, noise,
                                             vae_eps)
        fused_tap = head_delta is not None or return_trunk
        hn_out = self.hyper_network(latent, stop_head_weight_grad=fused_tap,
                                    head_delta=head_delta, return_trunk=return_trunk)
        flat_weights, trunk_h = hn_out if return_trunk else (hn_out, None)
        if ball_points is None:
            ball_points = generate_target_network_input_batch(
                self.target_network_input, generator, epoch, existing.shape[0],
                num_output_points, method=self.ball_method)
        decode_args = (flat_weights, ball_points.to(device=flat_weights.device, dtype=cd),
                       list(self.target_layer_out_channels), self.target_use_bias)
        if self.fused_decode(training):
            # the chain's rounding, so that K10 decodes as the JAX model does
            reconstruction = decoder.decode_batch(*decode_args, round_product=True)
        else:
            reconstruction = batched_target_network_forward(*decode_args)
        out_dtype = cd if torch.finfo(cd).bits >= 32 else torch.float32
        reconstruction = reconstruction.to(out_dtype)
        trunk = (trunk_h,) if return_trunk else ()
        if not training:
            return (reconstruction, *trunk) if return_trunk else reconstruction
        return (reconstruction, None if mu is None else mu.to(out_dtype),
                None if sigma is None else sigma.to(out_dtype), *trunk)
