"""Parallel WaveGAN generator and discriminators (PyTorch, (B, C, T) layout).

The generator is the counterpart of
parallelwavegan_tpu/models/parallel_wavegan.py:64-235:
noise and the upsampled mel through ``layers`` gated WaveNet blocks in
``stacks`` dilation cycles, the skip sum scaled by sqrt(1/layers), then
ReLU -> 1x1 -> ReLU -> 1x1. Keys are upstream's: ``first_conv``,
``upsample_net.*``, ``conv_layers.{i}.*``, ``last_conv_layers.{1,3}``.
``upsample_net`` is ``ConvInUpsampleNetwork``, ``UpsampleNetwork`` or
``MelGANGenerator`` (JAX :54-60: ``aux_context_window`` 0, no final tanh,
weight norm as the generator's; keys ``upsample_net.melgan.*``).
``use_causal_conv`` makes every block and the upsample net causal, as in
JAX (with the MelGAN upsample net, the causal MelGAN generator; keys
``upsample_net.melgan.0.conv``, ``.{i}.deconv``, ``.{j}.stack.1.conv``).

Kernel flags keep the JAX names so that configs are shared:

* ``use_pallas_stack`` or ``use_pallas_stack_train``, under the JAX gate
  (:142-148: c given, not causal, no dropout) runs the gated layers of
  every cycle through ``fused_wavenet_stack``, the hand-written CUDA
  kernel (K3) on a GPU: one launch per layer into one skip buffer (JAX
  sums the skips of each cycle's calls, :161-189; the result is the
  same). Without biases (``bias: false``) the kernel gets zero biases.
  That path is inference-only: with ``use_pallas_stack`` a forward that
  needs gradients raises, as the JAX kernel has no VJP.
* ``pallas_stack_bf16`` with ``use_pallas_stack`` runs that path in K3's
  bf16-resident mode (JAX :184-187, ``compute_dtype=bfloat16``): x, c and
  the weights rounded to bf16, the skip summed in float32. JAX ignores the
  flag when ``use_pallas_stack_train`` is set (:174-181), and so does the
  port: the cycles then run in float32.
* ``use_pallas_stack_train`` with gradients on (training) runs each cycle
  through ``fused_wavenet_cycle_train`` instead, as JAX does (:174-181):
  chunks of ``pallas_stack_train_layers_per_call`` layers, each a
  recompute checkpoint, forward through K3 and backward through the
  hand-written K4 kernel; the gradients of the stacked weights flow
  through ``torch.stack`` and weight norm to ``weight_g``/``weight_v``.
  The shipped ``parallel_wavegan.v1*.yaml`` set this flag.
* otherwise each block runs on its own, through ``fused_gated_resblock``
  when ``use_pallas_kernels`` is set: its forward is the kernel (K5,
  causal or not) and its backward autograd of the plain block, as in JAX.

``pallas_stack_tile`` and ``pallas_stack_train_tile`` are the TPU
kernels' tiling: they are accepted for config compatibility and have no
effect here.

``ResidualParallelWaveGANDiscriminator`` (JAX :294-371) is a WaveNet-like
discriminator without conditioning: ``first_conv`` (1x1 and the
activation), gated blocks with no aux input, the skip sum scaled by
sqrt(1/layers), then activation -> 1x1 -> activation -> 1x1, on cuDNN (JAX
runs no kernel here). Keys are upstream's (JAX
convert/torch_checkpoint.py:402 ``_t_residual_pwg_d``): ``first_conv.0``,
``conv_layers.{i}.*``, ``last_conv_layers.{1,3}``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from parallelwavegan_tpu_torch.layers.convs import (
    Conv1d,
    Conv1d1x1,
    kaiming_normal_relu_std,
    remove_weight_norm,
)
from parallelwavegan_tpu_torch.layers.residual_block import (
    WaveNetResidualBlock,
    get_activation,
)
from parallelwavegan_tpu_torch.layers.upsample import (
    ConvInUpsampleNetwork,
    UpsampleNetwork,
)
from parallelwavegan_tpu_torch.models.melgan import MelGANGenerator
from parallelwavegan_tpu_torch.ops.kernels.wavenet import (
    WEIGHT_KEYS,
    fused_wavenet_stack,
    with_fragments,
    with_tiles_bf16,
)
from parallelwavegan_tpu_torch.ops.kernels.wavenet_train import (
    fused_wavenet_cycle_train,
)


class ParallelWaveGANGenerator(nn.Module):
    """(z (B, in_channels, T), c (B, aux_channels, T' + 2w)) -> (B, out, T)."""

    requires_noise_input = True

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        kernel_size: int = 3,
        layers: int = 30,
        stacks: int = 3,
        residual_channels: int = 64,
        gate_channels: int = 128,
        skip_channels: int = 64,
        aux_channels: int = 80,
        aux_context_window: int = 2,
        dropout: float = 0.0,
        bias: bool = True,
        use_weight_norm: bool = True,
        use_causal_conv: bool = False,
        upsample_conditional_features: bool = True,
        upsample_net: str = "ConvInUpsampleNetwork",
        upsample_params: Any = None,
        use_pallas_kernels: bool = False,
        use_pallas_stack: bool = False,
        pallas_stack_tile: int = 8192,
        pallas_stack_bf16: bool = False,
        use_pallas_stack_train: bool = False,
        pallas_stack_train_tile: int = 2048,
        pallas_stack_train_layers_per_call: int = 5,
        device: torch.device | str | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        assert layers % stacks == 0
        self.layers = layers
        self.stacks = stacks
        self.aux_context_window = aux_context_window
        upsample_params = dict(upsample_params or {"upsample_scales": [4, 4, 4, 4]})
        self.upsample_scales = tuple(int(s) for s in upsample_params["upsample_scales"])
        kw = dict(use_weight_norm=use_weight_norm, generator=generator)

        self.first_conv = Conv1d1x1(
            in_channels, residual_channels, bias=True,
            normal_std=kaiming_normal_relu_std(in_channels), **kw)
        self.upsample_net = None
        if upsample_conditional_features:
            params = dict(upsample_params, use_causal_conv=use_causal_conv,
                          use_weight_norm=use_weight_norm)
            if upsample_net == "ConvInUpsampleNetwork":
                self.upsample_net = ConvInUpsampleNetwork(
                    **params, aux_channels=aux_channels,
                    aux_context_window=aux_context_window, generator=generator)
            elif upsample_net == "UpsampleNetwork":
                self.upsample_net = UpsampleNetwork(**params)
            elif upsample_net == "MelGANGenerator":
                # JAX :54-60: the generator's weight norm, no final tanh
                if aux_context_window != 0:
                    raise ValueError("upsample_net MelGANGenerator takes no "
                                     f"aux_context_window, got {aux_context_window}")
                params["use_final_nonlinear_activation"] = False
                self.upsample_net = MelGANGenerator(**params, generator=generator)
            else:
                raise ValueError(f"upsample_net {upsample_net!r} is not supported")
        per_cycle = layers // stacks
        self.conv_layers = nn.ModuleList([
            WaveNetResidualBlock(
                kernel_size=kernel_size, residual_channels=residual_channels,
                gate_channels=gate_channels, skip_channels=skip_channels,
                aux_channels=aux_channels, dilation=2 ** (layer % per_cycle),
                dropout=dropout, bias=bias, use_causal_conv=use_causal_conv,
                use_pallas=use_pallas_kernels, **kw)
            for layer in range(layers)
        ])
        self.last_conv_layers = nn.ModuleList([
            nn.ReLU(),
            Conv1d1x1(skip_channels, skip_channels, bias=True,
                      normal_std=kaiming_normal_relu_std(skip_channels), **kw),
            nn.ReLU(),
            Conv1d1x1(skip_channels, out_channels, bias=True,
                      normal_std=kaiming_normal_relu_std(skip_channels), **kw),
        ])
        # the JAX gate (:142-148); c given is checked per call
        self.use_stack = ((use_pallas_stack or use_pallas_stack_train)
                          and not use_causal_conv and dropout == 0.0)
        self.use_stack_train = use_pallas_stack_train and self.use_stack
        # JAX ignores pallas_stack_bf16 under use_pallas_stack_train (:174-187)
        self.stack_bf16 = pallas_stack_bf16 and self.use_stack and not self.use_stack_train
        self.layers_per_call = int(pallas_stack_train_layers_per_call)
        self._kernel_cache = None
        if device is not None:
            self.to(device)

    @property
    def upsample_factor(self) -> int:
        if self.upsample_net is None:
            return 1
        return math.prod(self.upsample_scales)

    @property
    def receptive_field_size(self) -> int:
        per_cycle = self.layers // self.stacks
        k = self.conv_layers[0].conv.kernel_size[0]
        return (k - 1) * sum(2 ** (i % per_cycle) for i in range(self.layers)) + 1

    def forward(self, z: torch.Tensor, c: torch.Tensor | None) -> torch.Tensor:
        if c is not None and self.upsample_net is not None:
            c = self.upsample_net(c)
            assert c.size(-1) == z.size(-1), (c.shape, z.shape)
        x = self.first_conv(z)
        cache = self._kernel_cache or {"stack": None, "blocks": None}
        if self.use_stack and c is not None:
            skips = self._fused_stack(x, c, cache["stack"])
        else:
            skips = 0.0
            for i, f in enumerate(self.conv_layers):
                x, h = f(x, c, cache["blocks"] and cache["blocks"][i])
                skips = skips + h
        x = skips * math.sqrt(1.0 / self.layers)
        for f in self.last_conv_layers:
            x = f(x)
        return x

    def _fused_stack(self, x, c, stack):
        """The skip sum (B, C_s, T) of every layer through the stack kernel,
        channel-last inside; differentiable, cycle by cycle, when training
        with ``use_pallas_stack_train``."""
        x, c = x.transpose(1, 2).contiguous(), c.transpose(1, 2).contiguous()
        # under mixed precision the no-grad forward too runs JAX's chunks,
        # whose boundaries round to bf16
        if self.use_stack_train and (torch.is_grad_enabled() or x.dtype == torch.bfloat16):
            weights, dilations = self.stack_weights(differentiable=True)
            per = self.layers // self.stacks
            skips = None
            for s in range(0, self.layers, per):
                cycle = {k: v[s:s + per] for k, v in weights.items()}
                x, sk = fused_wavenet_cycle_train(
                    x, c, cycle, dilations[s:s + per],
                    max_layers_per_call=self.layers_per_call)
                skips = sk if skips is None else skips + sk
            return skips.transpose(1, 2)
        weights, dilations = stack or self.stack_weights()
        _, skips = fused_wavenet_stack(
            x, c, weights, dilations,
            torch.bfloat16 if self.stack_bf16 else torch.float32)
        return skips.transpose(1, 2)

    def stack_weights(self, differentiable: bool = False) -> tuple:
        """(every block's gather-form weights stacked along a leading layer
        axis, as the JAX generator stacks a cycle's (:161-173), the blocks'
        dilations), from the current effective weights; ``differentiable``
        keeps them in the autograd graph."""
        per = [blk.gather_weights(differentiable) for blk in self.conv_layers]
        return ({k: torch.stack([w[k] for w in per]) for k in WEIGHT_KEYS},
                tuple(blk.dilation for blk in self.conv_layers))

    def prepare_kernels(self) -> None:
        """Gather the kernel weights once, for decode, and on the card split
        them once for K3/K5 (``wavenet.with_fragments``), or round them once
        into wgmma's bf16 tiles for K3's bf16 mode
        (``wavenet.with_tiles_bf16``); a MelGAN upsample net prepares
        its own. Call it after the weights are loaded, folded and on their
        device; loading weights or moving the module afterwards drops them
        again."""

        def split(w):
            if not w["wconv"].is_cuda:
                return w
            return with_tiles_bf16(w) if self.stack_bf16 else with_fragments(w)

        self._kernel_cache = None
        if hasattr(self.upsample_net, "prepare_kernels"):
            self.upsample_net.prepare_kernels()
        if self.use_stack:
            weights, dilations = self.stack_weights()
            self._kernel_cache = {"stack": (split(weights), dilations), "blocks": None}
        elif self.conv_layers[0].use_fused:
            self._kernel_cache = {
                "stack": None,
                "blocks": [split(blk.gather_weights()) for blk in self.conv_layers],
            }

    def _drop_kernel_weights(self) -> None:
        self._kernel_cache = None
        if hasattr(self.upsample_net, "_kernel_cache"):
            self.upsample_net._kernel_cache = None

    def remove_weight_norm(self) -> None:
        remove_weight_norm(self)
        self._drop_kernel_weights()

    def _apply(self, fn, *args, **kwargs):
        self._kernel_cache = None  # the children's _apply drops theirs
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._drop_kernel_weights()
        return super().load_state_dict(*args, **kwargs)


class ParallelWaveGANDiscriminator(nn.Module):
    """Non-conditional dilated conv stack: (B, in, T) -> (B, out, T).

    Counterpart of parallelwavegan_tpu/models/parallel_wavegan.py:238-291:
    ``layers - 1`` convs of ``conv_channels`` at dilation 1, 1, 2, 3, ...
    (or ``dilation_factor ** i``), each followed by the activation, then a
    last conv. Keys are upstream's ``conv_layers.{2i}`` (activations at the
    odd indices), the map of JAX's ``_make_t_pwg_d``
    (convert/torch_checkpoint.py:388).
    """

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_size: int = 3, layers: int = 10,
                 conv_channels: int = 64, dilation_factor: int = 1,
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 bias: bool = True, use_weight_norm: bool = True,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if (kernel_size - 1) % 2 != 0:
            raise ValueError("kernel_size must be odd")
        if dilation_factor <= 0:
            raise ValueError("dilation_factor must be positive")
        params = nonlinear_activation_params or {"negative_slope": 0.2}
        kw = dict(bias=bias, use_weight_norm=use_weight_norm, generator=generator)
        self.conv_layers = nn.ModuleList()
        for i in range(layers - 1):
            if i == 0:
                dilation, cin = 1, in_channels
            else:
                dilation = i if dilation_factor == 1 else dilation_factor ** i
                cin = conv_channels
            self.conv_layers.append(Conv1d(
                cin, conv_channels, kernel_size, dilation=dilation,
                normal_std=kaiming_normal_relu_std(kernel_size * cin), **kw))
            self.conv_layers.append(get_activation(nonlinear_activation, params))
        self.conv_layers.append(Conv1d(
            conv_channels, out_channels, kernel_size,
            normal_std=kaiming_normal_relu_std(kernel_size * conv_channels), **kw))
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for f in self.conv_layers:
            x = f(x)
        return x


class ResidualParallelWaveGANDiscriminator(nn.Module):
    """WaveNet-like discriminator: (B, in, T) -> (B, out, T) (module
    docstring; JAX parallel_wavegan.py:294-371)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_size: int = 3, layers: int = 30, stacks: int = 3,
                 residual_channels: int = 64, gate_channels: int = 128,
                 skip_channels: int = 64, dropout: float = 0.0,
                 bias: bool = True, use_weight_norm: bool = True,
                 use_causal_conv: bool = False,
                 nonlinear_activation: str = "LeakyReLU",
                 nonlinear_activation_params: dict | None = None,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if (kernel_size - 1) % 2 != 0:
            raise ValueError("kernel_size must be odd")
        assert layers % stacks == 0
        self.layers = layers
        params = nonlinear_activation_params or {"negative_slope": 0.2}
        kw = dict(use_weight_norm=use_weight_norm, generator=generator)
        per_cycle = layers // stacks
        self.first_conv = nn.Sequential(
            Conv1d1x1(in_channels, residual_channels, bias=True,
                      normal_std=kaiming_normal_relu_std(in_channels), **kw),
            get_activation(nonlinear_activation, params))
        self.conv_layers = nn.ModuleList([
            WaveNetResidualBlock(
                kernel_size=kernel_size, residual_channels=residual_channels,
                gate_channels=gate_channels, skip_channels=skip_channels,
                aux_channels=-1, dilation=2 ** (layer % per_cycle),
                dropout=dropout, bias=bias, use_causal_conv=use_causal_conv, **kw)
            for layer in range(layers)
        ])
        self.last_conv_layers = nn.ModuleList([
            get_activation(nonlinear_activation, params),
            Conv1d1x1(skip_channels, skip_channels, bias=True,
                      normal_std=kaiming_normal_relu_std(skip_channels), **kw),
            get_activation(nonlinear_activation, params),
            Conv1d1x1(skip_channels, out_channels, bias=True,
                      normal_std=kaiming_normal_relu_std(skip_channels), **kw),
        ])
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.first_conv(x)
        skips = 0.0
        for f in self.conv_layers:
            x, h = f(x, None)
            skips = skips + h
        x = skips * math.sqrt(1.0 / self.layers)
        for f in self.last_conv_layers:
            x = f(x)
        return x
