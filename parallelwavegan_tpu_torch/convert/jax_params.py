"""JAX parameter tree -> the port's (upstream-keyed) state dict.

The inverse of parallelwavegan_tpu/convert/torch_checkpoint.py:510
``_convert_tree`` for the models the port has: module paths go through
the same name maps as ``_t_hifigan_g`` (:131; the causal generator's
``input_conv/conv``, ``upsamples_{i}/deconv`` and ``output_conv/conv`` as
upstream's ``input_conv.conv``, ``upsamples.{i}.1.deconv`` and
``output_conv.1.conv``), ``_make_t_melgan_g``
(:153-207, causal or not), ``_make_t_pwg_g`` (:210-264, its MelGAN
upsample net under ``upsample_net.melgan.*``), ``_t_style_melgan_g``
(:267-286), ``_make_t_pwg_d`` (:388-399), ``_t_residual_pwg_d``
(:402-418), ``_make_t_melgan_d`` (:420-434, nested under
``discriminators`` for StyleMelGAN's and the MelGAN multi-scale one,
:85-90, :116-119), and HiFi-GAN's ``_t_hifigan_period_d`` and
``_make_t_hifigan_scale_d`` (:437-463, nested under ``discriminators``
and ``msd``/``mpd``, :94-122), the U-Net HiFi-GAN's ``_t_uhifigan_g``
(:289-315; its ``upsamples_{i}`` and causal ``upsamples_{i}/deconv`` the
transposed convs) and the VQ-VAE's ``_make_t_vqvae`` (:318-350: the
MelGAN discriminator's map under ``encoder``, the MelGAN generator's
under ``decoder``, the codebook's ``embedding`` as
``codebook.embedding.weight``, ``local_embed`` and ``global_embed``) in
reverse, conv
kernels (K, Cin, Cout) are transposed to torch's (Cout, Cin, K)
(``_CONV_PERM``) and 2-D ones (Kh, Kw, Cin, Cout) to (Cout, Cin, Kh, Kw)
(``_CONV2D_PERM``), the discrete generators' embeddings, LayerNorm scales
and the duration predictor's head (``_t_discrete_hifigan_g``,
``_t_duration_predictor``, ``_t_discrete_style_melgan_g``, :353-385) as
torch's ``weight`` (the head's transposed), transposed-conv kernels
(HiFi-GAN's ``upsamples_*``,
MelGAN's deconv layers, StyleMelGAN's ``noise_upsample_*``: the
``is_transpose`` set) are flipped along K and
laid out as torch's (Cin, Cout, K) (``_DECONV_PERM``, :466-467,
:558-562), the UpsampleNetwork's (T, F, 1, 1) leaves
``conv_{i}[_v|_g]`` become ``up_layers.{step*i+1}`` Conv2d weights
(1, 1, F, T) (``_UPCONV2D_PERM``, :469), and weight norm's ``g``/``v``
become ``weight_g``/``weight_v``. A module in the ``spectral`` collection
(spectral norm) has its ``kernel`` as ``weight_orig`` and its
power-iteration vectors ``u``/``v`` as ``weight_u``/``weight_v``, the
inverse of ``convert_state_dict`` (:675-684).
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch


def _idx(seg: str) -> int:
    return int(seg.rsplit("_", 1)[1])


def _hifigan_prefix(path) -> str:
    """Flax module path -> upstream state-dict prefix (``_t_hifigan_g``)."""
    out = []
    for p in path:
        if p == "input_conv":
            out.append("input_conv")
        elif p.startswith("upsamples_"):
            out.append(f"upsamples.{_idx(p)}.1")
        elif p.startswith("blocks_"):
            out.append(f"blocks.{_idx(p)}")
        elif p.startswith("convs1_"):
            out.append(f"convs1.{_idx(p)}.1")
        elif p.startswith("convs2_"):
            out.append(f"convs2.{_idx(p)}.1")
        elif p == "output_conv":
            out.append("output_conv.1")
        elif p in ("conv", "deconv"):  # the causal generator's wrapped convs
            out.append(p)
        else:
            raise KeyError(f"hifigan path segment {p!r}")
    return ".".join(out)


_PWG_NAMES = {
    "first_conv": "first_conv", "last_conv_1": "last_conv_layers.1",
    "last_conv_2": "last_conv_layers.3", "upsample_net": "upsample_net",
    "conv_in": "conv_in", "upsample": "upsample", "conv": "conv",
    "conv1x1_aux": "conv1x1_aux", "conv1x1_skip": "conv1x1_skip",
    "conv1x1_out": "conv1x1_out",
}


def _pwg_prefix(path) -> str:
    """Flax module path -> upstream state-dict prefix (``_make_t_pwg_g``)."""
    out = []
    for p in path:
        if p.startswith("conv_layers_"):
            out.append(f"conv_layers.{_idx(p)}")
        elif p in _PWG_NAMES:
            out.append(_PWG_NAMES[p])
        else:
            raise KeyError(f"pwg path segment {p!r}")
    return ".".join(out)


def _pwg_d_map(model_params: dict):
    """Flax path -> upstream prefix for ParallelWaveGANDiscriminator
    (``_make_t_pwg_d``): ``conv_layers_{i}`` -> ``conv_layers.{2i}``,
    ``last_conv`` -> ``conv_layers.{2(layers - 1)}``."""
    layers = model_params.get("layers", 10)

    def prefix(path) -> str:
        (p,) = path
        if p.startswith("conv_layers_"):
            return f"conv_layers.{2 * _idx(p)}"
        if p == "last_conv":
            return f"conv_layers.{2 * (layers - 1)}"
        raise KeyError(f"pwg-d path segment {p!r}")

    return prefix


_RESIDUAL_PWG_D_NAMES = {
    "first_conv": "first_conv.0", "last_conv_1": "last_conv_layers.1",
    "last_conv_2": "last_conv_layers.3", "conv": "conv",
    "conv1x1_aux": "conv1x1_aux", "conv1x1_skip": "conv1x1_skip",
    "conv1x1_out": "conv1x1_out",
}


def _residual_pwg_d_prefix(path) -> str:
    """Flax path -> upstream prefix for ResidualParallelWaveGANDiscriminator
    (``_t_residual_pwg_d``): ``first_conv`` -> ``first_conv.0`` (its
    Sequential holds the activation at 1)."""
    out = []
    for p in path:
        if p.startswith("conv_layers_"):
            out.append(f"conv_layers.{_idx(p)}")
        elif p in _RESIDUAL_PWG_D_NAMES:
            out.append(_RESIDUAL_PWG_D_NAMES[p])
        else:
            raise KeyError(f"residual-pwg-d path segment {p!r}")
    return ".".join(out)


# ResidualStack's flax names -> upstream's, non-causal and causal
_STACK_NAMES = {"conv_dilated": "stack.2", "conv_1x1": "stack.4",
                "skip_conv": "skip_layer"}
_CAUSAL_STACK_NAMES = {"conv_dilated": "stack.1.conv", "conv_1x1": "stack.3",
                       "skip_conv": "skip_layer"}


def _stack_prefix(path, causal: bool = False) -> str:
    names = _CAUSAL_STACK_NAMES if causal else _STACK_NAMES
    return ".".join(names[p] for p in path)


def _melgan_map(model_params: dict):
    """(prefix function, deconv module paths) for MelGANGenerator: flax
    ``layers_{li}`` -> upstream ``melgan.{idx}`` of the flat Sequential
    (pad, conv, then per scale act, deconv, stacks, then act, pad, conv;
    causal: CausalConv1d ``{idx}.conv``, per scale act,
    CausalConvTranspose1d ``{idx}.deconv`` (flax ``layers_{li}/deconv``),
    stacks, then act, CausalConv1d, as ``_make_t_melgan_g`` :153-207)."""
    causal = model_params.get("use_causal_conv", False)
    layer_map, deconvs = {0: "0.conv" if causal else "1"}, set()
    idx, li = (1, 1) if causal else (2, 1)
    for _ in model_params.get("upsample_scales", (8, 8, 2, 2)):
        layer_map[li] = str(idx + 1)  # after the activation
        deconvs.add((f"layers_{li}", "deconv") if causal else (f"layers_{li}",))
        idx, li = idx + 2, li + 1
        for _ in range(model_params.get("stacks", 3)):
            layer_map[li] = str(idx)
            idx, li = idx + 1, li + 1
    # after the activation (and the pad)
    layer_map[li] = f"{idx + 1}.conv" if causal else str(idx + 2)

    def prefix(path) -> str:
        out = f"melgan.{layer_map[_idx(path[0])]}"
        if len(path) == 1:
            return out
        if tuple(path[1:]) == ("deconv",):
            return f"{out}.deconv"
        return f"{out}.{_stack_prefix(path[1:], causal)}"

    return prefix, deconvs


_TADE_NAMES = {"tade1": "tade1", "tade2": "tade2", "gated_conv1": "gated_conv1",
               "gated_conv2": "gated_conv2", "aux_conv": "aux_conv.0",
               "gated_conv": "gated_conv.0", "output_conv": "output_conv.0"}


def _style_melgan_prefix(path) -> str:
    """Flax module path -> upstream prefix (``_t_style_melgan_g``): the
    ``trunk`` level is dropped."""
    out = []
    for p in path:
        if p == "trunk":
            continue
        if p.startswith("noise_upsample_"):
            out.append(f"noise_upsample.{2 * _idx(p)}")
        elif p.startswith("blocks_"):
            out.append(f"blocks.{_idx(p)}")
        elif p in _TADE_NAMES:
            out.append(_TADE_NAMES[p])
        else:
            raise KeyError(f"style_melgan path segment {p!r}")
    return ".".join(out)


def _duration_prefix(path) -> str:
    """DurationPredictor (``_t_duration_predictor``): ``conv_{i}`` ->
    ``conv.{i}.0``, ``norm_{i}`` -> ``conv.{i}.2``; the head's leaves sit at
    the module's root and go to ``linear``."""
    if not path:
        return "linear"
    (p,) = path
    if p.startswith("conv_"):
        return f"conv.{_idx(p)}.0"
    if p.startswith("norm_"):
        return f"conv.{_idx(p)}.2"
    raise KeyError(f"duration-predictor path segment {p!r}")


def _discrete_hifigan_prefix(path) -> str:
    """``_t_discrete_hifigan_g``: ``embedding/{emb,spk_emb}`` -> ``emb`` /
    ``spk_emb``, ``duration_predictor/...``, and the ``trunk`` at the root."""
    if path[0] == "embedding":
        return path[1]
    if path[0] == "duration_predictor":
        return f"duration_predictor.{_duration_prefix(path[1:])}"
    if path[0] == "trunk":
        return _hifigan_prefix(path[1:])
    raise KeyError(f"discrete-hifigan path segment {path[0]!r}")


def _discrete_style_melgan_prefix(path) -> str:
    """``_t_discrete_style_melgan_g``: ``emb``/``spk_emb``, then the trunk."""
    return path[0] if path[0] in ("emb", "spk_emb") else _style_melgan_prefix(path)


_UHIFIGAN_NAMES = {"input_conv": "input_conv.0", "hidden_conv": "hidden_conv",
                   "output_conv": "output_conv.1", "conv": "conv", "deconv": "deconv"}


def _uhifigan_prefix(path) -> str:
    """``_t_uhifigan_g``: ``input_conv`` -> ``input_conv.0``, the MRFs'
    blocks -> ``{down,up}samples_mrf.{n}``, ``downsamples_{i}`` ->
    ``downsamples.{i}.0``, ``upsamples_{i}`` -> ``upsamples.{i}.1``,
    ``output_conv`` -> ``output_conv.1``, the blocks' convs as HiFi-GAN's."""
    out = []
    for p in path:
        if p.startswith(("downsamples_mrf_", "upsamples_mrf_")):
            out.append(f"{p.rsplit('_', 1)[0]}.{_idx(p)}")
        elif p.startswith("downsamples_"):
            out.append(f"downsamples.{_idx(p)}.0")
        elif p.startswith("upsamples_"):
            out.append(f"upsamples.{_idx(p)}.1")
        elif p.startswith(("convs1_", "convs2_")):
            out.append(f"{p.rsplit('_', 1)[0]}.{_idx(p)}.1")
        elif p in _UHIFIGAN_NAMES:
            out.append(_UHIFIGAN_NAMES[p])
        else:
            raise KeyError(f"uhifigan path segment {p!r}")
    return ".".join(out)


def _vqvae_map(model_params: dict):
    """(prefix function, deconv module paths) for VQVAE (``_make_t_vqvae``)."""
    enc = model_params.get("encoder_conf") or {"downsample_scales": [4, 4, 2, 2]}
    dec = model_params.get("decoder_conf") or {"upsample_scales": [4, 4, 2, 2],
                                               "stacks": 3}
    enc_prefix = _melgan_d_map(enc.get("downsample_scales", (4, 4, 4, 4)))
    dec_prefix, dec_deconvs = _melgan_map(dec)

    def prefix(path) -> str:
        if path[0] == "encoder":
            return f"encoder.{enc_prefix(path[1:])}"
        if path[0] == "decoder":
            return f"decoder.{dec_prefix(path[1:])}"
        if path[0] == "codebook":
            return "codebook.embedding"
        if path[0] in ("local_embed", "global_embed"):
            return path[0]
        raise KeyError(f"vqvae path segment {path[0]!r}")

    return prefix, {("decoder", *d) for d in dec_deconvs}


def _melgan_d_map(downsample_scales):
    """Flax path -> upstream prefix for MelGANDiscriminator
    (``_make_t_melgan_d``): ``layers_0`` -> ``layers.0.1`` (after the pad),
    the downsampling convs and the first final conv -> ``layers.{i}.0``,
    the last conv -> ``layers.{len(downsample_scales) + 2}``."""
    last = len(downsample_scales) + 2

    def prefix(path) -> str:
        (p,) = path
        if not p.startswith("layers_"):
            raise KeyError(f"melgan-d path segment {p!r}")
        i = _idx(p)
        return "layers.0.1" if i == 0 else (f"layers.{i}.0" if i < last else f"layers.{last}")

    return prefix


def _hifigan_period_d_prefix(path) -> str:
    """``convs_{i}`` -> ``convs.{i}.0``, ``output_conv`` as it is."""
    (p,) = path
    if p.startswith("convs_"):
        return f"convs.{_idx(p)}.0"
    if p == "output_conv":
        return "output_conv"
    raise KeyError(f"period-d path segment {p!r}")


def _hifigan_scale_d_map(model_params: dict):
    """``layers_{i}`` -> ``layers.{i}.0``, the last conv ->
    ``layers.{len(downsample_scales) + 2}``."""
    last = len(model_params.get("downsample_scales", (2, 2, 4, 4, 1))) + 2

    def prefix(path) -> str:
        (p,) = path
        if not p.startswith("layers_"):
            raise KeyError(f"scale-d path segment {p!r}")
        i = _idx(p)
        return f"layers.{i}.0" if i < last else f"layers.{last}"

    return prefix


def _hifigan_msmpd_map(model_params: dict):
    """``msd/discriminators_{i}/...`` and ``mpd/discriminators_{i}/...``."""
    inner = {"msd": _nested("discriminators", _hifigan_scale_d_map(
                 model_params.get("scale_discriminator_params") or {})),
             "mpd": _nested("discriminators", _hifigan_period_d_prefix)}

    def prefix(path) -> str:
        if path[0] not in inner:
            raise KeyError(f"msmpd path segment {path[0]!r}")
        return f"{path[0]}.{inner[path[0]](path[1:])}"

    return prefix


def _nested(outer: str, inner):
    """``{outer}_{i}/...`` -> ``{outer}.{i}.`` + inner(...)."""

    def prefix(path) -> str:
        if not path[0].startswith(f"{outer}_"):
            raise KeyError(f"{outer} path segment {path[0]!r}")
        return f"{outer}.{_idx(path[0])}.{inner(path[1:])}"

    return prefix


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):  # dict or flax FrozenDict
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_params_to_state_dict(model_type: str, model_params: dict, params,
                             spectral=None) -> "OrderedDict[str, torch.Tensor]":
    """JAX params (``G.init(...)`` output or its ``"params"`` entry, with
    numpy or jax arrays as leaves) -> port state dict of float32 tensors.
    ``model_type`` is a registered generator or discriminator,
    ``"ResidualStack"``, ``"TADEResBlock"`` or ``"DurationPredictor"``.
    ``spectral`` is the ``spectral`` collection of a model with spectral
    norm (JAX's ``vars_d["spectral"]``); a full ``init`` output carries its
    own."""
    if "params" in params:
        spectral = params.get("spectral", spectral)
        params = params["params"]
    spectral_vecs = {tuple(path): leaf for path, leaf in _flatten(spectral or {})}
    spectral_mods = {path[:-1] for path in spectral_vecs}
    # MelGAN's deconv layer indices, or the module paths of a PWG's MelGAN
    # upsample net's deconvs
    deconvs = None
    if model_type == "HiFiGANGenerator":
        n_up = len(model_params.get("upsample_scales", (8, 8, 2, 2)))
        found = sum(1 for k in params if str(k).startswith("upsamples_"))
        if found != n_up:
            raise ValueError(f"params hold {found} upsample stages, "
                             f"model_params {n_up}")
        prefix_of = _hifigan_prefix
        if model_params.get("use_causal_conv", False):
            deconvs = {(f"upsamples_{i}", "deconv") for i in range(n_up)}
    elif model_type == "MelGANGenerator":
        prefix_of, deconvs = _melgan_map(model_params)
    elif model_type == "ResidualStack":
        causal = model_params.get("use_causal_conv", False)

        def prefix_of(path):
            return _stack_prefix(path, causal)
    elif model_type in ("StyleMelGANGenerator", "TADEResBlock"):
        prefix_of = _style_melgan_prefix
    elif model_type in ("DiscreteSymbolHiFiGANGenerator",
                        "DiscreteSymbolDurationGenerator"):
        prefix_of = _discrete_hifigan_prefix
    elif model_type == "DiscreteSymbolStyleMelGANGenerator":
        prefix_of = _discrete_style_melgan_prefix
    elif model_type == "DurationPredictor":
        prefix_of = _duration_prefix
    elif model_type == "ParallelWaveGANGenerator":
        prefix_of = _pwg_prefix
        up = model_params.get("upsample_params") or {}
        step = 3 if up.get("nonlinear_activation") is not None else 2
        if model_params.get("upsample_net") == "MelGANGenerator":
            melgan_prefix, melgan_deconvs = _melgan_map(   # the generator's causality
                dict(up, use_causal_conv=model_params.get("use_causal_conv", False)))

            def prefix_of(path):
                if path and path[0] == "upsample_net":
                    return f"upsample_net.{melgan_prefix(path[1:])}"
                return _pwg_prefix(path)

            deconvs = {("upsample_net", *d) for d in melgan_deconvs}
    elif model_type == "UHiFiGANGenerator":
        prefix_of = _uhifigan_prefix
        causal = model_params.get("use_causal_conv", False)
        deconvs = {(f"upsamples_{i}", "deconv") if causal else (f"upsamples_{i}",)
                   for i in range(len(model_params.get("upsample_scales", (8, 8, 2, 2))))}
    elif model_type == "VQVAE":
        prefix_of, deconvs = _vqvae_map(model_params)
    elif model_type == "ParallelWaveGANDiscriminator":
        prefix_of = _pwg_d_map(model_params)
    elif model_type == "ResidualParallelWaveGANDiscriminator":
        prefix_of = _residual_pwg_d_prefix
    elif model_type == "MelGANDiscriminator":
        prefix_of = _melgan_d_map(model_params.get("downsample_scales", (4, 4, 4, 4)))
    elif model_type == "MelGANMultiScaleDiscriminator":
        prefix_of = _nested("discriminators", _melgan_d_map(
            model_params.get("downsample_scales", (4, 4, 4, 4))))
    elif model_type == "HiFiGANPeriodDiscriminator":
        prefix_of = _hifigan_period_d_prefix
    elif model_type == "HiFiGANMultiPeriodDiscriminator":
        prefix_of = _nested("discriminators", _hifigan_period_d_prefix)
    elif model_type == "HiFiGANScaleDiscriminator":
        prefix_of = _hifigan_scale_d_map(model_params)
    elif model_type == "HiFiGANMultiScaleDiscriminator":
        prefix_of = _nested("discriminators", _hifigan_scale_d_map(
            model_params.get("discriminator_params") or {}))
    elif model_type == "HiFiGANMultiScaleMultiPeriodDiscriminator":
        prefix_of = _hifigan_msmpd_map(model_params)
    elif model_type == "StyleMelGANDiscriminator":
        inner = (model_params.get("discriminator_params") or {}).get(
            "downsample_scales", (4, 4, 4, 1))
        prefix_of = _nested("discriminators", _melgan_d_map(inner))
    else:
        raise NotImplementedError(
            f"{model_type} is not ported yet; see ROADMAP.md"
        )
    sd = OrderedDict()
    for path, leaf in _flatten(params):
        *mods, name = path
        prefix = prefix_of(mods)
        w = np.asarray(leaf, dtype=np.float32)
        m = re.match(r"conv_(\d+)(?:_(v|g))?$", name)
        if m and mods and mods[-1] == "upsample":
            # UpsampleNetwork smoothing conv: (T, F, 1, 1) <-> (1, 1, F, T)
            suffix = {"v": "weight_v", "g": "weight_g", None: "weight"}[m.group(2)]
            sd[f"{prefix}.up_layers.{step * int(m.group(1)) + 1}.{suffix}"] = (
                np.transpose(w, (3, 2, 1, 0)))
            continue
        if deconvs is not None:
            transpose = tuple(mods) in deconvs
        else:
            transpose = bool(mods) and mods[-1].startswith(
                ("upsamples_", "noise_upsample_"))
        if name in ("bias", "linear_bias"):
            sd[f"{prefix}.bias"] = w
        elif name in ("embedding", "scale"):  # an embedding table, LayerNorm's scale
            sd[f"{prefix}.weight"] = w
        elif name == "linear_kernel":  # (in, out) -> torch Linear's (out, in)
            sd[f"{prefix}.weight"] = w.T
        elif name in ("v", "kernel"):
            if w.ndim == 4:  # (Kh, Kw, Cin, Cout) -> (Cout, Cin, Kh, Kw)
                w = np.transpose(w, (3, 2, 0, 1))
            elif transpose:
                w = np.transpose(w[::-1], (1, 2, 0))
            else:
                w = np.transpose(w, (2, 1, 0))
            if name == "v":
                sd[f"{prefix}.weight_v"] = w
            elif tuple(mods) in spectral_mods:
                sd[f"{prefix}.weight_orig"] = w
                for vec in ("u", "v"):
                    sd[f"{prefix}.weight_{vec}"] = np.asarray(
                        spectral_vecs[tuple(mods) + (vec,)], dtype=np.float32)
            else:
                sd[f"{prefix}.weight"] = w
        elif name == "g":
            # JAX keeps the norm axis in place ((1, 1, Cout) for a conv,
            # (1, Cin, 1) for a transpose, (1, 1, 1, Cout) for a 2-D conv);
            # torch's weight_g is (n, 1, 1) or (n, 1, 1, 1)
            sd[f"{prefix}.weight_g"] = w.reshape(-1, *[1] * (w.ndim - 1))
        else:
            raise KeyError(f"unknown leaf {name!r} at {'/'.join(mods)}")
    return OrderedDict(
        (k, torch.tensor(np.ascontiguousarray(v))) for k, v in sd.items()
    )
