"""JAX parameter trees -> the port's (reference-layout) state_dicts.

`from_flax(params, which=...)` takes a Flax parameter tree of numpy arrays
(nested dicts, as the JAX package's models produce them) and returns the
state_dict that the port's modules load: Conv HWIO -> OIHW, Dense
(in, out) -> Linear (out, in), a Dense used as a 1x1-conv MLP ->
(out, in, 1, 1), GroupNorm scale -> weight.  The key walk follows the
reference's module construction order; it is this package's own copy of
the JAX package's mapping, so that nothing here imports Flax or JAX.
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Mapping

import numpy as np

__all__ = ["from_flax", "load_torch_state_dict", "lpips_from_flax", "train_state_from_flax"]


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _emit(flat: dict, sd: dict, tkey: str, fpath: tuple, kind: str) -> None:
    if kind == "raw":
        sd[tkey] = _np(flat[fpath])
        return
    if kind == "gn":
        sd[f"{tkey}.weight"] = _np(flat[fpath + ("scale",)])
        sd[f"{tkey}.bias"] = _np(flat[fpath + ("bias",)])
        return
    k = _np(flat[fpath + ("kernel",)])
    if kind == "conv":
        sd[f"{tkey}.weight"] = k.transpose(3, 2, 0, 1)
    elif kind == "linear":
        sd[f"{tkey}.weight"] = k.T
    elif kind == "dense1x1":
        sd[f"{tkey}.weight"] = k.T[:, :, None, None]
    else:  # pragma: no cover
        raise ValueError(kind)
    if fpath + ("bias",) in flat:
        sd[f"{tkey}.bias"] = _np(flat[fpath + ("bias",)])


def _resblock(flat, sd, t, f):
    _emit(flat, sd, f"{t}.in_layers.0", f + ("in_norm",), "gn")
    _emit(flat, sd, f"{t}.in_layers.2", f + ("in_conv",), "conv")
    _emit(flat, sd, f"{t}.emb_layers.1", f + ("emb_proj",), "linear")
    _emit(flat, sd, f"{t}.out_layers.0", f + ("out_norm",), "gn")
    _emit(flat, sd, f"{t}.out_layers.3", f + ("out_conv",), "conv")
    if f + ("skip_connection", "kernel") in flat:
        _emit(flat, sd, f"{t}.skip_connection", f + ("skip_connection",), "conv")


def _basiclayer(flat, sd, t, f, depth):
    _emit(flat, sd, f"{t}.patch_embed.proj", f + ("patch_embed_proj",), "conv")
    if f + ("patch_embed_norm", "scale") in flat:  # patch_norm
        _emit(flat, sd, f"{t}.patch_embed.norm", f + ("patch_embed_norm",), "gn")
    for i in range(depth):
        b, fb = f"{t}.blocks.{i}", f + (f"block{i}",)
        _emit(flat, sd, f"{b}.norm1", fb + ("norm1",), "gn")
        _emit(flat, sd, f"{b}.attn.relative_position_bias_table",
              fb + ("attn", "relative_position_bias_table"), "raw")
        _emit(flat, sd, f"{b}.attn.qkv", fb + ("attn", "qkv"), "linear")
        _emit(flat, sd, f"{b}.attn.proj", fb + ("attn", "proj"), "linear")
        _emit(flat, sd, f"{b}.norm2", fb + ("norm2",), "gn")
        _emit(flat, sd, f"{b}.mlp.fc1", fb + ("mlp_fc1",), "dense1x1")
        _emit(flat, sd, f"{b}.mlp.fc2", fb + ("mlp_fc2",), "dense1x1")
    _emit(flat, sd, f"{t}.patch_unembed.proj", f + ("patch_unembed_proj",), "conv")
    if f + ("patch_unembed_norm", "scale") in flat:
        _emit(flat, sd, f"{t}.patch_unembed.norm", f + ("patch_unembed_norm",), "gn")


def _resample(flat, sd, t, f, up: bool, resblock_updown: bool, conv_resample: bool,
              res=_resblock):
    """A Downsample (`op`) or Upsample (`conv`), none without `conv_resample`,
    or the ResBlock that takes its place with `resblock_updown`."""
    if resblock_updown:
        res(flat, sd, t, f)
    elif conv_resample:
        conv = "conv" if up else "op"
        _emit(flat, sd, f"{t}.{conv}", f + (conv,), "conv")


def _walk_unet_swin(flat, sd, *, image_size: int = 64,
                    channel_mult: Iterable[int] = (1, 2, 2, 4),
                    num_res_blocks: Iterable[int] | int = (2, 2, 2, 2),
                    attention_resolutions: Iterable[int] = (64, 32, 16, 8),
                    swin_depth: int = 2, cond_lq: bool = True, lq_size: int | None = None,
                    resblock_updown: bool = False, conv_resample: bool = True,
                    **_ignored) -> None:
    channel_mult = list(channel_mult)
    nrb = ([num_res_blocks] * len(channel_mult) if isinstance(num_res_blocks, int)
           else list(num_res_blocks))
    attn = set(attention_resolutions)
    _emit(flat, sd, "time_embed.0", ("time_embed_0",), "linear")
    _emit(flat, sd, "time_embed.2", ("time_embed_2",), "linear")
    if cond_lq and lq_size is not None and lq_size != image_size:
        for i in range(int(math.log2(lq_size / image_size))):  # the LQ feature pyramid
            _emit(flat, sd, f"feature_extractor.{3 * i}", (f"fe_conv{i}",), "conv")
            _emit(flat, sd, f"feature_extractor.{3 * i + 2}.op", (f"fe_down{i}", "op"), "conv")
    _emit(flat, sd, "input_blocks.0.0", ("conv_in",), "conv")
    n, ds = 1, image_size
    for level in range(len(channel_mult)):
        for jj in range(nrb[level]):
            _resblock(flat, sd, f"input_blocks.{n}.0", (f"in_l{level}_b{jj}_res",))
            if ds in attn and jj == 0:
                _basiclayer(flat, sd, f"input_blocks.{n}.1", (f"in_l{level}_b{jj}_swin",),
                            swin_depth)
            n += 1
        if level != len(channel_mult) - 1:
            _resample(flat, sd, f"input_blocks.{n}.0", (f"in_l{level}_down",), False,
                      resblock_updown, conv_resample)
            n += 1
            ds //= 2
    _resblock(flat, sd, "middle_block.0", ("mid_res0",))
    _basiclayer(flat, sd, "middle_block.1", ("mid_swin",), swin_depth)
    _resblock(flat, sd, "middle_block.2", ("mid_res1",))
    n = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(nrb[level] + 1):
            _resblock(flat, sd, f"output_blocks.{n}.0", (f"out_l{level}_b{i}_res",))
            j = 1
            if ds in attn and i == 0:
                _basiclayer(flat, sd, f"output_blocks.{n}.{j}", (f"out_l{level}_b{i}_swin",),
                            swin_depth)
                j += 1
            if level and i == nrb[level]:
                _resample(flat, sd, f"output_blocks.{n}.{j}", (f"out_l{level}_up",), True,
                          resblock_updown, conv_resample)
                ds *= 2
            n += 1
    _emit(flat, sd, "out.0", ("out_norm",), "gn")
    _emit(flat, sd, "out.2", ("out_conv",), "conv")


def _global_attn(flat, sd, t, f):
    """GlobalAttentionBlock: GN and two 1-D 1x1 convs, (out, in, 1) <-> Dense (in, out)."""
    _emit(flat, sd, f"{t}.norm", f + ("norm",), "gn")
    for name in ("qkv", "proj_out"):
        sd[f"{t}.{name}.weight"] = _np(flat[f + (name, "kernel")]).T[:, :, None]
        sd[f"{t}.{name}.bias"] = _np(flat[f + (name, "bias")])


def _walk_unet_plain(flat, sd, *, image_size: int = 64,
                     channel_mult: Iterable[int] = (1, 2, 4, 8),
                     num_res_blocks: Iterable[int] | int = 2,
                     attention_resolutions: Iterable[int] = (32, 16, 8),
                     num_classes: int | None = None, resblock_updown: bool = False,
                     conv_resample: bool = True, **_ignored) -> None:
    channel_mult = list(channel_mult)
    nrb = ([num_res_blocks] * len(channel_mult) if isinstance(num_res_blocks, int)
           else list(num_res_blocks))
    attn = set(attention_resolutions)
    _emit(flat, sd, "time_embed.0", ("time_embed_0",), "linear")
    _emit(flat, sd, "time_embed.2", ("time_embed_2",), "linear")
    if num_classes is not None:
        _emit(flat, sd, "label_emb.weight", ("label_emb", "embedding"), "raw")
    _emit(flat, sd, "input_blocks.0.0", ("conv_in",), "conv")
    n, ds = 1, image_size
    for level in range(len(channel_mult)):
        for jj in range(nrb[level]):
            _resblock(flat, sd, f"input_blocks.{n}.0", (f"in_l{level}_b{jj}_res",))
            if ds in attn:
                _global_attn(flat, sd, f"input_blocks.{n}.1", (f"in_l{level}_b{jj}_attn",))
            n += 1
        if level != len(channel_mult) - 1:
            _resample(flat, sd, f"input_blocks.{n}.0", (f"in_l{level}_down",), False,
                      resblock_updown, conv_resample)
            n += 1
            ds //= 2
    _resblock(flat, sd, "middle_block.0", ("mid_res0",))
    _global_attn(flat, sd, "middle_block.1", ("mid_attn",))
    _resblock(flat, sd, "middle_block.2", ("mid_res1",))
    n = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(nrb[level] + 1):
            _resblock(flat, sd, f"output_blocks.{n}.0", (f"out_l{level}_b{i}_res",))
            j = 1
            if ds in attn:
                _global_attn(flat, sd, f"output_blocks.{n}.{j}", (f"out_l{level}_b{i}_attn",))
                j += 1
            if level and i == nrb[level]:
                _resample(flat, sd, f"output_blocks.{n}.{j}", (f"out_l{level}_up",), True,
                          resblock_updown, conv_resample)
                ds *= 2
            n += 1
    _emit(flat, sd, "out.0", ("out_norm",), "gn")
    _emit(flat, sd, "out.2", ("out_conv",), "conv")


def _resblock_conv(flat, sd, t, f):
    """ResBlockConv under the port's own names (the JAX package has no
    mapping for UNetModelConv)."""
    _emit(flat, sd, f"{t}.in_layers.1", f + ("in_conv",), "conv")
    _emit(flat, sd, f"{t}.emb_layers.1", f + ("emb_proj",), "linear")
    _emit(flat, sd, f"{t}.out_layers.2", f + ("out_conv",), "conv")
    if f + ("skip_connection", "kernel") in flat:
        _emit(flat, sd, f"{t}.skip_connection", f + ("skip_connection",), "conv")


def _walk_unet_conv(flat, sd, *, channel_mult: Iterable[int] = (1, 2, 4, 8),
                    num_res_blocks: Iterable[int] | int = 2, resblock_updown: bool = False,
                    conv_resample: bool = True, **_ignored) -> None:
    channel_mult = list(channel_mult)
    nrb = ([num_res_blocks] * len(channel_mult) if isinstance(num_res_blocks, int)
           else list(num_res_blocks))
    _emit(flat, sd, "time_embed.0", ("time_embed_0",), "linear")
    _emit(flat, sd, "time_embed.2", ("time_embed_2",), "linear")
    _emit(flat, sd, "input_blocks.0.0", ("conv_in",), "conv")
    n = 1
    for level in range(len(channel_mult)):
        for jj in range(nrb[level]):
            _resblock_conv(flat, sd, f"input_blocks.{n}.0", (f"in_l{level}_b{jj}_res",))
            n += 1
        if level != len(channel_mult) - 1:
            _resample(flat, sd, f"input_blocks.{n}.0", (f"in_l{level}_down",), False,
                      resblock_updown, conv_resample, _resblock_conv)
            n += 1
    _resblock_conv(flat, sd, "middle_block.0", ("mid_res0",))
    _resblock_conv(flat, sd, "middle_block.1", ("mid_res1",))
    n = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(nrb[level] + 1):
            _resblock_conv(flat, sd, f"output_blocks.{n}.0", (f"out_l{level}_b{i}_res",))
            if level and i == nrb[level]:
                _resample(flat, sd, f"output_blocks.{n}.1", (f"out_l{level}_up",), True,
                          resblock_updown, conv_resample, _resblock_conv)
            n += 1
    _emit(flat, sd, "out.1", ("out_conv",), "conv")


def _ae_resnet(flat, sd, t, f):
    _emit(flat, sd, f"{t}.norm1", f + ("norm1",), "gn")
    _emit(flat, sd, f"{t}.conv1", f + ("conv1",), "conv")
    _emit(flat, sd, f"{t}.norm2", f + ("norm2",), "gn")
    _emit(flat, sd, f"{t}.conv2", f + ("conv2",), "conv")
    if f + ("nin_shortcut", "kernel") in flat:
        _emit(flat, sd, f"{t}.nin_shortcut", f + ("nin_shortcut",), "conv")


def _ae_attn(flat, sd, t, f):
    _emit(flat, sd, f"{t}.norm", f + ("norm",), "gn")
    for p in ("q", "k", "v", "proj_out"):
        _emit(flat, sd, f"{t}.{p}", f + (p,), "conv")


def _walk_vqgan(flat, sd, *, ch_mult: Iterable[int] = (1, 2, 4),
                num_res_blocks: Iterable[int] | int = 2, attn_resolutions: Iterable[int] = (),
                resolution: int = 256, resamp_with_conv: bool = True, quantize: bool = True,
                **_ignored) -> None:
    ch_mult = list(ch_mult)
    nrb = ([num_res_blocks] * len(ch_mult) if isinstance(num_res_blocks, int)
           else list(num_res_blocks))
    attn = set(attn_resolutions or ())
    enc = ("encoder",)
    _emit(flat, sd, "encoder.conv_in", enc + ("conv_in",), "conv")
    curr = resolution
    for i in range(len(ch_mult)):
        for j in range(nrb[i]):
            _ae_resnet(flat, sd, f"encoder.down.{i}.block.{j}", enc + (f"down{i}_block{j}",))
            if curr in attn:
                _ae_attn(flat, sd, f"encoder.down.{i}.attn.{j}", enc + (f"down{i}_attn{j}",))
        if i != len(ch_mult) - 1:
            if resamp_with_conv:
                _emit(flat, sd, f"encoder.down.{i}.downsample.conv",
                      enc + (f"down{i}_downsample", "conv"), "conv")
            curr //= 2
    _ae_resnet(flat, sd, "encoder.mid.block_1", enc + ("mid_block1",))
    _ae_attn(flat, sd, "encoder.mid.attn_1", enc + ("mid_attn1",))
    _ae_resnet(flat, sd, "encoder.mid.block_2", enc + ("mid_block2",))
    _emit(flat, sd, "encoder.norm_out", enc + ("norm_out",), "gn")
    _emit(flat, sd, "encoder.conv_out", enc + ("conv_out",), "conv")
    dec = ("decoder",)
    _emit(flat, sd, "decoder.conv_in", dec + ("conv_in",), "conv")
    _ae_resnet(flat, sd, "decoder.mid.block_1", dec + ("mid_block1",))
    _ae_attn(flat, sd, "decoder.mid.attn_1", dec + ("mid_attn1",))
    _ae_resnet(flat, sd, "decoder.mid.block_2", dec + ("mid_block2",))
    curr = resolution // 2 ** (len(ch_mult) - 1)
    for i in reversed(range(len(ch_mult))):
        for j in range(nrb[i] + 1):
            _ae_resnet(flat, sd, f"decoder.up.{i}.block.{j}", dec + (f"up{i}_block{j}",))
            if curr in attn:
                _ae_attn(flat, sd, f"decoder.up.{i}.attn.{j}", dec + (f"up{i}_attn{j}",))
        if i != 0:
            if resamp_with_conv:
                _emit(flat, sd, f"decoder.up.{i}.upsample.conv",
                      dec + (f"up{i}_upsample", "conv"), "conv")
            curr *= 2
    _emit(flat, sd, "decoder.norm_out", dec + ("norm_out",), "gn")
    _emit(flat, sd, "decoder.conv_out", dec + ("conv_out",), "conv")
    if quantize:  # the VQModel's codebook; AutoencoderKL has none
        _emit(flat, sd, "quantize.embedding.weight", ("quantize", "embedding"), "raw")
    _emit(flat, sd, "quant_conv", ("quant_conv",), "conv")
    _emit(flat, sd, "post_quant_conv", ("post_quant_conv",), "conv")


def from_flax(params: Mapping, which: str, **cfg) -> dict[str, np.ndarray]:
    """A JAX parameter tree -> reference-layout state_dict (numpy float32).

    which='unet' takes the UNetModelSwin hyperparameters (image_size,
    channel_mult, num_res_blocks, attention_resolutions, swin_depth,
    resblock_updown, conv_resample, and cond_lq with lq_size for the LQ
    feature pyramid, which is mapped when lq_size is given and differs from
    image_size; the patch norms are mapped where the tree has them; others
    are ignored); which='unet_plain' the UNetModel's (image_size,
    channel_mult, num_res_blocks, attention_resolutions, num_classes,
    resblock_updown, conv_resample), key for key the JAX package's
    `export_unet_plain`; which='unet_conv' the UNetModelConv's
    (channel_mult, num_res_blocks, resblock_updown, conv_resample), to the
    port's own names; which='vqgan' and 'autoencoder_kl' the ddconfig's
    ch_mult, num_res_blocks, attn_resolutions, resolution and
    resamp_with_conv (f4, f8, KL); which='window_attention' maps a
    standalone WindowAttention."""
    flat = _flatten(params)
    sd: dict[str, np.ndarray] = {}
    if which == "unet":
        _walk_unet_swin(flat, sd, **cfg)
    elif which == "unet_plain":
        _walk_unet_plain(flat, sd, **cfg)
    elif which == "unet_conv":
        _walk_unet_conv(flat, sd, **cfg)
    elif which in ("vqgan", "autoencoder_kl"):
        _walk_vqgan(flat, sd, quantize=which == "vqgan", **cfg)
    elif which == "window_attention":
        _emit(flat, sd, "relative_position_bias_table", ("relative_position_bias_table",), "raw")
        _emit(flat, sd, "qkv", ("qkv",), "linear")
        _emit(flat, sd, "proj", ("proj",), "linear")
    else:
        raise ValueError(f"which must be 'unet', 'unet_plain', 'unet_conv', 'vqgan', "
                         f"'autoencoder_kl' or 'window_attention', not {which!r}")
    return sd


def _strip_prefixes(sd: Mapping[str, Any]) -> dict[str, Any]:
    out = {}
    for k, v in sd.items():
        for p in ("module.", "_orig_mod."):
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def load_torch_state_dict(path: str) -> dict[str, Any]:
    """A reference-layout state_dict from a `.pth` file, on the CPU."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return _strip_prefixes(obj)


def _adam_state(opt_state) -> Any:
    """The element of an optax state that holds `mu`, `nu` and `count`."""
    if all(hasattr(opt_state, a) for a in ("mu", "nu", "count")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def train_state_from_flax(state, **unet_cfg) -> dict:
    """A JAX train state (the JAX package's `trainer.State`: params,
    optax.adamw's state, EMA params, step) -> the port's train-state dict
    (`TrainStep.load_state_dict`, `checkpoint.save_train_state`): params,
    EMA and the Adam moments mu / nu through `from_flax(..., "unet",
    **unet_cfg)`, which maps a moment tree as it maps the params, and the
    step.  Adam's count must equal the step."""
    import torch

    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in the optimizer state")
    step = int(np.asarray(state.step))
    if int(np.asarray(adam.count)) != step:
        raise ValueError(f"Adam's count {int(np.asarray(adam.count))} is not the step {step}")
    tree = lambda t: {k: torch.tensor(v) for k, v in from_flax(t, "unet", **unet_cfg).items()}
    return {"step": step, "params": tree(state.params), "ema": tree(state.ema_params),
            "exp_avg": tree(adam.mu), "exp_avg_sq": tree(adam.nu)}


def lpips_from_flax(params: Mapping) -> dict[str, np.ndarray]:
    """The JAX package's LPIPS parameters ({'vgg': {'conv{idx}': {kernel,
    bias}}, 'lin{i}': (C,)}, numpy) -> the state_dict of
    `models.lpips.LPIPS` (numpy float32), its scaling buffers included."""
    from .models.lpips import _SCALE, _SHIFT, _conv_indices, _slice_of

    sd = {"scaling_layer.shift": _np(_SHIFT).reshape(1, 3, 1, 1),
          "scaling_layer.scale": _np(_SCALE).reshape(1, 3, 1, 1)}
    for idx in _conv_indices():
        conv = params["vgg"][f"conv{idx}"]
        sd[f"net.slice{_slice_of(idx)}.{idx}.weight"] = _np(conv["kernel"]).transpose(3, 2, 0, 1)
        sd[f"net.slice{_slice_of(idx)}.{idx}.bias"] = _np(conv["bias"])
    i = 0
    while f"lin{i}" in params:
        w = _np(params[f"lin{i}"]).reshape(1, -1, 1, 1)
        sd[f"lin{i}.model.1.weight"] = sd[f"lins.{i}.model.1.weight"] = w
        i += 1
    return sd
