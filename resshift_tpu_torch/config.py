"""Task configuration registry (the port's own copy).

Plain dicts for the shipped tasks, with the same values as the JAX
package's registry, plus a small YAML loader that resolves `${a.b.c}`
interpolation.  PyYAML is imported only inside the loader, so that the
sampler runs where PyYAML is not installed.
"""

from __future__ import annotations

import copy
import json
import re
from pathlib import Path
from typing import Any

__all__ = ["task_config", "load_yaml_config", "default_chop", "TASKS", "CKPT_URLS"]

_F4_DDCONFIG = dict(
    double_z=False, z_channels=3, resolution=256, in_channels=3, out_ch=3,
    ch=128, ch_mult=[1, 2, 4], num_res_blocks=2, attn_resolutions=[], dropout=0.0,
)
_F8_DDCONFIG = dict(
    double_z=False, z_channels=8, resolution=512, in_channels=3, out_ch=3,
    ch=64, ch_mult=[1, 2, 4, 8], num_res_blocks=[1, 2, 3, 4],
    attn_resolutions=[], dropout=0.0,
)


def _unet(in_ch=3, out_ch=3, lq_size=64, cond_mask=False) -> dict:
    return dict(
        image_size=64, in_channels=in_ch, model_channels=160, out_channels=out_ch,
        attention_resolutions=[64, 32, 16, 8], dropout=0.0,
        channel_mult=[1, 2, 2, 4], num_res_blocks=[2, 2, 2, 2],
        conv_resample=True, num_head_channels=32, use_scale_shift_norm=True,
        resblock_updown=False, swin_depth=2, swin_embed_dim=192, window_size=8,
        mlp_ratio=4, cond_lq=True, cond_mask=cond_mask, lq_size=lq_size,
    )


def _diffusion(steps, min_noise_level, sf) -> dict:
    return dict(
        schedule_name="exponential", steps=steps, min_noise_level=min_noise_level,
        etas_end=0.99, kappa=2.0, power=0.3, predict_type="xstart",
        timestep_respacing=None, normalize_input=True, latent_flag=True,
        scale_factor=1.0, sf=sf,
    )


TASKS: dict[str, dict] = {
    # conference models: 15 steps, min_noise_level 0.04
    "realsr_v1": dict(
        task="realsr", sf=4,
        model=_unet(),
        diffusion=_diffusion(15, 0.04, 4),
        autoencoder=dict(embed_dim=3, n_embed=8192, ddconfig=_F4_DDCONFIG),
        inference=dict(chop_size=512, chop_stride=448, padding_offset=64),
    ),
    # journal models: 4 steps, min_noise_level 0.2
    "realsr_v3": dict(
        task="realsr", sf=4,
        model=_unet(),
        diffusion=_diffusion(4, 0.2, 4),
        autoencoder=dict(embed_dim=3, n_embed=8192, ddconfig=_F4_DDCONFIG),
        inference=dict(chop_size=512, chop_stride=448, padding_offset=64),
    ),
    "realsr_x2": dict(
        task="realsr", sf=2,
        model=_unet(lq_size=128),
        diffusion=_diffusion(4, 0.2, 2),
        autoencoder=dict(embed_dim=3, n_embed=8192, ddconfig=_F4_DDCONFIG),
        inference=dict(chop_size=256, chop_stride=224, padding_offset=64),
    ),
    "bicsr": dict(
        task="bicsr", sf=4,
        model=_unet(),
        diffusion=_diffusion(4, 0.2, 4),
        autoencoder=dict(embed_dim=3, n_embed=8192, ddconfig=_F4_DDCONFIG),
        inference=dict(chop_size=512, chop_stride=448, padding_offset=64),
    ),
    "inpaint_imagenet": dict(
        task="inpaint", sf=1,
        model=_unet(lq_size=256, cond_mask=True),
        diffusion=_diffusion(4, 0.2, 1),
        autoencoder=dict(embed_dim=3, n_embed=8192, ddconfig=_F4_DDCONFIG),
        inference=dict(chop_size=256, chop_stride=224, padding_offset=64),
    ),
    "inpaint_face": dict(
        task="inpaint", sf=1,
        model=_unet(lq_size=256, cond_mask=True),
        diffusion=_diffusion(4, 0.2, 1),
        autoencoder=dict(embed_dim=3, n_embed=8192, ddconfig=_F4_DDCONFIG),
        inference=dict(chop_size=256, chop_stride=224, padding_offset=64),
    ),
    "faceir": dict(
        task="faceir", sf=1,
        model=_unet(in_ch=8, out_ch=8, lq_size=512),
        diffusion=_diffusion(4, 0.2, 1),
        autoencoder=dict(embed_dim=8, n_embed=4096, ddconfig=_F8_DDCONFIG),
        inference=dict(chop_size=512, chop_stride=448, padding_offset=64),
    ),
}
TASKS["realsr_v2"] = copy.deepcopy(TASKS["realsr_v1"])

# the released checkpoints (unet, vqgan) of each task, for a download by
# hand: the port never fetches them
_REL = "https://github.com/zsyOAOA/ResShift/releases/download/v2.0"
CKPT_URLS = {
    "realsr_v1": (f"{_REL}/resshift_realsrx4_s15_v1.pth", f"{_REL}/autoencoder_vq_f4.pth"),
    "realsr_v2": (f"{_REL}/resshift_realsrx4_s15_v2.pth", f"{_REL}/autoencoder_vq_f4.pth"),
    "realsr_v3": (f"{_REL}/resshift_realsrx4_s4_v3.pth", f"{_REL}/autoencoder_vq_f4.pth"),
    "bicsr": (f"{_REL}/resshift_bicsrx4_s4.pth", f"{_REL}/autoencoder_vq_f4.pth"),
    "inpaint_imagenet": (f"{_REL}/resshift_inpainting_imagenet_s4.pth",
                         f"{_REL}/autoencoder_vq_f4.pth"),
    "inpaint_face": (f"{_REL}/resshift_inpainting_face_s4.pth",
                     f"{_REL}/celeba256_vq_f4_dim3_face.pth"),
    "faceir": (f"{_REL}/resshift_faceir_s4.pth", f"{_REL}/ffhq512_vq_f8_dim8_face.pth"),
}


def task_config(name: str) -> dict:
    """Deep copy of a built-in task config (e.g. 'realsr_v1')."""
    if name not in TASKS:
        raise KeyError(f"unknown task '{name}'; available: {sorted(TASKS)}")
    return copy.deepcopy(TASKS[name])


def default_chop(chop_size: int, scale: int) -> tuple[int, int]:
    """The reference's chop defaults: (chop_size, chop_stride) for a chop
    of 512, 256 or 64 LQ px, after the (4 // scale) rescale."""
    table = {512: 448, 256: 224, 64: 48}
    if chop_size not in table:
        raise ValueError("chop size must be one of 512/256/64")
    m = 4 // scale
    return chop_size * m, table[chop_size] * m


_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _resolve(node: Any, root: dict) -> Any:
    if isinstance(node, dict):
        return {k: _resolve(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, root) for v in node]
    if isinstance(node, str):
        m = _INTERP.fullmatch(node)
        if m:
            cur: Any = root
            for part in m.group(1).split("."):
                cur = cur[part]
            return _resolve(cur, root)
        return _INTERP.sub(lambda mm: str(_resolve(mm.group(0), root)), node)
    return node


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml_config(path: str | Path) -> dict:
    """YAML config with `${a.b.c}` interpolation.  A top-level
    `base_task: <name>` deep-merges the file over that built-in task.  A
    `.json` file is read with the json module (JSON is YAML), which needs
    no PyYAML."""
    with open(path) as f:
        if str(path).endswith(".json"):
            raw = json.load(f)
        else:
            import yaml  # lazy: an optional dependency of the port

            raw = yaml.safe_load(f)
    base = raw.pop("base_task", None)
    if base:
        raw = _deep_merge(task_config(base), raw)
    return _resolve(raw, raw)
