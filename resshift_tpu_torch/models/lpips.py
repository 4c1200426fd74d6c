"""LPIPS (VGG16 trunk + linear heads): the perceptual distance that the
LPIPS trainer adds to its loss and that validation and `cli eval` report
(the port's own copy of the JAX package's `models/lpips.py`).

  * the torchvision VGG16 `features` trunk, tapped after relu1_2, relu2_2,
    relu3_3, relu4_3 and relu5_3;
  * the `lpips` package's scaling layer, (x - shift) / scale;
  * each tap unit-normalised over its channels (`+ 1e-10`), the squared
    difference weighted by a 1x1 head, the spatial mean, the sum over the
    five stages.
Inputs are NHWC in [-1, 1]; the result is (B,).  The convolutions run in
`dtype` (parameters cast at use); the normalisation and the heads in
float32.  The keys are the `lpips` package's (`scaling_layer.shift`,
`net.slice{s}.{idx}.weight`, `lin{i}.model.1.weight` and its alias
`lins.{i}...`), so that `lpips.LPIPS(net='vgg').state_dict()` loads with
`load_state_dict`; `lpips_state_dict` maps the other layouts that the JAX
package's `convert_lpips` takes.  No weights ship with the repository.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from .layers import Conv2d

__all__ = ["LPIPS", "lpips_state_dict", "load_lpips"]

# VGG16 'features': conv widths and max pools, in torchvision's order
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
            512, 512, 512, "M"]
# the lpips package's five slices of that Sequential: [0, 4), [4, 9), [9, 16),
# [16, 23), [23, 30); each ends after the ReLU of a tap
_SLICE_END = (4, 9, 16, 23, 30)
_STAGE_CH = (64, 128, 256, 512, 512)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    def forward(self, x):
        return (x - self.shift) / self.scale


class _VGG16Slices(nn.Module):
    """VGG16 features as five Sequentials keeping torchvision's indices."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        layers, cin = [], 3
        for v in _VGG_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv2d(cin, v, 3, padding=1, dtype=dtype), nn.ReLU()]
                cin = v
        start = 0
        for s, end in enumerate(_SLICE_END, 1):
            seq = nn.Sequential()
            for idx in range(start, end):
                seq.add_module(str(idx), layers[idx])
            setattr(self, f"slice{s}", seq)
            start = end

    def forward(self, x):
        feats = []
        for s in range(1, len(_SLICE_END) + 1):
            x = getattr(self, f"slice{s}")(x)
            feats.append(x)
        return feats


class _NetLinLayer(nn.Module):
    """The lpips package's head: (dropout, 1x1 conv to one channel, no bias);
    the dropout is inactive in a frozen LPIPS, so index 0 is an identity."""

    def __init__(self, cin: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(cin, 1, 1, bias=False))


class LPIPS(nn.Module):
    """lpips.LPIPS(net='vgg'): `forward(x, y)` with x, y NHWC in [-1, 1] -> (B,)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scaling_layer = _ScalingLayer()
        self.net = _VGG16Slices(dtype)
        for i, c in enumerate(_STAGE_CH):
            setattr(self, f"lin{i}", _NetLinLayer(c))
        self.lins = nn.ModuleList([getattr(self, f"lin{i}") for i in range(len(_STAGE_CH))])
        for i in range(len(_STAGE_CH)):  # the JAX package's init: heads of ones
            nn.init.ones_(self.lins[i].model[1].weight)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.net(self.scaling_layer(x.permute(0, 3, 1, 2)))
        fy = self.net(self.scaling_layer(y.permute(0, 3, 1, 2)))
        total = 0.0
        for lin, a, b in zip(self.lins, fx, fy):
            a = a / (a.float().pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
            b = b / (b.float().pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
            w = lin.model[1].weight.float().view(1, -1, 1, 1)
            total = total + ((a - b) ** 2 * w).sum(1).mean((1, 2))
        return total


def _slice_of(idx: int) -> int:
    return next(s for s, end in enumerate(_SLICE_END, 1) if idx < end)


def _conv_indices() -> tuple[int, ...]:
    """torchvision's Sequential index of each VGG16 conv (0, 2, 5, ..., 28)."""
    out, idx = [], 0
    for v in _VGG_CFG:
        if v != "M":
            out.append(idx)
        idx += 1 if v == "M" else 2
    return tuple(out)


def lpips_state_dict(vgg_sd: Mapping[str, Any],
                     lin_sd: Mapping[str, Any] | None = None) -> dict[str, torch.Tensor]:
    """The state_dict of `LPIPS` from the layouts the JAX package's
    `convert_lpips` accepts: (torchvision `vgg16().features` state_dict with
    '{idx}.weight' keys, the lpips `vgg.pth` heads 'lin{i}.model.1.weight');
    one full `lpips.LPIPS(net='vgg').state_dict()` ('net.slice{s}.{idx}.*');
    or one dict with torchvision's 'features.{idx}.*' and the heads."""
    lin_sd = vgg_sd if lin_sd is None else lin_sd
    as_t = lambda v: torch.as_tensor(np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                                                else v), dtype=torch.float32)
    out = {"scaling_layer.shift": torch.tensor(_SHIFT).view(1, 3, 1, 1),
           "scaling_layer.scale": torch.tensor(_SCALE).view(1, 3, 1, 1)}
    for idx in _conv_indices():
        for kind in ("weight", "bias"):
            for k in (f"{idx}.{kind}", f"features.{idx}.{kind}",
                      f"net.slice{_slice_of(idx)}.{idx}.{kind}"):
                if k in vgg_sd:
                    out[f"net.slice{_slice_of(idx)}.{idx}.{kind}"] = as_t(vgg_sd[k])
                    break
            else:
                raise KeyError(f"no VGG conv {idx} ({kind}) in the state_dict; sample keys: "
                               f"{list(vgg_sd)[:5]}")
    for i, c in enumerate(_STAGE_CH):
        for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if k in lin_sd:
                w = as_t(lin_sd[k]).reshape(1, c, 1, 1)
                out[f"lin{i}.model.1.weight"] = out[f"lins.{i}.model.1.weight"] = w
                break
        else:
            raise KeyError(f"no lin{i} head in the state_dict")
    return out


def load_lpips(path: str | Path | None, dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cpu") -> LPIPS:
    """A frozen LPIPS in eval mode: from a `.pth` of the lpips package's
    weights (one dict in a layout `lpips_state_dict` takes), from the port's
    own parameter file
    (`checkpoint.save_params` of an `LPIPS().state_dict()`), or, with no
    path, with random weights seeded from 0 and heads of ones."""
    model = LPIPS(dtype)
    if path is None:  # He-normal convs (the activations keep their scale), zero biases
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for m in model.net.modules():
                if isinstance(m, nn.Conv2d):
                    std = (2.0 / (m.in_channels * 9)) ** 0.5
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
                    m.bias.zero_()
    elif str(path).endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(lpips_state_dict(sd))
    else:
        from ..checkpoint import load_params

        model.load_state_dict(load_params(path))
    return model.to(device).eval().requires_grad_(False)
