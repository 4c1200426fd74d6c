"""Tensor (model) parallelism: the JAX package's Megatron layout over a
process group, one process per card.

The counterpart of the JAX package's `parallel/tp.py`.  JAX annotates the
parameters with `PartitionSpec`s over a `model` mesh axis and lets GSPMD
insert the collectives; the port follows PyTorch's idiom instead: every
rank of a process group runs the same program on its own pieces of the
weights (SPMD), with the collectives written where the layout needs them.

The layout (`param_specs`, on the port's reference-layout state dicts; a
Linear weight is (out, in), so column-split is dim 0 and row-split dim 1):

  * Swin attention: `qkv` column-split, `proj` row-split; one all-reduce
    closes the pair.  The cut is head-aligned: q, k and v are each cut by
    heads, so that a rank owns whole heads (JAX cuts the concatenated
    [q|k|v] contiguously and lets GSPMD reshard).  A block whose head count
    does not divide `n_model` runs its attention whole on every rank.
  * Swin MLP: `fc1` column-split, `fc2` row-split (both 1x1 convs), one
    all-reduce.
  * Timestep MLP: `time_embed.0` column-split, `time_embed.2` row-split,
    one all-reduce; each ResBlock's `emb_layers.1` column-split, then an
    all-gather.
  * Every conv, in the UNet and the VQGAN, split by output channel where
    the count divides `n_model`, then an all-gather along the channels, so
    that GroupNorm, SiLU and the next conv see the full activations.
  * Row-parallel biases (added after the all-reduce), norm affines, the
    rel-pos tables and the codebook stay whole; so do the two heads that
    the fused tail reads by weight (`out.2`, `decoder.conv_out`), at any
    `n_model` (JAX cuts them where their 3 outputs divide it, at 3).

`tp_clone(module, group)` gives this rank's model: a clone pinned to the
plain compositions (`use_pallas=False`, as the JAX package's `_tp_clone`:
GSPMD cannot partition a Pallas call, and these split forms launch no
kernel either), its split layers holding only their pieces.  The row-
parallel partial sums are all-reduced in float32.  gloo handles CUDA
tensors only in `broadcast` and `all_reduce`, so on gloo a CUDA all-gather
is an all-reduce of a zero-filled tensor in which each rank writes its
slice (exact); elsewhere it is `all_gather_into_tensor`.  `COLLECTIVES`
counts both kinds.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import Conv2d, Linear, pinned_clone
from ..models.swin import SwinTransformerBlock, _dense
from ..ops import swin_block as sb
from ..ops.shift import shift_tokens_plain
from ..ops.window_attention import rounded

__all__ = ["param_specs", "shard_state_dict", "all_reduce_sum", "all_gather", "tp_clone",
           "tp_groups", "COLLECTIVES"]

COLLECTIVES = {"all_reduce": 0, "all_gather": 0}
_WHOLE = ("out.2", "decoder.conv_out")  # read by weight in the fused tails
_COL = (".mlp.fc1", ".time_embed.0", ".emb_layers.1")
_ROW = (".mlp.fc2", ".time_embed.2")
_GROUPS: dict = {}


def _ends(name: str, suffixes: tuple) -> bool:
    return ("." + name).endswith(suffixes)


def _spec(sd: Mapping, mod: str, leaf: str, n: int) -> int | None:
    w = sd.get(f"{mod}.weight")
    if leaf not in ("weight", "bias") or w is None or mod in _WHOLE:
        return None
    if _ends(mod, (".attn.qkv", ".attn.proj")):
        heads = sd[mod.rsplit(".", 1)[0] + ".relative_position_bias_table"].shape[1]
        if heads % n:
            return None
        return 0 if mod.endswith("qkv") else (1 if leaf == "weight" else None)
    if _ends(mod, _ROW):
        return 1 if leaf == "weight" and w.shape[1] % n == 0 else None
    if (_ends(mod, _COL) or w.ndim == 4) and w.shape[0] % n == 0:
        return 0
    return None


def param_specs(state_dict: Mapping, n_model: int) -> dict[str, int | None]:
    """For each key of a UNet's or a VQGAN's state dict, the dim it is cut
    along over `n_model` ranks, or None where it stays whole (see the
    module's docstring)."""
    return {k: _spec(state_dict, *k.rpartition(".")[::2], n_model) for k in state_dict}


def _qkv_piece(t: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    """Rank's heads of each of q, k and v (rows 3 x C of a qkv weight or bias)."""
    return t.reshape(3, n, -1, *t.shape[1:])[:, rank].reshape(-1, *t.shape[1:])


def shard_state_dict(sd: Mapping, rank: int, n_model: int,
                     specs: Mapping | None = None) -> dict[str, torch.Tensor]:
    """Rank's pieces of a state dict (the whole tensor where its spec is
    None)."""
    specs = param_specs(sd, n_model) if specs is None else specs
    out = {}
    for k, t in sd.items():
        t, d = torch.as_tensor(t), specs[k]
        if d is None:
            out[k] = t
        elif _ends(k.rsplit(".", 1)[0], (".attn.qkv",)):
            out[k] = _qkv_piece(t, rank, n_model)
        else:
            size = t.shape[d] // n_model
            out[k] = t.narrow(d, rank * size, size)
    return out


# ------------------------------------------------------------ collectives

def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `t` over the group's ranks, in place (every rank gets the
    same bits)."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, group=group)
    return t


def _gather_by_all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` stacked on a new dim 0 by an all-reduce of a
    zero-filled tensor in which this rank writes its slice (exact: every
    other term of each sum is zero)."""
    out = t.new_zeros((dist.get_world_size(group),) + t.shape)
    out[dist.get_rank(group)] = t
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim`, in rank order.  On gloo a
    CUDA tensor goes through `_gather_by_all_reduce`."""
    COLLECTIVES["all_gather"] += 1
    if t.is_cuda and dist.get_backend(group) == "gloo":
        out = _gather_by_all_reduce(t, group)
    else:
        out = t.new_empty((dist.get_world_size(group) * t.shape[0],) + t.shape[1:])
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, t.contiguous(), group=group)
        out = out.view((-1,) + t.shape)
    dim %= t.dim()
    return out.movedim(0, dim).flatten(dim, dim + 1)


def tp_groups(data: int = 1):
    """The tensor-parallel group of this rank when the world is split into
    `data` groups of world // data consecutive ranks (DP x TP): (the group,
    None for the whole world; its index; its size).  Every rank creates
    every group, in the same order, once."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if data < 1 or world % data:
        raise ValueError(f"data = {data} does not divide the world of {world} ranks")
    m = world // data
    if data == 1:
        return None, 0, m
    if (world, data) not in _GROUPS:
        _GROUPS[(world, data)] = [dist.new_group(list(range(g * m, (g + 1) * m)))
                                  for g in range(data)]
    return _GROUPS[(world, data)][rank // m], rank // m, m


# --------------------------------------------------------- split layers

class _ColumnConv2d(nn.Module):
    """An output-channel piece of a conv, then the all-gather along channels."""

    def __init__(self, conv: Conv2d, weight, bias, group):
        super().__init__()
        dt = conv.compute_dtype
        self.weight, self.bias = weight.to(dt).contiguous(), bias.to(dt).contiguous()
        self.stride, self.padding, self.dtype, self.group = (conv.stride, conv.padding, dt,
                                                             group)

    def forward(self, x):
        y = F.conv2d(x.to(self.dtype), self.weight, self.bias, self.stride, self.padding)
        return all_gather(y, 1, self.group)


class _ColumnLinear(nn.Module):
    """An output piece of a Linear, gathered after (`gather`) or left to the
    row-parallel layer that follows."""

    def __init__(self, lin: Linear, weight, bias, group, gather: bool):
        super().__init__()
        dt = lin.compute_dtype
        self.weight, self.bias = weight.to(dt).contiguous(), bias.to(dt).contiguous()
        self.dtype, self.group, self.gather = dt, group, gather

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight, self.bias)
        return all_gather(y, -1, self.group) if self.gather else y


class _RowLinear(nn.Module):
    """An input piece of a Linear: the partial product, all-reduced in f32,
    plus the whole bias."""

    def __init__(self, lin: Linear, weight, group):
        super().__init__()
        dt = lin.compute_dtype
        self.weight, self.bias = weight.to(dt).contiguous(), lin.bias.float()
        self.dtype, self.group = dt, group

    def forward(self, x):
        part = all_reduce_sum(F.linear(x.to(self.dtype), self.weight).float(), self.group)
        return (part + self.bias).to(self.dtype)


class _SplitSwinBlock(nn.Module):
    """`SwinTransformerBlock.forward` in the split form: the (shifted)
    attention of this rank's heads and its part of proj, all-reduced, then
    the bias, the residual and the statistics; likewise fc1's piece and
    fc2's partial.  A half whose weights stay whole runs the plain half."""

    def __init__(self, block: SwinTransformerBlock, pieces: dict, group):
        super().__init__()
        self.block, self.group = block, group
        dt, attn, mlp = block.dtype, block.attn, block.mlp
        self.heads = None
        if pieces.get("attn.qkv.weight") is not None:
            local = pieces["attn.qkv.weight"].shape[0] // 3 // (attn.qkv.weight.shape[1]
                                                                 // block.num_heads)
            first = dist.get_rank(group) * local
            self.heads = slice(first, first + local)
            self.wqkv = _dense(pieces["attn.qkv.weight"], dt)
            self.bqkv = pieces["attn.qkv.bias"].to(dt)
            self.wproj = _dense(pieces["attn.proj.weight"], dt)
            self.bproj = attn.proj.bias.float()
        self.mlp_split = pieces.get("mlp.fc1.weight") is not None
        if self.mlp_split:
            self.w1, self.b1 = _dense(pieces["mlp.fc1.weight"], dt), pieces["mlp.fc1.bias"].to(dt)
            self.w2, self.b2 = _dense(pieces["mlp.fc2.weight"], dt), mlp.fc2.bias.float()

    def _attn(self, x, w, b, bias_mask, n):
        blk = self.block
        dt = blk.dtype
        if self.heads is None:
            a = blk.attn
            return sb.norm_attn_residual_stats_plain(
                x, w, b, _dense(a.qkv.weight, dt), a.qkv.bias.to(dt), _dense(a.proj.weight, dt),
                a.proj.bias.to(dt), bias_mask, blk.num_heads, n)
        bsz, t, c = x.shape
        nh = self.heads.stop - self.heads.start
        hd = c // blk.num_heads
        xw = (x.float() * w[:, None] + b[:, None]).to(dt).reshape(bsz * t // n, n, c)
        m = xw.shape[0]
        qkv = (xw @ self.wqkv + self.bqkv).reshape(m, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        scores = (q * rounded(hd ** -0.5, dt)) @ k.transpose(-1, -2)
        bm = bias_mask[:, self.heads]
        nw = bm.shape[0]
        scores = scores.reshape(m // nw, nw, nh, n, n) + bm[None].to(dt)
        p = torch.softmax(scores.reshape(m, nh, n, n).float(), dim=-1).to(dt)
        out = (p @ v).transpose(1, 2).reshape(m, n, nh * hd)
        part = all_reduce_sum((out @ self.wproj).float(), self.group)
        y = x + (part + self.bproj).to(dt).reshape(bsz, t, c)
        return (y,) + sb.token_stats(y)

    def _mlp(self, x, w, b):
        blk = self.block
        dt = blk.dtype
        if not self.mlp_split:
            fc1, fc2 = blk.mlp.fc1, blk.mlp.fc2
            return sb.norm_mlp_residual_stats_plain(x, w, b, _dense(fc1.weight, dt),
                                                    fc1.bias.to(dt), _dense(fc2.weight, dt),
                                                    fc2.bias.to(dt))
        xn = (x.float() * w[:, None] + b[:, None]).to(dt)
        part = all_reduce_sum((F.gelu(xn @ self.w1 + self.b1) @ self.w2).float(), self.group)
        y = x + (part + self.b2).to(dt)
        return (y,) + sb.token_stats(y)

    def forward(self, xt: torch.Tensor, h: int, w: int, stats=None):
        blk = self.block
        t, ws, shift = xt.shape[1], blk.ws, blk.shift_size
        if stats is None:
            stats = sb.token_stats(xt)
        wa, ba = sb.fold_stats(stats, blk.norm1.weight, blk.norm1.bias, t)
        xs = shift_tokens_plain(xt, h, w, ws, shift) if shift else xt
        y, ys, yq = self._attn(xs, wa, ba, blk._bias_mask(h, w), ws * ws)
        if shift:
            y = shift_tokens_plain(y, h, w, ws, shift, inverse=True)
        wm, bm = sb.fold_stats((ys, yq), blk.norm2.weight, blk.norm2.bias, t)
        return self._mlp(y, wm, bm)


def tp_clone(module: nn.Module, group=None) -> nn.Module:
    """This rank's tensor-parallel copy of a UNet or a VQGAN (see the
    module's docstring): pinned plain, each split layer replaced by one
    holding only its pieces; the rest shares `module`'s tensors."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    model = pinned_clone(module, False)
    sd = model.state_dict()
    specs = param_specs(sd, n)
    pieces = shard_state_dict(sd, rank, n, specs)

    def piece(key):
        return pieces[key] if specs.get(key) is not None else None

    blocks = []
    for name, sub in list(model.named_modules()):
        if any(name.startswith(b + ".") for b in blocks):
            continue  # a Swin block's layers: the split block reads them
        w = piece(f"{name}.weight")
        if isinstance(sub, SwinTransformerBlock):
            blocks.append(name)
            new = _SplitSwinBlock(sub, {k[len(name) + 1:]: piece(k) for k in specs
                                        if k.startswith(name + ".")}, group)
        elif w is None:
            continue
        elif isinstance(sub, Linear):
            new = (_RowLinear(sub, w, group) if specs[f"{name}.weight"] == 1 else
                   _ColumnLinear(sub, w, piece(f"{name}.bias"), group,
                                 gather=name != "time_embed.0"))
        elif isinstance(sub, Conv2d):
            new = _ColumnConv2d(sub, w, piece(f"{name}.bias"), group)
        else:
            continue
        parent, _, attr = name.rpartition(".")
        model.get_submodule(parent)._modules[attr] = new
    return model
