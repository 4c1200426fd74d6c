"""Probe P2's tensor-core route (csrc/attn_variants_tc.cu, the body in
csrc/window_attn_tc.cuh with PolicyP2), checked on the CPU:

  * the route gate `attn_variants.attn_variant_route`: which shapes take
    the tensor-core kernel `attn_variants_tc` (bf16, C % 16 == 0, heads 16
    or 32 wide), which take the FMA kernel `attn_variants` (f32 at every
    shape, bf16 at the other head widths), and which raise; a CPU tensor
    runs the plain version and launches neither;
  * a numpy mirror of the body's register epilogue of the scores, window by
    window: each warp's 16 x 64 score block in the mma.sync accumulator
    layout (lane l holds rows l / 4 and l / 4 + 8, keys 8 nt + 2 (l % 4)
    and + 1), the bias added in f32, the masked keys (key >= N), the row
    max and sum over the lane's terms in the kernel's order and then over
    its quad by xor-shuffles 1 and 2, every mode's rounding points, the
    probabilities packed to bf16, p v, mxsum's scaling by the rounded
    reciprocal of the sum, and the rows past N dropped.  Around it the
    body's rounding under ROUND2 = false (q, k, v = rnd(acc + b), y =
    rnd(x + (acc + bproj))).  Held against `attn_variant_plain` in bf16 for
    every mode at windows of 64, 49 and 16 tokens and heads 16 and 32 wide,
    within one bf16 step of the largest output;
  * that the mirror catches the trap of the masked keys: with them left at
    -inf, noexp and none give non-finite outputs wherever a window has
    fewer than 64 tokens.

The mirror reads the body's tile constants and the softmax codes from the
sources and pins them.  The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 2).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from resshift_tpu_torch.ops import attn_variants as av

CSRC = Path(__file__).resolve().parents[1] / "resshift_tpu_torch" / "csrc"
BF16, F32 = torch.bfloat16, torch.float32
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
NT, E = np.arange(8), np.arange(4)
# (32, 8, 4): the row (of a warp's 16) and key of accumulator element e of
# n-tile nt in lane l
FRAG_ROW = G[:, None, None] + 8 * (E >> 1)[None, None, :]
FRAG_KEY = 8 * NT[None, :, None] + 2 * T[:, None, None] + (E & 1)[None, None, :]
ROWS, BLOCK = 64, 16  # a CTA's token rows; a warp's row block


def constants(text: str) -> dict:
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def bf16(a) -> np.ndarray:
    """Round to bf16 (nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


# ------------------------------------------------------------------ route


@pytest.mark.parametrize("n,c,heads", [
    (64, 192, 6),   # the probe's width: 8x8 windows, 6 heads x 32
    (16, 48, 3),    # ragged windows, heads of 16, a panel cut short
    (49, 48, 3),    # 7x7 windows
    (64, 256, 8),   # the widest C, heads of 32
    (16, 256, 16),  # heads of 16
    (1, 16, 1),     # the smallest
])
def test_bf16_takes_the_tensor_core_route(n, c, heads):
    assert av.attn_variant_route(BF16, n, c, heads) == "tc"


@pytest.mark.parametrize("n,c,heads,why", [
    (49, 96, 4, "heads 24 wide: the card test's FMA shape"),
    (64, 40, 2, "C % 16 != 0"),
    (64, 128, 2, "heads 64 wide"),
    (64, 64, 8, "heads 8 wide"),
])
def test_bf16_off_the_tensor_core_gate_takes_the_fma_route(n, c, heads, why):
    assert av.attn_variant_route(BF16, n, c, heads) == "fma"


@pytest.mark.parametrize("n,c,heads", [(64, 192, 6), (16, 48, 3), (49, 96, 4), (64, 40, 2)])
def test_f32_takes_the_fma_route(n, c, heads):
    assert av.attn_variant_route(F32, n, c, heads) == "fma"


@pytest.mark.parametrize("dt", [BF16, F32])
@pytest.mark.parametrize("n,c,heads", [
    (65, 192, 6), (0, 192, 6), (64, 272, 17), (64, 192, 5), (64, 192, 0), (64, 256, 2),
])
def test_both_routes_raise(dt, n, c, heads):
    with pytest.raises(ValueError, match="attn_variants"):
        av.attn_variant_route(dt, n, c, heads)


@pytest.mark.parametrize("dt", [torch.float16, torch.float64])
def test_other_dtypes_raise(dt):
    with pytest.raises(TypeError):
        av.attn_variant_route(dt, 64, 192, 6)


@pytest.mark.parametrize("c,heads", [(48, 3), (96, 4)])  # the tc and FMA routes' shapes
def test_cpu_tensors_take_the_plain_version(c, heads):
    """On the CPU the wrapper runs the plain version, whatever the gate
    says, and launches neither kernel."""
    args = [torch.from_numpy(a) for a in _inputs(16, 32, c, heads, 2, 0)]
    for i in (0, 3, 4, 5, 6):
        args[i] = args[i].bfloat16()
    before = (av.ATTN_VARIANTS_TC.launches, av.ATTN_VARIANTS.launches)
    got = av.attn_variant(*args, heads, 16, "noexp")
    assert (av.ATTN_VARIANTS_TC.launches, av.ATTN_VARIANTS.launches) == before
    assert torch.equal(got, av.attn_variant_plain(*args, heads, 16, "noexp"))


# ------------------------------------------------------------------ mirror


def test_mirror_pins_the_body():
    """The mirror's tile (64 rows a CTA, 8 warps: 4 row blocks of 16 x 2
    column halves), the softmax codes the wrapper passes, and mxsum's shift
    are the sources'."""
    body = (CSRC / "window_attn_tc.cuh").read_text()
    k = constants(body)
    assert (k["ROWS"], k["THREADS"]) == (ROWS, 4 * 2 * 32)
    codes = dict(re.findall(r"SM_(\w+) = (\d+)", (CSRC / "common.cuh").read_text()))
    assert {m: int(codes[m.upper()]) for m in av.SOFTMAX_MODES} == {
        m: i for i, m in enumerate(av.SOFTMAX_MODES)}
    assert "rnd<bf16>(expf(sc[nt][e] - 30.f))" in body and av.SOFTMAX_SHIFT == 30.0
    # the accumulator layout the mirror gathers the scores by
    assert "g = lane >> 2, t = lane & 3" in body
    assert "const int key = nt * 8 + 2 * t + (e & 1);" in body
    assert "const int r0 = rb * 16 + g;  // this thread's accumulator rows: r0, r0 + 8" in body
    assert "PolicyP2<SM>" in (CSRC / "attn_variants_tc.cu").read_text()


def quad(v: np.ndarray, op) -> np.ndarray:
    """The quad's reduction by __shfl_xor_sync 1, then 2, of v (32, ...)."""
    v = op(v, v[LANE ^ 1])
    return op(v, v[LANE ^ 2])


def epilogue(sc: np.ndarray, n: int, mode: str, trap: bool = False):
    """One warp's scores plus bias (32, 8, 4 in the accumulator layout) ->
    the probabilities as packed for p v (bf16 values) and the per-row
    reciprocal of the sum (32, 2), as the body computes them.  `trap`
    leaves every masked key at -inf."""
    valid = FRAG_KEY < n
    s = np.where(valid, sc, np.float32(0 if mode == "none" and not trap else -np.inf))
    s = s.astype(np.float32)
    if mode in ("f32", "bf16exp", "noexp"):
        mx = np.stack([s[:, :, 2 * r:2 * r + 2].max((1, 2)) for r in range(2)], 1)
        mx = quad(mx, np.maximum)[:, None, E >> 1]  # (32, 1, 4): each element's row max
    total = np.zeros((32, 2), np.float32)
    if mode != "none":
        with np.errstate(invalid="ignore", over="ignore"):
            if mode == "f32":
                s = np.exp(s - mx)
            elif mode == "mxsum":
                s = bf16(np.exp(s - np.float32(30)))
            elif mode == "bf16exp":
                s = bf16(np.exp(bf16(s - mx)))
            else:
                s = s - mx if trap else np.where(valid, s - mx, np.float32(0))
            for nt in range(8):  # the lane's terms in the kernel's order
                for e in range(4):
                    total[:, e >> 1] += s[:, nt, e]
        total = quad(total, np.add)
        if mode == "bf16exp":
            total = bf16(total)
    with np.errstate(divide="ignore", invalid="ignore"):
        rc = np.float32(1) / total
        if mode in ("f32", "bf16exp", "noexp"):  # the Markstein quotient is the IEEE one
            s = s / total[:, None, E >> 1]
    return bf16(s), rc


def window_y(x, w, b, wqkv, bqkv, wproj, bproj, bias, nh: int, n: int, mode: str,
             trap: bool = False) -> np.ndarray:
    """One window's n rows of y as attn_variants_tc computes them: x (n, C)
    bf16 values, w, b (C,) f32, bias (nh, n, n) f32 with the shift of 30
    already subtracted."""
    c = x.shape[1]
    hd = c // nh
    rows = np.minimum(np.arange(ROWS), n - 1)  # a row past N repeats row N - 1
    xr = x[rows]
    xn = bf16(xr * w + b)  # an f32 multiply and add
    qkv = bf16(xn @ wqkv + bqkv)  # rnd(acc + b)
    q = bf16(qkv[:, :c] * bf16(hd ** -0.5))
    k, v = qkv[:, c:2 * c], qkv[:, 2 * c:]
    heads = np.zeros((ROWS, c), np.float32)
    for h in range(nh):
        cols = slice(h * hd, (h + 1) * hd)
        s = q[:, cols] @ k[:, cols].T  # (64 rows, 64 keys), f32 sums
        bm = np.zeros((ROWS, ROWS), np.float32)
        bm[:, :n] = bias[h][rows]  # 0 past the last key, row N - 1's past the last row
        s = s + bm
        for rb in range(ROWS // BLOCK):  # each warp's row block
            blk = s[rb * BLOCK:(rb + 1) * BLOCK]
            p, rc = epilogue(blk[FRAG_ROW, FRAG_KEY], n, mode, trap)
            pb = np.zeros((BLOCK, ROWS), np.float32)
            pb[FRAG_ROW, FRAG_KEY] = p
            with np.errstate(invalid="ignore", over="ignore"):
                o = pb @ v[:, cols]
                if mode == "mxsum":  # rows g (rc[:, 0]) and g + 8 (rc[:, 1])
                    o = o * np.concatenate([rc[::4, 0], rc[::4, 1]])[:, None]
            heads[rb * BLOCK:(rb + 1) * BLOCK, cols] = bf16(o)
    with np.errstate(invalid="ignore", over="ignore"):
        y = bf16(xr + (heads @ wproj + bproj))
    return y[:n]


def mirror(x, w, b, wqkv, bqkv, wproj, bproj, bias_mask, nh, n, mode, trap=False):
    """y of every window of (B, T, C) x, window m of an image taking bias
    row m % nW."""
    bsz, t, _ = x.shape
    bias = bias_mask - np.float32(av.SOFTMAX_SHIFT)
    y = np.zeros_like(x)
    for i in range(bsz):
        for m in range(t // n):
            sl = slice(m * n, (m + 1) * n)
            y[i, sl] = window_y(x[i, sl], w[i], b[i], wqkv, bqkv, wproj, bproj,
                                bias[m % bias.shape[0]], nh, n, mode, trap)
    return y


def _inputs(n, t, c, nh, nwb, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return [bf16(f(1, t, c, sc=0.5)), 1 + f(1, c, sc=0.1), f(1, c, sc=0.1),
            bf16(f(c, 3 * c, sc=c ** -0.5)), bf16(f(3 * c, sc=0.1)), bf16(f(c, c, sc=c ** -0.5)),
            bf16(f(c, sc=0.1)), f(nwb, nh, n, n, sc=0.3)]


def _plain(args, nh, n, mode) -> np.ndarray:
    ta = [torch.from_numpy(a) for a in args]
    for i in (0, 3, 4, 5, 6):  # x and the weights in bf16; the affine and bias f32
        ta[i] = ta[i].bfloat16()
    return av.attn_variant_plain(*ta, nh, n, mode).float().numpy()


@pytest.mark.parametrize("mode", av.SOFTMAX_MODES)
@pytest.mark.parametrize("n,c,nh,nwb", [(64, 64, 2, 1), (49, 48, 3, 2), (16, 64, 2, 2),
                                        (16, 48, 3, 1)])
def test_mirror_matches_plain(mode, n, c, nh, nwb):
    args = _inputs(n, 2 * n, c, nh, nwb, seed=n + c)
    got, want = mirror(*args, nh, n, mode), _plain(args, nh, n, mode)
    assert np.isfinite(got).all()
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)  # one bf16 step
    assert np.abs(got - want).max() <= step


@pytest.mark.parametrize("mode", ["noexp", "none"])
@pytest.mark.parametrize("n", [64, 49, 16])
def test_mirror_catches_the_masked_key_trap(mode, n):
    """Masked keys left at -inf poison noexp's row sum and none's p v
    wherever N < 64; a full window has no masked key."""
    args = _inputs(n, 2 * n, 48, 3, 1, seed=7)
    with np.errstate(invalid="ignore", over="ignore"):
        trapped = mirror(*args, 3, n, mode, trap=True)
    if n == ROWS:
        np.testing.assert_array_equal(trapped, mirror(*args, 3, n, mode))
    else:
        assert not np.isfinite(trapped).all()
