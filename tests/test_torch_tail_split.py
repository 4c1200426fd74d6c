"""A numpy mirror of kernel F's three CUDA kernels (ops/tail.py), run on the
CPU: the statistics pass `gn_stats` and the FMA route's channel split
(csrc/gn_silu_conv3x3.cu), and the tensor-core route `gn_silu_conv3x3_tc`
(csrc/gn_silu_conv3x3_tc.cu).

The mirrors read the kernels' `constexpr int` constants and pin them: a
retiled kernel fails here until its mirror follows.
  * The plans: `gn_stats` cuts every (image, channel) plane into slices
    (each element in one slice), the FMA route cuts the channels into
    slices of whole chunks, and at the four production shapes each kernel
    of the route the shape takes runs at least 132 CTAs (the H100's SMs).
  * The statistics: each slice summed in its threads' order, a butterfly in
    each warp, the warps in order, the slices in order, then the fold; held
    against the JAX package's `group_norm_fold` (rtol 1e-4 on w, as
    tests/test_torch_tail.py holds the plain fold).
  * The tensor-core route, CTA by CTA: where each activated element lands in
    shared memory (16-byte loads for halo columns 1-64, 4 channels a lane,
    elements for the two edge columns, the swizzle and the odd row pitch), that every halo element is written
    exactly once and the 8-byte stores and ldmatrix reads do not conflict
    in the banks, the taps as B fragments with co padded to 8, each lane's
    ldmatrix row address at the shifted halo pixel, the mma.sync m16n8k16
    fragments and the epilogue; held against `tail_pallas.gn_silu_conv3x3`
    (its XLA composition `_reference` on the CPU) at C 64, 128, 160 and co
    3, 8 with a non-zero GroupNorm bias, within the card tests' bf16 band
    (2^-6 of the largest output).  Shared memory starts as NaN, so a read of
    a byte the staging never wrote shows in the output.
  * The route: bf16 at C % 16 == 0 takes the tensor cores, anything else the
    FMA kernel, a CPU tensor the plain version.
The kernels themselves run only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resshift_tpu.models.layers import group_norm_fold as jfold
from resshift_tpu.ops.tail_pallas import gn_silu_conv3x3 as jtail
from resshift_tpu_torch.ops import tail

CSRC = Path(__file__).resolve().parents[1] / "resshift_tpu_torch" / "csrc"
SMS = 132  # the H100 SXM's SMs
SMEM_MAX = 232448  # bytes of shared memory a CTA can opt into
BAND = 2 ** -6  # the card tests' bf16 band, relative to the largest output
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
PAIR = np.stack([2 * T, 2 * T + 1], 1)  # (32, 2): the two columns a lane holds

# the production shapes (B, C, H, W, co, dtype): UNet head at a tile batch of
# 8, faceir's head, the f4 decoder tail at a tile batch of 8, the f8 tail
PRODUCTION = [(8, 160, 64, 64, 3, torch.float32), (1, 160, 64, 64, 8, torch.float32),
              (8, 128, 256, 256, 3, torch.bfloat16), (1, 64, 512, 512, 3, torch.bfloat16)]


def constants(name: str) -> dict:
    """The file-level `constexpr int` constants of csrc/<name>.cu, in order
    (several a line allowed)."""
    env: dict = {}
    for decl in re.findall(r"^constexpr int ([^;]+);", (CSRC / f"{name}.cu").read_text(), re.M):
        for part in re.split(r",\s*(?=\w+\s*=)", decl):
            key, expr = part.split("=", 1)
            env[key.strip()] = int(eval(expr, {"__builtins__": {}}, dict(env)))
    return env


K = constants("gn_silu_conv3x3")
KT = constants("gn_silu_conv3x3_tc")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ------------------------------------------------------------------ plans


def stats_plan(planes: int, hw: int, esize: int) -> tuple[int, int]:
    """(slices, slice length) as gn_silu_conv3x3.cu `stats_plan` cuts a plane."""
    max_len, min_len = K["SLICE_MAX_BYTES"] // esize, K["SLICE_MIN_BYTES"] // esize
    lo = cdiv(hw, max_len)
    hi = max(lo, cdiv(hw, min_len))
    s = min(hi, max(lo, cdiv(K["TARGET_CTAS"], planes)))
    length = cdiv(cdiv(hw, s), K["SLICE_ALIGN"]) * K["SLICE_ALIGN"]
    return cdiv(hw, length), length


def fma_plan(b: int, c: int, h: int, w: int) -> tuple[int, int, int, int]:
    """(tiles, chunks, chunks a slice, slices) as `fma_plan` cuts the work."""
    tiles = b * cdiv(h, K["TH"]) * cdiv(w, K["TW"])
    chunks = cdiv(c, K["CC"])
    want = min(cdiv(K["TARGET_CTAS"], tiles), chunks)
    cps = cdiv(chunks, want)
    return tiles, chunks, cps, cdiv(chunks, cps)


def tc_ctas(b: int, h: int, w: int) -> int:
    return b * cdiv(h, KT["TH"]) * cdiv(w, KT["TW"])


def tc_smem(c: int) -> int:
    """gn_silu_conv3x3_tc.cu smem_bytes: the halo tile, the taps (9 x 8 rows of
    C padded to KC, plus 8), the affine."""
    return KT["A_BYTES"] + 9 * 8 * (cdiv(c, KT["KC"]) * KT["KC"] + 8) * 2 + 2 * c * 4


def test_constants_are_the_mirrors():
    """The mirrors were written for these; a retiled kernel fails here until
    the mirror follows."""
    assert K == {"STATS_THREADS": 256, "SLICE_MAX_BYTES": 32768, "SLICE_MIN_BYTES": 4096,
                 "SLICE_ALIGN": 8, "TARGET_CTAS": 528, "FOLD_THREADS": 128, "TW": 32, "RPT": 2,
                 "RG": 4, "TH": 8, "THREADS": 128, "CC": 16, "SH": 10, "SW": 34, "TILE_PIX": 256,
                 "BATCH": 8}
    assert KT == {"THREADS": 256, "TH": 16, "TW": 64, "KC": 32, "HR": 18, "HC": 66, "PW": 67,
                  "RB": 64, "A_BYTES": 77184, "VEC_ITEMS": 1152, "BATCH": 8, "WROWS": 8}
    # the FMA kernel's static shared memory: the activated chunk and its taps
    assert (K["CC"] * K["SH"] * K["SW"] + K["CC"] * 9 * 8) * 4 <= 48 * 1024
    # two tensor-core CTAs an SM at the production widths (228 KB an SM, 1 KB
    # reserved a CTA)
    assert 2 * (tc_smem(160) + 1024) <= 228 * 1024


def test_tc_max_c_is_the_shared_memory_limit():
    """ops/tail.py routes bf16 to the tensor cores up to the largest C % 16 ==
    0 whose shared memory fits a CTA."""
    fits = [c for c in range(16, 2048, 16) if tc_smem(c) <= SMEM_MAX]
    assert tail._TC_MAX_C == max(fits)


@pytest.mark.parametrize("planes", [1, 64, 160, 1024, 1280, 5000])
@pytest.mark.parametrize("hw", [1, 35, 960, 4096, 65536, 262144, 262147])
@pytest.mark.parametrize("esize", [2, 4])
def test_stats_plan_covers_each_plane(planes, hw, esize):
    """Every element of a plane in exactly one slice, none empty; a slice whole
    16-byte vectors, at most SLICE_MAX_BYTES."""
    slices, length = stats_plan(planes, hw, esize)
    assert length % K["SLICE_ALIGN"] == 0 and length * esize <= K["SLICE_MAX_BYTES"]
    assert (slices - 1) * length < hw <= slices * length


@pytest.mark.parametrize("c", [8, 24, 64, 128, 160, 200])
@pytest.mark.parametrize("b,h,w", [(1, 5, 7), (1, 64, 64), (8, 64, 64), (3, 33, 70)])
def test_fma_plan_covers_the_channels(b, c, h, w):
    """Each chunk of CC channels in exactly one slice, none empty."""
    tiles, chunks, cps, slices = fma_plan(b, c, h, w)
    assert (slices - 1) * cps < chunks <= slices * cps
    assert slices == chunks or 2 * tiles * slices >= K["TARGET_CTAS"]


@pytest.mark.parametrize("b,c,h,w,co,dt", PRODUCTION)
def test_plans_fill_the_card(b, c, h, w, co, dt):
    """At the production shapes the statistics pass and the conv of the route
    the shape takes each run at least one CTA an SM."""
    route = tail.tail_route("cuda", dt, c, co)
    assert route == ("tc" if dt == torch.bfloat16 else "fma")
    slices, _ = stats_plan(b * c, h * w, 2 if dt == torch.bfloat16 else 4)
    assert b * c * slices >= SMS
    if route == "tc":
        assert tc_ctas(b, h, w) >= SMS
    else:
        tiles, _, _, fslices = fma_plan(b, c, h, w)
        assert tiles * fslices >= SMS


# ------------------------------------------------------------- statistics


def slice_order(n: int, vec: int) -> tuple[np.ndarray, np.ndarray]:
    """(steps, STATS_THREADS) element indices of a slice of n elements in the
    order each thread adds them (whole vectors of `vec`, or elements), and
    whether the thread has one at that step."""
    nt = K["STATS_THREADS"]
    units = n // vec
    steps = cdiv(units, nt)
    u = np.arange(steps * nt).reshape(steps, nt)
    idx = (u[:, None, :] * vec + np.arange(vec)[None, :, None]).reshape(steps * vec, nt)
    ok = np.repeat(u < units, vec, axis=0)
    return np.where(ok, idx, 0), ok


def stats_mirror(x: np.ndarray, esize: int) -> tuple[np.ndarray, np.ndarray]:
    """gn_stats_kernel's partial (sum, sum of squares) of (planes, hw) f32
    values, (planes, slices) each: per thread in its order, a butterfly
    within each warp, the warps in order."""
    planes, hw = x.shape
    slices, length = stats_plan(planes, hw, esize)
    vec = 16 // esize if hw % (16 // esize) == 0 else 1
    ps = np.zeros((planes, slices), np.float32)
    pq = np.zeros((planes, slices), np.float32)
    for s in range(slices):
        seg = x[:, s * length:min(hw, (s + 1) * length)]
        idx, ok = slice_order(seg.shape[1], vec)
        acc_s = np.zeros((planes, K["STATS_THREADS"]), np.float32)
        acc_q = np.zeros_like(acc_s)
        for i, m in zip(idx, ok):
            v = np.where(m, seg[:, i], np.float32(0))
            acc_s = acc_s + v
            acc_q = (v.astype(np.float64) ** 2 + acc_q).astype(np.float32)  # fmaf
        acc_s = acc_s.reshape(planes, -1, 32)
        acc_q = acc_q.reshape(planes, -1, 32)
        for o in (16, 8, 4, 2, 1):
            acc_s = acc_s + acc_s[..., LANE ^ o]
            acc_q = acc_q + acc_q[..., LANE ^ o]
        for w in range(acc_s.shape[1]):
            ps[:, s] += acc_s[:, w, 0]
            pq[:, s] += acc_q[:, w, 0]
    return ps, pq


def fold_mirror(ps, pq, scale, bias, b, c, hw, groups, eps):
    """gn_fold_kernel: slices in order, a group's channels in order, then
    fold_stats' arithmetic in f32."""
    f32 = np.float32
    g = min(groups, c)
    cpg = c // g
    sc = np.zeros((b, c), f32)
    qc = np.zeros((b, c), f32)
    for k in range(ps.shape[1]):
        sc += ps[:, k].reshape(b, c)
        qc += pq[:, k].reshape(b, c)
    sg = np.zeros((b, g), f32)
    qg = np.zeros((b, g), f32)
    for j in range(cpg):
        sg += sc[:, j::cpg]
        qg += qc[:, j::cpg]
    n = f32(hw * cpg)
    mean = sg / n
    var = np.maximum(qg / n - mean * mean, f32(0))
    inv = (f32(1) / np.sqrt(var + f32(eps))).astype(f32)
    w = np.repeat(inv, cpg, 1) * scale[None]
    return w, bias[None] - np.repeat(mean, cpg, 1) * w


def _gn_inputs(shape, seed):
    b, c, h, w = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, c, h, w)) * 1.5 + 0.3).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    gbias = (0.5 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, gbias


@pytest.mark.parametrize("shape,dt", [((2, 64, 24, 40), "f32"), ((1, 32, 128, 128), "bf16"),
                                      ((2, 64, 5, 7), "bf16")])
def test_stats_mirror_matches_jax_fold(shape, dt):
    """The split statistics, folded, against `layers.group_norm_fold` on the
    same values (bf16: x rounded first, as both packages read it)."""
    x, scale, gbias = _gn_inputs(shape, sum(shape))
    esize = 4
    if dt == "bf16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
        esize = 2
    b, c, h, w = shape
    ps, pq = stats_mirror(x.reshape(b * c, h * w), esize)
    if h * w >= 4096:
        assert ps.shape[1] > 1  # several slices a plane
    got_w, got_b = fold_mirror(ps, pq, scale, gbias, b, c, h * w, 32, 1e-5)
    jx = jnp.asarray(x.transpose(0, 2, 3, 1))
    if dt == "bf16":
        jx = jx.astype(jnp.bfloat16)
    jw, jb = jfold(jx, jnp.asarray(scale), jnp.asarray(gbias), 32, 1e-5)
    np.testing.assert_allclose(got_w, np.asarray(jw), rtol=1e-4)
    np.testing.assert_allclose(got_b, np.asarray(jb), rtol=1e-4, atol=1e-5)


# ------------------------------------------------- tensor-core route


def swz_row(rb: int, row, chunk):
    """mma.cuh swz_row<RB>: chunk of an RB-byte row, XORed with
    (row / (128 / RB)) % (RB / 16), or with row % 8 where RB >= 128."""
    cpr = min(rb // 16, 8)
    rpl = 8 // cpr
    return row * rb + ((chunk ^ ((row // rpl) & (cpr - 1))) << 4)


def ldsm_x4(mem: np.ndarray, addrs: np.ndarray) -> np.ndarray:
    """ldmatrix .x4 for each warp of `addrs` (warps, 32): lane 8j + i gives
    the byte address of row i of matrix j; lane l receives, in register j,
    row l / 4 and columns 2 (l % 4), 2 (l % 4) + 1 of matrix j.  Returns
    (warps, 32, 4, 2)."""
    assert (addrs % 16 == 0).all()
    mats = mem[addrs[..., None] // 2 + np.arange(8)].reshape(len(addrs), 4, 8, 8)
    return mats[:, :, G[:, None], PAIR].transpose(0, 2, 1, 3)


def mma(acc: np.ndarray, a: np.ndarray, b0: np.ndarray, b1: np.ndarray) -> None:
    """mma.sync m16n8k16 row.col for each warp: acc (warps, 32, 4) += A B.
    Lane l holds A rows l / 4 and l / 4 + 8 at columns 2 (l % 4) + {0, 1} and
    + 8, B rows 2 (l % 4) + {0, 1} and + 8 at column l / 4, D rows l / 4 and
    l / 4 + 8 at columns 2 (l % 4) + {0, 1}."""
    nw = a.shape[0]
    A = np.zeros((nw, 16, 16), np.float32)
    B = np.zeros((16, 8), np.float32)
    g = G[:, None]
    A[:, g, PAIR], A[:, g + 8, PAIR] = a[:, :, 0], a[:, :, 1]
    A[:, g, PAIR + 8], A[:, g + 8, PAIR + 8] = a[:, :, 2], a[:, :, 3]
    B[PAIR, g], B[PAIR + 8, g] = b0, b1
    d = A @ B
    acc[:, :, 0:2] += d[:, g, PAIR]
    acc[:, :, 2:4] += d[:, g + 8, PAIR]


def distinct_banks(addrs: np.ndarray, lanes_per_phase: int, size: int = 16) -> bool:
    """Whether each phase of `lanes_per_phase` lanes reads or writes `size`-byte
    pieces at distinct positions of the 128 bytes of banks (16-byte accesses
    go 8 lanes a phase, 8-byte ones 16)."""
    pos = (addrs.reshape(-1, lanes_per_phase) % 128) // size
    return all(len(set(p)) == lanes_per_phase for p in pos)


def vector_items():
    """The tensor-core kernel's 16-byte staging, one warp item (32 lanes) at a
    time: each lane's 4-channel group, halo row and 8-pixel vector.  Thread t
    takes items t, t + THREADS, ...; lane bits (channel group, row bit,
    vector bit), then the warp item's row pair and vector pair."""
    out = []
    for base in range(0, KT["VEC_ITEMS"], 32):
        item = base + LANE
        wid = item >> 5
        out.append({"c4": item & 7, "hr": 2 * (wid % (KT["HR"] // 2)) + ((item >> 3) & 1),
                    "v": (wid // (KT["HR"] // 2)) * 2 + ((item >> 4) & 1)})
    return out


def vector_store_addrs(item: dict, j: int) -> np.ndarray:
    """Each lane's 8-byte store of pixel j of its item: 4 channels."""
    return (swz_row(KT["RB"], item["hr"] * KT["PW"] + 1 + 8 * item["v"] + j, item["c4"] >> 1)
            + (item["c4"] & 1) * 8)


def stage_chunk(act: np.ndarray, y0: int, x0: int, c0: int, vec: bool):
    """The CTA's halo tile of channels c0.. c0 + KC of the activated image
    `act` (C, H, W), as the kernel stages it: shared memory as bf16 values
    indexed by byte / 2 (NaN where nothing was written) and how many times
    each (halo pixel, channel) was written."""
    c, h, w = act.shape
    hr_n, hc_n, pw, kc, rb = KT["HR"], KT["HC"], KT["PW"], KT["KC"], KT["RB"]
    mem = np.full(KT["A_BYTES"] // 2, np.nan, np.float32)
    count = np.zeros((hr_n, hc_n, kc), int)

    def value(hr, hc, cc):
        gy, gx, ch = y0 - 1 + hr, x0 - 1 + hc, c0 + cc
        inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w) & (ch < c)
        return np.where(inside, act[np.clip(ch, 0, c - 1), np.clip(gy, 0, h - 1),
                                    np.clip(gx, 0, w - 1)], 0.0)

    def put_elem(hr, hc, cc):
        addr = swz_row(rb, hr * pw + hc, cc >> 3) + (cc & 7) * 2
        mem[addr // 2] = value(hr, hc, cc)
        np.add.at(count, (hr, hc, cc), 1)

    if vec:
        for item in vector_items():  # columns 1..64: one 8-byte store a pixel
            for j in range(8):
                addrs = vector_store_addrs(item, j)
                hc = 1 + 8 * item["v"] + j
                for i in range(4):
                    mem[addrs // 2 + i] = value(item["hr"], hc, 4 * item["c4"] + i)
                    np.add.at(count, (item["hr"], hc, 4 * item["c4"] + i), 1)
        i = np.arange(kc // 2 * hr_n * 2)  # columns 0 and 65: two channels a lane
        cc, hr, hc = 2 * (i // (2 * hr_n)), (i % (2 * hr_n)) >> 1, np.where(i & 1, hc_n - 1, 0)
        for half in range(2):
            put_elem(hr, hc, cc + half)
    else:
        i = np.arange(kc * hr_n * hc_n)
        j = i % (hr_n * hc_n)
        put_elem(j // hc_n, j % hc_n, i // (hr_n * hc_n))
    return mem, count


def test_smem_accesses_do_not_conflict():
    """The tensor-core route's 8-byte stores of the staged halo (16 lanes a
    phase: 8 channel groups x 2 rows an odd pitch apart) and its ldmatrix
    reads (8 consecutive shifted pixels a matrix) each fill the 32 banks
    once."""
    pw, rb = KT["PW"], KT["RB"]
    for item in vector_items():
        for j in range(8):
            assert distinct_banks(vector_store_addrs(item, j), 16, size=8)
    for warp in range(KT["THREADS"] // 32):
        q, rh = warp & 3, warp >> 2
        for hr in range(KT["WROWS"] + 2):
            for dx in range(3):
                p = (KT["WROWS"] * rh + hr) * pw + 16 * q + dx + (LANE & 15)
                for ks in range(KT["KC"] // 16):
                    assert distinct_banks(swz_row(rb, p, 2 * ks + (LANE >> 4)), 8)


def tc_emulated(act: np.ndarray, weight: np.ndarray, bias: np.ndarray, vec: bool) -> np.ndarray:
    """gn_silu_conv3x3_tc_kernel on one image's activated tensor (C, H, W),
    bf16 values, to (co, H, W), CTA by CTA, chunk by chunk."""
    c, h, w = act.shape
    co = weight.shape[0]
    th, tw, kc, pw, rb, wrows = (KT[n] for n in ("TH", "TW", "KC", "PW", "RB", "WROWS"))
    nw = KT["THREADS"] // 32
    tp = cdiv(c, kc) * kc + 8
    bs = np.zeros((9 * 8, tp), np.float32)  # bs[tap * 8 + o, c]
    bs.reshape(9, 8, tp)[:, :co, :c] = weight.reshape(co, c, 9).transpose(2, 0, 1)
    q, rh = np.arange(nw) & 3, np.arange(nw) >> 2
    y = np.full((co, h, w), np.nan, np.float32)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            acc = np.zeros((nw, wrows, 32, 4), np.float32)
            for c0 in range(0, c, kc):
                mem, count = stage_chunk(act, y0, x0, c0, vec)
                assert (count == 1).all()  # every halo element exactly once
                for ks in range(kc // 16):
                    kg = c0 + 16 * ks
                    if kg >= c:
                        break
                    bfr = []  # each tap's b0, b1: lane l holds output channel l / 4
                    for tap in range(9):
                        row = bs[tap * 8 + G]  # (32, tp)
                        bfr.append((row[LANE[:, None], kg + PAIR],
                                    row[LANE[:, None], kg + 8 + PAIR]))
                    for dx in range(3):
                        for hr in range(wrows + 2):
                            p = (((wrows * rh + hr) * pw + 16 * q)[:, None] + dx
                                 + (LANE & 15))
                            a = ldsm_x4(mem, swz_row(rb, p, 2 * ks + (LANE >> 4)))
                            for dy in range(3):
                                if 0 <= hr - dy < wrows:
                                    mma(acc[:, hr - dy], a, *bfr[dy * 3 + dx])
            for warp in range(nw):  # the epilogue's (pixel, channel) of each register
                for r in range(wrows):
                    gy = y0 + wrows * rh[warp] + r
                    if gy >= h:
                        continue
                    for hh in range(2):
                        gx = x0 + 16 * q[warp] + G + 8 * hh
                        for e in range(2):
                            o = 2 * T + e
                            ok = (gx < w) & (o < co)
                            v = bf16(bf16(acc[warp, r, :, 2 * hh + e])
                                     + bias[np.minimum(o, co - 1)])
                            y[o[ok], gy, gx[ok]] = v[ok]
    return y


def bf16(a) -> np.ndarray:
    """Round to bf16 (nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _tail_inputs(c, co, hw, seed, b=1):
    rng = np.random.default_rng(seed)
    x = bf16((rng.standard_normal((b, c) + hw) * 1.5 + 0.3))
    scale = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    gbias = (0.5 + 0.3 * rng.standard_normal(c)).astype(np.float32)  # silu(bias) != 0
    weight = bf16(rng.standard_normal((co, c, 3, 3)) / np.sqrt(9 * c))
    cbias = bf16(0.1 * rng.standard_normal(co))
    return x, scale, gbias, weight, cbias


@pytest.mark.parametrize("c,co,hw,vec", [(64, 3, (20, 72), True), (128, 8, (18, 64), True),
                                         (160, 3, (9, 70), False), (160, 8, (16, 80), True)])
def test_tc_route_emulation_matches_jax(c, co, hw, vec):
    """The tensor-core route's index maps and fragments, on the activated
    tensor the plain version computes from the mirrored statistics, against
    the JAX package's tail; the 16-byte path where W % 8 == 0, the element
    path elsewhere; ragged tiles at the bottom and right."""
    assert (hw[1] % 8 == 0) == vec
    x, scale, gbias, weight, cbias = _tail_inputs(c, co, hw, c + co)
    assert tail.tail_route("cuda", torch.bfloat16, c, co) == "tc"
    ps, pq = stats_mirror(x.reshape(c, -1), 2)
    w, b = fold_mirror(ps, pq, scale, gbias, 1, c, hw[0] * hw[1], 32, 1e-6)
    xt = torch.from_numpy(x).bfloat16()
    a = (xt.float() * torch.from_numpy(w)[..., None, None]
         + torch.from_numpy(b)[..., None, None]).bfloat16()
    act = (a * (1 / (1 + torch.exp(-a)))).float().numpy()[0]  # the plain version's SiLU
    got = tc_emulated(act, weight, cbias, vec)
    jx = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jnp.bfloat16)
    want = np.asarray(jtail(jx, jnp.asarray(scale), jnp.asarray(gbias),
                            jnp.asarray(weight.transpose(2, 3, 1, 0)), jnp.asarray(cbias),
                            eps=1e-6).astype(jnp.float32))[0].transpose(2, 0, 1)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= 1e-5 + BAND * np.abs(want).max(), err


def test_approximate_reciprocal_rounds_as_the_exact_one():
    """The kernel takes 1 / v with rcp.approx (at most 1 ulp off) where the
    plain version divides exactly: for every finite bf16 v >= 1 (v = 1 + e),
    the exact f32 quotient lies at least 129 ulps from the nearest midpoint
    of two bf16 values, so both round to the same bf16."""
    bits = np.arange(0x3F80, 0x7F80, dtype=np.uint32) << 16  # 1 .. the largest finite
    r = np.float32(1) / bits.view(np.float32)
    rb = r.view(np.uint32)
    assert np.abs((rb & 0xFFFF).astype(np.int64) - 0x8000).min() >= 129
    for step in (-1, 1):  # one ulp either way rounds to the same bf16
        assert np.array_equal(bf16((rb.astype(np.int64) + step).astype(np.uint32)
                                   .view(np.float32)), bf16(r))


def test_bf16x2_silu_steps_round_once():
    """The kernel runs 1 + e and a * r as bf16x2 operations, one rounding to
    bf16 of the exact result, where the plain version rounds the f32 result
    to bf16.  The same bits: for every finite bf16 e >= 0, bf16(f32(1 + e))
    equals bf16 of the sum in f64 (exact below 2^53, and above it both give
    e); for bf16 a and r, the f32 product is exact."""
    bits = np.arange(0x8000, dtype=np.uint32) << 16  # every non-negative bf16
    e = bits.view(np.float32)
    e = e[np.isfinite(e)]
    via_f32 = bf16(np.float32(1) + e)
    exact = bf16((np.float64(1) + e.astype(np.float64)).astype(np.float32))
    assert np.array_equal(via_f32, exact)
    rng = np.random.default_rng(0)
    a, r = (bf16(rng.standard_normal(200000) * 10.0 ** rng.uniform(-6, 6, 200000))
            for _ in range(2))
    assert np.array_equal((a * r).astype(np.float64), a.astype(np.float64) * r.astype(np.float64))


# ------------------------------------------------------------------ route


@pytest.mark.parametrize("c,dt,want", [(64, torch.bfloat16, "tc"), (128, torch.bfloat16, "tc"),
                                       (160, torch.bfloat16, "tc"), (992, torch.bfloat16, "tc"),
                                       (1008, torch.bfloat16, "fma"), (24, torch.bfloat16, "fma"),
                                       (40, torch.bfloat16, "fma"), (8, torch.bfloat16, "fma"),
                                       (160, torch.float32, "fma"), (64, torch.float32, "fma")])
def test_route_by_dtype_and_width(c, dt, want):
    for co in (1, 3, 8):
        assert tail.tail_route("cuda", dt, c, co) == want
        assert tail.tail_route("cuda", dt, c, co, use_pallas=False) == "plain"
        assert tail.tail_route("cpu", dt, c, co) == "plain"


def test_route_raises_off_the_kernels():
    with pytest.raises(ValueError):
        tail.tail_route("cuda", torch.bfloat16, 64, 9)
    with pytest.raises(ValueError):
        tail.tail_route("cuda", torch.float32, 64, 0)
    with pytest.raises(TypeError):
        tail.tail_route("cuda", torch.float16, 64, 3)
    with pytest.raises(RuntimeError, match="no kernel"):
        tail.tail_route("meta", torch.float32, 64, 3)


def test_gn_stats_on_the_cpu_is_the_plain_fold():
    """gn_stats, the statistics kernel's wrapper, takes the plain version for a
    CPU tensor and launches nothing."""
    x, scale, gbias = (torch.from_numpy(a) for a in _gn_inputs((2, 64, 6, 10), 1))
    n = tail.GN_STATS.launches
    got = tail.gn_stats(x, scale, gbias, eps=1e-6)
    want = tail.group_norm_fold(x, scale, gbias, eps=1e-6)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tail.GN_STATS.launches == n
