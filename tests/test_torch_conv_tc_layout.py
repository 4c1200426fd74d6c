"""A numpy mirror of the index maps of the two tensor-core conv kernels,
csrc/conv3x3_tc.cu (probe P1) and csrc/winograd_conv3x3_tc.cu (kernel K10),
run on the CPU.

The mirror follows each kernel's staging (where each 16-byte chunk of the
input patch, the taps or U lands in shared memory, with the XOR swizzle),
each lane's ldmatrix row address, the ldmatrix and mma.sync m16n8k16
fragment layouts (products of bf16-rounded values summed in f32), which
(pixel or tile, channel, position) each accumulator register holds, and
K10's input transform and epilogue.  A conv run through it must match
`conv3x3_plain` and `winograd_conv3x3_plain` within the card tests' bf16
band at small ragged shapes.  Shared memory starts as NaN, so a read of a
byte the staging never wrote shows in the output.

The tile constants (`constexpr int ...`) are read from the two sources and
pinned: a change of tiling fails here until the mirror follows.  K10's
mirror also runs the other tilings that `tools/profile_winograd_tilings.py`
builds from the same source.  The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from resshift_tpu_torch.ops import conv3x3 as cv
from resshift_tpu_torch.ops import winograd as wg
from resshift_tpu_torch.tools import profile_winograd_tilings as tilings

CSRC = Path(__file__).resolve().parents[1] / "resshift_tpu_torch" / "csrc"
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
PAIR = np.stack([2 * T, 2 * T + 1], 1)  # (32, 2): the two columns a lane holds
BAND = 2 ** -6  # the card tests' bf16 band, relative to the largest output

# the constants each mirror below was written for
P1_TILING = {"THREADS": 128, "PIX": 128, "CO_BLK": 64, "KC": 16, "WM": 64, "WN": 32, "RB": 32,
             "W_BYTES": 18432}
K10_TILING = {"THREADS": 512, "TILES": 32, "CO_BLK": 64, "KC": 32, "RB": 64, "U_BYTES": 65536,
              "V_BYTES": 32768, "P_PIX": 264, "P_BYTES": 16896, "STAGES": 230400, "M_LD": 72,
              "M_BYTES": 147456, "SMEM": 230400}


def constants(name: str, src: str | None = None) -> dict:
    """The `constexpr int` constants of csrc/<name>.cu (or of the source
    text `src`), evaluated in order."""
    env: dict = {}
    src = (CSRC / f"{name}.cu").read_text() if src is None else src
    for key, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        if "?" in expr:  # a ? b : c
            cond, rest = expr.split("?")
            yes, no = rest.split(":")
            expr = f"({yes}) if ({cond}) else ({no})"
        env[key] = int(eval(expr, {"__builtins__": {}}, dict(env)))
    return env


def swz(line, row, chunk):
    """mma.cuh swz: chunk of a 128-byte line, XORed with row % 8."""
    return line * 128 + ((chunk ^ (row & 7)) << 4)


def swz_row(rb: int, row, chunk):
    """mma.cuh swz_row<RB>: chunk of an RB-byte row, XORed with
    (row / (128 / RB)) % (RB / 16), or with row % 8 where RB >= 128."""
    cpr = min(rb // 16, 8)
    rpl = 8 // cpr
    return row * rb + ((chunk ^ ((row // rpl) & (cpr - 1))) << 4)


def bf16(a) -> np.ndarray:
    """Round to bf16 (nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def put(mem: np.ndarray, byte: int, vals) -> None:
    """Store 8 bf16 values (a 16-byte chunk) at byte offset `byte`."""
    assert byte % 16 == 0
    mem[byte // 2:byte // 2 + 8] = vals


def ldsm_x4(mem: np.ndarray, addrs, trans: bool = False) -> np.ndarray:
    """ldmatrix .x4 (.trans): lane 8j + i gives the byte address of row i of
    matrix j; lane l receives, in register j, row l / 4 and columns
    2 (l % 4), 2 (l % 4) + 1 of matrix j (of its transpose with .trans).
    Returns (32, 4, 2)."""
    addrs = np.asarray(addrs)
    assert addrs.shape == (32,) and (addrs % 16 == 0).all()
    mats = mem[addrs[:, None] // 2 + np.arange(8)].reshape(4, 8, 8)
    if trans:
        mats = mats.transpose(0, 2, 1)
    return mats[:, G[:, None], PAIR].transpose(1, 0, 2)


def mma(acc: np.ndarray, a: np.ndarray, b0: np.ndarray, b1: np.ndarray) -> None:
    """mma.sync m16n8k16 row.col: acc (32, 4) += A B.  Lane l holds A rows
    l / 4 and l / 4 + 8 at columns 2 (l % 4) + {0, 1} and + 8 (a: 4
    registers of 2 values), B rows 2 (l % 4) + {0, 1} and + 8 at column l / 4
    (b0, b1), D rows l / 4 and l / 4 + 8 at columns 2 (l % 4) + {0, 1}."""
    A = np.zeros((16, 16), np.float32)
    B = np.zeros((16, 8), np.float32)
    g = G[:, None]
    A[g, PAIR], A[g + 8, PAIR], A[g, PAIR + 8], A[g + 8, PAIR + 8] = (a[:, j] for j in range(4))
    B[PAIR, g], B[PAIR + 8, g] = b0, b1
    d = A @ B
    acc[:, 0:2] += d[g, PAIR]
    acc[:, 2:4] += d[g + 8, PAIR]


def _inputs(shape, seed):
    bsz, h, w, c, co = shape
    rng = np.random.default_rng(seed)
    x = bf16(0.3 * rng.standard_normal((bsz, h, w, c)))
    wk = bf16(rng.standard_normal((3, 3, c, co)) / np.sqrt(9 * c))
    return x, wk, (0.1 * rng.standard_normal(co)).astype(np.float32)


def _close(got: np.ndarray, want: torch.Tensor) -> None:
    want = want.float().numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= 1e-5 + BAND * np.abs(want).max(), err


# ------------------------------------------------------------------ P1


def p1_a_rows(k: dict, rows: int, wm: int, mt: int, tap: int) -> np.ndarray:
    """Each lane's ldmatrix row address (bytes into the patch) for the A
    operand of m-tile `mt` of warp row `wm` at tap `tap`: output pixel
    p = WM wm + 16 mt + (l & 15) reads patch pixel (p / cols + dy, p % cols
    + dx), channel chunk l >> 4."""
    cols = k["PIX"] // rows
    pw = cols + 2
    p = wm * k["WM"] + mt * 16 + (LANE & 15)
    pos = (p // cols) * pw + p % cols + (tap // 3) * pw + tap % 3
    return swz_row(k["RB"], pos, LANE >> 4)


def p1_emulated(x: np.ndarray, wk: np.ndarray, rows: int) -> np.ndarray:
    """conv3x3_tc_kernel, CTA by CTA, chunk by chunk."""
    k = constants("conv3x3_tc")
    bsz, h, wd, c = x.shape
    co_n = wk.shape[-1]
    kc, rb, wbytes, co_blk, wm_px, wn_co = (k[n] for n in ("KC", "RB", "W_BYTES", "CO_BLK", "WM",
                                                            "WN"))
    cols = k["PIX"] // rows
    pw, npp = cols + 2, (rows + 2) * (cols + 2)
    taps = wk.reshape(9, c, co_n)
    nco, tiles_w, tiles_h = -(-co_n // co_blk), -(-wd // cols), -(-h // rows)
    nwarps = k["THREADS"] // 32
    y = np.full((bsz, h, wd, co_n), np.nan, np.float32)
    b_row = (LANE & 7) + (((LANE >> 3) & 1) << 3)
    for blk in range(bsz * tiles_h * tiles_w * nco):
        co0 = (blk % nco) * co_blk
        x0 = (blk // nco % tiles_w) * cols
        y0 = (blk // nco // tiles_w % tiles_h) * rows
        bi = blk // nco // tiles_w // tiles_h
        acc = np.zeros((nwarps, wm_px // 16, wn_co // 8, 32, 4), np.float32)
        for c0 in range(0, c, kc):
            mem = np.full((wbytes + npp * rb) // 2, np.nan, np.float32)
            for kk in range(9 * kc):  # taps: line kk = tap * KC + c
                tap, cc = divmod(kk, kc)
                for ch in range(8):
                    co = co0 + ch * 8 + np.arange(8)
                    ok = (c0 + cc < c) & (co < co_n)
                    put(mem, swz(kk, kk, ch),
                        np.where(ok, taps[tap, min(c0 + cc, c - 1), np.minimum(co, co_n - 1)], 0))
            for pp in range(npp):  # the patch, zero outside the image
                r, s = y0 + pp // pw - 1, x0 + pp % pw - 1
                for ch in range(kc // 8):
                    cc = c0 + ch * 8 + np.arange(8)
                    ok = (0 <= r < h) and (0 <= s < wd)
                    vals = np.where(ok & (cc < c),
                                    x[bi, min(max(r, 0), h - 1), min(max(s, 0), wd - 1),
                                      np.minimum(cc, c - 1)], 0)
                    put(mem, wbytes + swz_row(rb, pp, ch), vals)
            for warp in range(nwarps):
                wm, wn = warp >> 1, warp & 1
                if co0 + wn * wn_co >= co_n:
                    continue  # all 32 channels past Co: no products
                b_ch = wn * (wn_co // 8) + (LANE >> 4)
                for tap in range(9):
                    af = [ldsm_x4(mem, wbytes + p1_a_rows(k, rows, wm, mt, tap))
                          for mt in range(wm_px // 16)]
                    line = tap * kc + b_row
                    for nb in range(wn_co // 16):
                        b = ldsm_x4(mem, swz(line, line, b_ch + 2 * nb), trans=True)
                        for mt in range(wm_px // 16):
                            mma(acc[warp, mt, 2 * nb], af[mt], b[:, 0], b[:, 1])
                            mma(acc[warp, mt, 2 * nb + 1], af[mt], b[:, 2], b[:, 3])
        for warp in range(nwarps):  # the epilogue's (pixel, channel) of each register
            wm, wn = warp >> 1, warp & 1
            if co0 + wn * wn_co >= co_n:
                continue
            for mt in range(wm_px // 16):
                for hr in range(2):
                    p = wm * wm_px + mt * 16 + G + 8 * hr
                    r, s = y0 + p // cols, x0 + p % cols
                    for nt in range(wn_co // 8):
                        for cc in range(2):
                            co = co0 + wn * wn_co + nt * 8 + 2 * T + cc
                            ok = (r < h) & (s < wd) & (co < co_n)
                            y[bi, r[ok], s[ok], co[ok]] = acc[warp, mt, nt, ok, 2 * hr + cc]
    return bf16(y)


def test_p1_tiling_is_mirrored():
    k = constants("conv3x3_tc")
    assert k == P1_TILING
    assert k["THREADS"] == 32 * (k["PIX"] // k["WM"]) * (k["CO_BLK"] // k["WN"])
    assert k["RB"] == 2 * k["KC"] and k["KC"] == 16  # one k16 step a tap


@pytest.mark.parametrize("rows", [1, 2, 4, 8, 16, 32, 64, 128])
def test_p1_ldmatrix_rows_point_at_the_shifted_patch_pixel(rows):
    """Every lane's A row address, unswizzled, is patch pixel (p / cols + dy,
    p % cols + dx) of its output pixel p at its channel chunk; where the
    tile's rows are at least 8 pixels wide, the eight rows of each ldmatrix
    matrix fall in eight different bank groups."""
    k = constants("conv3x3_tc")
    rb, cols = k["RB"], k["PIX"] // rows
    cpr, rpl = rb // 16, 8 // (rb // 16)
    for wm in range(k["PIX"] // k["WM"]):
        for mt in range(k["WM"] // 16):
            p = wm * k["WM"] + mt * 16 + (LANE & 15)
            for tap in range(9):
                addr = p1_a_rows(k, rows, wm, mt, tap)
                pos = addr // rb
                chunk = ((addr % rb) >> 4) ^ ((pos // rpl) & (cpr - 1))
                want = (p // cols + tap // 3) * (cols + 2) + p % cols + tap % 3
                assert (pos == want).all() and (chunk == LANE >> 4).all()
                if cols >= 8:
                    banks = (addr // 16 % 8).reshape(4, 8)
                    assert all(len(set(m)) == 8 for m in banks), (rows, tap, banks)


@pytest.mark.parametrize("shape,rows", [
    ((1, 5, 6, 20, 12), None),   # one CTA, C in a chunk and a tail, Co in one warp column
    ((1, 5, 6, 20, 12), 4),      # 32-wide rows: most of the tile past the image
    ((2, 3, 20, 8, 70), 8),      # Co = 70: a second block with one warp column
    ((1, 9, 3, 5, 3), 64),       # C = 5, Co = 3, two-pixel rows
])
def test_p1_emulated_matches_plain(shape, rows):
    x, wk, _ = _inputs(shape, seed=1)
    r = rows if rows is not None else cv._default_rows(shape[2], cv._PIX["tc"])
    got = p1_emulated(x, wk, r)
    _close(got, cv.conv3x3_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(wk).bfloat16()))


# ------------------------------------------------------------------ K10

AT = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], np.float32)  # the output transform A^T


def bt_k(k: int, d0, d1, d2, d3):
    """Output k of the 1-D input transform (winograd_conv3x3_tc.cu bt_k)."""
    return (d0 - d2, d1 + d2, d2 - d1, d1 - d3)[k]


def k10_tcols(w: int, tiles: int) -> int:
    """The tile columns of a CTA, as the kernel's launch picks them: the
    smallest power of two that covers a tile row, at most `tiles`."""
    tcols = tiles
    while tcols > 1 and tcols // 2 >= w // 2:
        tcols //= 2
    return tcols


def k10_epilogue(m: np.ndarray) -> np.ndarray:
    """The epilogue's transform: m (16, ...) -> o (2, 2, ...), each output
    adding its +-1 terms in (uu, vv) order from 0."""
    o = np.zeros((2, 2) + m.shape[1:], np.float32)
    for uu in range(4):
        for vv in range(4):
            for p in range(2):
                for q in range(2):
                    wgt = AT[p, uu] * AT[q, vv]
                    if wgt != 0:
                        o[p, q] = o[p, q] + (m[uu * 4 + vv] if wgt > 0 else -m[uu * 4 + vv])
    return o


def k10_emulated(x: np.ndarray, u: np.ndarray, bias, k: dict | None = None) -> np.ndarray:
    """winograd_tc_kernel, CTA by CTA, chunk by chunk; u (16, C, Co); `k`
    the kernel's constants (default: the shipped source's)."""
    k = constants("winograd_conv3x3_tc") if k is None else k
    bsz, h, wd, c = x.shape
    co_n = u.shape[-1]
    tiles, kc, rb, co_blk, m_ld = (k[n] for n in ("TILES", "KC", "RB", "CO_BLK", "M_LD"))
    tcols = k10_tcols(wd, tiles)
    trows, h2, w2 = tiles // tcols, h // 2, wd // 2
    pw, npp = 2 * tcols + 2, (2 * trows + 2) * (2 * tcols + 2)
    assert npp <= k["P_PIX"] and k["THREADS"] == 32 * 16  # warp e computes position e
    nco, ntc, ntr = -(-co_n // co_blk), -(-w2 // tcols), -(-h2 // trows)
    y = np.full((bsz, h, wd, co_n), np.nan, np.float32)
    a_row, a_ch = LANE & 15, LANE >> 4
    b_row, b_ch = (LANE & 7) + (((LANE >> 3) & 1) << 3), LANE >> 4
    m_all, cp_all = np.divmod(np.arange(tiles * kc // 2), kc // 2)
    for blk in range(bsz * ntr * ntc * nco):
        co0 = (blk % nco) * co_blk
        tj0 = (blk // nco % ntc) * tcols
        ti0 = (blk // nco // ntc % ntr) * trows
        bi = blk // nco // ntc // ntr
        acc = np.zeros((16, tiles // 16, co_blk // 8, 32, 4), np.float32)
        for c0 in range(0, c, kc):
            mu = np.full(k["U_BYTES"] // 2, np.nan, np.float32)
            mv = np.full(k["V_BYTES"] // 2, np.nan, np.float32)
            mp = np.full(k["P_BYTES"] // 2, np.nan, np.float32)
            for line in range(16 * kc):  # U: row e * KC + c of 2 CO_BLK bytes
                e, cc = divmod(line, kc)
                for ch in range(co_blk // 8):
                    co = co0 + ch * 8 + np.arange(8)
                    ok = (c0 + cc < c) & (co < co_n)
                    put(mu, swz_row(2 * co_blk, line, ch),
                        np.where(ok, u[e, min(c0 + cc, c - 1), np.minimum(co, co_n - 1)], 0))
            for pp in range(npp):  # the patch, zero outside the image
                r, s = 2 * ti0 + pp // pw - 1, 2 * tj0 + pp % pw - 1
                for ch in range(kc // 8):
                    cc = c0 + ch * 8 + np.arange(8)
                    ok = (0 <= r < h) and (0 <= s < wd)
                    vals = np.where(ok & (cc < c),
                                    x[bi, min(max(r, 0), h - 1), min(max(s, 0), wd - 1),
                                      np.minimum(cc, c - 1)], 0)
                    put(mp, swz_row(rb, pp, ch), vals)
            # the input transform: tile m, channels 2 cp and 2 cp + 1
            pr, pc = 2 * (m_all // tcols), 2 * (m_all % tcols)
            word = (cp_all & 3) * 4
            d = [[None] * 4 for _ in range(4)]
            for a in range(4):
                for b in range(4):
                    idx = (swz_row(rb, (pr + a) * pw + pc + b, cp_all >> 2) + word) // 2
                    d[a][b] = mp[idx[:, None] + np.arange(2)]
            for uu in range(4):
                tr = [bt_k(uu, d[0][b], d[1][b], d[2][b], d[3][b]) for b in range(4)]
                for vv in range(4):
                    idx = ((uu * 4 + vv) * tiles * rb + swz_row(rb, m_all, cp_all >> 2) + word) // 2
                    mv[idx[:, None] + np.arange(2)] = bf16(bt_k(vv, *tr))
            for e in range(16):  # warp e: position e, all tiles and channels
                for kk in range(0, kc, 16):
                    a = [ldsm_x4(mv, e * tiles * rb + swz_row(rb, mt * 16 + a_row, kk // 8 + a_ch))
                         for mt in range(tiles // 16)]
                    line = e * kc + kk + b_row
                    for nb in range(co_blk // 16):
                        if co0 + nb * 16 >= co_n:
                            break
                        b = ldsm_x4(mu, swz_row(2 * co_blk, line, 2 * nb + b_ch), trans=True)
                        for mt in range(tiles // 16):
                            mma(acc[e, mt, 2 * nb], a[mt], b[:, 0], b[:, 1])
                            mma(acc[e, mt, 2 * nb + 1], a[mt], b[:, 2], b[:, 3])
        # M through shared memory: lane l of warp e holds tiles 16 mt + l / 4
        # (+ 8), channels 8 nt + 2 (l % 4) (+ 1)
        ms = np.full(k["M_BYTES"] // 4, np.nan, np.float32)
        for e in range(16):
            for mt in range(tiles // 16):
                for nt in range(co_blk // 8):
                    for hr in range(2):
                        off = (e * tiles + mt * 16 + G + 8 * hr) * m_ld + nt * 8 + 2 * T
                        ms[off[:, None] + np.arange(2)] = acc[e, mt, nt, :, 2 * hr:2 * hr + 2]
        # A^T M A: item i takes tile i / (CO_BLK / 2), channels 2 (i % (CO_BLK / 2)) (+ 1)
        for i in range(tiles * co_blk // 2):
            m, cl = i // (co_blk // 2), 2 * (i % (co_blk // 2))
            ti, tj, co = ti0 + m // tcols, tj0 + m % tcols, co0 + cl
            if ti >= h2 or tj >= w2 or co >= co_n:
                continue
            mvals = np.stack([ms[(e * tiles + m) * m_ld + cl + np.arange(2)] for e in range(16)])
            o = k10_epilogue(mvals)  # (2, 2, 2): p, q, channel
            if bias is not None:
                o = o + bias[np.minimum(co + np.arange(2), co_n - 1)]
            n = min(2, co_n - co)
            for p in range(2):
                for q in range(2):
                    y[bi, 2 * ti + p, 2 * tj + q, co:co + n] = o[p, q, :n]
    return bf16(y)


def _k10_tiling_holds(k: dict) -> None:
    assert k["THREADS"] == 32 * 16  # one warp a position
    assert k["RB"] == 2 * k["KC"] and k["KC"] % 16 == 0 and k["TILES"] % 16 == 0
    # U's rows of 2 CO_BLK bytes: swz_row takes 32, 64 or a multiple of 128
    assert k["CO_BLK"] % 16 == 0 and (2 * k["CO_BLK"] in (32, 64) or 2 * k["CO_BLK"] % 128 == 0)
    assert k["M_BYTES"] == 16 * k["TILES"] * k["M_LD"] * 4
    assert k["SMEM"] == max(k["STAGES"], k["M_BYTES"])
    # a thread's accumulators: the CTA's (tile, channel) pairs in 16 positions
    assert 16 * k["TILES"] * k["CO_BLK"] // k["THREADS"] <= 64
    # the largest patch over the tile shapes TR x TC = TILES, and shared memory
    tcs = [2 ** i for i in range(10) if 2 ** i <= k["TILES"]]
    assert k["P_PIX"] == max((2 * (k["TILES"] // tc) + 2) * (2 * tc + 2) for tc in tcs)
    assert {k10_tcols(w, k["TILES"]) for w in range(2, 200, 2)} == set(tcs)
    assert k["SMEM"] <= 232448  # the H100's 227 KB a CTA


def test_k10_tiling_is_mirrored():
    k = constants("winograd_conv3x3_tc")
    assert k == K10_TILING
    _k10_tiling_holds(k)


def test_k10_epilogue_is_at_m_a():
    """The epilogue's ordered +-1 sums are A^T M A."""
    m = np.random.default_rng(3).standard_normal((16, 5)).astype(np.float32)
    want = np.einsum("pu,qv,uvn->pqn", AT, AT, m.reshape(4, 4, 5))
    np.testing.assert_allclose(k10_epilogue(m), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [
    (1, 6, 10, 20, 12),   # 5 tiles a row -> 8 columns x 4 rows a CTA; C and Co ragged
    (2, 4, 70, 40, 70),   # 35 tiles a row: two 32-wide strips; two chunks; two Co blocks
    (1, 8, 2, 8, 8),      # one tile a row -> 32 tile rows a CTA
])
@pytest.mark.parametrize("with_bias", [True, False])
def test_k10_emulated_matches_plain(shape, with_bias):
    x, wk, b = _inputs(shape, seed=2)
    bias = b if with_bias else None
    wt = torch.from_numpy(wk).bfloat16()
    u = wg.winograd_kernel_transform(wt).bfloat16().float().reshape(16, *wk.shape[2:]).numpy()
    got = k10_emulated(x, u, bias)
    _close(got, wg.winograd_conv3x3_plain(torch.from_numpy(x).bfloat16(), wt,
                                          None if bias is None else torch.from_numpy(bias)))


@pytest.mark.parametrize("tag", list(tilings.TILINGS))
def test_k10_other_tilings_match_plain(tag):
    """Each tiling that profile_winograd_tilings builds from the kernel's
    source fits the card and computes the same conv: ragged C, Co over two
    blocks of the widest tiling, two chunks of the narrowest."""
    src = tilings.variant_source(tilings.TILINGS[tag])
    k = constants("winograd_conv3x3_tc", src)
    assert all(k[n] == v for n, v in tilings.TILINGS[tag].items())
    _k10_tiling_holds(k)
    x, wk, b = _inputs((1, 4, 20, 40, 136), seed=4)
    wt = torch.from_numpy(wk).bfloat16()
    u = wg.winograd_kernel_transform(wt).bfloat16().float().reshape(16, *wk.shape[2:]).numpy()
    _close(k10_emulated(x, u, b, k),
           wg.winograd_conv3x3_plain(torch.from_numpy(x).bfloat16(), wt, torch.from_numpy(b)))


def test_k10_wider_tilings_do_not_fit():
    """What rules out a CTA over 128 channels with KC = 32 or 32 tiles: the
    shared memory of two stages, or the accumulators a thread."""
    k = constants("winograd_conv3x3_tc", tilings.variant_source({"TILES": 16, "CO_BLK": 128}))
    assert k["SMEM"] > 232448
    k = constants("winograd_conv3x3_tc", tilings.variant_source({"CO_BLK": 128, "KC": 16}))
    assert 16 * k["TILES"] * k["CO_BLK"] // k["THREADS"] == 128
