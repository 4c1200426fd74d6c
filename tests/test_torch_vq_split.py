"""A numpy mirror of kernel D's split and combine (csrc/vq_nearest.cu), run
on the CPU.

The kernel cuts the codebook into slices across CTAs (its host `plan()`),
finds each row's first minimum within a slice (a strict < over the codes in
order, the slice padded with codes that score +inf), and folds the slices
together by an atomic minimum over 64-bit keys: the order-preserving bits
of the score (-0 made +0) in the high word, the index in the low word.  The
mirror reads the kernel's constants (`constexpr int ...`), runs the same
plan, per-slice argmins and key combine on a score matrix, and must give
`torch.argmin`'s first minimum on random scores with planted ties across
slices, +-0 scores and negative scores, whatever order the slices arrive
in.  The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "resshift_tpu_torch" / "csrc" / "vq_nearest.cu"
SMS = 132  # the H100 SXM's SMs
# the decodes' shapes (rows, codes, D): the f4 tile batch, one f8 face, a
# 512x512 photo's f4 latent
SHAPES = [(32768, 8192, 3), (4096, 4096, 8), (262144, 8192, 3)]


def constants() -> dict:
    """The file-level `constexpr int` constants of vq_nearest.cu, in order."""
    env: dict = {}
    for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", SRC.read_text(), re.M):
        env[key] = int(eval(expr, {"__builtins__": {}}, dict(env)))
    return env


K = constants()


def packed(d: int) -> int:
    return (d + 4) & ~3


def plan(m: int, k: int, d: int, sms: int = SMS) -> tuple[int, int]:
    """(slices, slice length) as the kernel's host `plan()` cuts them."""
    max_len = K["SLICE_FLOATS"] // packed(d) // K["SLICE_ALIGN"] * K["SLICE_ALIGN"]
    blocks = -(-m // K["BLOCK_ROWS"])
    lo = -(-k // max_len)
    hi = max(lo, -(-k // K["MIN_SLICE"]))
    s = min(hi, max(lo, K["CTAS_PER_SM"] * sms // blocks))
    length = -(-(-(-k // s)) // K["SLICE_ALIGN"]) * K["SLICE_ALIGN"]
    return -(-k // length), length


def key(score: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """vq_key: uint64 keys ordered as (score, index), -0 equal to +0."""
    u = np.asarray(score, np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    u = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)
    return (u << np.uint64(32)) | np.asarray(idx, np.uint64)


def split_argmin(scores: np.ndarray, order=None) -> np.ndarray:
    """The kernel's result for an (M, K) f32 score matrix: per-slice first
    minima (the slice padded with +inf codes), their keys folded by a
    minimum in the slices' arrival `order`, the low words kept."""
    m, k = scores.shape
    slices, length = plan(m, k, 3)
    keys = np.full(m, np.iinfo(np.uint64).max, np.uint64)
    for s in (range(slices) if order is None else order):
        k0 = s * length
        part = np.full((m, length), np.inf, np.float32)
        part[:, :min(length, k - k0)] = scores[:, k0:k0 + length]
        arg = part.argmin(1)  # the first minimum: a strict < in code order
        keys = np.minimum(keys, key(part[np.arange(m), arg], k0 + arg))
    return (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)


def test_constants_are_the_mirrors():
    """The mirror was written for these; a retiled kernel fails here until
    the mirror follows."""
    assert K == {"THREADS": 128, "ROWS": 4, "BLOCK_ROWS": 512, "SLICE_FLOATS": 4096,
                 "SLICE_ALIGN": 8, "MIN_SLICE": 32, "CTAS_PER_SM": 8}
    assert K["SLICE_FLOATS"] * 4 <= 48 * 1024  # no opt-in to more dynamic shared memory


@pytest.mark.parametrize("m", [1, 1000, 4097, 32768, 262144])
@pytest.mark.parametrize("k", [1, 3, 300, 4096, 8191, 8192])
@pytest.mark.parametrize("d", [1, 3, 4, 8])
def test_plan_covers_the_codebook(m, k, d):
    """Every code in exactly one slice, none empty; a slice a multiple of the
    unroll that fits its shared memory."""
    slices, length = plan(m, k, d)
    assert length % K["SLICE_ALIGN"] == 0 and length * packed(d) <= K["SLICE_FLOATS"]
    assert (slices - 1) * length < k <= slices * length


@pytest.mark.parametrize("m,k,d", SHAPES)
def test_plan_fills_the_card(m, k, d):
    """At the decodes' shapes the grid gives every SM at least 16 warps
    (4 CTAs of 4), and at most CTAS_PER_SM CTAs an SM where the codebook
    needs no more slices than shared memory forces."""
    slices, _ = plan(m, k, d)
    ctas = -(-m // K["BLOCK_ROWS"]) * slices
    assert ctas * K["THREADS"] // 32 >= 16 * SMS
    lo = -(-k // (K["SLICE_FLOATS"] // packed(d) // K["SLICE_ALIGN"] * K["SLICE_ALIGN"]))
    assert slices == lo or ctas <= K["CTAS_PER_SM"] * SMS


def test_rows_map_once():
    """Thread t of row block b holds rows b BLOCK_ROWS + t + r THREADS, r <
    ROWS: each row of the blocks exactly once."""
    b, t, r = np.meshgrid(np.arange(3), np.arange(K["THREADS"]), np.arange(K["ROWS"]),
                          indexing="ij")
    rows = np.sort((b * K["BLOCK_ROWS"] + t + r * K["THREADS"]).ravel())
    assert np.array_equal(rows, np.arange(3 * K["BLOCK_ROWS"]))


def test_key_orders_scores_then_indices():
    """Sorting by key is sorting by (score, index), with -0 equal to +0."""
    rng = np.random.default_rng(0)
    s = np.concatenate([rng.standard_normal(200).astype(np.float32) * 10,
                        np.float32([0.0, -0.0, 0.0, -0.0, np.inf, -3.5, -3.5, 1e-38, -1e-38,
                                    np.finfo(np.float32).tiny * np.float32(0.5)])])
    idx = rng.permutation(len(s)).astype(np.int64)
    got = np.argsort(key(s, idx), kind="stable")
    want = np.lexsort((idx, s.astype(np.float64) + 0.0))  # + 0.0: -0 -> +0
    assert np.array_equal(got, want)


@pytest.mark.parametrize("m,k", [(64, 8192), (37, 8191), (64, 4096), (9, 300)])
def test_split_combine_is_the_first_argmin(m, k):
    """Random scores, negative and positive, with planted exact ties in
    different slices, +-0 minima and rows of all-equal scores: the combined
    keys give torch.argmin's first minimum, whatever order the slices
    arrive in."""
    rng = np.random.default_rng(k)
    scores = (rng.standard_normal((m, k)) * 4).astype(np.float32)
    slices, length = plan(m, k, 3)
    assert slices > 1
    lo = scores.min(1)
    for i in range(0, m, 3):  # the minimum twice: a later slice, then an earlier one
        a, b = rng.choice(k, 2, replace=False)
        scores[i, [a, b]] = lo[i] - 1.0
    for i in range(1, m, 3):  # a minimum of -0 before (or after) one of +0
        a, b = sorted(rng.choice(k, 2, replace=False))
        scores[i] = np.abs(scores[i]) + 1.0
        scores[i, a], scores[i, b] = (-0.0, 0.0) if i % 2 else (0.0, -0.0)
    scores[2] = -2.0  # every code ties
    want = torch.argmin(torch.from_numpy(scores), dim=1).numpy()
    assert want[2] == 0
    for order in (None, range(slices - 1, -1, -1), rng.permutation(slices)):
        assert np.array_equal(split_argmin(scores, order), want)
