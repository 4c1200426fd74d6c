"""The port's `cli infer` / `cli eval` and what they stand on, on the CPU.

  * The PNG codec (used where OpenCV is missing) round-trips 8- and 16-bit
    gray, gray+alpha, RGB and RGBA, and decodes files written with each of
    the five row filters exactly as cv2 does; `imread` / `imwrite` without
    cv2 agree with them with cv2, exactly.
  * `ops/metrics.py` equals the JAX package's `ops/metrics.py` exactly.
  * `default_chop`, `CKPT_URLS`, the configs of the CLI's tasks and
    `load_torch_state_dict` equal the JAX package's.
  * `cli infer --device cpu` on a folder of two PNGs (one of them wide
    enough for the token-permutation route of the Swin blocks under a
    patched threshold) writes outputs of the right size that equal
    `ResShiftPipeline.sample` with the same generator, bit for bit after
    the 8-bit rounding, and with `--gt-path` writes `metrics.json`.
"""

import json
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from resshift_tpu import config as jconfig
from resshift_tpu import convert as jconvert
from resshift_tpu.ops import metrics as jmetrics
from resshift_tpu_torch import cli, config as tconfig, convert as tconvert
from resshift_tpu_torch.ops import metrics as tmetrics
from resshift_tpu_torch.ops import shift as tshift
from resshift_tpu_torch.ops import swin_block as tsb
from resshift_tpu_torch.pipeline import ResShiftPipeline
from resshift_tpu_torch.utils import image_io, io_pipeline

torch.set_num_threads(1)

# (channels, dtype) of each PNG kind the codec reads
KINDS = {"g8": (1, np.uint8), "g16": (1, np.uint16), "ga8": (2, np.uint8),
         "ga16": (2, np.uint16), "rgb8": (3, np.uint8), "rgb16": (3, np.uint16),
         "rgba8": (4, np.uint8), "rgba16": (4, np.uint16)}


def _image(kind, h=9, w=13, seed=0):
    ch, dt = KINDS[kind]
    im = np.random.default_rng(seed).integers(0, np.iinfo(dt).max + 1, (h, w, ch), dtype=dt)
    return im[..., 0] if ch == 1 else im


def _png_all_filters(im) -> bytes:
    """A PNG whose rows cycle through filters 0-4 (None, Sub, Up, Average,
    Paeth), encoded here independently of the codec under test."""
    im = im if im.ndim == 3 else im[..., None]
    h, w, ch = im.shape
    depth = 8 * im.dtype.itemsize
    raw = (im.astype(">u2") if depth == 16 else im).reshape(h, -1).view(np.uint8).astype(np.int64)
    bpp = ch * depth // 8
    out = []
    for y in range(h):
        x, up = raw[y], raw[y - 1] if y else np.zeros_like(raw[0])
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        f = y % 5
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(np.concatenate([[f], (x - pred) & 255]).astype(np.uint8))

    def chunk(k, b):
        return struct.pack(">I", len(b)) + k + b + struct.pack(">I", zlib.crc32(k + b))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
            + chunk(b"IEND", b""))


def _cv2_in_file_order(im):
    """cv2's BGR(A) result in the file's channel order; cv2 gives a
    gray+alpha file as BGRA with B = G = R."""
    if im.ndim == 2:
        return im
    if np.array_equal(im[..., 0], im[..., 1]) and np.array_equal(im[..., 0], im[..., 2]):
        return im[..., [0, 3]] if im.shape[2] == 4 else im
    return np.concatenate([im[..., 2::-1], im[..., 3:]], axis=2)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_png_codec_round_trip(kind):
    im = _image(kind)
    got = image_io.png_decode(image_io.png_encode(im))
    assert got.dtype == im.dtype
    np.testing.assert_array_equal(got, im)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_png_codec_decodes_as_cv2(tmp_path, kind, monkeypatch):
    im = _image(kind, seed=1)
    path = tmp_path / f"{kind}.png"
    path.write_bytes(_png_all_filters(im))
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    got = image_io.png_decode(path.read_bytes())
    np.testing.assert_array_equal(got, im)
    if kind.startswith("ga"):
        np.testing.assert_array_equal(ref[..., 0], im[..., 0])
        np.testing.assert_array_equal(ref[..., 3], im[..., 1])
    else:
        np.testing.assert_array_equal(_cv2_in_file_order(ref), got)
    # imread without cv2 == imread with cv2, float and raw
    with_cv2 = [image_io.imread(path), image_io.imread(path, dtype="uint")]
    if im.ndim == 2 or kind.startswith("ga"):
        with_cv2.append(image_io.imread(path, chn="gray"))
    monkeypatch.setattr(image_io, "_cv2", lambda: None)
    without = [image_io.imread(path), image_io.imread(path, dtype="uint")]
    if im.ndim == 2 or kind.startswith("ga"):
        without.append(image_io.imread(path, chn="gray"))
    for a, b in zip(without, with_cv2):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_imwrite_without_cv2(tmp_path, monkeypatch):
    rgb = np.random.default_rng(2).uniform(0, 1, (11, 7, 3)).astype(np.float32)
    image_io.imwrite(rgb, tmp_path / "cv2.png")
    monkeypatch.setattr(image_io, "_cv2", lambda: None)
    image_io.imwrite(rgb, tmp_path / "own.png")
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "own.png")),
                                  cv2.imread(str(tmp_path / "cv2.png")))
    np.testing.assert_array_equal(image_io.imread(tmp_path / "own.png"),
                                  np.round(rgb * 255) / 255.0)
    with pytest.raises(RuntimeError, match="cv2"):
        image_io.imwrite(rgb, tmp_path / "x.jpg")
    (tmp_path / "x.bmp").write_bytes(b"BM")
    with pytest.raises(RuntimeError, match="cv2"):
        image_io.imread(tmp_path / "x.bmp")


@pytest.mark.parametrize("ycbcr", [False, True])
def test_metrics_match_jax(ycbcr):
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (2, 23, 29, 3))
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1)
    a8, b8 = (np.round(x * 255).astype(np.uint8) for x in (a, b))
    for only_y in (True, False):
        for x in (a8[0], a[0].astype(np.float32)):
            np.testing.assert_array_equal(tmetrics.rgb2ycbcr(x, only_y),
                                          jmetrics.rgb2ycbcr(x, only_y))
    for fn in ("calculate_psnr", "calculate_ssim"):
        for border in (0, 4):
            assert (getattr(tmetrics, fn)(a8[0], b8[0], border, ycbcr)
                    == getattr(jmetrics, fn)(a8[0], b8[0], border, ycbcr))
    for fn in ("batch_psnr", "batch_ssim"):
        assert getattr(tmetrics, fn)(a, b, 0, ycbcr) == getattr(jmetrics, fn)(a, b, 0, ycbcr)


def test_config_and_state_dict_loader_match_jax(tmp_path):
    for size in (512, 256, 64):
        for sf in (4, 2, 1):
            assert tconfig.default_chop(size, sf) == jconfig.default_chop(size, sf)
    with pytest.raises(ValueError):
        tconfig.default_chop(128, 4)
    assert tconfig.CKPT_URLS == jconfig.CKPT_URLS
    for name in ("realsr_v1", "realsr_v2", "realsr_v3", "bicsr"):  # the tasks of `cli infer`
        assert tconfig.task_config(name) == jconfig.task_config(name)
    sd = {f"module.layer{i}.weight": torch.randn(3, 2) for i in range(3)}
    torch.save({"state_dict": sd, "step": 7}, tmp_path / "ckpt.pth")
    got = tconvert.load_torch_state_dict(str(tmp_path / "ckpt.pth"))
    want = jconvert.load_torch_state_dict(str(tmp_path / "ckpt.pth"))
    assert list(got) == list(want) == [f"layer{i}.weight" for i in range(3)]
    for k in got:
        assert torch.equal(got[k], want[k])


def test_load_torch_checkpoints(tmp_path):
    """Released files carry derived buffers and training entries the
    models do not have: they are ignored; a missing key raises."""
    src = ResShiftPipeline(_small_config(tmp_path), dtype=torch.float32, device="cpu")
    src.init_params(3)
    for name, mod in (("unet", src.unet), ("vq", src.vq)):
        sd = {f"module.{k}": v for k, v in mod.state_dict().items()}
        sd["module.input_blocks.1.1.blocks.1.attn_mask"] = torch.zeros(4, 16, 16)
        sd["module.loss.discriminator.weight"] = torch.zeros(2)
        torch.save({"state_dict": sd}, tmp_path / f"{name}.pth")
    dst = ResShiftPipeline(_small_config(tmp_path), dtype=torch.float32, device="cpu")
    dst.load_torch_checkpoints(str(tmp_path / "unet.pth"), str(tmp_path / "vq.pth"))
    for a, b in ((src.unet, dst.unet), (src.vq, dst.vq)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    with pytest.raises(ValueError, match="VQGAN"):
        dst.load_torch_checkpoints(str(tmp_path / "unet.pth"))
    with pytest.raises(KeyError, match="lacks"):
        dst.load_torch_checkpoints(str(tmp_path / "vq.pth"), str(tmp_path / "vq.pth"))


def test_io_pipeline_order_and_errors():
    assert list(io_pipeline.prefetch(iter(range(37)), depth=3)) == list(range(37))

    def failing():
        yield 1
        raise RuntimeError("reader failed")

    with pytest.raises(RuntimeError, match="reader failed"):
        list(io_pipeline.prefetch(failing()))
    seen = []
    with pytest.raises(ValueError, match="writer failed"):
        with io_pipeline.AsyncWriter(depth=1) as w:
            w.submit(lambda pool: seen.append(1))
            w.submit(lambda pool: (_ for _ in ()).throw(ValueError("writer failed")))
    assert seen == [1]


# ----------------------------------------------------------- cli infer

SMALL_YAML = """\
base_task: realsr_v3
model:
  image_size: 16
  model_channels: 32
  attention_resolutions: [16, 8]
  channel_mult: [1, 2]
  num_res_blocks: [1, 1]
  num_head_channels: 16
  swin_embed_dim: 32
  window_size: 4
  mlp_ratio: 2
  lq_size: 16
autoencoder:
  embed_dim: 3
  n_embed: 64
  ddconfig: {double_z: false, z_channels: 3, resolution: 64, in_channels: 3, out_ch: 3,
             ch: 32, ch_mult: [1, 2, 4], num_res_blocks: 1, attn_resolutions: [], dropout: 0.0}
inference: {chop_size: 64, chop_stride: 48, padding_offset: 16}
"""
# LQ sizes: a 16-wide map fuses the shift under the threshold below, a
# 40-wide one (48 after padding) takes the token permutation
SIZES = {"a_square": (16, 16), "b_wide": (16, 40)}


def _small_config(tmp_path) -> dict:
    (tmp_path / "small.yaml").write_text(SMALL_YAML)
    return tconfig.load_yaml_config(tmp_path / "small.yaml")


def _gate(wd, ws):
    return wd * ws <= 64


@pytest.fixture
def folder(tmp_path, monkeypatch):
    monkeypatch.setattr(tsb, "shift_fuse_fits", _gate)
    (tmp_path / "lq").mkdir()
    (tmp_path / "gt").mkdir()
    rng = np.random.default_rng(4)
    for name, (h, w) in SIZES.items():
        image_io.imwrite(rng.uniform(0, 1, (h, w, 3)), tmp_path / "lq" / f"{name}.png")
        image_io.imwrite(rng.uniform(0, 1, (4 * h, 4 * w, 3)), tmp_path / "gt" / f"{name}.png")
    _small_config(tmp_path)
    return tmp_path


def _to8(x):
    return np.clip(np.round(np.clip(x, 0, 1) * 255.0), 0, 255).astype(np.uint8)


def test_cli_infer_equals_pipeline_sample(folder, monkeypatch, capsys):
    e_calls = []
    orig = tshift.shift_tokens
    monkeypatch.setattr(tshift, "shift_tokens", lambda *a, **k: e_calls.append(a[2]) or
                        orig(*a, **k))
    cli.main(["infer", "--config", str(folder / "small.yaml"), "--fp32", "--device", "cpu",
              "--seed", "7", "--in-path", str(folder / "lq"), "--out-path", str(folder / "out"),
              "--gt-path", str(folder / "gt")])
    out = capsys.readouterr().out
    assert "Done:" in out and "Mpx/s" in out and "PSNR(Y)" in out
    # only the wide map's shifted blocks took the permutation: 4 steps x 5
    # shifted blocks (2 on the 48-wide level, 3 on the 24-wide one) x (fwd, inv)
    assert sorted(set(e_calls)) == [24, 48] and len(e_calls) == 4 * 5 * 2

    pipe = ResShiftPipeline(tconfig.load_yaml_config(folder / "small.yaml"),
                            dtype=torch.float32, device="cpu")
    pipe.init_params(7)
    gen = torch.Generator().manual_seed(7)
    for name, (h, w) in SIZES.items():
        lq = torch.from_numpy(image_io.to_model(image_io.imread(folder / "lq" / f"{name}.png")))
        want = _to8(image_io.from_model(pipe.sample(lq, gen).numpy())[0])
        got = image_io.imread(folder / "out" / f"{name}.png", dtype="uint8")
        assert got.shape == (4 * h, 4 * w, 3)
        np.testing.assert_array_equal(got, want)
    record = json.loads((folder / "out" / "metrics.json").read_text())
    assert record["n"] == 2 and np.isfinite(record["psnr_y"])


def test_cli_eval_realset_protocol(folder, capsys):
    cli.main(["eval", "--protocol", "realset", "--config", str(folder / "small.yaml"),
              "--fp32", "--device", "cpu", "--in-path", str(folder / "lq"),
              "--out-path", str(folder / "out"), "--gt-path", str(folder / "gt")])
    assert "Protocol realset: 2 images" in capsys.readouterr().out
    record = json.loads((folder / "out" / "metrics.json").read_text())
    assert record["protocol"] == "realset" and record["n"] == 2
    for name, (h, w) in SIZES.items():
        assert image_io.imread(folder / "out" / f"{name}.png").shape == (4 * h, 4 * w, 3)


def test_cli_without_cuda_raises_unless_cpu_is_asked(folder, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["infer", "--config", str(folder / "small.yaml"), "--in-path",
                  str(folder / "lq"), "--out-path", str(folder / "out")])
