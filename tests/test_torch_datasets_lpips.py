"""The LPIPS trainer's data against the JAX package's, on the same files and
seed, through `create_dataset` and the loader; and `cli eval --lpips-path`.

  * `bicubic`: items equal bit for bit and the generator's state equal after
    each; the loader's shuffled batches equal;
  * `inpainting` (LaMa distortions and masks from one generator): the
    generator's state equal after each item; the masks within the band of
    `test_torch_masks.py`, the GT within 2 levels (of 255) on >= 99% of the
    pixels (`test_torch_distortions.py`'s chain band), the LQ the masked GT;
  * `inpainting_val`: items equal (the mask read as gray);
  * the parameters once left out (packed files, memcached) behave as the
    JAX package's: a missing packed file raises OSError in both, an
    `extra_pack_path` without `pack_path` is ignored by both, and memcached
    gives a dataset reading through a memcached client in both;
  * `cli eval --lpips-path` on a `.pth` written here: the LPIPS column in
    the report and in metrics.json equals the port's LPIPS of the written
    outputs against the GT.
"""

import json

import numpy as np
import pytest
import torch

from resshift_tpu.data import datasets as jds
from resshift_tpu_torch import cli
from resshift_tpu_torch.data import datasets as tds
from resshift_tpu_torch.models.lpips import LPIPS
from resshift_tpu_torch.utils.image_io import imread, imwrite

torch.set_num_threads(2)


def _field(rng, h, w):
    """A smooth random image with a little noise, HWC in [0, 1]."""
    from resshift_tpu_torch.ops.resize import resize_np

    return np.clip(resize_np(rng.uniform(0, 1, (h // 16, w // 16, 3)), (h, w), "bilinear")
                   + rng.normal(0, 0.03, (h, w, 3)), 0, 1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lpips_data")
    rng = np.random.default_rng(0)
    for sub in ("hq", "val/lq", "val/gt", "val/mask"):
        (d / sub).mkdir(parents=True)
    for i, (h, w) in enumerate([(160, 144), (128, 200), (112, 128), (176, 176)]):
        imwrite(_field(rng, h, w), d / "hq" / f"{i}.png")
    for i in range(2):
        imwrite(_field(rng, 64, 64), d / "val" / "lq" / f"{i}.png")
        imwrite(_field(rng, 64, 64), d / "val" / "gt" / f"{i}.png")
        imwrite((rng.uniform(0, 1, (64, 64)) > 0.7).astype(np.float32), d / "val" / "mask"
                / f"{i}.png")
    return d


def _pair(kind, **params):
    cfg = dict(type=kind, params=params)
    return tds.create_dataset(cfg), jds.create_dataset(cfg)


def test_bicubic_items_and_loader_equal(files):
    params = dict(source_path=str(files / "hq"), degrade_kwargs=dict(scale=0.25, pch_size=96),
                  transform_kwargs=dict(mean=0.5, std=0.5), seed=3)
    t, j = _pair("bicubic", **params)
    assert t.paths == j.paths
    for i in [0, 1, 2, 3, 2]:
        a, b = t[i], j[i]
        assert set(a) == {"gt", "lq"} == set(b)
        assert a["gt"].shape == (96, 96, 3) and a["lq"].shape == (24, 24, 3)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert t.rng.bit_generator.state == j.rng.bit_generator.state
    t, j = _pair("bicubic", **params)
    tl = tds.DataLoader(t, batch_size=2, seed=4, prefetch=0)
    jl = jds.DataLoader(j, batch_size=2, seed=4, prefetch=0)
    for a, b in zip(tl, jl):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_inpainting_items_match_jax(files):
    params = dict(dir_path=str(files / "hq"), pch_size=96, transform_type="lama_distortions",
                  mask_kwargs=dict(irregular_proba=1, irregular_kwargs=dict(
                      max_angle=4, max_len=60, max_width=30, max_times=5, min_times=1),
                      box_proba=1, box_kwargs=dict(margin=10, bbox_min_size=20,
                                                   bbox_max_size=50, max_times=4, min_times=1)),
                  seed=5)
    t, j = _pair("inpainting", **params)
    for i in [0, 1, 2, 3, 0, 1]:
        a, b = t[i], j[i]
        assert t.rng.bit_generator.state == j.rng.bit_generator.state
        assert set(a) == {"gt", "lq", "mask"} == set(b)
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == np.float32, k
        diff = a["mask"] != b["mask"]
        assert diff.mean() <= 0.01
        levels = np.abs(a["gt"] - b["gt"]) * 127.5  # [-1, 1] -> levels of 255
        assert np.mean(levels <= 2 + 1e-3) >= 0.99
        m = a["mask"] * 0.5 + 0.5
        np.testing.assert_allclose(a["lq"], a["gt"] * (1 - m) - m, rtol=0, atol=1e-6)


def test_inpainting_val_items_equal(files):
    t, j = _pair("inpainting_val", lq_path=str(files / "val" / "lq"),
                 gt_path=str(files / "val" / "gt"), mask_path=str(files / "val" / "mask"))
    assert len(t) == len(j) == 2
    for i in range(2):
        a, b = t[i], j[i]
        assert set(a) == {"lq", "gt", "mask"} == set(b) and a["mask"].shape == (64, 64, 1)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind,params", [
    ("base", dict(pack_path="x.pack")), ("base", dict(extra_pack_path="x.pack")),
    ("base", dict(io_backend=dict(type="memcached"))), ("realesrgan", dict(pack_path="x.pack")),
    ("realesrgan", dict(io_backend=dict(type="memcached")))])
def test_left_out_types_name_the_roadmap(kind, params):
    """Packed files and memcached are ported: the same parameters give the
    same outcome as in the JAX package (tests/test_torch_packfile.py reads
    real packed files and a memcached stub)."""
    cfg = dict(type=kind, params=params)
    if params.get("pack_path"):
        for ds in (tds, jds):
            with pytest.raises(OSError):
                ds.create_dataset(cfg)
        return
    t, j = tds.create_dataset(cfg), jds.create_dataset(cfg)
    assert len(t) == len(j) == 0
    assert (t.client is None) == (j.client is None)
    assert t.client is None or t.client.backend == j.client.backend == "memcached"


MODEL = dict(image_size=16, in_channels=3, model_channels=32, out_channels=3,
             attention_resolutions=[16, 8], dropout=0.0, channel_mult=[1, 2],
             num_res_blocks=[1, 1], conv_resample=True, num_head_channels=16,
             use_scale_shift_norm=True, resblock_updown=False, swin_depth=2, swin_embed_dim=32,
             window_size=4, mlp_ratio=2, cond_lq=True, cond_mask=False, lq_size=16)
SMALL = dict(
    task="test", sf=4, model=MODEL,
    diffusion=dict(schedule_name="exponential", steps=2, min_noise_level=0.2, etas_end=0.99,
                   kappa=2.0, power=0.3, predict_type="xstart", timestep_respacing=None,
                   normalize_input=True, latent_flag=True, scale_factor=1.0, sf=4),
    autoencoder=dict(embed_dim=3, n_embed=64, ddconfig=dict(
        double_z=False, z_channels=3, resolution=64, in_channels=3, out_ch=3, ch=32,
        ch_mult=[1, 2, 4], num_res_blocks=1, attn_resolutions=[], dropout=0.0)),
    inference=dict(chop_size=16, chop_stride=12, padding_offset=16))


def test_cli_eval_reports_lpips(files, tmp_path, capsys):
    (tmp_path / "lq").mkdir()
    rng = np.random.default_rng(6)
    for i in range(2):
        imwrite(rng.uniform(0, 1, (16, 16, 3)), tmp_path / "lq" / f"{i}.png")
    (tmp_path / "small.json").write_text(json.dumps(SMALL))
    lp = LPIPS()
    torch.save({k: v.half() for k, v in lp.state_dict().items()}, tmp_path / "lpips.pth")
    gt_dir = files / "val" / "gt"
    cli.main(["eval", "--protocol", "imagenet", "--config", str(tmp_path / "small.json"),
              "--fp32", "--device", "cpu", "--in-path", str(tmp_path / "lq"),
              "--out-path", str(tmp_path / "out"), "--gt-path", str(gt_dir),
              "--lpips-path", str(tmp_path / "lpips.pth")])
    assert "LPIPS:" in capsys.readouterr().out
    record = json.loads((tmp_path / "out" / "metrics.json").read_text())
    lp.load_state_dict({k: v.half().float() for k, v in lp.state_dict().items()})
    want = []
    with torch.no_grad():
        for i in range(2):
            sr, gt = (torch.from_numpy(imread(p)[None] * 2 - 1) for p in
                      (tmp_path / "out" / f"{i}.png", gt_dir / f"{i}.png"))
            want.append(float(lp(sr, gt)[0]))
    assert record["n"] == 2 and record["lpips"] > 0
    np.testing.assert_allclose(record["lpips"], np.mean(want), rtol=1e-5)
