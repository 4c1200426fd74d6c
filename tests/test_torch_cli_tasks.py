"""`cli infer` of the port for inpainting, face restoration and x2 SR, on the
CPU at a small width:

  * the parser offers the JAX package's tasks, `--scale` (realsr at 2 is
    realsr_x2, whatever `--version`) and `--mask-path` / `--mask-back`
    (always on in `infer`, off in `eval`);
  * inpainting with a folder of masks: each image takes the mask of its
    stem, else the first mask; the output equals `ResShiftPipeline.sample`
    with the same generator, pasted back with the JAX package's formula
    sr * m + lq * (1 - m), m = mask * 0.5 + 0.5, bit for bit after the
    8-bit rounding, and so equals the input outside the mask;
  * faceir (8 latent channels, f8 VQGAN) and x2 (a padded, tiled input)
    equal `ResShiftPipeline.sample` likewise.
The YAML configs keep each task's structure at 32 channels; the inpainting
one also pins `model.use_pallas: true` and `autoencoder.use_pallas: true`,
which on the CPU run the plain versions.
"""

import numpy as np
import pytest
import torch

from resshift_tpu import cli as jcli
from resshift_tpu_torch import cli, config as tconfig
from resshift_tpu_torch.pipeline import ResShiftPipeline
from resshift_tpu_torch.utils import image_io

torch.set_num_threads(1)

_SMALL_UNET = """\
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
"""
_F4 = """\
autoencoder:
  embed_dim: 3
  n_embed: 64
  ddconfig: {double_z: false, z_channels: 3, resolution: 64, in_channels: 3, out_ch: 3,
             ch: 32, ch_mult: [1, 2, 4], num_res_blocks: 1, attn_resolutions: [], dropout: 0.0}
"""
YAML = {
    "inpaint": "base_task: inpaint_face\n" + _SMALL_UNET + "  lq_size: 64\n  use_pallas: true\n"
               + _F4 + "  use_pallas: true\n"
               + "inference: {chop_size: 64, chop_stride: 48, padding_offset: 16}\n",
    "faceir": "base_task: faceir\n" + _SMALL_UNET + "  lq_size: 128\n" + """\
autoencoder:
  embed_dim: 8
  n_embed: 64
  ddconfig: {double_z: false, z_channels: 8, resolution: 128, in_channels: 3, out_ch: 3,
             ch: 32, ch_mult: [1, 2, 4, 8], num_res_blocks: [1, 2, 3, 4],
             attn_resolutions: [], dropout: 0.0}
inference: {chop_size: 128, chop_stride: 112, padding_offset: 16}
""",
    "x2": "base_task: realsr_x2\n" + _SMALL_UNET + "  lq_size: 32\n" + _F4
          + "inference: {chop_size: 32, chop_stride: 28, padding_offset: 16}\n",
}


def _to8(x):
    return np.clip(np.round(np.clip(x, 0, 1) * 255.0), 0, 255).astype(np.uint8)


def _folder(tmp_path, kind, sizes, seed):
    (tmp_path / "lq").mkdir()
    (tmp_path / f"{kind}.yaml").write_text(YAML[kind])
    rng = np.random.default_rng(seed)
    for name, (h, w) in sizes.items():
        image_io.imwrite(rng.uniform(0, 1, (h, w, 3)), tmp_path / "lq" / f"{name}.png")
    return tmp_path


def _reference(tmp_path, kind, names, seed, masks=None):
    """`ResShiftPipeline.sample` on each input in turn with one generator,
    as 8-bit images; pasted back where a mask is given."""
    pipe = ResShiftPipeline(tconfig.load_yaml_config(tmp_path / f"{kind}.yaml"),
                            dtype=torch.float32, device="cpu")
    # the YAML's pins reach the UNet head and the decoder tail (both pins
    # are tri-state: unset is None, F off)
    assert ((pipe.unet.use_pallas is True) == (pipe.vq.decoder.use_pallas is True)
            == (kind == "inpaint"))
    pipe.init_params(seed)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name in names:
        im = image_io.imread(tmp_path / "lq" / f"{name}.png")
        mask = None if masks is None else image_io.to_model(
            image_io.imread(masks[name], chn="gray"))
        # a batch built as the CLI builds it: the strides of the input reach
        # the convolutions of the VQGAN encoder at sf 1, and with them
        # the summation order
        lq = torch.from_numpy(np.concatenate([image_io.to_model(im)], axis=0))
        sr = pipe.sample(lq, gen, None if mask is None else torch.from_numpy(mask))
        sr01 = image_io.from_model(sr.numpy())[0]
        if mask is not None:  # resshift_tpu/cli.py's paste-back
            m01 = mask[0] * 0.5 + 0.5
            sr01 = sr01 * m01 + (im[..., :3] * (1 - m01))
        out[name] = _to8(sr01)
    return out


def _infer(tmp_path, kind, seed, *extra):
    cli.main(["infer", "--config", str(tmp_path / f"{kind}.yaml"), "--fp32", "--device", "cpu",
              "--seed", str(seed), "--in-path", str(tmp_path / "lq"),
              "--out-path", str(tmp_path / "out"), *extra])


def test_parser_tasks_scale_and_masks_follow_jax():
    ours, theirs = cli.make_parser(), jcli.make_parser()

    def infer_options(p):
        sub = next(a for a in p._actions if a.dest == "cmd").choices["infer"]
        return {a.dest: a for a in sub._actions}

    o, t = infer_options(ours), infer_options(theirs)
    assert o["task"].choices == t["task"].choices
    for dest in ("scale", "mask_path", "mask_back", "version"):
        assert o[dest].default == t[dest].default, dest
    base = ["infer", "--in-path", "x", "--out-path", "y"]
    for argv, name in ((["--task", "realsr", "--scale", "2", "--version", "v1"], "realsr_x2"),
                       (["--task", "realsr", "--version", "v1"], "realsr_v1"),
                       (["--task", "inpaint_face", "--scale", "2"], "inpaint_face"),
                       (["--task", "faceir"], "faceir")):
        args = ours.parse_args(base + argv)
        assert cli._task_name(args) == name and args.mask_back is True
        assert cli._config(args) == tconfig.task_config(name)


def test_cli_infer_inpaint_masks_by_stem_then_first(tmp_path, capsys):
    """Three 56x72 images (padded to 64x80: two 64-px tiles, chop 64, stride
    48); masks for a and b only, so c takes a's mask, the first."""
    sizes = {"a": (56, 72), "b": (56, 72), "c": (56, 72)}
    folder = _folder(tmp_path, "inpaint", sizes, 1)
    (folder / "masks").mkdir()
    masks = {}
    for name, (y0, x0) in {"a": (8, 10), "b": (30, 40)}.items():
        m = np.zeros((56, 72), np.uint8)
        m[y0:y0 + 20, x0:x0 + 24] = 255
        image_io.imwrite(m, folder / "masks" / f"{name}.png")
        masks[name] = folder / "masks" / f"{name}.png"
    masks["c"] = masks["a"]
    _infer(folder, "inpaint", 5, "--mask-path", str(folder / "masks"))
    assert "Done:" in capsys.readouterr().out
    want = _reference(folder, "inpaint", sizes, 5, masks)
    for name in sizes:
        got = image_io.imread(folder / "out" / f"{name}.png", dtype="uint8")
        np.testing.assert_array_equal(got, want[name], err_msg=name)
        keep = image_io.imread(masks[name], chn="gray", dtype="uint8") == 0
        lq = image_io.imread(folder / "lq" / f"{name}.png", dtype="uint8")
        np.testing.assert_array_equal(got[keep], lq[keep], err_msg=name)
        assert not np.array_equal(got[~keep], lq[~keep])


def test_cli_infer_single_mask_file(tmp_path):
    folder = _folder(tmp_path, "inpaint", {"a": (64, 64)}, 2)
    m = np.zeros((64, 64), np.uint8)
    m[20:40, 16:50] = 255
    image_io.imwrite(m, folder / "one_mask.png")
    _infer(folder, "inpaint", 6, "--mask-path", str(folder / "one_mask.png"))
    want = _reference(folder, "inpaint", ["a"], 6, {"a": folder / "one_mask.png"})
    np.testing.assert_array_equal(image_io.imread(folder / "out" / "a.png", dtype="uint8"),
                                  want["a"])


@pytest.mark.parametrize("kind,sizes,scale", [
    ("faceir", {"face": (128, 128)}, 1),
    ("x2", {"a_square": (32, 32), "b_tiled": (24, 40)}, 2),  # b: padded to 32x48, two tiles
])
def test_cli_infer_faceir_and_x2(tmp_path, kind, sizes, scale):
    folder = _folder(tmp_path, kind, sizes, 3)
    extra = ["--task", "realsr", "--scale", "2"] if kind == "x2" else ["--task", "faceir"]
    _infer(folder, kind, 7, *extra)
    want = _reference(folder, kind, sizes, 7)
    for name, (h, w) in sizes.items():
        got = image_io.imread(folder / "out" / f"{name}.png", dtype="uint8")
        assert got.shape == (scale * h, scale * w, 3)
        np.testing.assert_array_equal(got, want[name], err_msg=name)
