"""Faceir training in the port, on the CPU.

  * `cli train --device cpu` on a faceir-shaped small config (sf 1, an
    f8-style VQGAN, the LPIPS trainer, `gfpgan` data on two loader
    threads, `base` validation without GT) runs two iterations and writes
    its JSON log, its validation restoration and a checkpoint;
  * the config dict that `chip_smoke.py` phase 19 builds (the card's
    machine has no PyYAML) equals configs/faceir_gfpgan512_lpips.yaml;
  * `tools/profile_loader.py` times a loader's items serially and on its
    threads.
One LPIPS step of such a model against the JAX trainer is a case of
`tests/test_torch_lpips_train.py`'s step tests (`faceir`).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from resshift_tpu_torch import cli
from resshift_tpu_torch.checkpoint import restore_train_state
from resshift_tpu_torch.ops.resize import resize_np
from resshift_tpu_torch.utils.image_io import imwrite

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

DDCONFIG = dict(double_z=False, z_channels=4, resolution=64, in_channels=3, out_ch=3, ch=32,
                ch_mult=[1, 2, 2, 4], num_res_blocks=1, attn_resolutions=[], dropout=0.0)
MODEL = dict(image_size=8, in_channels=4, model_channels=32, out_channels=4,
             attention_resolutions=[8], dropout=0.0, channel_mult=[1, 2],
             num_res_blocks=[1, 1], conv_resample=True, num_head_channels=16,
             use_scale_shift_norm=True, resblock_updown=False, swin_depth=2,
             swin_embed_dim=32, window_size=4, mlp_ratio=2, cond_lq=True, cond_mask=False,
             lq_size=64)
# configs/faceir_gfpgan512_lpips.yaml's data.train.params, at 64x64
GFPGAN = dict(out_size=64, blur_kernel_size=41, kernel_list=["iso", "aniso"],
              kernel_prob=[0.5, 0.5], blur_sigma=[0.1, 10], downsample_range=[0.8, 8],
              noise_range=[0, 20], jpeg_range=[60, 100], use_hflip=True,
              color_jitter_prob=None, gray_prob=0.01)


@pytest.fixture(scope="module")
def faces(tmp_path_factory):
    d = tmp_path_factory.mktemp("faces")
    rng = np.random.default_rng(0)
    for i in range(4):
        im = resize_np(rng.uniform(0, 1, (8, 8, 3)), (64, 64), "bilinear")
        imwrite(np.clip(im + rng.normal(0, 0.03, im.shape), 0, 1), d / f"{i}.png")
    return d


def _config(faces):
    return dict(
        task="test", sf=1, trainer="difir_lpips", model=MODEL,
        diffusion=dict(schedule_name="exponential", steps=4, min_noise_level=0.2,
                       etas_end=0.99, kappa=2.0, power=0.3, predict_type="xstart",
                       timestep_respacing=None, normalize_input=True, latent_flag=True,
                       scale_factor=1.0, sf=1),
        autoencoder=dict(embed_dim=4, n_embed=64, ddconfig=DDCONFIG),
        inference=dict(chop_size=64, chop_stride=48, padding_offset=16),
        data=dict(train=dict(type="gfpgan", params=dict(GFPGAN, dir_path=str(faces))),
                  val=dict(type="base", params=dict(dir_path=str(faces)))),
        train=dict(lr=5e-5, lr_schedule="cosin", batch=[4, 2], microbatch=2, iterations=2,
                   loss_coef=[1.0, 1.0], lpips_path=None, save_freq=1000, log_freq=[1, 1000],
                   val_freq=2, val_max_images=2, num_workers=2))


def test_cli_train_faceir_two_iterations(faces, tmp_path, capsys):
    (tmp_path / "faceir.json").write_text(json.dumps(_config(faces)))
    cli.main(["train", "--config", str(tmp_path / "faceir.json"), "--device", "cpu", "--fp32",
              "--seed", "0", "--save-dir", str(tmp_path / "run")])
    assert "RANDOM weights" in capsys.readouterr().out
    run = tmp_path / "run"
    log = [json.loads(ln) for ln in (run / "train_log.jsonl").read_text().splitlines()]
    steps = [m for m in log if "loss" in m]
    assert [m["iter"] for m in steps] == [1, 2]
    for m in steps:
        assert np.isfinite(m["loss"]) and m["lpips"] > 0 and m["grad_norm"] > 0
        assert m["loader_ms"] >= 0 and m["step_ms"] > 0
    assert (run / "images" / "val" / "val_000002.png").is_file()  # no GT: no metrics
    state = restore_train_state(run / "ckpts" / "step_00000002")
    assert state["step"] == 2 and state["params"]


def test_chip_smoke_faceir_config_is_the_yaml():
    """`chip_smoke.faceir_lpips_config` equals the shipped YAML with the
    data paths replaced and no weights (none may be downloaded)."""
    pytest.importorskip("yaml")
    from resshift_tpu_torch.config import load_yaml_config

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    want = load_yaml_config(ROOT / "configs" / "faceir_gfpgan512_lpips.yaml")
    want["data"]["train"]["params"]["dir_path"] = "FACES"
    want["data"]["val"]["params"]["dir_path"] = "VAL"
    want["autoencoder"]["ckpt_path"] = None
    want["train"]["lpips_path"] = None
    assert chip_smoke.faceir_lpips_config("FACES", "VAL") == want


@pytest.mark.parametrize("kind", ["gfpgan", "bsrganimagenet"])
def test_profile_loader_times_items_both_ways(capsys, kind):
    from resshift_tpu_torch.tools import profile_loader

    out = profile_loader.main(["--type", kind, "--n", "2", "--size", "96", "--gt-size", "64",
                               "--threads", "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["items"] == 2 and out["serial_ms_per_item"] > 0 and out["speedup"] > 0
