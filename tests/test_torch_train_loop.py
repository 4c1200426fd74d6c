"""The port's training loop on the CPU at a small size.

  * `Trainer` on paired data with validation: the JSON log (each
    iteration's metrics and the loader / degrader / step milliseconds), the
    image grids, the validation metrics and images, the checkpoints;
  * the RealESRGAN path (degrader and queue) for two iterations;
  * a resume from a checkpoint continues bit for bit (paired data, the
    step-indexed generators);
  * SIGTERM checkpoints and stops at the next iteration boundary;
  * the asynchronous saves are joined by the last, blocking one;
  * `.pth` warm starts of both models, and an orbax directory refused;
  * `python -m resshift_tpu_torch.cli train --device cpu` in process on a
    small YAML: trains, checkpoints, and resumes bit for bit;
  * the config dict `chip_smoke.py` builds for phase 17 equals
    `load_yaml_config` of configs/realsr_swinunet_realesrgan256.yaml, the
    data paths and the VQGAN checkpoint replaced.
"""

import copy
import json
import os
import signal
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from resshift_tpu_torch import cli
from resshift_tpu_torch.checkpoint import load_params, restore_train_state
from resshift_tpu_torch.config import load_yaml_config
from resshift_tpu_torch.train_loop import Trainer, step_generator
from resshift_tpu_torch.utils.image_io import imwrite

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)

MODEL = dict(image_size=16, in_channels=3, model_channels=32, out_channels=3,
             attention_resolutions=[16, 8], dropout=0.0, channel_mult=[1, 2],
             num_res_blocks=[1, 1], conv_resample=True, num_head_channels=16,
             use_scale_shift_norm=True, resblock_updown=False, swin_depth=2, swin_embed_dim=32,
             window_size=4, mlp_ratio=2, cond_lq=True, cond_mask=False, lq_size=16)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for sub in ("lq", "gt", "val_lq", "val_gt", "hq"):
        (d / sub).mkdir()
    for i in range(8):
        imwrite(rng.uniform(0, 1, (16, 16, 3)), d / "lq" / f"{i}.png")
        imwrite(rng.uniform(0, 1, (64, 64, 3)), d / "gt" / f"{i}.png")
        imwrite(rng.uniform(0, 1, (72, 80, 3)), d / "hq" / f"{i}.png")
    for i in range(2):
        imwrite(rng.uniform(0, 1, (16, 16, 3)), d / "val_lq" / f"{i}.png")
        imwrite(rng.uniform(0, 1, (64, 64, 3)), d / "val_gt" / f"{i}.png")
    return d


def config(data, realesrgan=False, **train):
    cfg = dict(
        task="test", sf=4, model=dict(MODEL),
        diffusion=dict(schedule_name="exponential", steps=3, min_noise_level=0.2, etas_end=0.99,
                       kappa=2.0, power=0.3, predict_type="xstart", timestep_respacing=None,
                       normalize_input=True, latent_flag=True, scale_factor=1.0, sf=4),
        autoencoder=dict(embed_dim=3, n_embed=64, ddconfig=dict(
            double_z=False, z_channels=3, resolution=64, in_channels=3, out_ch=3, ch=32,
            ch_mult=[1, 2, 4], num_res_blocks=1, attn_resolutions=[], dropout=0.0)),
        inference=dict(chop_size=16, chop_stride=12, padding_offset=16),
        data=dict(train=dict(type="base", params=dict(dir_path=str(data / "lq"),
                                                      extra_dir_path=str(data / "gt")))),
        train=dict(lr=1e-3, lr_min=2e-4, lr_schedule="cosin", warmup_iterations=2,
                   iterations=3, batch=4, microbatch=2, ema_rate=0.9, save_freq=1000,
                   log_freq=[1, 1000], val_freq=1000))
    if realesrgan:
        cfg["degradation"] = dict(sf=4, gt_size=64, queue_size=8)
        cfg["data"]["train"] = dict(type="realesrgan", params=dict(
            dir_paths=[str(data / "hq")], gt_size=64, rescale_gt=True))
    cfg["train"].update(train)
    return cfg


def _state(tr):
    return tr.step_fn.state_dict()


def _assert_same_state(a, b):
    assert a["step"] == b["step"]
    for part in ("params", "ema", "exp_avg", "exp_avg_sq"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), f"{part} {k}"


def test_trainer_logs_grids_validates_and_saves(data, tmp_path):
    cfg = config(data, log_freq=[1, 2], val_freq=3)
    cfg["data"]["val"] = dict(type="base", params=dict(dir_path=str(data / "val_lq"),
                                                       extra_dir_path=str(data / "val_gt")))
    tr = Trainer(cfg, save_dir=str(tmp_path), seed=0, device="cpu")
    tr.train()
    log = [json.loads(ln) for ln in (tmp_path / "train_log.jsonl").read_text().splitlines()]
    steps, val = [m for m in log if "loss" in m], [m for m in log if "val_psnr_y" in m]
    assert [m["iter"] for m in steps] == [1, 2, 3]
    for m in steps:
        assert np.isfinite(m["loss"]) and m["loss"] > 0 and m["grad_norm"] > 0
        assert {"lr", "loss_t0", "loss_tmid", "loss_tlast", "loader_ms", "degrade_ms",
                "step_ms"} <= set(m)
    # warmup over 2 steps, then the cosine from 1e-3 to 2e-4 over 3
    assert [m["lr"] for m in steps] == pytest.approx([5e-4, 8e-4, 4e-4], rel=1e-6)
    assert len(val) == 1 and val[0]["val_n"] == 2 and np.isfinite(val[0]["val_psnr_y"])
    names = sorted(p.name for p in (tmp_path / "images").rglob("*.png"))
    assert names == ["gt_000002.png", "lq_000002.png", "progress_000003.png", "val_000003.png",
                     "x0pred_000002.png", "xt_000002.png"]
    st = restore_train_state(tmp_path / "ckpts" / "step_00000003")
    _assert_same_state(st, _state(tr))
    # the EMA moved off the weights and every parameter got a gradient
    assert any(not torch.equal(st["ema"][k], st["params"][k]) for k in st["params"])
    assert all(p.grad.abs().max() > 0 for _, p in tr.step_fn.named)
    # the validation pipeline holds the EMA weights, the training one the params
    vp = tr._val_pipe.unet.state_dict()
    assert all(torch.equal(vp[k], tr.step_fn.ema[k]) for k in tr.step_fn.ema)


def test_realesrgan_training_runs(data, tmp_path):
    tr = Trainer(config(data, realesrgan=True, iterations=2), save_dir=str(tmp_path), seed=0,
                 device="cpu")
    assert tr.train().step == 2
    assert tr.degrader._queue_ptr == 8  # two batches of 4 in the queue of 8


def test_resume_continues_bit_for_bit(data, tmp_path):
    cfg = config(data)
    straight = Trainer(cfg, save_dir=str(tmp_path / "a"), seed=0, device="cpu")
    straight.train()
    first = Trainer(cfg, save_dir=str(tmp_path / "b"), seed=0, device="cpu")
    first.train(stop_iter=2)
    resumed = Trainer(cfg, save_dir=str(tmp_path / "c"), seed=0, device="cpu",
                      resume=str(tmp_path / "b" / "ckpts" / "step_00000002"))
    assert resumed.start_iter == 2
    resumed.train()
    _assert_same_state(_state(resumed), _state(straight))
    # the step's draws depend on (seed, rank, step, stream) alone
    a, b = step_generator(0, 5, 0, 2), step_generator(0, 5, 0, 2)
    assert torch.equal(torch.randn(4, generator=a), torch.randn(4, generator=b))


def test_sigterm_checkpoints_and_stops(data, tmp_path):
    tr = Trainer(config(data, iterations=5), save_dir=str(tmp_path), seed=0, device="cpu")
    step = tr.train_step

    def signalling(batch, gen):
        out = step(batch, gen)
        if tr.step_fn.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    tr.train_step = signalling
    before = signal.getsignal(signal.SIGTERM)
    tr.train(handle_signals=True)
    assert tr.step_fn.step == 2
    assert signal.getsignal(signal.SIGTERM) == before
    assert restore_train_state(tmp_path / "ckpts" / "step_00000002")["step"] == 2


def test_async_saves_are_joined_by_the_last(data, tmp_path):
    tr = Trainer(config(data, save_freq=1), save_dir=str(tmp_path), seed=0, device="cpu")
    tr.train()
    assert tr._saver._thread is None  # the final, blocking save joined the writes
    steps = sorted(p.name for p in (tmp_path / "ckpts").iterdir())
    assert steps == ["step_00000001", "step_00000002", "step_00000003"]
    for s in steps:
        assert restore_train_state(tmp_path / "ckpts" / s)["step"] == int(s[5:])
    assert not list(tmp_path.rglob("*.tmp"))


def test_pth_warm_starts_and_orbax_refused(data, tmp_path):
    src = Trainer(config(data), save_dir=str(tmp_path / "src"), seed=3, device="cpu")
    unet = {f"module.{k}": v for k, v in src.pipe.unet.state_dict().items()}
    torch.save({"state_dict": unet}, tmp_path / "unet.pth")
    torch.save(src.pipe.vq.state_dict(), tmp_path / "vq.pth")
    cfg = config(data)
    cfg["model"]["ckpt_path"] = str(tmp_path / "unet.pth")
    cfg["autoencoder"]["ckpt_path"] = str(tmp_path / "vq.pth")
    tr = Trainer(cfg, save_dir=str(tmp_path / "run"), seed=0, device="cpu")
    for mod, ref in ((tr.pipe.unet, src.pipe.unet), (tr.pipe.vq, src.pipe.vq)):
        for k, v in ref.state_dict().items():
            assert torch.equal(mod.state_dict()[k], v), k
    # the EMA starts from the warm start; the VQGAN stays frozen through a step
    assert all(torch.equal(tr.step_fn.ema[n], p) for n, p in tr.step_fn.named)
    vq0 = copy.deepcopy(tr.pipe.vq.state_dict())
    tr.train(stop_iter=1)
    assert all(torch.equal(v, tr.pipe.vq.state_dict()[k]) for k, v in vq0.items())
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    (orbax / "_METADATA").write_text("{}")
    cfg["model"]["ckpt_path"] = str(orbax)
    with pytest.raises(ValueError, match="orbax"):
        Trainer(cfg, save_dir=str(tmp_path / "run2"), seed=0, device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        load_params(orbax)
    with pytest.raises(ValueError, match="orbax"):
        restore_train_state(orbax)


def test_lpips_trainer_is_not_ported(data, tmp_path):
    """The LPIPS trainer is ported, and takes `train.fsdp` as every trainer
    does: without a process group its step runs unsharded, as the JAX
    package's does on one device (tests/test_torch_parallel_train.py shards
    it over two ranks)."""
    cfg = config(data)
    cfg["trainer"] = "difir_lpips"
    cfg["train"]["fsdp"] = True
    tr = Trainer(cfg, save_dir=str(tmp_path), device="cpu")
    assert tr.tcfg.fsdp and not tr.step_fn.fsdp and tr.step_fn.lpips is not None
    assert tr.step_fn.named == list(tr.pipe.unet.named_parameters())


def test_cli_train_cpu_trains_checkpoints_and_resumes(data, tmp_path):
    yaml = pytest.importorskip("yaml")
    cfg = config(data, save_freq=2)
    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    base = ["train", "--config", str(path), "--device", "cpu", "--fp32", "--seed", "7"]
    cli.main(base + ["--save-dir", str(tmp_path / "a")])
    ckpts = tmp_path / "a" / "ckpts"
    assert sorted(p.name for p in ckpts.iterdir()) == ["step_00000002", "step_00000003"]
    cli.main(base + ["--save-dir", str(tmp_path / "b"), "--resume",
                     str(ckpts / "step_00000002")])
    _assert_same_state(restore_train_state(tmp_path / "b" / "ckpts" / "step_00000003"),
                       restore_train_state(ckpts / "step_00000003"))
    # a JSON config needs no PyYAML
    (tmp_path / "small.json").write_text(json.dumps(cfg))
    assert load_yaml_config(tmp_path / "small.json") == load_yaml_config(path)


def test_chip_smoke_train_config_is_the_yaml():
    pytest.importorskip("yaml")
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    want = load_yaml_config(ROOT / "configs" / "realsr_swinunet_realesrgan256.yaml")
    want["data"]["train"]["params"]["dir_paths"] = ["HQ"]
    want["data"]["val"]["params"].update(dir_path="VAL_LQ", extra_dir_path="VAL_GT")
    want["autoencoder"]["ckpt_path"] = None  # random weights on the card
    assert chip_smoke.realsr_train_config(["HQ"], "VAL_LQ", "VAL_GT") == want
