"""The LPIPS trainer of the port against the JAX package's, on the CPU in f32.

  * one LPIPS train step (two microbatches) for a bicsr-like model (x4 SR,
    LQ conditioning), an inpainting-like one (x1, LQ feature pyramid and
    mask) and a faceir-like one (x1, an f8-style VQGAN, the LQ pyramid from
    64 to 8), tiny UNet, VQGAN and the full VGG16 trunk at 64x64, against
    `resshift_tpu.trainer.make_train_step(..., lpips_fn=...)` given the same
    weights and JAX's draws: loss, mse and lpips within rtol 1e-4; every
    gradient (mu / (1 - b1) of the JAX AdamW state) within 4 times the
    port's own f32 spread between two conv backends plus PR 12's band, the
    whole within 1e-2 in relative L2 (PR 12's rtol 1e-4 is below f32's
    reach here: see the test); one compile a model;
  * the VQGAN's tri-state pin with the wrappers stubbed (CPU tensors sent
    down the CUDA branch): None launches C and D and leaves F off, True
    adds F, False launches none; `clone` shares the parameters and the
    output and gradient are the same under every pin;
  * the LPIPS term's decode runs pinned plain under autograd (no C or D
    where the step decodes), the encodes unpinned under no_grad (C and D);
  * `cli train` with `trainer: difir_lpips` and no weights: the WARNING,
    three steps with `lpips` in the log, validation with `val_lpips`, and a
    `Trainer` resumed from step 2 that continues bit for bit.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resshift_tpu import trainer as jtrainer
from resshift_tpu.convert import convert_unet_swin, convert_vqgan
from resshift_tpu.models.lpips import LPIPS as JLPIPS, convert_lpips
from resshift_tpu.pipeline import ResShiftPipeline as JPipe
from resshift_tpu_torch import cli
from resshift_tpu_torch.checkpoint import restore_train_state
from resshift_tpu_torch.convert import from_flax
from resshift_tpu_torch.models import vqgan as tvqgan
from resshift_tpu_torch.models.lpips import LPIPS, load_lpips
from resshift_tpu_torch.ops import flash_attention, tail, vq as vq_ops
from resshift_tpu_torch.pipeline import ResShiftPipeline
from resshift_tpu_torch.train_loop import Trainer
from resshift_tpu_torch.trainer import TrainConfig, TrainStep
from resshift_tpu_torch.utils.image_io import imwrite

torch.set_num_threads(2)


def _model(lq_size, cond_mask, image_size=16, ch=3):
    return dict(image_size=image_size, in_channels=ch, model_channels=32, out_channels=ch,
                attention_resolutions=[8], dropout=0.0, channel_mult=[1, 2],
                num_res_blocks=[1, 1], conv_resample=True, num_head_channels=16,
                use_scale_shift_norm=True, resblock_updown=False, swin_depth=2,
                swin_embed_dim=32, window_size=4, mlp_ratio=2, cond_lq=True,
                cond_mask=cond_mask, lq_size=lq_size)


def _config(sf, lq_size, cond_mask, ddconfig=None):
    dd = ddconfig or DDCONFIG
    return dict(
        task="test", sf=sf, model=_model(lq_size, cond_mask, 64 >> (len(dd["ch_mult"]) - 1),
                                         dd["z_channels"]),
        diffusion=dict(schedule_name="exponential", steps=4, min_noise_level=0.2,
                       etas_end=0.99, kappa=2.0, power=0.3, predict_type="xstart",
                       timestep_respacing=None, normalize_input=True, latent_flag=True,
                       scale_factor=1.0, sf=sf),
        autoencoder=dict(embed_dim=dd["z_channels"], n_embed=64, ddconfig=dd),
        inference=dict(chop_size=16 * 4 // sf, chop_stride=12 * 4 // sf, padding_offset=16))


DDCONFIG = dict(double_z=False, z_channels=3, resolution=64, in_channels=3, out_ch=3, ch=32,
                ch_mult=[1, 2, 4], num_res_blocks=1, attn_resolutions=[], dropout=0.0)
# bicsr: x4 from 16x16; inpainting: x1 at 64x64 with the mask (an LQ pyramid)
# faceir: x1 at 64x64 through an f8-style VQGAN (4 latent channels, 8x8
# latent) and the LQ pyramid from 64 down to 8
F8_DDCONFIG = dict(DDCONFIG, z_channels=4, ch_mult=[1, 2, 2, 4])
KINDS = {"bicsr": (_config(4, 16, False), 16), "inpaint": (_config(1, 64, True), 64),
         "faceir": (_config(1, 64, False, F8_DDCONFIG), 64)}
TRAIN = dict(lr=1e-3, lr_min=2e-4, lr_schedule="cosin", warmup_iterations=2, iterations=10,
             weight_decay=0.01, ema_rate=0.9, microbatch=2, loss_coef=(1.0, 0.5))
B1 = 0.9


def _walk(cfg):
    m = cfg["model"]
    return {k: m[k] for k in ("image_size", "channel_mult", "num_res_blocks",
                              "attention_resolutions", "swin_depth", "cond_lq", "lq_size")}


def _batch(kind, seed=0, n=4):
    cfg, lq_side = KINDS[kind]
    rng = np.random.default_rng(seed)
    out = {"gt": rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32),
           "lq": rng.uniform(-1, 1, (n, lq_side, lq_side, 3)).astype(np.float32)}
    if cfg["model"]["cond_mask"]:
        m = np.sign(rng.uniform(-1, 1, (n, lq_side, lq_side, 1))).astype(np.float32)
        out["mask"] = m
        out["lq"] = out["lq"] * (m < 0)
    return out


def _draws(key, sched_t, n_micro, mb, latent=(16, 16, 3)):
    """(t, noise) of each microbatch, split from `key` as the JAX step does."""
    out = []
    for k in jax.random.split(key, n_micro):
        kt, kn, _ = jax.random.split(k, 3)
        t = jax.random.randint(kt, (mb,), 0, sched_t)
        noise = jax.random.normal(kn, (mb,) + latent, dtype=jnp.float32)
        out.append((torch.tensor(np.asarray(t)).long(), torch.tensor(np.asarray(noise))))
    return out


@pytest.fixture(scope="module", params=sorted(KINDS))
def steps(request):
    """One JAX LPIPS step and the port's on the same weights and draws."""
    kind = request.param
    cfg = KINDS[kind][0]
    # the port's seeded weights, nonzero everywhere (so that every parameter
    # gets a gradient), carried to JAX by its own converters: no JAX init
    tp = ResShiftPipeline(cfg, dtype=torch.float32, device="cpu")
    tp.init_params(0)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for mod in (tp.unet, tp.vq):
            for t in mod.parameters():
                t.copy_(t + 0.02 * torch.randn(t.shape, generator=gen))
    lpips = load_lpips(None)
    with torch.no_grad():
        for i in range(5):
            lpips.lins[i].model[1].weight.uniform_(0, 1, generator=gen)
    np_sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    params = {"unet": convert_unet_swin(np_sd(tp.unet), **_walk(cfg)),
              "vqgan": convert_vqgan(np_sd(tp.vq), ch_mult=cfg["autoencoder"]["ddconfig"][
                  "ch_mult"], num_res_blocks=1)}
    lp = convert_lpips(np_sd(lpips))
    pipe = JPipe(cfg, dtype=jnp.float32)
    jcfg = jtrainer.TrainConfig(**TRAIN)
    state = jtrainer.create_state(params["unet"], jcfg)
    batch = _batch(kind)
    key = jax.random.PRNGKey(5)
    lpips_fn = lambda a, b: JLPIPS().apply({"params": lp}, a, b)
    new, jm = jax.jit(jtrainer.make_train_step(pipe, jcfg, lpips_fn=lpips_fn))(
        state, params["vqgan"], {k: jnp.asarray(v) for k, v in batch.items()}, key)

    step = TrainStep(tp, TrainConfig(**TRAIN), lpips=lpips)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    side = cfg["model"]["image_size"]
    draws = _draws(key, tp.sched.num_timesteps, 2, 2,
                   (side, side, cfg["model"]["in_channels"]))
    with torch.backends.mkldnn.flags(enabled=False):  # the same step on other conv kernels
        step.grads(tbatch, draws=draws)
    alt = {n: p.grad.clone() for n, p in step.named}
    tm = step(tbatch, draws=draws)
    return (kind, {k: float(v) for k, v in jm.items()}, new, step,
            {k: float(v) for k, v in tm.items()}, alt)


def test_lpips_step_metrics_match_jax(steps):
    kind, jm, _, _, tm, _ = steps
    assert set(tm) == set(jm) and "lpips" in tm and tm["lpips"] > 0
    for k in ("loss", "mse", "lpips", "loss_t0", "loss_tmid", "loss_tlast", "lr"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-7, err_msg=f"{kind} {k}")
    # the gradient's norm: within the f32 spread of the gradient (below)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-3, err_msg=kind)
    np.testing.assert_allclose(tm["loss"], tm["mse"] + 0.5 * tm["lpips"], rtol=1e-6)


def test_lpips_step_gradients_match_jax(steps):
    """The LPIPS term's gradient (back through 13 random VGG16 convs and the
    decoder) is ill-conditioned in f32: the port's own gradient moves by up
    to 1% of a tensor's largest value, and by 3.5e-3 in relative L2, when
    oneDNN's conv kernels are swapped for the native ones.  So each tensor
    is held within 4 times that spread (measured: 2.3 at most) plus PR 12's
    band (1e-4 of the tensor's largest value), and the whole gradient within
    1e-2 in relative L2 (measured: 4.8e-3)."""
    kind, _, new, step, _, alt = steps
    mu = from_flax(jax.tree_util.tree_map(np.asarray, new.opt_state[0].mu), "unet",
                   **_walk(KINDS[kind][0]))
    flat = {"port": [], "jax": []}
    for n, p in step.named:
        g, want = p.grad.numpy(), mu[n] / (1 - B1)
        spread = np.abs(g - alt[n].numpy()).max()
        err = np.abs(g - want).max()
        assert err <= 4 * spread + 1e-4 * np.abs(want).max() + 1e-7, (kind, n, err, spread)
        flat["port"].append(g.ravel())
        flat["jax"].append(want.ravel())
    g, want = (np.concatenate(v) for v in (flat["port"], flat["jax"]))
    assert np.linalg.norm(g - want) <= 1e-2 * np.linalg.norm(want)
    assert all(p.grad.abs().max() > 0 for _, p in step.named)
    assert not any(p.requires_grad for p in step.lpips.parameters())
    assert not any(p.requires_grad for p in step.pipe.vq.parameters())


# ------------------------------------------------------------ the VQGAN pin

@pytest.fixture
def launches(monkeypatch):
    """CPU tensors take the VQGAN's kernel branch; C and D are stubbed by
    their plain versions (C refusing autograd as its kernel does), F's
    wrapper records its `use_pallas`."""
    calls = []

    def attn(q, k, v):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise RuntimeError("flash_attn_1h has no backward")
        calls.append("C")
        return flash_attention.attention_plain(q, k, v)

    def nearest(flat, emb):
        calls.append("D")
        return vq_ops.nearest_codebook_indices_plain(flat, emb)

    orig_tail = tail.gn_silu_conv3x3

    def tail_fn(*a, use_pallas=False, **k):
        calls.append(("F", use_pallas))
        return orig_tail(*a, use_pallas=use_pallas, **k)

    monkeypatch.setattr(tvqgan, "_on_cpu", lambda x: False)
    monkeypatch.setattr(flash_attention, "flash_attention_1h", attn)
    monkeypatch.setattr(vq_ops, "nearest_codebook_indices", nearest)
    monkeypatch.setattr(tail, "gn_silu_conv3x3", tail_fn)
    return calls


@pytest.mark.parametrize("pin,want", [(None, ["C", "D", "C", ("F", False)]),
                                      (True, ["C", "D", "C", ("F", True)]),
                                      (False, [("F", False)])])
def test_vqgan_pin_is_tri_state(launches, pin, want):
    torch.manual_seed(0)
    vq = tvqgan.VQModel(DDCONFIG, n_embed=64, use_pallas=pin).eval()
    for p in vq.parameters():
        torch.nn.init.normal_(p, std=0.05)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    with torch.no_grad():
        out = vq.decode(vq.encode(x))
    assert launches == want
    plain = vq.clone(use_pallas=False)
    assert all(a is b for a, b in zip(plain.parameters(), vq.parameters()))
    assert all(m.use_pallas is False for m in plain.modules() if hasattr(m, "use_pallas"))
    assert vq.use_pallas is pin and vq.decoder.mid.attn_1.use_pallas is pin
    launches.clear()
    with torch.no_grad():
        torch.testing.assert_close(plain.decode(plain.encode(x)), out, rtol=0, atol=0)
    assert launches == [("F", False)]
    # under autograd: the plain clone decodes with a gradient; C refuses it
    with torch.no_grad():
        z = vq.encode(x)
    z.requires_grad_(True)
    plain.decode(z).square().sum().backward()
    assert z.grad.abs().max() > 0
    if pin is not False:
        with pytest.raises(RuntimeError, match="backward"):
            vq.decode(z)


def test_lpips_step_decodes_pinned_plain(launches):
    cfg = KINDS["bicsr"][0]
    pipe = ResShiftPipeline(cfg, dtype=torch.float32, device="cpu")
    pipe.init_params(0)
    step = TrainStep(pipe, TrainConfig(**TRAIN), lpips=LPIPS().eval())
    assert step.decode_vq.use_pallas is False and pipe.vq.use_pallas is None
    assert all(a is b for a, b in zip(step.decode_vq.parameters(), pipe.vq.parameters()))
    batch = {k: torch.from_numpy(v) for k, v in _batch("bicsr").items()}
    step.grads(batch, torch.Generator().manual_seed(0))
    # per microbatch: the two encodes launch C (unpinned, no_grad); the UNet
    # head and the decode under autograd launch neither C nor D, F off
    assert launches == (["C", "C", ("F", False), ("F", False)]) * 2


# ------------------------------------------------------------ the trainer

@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    for sub in ("lq", "gt"):
        (d / sub).mkdir()
    for i in range(6):
        imwrite(rng.uniform(0, 1, (16, 16, 3)), d / "lq" / f"{i}.png")
        imwrite(rng.uniform(0, 1, (64, 64, 3)), d / "gt" / f"{i}.png")
    return d


def _trainer_config(pairs):
    cfg = dict(KINDS["bicsr"][0], trainer="difir_lpips")
    cfg["data"] = dict(train=dict(type="base", params=dict(dir_path=str(pairs / "lq"),
                                                           extra_dir_path=str(pairs / "gt"))),
                       val=dict(type="base", params=dict(dir_path=str(pairs / "lq"),
                                                         extra_dir_path=str(pairs / "gt"))))
    cfg["train"] = dict(lr=1e-3, lr_schedule=None, warmup_iterations=1, iterations=3, batch=2,
                        microbatch=1, ema_rate=0.9, save_freq=2, log_freq=[1, 1000],
                        val_freq=2, val_max_images=2, lpips_path=None)
    return cfg


def test_trainer_lpips_steps_validates_and_resumes(pairs, tmp_path, capsys):
    """`cli train` on a JSON config with `trainer: difir_lpips`, then a
    `Trainer` resumed from its step-2 checkpoint."""
    cfg = _trainer_config(pairs)
    (tmp_path / "lpips.json").write_text(json.dumps(cfg))
    cli.main(["train", "--config", str(tmp_path / "lpips.json"), "--device", "cpu", "--fp32",
              "--seed", "0", "--save-dir", str(tmp_path / "a")])
    assert "RANDOM weights" in capsys.readouterr().out
    log = [json.loads(ln) for ln in (tmp_path / "a" / "train_log.jsonl").read_text().splitlines()]
    steps = [m for m in log if "loss" in m]
    assert [m["iter"] for m in steps] == [1, 2, 3]
    assert all(np.isfinite(m["lpips"]) and m["lpips"] > 0 for m in steps)
    val = [m for m in log if "val_psnr_y" in m]
    assert len(val) == 1 and val[0]["val_lpips"] > 0 and val[0]["val_n"] == 2
    resumed = Trainer(cfg, save_dir=str(tmp_path / "b"), seed=0, device="cpu",
                      resume=str(tmp_path / "a" / "ckpts" / "step_00000002"))
    assert resumed.start_iter == 2
    resumed.train(stop_iter=3)
    a = restore_train_state(tmp_path / "a" / "ckpts" / "step_00000003")
    b = restore_train_state(tmp_path / "b" / "ckpts" / "step_00000003")
    for part in ("params", "ema", "exp_avg", "exp_avg_sq"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)


def test_chip_smoke_lpips_configs_are_the_yamls():
    """The dicts `chip_smoke.py` phase 18 builds (the card's machine has no
    PyYAML) equal the shipped YAMLs, the data paths and weights replaced."""
    pytest.importorskip("yaml")
    import sys
    from pathlib import Path

    from resshift_tpu_torch.config import load_yaml_config

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    want = load_yaml_config(root / "configs" / "bicx4_swinunet_lpips.yaml")
    want["data"]["train"]["params"]["source_path"] = "HQ"
    want["data"]["val"]["params"].update(dir_path="VAL_LQ", extra_dir_path="VAL_GT")
    want["autoencoder"]["ckpt_path"] = want["train"]["lpips_path"] = None
    assert chip_smoke.bicsr_lpips_config("HQ", "VAL_LQ", "VAL_GT") == want
    want = load_yaml_config(root / "configs" / "inpaint_lama256_face.yaml")
    want["data"]["train"]["params"]["dir_path"] = "IM"
    want["data"]["val"]["params"].update(lq_path="LQ", gt_path="GT", mask_path="MASK")
    want["autoencoder"]["ckpt_path"] = want["train"]["lpips_path"] = None
    assert chip_smoke.inpaint_face_lpips_config("IM", "LQ", "GT", "MASK") == want
