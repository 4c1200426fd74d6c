"""The port's train step against the JAX package's, on the CPU in f32.

  * `training_losses` for each model mean type, with and without
    `weighted_mse` (and the epsilon_scale divide), on a fixed model function:
    rtol 1e-5;
  * one JAX `train_step` (two microbatches) against the port's
    `TrainStep` given the same draws (t and the noise rebuilt from the JAX
    key as its `loss_fn` splits it), on the same weights: the metrics, every
    gradient (the port's `.grad` against mu / (1 - b1) of the JAX AdamW
    state, through `from_flax`), the AdamW moments, the update where |g| is
    above a floor, and the EMA;
  * the learning rate at steps 0, in warmup, mid-run and at the end;
  * microbatches against the whole batch, remat ("dots", "full") against
    none, dropout live in the train step only;
  * `convert.train_state_from_flax` into `TrainStep.load_state_dict`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resshift_tpu import trainer as jtrainer
from resshift_tpu.diffusion import resshift as jrs
from resshift_tpu.diffusion.schedule import build_schedule as jbuild
from resshift_tpu.pipeline import ResShiftPipeline as JPipe
from resshift_tpu_torch.convert import from_flax, train_state_from_flax
from resshift_tpu_torch.diffusion import resshift as trs
from resshift_tpu_torch.diffusion.schedule import build_schedule as tbuild
from resshift_tpu_torch.pipeline import ResShiftPipeline
from resshift_tpu_torch.trainer import TrainConfig, TrainStep, lr_schedule_fn

torch.set_num_threads(2)

MODEL = dict(image_size=16, in_channels=3, model_channels=32, out_channels=3,
             attention_resolutions=[16, 8], dropout=0.0, channel_mult=[1, 2],
             num_res_blocks=[1, 1], conv_resample=True, num_head_channels=16,
             use_scale_shift_norm=True, resblock_updown=False, swin_depth=2, swin_embed_dim=32,
             window_size=4, mlp_ratio=2, cond_lq=True, cond_mask=False, lq_size=16)
WALK = dict(image_size=16, channel_mult=[1, 2], num_res_blocks=[1, 1],
            attention_resolutions=[16, 8], swin_depth=2, lq_size=16)
CONFIG = dict(
    task="test", sf=4, model=MODEL,
    diffusion=dict(schedule_name="exponential", steps=4, min_noise_level=0.2, etas_end=0.99,
                   kappa=2.0, power=0.3, predict_type="xstart", timestep_respacing=None,
                   normalize_input=True, latent_flag=True, scale_factor=1.0, sf=4),
    autoencoder=dict(embed_dim=3, n_embed=64, ddconfig=dict(
        double_z=False, z_channels=3, resolution=64, in_channels=3, out_ch=3, ch=32,
        ch_mult=[1, 2, 4], num_res_blocks=1, attn_resolutions=[], dropout=0.0)),
    inference=dict(chop_size=16, chop_stride=12, padding_offset=16))
TRAIN = dict(lr=1e-3, lr_min=2e-4, lr_schedule="cosin", warmup_iterations=2, iterations=10,
             weight_decay=0.01, ema_rate=0.9, microbatch=2)
B1 = 0.9


def _port_pipe(params, config=CONFIG):
    pipe = ResShiftPipeline(config, dtype=torch.float32, device="cpu")
    as_t = lambda sd: {k: torch.tensor(v) for k, v in sd.items()}
    pipe.load_state_dicts(unet=as_t(from_flax(params["unet"], "unet", **WALK)),
                          vqgan=as_t(from_flax(params["vqgan"], "vqgan", ch_mult=[1, 2, 4],
                                               num_res_blocks=1)))
    return pipe


def _batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return {"gt": rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32),
            "lq": rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32)}


def _draws(key, sched_t, n_micro, mb):
    """(t, noise) of each microbatch, split from `key` as the JAX step does."""
    out = []
    for k in jax.random.split(key, n_micro):
        kt, kn, _ = jax.random.split(k, 3)
        t = jax.random.randint(kt, (mb,), 0, sched_t)
        noise = jax.random.normal(kn, (mb, 16, 16, 3), dtype=jnp.float32)
        out.append((torch.tensor(np.asarray(t)).long(), torch.tensor(np.asarray(noise))))
    return out


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step from seeded weights: (params, state after, metrics, batch, key)."""
    pipe = JPipe(CONFIG, dtype=jnp.float32)
    params = pipe.init_params(jax.random.PRNGKey(0))
    # nonzero zero-initialised convs, so that every parameter gets a gradient
    rng = np.random.default_rng(9)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.02 * rng.standard_normal(p.shape).astype(np.float32), params)
    cfg = jtrainer.TrainConfig(**TRAIN)
    state = jtrainer.create_state(params["unet"], cfg)
    batch = _batch()
    key = jax.random.PRNGKey(5)
    new, metrics = jax.jit(jtrainer.make_train_step(pipe, cfg))(
        state, params["vqgan"], {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return params, state, new, {k: float(v) for k, v in metrics.items()}, batch, key


@pytest.fixture(scope="module")
def port_step(jax_step):
    params, _, _, _, batch, key = jax_step
    pipe = _port_pipe(params)
    step = TrainStep(pipe, TrainConfig(**TRAIN))
    before = {n: p.detach().clone() for n, p in step.named}
    draws = _draws(key, pipe.sched.num_timesteps, 2, 2)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
    return step, before, {k: float(v) for k, v in metrics.items()}, draws


def _flat(tree):
    return {k: v for k, v in from_flax(jax.tree_util.tree_map(np.asarray, tree), "unet",
                                       **WALK).items()}


# ------------------------------------------------------------ training_losses

@pytest.mark.parametrize("mtype", ["xstart", "residual", "epsilon", "epsilon_scale"])
@pytest.mark.parametrize("weighted", [False, True])
def test_training_losses_match_jax(mtype, weighted):
    kw = dict(steps=5, min_noise_level=0.1, kappa=1.5, predict_type=mtype)
    js, ts = jbuild(**kw), tbuild(**kw)
    rng = np.random.default_rng(1)
    z0, zy, noise = (rng.standard_normal((3, 8, 8, 3)).astype(np.float32) for _ in range(3))
    t = np.array([0, 2, 4], np.int32)
    model = lambda x, tt, **_: 0.7 * x + 0.01 * tt[:, None, None, None]
    want = jrs.training_losses(js, model, jnp.asarray(z0), jnp.asarray(zy), jnp.asarray(t),
                               jnp.asarray(noise), weighted_mse=weighted)
    got = trs.training_losses(ts, model, torch.from_numpy(z0), torch.from_numpy(zy),
                              torch.from_numpy(t).long(), torch.from_numpy(noise),
                              weighted_mse=weighted)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_q_posterior_and_mean_variance_match_jax():
    js, ts = jbuild(steps=6, min_noise_level=0.05), tbuild(steps=6, min_noise_level=0.05)
    rng = np.random.default_rng(2)
    x0, y = (rng.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(2))
    t = np.array([1, 5])
    for jf, tf in ((jrs.q_mean_variance, trs.q_mean_variance),
                   (jrs.q_posterior_mean_variance, trs.q_posterior_mean_variance)):
        want = jf(js, jnp.asarray(x0), jnp.asarray(y), jnp.asarray(t))
        got = tf(ts, torch.from_numpy(x0), torch.from_numpy(y), torch.from_numpy(t))
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.broadcast_to(g.numpy(), np.shape(w)), np.asarray(w),
                                       rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------ one step

def test_metrics_match_jax(jax_step, port_step):
    _, _, _, jm, _, _ = jax_step
    _, _, tm, _ = port_step
    assert set(tm) == set(jm)
    for k in jm:  # f32 through the VQGAN, the UNet and back
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-7, err_msg=k)


def test_gradients_and_moments_match_jax(jax_step, port_step):
    _, _, new, _, _, _ = jax_step
    step, _, _, _ = port_step
    mu, nu = _flat(new.opt_state[0].mu), _flat(new.opt_state[0].nu)
    sd = step.state_dict()
    # the gradient (mu / (1 - b1)) and mu within rtol 1e-4 and 1e-4 of the
    # tensor's largest value, nu within 2e-4; a floor of 1e-7 (gradient) for
    # the tensors whose gradient is zero but for rounding (a conv bias
    # before a GroupNorm of one channel a group, ~5e-9)
    for n, p in step.named:
        g, want = p.grad.numpy(), mu[n] / (1 - B1)
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-4 * np.abs(want).max() + 1e-7,
                                   err_msg=n)
        np.testing.assert_allclose(sd["exp_avg"][n].numpy(), mu[n], rtol=1e-4,
                                   atol=1e-4 * np.abs(mu[n]).max() + 1e-8, err_msg=n)
        np.testing.assert_allclose(sd["exp_avg_sq"][n].numpy(), nu[n], rtol=2e-4,
                                   atol=2e-4 * np.abs(nu[n]).max() + 1e-14, err_msg=n)
    assert all(p.grad.abs().max() > 0 for _, p in step.named)


def test_update_and_ema_match_jax(jax_step, port_step):
    """Adam's first update is lr * g / (|g| + eps): where |g| is at rounding
    level the two may take opposite signs.  The update agrees within 1e-3
    of lr wherever |mu| is above 1e-5 of its largest over all tensors; the
    values below that floor are under 5% of all.  The EMA's move off the
    old weights, (1 - ema_rate) times the update, agrees on the same
    elements within 1e-3 of lr * (1 - ema_rate), plus the f32 spacing of
    the weights that the move is taken from; an EMA left where it started
    is off by (1 - ema_rate) * lr there, 100 times that."""
    params, _, new, _, _, _ = jax_step
    step, before, _, _ = port_step
    p_new, ema, mu = _flat(new.params), _flat(new.ema_params), _flat(new.opt_state[0].mu)
    lr = lr_schedule_fn(TrainConfig(**TRAIN))(0)
    ema_tol = 1e-3 * lr * (1 - TRAIN["ema_rate"])
    floor = 1e-5 * max(np.abs(v).max() for v in mu.values())
    below = total = 0
    for n, p in step.named:
        g = np.abs(mu[n])
        keep = g > floor
        below += (~keep).sum()
        total += g.size
        old = before[n].numpy()
        got = (p.detach() - before[n]).numpy()
        want = p_new[n] - old
        np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=1e-3 * lr, err_msg=n)
        moved, want_moved = step.ema[n].numpy() - old, ema[n] - old
        off = np.abs(moved - want_moved) - 2 * np.spacing(np.abs(old).astype(np.float32))
        assert (off[keep] <= ema_tol).all(), (n, off[keep].max(), ema_tol)
        # below the floor the updates (so the EMAs) may differ by 2 lr
        np.testing.assert_allclose(moved, want_moved, rtol=0,
                                   atol=2 * lr * (1 - TRAIN["ema_rate"]) + 1e-6, err_msg=n)
    assert below / total < 0.05, below / total
    assert step.step == int(new.step) == 1


@pytest.mark.parametrize("step_no", [0, 1, 5, 9, 10])
def test_learning_rate_matches_jax(step_no):
    for sched in ("cosin", None):
        kw = dict(TRAIN, lr_schedule=sched, warmup_iterations=3)
        want = float(jtrainer.lr_schedule_fn(jtrainer.TrainConfig(**kw))(step_no))
        assert lr_schedule_fn(TrainConfig(**kw))(step_no) == pytest.approx(want, rel=1e-7)


def test_train_state_from_flax(jax_step):
    params, _, new, _, _, _ = jax_step
    sd = train_state_from_flax(new, **WALK)
    step = TrainStep(_port_pipe(params), TrainConfig(**TRAIN))
    step.load_state_dict(sd)
    assert step.step == 1
    got = step.state_dict()
    for part, tree in (("params", new.params), ("ema", new.ema_params),
                       ("exp_avg", new.opt_state[0].mu), ("exp_avg_sq", new.opt_state[0].nu)):
        for n, v in _flat(tree).items():
            np.testing.assert_array_equal(got[part][n].numpy(), v, err_msg=f"{part} {n}")
    # the next update runs from the restored moments and step
    assert step.opt.state[step.named[0][1]]["step"].item() == 1


# ------------------------------------------------------------ variants

@pytest.fixture(scope="module")
def small_pipe(jax_step):
    return jax_step[0]


def _grads(params, draws, batch, config=CONFIG, **tcfg):
    step = TrainStep(_port_pipe(params, config), TrainConfig(**dict(TRAIN, **tcfg)))
    metrics = step.grads({k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
    return {n: p.grad.clone() for n, p in step.named}, metrics, step


def test_microbatches_equal_the_whole_batch(small_pipe, port_step):
    _, _, _, draws = port_step
    batch = _batch()
    g2, m2, _ = _grads(small_pipe, draws, batch)
    whole = [(torch.cat([d[0] for d in draws]), torch.cat([d[1] for d in draws]))]
    g1, m1, _ = _grads(small_pipe, whole, batch, microbatch=None)
    for n in g1:  # the mean of two means of two against one mean of four (floor as above)
        torch.testing.assert_close(g2[n], g1[n], rtol=1e-4,
                                   atol=1e-4 * g1[n].abs().max().item() + 1e-7)
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_equals_no_remat(small_pipe, port_step, remat):
    _, _, _, draws = port_step
    batch = _batch()
    g0, m0, _ = _grads(small_pipe, draws, batch)
    g1, m1, _ = _grads(small_pipe, draws, batch, remat=remat)
    for n in g0:  # the recomputed forward is the same arithmetic
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0, msg=n)
    assert float(m0["loss"]) == float(m1["loss"])


def test_dropout_is_live_in_the_train_step_only(small_pipe, port_step):
    _, _, _, draws = port_step
    cfg = dict(CONFIG, model=dict(MODEL, dropout=0.5))
    batch = _batch()
    gen = lambda: torch.Generator().manual_seed(3)
    step = TrainStep(_port_pipe(small_pipe, cfg), TrainConfig(**TRAIN))
    assert step.train_unet.training and not step.pipe.unet.training
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    a = step.grads(tb, gen(), draws)["loss"]
    b = step.grads(tb, gen(), draws)["loss"]
    c = step.grads(tb, torch.Generator().manual_seed(4), draws)["loss"]
    assert float(a) == float(b) != float(c)  # the step's generator seeds the dropout
    _, m0, _ = _grads(small_pipe, draws, batch)  # the same weights without dropout
    assert float(a) != float(m0["loss"])


def test_fsdp_and_unknown_remat_raise(small_pipe):
    """An unknown remat raises.  FSDP no longer does: without a process
    group the step runs unsharded on the pipeline's own parameters, as the
    JAX package's does on one device (tests/test_torch_parallel_train.py
    shards it over two ranks)."""
    pipe = _port_pipe(small_pipe)
    step = TrainStep(pipe, TrainConfig(fsdp=True))
    assert not step.fsdp and step.named == list(pipe.unet.named_parameters())
    with pytest.raises(ValueError, match="remat"):
        TrainStep(pipe, TrainConfig(remat="all"))


def test_batch_not_a_multiple_of_the_microbatch_raises(small_pipe):
    """The JAX step's reshape to (n_micro, microbatch) fails there; the
    port's step refuses it rather than training on part of the batch."""
    step = TrainStep(_port_pipe(small_pipe), TrainConfig(**TRAIN))  # microbatch 2
    batch = {k: torch.from_numpy(v) for k, v in _batch(n=3).items()}
    with pytest.raises(ValueError, match="not a multiple of the microbatch 2"):
        step.grads(batch)
