"""Data-parallel and FSDP training of the port across real processes, on the
CPU (gloo), through `resshift_tpu_torch.tools.multiprocess_proof`.

  * DP: two ranks train three iterations through `Trainer`: the parameters,
    the EMA and the AdamW moments hash the same on both, the loader's items
    are disjoint, only rank 0 wrote the log, validation's items were split
    over the ranks, the checkpoint is on disk;
  * FSDP: the same run with `train.fsdp: true`: each rank holds half of
    every large parameter, the state after the first step equals the DP
    run's within float32 rounding, and the checkpoint it wrote resumes in a
    single-process `Trainer`;
  * one DP step over two ranks with the global draws handed over, each rank
    taking its rows: the update and the EMA equal the single-process step on
    the global batch, and the JAX package's DP step on a two-device CPU mesh
    (the same draws, split from its key), within the band of
    `tests/test_torch_train_step.py::test_update_and_ema_match_jax`; its
    logged metrics are the JAX step's over the global batch, with
    microbatches and without (the per-timestep buckets then summed over the
    ranks before the division by their counts).

Each spawned process has 120 s and is killed by the tool's `finally`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resshift_tpu import trainer as jtrainer
from resshift_tpu.parallel.mesh import data_parallel_shardings, make_mesh
from resshift_tpu.pipeline import ResShiftPipeline as JPipe
from resshift_tpu_torch.checkpoint import restore_train_state
from resshift_tpu_torch.convert import from_flax
from resshift_tpu_torch.pipeline import ResShiftPipeline
from resshift_tpu_torch.tools import multiprocess_proof as mp
from resshift_tpu_torch.train_loop import Trainer
from resshift_tpu_torch.trainer import TrainConfig, TrainStep, lr_schedule_fn
from tests.test_torch_unet_options import random_params

torch.set_num_threads(2)

# pixel space at sf 1 (the JAX package's multiprocess proof's shape of task),
# so that the JAX step compiles quickly
MODEL = dict(image_size=16, in_channels=3, model_channels=32, out_channels=3,
             attention_resolutions=[16, 8], dropout=0.0, channel_mult=[1, 2],
             num_res_blocks=[1, 1], conv_resample=True, num_head_channels=16,
             use_scale_shift_norm=True, resblock_updown=False, swin_depth=2, swin_embed_dim=32,
             window_size=4, mlp_ratio=2, cond_lq=True, cond_mask=False, lq_size=16)
WALK = dict(image_size=16, channel_mult=[1, 2], num_res_blocks=[1, 1],
            attention_resolutions=[16, 8], swin_depth=2, lq_size=16)
CONFIG = dict(
    task="test", sf=1, model=MODEL,
    diffusion=dict(schedule_name="exponential", steps=4, min_noise_level=0.2, etas_end=0.99,
                   kappa=2.0, power=0.3, predict_type="xstart", timestep_respacing=None,
                   normalize_input=True, latent_flag=False, scale_factor=1.0, sf=1),
    autoencoder=None, inference=dict(chop_size=16, chop_stride=16, padding_offset=16))
TRAIN = dict(lr=1e-3, lr_min=2e-4, lr_schedule="cosin", warmup_iterations=2, iterations=10,
             weight_decay=0.01, ema_rate=0.9, microbatch=2)
BATCH = 4  # global: two ranks of one microbatch of two


# ------------------------------------------------------------ Trainer runs

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two ranks train 3 iterations data-parallel, then 3 with FSDP."""
    out = tmp_path_factory.mktemp("runs")
    return out, mp.launch(out, nproc=2, iters=3, modes=("dp", "fsdp"), timeout=120,
                          step1=True)


@pytest.mark.parametrize("key", ["params_identical", "ema_identical", "opt_identical",
                                 "loader_sharded", "rank0_log_only", "checkpoint_written",
                                 "validated", "val_sharded"])
def test_dp_training_across_two_ranks(runs, key):
    _, rep = runs
    assert rep["exit_codes"] == [0, 0], rep
    assert rep["dp"][key] and rep["dp"]["step"] == 3 and not rep["dp"]["fsdp"], rep


def test_fsdp_training_shards_the_state(runs):
    """Every parameter of 4096 elements or more is cut in two (dim 0 over
    two ranks), as `tests/test_fsdp.py::test_fsdp_state_really_partitioned`
    holds the JAX state to 1/8 on eight devices; the gathered state is the
    same on both ranks and the run's checks pass."""
    _, rep = runs
    assert rep["ok"] and rep["fsdp"]["fsdp"], rep
    assert rep["fsdp"]["shard_share"] <= 0.5 + 1e-9, rep
    assert rep["fsdp"]["validated"] == 1, rep  # logged once, by rank 0, on the gathered EMA
    assert rep["fsdp"]["val_sharded"], rep


def test_fsdp_step_equals_the_dp_step(runs):
    """The same data and draws: after one step the FSDP state equals DP's
    within float32 rounding (the gradients are reduce-scattered there,
    all-reduced here: another order of the same sums).  Adam's first update
    is lr * sign(g) wherever |g| is well above its eps; no sign flips: the
    parameters within 1e-6 of their O(1) values."""
    dp, fs = (torch.load(runs[0] / mode / "step1.pt") for mode in ("dp", "fsdp"))
    assert dp["step"] == fs["step"] == 1
    for part, atol in (("params", 1e-6), ("ema", 1e-6), ("exp_avg", 1e-7),
                       ("exp_avg_sq", 1e-9)):
        assert dp[part].keys() == fs[part].keys()
        for k, v in dp[part].items():
            torch.testing.assert_close(fs[part][k], v, rtol=1e-5, atol=atol, msg=f"{part} {k}")


def test_fsdp_checkpoint_resumes_in_one_process(runs):
    """The checkpoint is the whole state (gathered on save): a trainer
    without a process group resumes it unsharded, at its step."""
    out, rep = runs
    step = rep["fsdp"]["step"]
    ckpt = out / "fsdp" / "run" / "ckpts" / f"step_{step:08d}"
    saved = restore_train_state(ckpt)
    cfg = mp.small_config(out / "data", 3, 2)
    cfg["train"]["fsdp"] = True
    tr = Trainer(cfg, save_dir=str(out / "resumed"), resume=str(ckpt), seed=0, device="cpu")
    assert tr.start_iter == step and not tr.step_fn.fsdp
    got = tr.step_fn.state_dict()
    for part in ("params", "ema", "exp_avg", "exp_avg_sq"):
        for k, v in saved[part].items():
            torch.testing.assert_close(got[part][k], v, rtol=0, atol=0, msg=f"{part} {k}")


# ------------------------------------------------------------ one DP step

def _draws(key, mb):
    """(t, noise) of each microbatch of `mb` rows of the global batch (the
    whole batch where `mb` is None), split from `key` as the JAX step does."""
    out = []
    for k in jax.random.split(key, BATCH // mb) if mb else [key]:
        kt, kn, _ = jax.random.split(k, 3)
        t = jax.random.randint(kt, (mb or BATCH,), 0, CONFIG["diffusion"]["steps"])
        noise = jax.random.normal(kn, (mb or BATCH, 16, 16, 3), dtype=jnp.float32)
        out.append((torch.tensor(np.asarray(t)).long(), torch.tensor(np.asarray(noise))))
    return out


def _jax_and_port_steps(tmp, train):
    """The JAX package's DP step on a two-device mesh and the port's step
    over two gloo ranks under the `train:` block `train`, from the same
    weights, batch and draws: (weights, batch, draws, the JAX state after,
    its metrics, the port's state after, its metrics)."""
    pipe = JPipe(CONFIG, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    batch = {"gt": rng.uniform(-1, 1, (BATCH, 16, 16, 3)).astype(np.float32),
             "lq": rng.uniform(-1, 1, (BATCH, 16, 16, 3)).astype(np.float32)}
    # nonzero everywhere (every parameter moves), from shapes alone: no init compile
    params = {"unet": random_params(lambda: pipe.unet.init(
        jax.random.PRNGKey(0), batch["gt"], np.zeros(BATCH, np.int32), lq=batch["lq"]), 9)}
    key = jax.random.PRNGKey(5)
    cfg = jtrainer.TrainConfig(**train)
    state = jtrainer.create_state(params["unet"], cfg)
    mesh = make_mesh(2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state_sh, batch_sh = data_parallel_shardings(mesh, state, jb)
    key_sh, _ = data_parallel_shardings(mesh, key, jb)
    jstep = jax.jit(jtrainer.make_train_step(pipe, cfg),
                    in_shardings=(state_sh, None, batch_sh, key_sh))
    with mesh:
        jnew, jmetrics = jstep(state, None, jb, key)
    flat = lambda tree: from_flax(jax.tree_util.tree_map(np.asarray, tree), "unet", **WALK)
    jax_after = {"params": flat(jnew.params), "ema": flat(jnew.ema_params),
                 "exp_avg": flat(jnew.opt_state[0].mu)}

    unet = {k: torch.tensor(v) for k, v in flat(params["unet"]).items()}
    draws = _draws(key, train["microbatch"])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    spec = tmp / "spec.pt"
    torch.save({"config": CONFIG, "train": train, "unet": unet, "batch": tb, "draws": draws},
               spec)
    rep = mp.launch_step(tmp, spec, nproc=2, timeout=120)
    assert rep["ok"], rep
    dp = torch.load(tmp / "dp" / "step.pt")
    return (unet, tb, draws, jax_after, {k: float(v) for k, v in jmetrics.items()},
            dp["state"], dp["metrics"])


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The JAX package's DP step on a two-device mesh, the port's step over
    two gloo ranks, and the port's single-process step, from the same
    weights, batch and draws."""
    unet, tb, draws, jax_after, jmetrics, dp, dp_metrics = _jax_and_port_steps(
        tmp_path_factory.mktemp("step"), TRAIN)
    port = ResShiftPipeline(CONFIG, dtype=torch.float32, device="cpu")
    port.load_state_dicts(unet=unet)
    single = TrainStep(port, TrainConfig(**TRAIN))
    single(tb, draws=draws)
    return unet, jax_after, dp, single.state_dict(), (jmetrics, dp_metrics)


def _within_the_train_step_band(before, got, want):
    """As `test_update_and_ema_match_jax`: Adam's first update, lr * g / (|g|
    + eps), agrees within 1e-3 of lr wherever |mu| is above 1e-5 of its
    largest over all tensors (where |g| is at rounding level the two may
    take opposite signs: at most 5% of the values lie below that floor);
    the EMA's move off the old weights within 1e-3 of lr * (1 - ema_rate)
    plus the f32 spacing of the weights there, within 2 lr (1 - ema_rate)
    everywhere."""
    lr = lr_schedule_fn(TrainConfig(**TRAIN))(0)
    ema_tol = 1e-3 * lr * (1 - TRAIN["ema_rate"])
    floor = 1e-5 * max(np.abs(v).max() for v in want["exp_avg"].values())
    below = total = 0
    for n, old in before.items():
        old = old.numpy()
        keep = np.abs(np.asarray(want["exp_avg"][n])) > floor
        below += (~keep).sum()
        total += keep.size
        upd, want_upd = got["params"][n].numpy() - old, np.asarray(want["params"][n]) - old
        np.testing.assert_allclose(upd[keep], want_upd[keep], rtol=0, atol=1e-3 * lr, err_msg=n)
        moved, want_moved = got["ema"][n].numpy() - old, np.asarray(want["ema"][n]) - old
        off = np.abs(moved - want_moved) - 2 * np.spacing(np.abs(old).astype(np.float32))
        assert (off[keep] <= ema_tol).all(), (n, off[keep].max(), ema_tol)
        np.testing.assert_allclose(moved, want_moved, rtol=0,
                                   atol=2 * lr * (1 - TRAIN["ema_rate"]) + 1e-6, err_msg=n)
    assert below / total < 0.05, below / total


def test_dp_step_equals_the_single_process_step(steps):
    unet, _, dp, single, _ = steps
    assert dp["step"] == single["step"] == 1
    _within_the_train_step_band(unet, dp, {k: {n: v.numpy() for n, v in single[k].items()}
                                           for k in ("params", "ema", "exp_avg")})


def test_dp_step_equals_jax_dp_step_on_two_devices(steps):
    """Transitively the JAX package's single-device step too: JAX's own
    tests hold its DP step to it (`tests/test_fsdp.py`)."""
    unet, jax_after, dp, _, _ = steps
    _within_the_train_step_band(unet, dp, jax_after)


@pytest.mark.parametrize("microbatch", [2, None])
def test_dp_step_logs_the_jax_metrics(steps, tmp_path, microbatch):
    """The metrics of one DP step over two ranks equal those that the JAX
    package's step logs on a two-device mesh.  With microbatches of two,
    each rank's one microbatch is a global microbatch, and the buckets are
    the mean of the ranks' means; without, the global batch is one
    microbatch, whose draws here fill a bucket unevenly over the ranks (so
    the mean of the ranks' means would differ), and each bucket is its sum
    over the ranks over its count."""
    if microbatch:
        jmetrics, metrics = steps[-1]
    else:
        _, _, draws, _, jmetrics, _, metrics = _jax_and_port_steps(
            tmp_path, dict(TRAIN, microbatch=None))
        t = draws[0][0]
        half = lambda r, tt: int((t[2 * r:2 * r + 2] == tt).sum())
        assert any(half(0, tt) != half(1, tt) and half(0, tt) + half(1, tt)
                   for tt in (0, 2, 3)), t
    assert set(metrics) == set(jmetrics), (set(metrics), set(jmetrics))
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
