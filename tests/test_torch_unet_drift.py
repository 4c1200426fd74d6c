"""Phase 20(a)'s option set in bf16: a drift of the architecture, not of
the port.

On the card (chip_smoke.py phase 20(a)) `resblock_updown` + `patch_norm` +
`use_scale_shift_norm: false` left the kernel path's final latent 31.61 dB
from the plain clone's, where the default options give 47.26 dB: two bf16
chains that round in different places.  Here, on the CPU and at a small
width, the 15-step realsr_v1 chain runs on the same weights through the JAX
package's XLA path and the port's plain path, each in bf16 and in f32, with
the same draws.  Each bf16 chain is held against its own f32 chain:

  * in f32 the two packages agree (final latent >= 90 dB apart in PSNR);
  * the port's bf16 chain drifts from its f32 chain no more than JAX's does
    from its own, within 2 dB (measured: 33.65 against 33.35 dB under the
    default options, 18.16 against 17.79 dB under phase 20(a)'s);
  * under phase 20(a)'s options both packages drift at least 10 dB further
    than under the default options (measured: 15.6 dB further in JAX, 15.5
    in the port).

So this option set amplifies bf16 rounding in any implementation (ROADMAP.md
section 3 records it as a divergence of the architecture).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resshift_tpu.diffusion import build_schedule as jbuild
from resshift_tpu.diffusion import resshift as jrs
from resshift_tpu.models import UNetModelSwin as JUNet
from resshift_tpu_torch.convert import from_flax
from resshift_tpu_torch.diffusion import build_schedule
from resshift_tpu_torch.diffusion import resshift as trs
from resshift_tpu_torch.models.unet import UNetModelSwin
from tests.test_torch_unet_options import CFG, WALK_KEYS, random_params

torch.set_num_threads(2)

STEPS, B = 15, 4
SETS = {"default": {},
        "20a1": dict(resblock_updown=True, patch_norm=True, use_scale_shift_norm=False)}


def _db(x, y) -> float:
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return 10 * math.log10(np.abs(y).max() ** 2 / max(((x - y) ** 2).mean(), 1e-30))


@pytest.fixture(scope="module")
def chains():
    """The final latent of each package's chain, by option set and dtype."""
    rng = np.random.default_rng(0)
    z_y, lq, noise = (rng.standard_normal((B, 16, 16, 3)).astype(np.float32),
                      rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
                      rng.standard_normal((B, 16, 16, 3)).astype(np.float32))
    step_noise = rng.standard_normal((STEPS, B, 16, 16, 3)).astype(np.float32)
    kw = dict(steps=STEPS, min_noise_level=0.04, kappa=2.0)  # realsr_v1's schedule
    js, ts = jbuild(**kw), build_schedule(**kw)
    out = {}
    for name, opts in SETS.items():
        cfg = {**CFG, **opts}
        params = random_params(lambda: JUNet(**cfg, use_pallas=False).init(
            jax.random.PRNGKey(0), z_y, np.zeros(B, np.int32), lq=lq), 0)
        sd = {k: torch.tensor(v) for k, v in
              from_flax(params, "unet", **{k: cfg[k] for k in WALK_KEYS}).items()}
        for dt, jdt, tdt in (("f32", jnp.float32, torch.float32),
                             ("bf16", jnp.bfloat16, torch.bfloat16)):
            jm = JUNet(**cfg, dtype=jdt, use_pallas=False)
            run = jax.jit(lambda p, jm=jm: jrs.sample_loop(
                js, lambda x, t, **k: jm.apply({"params": p}, x, t, **k), jnp.asarray(z_y),
                jax.random.PRNGKey(0), noise=jnp.asarray(noise),
                step_noise=jnp.asarray(step_noise), clip_denoised=False,
                model_kwargs={"lq": jnp.asarray(lq)}))
            out[name, "jax", dt] = np.asarray(run(params).astype(jnp.float32))
            tm = UNetModelSwin(**cfg, dtype=tdt, use_pallas=False)
            tm.load_state_dict(sd)
            with torch.no_grad():
                out[name, "port", dt] = trs.sample_loop(
                    ts, tm.eval(), torch.from_numpy(z_y), None, noise=torch.from_numpy(noise),
                    step_noise=torch.from_numpy(step_noise), clip_denoised=False,
                    model_kwargs={"lq": torch.from_numpy(lq)}).float().numpy()
    return out


@pytest.mark.parametrize("name", sorted(SETS))
def test_f32_chains_agree(chains, name):
    assert _db(chains[name, "port", "f32"], chains[name, "jax", "f32"]) >= 90.0


@pytest.mark.parametrize("name", sorted(SETS))
def test_port_bf16_drifts_no_more_than_jax(chains, name):
    drift = {pkg: _db(chains[name, pkg, "bf16"], chains[name, pkg, "f32"])
             for pkg in ("jax", "port")}
    assert drift["port"] >= drift["jax"] - 2.0, drift


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_phase_20a_options_drift_in_both_packages(chains, pkg):
    drift = {name: _db(chains[name, pkg, "bf16"], chains[name, pkg, "f32"]) for name in SETS}
    assert drift["20a1"] <= drift["default"] - 10.0, drift
