"""The port's pipeline parallelism (parallel/pp.py, `sample_pipelined`) on
the CPU in f32: the JAX package's tests/test_pp.py with the same inputs,
the stages a list of CPU "devices" (a device listed k times holds k
replicas of the models, one a stage).

Staging never changes the math: each chunk's chain is the same sequence of
steps on its rows of the draws that `sample(..., tile_bs=chunk_bs)` takes,
so the port is held to its own `sample`: per chunk within atol 5e-5 /
rtol 1e-5 in pixel space, and bit for bit where the chunks are `sample`'s
tile batches.  It is also held to the JAX package's `sample_pipelined` on
the virtual `stage` mesh in pixel space, within atol 5e-4 / rtol 1e-4, the
port given the draws that JAX's chunk walk takes for the same key.
`stage_slices` is held to the JAX package's for every chain and stage count
the samplers take.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from resshift_tpu.convert import convert_unet_swin
from resshift_tpu.parallel import pp as jpp
from resshift_tpu.pipeline import ResShiftPipeline as JPipeline
from resshift_tpu_torch.parallel import pp
from resshift_tpu_torch.pipeline import ResShiftPipeline
from tests.test_pipeline import tiny_config
from tests.test_torch_pipeline import _random_state_dict
from tests.test_torch_tp import _jax_draws

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _psnr(a, b) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10 * np.log10(4.0 / mse) if mse > 0 else np.inf


def _pipe(cfg, seed=0):
    p = ResShiftPipeline(cfg, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(seed)
    p.load_state_dicts(unet=_random_state_dict(p.unet, g),
                       vqgan=None if p.vq is None else _random_state_dict(p.vq, g))
    return p


@pytest.fixture(scope="module")
def pix():
    return _pipe(dict(tiny_config(sf=1), autoencoder=None))


@pytest.fixture(scope="module")
def vqp():
    return _pipe(tiny_config(), 1)


def _lq(b, h=16, w=16, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, (b, h, w, 3))
                            .astype(np.float32))


def _gen(seed=2):
    return torch.Generator().manual_seed(seed)


# --------------------------------------------------------------- engine

def test_stage_slices_match_jax():
    for t_steps in range(1, 17):
        for s in range(1, 9):
            assert pp.stage_slices(t_steps, s) == jpp.stage_slices(t_steps, s), (t_steps, s)


@pytest.mark.parametrize("t_steps,s", [(15, 8), (4, 8), (15, 3), (4, 4), (1, 2), (7, 2)])
def test_stage_slices_cover_chain(t_steps, s):
    starts, counts = pp.stage_slices(t_steps, s)
    ran = [t for st, cn in zip(starts, counts) for t in range(st, st - cn, -1)]
    assert ran == list(range(t_steps - 1, -1, -1))


def _stream(devices, chunks, step):
    """pipeline_stream on chunks of plain tensors, work = step(stage, v),
    recording each launch as (tick order, stage, chunk)."""
    log = []

    def ingest(c, d, dev):
        return {"v": chunks[c].to(dev), "c": c}

    def work(s, d, dev, p):
        log.append((s, p["c"]))
        return {**p, "v": step(s, p["v"])}

    outs = pp.pipeline_stream(devices, len(chunks), ingest, work,
                              lambda c, d, dev, p: p["v"])
    return outs, log


def test_pipeline_stream_engine_identity():
    """Every chunk through every stage once, in order: work adds a
    stage-indexed increment, the output counts each stage's visit."""
    chunks = torch.arange(6, dtype=torch.float32).reshape(6, 1) * 10.0
    incr = [1.0, 2.0, 4.0, 8.0]
    outs, log = _stream([CPU] * 4, chunks, lambda s, v: v + incr[s])
    torch.testing.assert_close(torch.stack([o[0] for o in outs]), chunks + sum(incr))
    # a tick launches the last stage first: tick 3 runs stage 3 on chunk 0 ... stage 0 on 3
    assert log[6:10] == [(3, 0), (2, 1), (1, 2), (0, 3)]
    assert sorted(log) == [(s, c) for s in range(4) for c in range(6)]


def test_pipeline_stream_single_stage_and_short_stream():
    chunks = torch.arange(3, dtype=torch.float32).reshape(3, 1) + 1.0
    outs, _ = _stream([CPU], chunks, lambda s, v: v * 3.0)
    torch.testing.assert_close(torch.stack([o[0] for o in outs]), chunks * 3.0)
    outs, log = _stream([CPU] * 8, chunks, lambda s, v: v + 1.0)  # drain-heavy: S > N
    torch.testing.assert_close(torch.stack([o[0] for o in outs]), chunks + 8.0)
    assert len(log) == 24  # no re-ingest during the drain ticks


def test_stage_grid_and_move():
    assert pp.stage_grid([CPU, "cpu"]) == [[CPU], [CPU]]
    assert pp.stage_grid([[CPU, CPU]] * 3) == [[CPU, CPU]] * 3
    with pytest.raises(ValueError):
        pp.stage_grid([[CPU, CPU], [CPU]])
    p = {"x": torch.ones(2), "kw": {"lq": torch.zeros(1)}, "n": [torch.ones(1)], "k": 3}
    moved = pp.move(p, CPU)
    assert moved["k"] == 3 and torch.equal(moved["kw"]["lq"], p["kw"]["lq"])


# -------------------------------------------------------------- sampler

def test_sample_pipelined_exact_vs_sample_pixel_space(pix):
    """JAX tests/test_pp.py:59-79: a batch of 4 as 4 chunks of one image
    through 8 stages (a 4-step chain: half the stages carry one step, half
    none), against `sample` of each chunk with its rows of the draws."""
    lq = _lq(4)
    got = pix.sample_pipelined(lq, _gen(), [CPU] * 8, chunk_bs=1)
    noise, eps = pix.chain_draws(lq.shape, _gen())
    want = torch.cat([pix.sample(lq[i:i + 1], draws=(noise[i:i + 1], eps[:, i:i + 1]))
                      for i in range(4)])
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-5)
    assert torch.equal(got, want)  # the same ops on the same shapes
    torch.testing.assert_close(got, pix.sample(lq, _gen()), atol=5e-5, rtol=1e-5)
    assert len([k for k in pix._compute if k[0] == CPU]) == 8  # a replica a stage


@pytest.fixture(scope="module")
def pix_jax(pix):
    """The JAX package's pixel-space pipeline with `pix`'s weights (`_pipe`
    draws them from the shapes and the seed alone)."""
    cfg = tiny_config(sf=1)
    m = cfg["model"]
    sd = _random_state_dict(pix.unet, torch.Generator().manual_seed(0))
    params = {"unet": convert_unet_swin(
        {k: v.numpy() for k, v in sd.items()}, image_size=m["image_size"],
        channel_mult=m["channel_mult"], num_res_blocks=m["num_res_blocks"],
        attention_resolutions=m["attention_resolutions"], lq_size=m["lq_size"])}
    return JPipeline(cfg, dtype=jnp.float32, use_autoencoder=False), params


def _jax_chunk_draws(key, n_tiles, cb, shape, steps):
    """The draws of JAX's chunk walk for `key` (`jax.random.split(key,
    n_chunks)`, each chunk's `_sample_tile` draws at its wrap-padded size)
    in the layout of the port's `chain_draws`, the padding's rows dropped."""
    parts = [_jax_draws(k, (cb, *shape), steps)
             for k in jax.random.split(key, -(-n_tiles // cb))]
    return (torch.cat([p[0] for p in parts])[:n_tiles],
            torch.cat([p[1] for p in parts], 1)[:, :n_tiles])


@pytest.mark.parametrize("b,side,cb,stages", [(4, 16, 1, 8), (1, 40, 2, 4), (1, 40, 3, 4)])
def test_sample_pipelined_matches_jax_pixel_space(pix, pix_jax, b, side, cb, stages):
    """The port over [cpu] * stages on JAX's draws against JAX's
    `sample_pipelined` on a `stage` mesh of as many virtual devices, with
    the same key: a batch of 4 in chunks of one image through 8 stages
    (JAX tests/test_pp.py:59-79), and a 40x40 input's 16 tiles (padded to
    48x48) in chunks of 2, and of 3 (JAX wrap-pads the last chunk with the
    first tile), through 4."""
    jp, params = pix_jax
    lq, key = _lq(b, side, side), jax.random.PRNGKey(2)
    n_tiles = len(pix.chain_draws(lq.shape, _gen(), tile_bs=cb)[0])
    assert n_tiles == (b if side <= 16 else 16)
    draws = _jax_chunk_draws(key, n_tiles, cb, (16, 16, 3), pix.sched.num_timesteps)
    got = pix.sample_pipelined(lq, None, [CPU] * stages, chunk_bs=cb, draws=draws).numpy()
    mesh = Mesh(np.array(jax.devices()[:stages]), ("stage",))
    want = np.asarray(jp.sample_pipelined(params, jnp.asarray(lq.numpy()), key, mesh,
                                          chunk_bs=cb))
    assert got.shape == want.shape == (b, side, side, 3)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


def test_sample_pipelined_full_pipeline_single_chunk(vqp):
    """JAX tests/test_pp.py:81-96: one chunk of 2 images through 4 stages
    is `sample` with the same generator."""
    lq = _lq(2)
    want = vqp.sample(lq, _gen())
    got = vqp.sample_pipelined(lq, _gen(), [CPU] * 4, chunk_bs=2)
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert _psnr(got, want) >= 35.0
    assert torch.equal(got, want)


def test_sample_pipelined_chopped_matches_the_tile_walk(vqp):
    """JAX tests/test_pp.py:98-115: a 40x40 input, 9 tiles in chunks of 2,
    against `sample(tile_bs=2)`."""
    lq = _lq(1, 40, 40)
    want = vqp.sample(lq, _gen(), tile_bs=2)
    got = vqp.sample_pipelined(lq, _gen(), [CPU] * 4, chunk_bs=2)
    assert got.shape == want.shape == (1, 160, 160, 3) and torch.isfinite(got).all()
    assert _psnr(got, want) >= 35.0
    assert torch.equal(got, want)


def test_sample_pipelined_hybrid_pp_x_dp(vqp):
    """JAX tests/test_pp.py:117-135: 4 stages of 2 replicas each, every
    chunk of 2 split over a row, against the 1-D pipeline."""
    lq = _lq(4)
    want = vqp.sample_pipelined(lq, _gen(), [CPU] * 4, chunk_bs=2)
    got = vqp.sample_pipelined(lq, _gen(), [[CPU, CPU]] * 4, chunk_bs=2)
    assert got.shape == want.shape == (4, 64, 64, 3)
    assert _psnr(got, want) >= 45.0
    torch.testing.assert_close(got, vqp.sample(lq, _gen()), atol=5e-4, rtol=1e-4)


def test_sample_pipelined_takes_handed_draws_and_a_mask():
    """`draws=` replaces the generator's, and an inpainting mask rides each
    chunk through the stages."""
    p = _pipe(tiny_config(cond_mask=True), 2)
    lq = _lq(2)
    mask = torch.from_numpy(np.random.default_rng(4).choice([-1.0, 1.0], (2, 16, 16, 1))
                            .astype(np.float32))
    draws = p.chain_draws(lq.shape, _gen(7))
    want = p.sample(lq, mask=mask, draws=draws)
    got = p.sample_pipelined(lq, None, [CPU] * 2, mask, chunk_bs=2, draws=draws)
    assert torch.equal(got, want)
