"""The port's data-parallel layer in one process, on the CPU in f32:
`parallel.mesh`, the sharded samplers over two CPU "cards" ([cpu, cpu]),
the Picard chain over them, data-parallel serving, `cli infer`'s split of a
folder by rank.  A card listed twice holds two replicas of the models (the
second a copy of the first), so [cpu, cpu] runs each shard on a replica of
its own.

Transitivity: the port's unsharded `sample` is held to the JAX package's
with the noise handed over (tests/test_torch_pipeline.py).  The JAX
package's sharded samplers draw from a key that the port cannot reproduce,
so they are not compared here directly; JAX's own tests hold its sharded
samplers equal to its unsharded `sample` (tests/test_pipeline.py), and these
hold the port's sharded samplers to the port's `sample`, which closes the
loop.  Each shard is held bit-equal to `sample` of its own inputs with its
rows of the draws; the whole to `sample` within the end-to-end band, rtol /
atol 5e-3 (on the CPU they agree bit for bit).
"""

import json
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from resshift_tpu_torch import cli
from resshift_tpu_torch import serve as srv
from resshift_tpu_torch.parallel import mesh
from resshift_tpu_torch.pipeline import ResShiftPipeline
from resshift_tpu_torch.tools.multiprocess_proof import free_port
from resshift_tpu_torch.utils.image_io import imwrite
from tests.test_torch_pipeline import small_config

torch.set_num_threads(1)
CPUS = [torch.device("cpu")] * 2
BAND = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(scope="module")
def pipe():
    p = ResShiftPipeline(small_config(), dtype=torch.float32, device="cpu")
    p.init_params(0)
    return p


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


def _lq(b, h=16, w=16, seed=1):
    return torch.rand(b, h, w, 3, generator=torch.Generator().manual_seed(seed)) * 2 - 1


def _recording(pipe, monkeypatch, name):
    """Record every call of `pipe.<name>` (the shards' work) with its result."""
    calls, orig = [], getattr(pipe, name)

    def rec(*a, **k):
        out = orig(*a, **k)
        calls.append((a, k, out))
        return out

    monkeypatch.setattr(pipe, name, rec)
    return calls


# ------------------------------------------------------------------ mesh

def test_maybe_init_distributed_is_a_no_op_without_the_environment(monkeypatch):
    for var in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.maybe_init_distributed() is False
    assert not dist.is_initialized()
    assert (mesh.rank(), mesh.world_size(), mesh.local_rank()) == (0, 1, 0)
    assert mesh.local_devices() == [torch.device("cpu")]  # no card here
    assert mesh.process_device("cpu") == torch.device("cpu")


def test_maybe_init_distributed_raises_on_an_unreachable_rendezvous(monkeypatch):
    """WORLD_SIZE 2 naming a rendezvous that nothing serves (a closed port on
    this host): it raises, and leaves no group behind, rather than running
    as an independent rank 0."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    with pytest.raises(RuntimeError, match="could not be initialised"):
        mesh.maybe_init_distributed(device="cpu", timeout_s=2.0)
    assert not dist.is_initialized()


def test_process_device_and_local_devices_under_a_launcher(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert mesh.process_device("cuda") == torch.device("cuda", 3)
    assert mesh.process_device("cuda:1") == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh.local_devices() == [torch.device("cuda", 3)]  # one card a process
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert mesh.local_devices() == [torch.device("cuda", i) for i in range(4)]
    assert mesh.local_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]


# ------------------------------------------------------------- samplers

def _two_replicas(pipe):
    """After a call over [cpu, cpu]: two replicas, distinct modules with the
    same weights."""
    assert set(pipe._compute) == {(torch.device("cpu"), 0), (torch.device("cpu"), 1)}
    (u0, v0), (u1, v1) = (pipe._compute[k] for k in sorted(pipe._compute, key=lambda k: k[1]))
    assert u0 is not u1 and v0 is not v1
    for a, b in ((u0, u1), (v0, v1)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) and sa[k].data_ptr() != sb[k].data_ptr()
                   for k in sa)


def test_batch_sharded_shards_are_sample_of_their_rows(pipe, monkeypatch):
    """Each card its two images and their rows of the draws, on a replica of
    its own: shard 1's (a copy) gives the bits of `sample` on replica 0."""
    lq = _lq(4)
    want = pipe.sample(lq, _gen())
    calls = _recording(pipe, monkeypatch, "_sample_padded")
    got = pipe.sample_batch_sharded(lq, _gen(), CPUS)
    monkeypatch.undo()
    assert len(calls) == 2 and got.shape == (4, 64, 64, 3)
    _two_replicas(pipe)
    draws = pipe.chain_draws(lq.shape, _gen())
    for s, (a, k, out) in enumerate(calls):
        x, d = a[0], k["draws"]
        assert k["slot"] == s and torch.equal(x, lq[2 * s:2 * s + 2])
        torch.testing.assert_close(d[0], draws[0][2 * s:2 * s + 2], rtol=0, atol=0)
        torch.testing.assert_close(d[1], draws[1][:, 2 * s:2 * s + 2], rtol=0, atol=0)
        torch.testing.assert_close(out, pipe.sample(x, draws=d), rtol=0, atol=0)
    torch.testing.assert_close(got, want, **BAND)


def test_batch_sharded_pads_an_odd_batch_and_crops(pipe):
    """3 images over 2 cards: the last is repeated to 4, as the JAX package
    pads; the draws are those of `sample` on the padded batch."""
    lq = _lq(3)
    got = pipe.sample_batch_sharded(lq, _gen(), CPUS)
    want = pipe.sample(torch.cat([lq, lq[-1:]]), _gen())[:3]
    assert got.shape == (3, 64, 64, 3)
    torch.testing.assert_close(got, want, **BAND)


def test_batch_sharded_chopped_input_takes_its_tiles_rows(pipe, monkeypatch):
    """A chopped 16x28 input, two images over two cards, tile batches of 2:
    each card gets its image's tiles (tile-major rows of the whole batch's
    draws) and samples them as `sample` does."""
    lq = _lq(2, 16, 28, seed=2)
    want = pipe.sample(lq, _gen(), tile_bs=2)
    calls = _recording(pipe, monkeypatch, "_sample_padded")
    got = pipe.sample_batch_sharded(lq, _gen(), CPUS, tile_bs=2)
    monkeypatch.undo()
    for a, k, out in calls:
        torch.testing.assert_close(out, pipe.sample(a[0], draws=k["draws"], tile_bs=2),
                                   rtol=0, atol=0)
    torch.testing.assert_close(got, want, **BAND)


def test_batch_sharded_noise_repeat_gives_identical_rows(pipe):
    """As the JAX package's `noise_repeat` test holds it: one image repeated,
    one noise for all, so all outputs agree, across the cards too."""
    lq = _lq(1).expand(4, -1, -1, -1)
    got = pipe.sample_batch_sharded(lq, _gen(), CPUS, noise_repeat=True)
    for i in range(1, 4):
        torch.testing.assert_close(got[i], got[0], rtol=0, atol=0)
    torch.testing.assert_close(got, pipe.sample(lq, _gen(), noise_repeat=True), **BAND)
    assert not torch.equal(pipe.sample_batch_sharded(lq, _gen(), CPUS)[1], got[0])


def test_tiles_sharded_equals_sample_with_every_tile(pipe, monkeypatch):
    """A chopped 20x28 input: padded to 32x32, nine 16px tiles (chop 16,
    stride 12) padded to ten over two cards; each card's five tiles are
    `sample` of those tiles with their draws; the whole is `sample(...,
    tile_bs=9)`, each card's part on a replica of its own."""
    lq = _lq(1, 20, 28, seed=4)
    want = pipe.sample(lq, _gen(), tile_bs=9)
    calls = _recording(pipe, monkeypatch, "_sample_tile")
    got = pipe.sample_tiles_sharded(lq, _gen(), CPUS)
    monkeypatch.undo()
    assert [a[0].shape[0] for a, _, _ in calls] == [5, 5] and got.shape == (1, 80, 112, 3)
    assert [k["slot"] for _, k, _ in calls] == [0, 1]
    _two_replicas(pipe)
    for a, k, out in calls:
        mine = pipe.sample(a[0], draws=(k["noise"], k["step_noise"]))
        torch.testing.assert_close(out, mine, rtol=0, atol=0)
    torch.testing.assert_close(got, want, **BAND)


def test_time_parallel_over_two_cards_at_t_sweeps_is_sample(pipe, monkeypatch):
    """The Picard chain with each sweep's (T*B) batch cut over [cpu, cpu]:
    at sweeps = T it gives `sample`'s result (the UNet at batch T*B/2
    against B: rtol / atol 1e-4, as tests/test_torch_ddpm_parallel.py holds
    the unsharded chain), and the UNet ran on both halves every sweep."""
    lq = _lq(2, seed=7)
    t = pipe.sched.num_timesteps
    want = pipe.sample(lq, _gen())
    unet = pipe._compute_params()[0]
    seen = []
    monkeypatch.setattr(type(unet), "__call__", lambda self, x, *a, **k: seen.append(
        x.shape[0]) or torch.nn.Module.__call__(self, x, *a, **k))
    got = pipe.sample_time_parallel(lq, _gen(), sweeps=t, devices=CPUS)
    monkeypatch.undo()
    assert seen.count(t) == 2 * t  # two halves of the 2T batch, each sweep
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("devices,want", [
    (["cpu", "cpu"], [("cpu", 0), ("cpu", 1)]),
    (["cpu"] * 3, [("cpu", 0), ("cpu", 1), ("cpu", 2)]),
    (["cuda:1", "cpu", "cuda:1", "cuda:0"], [("cuda:1", 0), ("cpu", 0), ("cuda:1", 1),
                                            ("cuda:0", 0)]),
])
def test_each_entry_of_devices_is_a_replica_of_its_own(devices, want):
    """(card, slot) per entry: a card listed k times holds k replicas."""
    from resshift_tpu_torch.pipeline import _replicas

    assert _replicas(devices) == [(torch.device(d), i) for d, i in want]


def test_validation_is_split_by_rank(tmp_path, monkeypatch):
    """Rank 1 of 2 restores the 2nd and 4th of four val items, writes no
    file, and returns the metrics over the whole set from one all-reduce of
    the sums (here a stand-in adding a rank 0 that scored the same)."""
    from resshift_tpu_torch import train_loop
    from resshift_tpu_torch.tools import multiprocess_proof as mp

    mp.write_pairs(tmp_path / "data", n=4)
    cfg = mp.small_config(tmp_path / "data", 1, 2)
    cfg["train"]["val_max_images"] = 4
    monkeypatch.setattr(train_loop, "rank", lambda: 1)
    monkeypatch.setattr(train_loop, "world_size", lambda: 2)
    tr = train_loop.Trainer(cfg, save_dir=str(tmp_path / "run"), seed=0, device="cpu")
    reduced = []

    def all_reduce(t):
        reduced.append(t.clone())
        t.mul_(2)

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    psnr, ssim = tr.validate(1)
    assert tr.val_items == [1, 3] and len(reduced) == 1
    mine = reduced[0].tolist()
    assert mine[3] == 2 and (psnr, ssim) == pytest.approx((mine[0] / 2, mine[1] / 2))
    assert not (tmp_path / "run").exists()  # rank 0 alone makes the run's directories


def test_replicas_follow_the_weights(pipe):
    """A replica per card and slot, dropped with the others when the weights
    change."""
    a, b = pipe._compute_params("cpu"), pipe._compute_params("cpu", 1)
    assert pipe._compute_params(torch.device("cpu")) is a and a is not b
    assert pipe._compute_params(torch.device("cpu"), 1) is b
    pipe.init_params(0)
    assert pipe._compute_params("cpu") is not a and pipe._compute_params("cpu", 1) is not b


# ------------------------------------------------------------- serving

def test_data_parallel_predictor_serves_the_same_images():
    """One burst of four same-shape requests, batched whole (a window that
    closes when the fourth arrives, wide enough for a loaded machine):
    split over [cpu, cpu] it gives `data_parallel=False`'s images, drawn
    alike from the seed; max_batch is raised to the card count."""
    imgs = [(np.random.default_rng(i).random((16, 16, 3)) * 255).astype(np.uint8)
            for i in range(4)]
    small = srv.Predictor(small_config(), bf16=False, device="cpu", data_parallel=True,
                          devices=CPUS, max_batch=1)
    small.close()
    assert small.devices == CPUS and small.max_batch == 2
    outs = {}
    for dp in (False, True):
        pred = srv.Predictor(small_config(), bf16=False, device="cpu", data_parallel=dp,
                             devices=CPUS, max_batch=4, batch_window_s=30.0)
        try:
            assert pred.devices == (CPUS if dp else None)
            got = [None] * 4
            threads = [threading.Thread(target=lambda i=i: got.__setitem__(
                i, pred.predict(imgs[i]))) for i in range(4)]
            queued, submit = threading.Semaphore(0), pred._submit
            pred._submit = lambda req: submit(req) or queued.release()
            for t in threads:  # one at a time: the batch's rows (so its draws) in this order
                t.start()
                assert queued.acquire(timeout=60)
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            assert pred.batch_sizes == [4], pred.batch_sizes
            outs[dp] = np.stack(got)
        finally:
            pred.close()
    np.testing.assert_allclose(outs[True], outs[False], **BAND)


def test_predictor_splits_one_big_image_by_tiles(monkeypatch):
    pred = srv.Predictor(small_config(), bf16=False, device="cpu", data_parallel=True,
                         devices=CPUS)
    try:
        calls = _recording(pred.pipe, monkeypatch, "sample_tiles_sharded")
        out = pred.predict((np.random.default_rng(5).random((20, 28, 3)) * 255)
                           .astype(np.uint8))
        assert len(calls) == 1 and out.shape == (80, 112, 3)
    finally:
        pred.close()


# ------------------------------------------------------------------ cli

def test_cli_infer_splits_the_folder_by_rank(tmp_path, monkeypatch):
    """Rank 1 of 2 restores the 2nd and 4th of four files (JAX's
    files[rank::world]); rank 0 would report the metrics over all four."""
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        imwrite(rng.uniform(0, 1, (16, 16, 3)), src / f"im{i}.png")
    (tmp_path / "small.json").write_text(json.dumps(small_config()))
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    monkeypatch.setattr(dist, "barrier", lambda: None)
    cli.main(["infer", "--config", str(tmp_path / "small.json"), "--fp32", "--device", "cpu",
              "--in-path", str(src), "--out-path", str(tmp_path / "out")])
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["im1.png", "im3.png"]
