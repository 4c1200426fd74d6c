"""The port's tensor parallelism (parallel/tp.py, `sample_tp`) on the CPU in
f32, against the JAX package's layout and sampler (tests/test_tp.py).

The layout: every JAX leaf is mapped through the port's key map
(`convert.from_flax`) and the port must cut the dim that
`resshift_tpu.parallel.tp.param_specs` shards, except where the port's
head-aligned qkv cut differs (a Swin block whose heads do not divide
`n_model` stays whole); every rank's pieces merge back bit for bit.

The sampler: gloo worlds started through `tools/multiprocess_proof.py`'s
launcher (2 ranks; one 2 x 2 DP x TP world of 4), each rank a process.  In
pixel space the port's `sample_tp` takes the JAX package's draws for the
same key and is held to JAX's `sample_tp` on the virtual 4-device `model`
mesh and to the port's own `sample` within atol 5e-4 / rtol 1e-4 (the
port's within f32 noise of its own `sample`); with the VQGAN (an odd batch
over 2 x 2, and a chopped input) within 35 dB of `sample` on the same
generator; every rank's image bit-equal to rank 0's.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from resshift_tpu.convert import convert_unet_swin, convert_vqgan
from resshift_tpu.parallel import tp as jtp
from resshift_tpu.pipeline import ResShiftPipeline as JPipeline
from resshift_tpu_torch import cli
from resshift_tpu_torch.convert import from_flax
from resshift_tpu_torch.parallel import mesh, tp
from resshift_tpu_torch.pipeline import ResShiftPipeline
from resshift_tpu_torch.tools import multiprocess_proof as mp
from resshift_tpu_torch.utils.image_io import imwrite
from tests.test_pipeline import tiny_config
from tests.test_torch_pipeline import _random_state_dict

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(4.0 / mse) if mse > 0 else np.inf


def _port(cfg, seed):
    """A port pipeline (f32, CPU) with random weights everywhere, and its
    state dicts."""
    p = ResShiftPipeline(cfg, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(seed)
    sds = {"unet": _random_state_dict(p.unet, g)}
    if p.vq is not None:
        sds["vqgan"] = _random_state_dict(p.vq, g)
    p.load_state_dicts(**sds)
    return p, sds


def _jax_draws(key, shape, steps):
    """The prior and step draws of JAX's `_sample_tile` for `key`."""
    k1, kprior = jax.random.split(key)
    noise = jax.random.normal(kprior, shape, jnp.float32)
    k2, _ = jax.random.split(k1)
    eps = [jax.random.normal(k, shape, jnp.float32) for k in jax.random.split(k2, steps)]
    return torch.from_numpy(np.array(noise)), torch.from_numpy(np.stack(eps))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both gloo worlds, run at once: (the 2-rank pixel-space world's and the
    4-rank DP x TP world's reports, their directories, the inputs)."""
    root = tmp_path_factory.mktemp("tp")
    pix_cfg = dict(tiny_config(sf=1), autoencoder=None)
    pix, pix_sds = _port(pix_cfg, 0)
    lq_pix = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (1, 16, 16, 3))
                              .astype(np.float32))
    key = jax.random.PRNGKey(2)
    draws = _jax_draws(key, (1, 16, 16, 3), pix.sched.num_timesteps)
    vq_cfg = tiny_config()
    vqp, vq_sds = _port(vq_cfg, 1)
    rng = np.random.default_rng(3)
    lq_odd = torch.from_numpy(rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32))
    lq_chop = torch.from_numpy(rng.uniform(-1, 1, (1, 40, 40, 3)).astype(np.float32))
    specs = {
        "pix": dict(config=pix_cfg, unet=pix_sds["unet"], cases=[
            dict(name="pix", lq=lq_pix, draws=draws)]),
        "dpxtp": dict(config=vq_cfg, **vq_sds, cases=[
            dict(name="odd", lq=lq_odd, seed=5, kw=dict(data=2)),
            dict(name="chop", lq=lq_chop, seed=6, kw=dict(data=2))]),
    }
    reports = {}

    def run(name, nproc):
        torch.save(specs[name], root / f"{name}.pt")
        reports[name] = mp.launch_tp(root / name, root / f"{name}.pt", nproc=nproc,
                                     timeout=150)

    threads = [threading.Thread(target=run, args=a) for a in (("pix", 2), ("dpxtp", 4))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, rep in reports.items():
        if not rep["ok"]:
            logs = [(root / name / f"worker_{r}.log").read_text()[-3000:]
                    for r in range(rep["nproc"])]
            pytest.fail(f"{name}: {rep}\n" + "\n".join(logs))
    return dict(root=root, reports=reports, pix=pix, pix_sds=pix_sds, lq_pix=lq_pix,
                draws=draws, key=key, vqp=vqp, lq_odd=lq_odd, lq_chop=lq_chop,
                pix_cfg=pix_cfg)


def _images(w, world, case, nproc):
    imgs = [torch.load(w["root"] / world / "tp" / f"{case}_rank{r}.pt") for r in range(nproc)]
    for r, img in enumerate(imgs[1:], 1):
        assert torch.equal(img, imgs[0]), f"{case}: rank {r} differs from rank 0"
    assert w["reports"][world]["cases"][case]["ranks_equal"]
    return imgs[0]


# ---------------------------------------------------------------- layout

def _jax_tree(sds, cfg):
    """The JAX package's parameter tree of the port's state dicts (its own
    converter)."""
    m, dd = cfg["model"], cfg["autoencoder"]["ddconfig"]
    npsd = {k: {n: v.numpy() for n, v in sd.items()} for k, sd in sds.items()}
    return {"unet": convert_unet_swin(npsd["unet"], image_size=m["image_size"],
                                      channel_mult=m["channel_mult"],
                                      num_res_blocks=m["num_res_blocks"],
                                      attention_resolutions=m["attention_resolutions"],
                                      lq_size=m["lq_size"]),
            "vqgan": convert_vqgan(npsd["vqgan"], ch_mult=dd["ch_mult"],
                                   num_res_blocks=dd["num_res_blocks"])}


def _port_dicts(tree, cfg):
    m, dd = cfg["model"], cfg["autoencoder"]["ddconfig"]
    return {"unet": from_flax(tree["unet"], "unet", image_size=m["image_size"],
                              channel_mult=m["channel_mult"], num_res_blocks=m["num_res_blocks"],
                              attention_resolutions=m["attention_resolutions"]),
            "vqgan": from_flax(tree["vqgan"], "vqgan", ch_mult=dd["ch_mult"],
                               num_res_blocks=dd["num_res_blocks"])}


@pytest.fixture(scope="module")
def layout():
    cfg = tiny_config()
    p, sds = _port(cfg, 7)
    return cfg, sds, _jax_tree(sds, cfg)


@pytest.mark.parametrize("n_model", [2, 4, 7])
def test_param_specs_cut_the_dims_jax_shards(layout, n_model):
    """Each JAX leaf filled with its index along the sharded axis (-1 where
    replicated) goes through `from_flax`; the port dim along which the
    values vary is the dim JAX shards, and the port's spec must name it."""
    cfg, sds, tree = layout
    specs = jtp.param_specs(tree, n_model)
    encoded = jax.tree_util.tree_map(
        lambda leaf, spec: (np.indices(leaf.shape)[list(spec).index("model")].astype(np.float32)
                            if "model" in tuple(spec) else np.full(leaf.shape, -1, np.float32)),
        tree, specs, is_leaf=lambda x: isinstance(x, P))
    port = _port_dicts(encoded, cfg)
    checked = heads_aligned = 0
    for which, sd in port.items():
        assert set(sd) == set(sds[which])
        mine = tp.param_specs(sds[which], n_model)
        for key, arr in sd.items():
            varying = [d for d in range(arr.ndim) if arr.shape[d] > 1
                       and not (np.diff(arr, axis=d) == 0).all()]
            jax_dim = varying[0] if varying else None
            assert len(varying) <= 1, key
            mod = key.rsplit(".", 1)[0]
            if mod.endswith((".attn.qkv", ".attn.proj")):
                heads = sds[which][mod.rsplit(".", 1)[0] + ".relative_position_bias_table"]
                whole = heads.shape[1] % n_model != 0
                want = None if whole else (0 if mod.endswith("qkv") else
                                           1 if key.endswith("weight") else None)
                heads_aligned += want != jax_dim
                assert mine[key] == want, key
            else:
                assert mine[key] == jax_dim, (key, mine[key], jax_dim)
            checked += mine[key] is not None
    assert bool(checked) == (n_model != 7)  # 7 divides no width of the tiny model
    # the tiny model's 2 heads a block: whole at 4 and 7, where JAX still cuts qkv (96 | 4)
    assert (heads_aligned > 0) == (n_model == 4)


def _merge(pieces, specs):
    """The whole state dict from every rank's pieces, in rank order (qkv's
    pieces hold each rank's rows of q, k and v)."""
    out = {}
    for k, d in specs.items():
        parts = [p[k] for p in pieces]
        if d is None:
            out[k] = parts[0]
        elif k.rsplit(".", 1)[0].endswith(".attn.qkv"):
            rest = parts[0].shape[1:]
            out[k] = torch.cat([p.reshape(3, -1, *rest) for p in parts], 1).reshape(-1, *rest)
        else:
            out[k] = torch.cat(parts, d)
    return out


@pytest.mark.parametrize("n_model", [2, 4, 7])
def test_pieces_merge_back_bit_for_bit(layout, n_model):
    _, sds, _ = layout
    for sd in sds.values():
        specs = tp.param_specs(sd, n_model)
        pieces = [tp.shard_state_dict(sd, r, n_model, specs) for r in range(n_model)]
        whole = _merge(pieces, specs)
        assert set(whole) == set(sd)
        for k, t in sd.items():
            assert torch.equal(whole[k], t), k
            if specs[k] is not None:
                assert pieces[1][k].shape[specs[k]] * n_model == t.shape[specs[k]], k
    # a rank owns whole heads of q, k and v: rank 1 of 2 holds the second head of each
    key = "middle_block.1.blocks.0.attn.qkv.weight"
    q, k, v = sds["unet"][key].chunk(3)
    piece = tp.shard_state_dict(sds["unet"], 1, 2)[key]
    assert torch.equal(piece, torch.cat([t[16:] for t in (q, k, v)]))


def test_what_stays_whole(layout):
    """An n_model that divides nothing leaves every tensor whole; at 2 the
    norms, rel-pos tables, row-parallel biases, heads and codebook stay."""
    _, sds, _ = layout
    for sd in sds.values():
        assert set(tp.param_specs(sd, 7).values()) == {None}
    unet, vqgan = tp.param_specs(sds["unet"], 2), tp.param_specs(sds["vqgan"], 2)
    blk = "middle_block.1.blocks.0."
    for k in ("norm1.weight", "attn.relative_position_bias_table", "attn.proj.bias",
              "mlp.fc2.bias"):
        assert unet[blk + k] is None, k
    assert (unet[blk + "attn.qkv.weight"], unet[blk + "attn.proj.weight"],
            unet[blk + "mlp.fc1.weight"], unet[blk + "mlp.fc2.weight"]) == (0, 1, 0, 1)
    assert unet["out.2.weight"] is None and unet["time_embed.2.bias"] is None
    assert unet["time_embed.0.weight"] == 0 and unet["time_embed.2.weight"] == 1
    assert vqgan["decoder.conv_out.weight"] is None
    assert vqgan["quantize.embedding.weight"] is None
    assert vqgan["encoder.mid.attn_1.q.weight"] == 0


# -------------------------------------------------------------- sampler

def test_the_gather_forms_agree_and_ranks_are_equal(worlds):
    for name, rep in worlds["reports"].items():
        assert rep["exit_codes"] == [0] * rep["nproc"]
        for r in range(rep["nproc"]):
            d = json.loads((worlds["root"] / name / "tp" / f"digest_rank{r}.json").read_text())
            assert d["gather_forms_equal"], (name, r)


def test_sample_tp_pixel_space_matches_jax_and_sample(worlds):
    """JAX tests/test_tp.py:63-76 with the port on 2 gloo ranks."""
    got = _images(worlds, "pix", "pix", 2).numpy()
    pix, lq, draws = worlds["pix"], worlds["lq_pix"], worlds["draws"]
    own = pix.sample(lq, draws=draws).numpy()
    np.testing.assert_allclose(got, own, atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(got, own, atol=2e-5, rtol=1e-5)  # f32 noise of the split sums
    jp = JPipeline(tiny_config(sf=1), dtype=jnp.float32, use_autoencoder=False)
    m = worlds["pix_cfg"]["model"]
    params = {"unet": convert_unet_swin(
        {k: v.numpy() for k, v in worlds["pix_sds"]["unet"].items()},
        image_size=m["image_size"], channel_mult=m["channel_mult"],
        num_res_blocks=m["num_res_blocks"], attention_resolutions=m["attention_resolutions"],
        lq_size=m["lq_size"])}
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("model",))
    want = np.asarray(jp.sample_tp(params, jnp.asarray(lq.numpy()), worlds["key"], mesh4))
    assert got.shape == want.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4)


def test_sample_tp_vqgan_on_a_dp_x_tp_world_odd_batch(worlds):
    """JAX tests/test_tp.py:78-97: 2 x 2 ranks, 3 images (the pad row cropped)."""
    got = _images(worlds, "dpxtp", "odd", 4).numpy()
    want = worlds["vqp"].sample(worlds["lq_odd"], torch.Generator().manual_seed(5)).numpy()
    assert got.shape == want.shape == (3, 64, 64, 3) and np.isfinite(got).all()
    assert _psnr(got, want) >= 35.0
    assert not np.allclose(got[0], got[1]) and not np.allclose(got[1], got[2])


def test_sample_tp_chopped_input(worlds):
    """JAX tests/test_tp.py:125-144: a 40x40 input, 9 tiles walked in chunks
    of 2 over the 2 x 2 world, against `sample(tile_bs=2)`."""
    got = _images(worlds, "dpxtp", "chop", 4).numpy()
    want = worlds["vqp"].sample(worlds["lq_chop"], torch.Generator().manual_seed(6),
                                tile_bs=2).numpy()
    assert got.shape == want.shape == (1, 160, 160, 3) and np.isfinite(got).all()
    assert _psnr(got, want) >= 35.0


def test_the_collectives_of_a_call(worlds):
    rep = worlds["reports"]["pix"]["cases"]["pix"]
    assert rep["collectives"]["all_reduce"] > 0 and rep["collectives"]["all_gather"] > 0


def test_tp_groups_refuses_a_split_of_the_world_that_does_not_divide(monkeypatch):
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    with pytest.raises(ValueError):
        tp.tp_groups(3)
    assert tp.tp_groups(1) == (None, 0, 4)


# ------------------------------------------------------------------ cli

def _folder(tmp_path, n=2):
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        imwrite(rng.uniform(0, 1, (16, 16, 3)), src / f"im{i}.png")
    cfg = tmp_path / "small.json"
    cfg.write_text(json.dumps(tiny_config(steps=2)))
    return ["infer", "--config", str(cfg), "--fp32", "--device", "cpu", "--in-path", str(src),
            "--out-path", str(tmp_path / "out")]


def _record(monkeypatch, *names):
    """Every named sampler of the pipeline class replaced by one that
    records its call and returns `sample`'s result."""
    calls, sample = [], ResShiftPipeline.sample
    for name in names:
        def rec(self, lq, *a, _name=name, **k):
            calls.append(_name)
            return sample(self, lq, torch.Generator().manual_seed(0))
        monkeypatch.setattr(ResShiftPipeline, name, rec)
    return calls


def test_cli_flags_parse():
    base = ["infer", "--in-path", "x", "--out-path", "y"]
    a = cli.make_parser().parse_args(base + ["--tensor-parallel", "--pipeline-parallel"])
    assert a.tensor_parallel is True and a.pipeline_parallel is True
    a = cli.make_parser().parse_args(base)
    assert a.tensor_parallel is False and a.pipeline_parallel is False


@pytest.mark.parametrize("rank", [0, 1])
def test_cli_tensor_parallel_dispatches_on_every_rank(tmp_path, monkeypatch, rank):
    """World of 2: every rank samples every file through sample_tp; rank 0
    alone writes them."""
    monkeypatch.setattr(mesh, "rank", lambda: rank)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    monkeypatch.setattr(dist, "barrier", lambda: None)
    calls = _record(monkeypatch, "sample_tp", "sample", "sample_pipelined")
    cli.main(_folder(tmp_path) + ["--tensor-parallel"])
    assert calls == ["sample_tp"] * 2
    written = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert written == (["im0.png", "im1.png"] if rank == 0 else [])


def test_cli_pipeline_parallel_dispatches_over_the_cards(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_devices", lambda pipe: [torch.device("cpu")] * 2)
    calls = _record(monkeypatch, "sample_pipelined", "sample_tp", "sample_batch_sharded")
    cli.main(_folder(tmp_path) + ["--pipeline-parallel", "--tensor-parallel"])
    assert calls == ["sample_pipelined"] * 2  # one process: TP falls through to PP


def test_cli_one_card_falls_through_to_sample(tmp_path, monkeypatch):
    calls = _record(monkeypatch, "sample_pipelined", "sample_tp", "sample")
    cli.main(_folder(tmp_path) + ["--pipeline-parallel", "--tensor-parallel"])
    assert calls == ["sample"] * 2
    assert len(list((tmp_path / "out").iterdir())) == 2


def test_cli_refuses_distributed_with_tensor_parallel(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(_folder(tmp_path) + ["--tensor-parallel", "--distributed"])


# ------------------------------------------------------------- launcher

def _workers(out: Path) -> list[int]:
    """Pids of the live workers whose command line names `out`."""
    pids = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            cmd = (d / "cmdline").read_bytes().split(b"\0")
            state = next((ln for ln in (d / "status").read_text().splitlines()
                          if ln.startswith("State:")), "")
        except OSError:
            continue
        if b"--worker" in cmd and str(out).encode() in cmd and "zombie" not in state:
            pids.append(int(d.name))
    return pids


@pytest.mark.skipif(not Path("/proc/self/cmdline").exists(), reason="needs /proc (Linux)")
def test_a_killed_launcher_leaves_no_worker(tmp_path):
    """The launcher is killed (SIGKILL: no finally runs) while its two
    workers train a run far longer than the test; both must die with it."""
    out = tmp_path / "run"
    code = ("import sys; from resshift_tpu_torch.tools.multiprocess_proof import launch; "
            f"launch({str(out)!r}, nproc=2, iters=10 ** 6, timeout=600)")
    launcher = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while len(_workers(out)) < 2 and time.monotonic() < deadline:
            time.sleep(0.2)
        alive = _workers(out)
        assert len(alive) == 2, "the workers did not start"
    finally:
        launcher.kill()
        launcher.wait()
    deadline = time.monotonic() + 20
    while _workers(out) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _workers(out)
    for pid in left:  # not to leave them behind should the check fail
        os.kill(pid, signal.SIGKILL)
    assert not left, f"workers {left} outlived their launcher"
