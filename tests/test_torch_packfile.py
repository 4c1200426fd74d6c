"""Packed files, memcached and the file client of the port against the JAX
package's:

  * a packed file written by either package reads in the other, through
    both packages' native (C++ mmap) and Python readers, key and byte for
    byte; the port's native reader is its own build of its own source;
  * `scripts pack` writes the same bytes as the JAX package's;
  * `FileClient` over a memcached stub kept here (the text protocol's get
    and set, an item limit): a cold read goes to the disk and fills the
    cache, a warm one is served from it, a value over the limit stays
    uncached; the pack backend's keys and images;
  * `BaseData` (with `extra_pack_path`'s GT, and a seeded `length` draw) and
    `RealESRGANData` from packed files equal the same images from folders
    and the JAX package's datasets from the same packs; `BaseData` through
    memcached equals it from the disk; a loader's threads share one reader.
"""

import copy
import socketserver
import threading

import numpy as np
import pytest

from resshift_tpu import scripts as jscripts
from resshift_tpu.data import datasets as jds
from resshift_tpu.data import packfile as jpack
from resshift_tpu_torch import scripts as tscripts
from resshift_tpu_torch.data import datasets as tds
from resshift_tpu_torch.data import packfile as tpack
from resshift_tpu_torch.data.file_client import FileClient
from resshift_tpu_torch.data.memcached import sanitize_key
from resshift_tpu_torch.utils.image_io import imread, imwrite

ITEM_LIMIT = 4096  # the stub daemon refuses larger values, as memcached does above 1 MiB


def _blobs() -> dict:
    blobs = {f"key_{i:03d}": bytes([i]) * (10 + 7 * i) for i in range(40)}
    blobs.update({"zzz/last.png": b"lastblob", "aaa/first": b"", "ü/utf8": b"\x00\x01"})
    return blobs


WRITERS = {"jax": jpack.PackWriter, "port": tpack.PackWriter}
READERS = {"jax native": lambda p: jpack.PackReader(p, native=True),
           "jax python": lambda p: jpack.PackReader(p, native=False),
           "port native": lambda p: tpack.PackReader(p, native=True),
           "port python": lambda p: tpack.PackReader(p, native=False)}


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("reader", sorted(READERS))
def test_pack_written_by_either_reads_in_either(tmp_path, writer, reader):
    blobs = _blobs()
    path = tmp_path / "data.pack"
    with WRITERS[writer](path) as w:
        for k in sorted(blobs, reverse=True):  # the writer sorts the index
            w.add(k, blobs[k])
    with READERS[reader](path) as r:
        assert r.native == reader.endswith("native")
        assert len(r) == len(blobs)
        assert r.keys() == sorted(blobs, key=str.encode)
        for k, v in blobs.items():
            assert r.get(k) == v
        assert [r.get_index(i) for i in range(len(r))] == [blobs[k] for k in r.keys()]
        with pytest.raises(KeyError):
            r.get("missing")
        r.prefetch(0)


def test_port_builds_its_own_native_reader():
    assert tpack.native_available()
    lib = tpack._load_lib()
    assert "resshift_tpu_torch/_build/libpackfile-" in lib._name
    assert tpack._SRC.read_bytes().count(b"rspk_") >= 7  # its own copy of the reader


def test_bad_magic_raises(tmp_path):
    path = tmp_path / "bad.pack"
    path.write_bytes(b"NOTAPACK" + b"\0" * 32)
    for native in (True, False):
        with pytest.raises(OSError):
            tpack.PackReader(path, native=native)


def _field(rng, h, w):
    return np.clip(rng.uniform(0, 1, (h // 8, w // 8, 3)).repeat(8, 0).repeat(8, 1)
                   + rng.normal(0, 0.03, (h, w, 3)), 0, 1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """lq/ 16x16 and gt/ 64x64 pairs, hq/ 96x80 images (one in a subfolder),
    and the packs of each made by `scripts pack`."""
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(11)
    for sub in ("lq", "gt", "hq", "hq/nested"):
        (d / sub).mkdir()
    for i in range(5):
        imwrite(_field(rng, 16, 16), d / "lq" / f"{i:02d}.png")
        imwrite(_field(rng, 64, 64), d / "gt" / f"{i:02d}.png")
    for i in range(4):
        imwrite(_field(rng, 96, 80), d / "hq" / ("nested" if i == 3 else "") / f"{i}.png")
    for sub in ("lq", "gt", "hq"):
        tscripts.main(["pack", "--source", str(d / sub), "--out", str(d / f"{sub}.pack")])
    return d


def test_scripts_pack_writes_the_jax_packages_bytes(files, tmp_path):
    jscripts.main(["pack", "--source", str(files / "hq"), "--out", str(tmp_path / "j.pack")])
    assert (tmp_path / "j.pack").read_bytes() == (files / "hq.pack").read_bytes()
    with tpack.PackReader(files / "hq.pack") as r:
        assert r.keys() == ["0.png", "1.png", "2.png", "nested/3.png"]


class _Memcached(socketserver.StreamRequestHandler):
    """get / set of the memcached text protocol over a dict, refusing values
    over ITEM_LIMIT as the daemon refuses values over its item size."""

    def handle(self):
        srv = self.server
        while line := self.rfile.readline():
            cmd = line.split()
            if cmd[0] == b"get":
                with srv.lock:
                    srv.gets += 1
                    val = srv.store.get(cmd[1])
                if val is not None:
                    self.wfile.write(b"VALUE %s 0 %d\r\n%s\r\n" % (cmd[1], len(val), val))
                self.wfile.write(b"END\r\n")
            elif cmd[0] == b"set":
                data = self.rfile.read(int(cmd[4]) + 2)[:-2]
                if len(data) > ITEM_LIMIT:
                    self.wfile.write(b"SERVER_ERROR object too large for cache\r\n")
                    return  # the daemon may drop the connection after an error
                with srv.lock:
                    srv.store[cmd[1]] = data
                self.wfile.write(b"STORED\r\n")
            else:
                self.wfile.write(b"ERROR\r\n")


@pytest.fixture
def memcached():
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _Memcached)
    srv.daemon_threads = True
    srv.store, srv.lock, srv.gets = {}, threading.Lock(), 0
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def test_file_client_memcached_reads_through(memcached, tmp_path):
    server = f"127.0.0.1:{memcached.server_address[1]}"
    small, big = tmp_path / "small.bin", tmp_path / "big.bin"
    small.write_bytes(b"a" * 100)
    big.write_bytes(b"b" * (ITEM_LIMIT + 1))
    client = FileClient("memcached", server=server)
    assert client.get(small) == b"a" * 100  # cold: the disk, then the cache
    assert memcached.store[sanitize_key(str(small)).encode()] == b"a" * 100
    small.write_bytes(b"changed")
    assert client.get(small) == b"a" * 100  # warm: the cache
    for _ in range(2):  # refused by the daemon: read from the disk each time
        assert client.get(big) == b"b" * (ITEM_LIMIT + 1)
    assert sanitize_key(str(big)).encode() not in memcached.store
    assert memcached.gets == 4
    # a copy (a loader thread's) dials its own connection
    assert copy.deepcopy(client).get(small) == b"a" * 100


def test_file_client_pack_and_disk(files):
    pack, disk = FileClient("pack", files / "gt.pack"), FileClient("disk")
    assert pack.keys() == [f"{i:02d}.png" for i in range(5)]
    for k in pack.keys():
        np.testing.assert_array_equal(pack.imread(k), imread(files / "gt" / k))
        np.testing.assert_array_equal(disk.imread(files / "gt" / k, dtype="uint8"),
                                      imread(files / "gt" / k, dtype="uint8"))
    with pytest.raises(ValueError, match="keys"):
        disk.keys()
    with pytest.raises(ValueError, match="backend"):
        FileClient("lmdb")


def _equal_items(a, b, n):
    assert len(a) == len(b) == n
    for i in range(n):
        x, y = a[i], b[i]
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_base_data_from_packs(files):
    packs = dict(pack_path=str(files / "lq.pack"), extra_pack_path=str(files / "gt.pack"))
    t = tds.create_dataset(dict(type="base", params=packs))
    folder = tds.create_dataset(dict(type="base", params=dict(
        dir_path=str(files / "lq"), extra_dir_path=str(files / "gt"))))
    _equal_items(t, folder, 5)
    _equal_items(t, jds.create_dataset(dict(type="base", params=packs)), 5)
    assert t.client.pack.native
    drawn = dict(packs, length=3, seed=4)  # the seeded draw of `length` keys
    td, jd = (m.create_dataset(dict(type="base", params=drawn)) for m in (tds, jds))
    assert td.paths == jd.paths and len(td.paths) == 3
    _equal_items(td, jd, 3)


def test_realesrgan_data_from_a_pack(files):
    common = dict(gt_size=64, crop_pad_size=96, use_rot=True, seed=5)
    packed = dict(type="realesrgan", params=dict(pack_path=str(files / "hq.pack"), **common))
    t, j = tds.create_dataset(packed), jds.create_dataset(packed)
    folder = tds.create_dataset(dict(type="realesrgan", params=dict(
        dir_paths=[str(files / "hq")], **common)))
    assert t.paths == j.paths == [p.removeprefix(str(files / "hq") + "/") for p in folder.paths]
    _equal_items(t, j, 4)  # the same draws after each item
    _equal_items(tds.create_dataset(packed), folder, 4)


def test_base_data_through_memcached(memcached, files):
    io = dict(type="memcached", server=f"127.0.0.1:{memcached.server_address[1]}")
    params = dict(dir_path=str(files / "lq"), extra_dir_path=str(files / "gt"))
    t = tds.create_dataset(dict(type="base", params=dict(params, io_backend=io)))
    assert t.client.backend == "memcached"
    disk = tds.create_dataset(dict(type="base", params=params))
    _equal_items(t, disk, 5)  # cold
    assert len(memcached.store) == 5
    _equal_items(t, disk, 5)  # warm
    assert memcached.gets == 10


def test_loader_threads_share_one_pack_reader(files):
    ds = tds.create_dataset(dict(type="base", params=dict(
        pack_path=str(files / "lq.pack"), extra_pack_path=str(files / "gt.pack"))))
    assert copy.deepcopy(ds).client.pack is ds.client.pack
    loader = tds.DataLoader(ds, batch_size=2, shuffle=False, num_workers=2)
    try:
        batches = list(loader)
    finally:
        loader.close()
    assert [b["gt"].shape for b in batches] == [(2, 64, 64, 3)] * 2
    np.testing.assert_array_equal(batches[0]["lq"][1], ds[1]["lq"])


def _chip_smoke():
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    return chip_smoke, root


def test_chip_smoke_pixel_config_is_train_proofs(tmp_path):
    """Phase 20(d)'s config: tools/train_proof.py's model, diffusion and
    training settings, its data from packed files."""
    import importlib.util

    chip_smoke, root = _chip_smoke()
    spec = importlib.util.spec_from_file_location("train_proof", root / "tools" / "train_proof.py")
    proof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(proof)
    want = proof.proof_config(tmp_path, iters=3)
    got = chip_smoke.pixel_train_config(("LQ.pack", "GT.pack"), ("VAL_LQ", "VAL_GT"))
    for key in ("task", "sf", "model", "diffusion", "autoencoder", "inference"):
        assert got[key] == want[key], key
    for key in ("lr", "lr_min", "lr_schedule", "warmup_iterations", "iterations", "batch",
                "microbatch", "ema_rate", "weight_decay", "val_max_images"):
        assert got["train"][key] == want["train"][key], key
    assert got["data"]["train"] == dict(type="base", params=dict(pack_path="LQ.pack",
                                                                 extra_pack_path="GT.pack"))


def test_pixel_space_training_from_packs(files, tmp_path):
    """`autoencoder: null` training (IdentityFirstStage's role) on packed
    pairs through the native reader, small, on the CPU."""
    import json

    import torch

    from resshift_tpu_torch.train_loop import Trainer

    chip_smoke, _ = _chip_smoke()
    for sub in ("lq", "gt"):  # sf 1: the LQ at the GT's size
        (tmp_path / sub).mkdir()
        for k in range(4):
            imwrite(imread(files / "gt" / f"{k:02d}.png")[:32, :32], tmp_path / sub / f"{k}.png")
        tscripts.main(["pack", "--source", str(tmp_path / sub), "--out",
                       str(tmp_path / f"{sub}.pack")])
    model = dict(chip_smoke.PIXEL_MODEL, image_size=32, lq_size=32, model_channels=32,
                 swin_embed_dim=32, num_head_channels=16, channel_mult=[1, 2],
                 num_res_blocks=[1, 1], attention_resolutions=[32])
    cfg = chip_smoke.pixel_train_config((str(tmp_path / "lq.pack"), str(tmp_path / "gt.pack")),
                                        (str(tmp_path / "lq"), str(tmp_path / "gt")), model,
                                        batch=2)
    cfg["inference"].update(chop_size=32, chop_stride=24, padding_offset=32)
    cfg["train"].update(val_freq=1000, save_freq=1000)
    torch.manual_seed(0)
    tr = Trainer(cfg, save_dir=str(tmp_path / "run"), seed=0, device="cpu")
    assert tr.pipe.vq is None and tr.loader.ds.client.pack.native
    tr.train(stop_iter=2)
    tr.loader.close()
    log = [json.loads(ln) for ln in (tmp_path / "run" / "train_log.jsonl").read_text().splitlines()]
    losses = [m["loss"] for m in log if "loss" in m]
    assert len(losses) == 2 and all(np.isfinite(losses)) and min(losses) > 0
