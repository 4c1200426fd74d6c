"""The port's serving layer and observability on the CPU, each behaviour
of tests/test_serve_and_obs.py but the mesh test, on the Predictor of the
small realsr config with `device="cpu"`:

  * batching of concurrent same-shape requests, distinct outputs for
    identical inputs; mixed shapes and a failing request; the dispatch
    buckets, the padded copies drawing noise too, and `warmup` running each
    bucket once as one batch; a burst beyond `max_queue` -> ServerBusyError;
    a timed-out request dropped unprocessed; `close()` draining; the
    `metrics()` keys; `--chop-size`; the options not ported;
  * a batch-1 `predict` equals `ResShiftPipeline.sample` with a generator
    seeded alike;
  * the HTTP server with stub predictors and the port's PNG codec (health,
    restore, demo page, 404 / 413 / 400 / 500, 429 / 503 with Retry-After,
    /metrics, the backlog of 512), and the load test's driver against the
    real Predictor behind a real server;
  * `nan_guard`, `measure`, `trace` and `debug_nans` naming the module;
  * kernels launch on their tensors' card: `_ext.Kernel` with a stubbed
    library makes that card current and passes its stream, and every
    wrapper in `ops/` passes its tensors' device.
"""

import ast
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from resshift_tpu_torch import _ext, serve as srv
from resshift_tpu_torch.pipeline import ResShiftPipeline
from resshift_tpu_torch.tools import serve_loadtest
from resshift_tpu_torch.utils import image_io, observability as obs
from tests.test_torch_pipeline import ROOT, small_config

torch.set_num_threads(1)


def _predictor(**kw):
    return srv.Predictor(small_config(), bf16=False, device="cpu", **kw)


def _img(seed, hw=16):
    return (np.random.default_rng(seed).random((hw, hw, 3)) * 255).astype(np.uint8)


def _run_threads(fn, args_list, timeout=120):
    threads = [threading.Thread(target=fn, args=a) for a in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)


# --------------------------------------------------------------- Predictor

def test_predictor_concurrent_requests_batched():
    pred = _predictor(max_batch=8, batch_window_s=0.5)
    try:
        pred.warmup((16, 16), batch_sizes=(1,))
        img = _img(0)
        n = 6
        results, errors = [None] * n, []

        def post(i):
            try:
                results[i] = pred.predict(img)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        _run_threads(post, [(i,) for i in range(n)])
        assert not errors
        assert all(r is not None and r.shape == (64, 64, 3) for r in results)
        for i in range(1, n):  # identical inputs, per-image noise
            assert not np.array_equal(results[0], results[i])
        post_warmup = pred.batch_sizes[1:]
        assert sum(post_warmup) == n
        assert len(post_warmup) < n and max(post_warmup) >= 2
    finally:
        pred.close()


def test_predictor_mixed_shapes_and_errors():
    pred = _predictor(max_batch=4, batch_window_s=0.05)
    try:
        a, b = _img(1), _img(2, 32)
        out = {}
        _run_threads(lambda name, im: out.__setitem__(name, pred.predict(im)),
                     [("a", a), ("b", b), ("a2", a)], timeout=300)
        assert out["a"].shape == (64, 64, 3) and out["a2"].shape == (64, 64, 3)
        assert out["b"].shape == (128, 128, 3)  # chopped into 16-px tiles
        with pytest.raises(Exception):
            pred.predict(np.zeros((2, 16, 16, 3), np.uint8))  # 4D: invalid
        assert pred.predict(a).shape == (64, 64, 3)  # the worker lives on
        assert pred.metrics()["requests_error"] == 1
    finally:
        pred.close()


def test_dispatch_bucket_padding_and_its_noise(monkeypatch):
    p = srv.Predictor.__new__(srv.Predictor)  # the bucket rule alone
    p.max_batch = 16
    assert [p._bucket(n) for n in (1, 2, 3, 5, 8, 9, 15, 16)] == [1, 2, 4, 8, 8, 16, 16, 16]
    p.max_batch = 24
    assert p._bucket(17) == 24 and p._bucket(24) == 24 and p._bucket(16) == 16

    # three requests run as a bucket of four: the copy of the last image
    # draws noise too, so the three outputs are the first three of sample()
    # on the padded batch
    pred = _predictor(max_batch=4, batch_window_s=0.5, seed=21)
    try:
        seen, out = [], []
        orig = pred.pipe.sample
        monkeypatch.setattr(pred.pipe, "sample",
                            lambda lq, *a, **k: seen.append(lq.clone()) or orig(lq, *a, **k))
        _run_threads(lambda i: out.append(pred.predict(_img(10 + i))), [(i,) for i in range(3)])
        assert [lq.shape[0] for lq in seen] == [4] and pred.batch_sizes == [3]
        assert torch.equal(seen[0][3], seen[0][2])
        want = image_io.from_model(orig(seen[0], torch.Generator().manual_seed(21)).numpy())
        for j in range(3):
            assert sum(np.array_equal(o, want[j]) for o in out) == 1, j
    finally:
        pred.close()


def test_warmup_runs_each_bucket_as_one_batch():
    pred = _predictor(max_batch=4, batch_window_s=0.0)
    try:
        pred.warmup((16, 16))
        assert pred.batch_sizes == [1, 2, 4]
        assert pred.batch_window_s == 0.0  # the warmup's window rides on its requests
    finally:
        pred.close()


def test_predict_batch1_equals_pipeline_sample():
    pred = _predictor(seed=5)
    try:
        img = _img(3)
        got = pred.predict(img)
    finally:
        pred.close()
    pipe = ResShiftPipeline(small_config(), dtype=torch.float32, device="cpu")
    pipe.init_params(0)
    lq = torch.from_numpy(image_io.to_model(img.astype(np.float32) / 255.0))
    want = image_io.from_model(pipe.sample(lq, torch.Generator().manual_seed(5)).numpy())[0]
    np.testing.assert_array_equal(got, want)


def test_predict_pastes_back_outside_the_mask():
    """The inpainting paste-back (here with a forward that returns zeros
    at the input's size): the input outside the mask, the output inside."""
    pred = _predictor()
    try:
        pred.pipe.sample = lambda lq, *a, **k: torch.zeros_like(lq)
        img = _img(4).astype(np.float32) / 255.0
        mask = np.zeros((16, 16, 1), np.float32)
        mask[4:12, 4:12] = 1.0
        got = pred.predict(img, mask)
        keep = mask[..., 0] == 0
        np.testing.assert_allclose(got[keep], img[keep], atol=1e-6)
        np.testing.assert_allclose(got[~keep], 0.5, atol=1e-6)
    finally:
        pred.close()


def _gated_predictor(**kw):
    """A predictor whose forward waits on an event: the tests fill the
    bounded queue deterministically."""
    pred = _predictor(batch_window_s=0.01, **kw)
    gate = threading.Event()

    def slow_sample(lq, generator=None, mask=None, tile_bs=1, **_):
        assert gate.wait(60), "test gate never released"
        b, h, w = lq.shape[:3]
        return torch.zeros(b, h * 4, w * 4, 3)

    pred.pipe.sample = slow_sample
    return pred, gate


def test_predictor_burst_fast_fails_with_busy():
    pred, gate = _gated_predictor(max_batch=1, max_queue=3)
    threads = []
    try:
        img = np.zeros((16, 16, 3), np.uint8)
        results = []
        for _ in range(4):  # one in flight on the worker + three queued
            t = threading.Thread(target=lambda: results.append(pred.predict(img)))
            t.start()
            threads.append(t)
        deadline = time.monotonic() + 30
        while pred.queue_depth() < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pred.queue_depth() == 3
        t0 = time.monotonic()
        with pytest.raises(srv.ServerBusyError):
            pred.predict(img)
        assert time.monotonic() - t0 < 1.0
        assert pred.metrics()["requests_rejected"] == 1
        gate.set()
        for t in threads:
            t.join(timeout=60)
        assert len(results) == 4 and pred.metrics()["requests_done"] == 4
    finally:
        gate.set()
        pred.close()


def test_predictor_request_timeout_drops_abandoned_work():
    pred, gate = _gated_predictor(max_batch=1, max_queue=8)
    try:
        img = np.zeros((16, 16, 3), np.uint8)
        t1 = threading.Thread(target=lambda: pred.predict(img))
        t1.start()
        time.sleep(0.1)
        with pytest.raises(TimeoutError):
            pred.predict(img, timeout_s=0.3)
        assert pred.metrics()["requests_timeout"] == 1
        gate.set()
        t1.join(timeout=60)
        n_before = len(pred.batch_sizes)
        assert pred.predict(img).shape == (64, 64, 3)
        assert len(pred.batch_sizes) == n_before + 1
        assert pred.metrics()["requests_done"] == 2
    finally:
        gate.set()
        pred.close()


def test_predictor_close_drains_and_rejects_new_work():
    pred, gate = _gated_predictor(max_batch=1, max_queue=8)
    results = []
    try:
        img = np.zeros((16, 16, 3), np.uint8)
        threads = [threading.Thread(target=lambda: results.append(pred.predict(img)))
                   for _ in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while pred.queue_depth() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        closer = threading.Thread(target=pred.close)
        closer.start()
        time.sleep(0.1)
        with pytest.raises(srv.ServerClosedError):
            pred.predict(img)
        gate.set()
        closer.join(timeout=60)
        assert not closer.is_alive()
        for t in threads:
            t.join(timeout=60)
        assert len(results) == 3
    finally:
        gate.set()


def test_close_drains_queued_work_with_closed_error():
    """What is queued behind the shutdown mark gets ServerClosedError,
    not a wait that never ends."""
    pred, gate = _gated_predictor(max_batch=1, max_queue=8)
    reqs = [srv._Request(lq=np.zeros((1, 16, 16, 3), np.float32), mask=None,
                         done=threading.Event()) for _ in range(3)]
    pred._submit(reqs[0])
    time.sleep(0.1)  # in flight at the gate, its batching window over
    pred._requests.put(None)
    for r in reqs[1:]:
        pred._submit(r)
    gate.set()
    pred._worker.join(timeout=60)
    assert not pred._worker.is_alive()
    assert reqs[0].error is None and reqs[0].result.shape == (64, 64, 3)
    assert all(r.done.is_set() and isinstance(r.error, srv.ServerClosedError) for r in reqs[1:])


def test_predictor_metrics():
    pred = _predictor(max_batch=4, batch_window_s=0.05)
    try:
        m0 = pred.metrics()
        assert m0["requests_done"] == 0 and m0["forward_seconds"]["p50"] is None
        assert set(m0) == {"queue_depth", "requests_done", "requests_error",
                           "requests_rejected", "requests_timeout", "forwards",
                           "batch_size_hist", "forward_seconds", "max_batch", "max_queue",
                           "request_timeout_s", "chop_bs"}
        img = _img(1)
        for _ in range(3):
            pred.predict(img)
        m = pred.metrics()
        assert m["requests_done"] == 3 and m["requests_error"] == 0
        assert m["forwards"] == len(pred.batch_sizes) >= 1
        assert sum(int(k) * v for k, v in m["batch_size_hist"].items()) == 3
        assert m["forward_seconds"]["p50"] > 0
        assert m["forward_seconds"]["p99"] >= m["forward_seconds"]["p50"]
        assert m["queue_depth"] == 0
        with pytest.raises(Exception):
            pred.predict(np.zeros((16, 16, 5), np.float32))  # five channels
        assert pred.metrics()["requests_error"] == 1
    finally:
        pred.close()


def test_serve_chop_size_override():
    pred = _predictor(chop_size=64)
    try:
        assert pred.pipe.chop_size == 64 and pred.pipe.chop_stride == 48
    finally:
        pred.close()


def test_unported_options_raise():
    """The int8 VQGAN is not ported and raises; `--dp` is ported: on one
    device it serves unsplit, as the JAX package's does on one chip."""
    pred = _predictor(data_parallel=True)
    try:
        assert pred.devices is None
    finally:
        pred.close()
    with pytest.raises(NotImplementedError):
        _predictor(quant_vqgan="int8")
    with pytest.raises(NotImplementedError):
        srv.main(["--quant-vqgan", "int8", "--device", "cpu"])
    with pytest.raises(ValueError, match=".pth"):
        _predictor(ckpt="weights_dir")


# -------------------------------------------------------------------- HTTP

def _start(predictor):
    srv._Handler.predictor = predictor
    httpd = srv.HTTPServer(("127.0.0.1", 0), srv._Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def _post(port, data, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/restore", data=data, method="POST",
                                 headers=headers or {})
    return urllib.request.urlopen(req, timeout=30)


def test_http_serving_roundtrip():
    class StubPredictor:
        def predict(self, image, mask=None):
            return np.repeat(np.repeat(image.astype(np.float32) / 255.0, 4, 0), 4, 1)

    httpd, port = _start(StubPredictor())
    try:
        assert srv.HTTPServer.request_queue_size == 512
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health") as r:
            assert json.loads(r.read())["status"] == "ok"
        img = _img(0)
        with _post(port, image_io.png_encode(img)) as r:
            assert r.headers["Content-Type"] == "image/png"
            out = image_io.png_decode(r.read())
        np.testing.assert_array_equal(out, np.repeat(np.repeat(img, 4, 0), 4, 1))
        # gray and 16-bit bodies decode as a colour read gives them
        gray16 = (np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
        with _post(port, image_io.png_encode(gray16)) as r:
            out = image_io.png_decode(r.read())
        assert out.shape == (32, 32, 3) and (out[..., 0] == out[..., 2]).all()
        assert out[0, 4, 0] == (1000 >> 8)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, b"not-an-image")
        assert e.value.code == 500 and "decode" in json.loads(e.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
        assert e.value.code == 404
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/") as r:
            page = r.read().decode()
        assert "ResShift" in page and "GPU" in page and "TPU" not in page and "/restore" in page
        try:  # oversized: answered from the header alone
            _post(port, b"x", {"Content-Length": str(srv._Handler.max_body + 1)})
            raise AssertionError("expected 413")
        except urllib.error.HTTPError as e:
            assert e.code == 413
        except urllib.error.URLError:
            pass  # some stacks abort the send after the early reply
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, b"")
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_http_backpressure_status_codes():
    class BusyPredictor:
        mode = "busy"

        def predict(self, image, mask=None):
            if self.mode == "busy":
                raise srv.ServerBusyError("queue full")
            if self.mode == "timeout":
                raise TimeoutError("too slow")
            raise srv.ServerClosedError("closing")

    stub = BusyPredictor()
    httpd, port = _start(stub)
    body = image_io.png_encode(_img(0, 8))
    try:
        for mode, code, retry in (("busy", 429, "1"), ("timeout", 503, "5"),
                                  ("closed", 503, "5")):
            stub.mode = mode
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, body)
            assert e.value.code == code and e.value.headers.get("Retry-After") == retry
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_http_metrics_endpoint():
    class StubPredictor:
        def metrics(self):
            return {"queue_depth": 0, "requests_done": 42}

    httpd, port = _start(StubPredictor())
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
            assert json.loads(r.read())["requests_done"] == 42
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_loadtest_drive_against_a_real_predictor():
    """The load test's bursts through HTTP to the small Predictor: every 200
    a PNG of the right size, the overload burst answered 429 with
    Retry-After, and the /metrics counts adding up."""
    pred = _predictor(max_batch=4, max_queue=4, batch_window_s=0.5)
    httpd, port = _start(pred)
    try:
        pred.warmup((16, 16))
        r = serve_loadtest.drive(port, hw=16, burst=8, threads=4, overload=24)
    finally:
        httpd.shutdown()
        httpd.server_close()
        pred.close()
    b, o, m = r["burst"], r["overload"], r["server_metrics"]
    assert b["ok"] == b["png_ok"] == 8 and b["mpx_per_s"] > 0 and b["p99_ms"] >= b["p50_ms"]
    assert o["rejected"] > 0 and o["retry_after_set"]
    assert o["ok"] == o["png_ok"] and o["ok"] + o["rejected"] == 24
    assert m["requests_rejected"] == o["rejected"]
    assert m["requests_done"] == 1 + 2 + 4 + 1 + 8 + o["ok"]  # warmup, first, bursts
    assert sum(int(k) * v for k, v in m["batch_size_hist"].items()) == m["requests_done"]


# ----------------------------------------------------------- observability

def test_nan_guard(tmp_path):
    batch = {"a": torch.tensor([1.0, float("nan")]), "b": torch.ones(2)}
    out, flagged = obs.nan_guard(batch, tmp_path / "audit.log")
    assert flagged and torch.isfinite(out["a"]).all() and out["b"] is batch["b"]
    assert (tmp_path / "audit.log").read_text() == "NaN found in batch on process 0\n"
    _, flagged2 = obs.nan_guard({"a": torch.ones(2)}, tmp_path / "audit2.log")
    assert not flagged2 and not (tmp_path / "audit2.log").exists()


def test_measure_and_trace(tmp_path):
    r = obs.measure(lambda: torch.ones(64, 64) @ torch.ones(64, 64), iters=2)
    assert r["compile_s"] >= 0 and r["steady_s"] >= 0
    with obs.trace(tmp_path / "tr"):
        torch.ones(8) + 1
    assert "traceEvents" in json.loads((tmp_path / "tr" / "trace.json").read_text())


def test_debug_nans_names_the_module():
    class Bad(torch.nn.Module):
        def forward(self, x):
            return torch.log(x - 10.0)  # NaN for x < 10

    net = torch.nn.Sequential(torch.nn.Linear(4, 4),
                              torch.nn.Sequential(torch.nn.Identity(), Bad()))
    with pytest.raises(FloatingPointError, match=r"module '1\.1' \(Bad"):
        with obs.debug_nans():
            net(torch.ones(2, 4))
    net(torch.ones(2, 4))  # the hooks are gone
    with obs.debug_nans(False):
        net(torch.ones(2, 4))


# ------------------------------------------- kernels on their tensors' card

class _Stream:
    def __init__(self, index):
        self.cuda_stream = 1000 + index


def test_kernel_launches_on_its_tensors_device(monkeypatch):
    """A kernel's call makes its tensors' card current and passes that
    card's stream, whichever card was current before (the calling thread's
    is card 0 here)."""
    current = [0]
    seen = []

    class Device:
        def __init__(self, d):
            self.idx = torch.device(d).index

        def __enter__(self):
            self.prev, current[0] = current[0], self.idx

        def __exit__(self, *exc):
            current[0] = self.prev

    class Lib:
        def __getattr__(self, name):
            def fn(*args):
                seen.append((name, current[0], args[-1]))
                return 0
            return fn

    monkeypatch.setattr(_ext, "_library", lambda lib: Lib())
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream(
        current[0] if d is None else torch.device(d).index))
    kern = _ext.Kernel("vq_nearest", [_ext.P] * 3 + [_ext.I] * 3)
    kern(1, 2, 3, 4, 5, 6, device=torch.device("cuda", 1))
    kern(1, 2, 3, 4, 5, 6, device=torch.device("cuda", 0))
    assert seen == [("vq_nearest", 1, 1001), ("vq_nearest", 0, 1000)]
    assert current[0] == 0 and kern.launches == 2
    with pytest.raises(TypeError):
        kern(1, 2, 3, 4, 5, 6)  # the device is required


def test_every_wrapper_passes_its_tensors_device():
    """Each launch of a kernel object in ops/ names `device=<tensor>.device`."""
    n = 0
    for f in sorted((ROOT / "resshift_tpu_torch" / "ops").glob("*.py")):
        tree = ast.parse(f.read_text())
        kernels = {t.id for node in ast.walk(tree) if isinstance(node, ast.Assign)
                   and isinstance(node.value, ast.Call)
                   and getattr(node.value.func, "attr", None) == "Kernel"
                   for t in node.targets}
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) in kernels:
                dev = [k.value for k in node.keywords if k.arg == "device"]
                assert dev and isinstance(dev[0], ast.Attribute) and dev[0].attr == "device", \
                    f"{f.name}:{node.lineno}"
                n += 1
    assert n == 20  # every launch site of the twelve sites' kernels


def test_serve_and_loadtest_help_run_without_jax():
    import subprocess
    import sys

    code = ("import sys, runpy\n"
            "sys.argv = ['serve', '--help']\n"
            "try:\n    runpy.run_module('resshift_tpu_torch.serve', run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0\n"
            "import resshift_tpu_torch.tools.serve_loadtest\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'yaml', 'resshift_tpu', 'cv2')]\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=Path(ROOT), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "--warmup" in r.stdout and "--device" in r.stdout
