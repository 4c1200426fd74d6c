"""Serving: a programmatic `Predictor` and a stdlib HTTP endpoint.

    python -m resshift_tpu_torch.serve --task realsr_v3 --device cuda --warmup 64x64
    curl -X POST --data-binary @lq.png localhost:8080/restore > sr.png

Concurrency: every device call, from building the pipeline to the last
forward, runs on ONE device-worker thread fed by a bounded request queue,
so handler threads never touch a tensor on the device, the pipeline or the
noise generator.  The worker micro-batches same-shape requests that arrive
within `batch_window_s` (up to `max_batch`) into one sampler call, padded
to a power-of-two bucket by repeating the last image, so that only the
buckets `warmup` ran ever reach the card.  The noise comes from one
`torch.Generator` on the pipeline's device, seeded from `seed` and advanced
only by the worker: each image of a batch (padding included) draws its own
noise, so identical concurrent inputs get distinct restorations.

Backpressure: a burst beyond `max_queue` waiting requests fails at once
with `ServerBusyError` (HTTP 429, Retry-After: 1); a request not served
within its timeout raises `TimeoutError` to its caller (503, Retry-After:
5) and the worker drops it unprocessed; `close()` stops admission at once
and drains what is queued with `ServerClosedError` (503).

HTTP: GET /health, GET /metrics (`Predictor.metrics()`), GET / (a browser
demo page), POST /restore with a PNG body (the port's own codec: the card's
machine has no OpenCV) answered with the restored PNG; 413 / 400 on the
body size, 500 with a JSON error on a body that does not decode.  The
accept backlog is 512, so a burst is answered with 429 rather than reset
by the kernel.

Several cards (`--dp`, `Predictor(data_parallel=True)`; on by default
where the process owns more than one): each dispatched batch is split over
the cards (`ResShiftPipeline.sample_batch_sharded`), a single image larger
than the chop size has its tile grid split instead (`sample_tiles_sharded`),
and `max_batch` is raised to at least the card count.  The draws are those
of `sample` on the same batch, so the images are `sample`'s up to the
rounding of a smaller batch.

Not ported: the int8 VQGAN (`--quant-vqgan int8`) raises
`NotImplementedError`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import queue as _queue
import struct
import sys
import threading
import time
import zlib
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = ["Predictor", "ServerBusyError", "ServerClosedError", "decode_image", "encode_image",
           "serve", "main"]

WARMUP_WINDOW_S = 0.25  # a warmup group's batching window: one group, one batch


class ServerBusyError(RuntimeError):
    """Admission control: the bounded request queue is full (HTTP 429)."""


class ServerClosedError(RuntimeError):
    """The predictor is shutting down; queued work is drained with this
    error instead of blocking forever (HTTP 503)."""


@dataclasses.dataclass
class _Request:
    lq: np.ndarray                      # (1, H, W, C) model-space [-1, 1]
    mask: np.ndarray | None
    done: threading.Event
    window_s: float | None = None       # batching window if this request opens a batch
    result: np.ndarray | None = None    # (H*sf, W*sf, C) in [0, 1]
    error: Exception | None = None
    abandoned: bool = False             # the caller timed out; the worker drops it

    @property
    def sig(self):
        return self.lq.shape, None if self.mask is None else self.mask.shape


class Predictor:
    """One-time model setup, then `predict` per request, from any number of
    threads: calls go through the device-worker thread and are batched.

    `task` is a task name or a config dict; without `ckpt` the weights are
    random (seed 0).  `device` is the pipeline's ("cuda" by default).
    `data_parallel` splits each batch over `devices` (this process's cards
    by default); None turns it on where there are two or more."""

    def __init__(self, task: str | dict = "realsr_v3", ckpt: str | None = None,
                 vqgan_ckpt: str | None = None, seed: int = 12345, bf16: bool = True,
                 chop_bs: int = 128, max_batch: int = 16, batch_window_s: float = 0.01,
                 quant_vqgan: str | None = None, data_parallel: bool | None = None,
                 max_queue: int = 64, request_timeout_s: float | None = 300.0,
                 chop_size: int | None = None, chop_stride: int | None = None,
                 device: str = "cuda", devices: list | None = None):
        if quant_vqgan is not None:
            raise NotImplementedError("the int8 VQGAN is not ported")
        if ckpt and not str(ckpt).endswith(".pth"):
            raise ValueError("the port loads the released .pth checkpoints only")
        if data_parallel is not False:
            import torch

            from .parallel.mesh import local_devices

            devices = (local_devices() if devices is None and device != "cpu"
                       else [torch.device(d) for d in devices or [device]])
        # the cards a batch is split over, or None: one card
        self.devices = devices if data_parallel is not False and len(devices) > 1 else None
        if self.devices is not None:  # a whole row of cards per dispatch
            max_batch = max(int(max_batch), len(self.devices))
        self.chop_bs = chop_bs
        self.max_batch = max(1, int(max_batch))
        self.batch_window_s = float(batch_window_s)
        self.max_queue = max(int(max_queue), self.max_batch)
        self.request_timeout_s = request_timeout_s
        self._requests: _queue.Queue = _queue.Queue(maxsize=self.max_queue)
        self._closing = False
        self._pending: deque = deque()     # worker-local overflow (mixed shapes)
        self.batch_sizes: list[int] = []   # images per forward
        self._lat = deque(maxlen=512)      # seconds per forward
        self._lock = threading.Lock()      # the counters callers' threads update
        self._n_done = 0
        self._n_err = 0
        self._n_rejected = 0
        self._n_timeout = 0
        self.pipe = None
        setup = dict(task=task, ckpt=ckpt, vqgan_ckpt=vqgan_ckpt, seed=seed, bf16=bf16,
                     chop_size=chop_size, chop_stride=chop_stride, device=device)
        ready = threading.Event()
        failed: list[BaseException] = []
        self._worker = threading.Thread(target=self._worker_main, args=(setup, ready, failed),
                                        name="predictor-device-worker", daemon=True)
        self._worker.start()
        ready.wait()
        if failed:
            raise failed[0]

    # ------------------------------------------------------------ public

    def predict(self, image: np.ndarray, mask: np.ndarray | None = None,
                timeout_s: float | None = None) -> np.ndarray:
        """image: HWC RGB uint8 or [0, 1] float -> restored HWC [0, 1] float.

        Raises ServerBusyError at once when the bounded queue is full,
        TimeoutError when the result does not arrive within `timeout_s`
        (default: the predictor's `request_timeout_s`), ServerClosedError
        when shutting down."""
        from .utils.image_io import to_model

        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        req = _Request(lq=to_model(image), mask=None if mask is None else to_model(mask),
                       done=threading.Event())
        self._submit(req)
        timeout = self.request_timeout_s if timeout_s is None else timeout_s
        if not req.done.wait(timeout):
            req.abandoned = True  # the worker drops it unprocessed
            with self._lock:
                self._n_timeout += 1
            raise TimeoutError(f"request not served within {timeout:.0f}s "
                               f"(queue_depth={self.queue_depth()})")
        if req.error is not None:
            raise req.error
        sr = req.result
        if req.mask is not None:  # inpainting paste-back
            m01 = req.mask[0] * 0.5 + 0.5
            sr = sr * m01 + image[..., :3] * (1 - m01)
        return sr

    def _submit(self, req: _Request) -> None:
        if self._closing:
            raise ServerClosedError("predictor is shutting down")
        try:
            self._requests.put_nowait(req)
        except _queue.Full:
            with self._lock:
                self._n_rejected += 1
            raise ServerBusyError(f"request queue full ({self.max_queue} waiting); "
                                  f"retry later") from None

    def queue_depth(self) -> int:
        return self._requests.qsize() + len(self._pending)

    def _bucket(self, n: int) -> int:
        """Smallest power of two >= n, capped at max_batch: the batch size a
        forward of n images is padded to."""
        b = 1
        while b < n and b < self.max_batch:
            b *= 2
        return min(b, self.max_batch)

    def warmup(self, hw: tuple[int, int] = (64, 64), batch_sizes=None) -> None:
        """Run every dispatch bucket (1, 2, 4, ..., max_batch) once at an
        (h, w) input, so that the kernels' build and load, cuDNN's first
        calls and the per-shape caches happen before the first request.
        Each group's requests carry a wide batching window of their own, so
        that a group becomes one batch of exactly its size."""
        if batch_sizes is None:
            batch_sizes, b = [], 1
            while b < self.max_batch:
                batch_sizes.append(b)
                b *= 2
            batch_sizes.append(self.max_batch)
        for bs in batch_sizes:
            reqs = [_Request(lq=np.zeros((1, hw[0], hw[1], 3), np.float32), mask=None,
                             done=threading.Event(), window_s=WARMUP_WINDOW_S)
                    for _ in range(bs)]
            for r in reqs:
                self._submit(r)
            for r in reqs:
                r.done.wait()
                if r.error is not None:
                    raise r.error

    def close(self) -> None:
        """Stop accepting work, let the worker finish the batch in flight,
        and drain everything still queued with ServerClosedError."""
        self._closing = True
        self._requests.put(None)  # bounded, but producers have stopped
        self._worker.join(timeout=30)

    # ------------------------------------------------------------ worker

    def _setup(self, task, ckpt, vqgan_ckpt, seed, bf16, chop_size, chop_stride, device):
        """Build the pipeline and the generator (on the worker thread)."""
        import torch

        from .config import default_chop
        from .pipeline import ResShiftPipeline

        self.pipe = ResShiftPipeline(task, dtype=torch.bfloat16 if bf16 else torch.float32,
                                     device=device)
        if chop_size:  # the reference's stride for the size unless one is given
            self.pipe.chop_size = int(chop_size)
            self.pipe.chop_stride = int(chop_stride or default_chop(int(chop_size), 4)[1])
        if ckpt:
            self.pipe.load_torch_checkpoints(ckpt, vqgan_ckpt)
        else:
            print("WARNING: serving with RANDOM weights (no --ckpt)", file=sys.stderr)
            self.pipe.init_params(0)
        self._generator = torch.Generator(device=self.pipe.device).manual_seed(seed)

    def _worker_main(self, setup: dict, ready: threading.Event, failed: list) -> None:
        import torch

        try:
            self._setup(**setup)
            if self.pipe.device.type == "cuda" and self.pipe.device.index is not None:
                torch.cuda.set_device(self.pipe.device)  # this thread's cuDNN and cuBLAS handles
        except BaseException as e:  # noqa: BLE001 -- handed to the constructor, which raises
            failed.append(e)
            return
        finally:
            ready.set()
        with torch.no_grad():  # grad mode is per thread
            self._worker_loop()

    def _collect(self):
        """Blocking: the next same-shape batch of requests, or None on
        shutdown.  Mixed-shape arrivals are parked in `_pending`; requests
        whose caller already timed out are dropped unprocessed."""
        first = None
        while first is None or first.abandoned:
            if self._pending:
                first = self._pending.popleft()
            else:
                first = self._requests.get()
                if first is None:
                    return None
        batch, sig = [first], first.sig
        keep = deque()  # parked requests with the same signature go first
        while self._pending and len(batch) < self.max_batch:
            r = self._pending.popleft()
            if r.abandoned:
                continue
            (batch if r.sig == sig else keep).append(r)
        self._pending.extendleft(reversed(keep))
        window = self.batch_window_s if first.window_s is None else first.window_s
        deadline = time.monotonic() + window
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                r = self._requests.get(timeout=remaining)
            except _queue.Empty:
                break
            if r is None:  # shutdown: finish this batch first
                self._requests.put(None)
                break
            if r.abandoned:
                continue
            (batch if r.sig == sig else self._pending).append(r)
        return batch

    def _drain(self) -> None:
        """Shutdown: everything still queued gets ServerClosedError."""
        leftovers = list(self._pending)
        self._pending.clear()
        while True:
            try:
                r = self._requests.get_nowait()
            except _queue.Empty:
                break
            if r is not None:
                leftovers.append(r)
        for r in leftovers:
            r.error = ServerClosedError("predictor closed before this request was served")
            r.done.set()

    def _worker_loop(self) -> None:
        import torch

        from .utils.image_io import from_model

        while True:
            batch = self._collect()
            if batch is None:
                self._drain()
                return
            self.batch_sizes.append(len(batch))
            try:
                n = len(batch)
                lq = np.concatenate([r.lq for r in batch], axis=0)
                mask = (np.concatenate([r.mask for r in batch], axis=0)
                        if batch[0].mask is not None else None)
                pad = self._bucket(n) - n  # repeat the last image up to the bucket
                if pad:
                    lq = np.concatenate([lq, np.repeat(lq[-1:], pad, 0)], 0)
                    if mask is not None:
                        mask = np.concatenate([mask, np.repeat(mask[-1:], pad, 0)], 0)
                t0 = time.perf_counter()
                lq_t, mask_t = (None if a is None else torch.from_numpy(a) for a in (lq, mask))
                chopped = max(lq.shape[1:3]) > self.pipe.chop_size
                if self.devices is not None and lq.shape[0] == 1 and chopped:
                    # one big image: its tile grid is split over the cards
                    out = self.pipe.sample_tiles_sharded(lq_t, self._generator, self.devices,
                                                         mask_t)
                elif self.devices is not None:
                    out = self.pipe.sample_batch_sharded(lq_t, self._generator, self.devices,
                                                         mask_t, tile_bs=self.chop_bs)
                else:
                    out = self.pipe.sample(lq_t, self._generator, mask_t, tile_bs=self.chop_bs)
                sr = from_model(out[:n].float().cpu().numpy())  # waits for the device
                self._lat.append(time.perf_counter() - t0)
                self._n_done += n
                for i, r in enumerate(batch):
                    r.result = sr[i]
                    r.done.set()
            except Exception as e:  # noqa: BLE001 -- delivered to the callers; the worker lives on
                self._n_err += len(batch)
                for r in batch:
                    r.error = e
                    r.done.set()

    # ------------------------------------------------------- observability

    def metrics(self) -> dict:
        """Serving counters: queue depth, completed / error / rejected /
        timed-out requests, the batch-size histogram and forward-time
        quantiles over the last 512 forwards."""
        lat = sorted(self._lat)

        def q(p):
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 4) if lat else None

        hist: dict[str, int] = {}
        for s in self.batch_sizes[-512:]:
            hist[str(s)] = hist.get(str(s), 0) + 1
        return {
            "queue_depth": self.queue_depth(),
            "requests_done": self._n_done,
            "requests_error": self._n_err,
            "requests_rejected": self._n_rejected,
            "requests_timeout": self._n_timeout,
            "forwards": len(self.batch_sizes),
            "batch_size_hist": hist,
            "forward_seconds": {"p50": q(0.50), "p90": q(0.90), "p99": q(0.99)},
            "max_batch": self.max_batch,
            "max_queue": self.max_queue,
            "request_timeout_s": self.request_timeout_s,
            "chop_bs": self.chop_bs,
        }


# ------------------------------------------------------------------ HTTP

def decode_image(raw: bytes) -> np.ndarray:
    """A PNG body -> HWC RGB uint8, as a colour read gives it: gray
    repeated into three channels, alpha dropped, 16-bit cut to 8 bits."""
    from .utils.image_io import png_decode

    try:
        im = png_decode(raw)
    except (ValueError, IndexError, struct.error, zlib.error) as e:
        raise ValueError("cannot decode image body") from e
    if im.dtype == np.uint16:
        im = (im >> 8).astype(np.uint8)
    if im.ndim == 2:
        im = im[..., None]
    return np.repeat(im[..., :1], 3, axis=2) if im.shape[2] < 3 else im[..., :3]


def encode_image(sr: np.ndarray) -> bytes:
    """HWC [0, 1] float -> an 8-bit RGB PNG."""
    from .utils.image_io import png_encode

    return png_encode(np.clip(np.round(np.clip(sr, 0.0, 1.0) * 255.0), 0, 255).astype(np.uint8))


_DEMO_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ResShift demo (PyTorch, GPU)</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:880px;margin:2rem auto;padding:0 1rem}
 .row{display:flex;gap:1rem;flex-wrap:wrap}
 .row>div{flex:1;min-width:300px}
 img{max-width:100%%;border:1px solid #ccc;border-radius:4px}
 button{padding:.5rem 1.2rem;font-size:1rem;cursor:pointer}
 #status{color:#666;margin-left:1rem}
</style></head><body>
<h2>ResShift &mdash; image restoration (task: %(task)s)</h2>
<p>Upload a low-quality PNG; the server runs the full diffusion sampler
on the GPU and returns the restored result.</p>
<p><input type="file" id="file" accept="image/png">
   <button id="go" disabled>Restore</button><span id="status"></span></p>
<div class="row">
 <div><h4>Input</h4><img id="in"></div>
 <div><h4>Output</h4><img id="out"></div>
</div>
<script>
const f=document.getElementById('file'),go=document.getElementById('go'),
      st=document.getElementById('status');
let data=null;
f.onchange=()=>{const r=new FileReader();
  r.onload=()=>{data=r.result;document.getElementById('in').src=
    URL.createObjectURL(f.files[0]);go.disabled=false;};
  r.readAsArrayBuffer(f.files[0]);};
go.onclick=async()=>{go.disabled=true;st.textContent='running\\u2026';
  try{const t0=performance.now();
    const resp=await fetch('/restore',{method:'POST',body:data});
    if(!resp.ok)throw new Error(await resp.text());
    const blob=await resp.blob();
    document.getElementById('out').src=URL.createObjectURL(blob);
    st.textContent=((performance.now()-t0)/1000).toFixed(1)+' s';
  }catch(e){st.textContent='error: '+e.message;}
  go.disabled=false;};
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    predictor: Predictor = None  # set by serve()
    task: str = "?"
    max_body: int = 64 * 1024 * 1024  # larger uploads get 413 unread

    def _reply(self, code: int, body: bytes, ctype: str, headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/health":
            self._reply(200, json.dumps({"status": "ok"}).encode(), "application/json")
        elif self.path == "/metrics":
            self._reply(200, json.dumps(self.predictor.metrics()).encode(), "application/json")
        elif self.path in ("/", "/index.html"):
            self._reply(200, (_DEMO_PAGE % {"task": self.task}).encode(),
                        "text/html; charset=utf-8")
        else:
            self.send_error(404)

    def do_POST(self):
        if not self.path.startswith("/restore"):
            self.send_error(404)
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0 or n > self.max_body:
                msg = json.dumps({"error": f"body must be 1..{self.max_body} bytes"}).encode()
                self._reply(413 if n > self.max_body else 400, msg, "application/json")
                return
            img = decode_image(self.rfile.read(n))
            t0 = time.perf_counter()
            sr = self.predictor.predict(img)
            dt = time.perf_counter() - t0
            self._reply(200, encode_image(sr), "image/png",
                        {"X-Inference-Seconds": f"{dt:.3f}"})
        except Exception as e:  # noqa: BLE001 -- every failure becomes a JSON error reply
            # full queue -> 429 (retry soon); timeout or shutdown -> 503
            if isinstance(e, ServerBusyError):
                code, headers = 429, {"Retry-After": "1"}
            elif isinstance(e, (TimeoutError, ServerClosedError)):
                code, headers = 503, {"Retry-After": "5"}
            else:
                code, headers = 500, {}
            self._reply(code, json.dumps({"error": str(e)}).encode(), "application/json",
                        headers)

    def log_message(self, fmt, *args):
        print(f"[serve] {fmt % args}", file=sys.stderr)


class HTTPServer(ThreadingHTTPServer):
    """The default accept backlog (5) resets a modest concurrent burst in
    the kernel before the bounded queue can answer 429: backpressure has to
    happen here, so the backlog exceeds any burst meant to get 429."""

    request_queue_size = 512
    daemon_threads = True


def serve(task: str = "realsr_v3", ckpt: str | None = None, vqgan_ckpt: str | None = None,
          host: str = "0.0.0.0", port: int = 8080, chop_bs: int = 128, max_batch: int = 16,
          warmup: str | None = None, max_body_mb: int = 64, quant_vqgan: str | None = None,
          data_parallel: bool | None = None, max_queue: int = 64,
          request_timeout_s: float = 300.0, chop_size: int | None = None,
          chop_stride: int | None = None, device: str = "cuda") -> None:
    _Handler.predictor = Predictor(task, ckpt, vqgan_ckpt, chop_bs=chop_bs, max_batch=max_batch,
                                   quant_vqgan=quant_vqgan, data_parallel=data_parallel,
                                   max_queue=max_queue, request_timeout_s=request_timeout_s,
                                   chop_size=chop_size, chop_stride=chop_stride, device=device)
    _Handler.task = task
    _Handler.max_body = int(max_body_mb) * 1024 * 1024
    if warmup:
        h, w = (int(v) for v in warmup.lower().split("x"))
        print(f"[serve] warming up {h}x{w} (every dispatch bucket up to {max_batch})...",
              file=sys.stderr)
        _Handler.predictor.warmup((h, w))
    httpd = HTTPServer((host, port), _Handler)
    print(f"[serve] {task} on {device}, listening on {host}:{port} (browser demo at /)",
          file=sys.stderr, flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        _Handler.predictor.close()


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="resshift_tpu_torch.serve")
    p.add_argument("--task", default="realsr_v3",
                   choices=["realsr_v1", "realsr_v2", "realsr_v3", "realsr_x2", "bicsr",
                            "inpaint_imagenet", "inpaint_face", "faceir"])
    p.add_argument("--ckpt", default=None, help="released denoiser .pth")
    p.add_argument("--vqgan-ckpt", default=None, help="released VQGAN .pth")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions of the kernels")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--chop-bs", type=int, default=128,
                   help="tiles per forward when chopping large inputs")
    p.add_argument("--max-batch", type=int, default=16,
                   help="concurrent same-shape requests batched per forward")
    p.add_argument("--max-queue", type=int, default=64,
                   help="bounded request queue depth; beyond it, requests fail at once "
                        "with HTTP 429")
    p.add_argument("--request-timeout", type=float, default=300.0, metavar="SECONDS",
                   help="per-request wall-clock budget; exceeded -> HTTP 503 and the queued "
                        "entry is dropped unprocessed")
    p.add_argument("--warmup", default=None, metavar="HxW",
                   help="run every dispatch bucket at this input size first, e.g. 64x64")
    p.add_argument("--max-body-mb", type=int, default=64,
                   help="reject request bodies larger than this (413)")
    p.add_argument("--quant-vqgan", default=None, choices=["int8"],
                   help="the int8 VQGAN: not ported (raises)")
    p.add_argument("--dp", dest="data_parallel", action="store_true", default=None,
                   help="split each batch over this process's cards (default: on where it "
                        "owns two or more)")
    p.add_argument("--no-dp", dest="data_parallel", action="store_false")
    p.add_argument("--chop-size", type=int, default=None, choices=[512, 256, 64],
                   help="tile size for big inputs (default: the task config's)")
    p.add_argument("--chop-stride", type=int, default=None,
                   help="tile stride (default: the reference stride for the size)")
    return p


def main(argv=None) -> None:
    a = make_parser().parse_args(argv)
    serve(a.task, a.ckpt, a.vqgan_ckpt, a.host, a.port, a.chop_bs, a.max_batch, a.warmup,
          a.max_body_mb, a.quant_vqgan, a.data_parallel, a.max_queue, a.request_timeout,
          a.chop_size, a.chop_stride, a.device)


if __name__ == "__main__":
    main()
