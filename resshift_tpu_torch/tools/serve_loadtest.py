"""Serving load test through the real HTTP path.

Starts `python -m resshift_tpu_torch.serve` in a subprocess (warmed up at
the test's input size) and drives it with concurrent HTTP bursts of more
requests than `max_batch`, measuring what a client sees: PNG decode, queue,
batch, sampler and PNG encode.

  * a closed-loop burst: delivered Mpx/s of SR output and the client's
    p50 / p90 / p99 latency, every 200 checked to be a PNG of the right size;
  * an overload burst beyond `max_queue`: the 429 count, and that every 429
    carries Retry-After;
  * the server's /metrics snapshot after both;
  * the card's name and power limit (nvidia-smi; "cpu" with `--device cpu`).

Prints one JSON line (the last line of its output); exits non-zero when the
server does not come up or dies.

    python -m resshift_tpu_torch.tools.serve_loadtest [--task realsr_v3] [--device cuda]
        [--hw 64] [--burst 96] [--threads 32] [--max-queue 24] [--overload 120]
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import http.client
import json
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..utils.image_io import png_decode, png_encode
from . import card

REPO = Path(__file__).resolve().parents[2]


def make_png(hw: int, seed: int) -> bytes:
    return png_encode(np.random.default_rng(seed).integers(0, 256, (hw, hw, 3), dtype=np.uint8))


def post(port: int, body: bytes, out_hw: int, timeout: float = 600.0) -> dict:
    """POST /restore; for a 200, whether the body is an RGB PNG of
    out_hw x out_hw."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/restore", body=body, headers={"Content-Length": str(len(body))})
        resp = conn.getresponse()
        data = resp.read()
        r = {"code": resp.status, "retry_after": resp.getheader("Retry-After"),
             "lat_s": time.perf_counter() - t0}
        if resp.status == 200:
            try:
                r["png_ok"] = png_decode(data).shape == (out_hw, out_hw, 3)
            except ValueError:
                r["png_ok"] = False
        return r
    finally:
        conn.close()


def get_json(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _codes(results: list[dict]) -> dict:
    return {str(c): sum(1 for r in results if r["code"] == c)
            for c in sorted({r["code"] for r in results})}


def drive(port: int, hw: int, burst: int, threads: int, overload: int, sf: int = 4) -> dict:
    """The first request, the closed-loop burst and the overload burst
    against a server on `port`; returns the report."""
    out_hw = hw * sf
    bodies = [make_png(hw, i) for i in range(threads)]
    first = post(port, bodies[0], out_hw)
    if first["code"] != 200:
        raise RuntimeError(f"first request failed: {first}")
    report = {"first_request_ms": first["lat_s"] * 1e3}

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(threads) as ex:
        results = list(ex.map(lambda i: post(port, bodies[i % threads], out_hw), range(burst)))
    wall = time.perf_counter() - t0
    ok = [r for r in results if r["code"] == 200]
    lat = sorted(r["lat_s"] for r in ok)
    q = lambda p: lat[int(p * (len(lat) - 1))] * 1e3 if lat else None
    report["burst"] = {"requests": burst, "threads": threads, "ok": len(ok),
                       "png_ok": sum(r["png_ok"] for r in ok), "codes": _codes(results),
                       "wall_s": wall, "mpx_per_s": len(ok) * out_hw ** 2 / wall / 1e6,
                       "p50_ms": q(0.5), "p90_ms": q(0.9), "p99_ms": q(0.99)}

    with cf.ThreadPoolExecutor(overload) as ex:
        results = list(ex.map(lambda i: post(port, bodies[i % threads], out_hw),
                              range(overload)))
    rejected = [r for r in results if r["code"] == 429]
    ok = [r for r in results if r["code"] == 200]
    report["overload"] = {"requests": overload, "codes": _codes(results), "ok": len(ok),
                          "png_ok": sum(r["png_ok"] for r in ok), "rejected": len(rejected),
                          "retry_after_set": all(r["retry_after"] for r in rejected),
                          "reject_latency_ms_max": max((r["lat_s"] for r in rejected),
                                                       default=0.0) * 1e3}
    report["server_metrics"] = get_json(port, "/metrics")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="resshift_tpu_torch.tools.serve_loadtest")
    ap.add_argument("--task", default="realsr_v3")
    ap.add_argument("--device", default="cuda", help="passed on to the server")
    ap.add_argument("--port", type=int, default=18080)
    ap.add_argument("--hw", type=int, default=64)
    ap.add_argument("--burst", type=int, default=96)
    ap.add_argument("--threads", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-queue", type=int, default=24)
    ap.add_argument("--overload", type=int, default=120,
                    help="one-shot burst size for the 429 check")
    ap.add_argument("--startup-timeout", type=float, default=900.0)
    args = ap.parse_args(argv)

    cmd = [sys.executable, "-m", "resshift_tpu_torch.serve", "--task", args.task,
           "--device", args.device, "--host", "127.0.0.1", "--port", str(args.port),
           "--warmup", f"{args.hw}x{args.hw}", "--max-batch", str(args.max_batch),
           "--max-queue", str(args.max_queue)]
    report = {"task": args.task, "device": args.device,
              "card": card(torch.device(args.device)), "hw": args.hw,
              "max_batch": args.max_batch, "max_queue": args.max_queue}
    with tempfile.TemporaryFile("w+") as log:
        srv = subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            while True:  # the server listens once its warmup is done
                try:
                    get_json(args.port, "/health")
                    break
                except OSError:
                    if srv.poll() is not None:
                        raise RuntimeError(f"server exited with {srv.returncode}") from None
                    if time.perf_counter() - t0 > args.startup_timeout:
                        raise RuntimeError("server did not come up") from None
                    time.sleep(1)
            report["startup_s"] = time.perf_counter() - t0
            report.update(drive(args.port, args.hw, args.burst, args.threads, args.overload))
        except Exception:
            log.seek(0)
            print(log.read()[-4000:], file=sys.stderr)
            raise
        finally:
            srv.send_signal(signal.SIGTERM)
            try:
                srv.wait(timeout=30)
            except subprocess.TimeoutExpired:
                srv.kill()
                srv.wait()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
