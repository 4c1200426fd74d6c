"""Tracing, timing and NaN checks for the port.

  * `trace(logdir)`: a `torch.profiler` trace of the CPU and, where there
    is one, the card, written to `logdir` as a Chrome trace that
    TensorBoard's profiler plugin and Perfetto load.
  * `measure(fn, iters)`: the first call and the steady state timed apart,
    each ended by `torch.cuda.synchronize()` where the output is on CUDA.
  * `nan_guard(batch, audit_path)`: NaNs replaced by zeros, with an audit
    line when any were found.
  * `debug_nans(enable)`: fail at the first module whose forward produces
    a NaN, naming it.

The JAX package's `start_profiler_server` (a live profiling endpoint) has
no PyTorch counterpart and is not ported.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import Any, Callable

import torch

__all__ = ["trace", "measure", "nan_guard", "debug_nans"]


def _tensors(out: Any):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


def _sync(out: Any) -> None:
    """Wait for the card where any tensor of `out` lies on one."""
    for t in _tensors(out):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Profile the block into `logdir/trace.json` (Chrome trace format)."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(logdir / "trace.json"))


def measure(fn: Callable[[], Any], iters: int = 5) -> dict[str, float]:
    """Run `fn` once (kernel builds, cuDNN's first calls) then `iters` times;
    returns seconds: the first call and the mean of the steady ones."""
    t0 = time.perf_counter()
    _sync(fn())
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn()
    _sync(out)
    return {"compile_s": first_s, "steady_s": (time.perf_counter() - t0) / iters}


def nan_guard(batch: dict[str, torch.Tensor], audit_path: str | Path | None = None
              ) -> tuple[dict, bool]:
    """Replace NaNs with zeros, logging an audit line when any were found."""
    flagged = False
    out = {}
    for k, v in batch.items():
        has_nan = bool(torch.isnan(v).any())
        flagged |= has_nan
        out[k] = torch.nan_to_num(v) if has_nan else v
    if flagged and audit_path is not None:
        rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
        with open(audit_path, "a") as f:
            f.write(f"NaN found in batch on process {rank}\n")
    return out, flagged


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Inside the block, raise `FloatingPointError` naming the first module
    whose forward returns a NaN, by its path in the outermost module being
    called (global forward hooks, removed on exit)."""
    if not enable:
        yield
        return
    calls = threading.local()  # each thread's stack of modules in forward

    def pre(module, args):
        calls.__dict__.setdefault("stack", []).append(module)

    def post(module, args, out):
        stack = calls.stack
        stack.pop()
        if any(t.is_floating_point() and bool(torch.isnan(t).any()) for t in _tensors(out)):
            root = stack[0] if stack else module
            name = next((n for n, m in root.named_modules() if m is module), "") or "<root>"
            raise FloatingPointError(f"NaN produced by module {name!r} "
                                     f"({type(module).__name__} in {type(root).__name__})")

    h_pre = torch.nn.modules.module.register_module_forward_pre_hook(pre)
    h_post = torch.nn.modules.module.register_module_forward_hook(post)
    try:
        yield
    finally:
        h_post.remove()
        h_pre.remove()
