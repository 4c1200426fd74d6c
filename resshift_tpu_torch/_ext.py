"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface under `resshift_tpu_torch/_build/`
(named by a hash of the sources, so an edit rebuilds), all sources at once
in parallel, at the first launch of any kernel.  The libraries are loaded
with ctypes: every pointer and the stream are `c_void_p`, and each C entry
point returns `cudaGetLastError()` after its launches.

Importing this module needs neither `nvcc` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["Kernel", "Recompute", "aligned16", "build_all", "dtype_code", "query", "P", "I",
           "F"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
_SOURCES = ("swin_window_attn", "swin_window_attn_tc", "swin_mlp", "swin_mlp_tc", "flash_attn_1h",
            "flash_attn_1h_tc", "vq_nearest", "shift_tokens", "gn_silu_conv3x3",
            "gn_silu_conv3x3_tc", "window_attn", "window_attn_tc", "winograd_conv3x3",
            "winograd_conv3x3_tc", "conv3x3", "conv3x3_tc", "attn_variants", "attn_variants_tc")

P = ctypes.c_void_p  # every pointer and the stream
I = ctypes.c_int
F = ctypes.c_float

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are compiled at "
                       "their first launch")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel source that has no up-to-date library, one
    `nvcc` process per source, all started together.  Returns the paths;
    the compiler's register/spill report goes to `_build/<name>.log`,
    closed by a line "built in <s> s" (the source's own wall time)."""
    _BUILD.mkdir(exist_ok=True)
    paths = {n: _lib_path(n) for n in _SOURCES}
    procs = {}
    t0 = time.perf_counter()
    for n, p in paths.items():
        if not p.exists():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(_CSRC / f"{n}.cu")]
            log = open(_BUILD / f"{n}.log", "w")
            procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    while procs:
        time.sleep(0.05)
        for n in [n for n, (proc, *_) in procs.items() if proc.poll() is not None]:
            proc, tmp, log = procs.pop(n)
            log.close()
            with open(log.name, "a") as f:
                f.write(f"built in {time.perf_counter() - t0:.1f} s\n")
            if proc.returncode != 0:
                failed.append(f"--- {n} (nvcc rc {proc.returncode}) ---\n"
                              f"{Path(log.name).read_text()}")
            else:
                os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            paths = build_all()
            for n, p in paths.items():
                _libs[n] = ctypes.CDLL(str(p))
        return _libs[name]


def query(lib: str, name: str, *args: int) -> int:
    """The value of C function `name` of library `lib` that launches nothing
    (a plan's workspace size): int arguments, a 64-bit int result."""
    fn = getattr(_library(lib), name)
    fn.argtypes = [I] * len(args)
    fn.restype = ctypes.c_longlong
    return int(fn(*args))


def dtype_code(dt: torch.dtype) -> int:
    """The dtype codes of csrc/common.cuh."""
    if dt == torch.float32:
        return 0
    if dt == torch.bfloat16:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dt}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t` (contiguous), copied if its data does not start on a 16-byte
    boundary, as the kernels' 16-byte `cp.async` loads need."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


class Kernel:
    """One C entry point of one kernel library (`lib`, by default the entry's
    own name: csrc/<lib>.cu), with its launch count.

    `launches` counts calls that launched the kernel; `variants` splits the
    count by the label a wrapper passes (e.g. "shift").  A call launches on
    `device`, the card its tensors are on: that card is made current for
    the call (so the entry point's own device queries and attribute
    settings see it) and the launch goes on that card's current stream,
    whichever card the calling thread had current."""

    def __init__(self, name: str, argtypes: list, lib: str | None = None):
        self.name = name
        self.lib = lib or name
        self.argtypes = argtypes
        self.launches = 0
        self.variants: dict[str, int] = {}
        self._fn = None

    def reset(self) -> None:
        self.launches = 0
        self.variants = {}

    def __call__(self, *args, device: torch.device, variant: str | None = None) -> None:
        if self._fn is None:
            fn = getattr(_library(self.lib), self.name)
            fn.argtypes = self.argtypes + [P]
            fn.restype = I
            self._fn = fn
        with torch.cuda.device(device):
            rc = self._fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch")
        self.launches += 1
        if variant is not None:
            self.variants[variant] = self.variants.get(variant, 0) + 1


_SAVED = object()  # a tensor argument's place in `Recompute`'s static list


class Recompute(torch.autograd.Function):
    """A kernel launch with the gradient of its plain version:
    `Recompute.apply(kernel, plain, *args)` returns `kernel(*args)`, and its
    backward recomputes `plain(*args)` under autograd and returns that
    graph's gradients, as the JAX package's custom VJPs call `jax.vjp` of
    their XLA compositions.  `args` mixes tensors and static values (ints,
    None); `plain` returns a tensor or a tuple of them, as `kernel` does.
    `Recompute.launch` goes through the Function only where autograd
    records the call, and launches the kernel directly elsewhere (the
    sampler, under `no_grad`), without the Function's host cost."""

    @classmethod
    def launch(cls, kernel, plain, *args):
        if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                           for a in args):
            return cls.apply(kernel, plain, *args)
        return kernel(*args)

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.static = [_SAVED if isinstance(a, torch.Tensor) else a for a in args]
        ctx.save_for_backward(*(a for a in args if isinstance(a, torch.Tensor)))
        return kernel(*args)

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        needs = ctx.needs_input_grad[2:]
        ins = [next(saved).detach().requires_grad_(need) if a is _SAVED else a
               for a, need in zip(ctx.static, needs)]
        wanted = [t for t in ins if isinstance(t, torch.Tensor) and t.requires_grad]
        got = iter(())
        if wanted:
            with torch.enable_grad():
                outs = ctx.plain(*ins)
            pairs = [(o, g) for o, g in zip(outs if isinstance(outs, tuple) else (outs,), grads)
                     if o.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                           allow_unused=True))
        return (None, None, *(next(got) if isinstance(t, torch.Tensor) and t.requires_grad
                              else None for t in ins))
