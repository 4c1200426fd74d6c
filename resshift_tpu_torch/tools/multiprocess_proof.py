"""Multi-process training proof: N real processes train through `Trainer`.

The counterpart of the JAX package's `tools/multiprocess_proof.py`.  The
launcher starts N workers with torchrun's environment and a rendezvous on
localhost (gloo on the CPU, or NCCL with one card a process), each worker
brings the process group up through `parallel.mesh.maybe_init_distributed`
and trains the same config for `--iters` iterations (the schedule stays the
config's) into one save directory a mode, for each of `--modes`: `dp`
(data-parallel) and `fsdp` (the state sharded), one after the other in the
same processes.  The launcher then reports, for each mode (one JSON line,
the last of its output):

  * `params_identical`, `ema_identical`, `opt_identical`: each rank's train
    state (gathered whole under FSDP) hashes the same (not hashed at world
    size 1);
  * `loader_sharded`: the ranks' loader items are disjoint and cover the
    epoch's batches;
  * `rank0_log_only`: the JSON log has one line an iteration (a second
    writer would double it);
  * `checkpoint_written`: the last iteration's checkpoint is on disk;
  * `validated`: rank 0 logged validation metrics (the EMA gathered first
    under FSDP), where the config validates; `val_sharded`: the last
    validation's items were split over the ranks, disjoint and covering the
    set;
  * under FSDP, `shard_share`: the largest share of a large parameter that
    one rank holds;
  * each rank's step milliseconds, and its peak memory on a card.

With `--step1` rank 0 also saves the gathered state after the first
iteration (`<mode>/step1.pt`), which the tests hold across the modes.

`--step FILE` runs one `TrainStep` instead, on a spec that `torch.save`
wrote: {'config', 'train' (the `train:` block), 'unet' (and 'vqgan') state
dicts, 'batch' (the global batch), 'draws' (each global microbatch's (t,
noise))}.  Each rank takes its rows of the batch and of the draws, cut into
its own microbatches, and rank 0 saves the gathered state and the metrics
(`<mode>/step.pt`); the report adds whether every rank's state hashes the
same.

`--tp FILE` samples through `ResShiftPipeline.sample_tp` instead, on a
spec that `torch.save` wrote: {'config' (a dict or a task name), 'dtype'
('float32' or 'bfloat16'), 'unet' (and 'vqgan') state dicts, 'cases': a
list of {'name', 'lq', 'mask' (optional), 'draws' (optional: else a
generator on the rank's device seeded 'seed'), 'kw' (sample_tp's keyword
arguments, `data` among them), 'reps'}}.  Every rank builds its split
clone of the models for a case's group before the clock starts, then samples
the case 'reps' times and
saves its image (`tp/<name>_rank<r>.pt`); the report gives, for each case,
whether every rank's image hashes the same, each rank's milliseconds a call
and the collectives of one call; and whether the two forms of the
all-gather (`tp.all_gather` and the zero-filled all-reduce that it takes
for CUDA tensors on gloo, here on CPU tensors under gloo) gave every rank
the same tensor.  `--backend gloo` lets ranks share a card (`--device
cuda:0`), which NCCL refuses.

Every child is killed in a `finally`, whatever ends the launcher, and dies
with the launcher where that is killed (Linux's parent-death signal); each
has `--timeout` seconds, its rendezvous three quarters of them.

    python -m resshift_tpu_torch.tools.multiprocess_proof --out DIR [--nproc 2]
        [--iters 3] [--modes dp,fsdp] [--step1] [--device cpu|cuda] [--config FILE.json]
        [--timeout 120]
    python -m resshift_tpu_torch.tools.multiprocess_proof --out DIR --step SPEC.pt [--modes dp]
    python -m resshift_tpu_torch.tools.multiprocess_proof --out DIR --tp SPEC.pt [--nproc 2]
        [--device cpu|cuda|cuda:N] [--backend gloo|nccl]

Without `--config` the workers train a small realsr-shaped model (UNet 32
channels, f4 VQGAN) on seeded random 16 -> 64 pairs that the launcher writes
under DIR; `--config` names a JSON task config with its own data.  With
`--device cuda` each worker computes on `cuda:LOCAL_RANK`, with `cuda:N`
every worker on card N.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["small_config", "launch", "launch_step", "launch_tp", "main"]

DIGESTS = ("params", "ema", "exp_avg", "exp_avg_sq")
MODES = ("dp", "fsdp")


def small_config(data: Path, iters: int, batch: int) -> dict:
    """A realsr-shaped task at small width (window 4, LQ 16, f4 VQGAN) on
    the pairs under `data`, trained `iters` iterations at `batch` images a
    rank in microbatches of one, logged every iteration, validated on two
    pairs and checkpointed at the end."""
    return dict(
        task="mp_proof", sf=4,
        model=dict(image_size=16, in_channels=3, model_channels=32, out_channels=3,
                   attention_resolutions=[16, 8], dropout=0.0, channel_mult=[1, 2],
                   num_res_blocks=[1, 1], conv_resample=True, num_head_channels=16,
                   use_scale_shift_norm=True, resblock_updown=False, swin_depth=2,
                   swin_embed_dim=32, window_size=4, mlp_ratio=2, cond_lq=True,
                   cond_mask=False, lq_size=16),
        diffusion=dict(schedule_name="exponential", steps=3, min_noise_level=0.2,
                       etas_end=0.99, kappa=2.0, power=0.3, predict_type="xstart",
                       timestep_respacing=None, normalize_input=True, latent_flag=True,
                       scale_factor=1.0, sf=4),
        autoencoder=dict(embed_dim=3, n_embed=64, ddconfig=dict(
            double_z=False, z_channels=3, resolution=64, in_channels=3, out_ch=3, ch=32,
            ch_mult=[1, 2, 4], num_res_blocks=1, attn_resolutions=[], dropout=0.0)),
        inference=dict(chop_size=16, chop_stride=12, padding_offset=16),
        data={k: dict(type="base", params=dict(dir_path=str(data / "lq"),
                                                extra_dir_path=str(data / "gt")))
              for k in ("train", "val")},
        train=dict(lr=1e-3, lr_min=2e-4, lr_schedule="cosin", warmup_iterations=2,
                   iterations=iters, batch=batch, microbatch=1, ema_rate=0.9,
                   weight_decay=0.01, save_freq=iters, log_freq=[1, 10 ** 9],
                   val_freq=iters, val_max_images=2))


def write_pairs(data: Path, n: int = 16) -> None:
    """n seeded random LQ 16x16 / GT 64x64 PNG pairs."""
    import numpy as np

    from ..utils.image_io import imwrite

    rng = np.random.default_rng(0)
    for sub in ("lq", "gt"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        imwrite(rng.uniform(0, 1, (16, 16, 3)), data / "lq" / f"{i:03d}.png")
        imwrite(rng.uniform(0, 1, (64, 64, 3)), data / "gt" / f"{i:03d}.png")


# ------------------------------------------------------------------ worker

def _digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _digests(state: dict, world: int) -> dict:
    """The state's hashes, where another rank's could differ."""
    return {f"{k}_digest": _digest(state[k]) if world > 1 else None for k in DIGESTS}


def _init_group(args) -> None:
    """The worker's threads and process group, its rendezvous bounded by
    three quarters of the launcher's wait."""
    import torch

    from ..parallel.mesh import maybe_init_distributed

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", 1)))
    maybe_init_distributed(force=True, device=args.device, timeout_s=0.75 * args.timeout,
                           backend=args.backend)


def worker(args) -> None:
    """Train the config once a mode, one mode after the other."""
    import torch

    from ..parallel.mesh import process_device

    _init_group(args)
    device = process_device(args.device)
    for mode in args.modes.split(","):
        _train(args, mode, device)
        gc.collect()  # the mode's trainer, before the next one's peak memory is read
        if device.type == "cuda":
            torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()


def _train(args, mode: str, device) -> None:
    import torch

    from ..checkpoint import save_params
    from ..parallel.mesh import rank, world_size
    from ..train_loop import Trainer

    r, world = rank(), world_size()
    out = Path(args.out) / mode
    cfg = json.loads(Path(args.config).read_text())
    cfg["train"]["fsdp"] = mode == "fsdp"
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    tr = Trainer(cfg, save_dir=str(out / "run"), seed=0, dtype=torch.float32 if
                 args.device == "cpu" else torch.bfloat16, device=device)
    items = [int(i) for i in tr.loader._epoch_indices()[:len(tr.loader) * tr.batch]]
    train_step = tr.train_step

    def first_saved(batch, generator):  # the state after iteration 1, gathered by every rank
        metrics = train_step(batch, generator)
        if tr.step_fn.step == 1:
            state = tr.step_fn.state_dict()
            if r == 0:
                save_params(out / "step1.pt", state)
        return metrics

    if args.step1:
        tr.train_step = first_saved
    step = tr.train(stop_iter=args.iters)
    wall = time.perf_counter() - t0
    state = step.state_dict()
    shares = {}
    if step.fsdp:  # this rank's share of each parameter of 2^12 elements or more
        shares = {n: p.to_local().numel() / p.numel() for n, p in step.named
                  if p.numel() >= 2 ** 12}
    result = {
        "rank": r, "world": world, "device": str(device), "fsdp": step.fsdp,
        "step": state["step"], "items": items, "val_items": tr.val_items,
        **_digests(state, world),
        "shard_share_max": max(shares.values()) if shares else None,
        "step_ms": [t["step_ms"] for t in tr.timings], "wall_s": wall,
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                     if device.type == "cuda" else None),
    }
    (out / f"digest_rank{r}.json").write_text(json.dumps(result))


def step_worker(args) -> None:
    """One `TrainStep` on this rank's part of the spec's global batch."""
    import torch

    from ..checkpoint import save_params
    from ..parallel.mesh import process_device, rank, world_size
    from ..pipeline import ResShiftPipeline
    from ..trainer import TrainConfig, TrainStep

    _init_group(args)
    r, world = rank(), world_size()
    spec = torch.load(args.step, weights_only=True)
    device = process_device(args.device)
    for mode in args.modes.split(","):
        out = Path(args.out) / mode
        pipe = ResShiftPipeline(spec["config"], dtype=torch.float32, device=device)
        pipe.load_state_dicts(unet=spec["unet"], vqgan=spec.get("vqgan"))
        cfg = TrainConfig.from_config({"train": dict(spec["train"], fsdp=mode == "fsdp")})
        step = TrainStep(pipe, cfg)
        b = next(iter(spec["batch"].values())).shape[0] // world
        rows = slice(r * b, (r + 1) * b)
        batch = {k: v[rows].to(device) for k, v in spec["batch"].items()}
        t, noise = (torch.cat([d[i] for d in spec["draws"]])[rows] for i in (0, 1))
        mb = cfg.microbatch or b
        draws = [(t[i:i + mb], noise[i:i + mb]) for i in range(0, b, mb)]
        metrics = step(batch, draws=draws)
        state = step.state_dict()
        if r == 0:
            save_params(out / "step.pt",
                        {"state": state, "metrics": {k: float(v) for k, v in metrics.items()}})
        (out / f"digest_rank{r}.json").write_text(json.dumps(
            {"rank": r, "world": world, "fsdp": step.fsdp, **_digests(state, world)}))
    torch.distributed.destroy_process_group()


def tp_worker(args) -> None:
    """Every case of the spec through `sample_tp` on this rank."""
    import torch

    from ..parallel import tp
    from ..parallel.mesh import process_device, rank, world_size
    from ..pipeline import ResShiftPipeline

    _init_group(args)
    r, world = rank(), world_size()
    device = process_device(args.device)
    spec = torch.load(args.tp, weights_only=True, mmap=True)
    pipe = ResShiftPipeline(spec["config"], dtype=getattr(torch, spec.get("dtype", "float32")),
                            device=device)
    pipe.load_state_dicts(unet=spec["unet"], vqgan=spec.get("vqgan"))
    spec.pop("unet"), spec.pop("vqgan", None)
    x = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(r))
    if torch.distributed.get_backend() == "nccl":  # NCCL takes no CPU tensor
        x = x.to(device)
    forms = [tp.all_gather(x, 1), tp._gather_by_all_reduce(x).movedim(0, 1).flatten(1, 2)]
    out, report = Path(args.out) / "tp", {"rank": r, "world": world, "cases": {},
                                          "gather_forms_equal": torch.equal(*forms)}
    for case in spec["cases"]:
        draws, times = case.get("draws"), []
        pipe._tp_models(tp.tp_groups(case.get("kw", {}).get("data", 1))[0])
        for _ in range(case.get("reps", 1)):
            gen = (None if draws is not None else
                   torch.Generator(device=device).manual_seed(case.get("seed", 0)))
            before = dict(tp.COLLECTIVES)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            img = pipe.sample_tp(case["lq"], gen, case.get("mask"), draws=draws,
                                 **case.get("kw", {}))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        img = img.cpu()
        torch.save(img, out / f"{case['name']}_rank{r}.pt")
        report["cases"][case["name"]] = {
            "ms": times, "digest": _digest({"img": img}),
            "collectives": {k: v - before[k] for k, v in tp.COLLECTIVES.items()}}
    (out / f"digest_rank{r}.json").write_text(json.dumps(report))
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------- launcher

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """The first thing a worker does: the kernel is to kill it when the
    launcher (the thread of it that started the worker) dies
    (PR_SET_PDEATHSIG, through libc where there is one), and it exits at
    once where the launcher is already gone.  Without prctl the launcher's
    `finally` is all there is."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL, 0, 0, 0)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != int(os.environ["LAUNCHER_PID"]):
        os._exit(1)


def _spawn(out: Path, nproc: int, worker_args: list[str], modes: tuple, device: str,
           timeout: float, threads: int) -> tuple[list, float]:
    """Start the workers with torchrun's environment and wait for them;
    returns their exit codes (None: cut at `timeout`) and the wall time.
    Every worker still alive when this returns or raises is killed, and
    each dies with this process where that is killed."""
    for mode in modes:  # the log and checkpoints of a run before
        shutil.rmtree(out / mode, ignore_errors=True)
        (out / mode).mkdir(parents=True)
    port = free_port()
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(nproc):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(nproc),
                       LOCAL_WORLD_SIZE=str(nproc), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS=str(threads),
                       LAUNCHER_PID=str(os.getpid()))
            cmd = [sys.executable, "-m", "resshift_tpu_torch.tools.multiprocess_proof",
                   "--worker", "--out", str(out), "--device", device, "--modes", ",".join(modes),
                   "--timeout", str(timeout), *worker_args]
            log = open(out / f"worker_{r}.log", "w")
            procs.append((subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                                           cwd=Path(__file__).resolve().parents[2]), log))
        deadline = time.monotonic() + timeout
        codes = []
        for p, _ in procs:
            try:
                codes.append(p.wait(timeout=max(0.1, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return codes, time.perf_counter() - t0


def _ranks(out: Path, mode: str, nproc: int) -> list[dict]:
    return [json.loads((out / mode / f"digest_rank{r}.json").read_text()) for r in range(nproc)]


def _identical(ranks: list[dict]) -> dict:
    return {f"{name}_identical": len({tuple(d[f"{k}_digest"] for k in keys) for d in ranks}) == 1
            for name, keys in (("params", ("params",)), ("ema", ("ema",)),
                               ("opt", ("exp_avg", "exp_avg_sq")))}


def launch_step(out: str | Path, spec: str | Path, nproc: int = 2, modes: tuple = ("dp",),
                device: str = "cpu", timeout: float = 120.0, threads: int = 1) -> dict:
    """One `TrainStep` on `spec` over `nproc` ranks in each mode (see the
    module's docstring); returns the report, `ok` where every rank exited 0
    with the same state."""
    out = Path(out)
    codes, wall = _spawn(out, nproc, ["--step", str(spec)], modes, device, timeout, threads)
    report: dict = {"nproc": nproc, "device": device, "wall_s": wall, "exit_codes": codes}
    ok = all(c == 0 for c in codes)
    for mode in modes if ok else ():
        report[mode] = _identical(_ranks(out, mode, nproc))
        ok = ok and all(report[mode].values())
    report["ok"] = ok
    return report


def launch_tp(out: str | Path, spec: str | Path, nproc: int = 2, device: str = "cpu",
              backend: str | None = None, timeout: float = 120.0, threads: int = 1) -> dict:
    """`sample_tp` on `spec` over `nproc` ranks (see the module's
    docstring); returns the report, `ok` where every rank exited 0 with the
    same image in every case."""
    out = Path(out)
    codes, wall = _spawn(out, nproc, ["--tp", str(spec)] + ["--backend", backend] * bool(backend),
                         ("tp",), device, timeout, threads)
    report: dict = {"nproc": nproc, "device": device, "wall_s": wall, "exit_codes": codes}
    ok = all(c == 0 for c in codes)
    if ok:
        ranks = _ranks(out, "tp", nproc)
        report["cases"] = {name: {
            "ranks_equal": len({d["cases"][name]["digest"] for d in ranks}) == 1,
            "ms": [d["cases"][name]["ms"] for d in ranks],
            "collectives": ranks[0]["cases"][name]["collectives"]} for name in ranks[0]["cases"]}
        report["gather_forms_equal"] = all(d["gather_forms_equal"] for d in ranks)
        ok = report["gather_forms_equal"] and all(c["ranks_equal"]
                                                  for c in report["cases"].values())
    report["ok"] = ok
    return report


def launch(out: str | Path, nproc: int = 2, iters: int = 3, modes: tuple = ("dp",),
           device: str = "cpu", config: str | None = None, batch: int = 2,
           timeout: float = 120.0, threads: int = 1, step1: bool = False) -> dict:
    """Train on `nproc` ranks in each mode (see the module's docstring);
    returns the report (also written to out/report.json): a section for
    each mode, and `ok` where every mode passed every check."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    if config is None:
        write_pairs(out / "data")
        config = out / "config.json"
        config.write_text(json.dumps(small_config(out / "data", iters, batch)))
    codes, wall = _spawn(out, nproc, ["--config", str(config), "--iters", str(iters)]
                         + ["--step1"] * step1, modes, device, timeout, threads)
    report: dict = {"nproc": nproc, "device": device, "wall_s": wall, "exit_codes": codes}
    ok = all(c == 0 for c in codes)
    for mode in modes if ok else ():
        ranks, run = _ranks(out, mode, nproc), out / mode / "run"
        iters_run = ranks[0]["step"]
        seen = [set(d["items"]) for d in ranks]
        log = run / "train_log.jsonl"
        lines = log.read_text().splitlines() if log.exists() else []
        rep = report[mode] = _identical(ranks)
        rep.update(
            loader_sharded=all(seen) and sum(map(len, seen)) == len(set().union(*seen)),
            rank0_log_only=len([ln for ln in lines if '"loss"' in ln]) == iters_run,
            checkpoint_written=(run / "ckpts" / f"step_{iters_run:08d}" / "state.pt").exists())
        ok = ok and all(rep.values())
        val = [set(d["val_items"]) for d in ranks]
        everyone = set().union(*val)
        rep.update(validated=sum('"val_psnr_y"' in ln for ln in lines),
                   val_sharded=(all(val) and sum(map(len, val)) == len(everyone)
                                and everyone == set(range(len(everyone)))), step=iters_run,
                   fsdp=ranks[0]["fsdp"], shard_share=ranks[0]["shard_share_max"],
                   step_ms=[d["step_ms"] for d in ranks], wall_s=[d["wall_s"] for d in ranks],
                   peak_gib=[d["peak_gib"] for d in ranks])
    report["ok"] = ok
    (out / "report.json").write_text(json.dumps(report, indent=2))
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="resshift_tpu_torch.tools.multiprocess_proof")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", required=True, help="the run's directory")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2, help="images a rank (built-in config)")
    ap.add_argument("--modes", default="dp",
                    help="comma list of dp (data-parallel) and fsdp (the state sharded)")
    ap.add_argument("--device", default="cpu",
                    help="cpu, cuda (each worker on cuda:LOCAL_RANK) or cuda:N (all on card N)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="the process group's backend (default: NCCL on a card, else gloo)")
    ap.add_argument("--config", default=None, help="a JSON task config with its data")
    ap.add_argument("--timeout", type=float, default=120.0, help="seconds for the workers")
    ap.add_argument("--threads", type=int, default=1, help="CPU threads a worker")
    ap.add_argument("--step", default=None, help="one train step on this spec (torch.save)")
    ap.add_argument("--step1", action="store_true",
                    help="also save the state after iteration 1 (step1.pt)")
    ap.add_argument("--tp", default=None, help="sample_tp on this spec (torch.save)")
    args = ap.parse_args(argv)
    if args.worker:
        _die_with_parent()
        (tp_worker if args.tp else step_worker if args.step else worker)(args)
        return
    modes = tuple(args.modes.split(","))
    if any(m not in MODES for m in modes):
        raise SystemExit(f"--modes takes {MODES}, got {args.modes}")
    if args.tp:
        report = launch_tp(args.out, args.tp, args.nproc, args.device, args.backend,
                           args.timeout, args.threads)
    elif args.step:
        report = launch_step(args.out, args.step, args.nproc, modes, args.device, args.timeout,
                             args.threads)
    else:
        report = launch(args.out, args.nproc, args.iters, modes, args.device, args.config,
                        args.batch, args.timeout, args.threads, args.step1)
    if not report["ok"]:
        for r in range(args.nproc):
            log = Path(args.out) / f"worker_{r}.log"
            if log.exists():
                print(f"----- worker {r} -----\n" + "\n".join(
                    log.read_text().splitlines()[-20:]), file=sys.stderr)
    print(json.dumps(report))
    sys.exit(0 if report["ok"] else 1)


if __name__ == "__main__":
    main()
