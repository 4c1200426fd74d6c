"""Pipeline parallelism: the reverse chain staged over devices, one process.

The counterpart of the JAX package's `parallel/pp.py`.  The chain is T
applications of one weight-tied denoiser, so the pipeline axis is time:
stage s runs a contiguous slice of the steps (`stage_slices`), stage 0
also ingests (encodes) each chunk and the last stage emits (decodes) it.
JAX runs the stages as one SPMD program (`shard_map` over a `stage` mesh
axis, `ppermute` between stages); the port drives them from one process,
as its data-parallel samplers do: stage s keeps its own replica of the
models on its device, each tick launches every stage's work on the payload
it holds, the last stage first, then moves each payload on to the next
stage's device.  Launches are asynchronous and a move to a card does not
wait (`non_blocking`), so stages on different cards overlap as JAX's do;
a move to the host waits for its data.  Stage-to-stage traffic is one
payload a tick, so no collective is needed.  JAX re-ingests the last
chunk during the drain ticks and discards the result; the port skips it.

A stage may be a row of devices (its data replicas: PP x DP): the chunk's
parts flow down the columns, part d through device d of every stage.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .mesh import local_devices

__all__ = ["stage_slices", "stage_grid", "move", "pipeline_stream"]


def stage_slices(n_steps: int, n_stages: int) -> tuple[list[int], list[int]]:
    """The descending chain t = n_steps-1 .. 0 cut into contiguous slices:
    (starts, counts), stage s running steps starts[s], starts[s]-1, ...,
    starts[s]-counts[s]+1; the remainder goes to the earliest stages (the
    last stage also decodes, the heavier end)."""
    counts = [n_steps // n_stages + (1 if i < n_steps % n_stages else 0)
              for i in range(n_stages)]
    starts, done = [], 0
    for c in counts:
        starts.append(n_steps - 1 - done)
        done += c
    return starts, counts


def stage_grid(devices=None) -> list[list[torch.device]]:
    """`devices` (this process's cards by default) as rows of stages: a flat
    list is one device a stage; a list of lists gives each stage a row of
    data replicas, every row as long."""
    devices = local_devices() if devices is None else devices
    grid = [[torch.device(d) for d in (row if isinstance(row, (list, tuple)) else [row])]
            for row in devices]
    if not grid or len({len(row) for row in grid}) != 1 or not grid[0]:
        raise ValueError(f"stages must be devices or rows of equal length, got {devices}")
    return grid


def move(payload: Any, device: torch.device) -> Any:
    """Every tensor of `payload` (nested dicts, lists, tuples) on `device`;
    without waiting where that is a card."""
    if isinstance(payload, torch.Tensor):
        return payload.to(device, non_blocking=device.type == "cuda")
    if isinstance(payload, dict):
        return {k: move(v, device) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        return type(payload)(move(v, device) for v in payload)
    return payload


def pipeline_stream(devices, n_chunks: int,
                    ingest: Callable[[int, int, torch.device], Any],
                    work: Callable[[int, int, torch.device, Any], Any],
                    emit: Callable[[int, int, torch.device, Any], Any]) -> list[list]:
    """Stream `n_chunks` payloads through the stages of `devices` (see
    `stage_grid`) in n_chunks + S - 1 ticks.

    ingest(chunk, part, device) -> the payload of `part` of `chunk` on stage
        0's device of that column (None: an empty part, skipped);
    work(stage, part, device, payload) -> payload, the stage's slice;
    emit(chunk, part, device, payload) -> the output, on the last stage.

    Returns outputs[chunk][part] (None for an empty part)."""
    grid = stage_grid(devices)
    n_stages, n_parts = len(grid), len(grid[0])
    held: list[list] = [[None] * n_parts for _ in range(n_stages)]
    outs: list[list] = [[None] * n_parts for _ in range(n_chunks)]
    for tick in range(n_chunks + n_stages - 1):
        for s in reversed(range(n_stages)):
            chunk = tick - s  # the chunk stage s holds this tick
            if not 0 <= chunk < n_chunks:
                continue
            for d, dev in enumerate(grid[s]):
                p = ingest(chunk, d, dev) if s == 0 else held[s][d]
                if p is None:
                    continue
                p = work(s, d, dev, p)
                if s == n_stages - 1:
                    outs[chunk][d], p = emit(chunk, d, dev, p), None
                held[s][d] = p
        for s in reversed(range(n_stages - 1)):
            held[s + 1] = [None if p is None else move(p, dev)
                           for p, dev in zip(held[s], grid[s + 1])]
            held[s] = [None] * n_parts
    return outs
