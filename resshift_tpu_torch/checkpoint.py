"""Checkpoints: the train state and parameter files, with `torch.save`.

A train state (`TrainStep.state_dict()`: step, params, EMA, the AdamW
moments, each name -> tensor) goes to `<dir>/step_XXXXXXXX/state.pt`;
resuming replays the learning rate exactly, since the step is in the
state.  An FSDP state is gathered whole before it is saved
(`TrainStep.state_dict`; rank 0 writes), so a checkpoint is the same file
at any world size and resumes at world size 1 or N.  `AsyncSaver` copies
the state to the host at once (so that the loop may go on updating its
tensors) and writes the file on a background thread; the next save or
`wait` joins it and raises its error if it failed.  Files are written to
a temporary name and renamed, so a crash never leaves a half-written
checkpoint under the final name.

The JAX package's checkpoints are orbax directories; this port reads none
(no orbax here): `load_params` and `restore_train_state` say so.  Released
weights are `.pth` files (`convert.load_torch_state_dict`); a JAX train
state carries over in memory through `convert.train_state_from_flax`.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any

import torch

__all__ = ["save_params", "load_params", "save_train_state", "restore_train_state",
           "AsyncSaver", "STATE_FILE"]

STATE_FILE = "state.pt"


def _to_host(obj: Any) -> Any:
    """A copy of `obj` with every tensor copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(path: Path, obj: Any) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _orbax(path: Path) -> ValueError:
    return ValueError(f"{path} is a directory without {STATE_FILE}: an orbax checkpoint of the "
                      f"JAX package, which this port does not read (it has no orbax). Load the "
                      f"state in JAX and pass it through convert.train_state_from_flax, or "
                      f"export the weights as a .pth")


def save_params(path: str | Path, params: dict) -> None:
    """A name -> tensor dict to one file."""
    _write(Path(path), _to_host(params))


def load_params(path: str | Path) -> dict:
    path = Path(path)
    if path.is_dir():
        raise _orbax(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def _state_path(path: str | Path, step: int | None) -> Path:
    path = Path(path)
    return (path / f"step_{step:08d}" if step is not None else path) / STATE_FILE


def save_train_state(path: str | Path, state: dict, step: int | None = None) -> Path:
    """Write `state` to `path[/step_XXXXXXXX]/state.pt`; returns the file."""
    out = _state_path(path, step)
    _write(out, _to_host(state))
    return out


def restore_train_state(path: str | Path) -> dict:
    """A state written by `save_train_state`: its file or its directory."""
    path = Path(path)
    if path.is_dir():
        if not (path / STATE_FILE).is_file():
            raise _orbax(path)
        path = path / STATE_FILE
    return torch.load(path, map_location="cpu", weights_only=True)


class AsyncSaver:
    """Train-state saves written in the background, at most one in flight."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, path: str | Path, state: dict, step: int | None = None) -> Path:
        """Copy `state` to the host now, join the previous write, and write
        this one on a background thread; returns the file it goes to."""
        host = _to_host(state)
        self.wait()
        out = _state_path(path, step)

        def run():
            try:
                _write(out, host)
            except Exception as e:  # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, name="ckpt-writer")
        self._thread.start()
        return out

    def wait(self) -> None:
        """Join the write in flight; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err
