"""Checkpointing: atomic, asynchronous, with retention.

Port of the reference's ``checkpoint/ckpt.py``, with its layout on disk::

    <dir>/step_00000100.tmp/   — written first
        manifest.json          — tree paths, shapes, dtypes, leaf files
        leaf_00000.npy …       — one file per leaf (the full array)
    <dir>/step_00000100/       — atomic rename on completion
    <dir>/LATEST               — pointer file, updated last

A leaf's path is the reference's ``keystr``: ``['key']`` for a dict key
and ``[i]`` for a list index, dict keys in sorted order (JAX's flattening
order), so the two packages read each other's checkpoints where their
trees match.  numpy has no bfloat16 (and the card's machine has no
``ml_dtypes``), so a bfloat16 leaf is stored as its 16-bit integer view,
made by torch, under the manifest dtype ``"bfloat16"`` (the reference's
codec, uint16 on disk).

``restore`` rebuilds a template's tree; the template's leaves may be on
the ``meta`` device, so that a restore at full width allocates no second
state, and the restored leaves go to ``device``.  ``AsyncCheckpointer``
snapshots to host memory synchronously and writes files on a worker
thread, so the train loop is not blocked on disk.  The reference's
placement under a sharding (elastic restore) waits for
``sharding/rules.py`` (ROADMAP, the tail).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

#: dtypes numpy cannot store, as (manifest name, torch dtype, the integer
#: view torch makes, the numpy view on disk)
_CODEC = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16)}
_DECODE = {name: (dt, view, disk) for dt, (name, view, disk)
           in _CODEC.items()}


def _flatten(tree, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs, dict keys sorted, in JAX's ``keystr`` form."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _rebuild(tree, leaves: dict, path: str = ""):
    """``tree`` with each leaf replaced by ``leaves[its path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return leaves[path]


def _encode(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype in _CODEC:
        name, view, disk = _CODEC[t.dtype]
        return t.view(view).numpy().view(disk), name
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _decode(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _DECODE:
        dt, view, _ = _DECODE[name]
        return torch.from_numpy(arr.view(np.int16)).view(dt)
    return torch.from_numpy(arr)


def _snapshot(tree):
    """Every tensor leaf copied to host memory (numpy leaves kept)."""
    def leaf(x):
        return x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    return leaf(tree)


def save(directory: str, step: int, tree: Any, keep: int = 3) -> str:
    """Synchronous atomic save of a tree of tensors (or numpy arrays);
    returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        if torch.is_tensor(leaf):
            stored, dtype_name = _encode(leaf)
        else:
            stored = np.asarray(leaf)
            dtype_name = stored.dtype.name
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), stored)
        manifest["leaves"].append({"path": path, "file": fname,
                                   "shape": list(stored.shape),
                                   "dtype": dtype_name})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    _retain(directory, keep)
    return final


def _retain(directory: str, keep: int):
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.removeprefix("step_"))


def restore(directory: str, template: Any, step: Optional[int] = None,
            device=None) -> tuple[Any, int]:
    """Rebuild ``template``'s tree (tensors, possibly on ``meta``) from the
    checkpoint at ``step`` (default the latest); each leaf goes to
    ``device``, else to its template leaf's device (``meta`` then
    raises)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    leaves = {}
    for kpath, tmpl in _flatten(template):
        entry = by_path[kpath]
        t = _decode(np.load(os.path.join(path, entry["file"])),
                    entry["dtype"])
        want = tuple(tmpl.shape)
        if tuple(t.shape) != want:
            raise ValueError(f"shape mismatch at {entry['path']}: "
                             f"{tuple(t.shape)} vs {want}")
        dev = torch.device(device) if device is not None else tmpl.device
        if dev.type == "meta":
            raise ValueError(f"{kpath}: a template on the meta device needs "
                             "a device to restore to")
        leaves[kpath] = t.to(dev)
    return _rebuild(template, leaves), step


class AsyncCheckpointer:
    """Snapshot synchronously, write on a worker thread (latency hiding)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def save(self, step: int, tree: Any):
        self.wait()
        snapshot = _snapshot(tree)

        def work():
            try:
                save(self.directory, step, snapshot, keep=self.keep)
            except BaseException as e:      # surfaced on next wait()
                self.error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err
