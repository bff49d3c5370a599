"""Checkpoints with atomic manifest commit, in the JAX package's layout.

Layout per step:

    <dir>/step_000123/
        manifest.json      # leaf paths, shapes, dtypes, leaf -> file map
        leaf_00000.npy ... # one .npy per leaf, in flatten order
    <dir>/LATEST           # atomic pointer file, written LAST

Crash-safety contract: a checkpoint is visible only after its manifest AND
the LATEST pointer are fully written (``os.replace`` is atomic on POSIX).
A half-written ``step_*.tmp`` directory is ignored by loaders and reaped by
`CheckpointManager.gc`.

The layout and the leaf paths are those the JAX package writes (leaf paths
such as ``.w/[0]``: ``.field`` for a dataclass field, ``[i]`` for a tuple or
list entry, ``['key']`` for a dict entry, dict keys in sorted order), so a
checkpoint written by either package loads in the other.  The flatten here
is the port's own, over dataclasses, tuples, lists and dicts whose leaves
are tensors or arrays; None is an empty subtree.  Leaves come off the card
with ``.cpu().numpy()`` and restore onto the device the caller names.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def flatten(tree, prefix: str = "") -> tuple[list, list]:
    """``(paths, leaves)`` of `tree` in flatten order."""
    if tree is None:
        return [], []
    if _is_dataclass(tree):
        items = [(f".{f.name}", getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", x) for i, x in enumerate(tree)]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    else:
        return [prefix], [tree]
    paths, leaves = [], []
    for key, sub in items:
        p, l = flatten(sub, f"{prefix}/{key}" if prefix else key)
        paths += p
        leaves += l
    return paths, leaves


def unflatten(like, leaves):
    """A tree of `like`'s structure with `leaves` in flatten order."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if _is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: build(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        if isinstance(x, (tuple, list)):
            return type(x)(build(e) for e in x)
        if isinstance(x, dict):
            return {k: build(x[k]) for k in sorted(x)}
        return next(it)

    return build(like)


def structure(tree):
    """The tree's skeleton (node types, field names, dict keys, leaf
    positions): two trees with equal structures flatten alike."""
    if tree is None:
        return None
    if _is_dataclass(tree):
        return (type(tree).__qualname__,
                tuple((f.name, structure(getattr(tree, f.name)))
                      for f in dataclasses.fields(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(structure(x) for x in tree))
    if isinstance(tree, dict):
        return ("dict", tuple((k, structure(tree[k])) for k in sorted(tree)))
    return "*"


def tree_map(fn, tree):
    """`fn` applied to every leaf of `tree`."""
    return unflatten(tree, [fn(l) for l in flatten(tree)[1]])


def to_host(leaf) -> np.ndarray:
    """One leaf as a host numpy array (a copy for a tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Write one checkpoint synchronously.  Returns the step dir path."""
    step_dir = os.path.join(directory, f"step_{step:09d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)

    paths, leaves = flatten(tree)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        arr = to_host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp_dir, fname), arr)
        manifest["leaves"].append({
            "path": path, "file": fname,
            "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)                      # atomic visibility
    _write_latest(directory, step)
    return step_dir


def _write_latest(directory: str, step: int) -> None:
    tmp = os.path.join(directory, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(directory, "LATEST"))


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def load_checkpoint(directory: str, tree_like: Any,
                    step: Optional[int] = None, device=None):
    """Restore into the structure of `tree_like`, leaves as tensors on
    ``device`` (the CPU when None).  Each stored leaf must have its
    counterpart's shape.  Returns ``(tree, step, extra)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    step_dir = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)

    paths, leaves = flatten(tree_like)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for path, like in zip(paths, leaves):
        entry = by_path.get(path)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        arr = np.load(os.path.join(step_dir, entry["file"]))
        want_shape = tuple(getattr(like, "shape", arr.shape))
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"shape mismatch for {path}: ckpt {arr.shape} vs {want_shape}")
        out.append(torch.from_numpy(arr).to(device))
    return unflatten(tree_like, out), step, manifest["extra"]


class CheckpointManager:
    """Keep-K rotating checkpoints with async save.

    ``save(blocking=False)`` snapshots the tensors to host memory at once
    and writes the files on a background thread; `wait` joins it.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = True) -> None:
        self.wait()
        # snapshot NOW (host copy) so the caller may mutate its tensors
        host_tree = tree_map(to_host, tree)
        if blocking:
            save_checkpoint(self.directory, step, host_tree, extra)
            self.gc()
            return

        def _bg():
            save_checkpoint(self.directory, step, host_tree, extra)
            self.gc()

        self._thread = threading.Thread(target=_bg, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device=None):
        self.wait()
        return load_checkpoint(self.directory, tree_like, step, device)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def gc(self) -> None:
        """Remove all but the newest `keep` complete checkpoints + orphans."""
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else steps:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
