"""Fault-tolerant checkpointing (counterpart of
`repro.checkpoint.manager`), on the reference's on-disk layout, so a
checkpoint either package writes restores in the other:

  <dir>/step_000000123/
    manifest.json   {treedef, leaves: [{file, shape, dtype, sha256}],
                     paths}
    <leaf-idx>.npy  one file per leaf

A tree is a nested dict whose leaves are numpy arrays, as
`repro_torch.bridge` gives a model's weights and its optimizer state
(copies, so a save thread never reads a tensor that training updates):
the training state `{"params": ..., "opt": {"m", "v", "step"}}` has the
reference's leaves and shapes, per-layer leaves stacked on L. Leaves
are written in jax's flatten order (sorted keys, depth first), `paths`
in jax's keystr form (`['params']['embed']`) and `treedef` as jax
prints a tree of dicts.

  * ATOMIC: written to `step_N.tmp/`, fsynced, then renamed;
  * VERIFIED: per-leaf SHA-256 in the manifest; restore checks them and
    falls back past a corrupt checkpoint to the previous valid one;
  * ASYNC: the save runs on a background thread over host arrays, and
    `wait()` joins it (and raises what it raised) before the next save
    or a restore;
  * KEEP-K: old steps are removed after a new save commits.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep: int = 3
    save_every: int = 100
    async_save: bool = True


def _flatten(tree, prefix=""):
    """(jax keystr path, leaf) pairs in jax's order: sorted dict keys."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], f"{prefix}[{key!r}]")
    else:
        yield prefix, tree


def _treedef(tree) -> str:
    """`str(jax.tree_util.tree_structure(tree))` of a tree of dicts."""
    def node(t):
        if not isinstance(t, dict):
            return "*"
        return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                               for k in sorted(t)) + "}"
    return f"PyTreeDef({node(tree)})"


def _unflatten(like, leaves):
    """`like`'s structure holding `leaves` (an iterator, jax's order)."""
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    return next(leaves)


def save_pytree(tree, path: str) -> None:
    """Atomic, hash-manifested save of one tree to `path` (a step dir)."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = list(_flatten(tree))
    manifest = {"treedef": _treedef(tree), "leaves": []}
    for i, (_, leaf) in enumerate(flat):
        arr = np.asarray(leaf)
        fname = f"{i:05d}.npy"
        fpath = os.path.join(tmp, fname)
        with open(fpath, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        with open(fpath, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest["leaves"].append(
            {"file": fname, "shape": list(arr.shape),
             "dtype": str(arr.dtype), "sha256": digest})
    manifest["paths"] = [p for p, _ in flat]
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)  # the atomic commit point


def load_pytree(path: str, like=None):
    """Load and verify. Without `like`: (leaves, manifest). With it: a
    tree of `like`'s structure whose numpy leaves take the dtypes of
    `like`'s (numpy) leaves; the count and the shapes of the leaves must
    match, as the reference checks."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for entry in manifest["leaves"]:
        fpath = os.path.join(path, entry["file"])
        with open(fpath, "rb") as f:
            raw = f.read()
        if hashlib.sha256(raw).hexdigest() != entry["sha256"]:
            raise IOError(f"checkpoint corruption: {fpath}")
        leaves.append(np.load(fpath))
    if like is None:
        return leaves, manifest
    like_leaves = [leaf for _, leaf in _flatten(like)]
    if len(like_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, expected "
            f"{len(like_leaves)}")
    out = []
    for arr, ref in zip(leaves, like_leaves):
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"leaf shape mismatch: {arr.shape} vs {tuple(ref.shape)}")
        out.append(arr.astype(ref.dtype, copy=False))
    return _unflatten(like, iter(out))


class CheckpointManager:
    """keep-k, async, auto-resuming checkpoint manager."""

    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- discovery ----------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.cfg.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def _path(self, step: int) -> str:
        return os.path.join(self.cfg.directory, f"step_{step:09d}")

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree) -> None:
        self.wait()
        host_tree = _unflatten(tree, (np.asarray(leaf)
                                      for _, leaf in _flatten(tree)))

        def _do():
            try:
                save_pytree(host_tree, self._path(step))
                self._gc()
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        if self.cfg.async_save:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.cfg.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def restore_latest(self, like):
        """Restore the newest valid checkpoint, falling back past corrupt
        ones. Returns (step, tree) or (None, None) when nothing valid
        exists."""
        self.wait()
        for step in reversed(self.steps()):
            try:
                return step, load_pytree(self._path(step), like=like)
            except (OSError, ValueError):
                continue
        return None, None
