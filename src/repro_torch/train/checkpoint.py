"""Checkpoints of tensor trees: save/restore, a versioned store, an async
writer.

A torch/numpy copy of the JAX package's ``repro.train.checkpoint`` that
writes and reads the same directory format, so a checkpoint written by
either package loads in the other:

  * one ``leaf_{i:05d}.npy`` per leaf, in ``jax.tree_util``'s flatten
    order (dict keys sorted; lists, tuples and NamedTuples in order;
    ``None`` is no leaf), and a ``manifest.json`` index with the step,
    the leaf count and each leaf's dtype (the JAX package also writes
    its treedef there, which neither package reads);
  * bfloat16 leaves are stored as their uint16 bits with ``"bfloat16"``
    in the manifest (npy has no bfloat16) and come back through a torch
    ``view``, so no ``ml_dtypes`` is needed;
  * writes go to a staging dir, then an atomic rename (a torn checkpoint
    can never be loaded);
  * async: a background thread drains a queue of (step, host-copied
    trees), so the training loop blocks only for the device->host copy;
  * retention: keep the last ``keep`` steps;
  * restore rebuilds the caller's tree (a NamedTuple as itself, ``None``
    as ``None``) with its leaves as tensors on ``device``.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch


def _flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(like, values: list):
    """``like``'s structure with its leaves replaced by ``values`` in
    :func:`_flatten` order; dicts keep their own key order, a NamedTuple
    is rebuilt as its own type."""
    it = iter(values)

    def fill(t):
        if t is None:
            return None
        if isinstance(t, dict):
            got = {k: fill(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(fill(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(fill(v) for v in t)
        return next(it)

    out = fill(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def _to_host(leaf) -> np.ndarray:
    """One leaf as a numpy array of its own dtype (a bfloat16 tensor as
    its uint16 bits, reinterpreted: exact)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def save(path: str, step: int, tree, keep: int = 3) -> str:
    """Synchronous save. Returns the final step directory."""
    os.makedirs(path, exist_ok=True)
    stage = os.path.join(path, f".tmp-{step}")
    final = os.path.join(path, f"step_{step:08d}")
    if os.path.exists(stage):
        shutil.rmtree(stage)
    os.makedirs(stage)
    leaves = _flatten(tree)
    manifest = {"step": step, "n_leaves": len(leaves), "dtypes": []}
    for i, leaf in enumerate(leaves):
        manifest["dtypes"].append(_dtype_name(leaf))
        np.save(os.path.join(stage, f"leaf_{i:05d}.npy"), _to_host(leaf),
                allow_pickle=False)
    with open(os.path.join(stage, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(stage, final)
    _fsync_dir(path)
    _retain(path, keep)
    return final


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it survives power loss —
    best-effort (not every filesystem lets you open a directory)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _retain(path: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(path, d))


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_"))
    if not steps:
        return None
    return int(steps[-1].split("_")[1])


def _from_host(arr: np.ndarray, dtype: str | None) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(path: str, step: int, like_tree, device=None):
    """Load a checkpoint into the structure of ``like_tree``.  Every leaf
    comes back as a tensor of its saved dtype, on ``device`` when it is
    given, else on the device of the matching ``like_tree`` leaf (the
    CPU where that leaf is no tensor)."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    likes = _flatten(like_tree)
    if manifest["n_leaves"] != len(likes):
        raise ValueError(f"checkpoint {d} has {manifest['n_leaves']} "
                         f"leaves, the tree {len(likes)}")
    dtypes = manifest.get("dtypes", [None] * len(likes))
    out = []
    for i, like in enumerate(likes):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"),
                      allow_pickle=False)
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        out.append(_from_host(arr, dtypes[i]).to(dev))
    return _unflatten(like_tree, out)


class VersionStore:
    """Versioned model checkpoints with promote / rollback semantics.

    Built on :func:`save` / :func:`restore` (per-leaf ``.npy`` shards,
    staging dir + atomic rename), so a torn version can never load.  On
    top of the step directories it keeps a ``CURRENT`` json pointer —
    ``{"current": v, "history": [...]}`` written via tmp + rename — that
    records which version is *serving* and the promotion trail.  The
    pointer is fsynced before the rename (and the directory after), and
    a torn/garbage pointer recovers to the newest intact version — see
    :meth:`_read_ptr`.  A version number is the ``save()`` step; saving
    never changes what is served until :meth:`promote` flips the
    pointer, and :meth:`rollback` flips it back to the previous history
    entry.

    Retention keeps the last ``keep`` saved versions but never deletes
    a version still on the promotion history (rollback must always have
    somewhere to land).
    """

    _PTR = "CURRENT"

    def __init__(self, path: str, keep: int = 4):
        self.path = path
        self.keep = keep
        os.makedirs(path, exist_ok=True)

    # -- pointer ----------------------------------------------------
    def _read_ptr(self) -> dict:
        """Read the pointer; a torn or garbage ``CURRENT`` (power loss
        mid-write on a filesystem that reordered the rename past the
        data blocks) falls back to the newest *intact* saved version
        instead of raising — the service comes back serving something
        real rather than refusing to start."""
        p = os.path.join(self.path, self._PTR)
        if not os.path.exists(p):
            return {"current": None, "history": []}
        try:
            with open(p) as f:
                ptr = json.load(f)
            if (not isinstance(ptr, dict) or "current" not in ptr
                    or not isinstance(ptr.get("history"), list)):
                raise ValueError(f"malformed pointer {ptr!r}")
            return ptr
        except (ValueError, OSError):
            return self._recover_ptr()

    def _recover_ptr(self) -> dict:
        """Newest intact version wins; history is unrecoverable (the
        trail lived only in the pointer) so rollback starts empty.  The
        recovered pointer is NOT persisted here — reads stay read-only;
        the next promote rewrites ``CURRENT`` durably."""
        for v in sorted(self.versions(), reverse=True):
            if self._intact(v):
                return {"current": v, "history": []}
        return {"current": None, "history": []}

    def _intact(self, version: int) -> bool:
        """Cheap integrity probe: manifest parses, every leaf file is
        present with a readable ``.npy`` header."""
        d = os.path.join(self.path, f"step_{version:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            for i in range(int(manifest["n_leaves"])):
                np.load(os.path.join(d, f"leaf_{i:05d}.npy"),
                        mmap_mode="r", allow_pickle=False)
            return True
        except (OSError, ValueError, EOFError, KeyError, TypeError):
            return False

    def _write_ptr(self, ptr: dict) -> None:
        tmp = os.path.join(self.path, f".{self._PTR}.tmp")
        with open(tmp, "w") as f:
            json.dump(ptr, f)
            f.flush()
            os.fsync(f.fileno())     # data durable BEFORE the rename
        os.replace(tmp, os.path.join(self.path, self._PTR))
        _fsync_dir(self.path)        # ...and the rename itself durable

    def current(self) -> int | None:
        return self._read_ptr()["current"]

    def history(self) -> list[int]:
        return list(self._read_ptr()["history"])

    # -- versions ---------------------------------------------------
    def save_version(self, version: int, tree) -> str:
        """Persist a candidate. Does NOT change what is served."""
        out = save(self.path, version, tree, keep=10 ** 9)
        self._retain()
        return out

    def load_version(self, version: int, like_tree, device=None):
        return restore(self.path, version, like_tree, device=device)

    def promote(self, version: int) -> None:
        """Flip the serving pointer to ``version`` (must be saved)."""
        if not os.path.isdir(
                os.path.join(self.path, f"step_{version:08d}")):
            raise FileNotFoundError(f"version {version} not saved")
        ptr = self._read_ptr()
        if ptr["current"] is not None and ptr["current"] != version:
            ptr["history"].append(ptr["current"])
        ptr["current"] = version
        self._write_ptr(ptr)
        self._retain()

    def rollback(self) -> int | None:
        """Demote current to its predecessor; returns the new current
        version, or ``None`` if there is no history to land on."""
        ptr = self._read_ptr()
        if not ptr["history"]:
            return None
        ptr["current"] = ptr["history"].pop()
        self._write_ptr(ptr)
        return ptr["current"]

    def versions(self) -> list[int]:
        return sorted(int(d.split("_")[1])
                      for d in os.listdir(self.path)
                      if d.startswith("step_"))

    def _retain(self) -> None:
        ptr = self._read_ptr()
        pinned = set(ptr["history"])
        if ptr["current"] is not None:
            pinned.add(ptr["current"])
        vs = self.versions()
        for v in vs[:-self.keep] if len(vs) > self.keep else []:
            if v not in pinned:
                shutil.rmtree(
                    os.path.join(self.path, f"step_{v:08d}"))


def _host_copy(leaf):
    """A copy of one leaf on the host that later in-place updates of the
    leaf (the LM optimizer writes params and moments in place) cannot
    reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


class AsyncCheckpointer:
    """Background-thread writer; the step loop only pays device->host."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Exception | None = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, tree = item
                save(self.path, step, tree, keep=self.keep)
            except Exception as e:  # surfaced on next submit/flush/close
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, step: int, tree) -> None:
        if self._err:
            raise self._err
        host_tree = _unflatten(tree, [_host_copy(x) for x in _flatten(tree)])
        self._q.put((step, host_tree))

    def flush(self) -> None:
        """Block until every submitted checkpoint is durably on disk."""
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err
