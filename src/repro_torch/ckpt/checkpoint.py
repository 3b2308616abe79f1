"""Asynchronous, atomic checkpointing with retention and restart.

The port's copy of ``repro/ckpt/checkpoint.py`` over the port's train
state (tensors in nested dicts, lists and named tuples; ints).  Layout,
one directory per step:

    <root>/step_000100.tmp/          # staging (invisible to restore)
        <leaf-path>.npy              # one file per tensor, written first
        manifest.json                # paths, shapes, dtypes, ints; last
    <root>/step_000100/              # os.replace once complete

* **Atomic**: a checkpoint is visible once its rename happened; a crash
  mid-write leaves only ``.tmp`` garbage, skipped and removed on the
  next save.
* **Async**: ``save`` copies every tensor to host memory synchronously
  (a consistent view of the step) and writes on a background thread;
  ``wait`` joins it (and re-raises its error) before the next save.
* **Retention**: the newest ``keep`` checkpoints stay, older ones are
  deleted after a successful save, never before.
* bfloat16 tensors are stored as their uint16 bits (numpy has no
  bfloat16) with ``bfloat16`` in the manifest.

A checkpoint the JAX package wrote is not read here.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    if hasattr(tree, "_fields"):                      # a NamedTuple
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix[:-1], tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}{k}/")
    return out


def _restore(tree, loaded: dict, shardings=None, prefix: str = ""):
    """``tree`` with each tensor leaf given its saved value (in place, or
    as a new tensor on its sharding's device where ``shardings`` gives
    one) and each int leaf replaced."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_restore(v, loaded, _sub(shardings, k),
                                     f"{prefix}{k}/")
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: _restore(v, loaded, _sub(shardings, k), f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restore(v, loaded, _sub(shardings, i),
                                   f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    value = loaded[prefix[:-1]]
    if isinstance(tree, torch.Tensor):
        if shardings is not None:
            return value.to(shardings.device)
        with torch.no_grad():
            tree.copy_(value)
        return tree
    return type(tree)(value)


def _sub(shardings, key):
    """The sharding subtree of ``key`` (None: no shardings given)."""
    if shardings is None:
        return None
    if hasattr(shardings, "_fields") and isinstance(key, str):
        return getattr(shardings, key)
    return shardings[key]


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(root)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().copy(), "bfloat16"
    return t.numpy().copy(), str(t.dtype).removeprefix("torch.")


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class Checkpointer:
    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(root, exist_ok=True)

    # -- save ----------------------------------------------------------------
    def save(self, state, step: int) -> None:
        self.wait()
        host = [(k, _host(v) if isinstance(v, torch.Tensor) else v)
                for k, v in _flatten(state)]
        self._thread = threading.Thread(target=self._write,
                                        args=(host, step), daemon=True)
        self._thread.start()

    def _write(self, host: list, step: int) -> None:
        try:
            tmp = os.path.join(self.root, f"step_{step:06d}.tmp")
            final = os.path.join(self.root, f"step_{step:06d}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": []}
            for key, val in host:
                if isinstance(val, tuple):
                    arr, dtype = val
                    fname = key.replace("/", "__") + ".npy"
                    np.save(os.path.join(tmp, fname), arr)
                    manifest["leaves"].append(
                        {"key": key, "file": fname,
                         "shape": list(arr.shape), "dtype": dtype})
                else:
                    manifest["leaves"].append({"key": key, "value": val})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)                    # atomic publish
            self._gc()
        except BaseException as e:                    # surfaced on wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.root)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:06d}"),
                          ignore_errors=True)
        for d in os.listdir(self.root):               # crash leftovers
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, d),
                              ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def restore(self, like, step: int | None = None, shardings=None):
        """Restore into ``like`` (a state of the same structure): its
        tensors take the saved values in place (a model's parameters
        among them), its ints are replaced.  ``shardings``: a tree of
        ``dist.sharding.Sharding`` matching ``like``; each tensor is then
        restored as a new tensor on its sharding's device (elastic
        re-shard onto the mesh of ``dist.elastic.remesh``).  Returns
        (state, step)."""
        if step is None:
            step = latest_step(self.root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = os.path.join(self.root, f"step_{step:06d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        loaded = {}
        for m in manifest["leaves"]:
            if "file" in m:
                loaded[m["key"]] = _tensor(np.load(os.path.join(
                    d, m["file"])), m["dtype"])
            else:
                loaded[m["key"]] = m["value"]
        return _restore(like, loaded, shardings), step
