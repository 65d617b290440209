"""Atomic, async-capable checkpointing in ``repro``'s on-disk layout, the
port's counterpart of ``repro.ckpt.checkpoint``.

Layout (``repro``'s): ``<dir>/step_<N>/`` with one ``.npy`` per path of
``repro``'s stacked tree (``params/layers/attn/wq`` is the ``[L, ...]``
stack of every layer's ``wq``; the port's per-layer lists are stacked on
save and split on restore, ``models.convert``'s layouts) plus a
``manifest.json`` (each array's path, file, dtype and shape, the step and
``extra``, e.g. the data pipeline's position). Writes go to
``step_<N>.tmp`` and are renamed into place, so a crash mid-save never
corrupts the latest durable step. A checkpoint written by either package
restores in the other, AdamW's moments and step included. bfloat16 has no
numpy type without ``ml_dtypes``: it is written as its raw 16 bits
(``|V2``, what ``repro``'s ``np.save`` of an ``ml_dtypes`` array also
writes) under the manifest dtype ``bfloat16``, and read back through an
int16 view, exactly. ``save_async`` copies the state to the host on the
caller's thread (a consistent snapshot) and writes it on a background
thread; :meth:`CheckpointManager.wait` joins it and raises what it
raised.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import tree_leaves, tree_map, tree_paths


def _stacked_path(keys: Tuple) -> Tuple[str, Optional[int]]:
    """``repro``'s path of a leaf at ``keys`` of the port's tree, and its
    layer (the index in a ``"layers"`` list) or None."""
    layer = [k for k in keys if isinstance(k, int)]
    if len(layer) > 1:
        raise ValueError(f"nested lists at {keys}: not a tree of the port's "
                         f"layout")
    return ("/".join(str(k) for k in keys if not isinstance(k, int)),
            layer[0] if layer else None)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host tensor as the array ``np.save`` writes and its manifest
    dtype name."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _host(tree):
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, params, opt_state=None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "arrays": [], "extra": extra or {}}
        state = {"params": params}
        if opt_state is not None:
            state["opt"] = opt_state
        stacked: Dict[str, List] = {}
        for keys, leaf in zip(tree_paths(state), tree_leaves(state)):
            name, layer = _stacked_path(keys)
            stacked.setdefault(name, []).append((layer, leaf))
        for name, parts in stacked.items():
            # a layer's leaves come in layer order (tree_paths')
            t = (parts[0][1] if parts[0][0] is None else
                 torch.stack([leaf.detach().cpu() for _, leaf in parts]))
            arr, dtype = _to_numpy(t.detach().cpu())
            fn = name.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["arrays"].append({"path": name, "file": fn,
                                       "dtype": dtype,
                                       "shape": list(arr.shape)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final) if not os.path.exists(final) else shutil.rmtree(tmp)
        self._gc()
        return final

    def save_async(self, step: int, params, opt_state=None,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        # the host copy on the caller's thread (consistent snapshot), the
        # writes on another
        self.wait()
        snap_p = _host(params)
        snap_o = _host(opt_state) if opt_state is not None else None

        def write():
            try:
                self.save(step, snap_p, snap_o, extra)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("the asynchronous checkpoint write failed") \
                from err

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"))

    # -------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None):
        """template: a tree of the port's layout (e.g. ``{"params": ...,
        "opt": ...}`` from init); returns (state, step, extra), each tensor
        leaf on its template leaf's device in the file's dtype."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {a["path"]: a for a in manifest["arrays"]}
        loaded: Dict[str, torch.Tensor] = {}
        leaves = []
        for keys, leaf in zip(tree_paths(template), tree_leaves(template)):
            name, layer = _stacked_path(keys)
            if name not in loaded:
                rec = by_name[name]
                loaded[name] = _from_numpy(
                    np.load(os.path.join(d, rec["file"])), rec["dtype"])
            t = loaded[name] if layer is None else loaded[name][layer]
            if not isinstance(leaf, torch.Tensor):
                leaves.append(t.numpy())
                continue
            if t.shape != leaf.shape:
                raise ValueError(f"{'/'.join(map(str, keys))}: checkpoint "
                                 f"shape {tuple(t.shape)}, template "
                                 f"{tuple(leaf.shape)}")
            leaves.append(t.to(leaf.device, copy=True))
        it = iter(leaves)
        return tree_map(lambda _: next(it), template), step, \
            manifest.get("extra", {})
