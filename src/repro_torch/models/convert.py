"""Carry ``repro``'s weights and caches across the framework boundary as
numpy arrays, for tests that run both packages on the same numbers.

:func:`params_from_numpy` takes ``repro``'s parameter tree with numpy
leaves (``jax.tree.map(np.asarray, params)``) and returns the port's: the
layer-stacked ``[L, ...]`` leaves of the decoder and of the encoder split
into one dictionary a layer, each leaf a tensor of its own type on
``device`` (the MoE router stays float32). numpy's bfloat16 (the
``ml_dtypes`` type jax arrays convert to, which ``torch.from_numpy``
refuses) goes through float32, which holds every bfloat16 value exactly.
:func:`cache_to_numpy` takes the port's cache back to per-layer numpy
arrays (bfloat16 widened to float32, exactly), an enc-dec layer's with
its ``cross_kv`` pair.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.kernels.registry import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Params, check_family


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _split(stacked, n: int, device) -> List[Dict[str, Any]]:
    """``[L, ...]``-stacked leaves as one dictionary of tensors a layer."""
    return [_tree(stacked, lambda a, i=i: _tensor(np.asarray(a)[i], device))
            for i in range(n)]


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device=None) -> Params:
    """The port's parameters from ``repro``'s tree of numpy arrays, on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    check_family(cfg)
    dev = resolve_device(device)
    out = {k: _tree(v, lambda a: _tensor(a, dev))
           for k, v in tree.items() if k not in ("layers", "encoder")}
    out["layers"] = _split(tree["layers"], cfg.n_layers, dev)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": _split(enc["layers"], cfg.encoder_layers, dev),
            "final_norm": _tensor(enc["final_norm"], dev),
        }
    return out


def cache_to_numpy(cache: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The port's cache as one dictionary of float32 (or wider) numpy
    arrays a layer (with ``"cross_kv"``, the layer's ``(k, v)``, for an
    enc-dec cache): copies, which later in-place writes to the cache leave
    as they are."""
    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    layers = [_tree(entry, arr) for entry in cache["layers"]]
    for entry, kv in zip(layers, cache.get("cross_kv") or ()):
        entry["cross_kv"] = tuple(arr(t) for t in kv)
    return layers
