"""Carry ``repro``'s weights and caches across the framework boundary as
numpy arrays, for tests that run both packages on the same numbers, and
move the port's trees between its per-layer layout and ``repro``'s
stacked one.

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

The port keeps ``"layers"`` (the decoder's and the encoder's) as a list
of per-layer dictionaries where ``repro`` stacks each leaf on a leading
``[L]`` axis. :func:`stack_layers` turns any tree of the port's layout
(parameters, gradients, AdamW moments, the compression residual) into
``repro``'s, each list of per-layer dictionaries one dictionary of
stacked tensors; :func:`unstack_layers` is its inverse; and
:func:`params_to_numpy` (the inverse of :func:`params_from_numpy`) gives
the stacked tree as numpy arrays, bfloat16 widened to float32 exactly.
:func:`tree_map`, :func:`tree_leaves` and :func:`tree_paths` walk nested
dictionaries, lists and tuples of tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

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


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the leaves at the same
    places of each of ``rest``); dictionaries, lists and tuples are
    walked, None is kept as a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_paths(tree, prefix: Tuple = ()) -> Iterator[Tuple]:
    """The key path of each leaf of ``tree``, in :func:`tree_map`'s order
    (a list index is an int)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    else:
        yield prefix


def _transpose_layers(layers: List[Dict[str, Any]]):
    """A list of per-layer dictionaries as one dictionary of per-layer
    lists (leaves)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _transpose_layers([lp[k] for lp in layers]) for k in first}
    return layers


def stack_layers(tree):
    """``tree`` in ``repro``'s layout: every ``"layers"`` list of
    per-layer dictionaries stacked into one dictionary of ``[L, ...]``
    tensors (copies); other leaves as they are."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "layers" and isinstance(v, list):
            out[k] = _tree(_transpose_layers(v), torch.stack)
        else:
            out[k] = stack_layers(v)
    return out


def _split_stacked(stacked) -> List[Dict[str, Any]]:
    leaves = tree_leaves(stacked)
    n = leaves[0].shape[0]
    return [_tree(stacked, lambda t, i=i: t[i]) for i in range(n)]


def unstack_layers(tree):
    """The inverse of :func:`stack_layers`: every ``"layers"`` dictionary
    of ``[L, ...]`` tensors split into a list of per-layer dictionaries
    (views of the stacked tensors)."""
    if not isinstance(tree, dict):
        return tree
    return {k: (_split_stacked(v) if k == "layers" and isinstance(v, dict)
                else unstack_layers(v)) for k, v in tree.items()}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy, bfloat16 widened to float32
    (exactly)."""
    t = t.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(tree) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: ``repro``'s stacked tree
    of numpy arrays (:func:`stack_layers`, then :func:`to_numpy`), for
    parameters or any tree of the same layout (gradients, moments)."""
    return tree_map(to_numpy, stack_layers(tree))


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
    layers = [_tree(entry, to_numpy) for entry in cache["layers"]]
    for entry, kv in zip(layers, cache.get("cross_kv") or ()):
        entry["cross_kv"] = tuple(to_numpy(t) for t in kv)
    return layers
