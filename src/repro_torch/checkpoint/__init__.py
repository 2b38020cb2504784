"""Checkpointing: params / analytic state / FL-server state.

The port of ``repro.checkpoint``. Layout (a directory per checkpoint):
    <dir>/manifest.json     tree structure + leaf metadata + user metadata
    <dir>/arrays.npz        leaf arrays keyed by flattened path

Works on any tree of dicts, lists and tuples whose leaves are torch
tensors, numpy arrays or scalars; tensors (on any device) go to host numpy.
The flattened keys are the reference's ``jax.tree_util`` paths: dict keys
in sorted order, list and tuple indices as numbers, joined by ``/`` (a bare
leaf is ``_root``; ``None`` is an empty subtree). So a checkpoint written
by either package restores in the other. The manifest's ``treedef`` is a
string in the reference's ``PyTreeDef(...)`` form, for reading only:
neither package parses it.

``save_server`` / ``load_server`` round-trip any
:class:`repro_torch.fl.api.Coordinator` state (all coordinator kinds share
one checkpoint schema), enabling the straggler workflow: checkpoint
mid-aggregation, restart — as the same kind or a different one — and late
clients keep submitting. A :class:`~repro_torch.fl.service.RemoteCoordinator`
works as the source too — its ``state()`` downloads the federation
checkpoint over the wire — so an operator can snapshot a live remote
federation and restore it into any local coordinator kind behind a fresh
FederationService.
"""

from __future__ import annotations

import json
import pathlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "save_server", "load_server",
           "SnapshotDaemon"]

_SEP = "/"


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node in the reference's flattening
    order, or None for a leaf."""
    if isinstance(node, OrderedDict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()):
    """Yield (key path, leaf) in flattening order; ``None`` has no leaves."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from _leaves(v, prefix + (k,))


def _treedef(tree: Any) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        keys = tree if isinstance(tree, OrderedDict) else sorted(tree)
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in keys) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(v) for v in tree)
        return "(" + inner + ("," if len(tree) == 1 else "") + ")"
    return "*"


def _to_host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {(_SEP.join(path) or "_root"): _to_host(leaf)
            for path, leaf in _leaves(tree)}


def save(path, tree: Any, metadata: Optional[dict] = None) -> None:
    """Write a tree checkpoint (atomic-ish: npz then manifest last)."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    arrays = _flatten(tree)
    np.savez(path / "arrays.npz", **arrays)
    manifest = {
        "treedef": f"PyTreeDef({_treedef(tree)})",
        "keys": sorted(arrays),
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "metadata": metadata or {},
    }
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))


def _fill(like: Any, arrays: Dict[str, np.ndarray], prefix: Tuple[str, ...]):
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        key = _SEP.join(prefix) or "_root"
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(np.shape(like)):
            raise ValueError(
                f"shape mismatch at {key!r}: ckpt {arr.shape} vs "
                f"{tuple(np.shape(like))}")
        return arr
    filled = {k: _fill(v, arrays, prefix + (k,)) for k, v in kids}
    if isinstance(like, dict):
        out = {k: filled[str(k)] for k in like}
        return OrderedDict(out) if isinstance(like, OrderedDict) else out
    vals = [filled[str(i)] for i in range(len(like))]
    return vals if isinstance(like, list) else tuple(vals)


def restore(path, like: Any = None) -> Any:
    """Read a checkpoint. With ``like`` (a tree of the same structure —
    arrays, tensors or anything with a ``shape``), returns that structure
    filled with the stored (host numpy) arrays, validating shapes; without
    it, returns {key: array}."""
    path = pathlib.Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    if sorted(arrays) != manifest["keys"]:
        raise ValueError("checkpoint corrupt: manifest/npz key mismatch")
    if like is None:
        return arrays
    return _fill(like, arrays, ())


def save_server(path, server, metadata: Optional[dict] = None) -> None:
    """Checkpoint a coordinator (``state()`` speaks one shared schema).

    For the async coordinator ``state()`` is a coroutine — checkpoint it
    from its event loop: ``ckpt.save(path, await server.state())``.
    """
    import inspect

    state = server.state()
    if inspect.isawaitable(state):
        state.close()
        raise TypeError(
            "async coordinator state() is a coroutine; checkpoint it from "
            "the event loop: ckpt.save(path, await server.state())")
    meta = dict(metadata or {})
    meta["kind"] = type(server).__name__
    save(path, state, metadata=meta)


def load_server(path, cls=None, **kwargs):
    """Restore a coordinator: :class:`repro_torch.fl.api.AFLServer` by
    default, or any ``cls`` with the protocol's ``from_state`` (e.g.
    AsyncAFLServer). Extra kwargs pass through to ``from_state``."""
    if cls is None:
        from repro_torch.fl.api import AFLServer as cls

    state = restore(path)
    return cls.from_state(state, **kwargs)


# at the bottom: snapshot.py imports this module for save/load_server
from repro_torch.checkpoint.snapshot import SnapshotDaemon  # noqa: E402
