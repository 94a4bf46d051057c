"""Checkpoints: a nested dict (or list/tuple) of tensors -> npz, ported
from ``repro.checkpoint.checkpoint``.

Tensors are moved to the host.  Keys are '/'-joined paths (dict keys,
list indices), so restore round-trips through nested structures.

``restore_flat`` walks the CALLER's template, so an archive may carry
extra keys the template does not name, and they are ignored.

``save_lm`` / ``restore_lm`` keep a language model's ParamTree in the
reference's stacked layout (a decoder's ``scan/u0/...`` leaves ``[n_rep,
...]``, an encoder-decoder's ``enc_scan/u0/...`` and ``dec_scan/u0/...``
leaves ``[n_layers, ...]``), so
``repro.checkpoint.checkpoint.restore`` reads the port's archive and the
port reads the reference's.  numpy has no bfloat16: bf16 leaves are
written as float32, which holds them exactly, and a restore casts them
back to their def's dtype (the reference's own npz holds a bf16 leaf's raw
2-byte values, which its ``restore`` cannot cast; ``restore_lm`` reads
them).
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

Tree = Any

# npz key carrying the JSON-encoded meta dict; it lives INSIDE the archive,
# so meta and arrays are one atomic unit (see save())
_META_KEY = "__meta__"


def _leaves(tree: Tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict/list/tuple, in a fixed order."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}/{k}" if prefix else k)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else tuple(np.shape(leaf))


def _flatten(tree: Tree) -> dict:
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def save(path: str, tree: Tree, meta: dict | None = None) -> None:
    """Atomic write: ``meta`` rides INSIDE the npz (as JSON bytes under
    ``__meta__``), so the arrays and the meta that describes them (the
    fleet driver's chunk counter) land in one ``os.replace``; a kill at any
    point leaves the previous complete checkpoint or the new one."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    if _META_KEY in flat:
        raise ValueError(f"tree path collides with {_META_KEY!r}")
    npz_path = _npz(path)
    tmp = npz_path + ".tmp.npz"
    meta_bytes = np.frombuffer(json.dumps(meta or {}).encode(), np.uint8)
    np.savez(tmp, **flat, **{_META_KEY: meta_bytes})
    os.replace(tmp, npz_path)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def exists(path: str) -> bool:
    """Whether a checkpoint was saved at ``path``."""
    return os.path.exists(_npz(path))


def restore(path: str, like: Tree) -> Tree:
    """Restore into the structure of ``like`` (values ignored)."""
    return restore_flat(load_flat(path), like)


def _like(arr: np.ndarray, leaf):
    """``arr`` in the form of the template ``leaf``: a tensor of its dtype
    on its device, or a numpy array of its dtype.  Values are not touched
    (npz keeps dtypes)."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
    return np.asarray(arr, dtype=np.asarray(leaf).dtype)


def restore_flat(flat: dict, like: Tree) -> Tree:
    """``restore`` from an already loaded ``load_flat`` dict.  Raises a
    KeyError for a key the template names and the archive lacks, and a
    ValueError on a shape mismatch."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [walk(v, f"{prefix}/{i}" if prefix else str(i))
                   for i, v in enumerate(tree)]
            return type(tree)(out)
        if prefix not in flat:
            raise KeyError(f"checkpoint missing key {prefix!r}")
        arr = flat[prefix]
        if tuple(arr.shape) != _shape(tree):
            raise ValueError(f"shape mismatch for {prefix}: "
                             f"{arr.shape} vs {_shape(tree)}")
        return _like(arr, tree)
    return walk(like, "")


def load_flat(path: str) -> dict:
    """The checkpoint as the flat {'/'-joined path: array} dict, for
    callers whose restore target has a variable length (the fleet driver's
    traces and evals)."""
    with np.load(_npz(path)) as npz:
        return {k: npz[k] for k in npz.files if k != _META_KEY}


def load_meta(path: str) -> dict:
    """The meta stored inside the npz (atomic with the arrays)."""
    with np.load(_npz(path)) as npz:
        return json.loads(bytes(npz[_META_KEY]).decode())


def save_lm(path: str, cfg, params, meta: dict | None = None) -> None:
    """Save a language model's ParamTree in the reference's stacked layout
    (``models.param.lm_params_to_stacked``, or ``encdec_params_to_stacked``
    when ``cfg.is_enc_dec``); bf16 leaves as float32."""
    from repro_torch.models.param import (encdec_params_to_stacked,
                                          lm_params_to_stacked)
    to_stacked = encdec_params_to_stacked if cfg.is_enc_dec \
        else lm_params_to_stacked

    def widen(tree):
        if isinstance(tree, dict):
            return {k: widen(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [widen(v) for v in tree]
        return tree.float() if tree.dtype == torch.bfloat16 else tree
    save(path, widen(to_stacked(cfg, params)), meta)


def _nest(flat: dict) -> dict:
    """A flat {'/'-joined path: array} dict as nested dicts, a level whose
    keys are all indices as a list."""
    root: dict = {}
    for key, arr in flat.items():
        *parents, leaf = key.split("/")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(root)


def restore_lm(path: str, cfg, device: torch.device = torch.device("cpu")):
    """A ParamTree on ``device`` from an archive in the reference's stacked
    layout (the port's ``save_lm`` or the reference's ``save``); each leaf
    in its def's dtype.  A missing, extra or misshapen leaf raises."""
    from repro_torch.models.param import (encdec_params_from_jax,
                                          lm_params_from_jax)
    from_jax = encdec_params_from_jax if cfg.is_enc_dec \
        else lm_params_from_jax

    def readable(a: np.ndarray) -> np.ndarray:
        # the reference's npz of a bf16 leaf holds its raw 2-byte values
        if a.dtype.kind == "V" and a.dtype.itemsize == 2:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16).float().numpy()
        return a
    flat = {k: readable(a) for k, a in load_flat(path).items()}
    return from_jax(cfg, _nest(flat)).to(device)
