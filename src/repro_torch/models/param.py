"""Parameter definitions for the port's models.

Parameters are a plain ``dict`` of tensors.  Every function that ravels
them walks the keys in sorted order, which is ``jax.tree.flatten``'s order
for a dict: for the MLP that is ``b1, b2, w1, w2``.  The per-leaf noise
draws and the raveled gradient line up with the reference only in that
order.

``init_params`` draws the init laws of ``repro.models.param`` (``scaled``:
normal x 1/sqrt(fan_in); ``embed``: normal x 1/sqrt(d_model); ``zeros``,
``ones``) from a ``torch.Generator``; it cannot reproduce JAX's threefry
stream, so weights are carried across with ``params_from_jax`` (the MLP),
``lm_params_from_jax`` (the decoders) or ``encdec_params_from_jax`` (the
encoder-decoder) where a test needs the reference's exact start.

The language models hold their parameters in a ``ParamTree``: a module
whose children are indexed like the reference's pytree
(``p["mixer"]["wq"]["w"]``), with one child per layer where the reference
stacks the layers of a ``lax.scan``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "scaled"          # scaled | zeros | ones | embed
    fan_in: Optional[int] = None  # for 'scaled': 1/sqrt(fan_in)
    dtype: Any = torch.float32

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def param_count(defs: Mapping[str, ParamDef]) -> int:
    return sum(d.size for d in defs.values())


def leaf_order(tree: Mapping) -> list:
    """The raveling order of a parameter dict: sorted keys."""
    return sorted(tree)


def _init_one(d: ParamDef, gen: torch.Generator,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """One leaf in ``d.dtype``, drawn in float32 on ``gen``'s device and
    scaled in place before the cast (one float32 copy of the leaf at a
    time: an expert weight of mixtral-8x22b is 6.4 GB in float32)."""
    kw = dict(dtype=torch.float32, device=device)
    if d.init == "zeros":
        return torch.zeros(d.shape, **kw).to(d.dtype)
    if d.init == "ones":
        return torch.ones(d.shape, **kw).to(d.dtype)
    if d.init == "embed":
        # 1/sqrt(d_model): keeps tied-unembedding logits O(1) at init
        scale = 1.0 / math.sqrt(d.shape[-1])
    elif d.init == "scaled":
        fan_in = d.fan_in
        if fan_in is None:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else max(1, d.shape[-1])
        scale = 1.0 / math.sqrt(fan_in)
    else:
        raise ValueError(f"unknown init {d.init!r}")
    return torch.randn(d.shape, generator=gen, **kw).mul_(scale).to(d.dtype)


def init_params(defs: Mapping[str, ParamDef], seed: int,
                device: torch.device) -> dict:
    """Materialize ``defs`` from a CPU generator seeded with ``seed`` (the
    same numbers on every device), leaves drawn in raveling order."""
    gen = torch.Generator().manual_seed(int(seed))
    return {k: _init_one(defs[k], gen).to(device) for k in leaf_order(defs)}


def params_from_jax(tree: Mapping[str, np.ndarray],
                    device: torch.device = torch.device("cpu")) -> dict:
    """Carry a reference parameter dict (leaves converted to numpy by the
    caller) across as float32 tensors, bit for bit."""
    return {k: torch.from_numpy(np.array(tree[k], np.float32)).to(device)
            for k in leaf_order(tree)}


class ParamTree(nn.Module):
    """A nested dict (and list) of tensors as a module, indexed like the
    reference's pytree: ``tree["layers"][3]["mixer"]["wq"]["w"]``.
    Leaves are frozen parameters: serving computes no gradient, and the
    train path differentiates a ``trainable`` view of them."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v) for v in val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _map_defs(defs, fn):
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, Mapping):
        return {k: _map_defs(v, fn) for k, v in defs.items()}
    return [_map_defs(v, fn) for v in defs]


def tree_param_count(defs) -> int:
    """Parameters of a nested def tree (dicts and lists of ``ParamDef``)."""
    n = []
    _map_defs(defs, lambda d: n.append(d.size))
    return sum(n)


def init_param_tree(defs: Mapping, seed: int, device: torch.device,
                    draw_device: Optional[torch.device] = None) -> ParamTree:
    """Materialize a nested def tree on ``device`` from a generator on
    ``draw_device`` (default ``device``), seeded with ``seed``; leaves
    drawn in the tree's insertion order.  A CPU generator gives the same
    numbers on every device (the LM task's init, which the reference's
    trajectories start from)."""
    draw = device if draw_device is None else torch.device(draw_device)
    gen = torch.Generator(device=draw).manual_seed(int(seed))
    return ParamTree(_map_defs(
        defs, lambda d: _init_one(d, gen, draw).to(device)))


def map_named(tree, fn, path=""):
    """``fn(path, leaf)`` over a ParamTree (or nested dicts and lists of
    tensors) as nested dicts and lists; paths are ``named_parameters``'s
    names."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    pre = path + "." if path else ""
    if isinstance(tree, (nn.ModuleList, list, tuple)):
        return [map_named(v, fn, f"{pre}{i}") for i, v in enumerate(tree)]
    items = (list(tree._parameters.items()) + list(tree._modules.items())
             if isinstance(tree, nn.Module) else tree.items())
    return {k: map_named(v, fn, pre + k) for k, v in items}


def param_leaves(params) -> dict:
    """The leaves of a ParamTree (or nested dicts and lists of tensors) by
    name, ``named_parameters``'s names, in its order of insertion."""
    leaves = {}

    def one(path, p):
        leaves[path] = p
    map_named(params, one)
    return leaves


def trainable(params) -> tuple:
    """(view, leaves): ``params`` as nested dicts and lists of tensors that
    share the parameters' storage and require grad, and those tensors by
    name (``named_parameters``'s names), for ``torch.autograd.grad``."""
    leaves = {}

    def one(path, p):
        leaves[path] = p.detach().requires_grad_(True)
        return leaves[path]
    return map_named(params, one), leaves


def layer_groups(cfg) -> tuple:
    """(lead, unit, n_rep, tail) over the port's per-layer signatures: the
    reference's ``layer_plan`` (``repro.models.transformer``), which groups
    the layers as ``lead`` layers (an MoE config's first
    ``moe_first_dense``, whose FFN is dense), a unit of
    ``len(block_pattern)`` layers stacked ``n_rep`` times under ``scan``,
    and ``tail`` layers."""
    from repro_torch.models.transformer import layer_sigs
    sigs = layer_sigs(cfg)
    n_lead = min(cfg.moe_first_dense if cfg.moe_num_experts else 0,
                 len(sigs))
    lead, body = sigs[:n_lead], sigs[n_lead:]
    if not body:
        return lead, [], 0, []
    k = len(cfg.block_pattern)
    unit, n_rep = body[:k], 0
    while (n_rep + 1) * k <= len(body) and \
            body[n_rep * k:(n_rep + 1) * k] == unit:
        n_rep += 1
    return lead, unit, n_rep, body[n_rep * k:]


def lm_params_to_stacked(cfg, params) -> dict:
    """The inverse of ``lm_params_from_jax``: a ParamTree (or a tree of the
    same layout, such as its gradients) in the reference's layout,
    ``embed``, ``lead``, ``scan`` (``u0 .. u{k-1}``, leaves stacked
    ``[n_rep, ...]``), ``tail``, ``ln_f``, ``unembed``, ``mtp``, as nested
    dicts and lists of tensors on the tree's device."""
    lead, unit, n_rep, _ = layer_groups(cfg)
    tree = map_named(params, lambda _, t: t.detach())
    n_lead, k = len(lead), len(unit)
    layers = tree["layers"][n_lead:]
    out = {"embed": tree["embed"]} if "embed" in tree else {}
    out["lead"] = tree["layers"][:n_lead]
    if n_rep:
        out["scan"] = {f"u{i}": _stack(layers[i:n_rep * k:k])
                       for i in range(k)}
    out["tail"] = layers[n_rep * k:]
    out["ln_f"] = tree["ln_f"]
    for key in ("unembed", "mtp"):
        if key in tree:
            out[key] = tree[key]
    return out


def lm_params_from_jax(cfg, tree: Mapping) -> ParamTree:
    """Carry a reference decoder's parameters (``repro.models.transformer``
    layout, leaves converted to numpy by the caller) across as a
    ``ParamTree`` on the CPU (``.to(device)`` moves it), each leaf in the
    dtype of its ``ParamDef`` in the port's ``model_defs(cfg)``: mostly
    ``cfg.param_dtype``, but float32 for the SSD mixer's ``a_log``,
    ``dt_bias`` and ``d_skip``, the RG-LRU block's ``lam`` and the MoE
    router at every width, as in the reference.

    The reference groups its layers as ``lead`` (a list), ``scan`` (a dict
    ``u0 .. u{k-1}`` of unit layers whose leaves are stacked ``[n_rep,
    ...]``) and ``tail`` (a list); the port keeps one entry per layer in
    ``layers``, in execution order: lead, then the units repetition by
    repetition, then tail.  ``mtp`` (the MTP module, with ``mtp_depth``)
    comes across as it is.  A leaf missing on either side, or of another
    shape than its def, raises.
    """
    # transformer imports this module, so its defs are looked up here
    from repro_torch.models.transformer import model_defs

    lead, tail = tree.get("lead", []), tree.get("tail", [])
    layers = list(lead)
    scan = tree.get("scan")
    if scan:
        units = [scan[f"u{i}"] for i in range(len(scan))]
        n_rep = (cfg.n_layers - len(lead) - len(tail)) // len(units)
        for r in range(n_rep):
            layers += [_map_leaves(u, lambda a, r=r: np.asarray(a)[r])
                       for u in units]
    layers += list(tail)
    flat = {"layers": layers, "ln_f": tree["ln_f"]}
    for key in ("embed", "unembed", "mtp"):
        if key in tree:
            flat[key] = tree[key]

    return _carry(flat, model_defs(cfg))


def encdec_params_from_jax(cfg, tree: Mapping) -> ParamTree:
    """Carry a reference encoder-decoder's parameters
    (``repro.models.encdec`` layout, leaves converted to numpy by the
    caller) across as a ``ParamTree`` on the CPU, each leaf in the dtype
    of its ``ParamDef`` in ``encdec_defs(cfg)``.  The reference stacks
    each side's layers under ``enc_scan`` and ``dec_scan`` (one unit,
    ``u0``, leaves ``[n_layers, ...]``); the port keeps one entry per
    layer in ``enc_layers`` and ``dec_layers``.  A leaf missing on either
    side, or of another shape than its def, raises."""
    from repro_torch.models.encdec import encdec_defs

    flat = {"enc_layers": _unstack(tree["enc_scan"]["u0"]),
            "dec_layers": _unstack(tree["dec_scan"]["u0"]),
            **{k: tree[k] for k in ("enc_ln_f", "embed", "ln_f",
                                    "unembed")}}
    return _carry(flat, encdec_defs(cfg))


def encdec_params_to_stacked(cfg, params) -> dict:
    """The inverse of ``encdec_params_from_jax``: an encoder-decoder's
    ParamTree (or a tree of its layout) in the reference's
    ``encdec_defs`` layout, ``enc_scan`` and ``dec_scan`` (one unit,
    ``u0``, leaves stacked ``[n_layers, ...]``), ``enc_ln_f``, ``embed``,
    ``ln_f``, ``unembed``, as nested dicts of tensors on the tree's
    device."""
    tree = map_named(params, lambda _, t: t.detach())
    return {"enc_scan": {"u0": _stack(tree["enc_layers"])},
            "enc_ln_f": tree["enc_ln_f"], "embed": tree["embed"],
            "dec_scan": {"u0": _stack(tree["dec_layers"])},
            "ln_f": tree["ln_f"], "unembed": tree["unembed"]}


def _stack(group: list):
    """n trees of one layout as one tree whose leaves are stacked
    ``[n, ...]``."""
    if isinstance(group[0], Mapping):
        return {key: _stack([g[key] for g in group]) for key in group[0]}
    return torch.stack(group)


def _unstack(unit: Mapping) -> list:
    """A scan unit whose leaves are stacked ``[n, ...]`` as n trees."""
    leaf = unit
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    return [_map_leaves(unit, lambda a, r=r: np.asarray(a)[r])
            for r in range(len(leaf))]


def _map_leaves(t, fn):
    if isinstance(t, Mapping):
        return {k: _map_leaves(v, fn) for k, v in t.items()}
    return fn(t)


def _carry(tree, defs) -> ParamTree:
    """A nested tree of arrays as a ParamTree in the layout and dtypes of
    ``defs``; a key or length that differs, or a shape, raises."""
    def carry(t, d, path):
        if isinstance(d, ParamDef):
            a = np.array(t, np.float32)
            if a.shape != d.shape:
                raise ValueError(f"{path}: shape {a.shape}, def {d.shape}")
            return torch.from_numpy(a).to(d.dtype)
        if isinstance(d, Mapping):
            if not isinstance(t, Mapping) or set(t) != set(d):
                raise ValueError(f"{path}: keys {sorted(t)} against the "
                                 f"defs' {sorted(d)}")
            return {k: carry(t[k], d[k], f"{path}/{k}") for k in d}
        if len(t) != len(d):
            raise ValueError(f"{path}: {len(t)} entries, defs {len(d)}")
        return [carry(a, b, f"{path}/{i}")
                for i, (a, b) in enumerate(zip(t, d))]

    return ParamTree(carry(tree, defs, ""))
