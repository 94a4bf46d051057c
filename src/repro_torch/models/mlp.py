"""The paper's experiment model (§IV): one-hidden-layer MLP for 10-class
28x28 image classification, ported from ``repro.models.mlp``.

784 -> 1024 (ReLU) -> 10, with l2-regularized cross-entropy (coef 0.01).
Parameter count: 784*1024 + 1024 + 1024*10 + 10 = 814,090 = d.  The
matmuls stay ``torch.matmul``, as the JAX package leaves them to XLA.
Every function takes one cell's parameters; the fleet batches cells and
devices with ``torch.func.vmap``.
"""
from __future__ import annotations

import torch

from repro_torch.models.param import ParamDef

INPUT_DIM = 784
HIDDEN_DIM = 1024
NUM_CLASSES = 10
L2_COEF = 0.01
PARAM_DIM = INPUT_DIM * HIDDEN_DIM + HIDDEN_DIM + HIDDEN_DIM * NUM_CLASSES + NUM_CLASSES


def mlp_defs(hidden: int = HIDDEN_DIM, num_classes: int = NUM_CLASSES,
             input_dim: int = INPUT_DIM) -> dict:
    return {
        "w1": ParamDef((input_dim, hidden), init="scaled", fan_in=input_dim),
        "b1": ParamDef((hidden,), init="zeros"),
        "w2": ParamDef((hidden, num_classes), init="scaled", fan_in=hidden),
        "b2": ParamDef((num_classes,), init="zeros"),
    }


def mlp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, 784] -> logits [B, 10]."""
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def mlp_loss(params: dict, batch, l2: float = L2_COEF) -> torch.Tensor:
    """l2-regularized mean cross-entropy; batch = (x [B,784], y [B] int64).
    The l2 term sums over all leaves, as ``repro.models.mlp.mlp_loss``."""
    x, y = batch
    logits = mlp_forward(params, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[:, None])[:, 0]
    xent = torch.mean(logz - gold)
    reg = sum(torch.sum(params[k].float() ** 2) for k in sorted(params))
    return xent + 0.5 * l2 * reg


def accuracy(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logits = mlp_forward(params, x)
    return torch.mean((torch.argmax(logits, -1) == y).float())
