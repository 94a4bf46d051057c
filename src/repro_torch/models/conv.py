"""Small convnet for the CIFAR-class image task, ported from
``repro.models.conv``:

    conv 3x3 (3 -> c1) -> ReLU -> 2x2 avg-pool
    conv 3x3 (c1 -> c2) -> ReLU -> 2x2 avg-pool
    flatten -> dense hidden -> ReLU -> dense num_classes

Parameters keep the reference's layouts -- HWIO kernels, NHWC activations
at the public functions -- so ``params_from_jax`` carries the reference's
weights across as they are and the raveled [C, N, D] gradient that kernel
K1 reads is in the reference's order.  Inside, the convolutions are
``F.conv2d`` on NCHW with padding 1 ('SAME' for 3x3, stride 1), and the
pooled activation is flattened back in NHWC order (h, w, c) before ``w1``,
as the reference flattens it.  All parameters are float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.param import ParamDef, param_count

INPUT_SHAPE = (32, 32, 3)
NUM_CLASSES = 10
L2_COEF = 1e-4


def conv_defs(channels: tuple = (16, 32), hidden: int = 128,
              num_classes: int = NUM_CLASSES,
              input_shape: tuple = INPUT_SHAPE) -> dict:
    """ParamDef dict for the convnet (all f32, the reference's shapes)."""
    h, w, c_in = input_shape
    c1, c2 = channels
    pooled = (h // 4) * (w // 4) * c2        # two 2x2 pools
    return {
        "conv1": ParamDef((3, 3, c_in, c1), init="scaled",
                          fan_in=3 * 3 * c_in),
        "bc1": ParamDef((c1,), init="zeros"),
        "conv2": ParamDef((3, 3, c1, c2), init="scaled", fan_in=3 * 3 * c1),
        "bc2": ParamDef((c2,), init="zeros"),
        "w1": ParamDef((pooled, hidden), init="scaled", fan_in=pooled),
        "b1": ParamDef((hidden,), init="zeros"),
        "w2": ParamDef((hidden, num_classes), init="scaled", fan_in=hidden),
        "b2": ParamDef((num_classes,), init="zeros"),
    }


def conv_dim(channels: tuple = (16, 32), hidden: int = 128,
             num_classes: int = NUM_CLASSES,
             input_shape: tuple = INPUT_SHAPE) -> int:
    return param_count(conv_defs(channels, hidden, num_classes, input_shape))


def _conv_relu_pool(x: torch.Tensor, w_hwio: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """NCHW x, an HWIO kernel: 'SAME' 3x3 conv + bias, ReLU, 2x2 mean."""
    h = F.conv2d(x, w_hwio.permute(3, 2, 0, 1), b, padding=1)
    return F.avg_pool2d(torch.relu(h), 2)


def conv_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: [B, 32, 32, 3] (NHWC) -> logits [B, num_classes]."""
    h = _conv_relu_pool(x.permute(0, 3, 1, 2), params["conv1"],
                        params["bc1"])
    h = _conv_relu_pool(h, params["conv2"], params["bc2"])
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)    # (h, w, c) order
    h = torch.relu(h @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def conv_loss(params: dict, batch, l2: float = L2_COEF) -> torch.Tensor:
    """l2-regularized mean cross-entropy; batch = (x [B,32,32,3], y [B]
    int64).  The l2 term sums over all leaves, as the reference's."""
    x, y = batch
    logits = conv_forward(params, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[:, None])[:, 0]
    xent = torch.mean(logz - gold)
    reg = sum(torch.sum(params[k].float() ** 2) for k in sorted(params))
    return xent + 0.5 * l2 * reg


def accuracy(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logits = conv_forward(params, x)
    return torch.mean((torch.argmax(logits, -1) == y).float())
