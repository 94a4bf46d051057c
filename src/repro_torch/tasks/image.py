"""Image-classification tasks, ported from ``repro.tasks.image``.

``paper_mlp`` is the paper's §IV workload: mnist_like data, the ring label
partition, the 814,090-parameter MLP, accuracy + global-loss eval.

``cifar_conv`` is the harder non-iid vision workload: 32x32x3 10-class
``cifar_like`` data, a Dirichlet(alpha) label partition padded to the
largest shard, the small f32 convnet of ``models/conv.py`` (268,650
parameters at the defaults), minibatch + flat aggregation as its
preferred sweep mode (so its rounds go through kernel K1 on the card).
"""
from __future__ import annotations

import torch

from repro_torch.configs.paper_mlp import CONFIG as PAPER
from repro_torch.data import partition, synthetic
from repro_torch.models import conv, mlp
from repro_torch.models.param import param_count
from repro_torch.tasks.base import Task, TaskData

# constant step sizes per scheme (grid-searched once, as in the paper)
PAPER_ETAS = {"ideal": 0.08, "opc": 0.06, "sca": 0.06, "lcpc": 0.05,
              "vanilla": 0.05, "bbfl_interior": 0.06,
              "bbfl_alternative": 0.06}

# the convnet reuses the paper task's operating points as-is, as the
# reference does
CIFAR_ETAS = dict(PAPER_ETAS)


def _image_eval(loss_fn, acc_fn, td: TaskData, device: torch.device):
    xt = torch.as_tensor(td.test[0], device=device)
    yt = torch.as_tensor(td.test[1], device=device).long()
    xg = torch.as_tensor(td.extras["global"][0], device=device)
    yg = torch.as_tensor(td.extras["global"][1], device=device).long()

    def evals(params):
        return {"acc": acc_fn(params, xt, yt),
                "global_loss": loss_fn(params, (xg, yg))}
    return evals


def make_paper_mlp(hidden: int = mlp.HIDDEN_DIM,
                   samples_per_class: int = PAPER.samples_per_class,
                   noise: float = 0.75, test_per_class: int = 100,
                   global_eval: int = 4000) -> Task:
    """The paper's §IV workload (defaults = the reference's fig2 world)."""
    defs = mlp.mlp_defs(hidden=hidden)

    def build(seed: int = 0) -> TaskData:
        x, y, xt, yt = synthetic.mnist_like(
            samples_per_class, noise=noise, seed=seed,
            test_per_class=test_per_class)
        shards = partition.partition_by_label(
            x, y, PAPER.num_devices, PAPER.labels_per_device,
            PAPER.max_devices_per_label, seed=seed)
        return TaskData(train=partition.stack_shards(shards), test=(xt, yt),
                        extras={"global": (x[:global_eval], y[:global_eval])})

    return Task(
        name="paper_mlp", num_devices=PAPER.num_devices,
        param_dim=param_count(defs), loss_fn=mlp.mlp_loss,
        defaults=dict(eta=0.05, num_rounds=150, eval_every=10,
                      gmax=PAPER.gmax, batch_size=PAPER.local_batch),
        defs=defs, scheme_etas=dict(PAPER_ETAS), artifact_tag="fig2_torch",
        _build_data=build,
        _make_eval=lambda td, device: _image_eval(mlp.mlp_loss, mlp.accuracy,
                                                  td, device))


def make_cifar_conv(channels: tuple = (16, 32), hidden: int = 128,
                    num_devices: int = 10, samples_per_class: int = 500,
                    noise: float = 0.25, alpha: float = 0.3,
                    test_per_class: int = 100,
                    global_eval: int = 2000) -> Task:
    """CIFAR-class conv workload: Dirichlet(alpha) non-iid split, f32
    convnet; preferred sweep mode minibatch 32 + flat (the defaults).
    The Dirichlet shards are unequal, so they are padded to the largest
    by cyclic repetition; a minibatch draws over the padded length."""
    defs = conv.conv_defs(channels, hidden)

    def build(seed: int = 0) -> TaskData:
        x, y, xt, yt = synthetic.cifar_like(
            samples_per_class, noise=noise, seed=seed,
            test_per_class=test_per_class)
        shards = partition.partition_dirichlet(x, y, num_devices,
                                               alpha=alpha, seed=seed)
        return TaskData(train=partition.stack_shards(shards, pad=True),
                        test=(xt, yt),
                        extras={"global": (x[:global_eval], y[:global_eval])})

    return Task(
        name="cifar_conv", num_devices=num_devices,
        param_dim=param_count(defs), loss_fn=conv.conv_loss,
        defaults=dict(eta=0.05, num_rounds=120, eval_every=10, gmax=10.0,
                      batch_size=32),
        defs=defs, scheme_etas=dict(CIFAR_ETAS), artifact_tag="cifar",
        _build_data=build,
        _make_eval=lambda td, device: _image_eval(conv.conv_loss,
                                                  conv.accuracy, td, device))
