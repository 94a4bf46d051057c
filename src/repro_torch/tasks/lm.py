"""The token_stream LM task: synthetic-corpus FL language modelling, ported
from ``repro.tasks.lm``.

A decoder bundle (``models.registry``) plus the non-iid client sharding:
each client's Zipf token stream is rotated into a client-specific vocab
band, a heterogeneity analogous to the paper's label split.  The bundle
rides in ``task.aux["bundle"]`` for the train step, which builds against
it (``launch.steps.make_train_step``).  Its runtime is ``"steps"``: it
trains through ``launch.train``, and the fleet consumers refuse it.

``init_params(seed, device)`` draws the reference's init laws from a CPU
generator seeded with ``seed`` and moves them to ``device``, so a seed's
initial weights are the same numbers on the CPU and on the card (the
reference's trajectories in ``experiments/lm_reference/`` start from
them).  The held-out eval runs the loss under ``torch.no_grad()`` with the
kernels on: K3 for attention layers, K4 for SSD layers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data.synthetic import token_stream
from repro_torch.models.param import init_param_tree
from repro_torch.models.registry import build_bundle
from repro_torch.tasks.base import Task, TaskData


def client_batches(vocab: int, num_clients: int, per_client: int, seq: int,
                   steps: int, seed: int = 0) -> np.ndarray:
    """Non-iid client shards [steps, N, per_client, seq+1]: each client's
    stream uses a shifted vocab slice."""
    streams = []
    for m in range(num_clients):
        toks = token_stream(steps * per_client * (seq + 1), vocab,
                            seed=seed * 1000 + m)
        band = vocab // max(num_clients, 1)
        toks = (toks + m * band) % vocab
        streams.append(toks.reshape(steps, per_client, seq + 1))
    return np.stack(streams, axis=1)


def make_token_stream(arch: str = "qwen1.5-0.5b", smoke: bool = True,
                      d_model: int = 64, n_layers: int = 2,
                      clients: int = 4, per_client_batch: int = 1,
                      seq: int = 32, device=None) -> Task:
    """LM task factory.  Defaults are CPU-tiny (the reference's registry
    smoke scale); ``launch.train`` passes its CLI sizes through.
    ``d_model=0`` / ``n_layers=0`` keep the arch's own smoke dimensions;
    without ``smoke``, ``n_layers`` cuts the full-width arch's depth (a
    port addition: mixtral-8x22b and deepseek-v3-671b fit the card only
    so) and ``d_model``
    is ignored, as the reference ignores both there.
    ``device`` is the bundle's (None: the CUDA card, which must be
    there).  An encoder-decoder raises: its loss takes (frames, tokens),
    and these token batches carry no frames, as the reference's do not
    (its CLI cannot train one either); it trains through
    ``launch.steps.make_train_step`` on (frames, tokens) batches."""
    cfg = configs.get_config(arch)
    if cfg.is_enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: token_stream batches carry no frames, as the "
            "reference's do not; an encoder-decoder trains through "
            "launch.steps.make_train_step on (frames, tokens) batches")
    if smoke:
        over = {}
        if d_model:
            over.update(d_model=d_model, n_heads=max(4, d_model // 64),
                        n_kv_heads=max(2, d_model // 128),
                        d_ff=d_model * 3, vocab_size=8192)
        if n_layers:
            over["n_layers"] = n_layers
        cfg = cfg.smoke(**over)
    elif n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    bundle = build_bundle(cfg, device)

    def build(seed: int = 0, steps: int = 8) -> TaskData:
        # one extra step's worth of tokens becomes the held-out eval batch
        data = client_batches(cfg.vocab_size, clients, per_client_batch,
                              seq, steps + 1, seed)
        test = data[-1].reshape(-1, seq + 1)
        return TaskData(train=data[:steps], test=test,
                        extras={"steps": steps})

    def make_eval(td: TaskData, dev: torch.device):
        test = torch.as_tensor(td.test, device=dev).long()

        @torch.no_grad()
        def evals(params):
            return {"loss": bundle.loss(params, test, use_kernel=True)}
        return evals

    def init(seed: int, dev: torch.device):
        return init_param_tree(bundle.defs, seed, dev, draw_device="cpu")

    return Task(
        name="token_stream", num_devices=clients,
        param_dim=bundle.num_params,
        loss_fn=lambda params, batch: bundle.loss(params, batch),
        defaults=dict(eta=0.05, num_rounds=50, eval_every=10, gmax=10.0,
                      batch_size=0),
        defs=bundle.defs, _build_data=build, _make_eval=make_eval,
        artifact_tag="lm", runtime="steps", _init_fn=init,
        aux={"bundle": bundle, "cfg": cfg})
