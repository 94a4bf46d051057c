"""Helpers for the port's parity tests (``tests/test_torch_*.py``).

* numpy <-> tensor conversion of parameter dicts;
* the reference's draws recipe, replayed for the port;
* a child-process runner for the reference fleet.

The reference's fleet driver imports ``jax.experimental.enable_x64``, which
the installed jax no longer has.  The child process sets the shim
``jax.experimental.enable_x64 = jax.enable_x64`` before importing
``repro.fl.driver``; the pytest process never does, so the JAX test files
import exactly as they do without the port's tests.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SCHEME_FIELDS = ("gamma", "alpha", "p", "thresholds", "noise_over_alpha",
                 "n0", "mask", "bmax", "gmax")
CHUNK_CASES = ((30, 10, 1), (31, 10, 1), (4, 2, 1), (7, 3, 0), (1, 5, 1))
FIG2_SCHEMES = ("ideal", "opc", "sca", "lcpc", "vanilla", "bbfl_interior",
                "bbfl_alternative")


def to_numpy(tree: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def scheme_fields(pc) -> dict:
    """A reference scheme's design leaves as numpy (what ``scheme_from_jax``
    takes)."""
    out = {}
    for f in SCHEME_FIELDS:
        v = getattr(pc, f, None)
        if v is not None:
            out[f] = np.asarray(v, np.float64)
    return out


def reference_draws(jax_random, ota, gains, seeds, num_rounds, leaf_sizes,
                    num_devices, batch_size, shard_len) -> dict:
    """The reference fleet's per-(seed, round) draws, by its own recipe:
    per round ``key, sub = split(key)``; ``k_fade, k_ota, k_batch =
    split(sub, 3)`` (engine.py); ``h = ota.draw_fading(k_fade, gains)``;
    ``k_coeff, k_noise = split(k_ota)``; leaf l's noise is
    ``normal(split(k_noise, n_leaves)[l], size_l)`` (ops.py); minibatch
    indices ``randint(k_batch, (N, B), 0, Dn)``; the bbfl coin
    ``bernoulli(k_coeff, 0.5)`` (power_control.py).  Arrays [T, S, ...]."""
    import jax.numpy as jnp
    gains_j = jnp.asarray(gains)
    hs, zs, idxs, coins = [], [], [], []
    for seed in seeds:
        key = jax_random.PRNGKey(seed)
        h_s, z_s, i_s, c_s = [], [], [], []
        for _ in range(num_rounds):
            key, sub = jax_random.split(key)
            k_fade, k_ota, k_batch = jax_random.split(sub, 3)
            h_s.append(np.asarray(ota.draw_fading(k_fade, gains_j)))
            k_coeff, k_noise = jax_random.split(k_ota)
            keys = jax_random.split(k_noise, len(leaf_sizes))
            z_s.append(np.concatenate([np.asarray(jax_random.normal(k, (sz,)))
                                       for k, sz in zip(keys, leaf_sizes)]))
            i_s.append(np.asarray(jax_random.randint(
                k_batch, (num_devices, batch_size), 0, shard_len)))
            c_s.append(bool(jax_random.bernoulli(k_coeff, 0.5)))
        hs.append(h_s), zs.append(z_s), idxs.append(i_s), coins.append(c_s)
    swap = (lambda a: np.swapaxes(np.asarray(a), 0, 1))   # [S, T] -> [T, S]
    return {"h": swap(hs), "z": swap(zs), "idx": swap(idxs),
            "coin": swap(coins)}


_CHILD = r'''
import json, sys
cfg = json.loads(sys.argv[1])
import numpy as np
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
from jax import random as jr
from repro.core import channel, ota, power_control as pcm
from repro.core.theory import OTAParams
from repro.fl import driver
from repro.tasks.image import make_paper_mlp
sys.path.insert(0, cfg["tests"])
import torch_ref

task = make_paper_mlp(hidden=cfg["hidden"],
                      samples_per_class=cfg["samples_per_class"])
wcfg = channel.WirelessConfig(num_devices=task.num_devices, seed=0)
dep = channel.deploy(wcfg)
td = task.build_data(0)
prm = OTAParams(d=task.param_dim, gmax=10.0, es=wcfg.energy_per_sample,
                n0=wcfg.noise_psd, gains=dep.gains,
                sigma_sq=np.zeros(wcfg.num_devices), eta=0.05, lsmooth=1.0,
                kappa_sq=4.0)
schemes = [pcm.make_power_control(n, dep, prm.replace(eta=task.eta_for(n, 0.05)),
                                  method="scipy") if n == "sca" else
           pcm.make_power_control(n, dep, prm.replace(eta=task.eta_for(n, 0.05)))
           for n in cfg["schemes"]]
params0 = task.init_params(0)
out = {"gains": dep.gains}
for k, v in params0.items():
    out["params0/" + k] = np.asarray(v)
for pc in schemes:
    for f, v in torch_ref.scheme_fields(pc).items():
        out["scheme/%s/%s" % (pc.name, f)] = v
for name, kw in cfg["variants"].items():
    run = task.run_config(num_rounds=cfg["rounds"], eval_every=cfg["every"],
                          seed=0, batch_size=cfg["batch"])
    res = driver.run_fleet_task(task, schemes, dep.gains, run, task_data=td,
                                params=params0, seeds=tuple(cfg["seeds"]),
                                flat=True, **kw)
    for k, v in res.params.items():
        out["%s/params/%s" % (name, k)] = np.asarray(v)
    for k, v in res.traces.items():
        out["%s/traces/%s" % (name, k)] = np.asarray(v)
    out["%s/evals_t" % name] = np.asarray([t for t, _ in res.evals])
    for k in res.evals[0][1]:
        out["%s/evals/%s" % (name, k)] = np.stack(
            [np.asarray(ev[k]) for _, ev in res.evals])
sizes = [int(np.asarray(params0[k]).size) for k in sorted(params0)]
x_dev = td.train[0]
draws = torch_ref.reference_draws(jr, ota, dep.gains, cfg["seeds"],
                                  cfg["rounds"], sizes, x_dev.shape[0],
                                  cfg["batch"], x_dev.shape[1])
for k, v in draws.items():
    out["draws/" + k] = v
from repro.fl.engine import chunk_lengths
for case in cfg["chunk_cases"]:
    out["chunk_lengths/%d-%d-%d" % tuple(case)] = np.asarray(
        chunk_lengths(case[0], case[1], bool(case[2])), np.int64)
np.savez(cfg["out"], **out)
'''


def run_reference_fleet(out_path: Path, *, hidden: int = 16,
                        samples_per_class: int = 40, batch: int = 8,
                        rounds: int = 4, every: int = 2, seeds=(0, 1),
                        schemes=FIG2_SCHEMES, variants=None,
                        timeout: float = 600.0) -> dict:
    """Run ``repro.fl.driver.run_fleet_task`` on a shrunk paper_mlp in a
    child process (JAX on the CPU) and return what it wrote: initial
    params, scheme design leaves, per-variant params/traces/evals, the
    draws it consumed ([T, S, ...]), and ``engine.chunk_lengths`` for each
    (num_rounds, eval_every, with_eval) of ``CHUNK_CASES``."""
    variants = variants if variants is not None else {
        "fused": {}, "unfused": {"fuse_round": False},
        "int8": {"uplink_dtype": "int8"}}
    cfg = dict(hidden=hidden, samples_per_class=samples_per_class,
               batch=batch, rounds=rounds, every=every, seeds=list(seeds),
               schemes=list(schemes), variants=variants, out=str(out_path),
               chunk_cases=[list(c) for c in CHUNK_CASES],
               tests=str(ROOT / "tests"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(cfg)],
                          env=env, cwd=str(ROOT), capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference fleet failed:\n{proc.stderr[-4000:]}")
    with np.load(out_path) as f:
        return {k: f[k] for k in f.files}


def prefixed(blob: dict, prefix: str) -> dict:
    """The entries of ``blob`` under ``prefix/``, prefix stripped."""
    p = prefix + "/"
    return {k[len(p):]: v for k, v in blob.items() if k.startswith(p)}


def tensors(tree: dict, dtype=torch.float32) -> dict:
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype)
            for k, v in tree.items()}
