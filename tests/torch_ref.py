"""Helpers for the port's parity tests (``tests/test_torch_*.py``).

* numpy <-> tensor conversion of parameter dicts;
* the reference's draws recipe, replayed for the port;
* child-process runners for the reference: its fleet, its default ``sca``
  design, its solvers (``repro.solvers``), its task registry, and one
  seed of its Fig.-2 run (``benchmarks.fig2.run(..., save=False)``);
* ``python -m tests.torch_ref``, which writes the reference's Fig.-2
  curves and ``sca`` design under ``experiments/fig2_reference/`` for the
  port's curve check (``repro_torch.curves``), its scenario data
  (``--scenarios``) and its population data (``--population``);
* TF32 rounding and 3xTF32 products in plain torch, for the CPU emulations
  of the tensor-core kernels' arithmetic (K3 f32, K4).

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

# the curve check's protocols (the paper's full batch, aggregated leaf by
# leaf; minibatch 128 on the flat, fused path) and where the reference's
# curves live
from repro_torch.curves import PROTOCOLS, REFERENCE as FIG2_REF_DIR, TASKS

CIFAR_REF_DIR, CIFAR_PROTOCOLS = TASKS["cifar_conv"]

ROOT = Path(__file__).resolve().parents[1]
SCHEME_FIELDS = ("gamma", "alpha", "p", "thresholds", "noise_over_alpha",
                 "n0", "mask", "bmax", "gmax", "dropout_aware")
CHUNK_CASES = ((30, 10, 1), (31, 10, 1), (4, 2, 1), (7, 3, 0), (1, 5, 1))
FIG2_SCHEMES = ("ideal", "opc", "sca", "lcpc", "vanilla", "bbfl_interior",
                "bbfl_alternative")
# the reference fleet's variants: minibatch and flat (fused, unfused, int8
# uplink), and the paper's full-batch protocol, aggregated leaf by leaf
FLEET_VARIANTS = {"fused": {}, "unfused": {"fuse_round": False},
                  "int8": {"uplink_dtype": "int8"},
                  "full_batch": {"batch_size": 0, "flat": False}}


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
    kw = dict(kw)
    run = task.run_config(num_rounds=cfg["rounds"], eval_every=cfg["every"],
                          seed=0, batch_size=kw.pop("batch_size", cfg["batch"]))
    res = driver.run_fleet_task(task, schemes, dep.gains, run, task_data=td,
                                params=params0, seeds=tuple(cfg["seeds"]),
                                flat=kw.pop("flat", True), **kw)
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

_SCA_CHILD = r'''
import json, sys
cfg = json.loads(sys.argv[1])
import numpy as np
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
from repro import tasks
from repro.core import channel, power_control as pcm, theory
from repro.core.theory import OTAParams

task = tasks.get(cfg["task"])
wcfg = channel.WirelessConfig(num_devices=task.num_devices, seed=0)
dep = channel.deploy(wcfg)
prm = OTAParams(d=task.param_dim, gmax=float(task.defaults["gmax"]),
                es=wcfg.energy_per_sample, n0=wcfg.noise_psd, gains=dep.gains,
                sigma_sq=np.zeros(wcfg.num_devices), eta=0.05, lsmooth=1.0,
                kappa_sq=4.0).replace(eta=task.eta_for("sca", 0.05))
pc = pcm.make_power_control("sca", dep, prm)      # the default solver
np.savez(cfg["out"], gamma=np.asarray(pc.gamma, np.float64),
         alpha=np.float64(pc.alpha),
         thresholds=np.asarray(pc.thresholds, np.float64),
         objective=np.float64(theory.p1_objective(pc.gamma, prm)),
         d=np.int64(prm.d), eta=np.float64(prm.eta))
'''


# The reference's solvers (``repro.solvers``) at the cases of
# tests/test_solvers.py: theory parity (three families, dropout), Marcum
# Q_1, ``solve`` at the Fig.-2 world, at test_solvers' 10-device world, off
# Rayleigh and with a legacy budget, and ``solve_batch`` on its batch.  The
# scenarios' fields are saved beside the results, so the port rebuilds
# exactly the same OTAParams.
_SOLVERS_CHILD = r'''
import dataclasses, json, sys
cfg = json.loads(sys.argv[1])
import numpy as np
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
import jax.numpy as jnp
from jax.experimental import enable_x64
from repro import solvers
from repro.core import channel
from repro.core.channel import FadingSpec
from repro.core.theory import OTAParams
from repro.solvers import theory_jax as tj

FIELDS = ("d", "gmax", "es", "n0", "gains", "sigma_sq", "eta", "lsmooth",
          "kappa_sq", "dropout")
out = {}

def prm_of(gains, d=10000, gmax=10.0, sigma=0.0, eta=0.05, kappa_sq=4.0,
           fading=None, dropout=0.0):           # tests/helpers.py::make_prm
    gains = np.asarray(gains, dtype=np.float64)
    w = channel.WirelessConfig(num_devices=len(gains))
    return OTAParams(d=d, gmax=gmax, es=w.energy_per_sample, n0=w.noise_psd,
                     gains=gains, sigma_sq=np.full(len(gains), sigma),
                     eta=eta, lsmooth=1.0, kappa_sq=kappa_sq, fading=fading,
                     dropout=dropout)

def random_prm(seed, n, family):                # tests/test_solvers.py
    rng = np.random.default_rng(seed)
    gains = channel.average_gain(rng.uniform(80.0, 1750.0, size=n))
    fading = None
    if family == "rician":
        fading = FadingSpec(family="rician",
                            rician_k=rng.uniform(0.2, 12.0, size=n))
    elif family == "nakagami":
        fading = FadingSpec(family="nakagami",
                            nakagami_m=rng.uniform(0.6, 4.0, size=n))
    return prm_of(gains, d=814090, sigma=float(rng.uniform(0.0, 2.0)),
                  kappa_sq=float(rng.uniform(0.5, 16.0)), fading=fading)

def save_prm(tag, prm):
    for f in FIELDS:
        out["%s/prm/%s" % (tag, f)] = np.asarray(getattr(prm, f), np.float64)
    fam = "rayleigh" if prm.fading is None else prm.fading.family
    out["%s/prm/family" % tag] = np.asarray(fam)
    if fam == "rician":
        out["%s/prm/fparam" % tag] = np.asarray(prm.fading.rician_k)
    elif fam == "nakagami":
        out["%s/prm/fparam" % tag] = np.asarray(prm.fading.nakagami_m)

for tag, (seed, n, family, dropout) in cfg["theory"].items():
    prm = random_prm(seed, n, family).replace(dropout=dropout)
    save_prm(tag, prm)
    with enable_x64():
        pj = tj.from_ota(prm)
        gm = tj.gamma_max(pj)
        gamma = 0.7 * gm
        out[tag + "/gamma_max"] = np.asarray(gm)
        out[tag + "/alpha_max"] = np.asarray(tj.alpha_max(pj))
        out[tag + "/gamma"] = np.asarray(gamma)
        out[tag + "/alpha_of_gamma"] = np.asarray(tj.alpha_of_gamma(gamma, pj))
        out[tag + "/log_alpha_of_gamma"] = np.asarray(
            tj.log_alpha_of_gamma(gamma, pj))
        out[tag + "/chi_threshold"] = np.asarray(tj.chi_threshold(gamma, pj))
        for k, v in tj.zeta_terms(gamma, pj).items():
            out[tag + "/zeta/" + k] = np.asarray(v)
        _, _, pm = tj.participation(gamma, pj)
        out[tag + "/bias_term"] = np.asarray(tj.bias_term(pm, pj))
        out[tag + "/p1_objective"] = np.asarray(tj.p1_objective(gamma, pj))

with enable_x64():
    a = jnp.asarray([0.0, 0.3, 1.0, 3.0, 7.0], jnp.float64)[:, None]
    b = jnp.asarray([0.1, 0.5, 1.0, 2.0, 5.0], jnp.float64)[None, :]
    out["marcum/a"] = np.asarray(jnp.broadcast_to(a, (5, 5)))
    out["marcum/b"] = np.asarray(jnp.broadcast_to(b, (5, 5)))
    out["marcum/q"] = np.asarray(tj.marcum_q1(jnp.broadcast_to(a, (5, 5)),
                                              jnp.broadcast_to(b, (5, 5))))

def fig2_world():
    w = channel.WirelessConfig(num_devices=10, seed=0)
    dep = channel.deploy(w)
    return OTAParams(d=814090, gmax=10.0, es=w.energy_per_sample,
                     n0=w.noise_psd, gains=dep.gains, sigma_sq=np.zeros(10),
                     eta=0.06, lsmooth=1.0, kappa_sq=4.0)

solve_cases = {
    "fig2_world": (fig2_world(), {}),
    "prm10": (prm_of(channel.deploy(channel.WirelessConfig(
        num_devices=10, seed=0)).gains, d=814090), {}),
    "rician": (random_prm(1, 8, "rician"), {}),
    "nakagami": (random_prm(1, 8, "nakagami"), {}),
    "legacy_budget": (prm_of(channel.deploy(channel.WirelessConfig(
        num_devices=8, seed=2)).gains, d=10000),
        {"max_iters": 8, "tol": 1e-5}),
}
for tag in cfg["solve"]:
    prm, budget = solve_cases[tag]
    save_prm(tag, prm)
    res = solvers.solve(prm, cfg=dataclasses.replace(solvers.DEFAULT_CONFIG,
                                                     **budget))
    for f in ("gamma", "p", "alpha", "objective", "history", "converged"):
        out[tag + "/" + f] = np.asarray(getattr(res, f))

# the reference against itself: one gain moved by one ulp
prm = fig2_world()
gains = prm.gains.copy()
gains[3] = np.nextafter(gains[3], 1.0)
res = solvers.solve(prm.replace(gains=gains))
for f in ("gamma", "alpha", "objective", "history"):
    out["fig2_world_ulp/" + f] = np.asarray(getattr(res, f))

prms = [random_prm(s, 8, "rayleigh") for s in range(cfg["batch"])]
for i, prm in enumerate(prms):
    save_prm("batch%d" % i, prm)
br = solvers.solve_batch(prms)
for f in ("gamma", "p", "alpha", "objective", "history", "converged"):
    out["batch/" + f] = np.asarray(getattr(br, f))
np.savez(cfg["out"], **out)
'''

# theory parity cases: tag -> (seed, N, family, dropout)
THEORY_CASES = {f"{fam}-{seed}-{n}": (seed, n, fam, 0.0)
                for fam in ("rayleigh", "rician", "nakagami")
                for seed, n in ((0, 5), (7, 10))}
THEORY_CASES.update({f"{fam}-dropout": (3, 8, fam, 0.15)
                     for fam in ("rayleigh", "rician", "nakagami")})
SOLVE_CASES = ("fig2_world", "prm10", "rician", "nakagami", "legacy_budget")
BATCH_ROWS = 5


def run_reference_solvers(out_path: Path, timeout: float = 900.0) -> dict:
    """``repro.solvers`` (theory_jax, solve, solve_batch) at the cases of
    tests/test_solvers.py, in a child process; see ``_SOLVERS_CHILD``."""
    cfg = dict(theory={k: list(v) for k, v in THEORY_CASES.items()},
               solve=list(SOLVE_CASES), batch=BATCH_ROWS, out=str(out_path))
    return _run_child(_SOLVERS_CHILD, cfg, "reference solvers", timeout)


def ota_params(blob: dict, tag: str):
    """The port's ``OTAParams`` of a scenario the solvers child saved."""
    from repro_torch.core.channel import FadingSpec
    from repro_torch.core.theory import OTAParams
    f = prefixed(blob, f"{tag}/prm")
    family = str(f["family"])
    fading = None
    if family == "rician":
        fading = FadingSpec(family="rician", rician_k=f["fparam"])
    elif family == "nakagami":
        fading = FadingSpec(family="nakagami", nakagami_m=f["fparam"])
    return OTAParams(d=int(f["d"]), gmax=float(f["gmax"]), es=float(f["es"]),
                     n0=float(f["n0"]), gains=f["gains"],
                     sigma_sq=f["sigma_sq"], eta=float(f["eta"]),
                     lsmooth=float(f["lsmooth"]),
                     kappa_sq=float(f["kappa_sq"]), fading=fading,
                     dropout=float(f["dropout"]))


_TASKS_CHILD = r'''
import json, sys
cfg = json.loads(sys.argv[1])
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
from repro import tasks

out = {"names": list(tasks.names()),
       "fleet": list(tasks.names(runtime="fleet")),
       "steps": list(tasks.names(runtime="steps")),
       "paper_mlp_small": tasks.get("paper_mlp", hidden=16).param_dim,
       "cifar_conv_small": tasks.get("cifar_conv",
                                     **cfg["cifar_kw"]).param_dim}
for name in ("paper_mlp", "cifar_conv", "token_stream"):
    t = tasks.get(name)
    out[name] = {"num_devices": t.num_devices, "param_dim": t.param_dim,
                 "defaults": t.defaults, "scheme_etas": t.scheme_etas,
                 "runtime": t.runtime, "artifact_tag": t.artifact_tag}
lm = tasks.get("token_stream", **cfg["lm_kw"])
out["token_stream_kw"] = {"param_dim": lm.param_dim,
                          "num_devices": lm.num_devices}
with open(cfg["out"], "w") as f:
    json.dump(out, f)
'''


# a token_stream task off its defaults: mamba2's smoke at d_model 128,
# 3 layers, 3 clients
LM_TASK_KW = dict(arch="mamba2-1.3b", d_model=128, n_layers=3, clients=3,
                  per_client_batch=2, seq=16)


def run_reference_tasks(out_path: Path, timeout: float = 300.0) -> dict:
    """The reference's task registry (``repro.tasks``): its names, by
    runtime, and its tasks' bundle constants (token_stream's also at
    ``LM_TASK_KW``), in a child process."""
    _child(_TASKS_CHILD, {"out": str(out_path), "cifar_kw": CIFAR_SMOKE_KW,
                          "lm_kw": LM_TASK_KW},
           "reference tasks", timeout)
    with open(out_path) as f:
        return json.load(f)


def run_reference_fleet(out_path: Path, *, hidden: int = 16,
                        samples_per_class: int = 40, batch: int = 8,
                        rounds: int = 4, every: int = 2, seeds=(0, 1),
                        schemes=FIG2_SCHEMES, variants=None,
                        timeout: float = 600.0) -> dict:
    """Run ``repro.fl.driver.run_fleet_task`` on a shrunk paper_mlp in a
    child process (JAX on the CPU) and return what it wrote: initial
    params, scheme design leaves, per-variant params/traces/evals, the
    draws it consumed ([T, S, ...]), and ``engine.chunk_lengths`` for each
    (num_rounds, eval_every, with_eval) of ``CHUNK_CASES``.  A variant's
    keywords go to ``run_fleet_task``, except ``batch_size`` (default
    ``batch``) and ``flat`` (default True)."""
    variants = variants if variants is not None else FLEET_VARIANTS
    cfg = dict(hidden=hidden, samples_per_class=samples_per_class,
               batch=batch, rounds=rounds, every=every, seeds=list(seeds),
               schemes=list(schemes), variants=variants, out=str(out_path),
               chunk_cases=[list(c) for c in CHUNK_CASES],
               tests=str(ROOT / "tests"))
    return _run_child(_CHILD, cfg, "reference fleet", timeout)


def run_reference_sca(out_path: Path, timeout: float = 300.0,
                      task: str = "paper_mlp") -> dict:
    """The reference's default SCA design (``make_power_control("sca",
    ...)``, the batched JAX solver) in a child process, at ``task``'s
    full-width Fig.-2 world: the task's d (paper_mlp 814,090, cifar_conv
    268,650), the fig2 deployment, eta = ``task.eta_for("sca", 0.05)``.
    Returns gamma, alpha, thresholds, the (P1) objective
    (``repro.core.theory.p1_objective``), d and eta."""
    return _run_child(_SCA_CHILD, {"out": str(out_path), "task": task},
                      "reference sca", timeout)


def _run_child(script: str, cfg: dict, what: str, timeout: float) -> dict:
    """Run ``script`` with the shim in a child process (JAX on the CPU) and
    return the arrays it saved to ``cfg["out"]``."""
    _child(script, cfg, what, timeout)
    with np.load(cfg["out"]) as f:
        return {k: f[k] for k in f.files}


def _child(script: str, cfg: dict, what: str, timeout: float) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script, json.dumps(cfg)],
                          env=env, cwd=str(ROOT), capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed:\n{proc.stderr[-4000:]}")


# The reference's Fig.-2 run of one seed and one protocol.  ``save=False``
# is load-bearing: with ``save=True`` ``benchmarks.fig2.run`` would
# overwrite the committed experiments/fig2/histories_seed0.json.
_FIG2_CHILD = r'''
import json, sys, time
cfg = json.loads(sys.argv[1])
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
from benchmarks import fig2

t0 = time.time()
hist = fig2.run(num_rounds=cfg["rounds"], eval_every=cfg["every"],
                seed=cfg["seed"], batch_size=cfg["batch"], task=cfg["task"],
                save=False)
with open(cfg["out"], "w") as f:
    json.dump({"histories": hist, "cpu_wall_s": time.time() - t0}, f)
'''



def run_reference_fig2(out_path: Path, *, seed: int, batch: int,
                       rounds: int = 150, every: int = 10,
                       task: str = "paper_mlp",
                       timeout: float = 3600.0) -> dict:
    """``benchmarks.fig2.run(..., save=False)`` of ``task`` for one seed and
    one protocol (``batch`` 0: full batch; > 0: minibatch, flat) in a
    child process.  Returns ``{"histories": {scheme: [eval rows]},
    "cpu_wall_s": the child's wall on the CPU}``."""
    cfg = dict(seed=int(seed), batch=int(batch), rounds=int(rounds),
               every=int(every), task=task, out=str(out_path))
    _child(_FIG2_CHILD, cfg, "reference fig2", timeout)
    with open(out_path) as f:
        return json.load(f)


# The reference's scenario sweep (``benchmarks.scenario_sweep``): the
# Theorem-1 rows of every registered scenario x (sca, lcpc, zero_bias) at
# the sweep's defaults, and each scenario's ``sca`` design, recorded as the
# sweep makes it (the default solver, one solve per scenario).
_SCN_THEORY_CHILD = r'''
import json, sys, time
cfg = json.loads(sys.argv[1])
import numpy as np
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
from benchmarks import scenario_sweep as ss
from repro.core import scenarios as scn

designs, orig = [], ss.pcm.make_power_control

def recording(name, dep, prm, **kw):
    pc = orig(name, dep, prm, **kw)
    if name == "sca":
        designs.append({f: np.asarray(getattr(pc, f), np.float64).tolist()
                        for f in ("gamma", "alpha", "p", "thresholds")})
    return pc

ss.pcm.make_power_control = recording
names = list(scn.scenario_names())
t0 = time.time()
rows = ss.sweep(names, seed=cfg["seed"])
with open(cfg["out"], "w") as f:
    json.dump({"scenarios": names, "schemes": list(ss.SCHEMES),
               "seed": cfg["seed"], "d": 814090, "gmax": 10.0, "eta": 0.05,
               "kappa_sq": 4.0, "rows": rows,
               "sca_designs": dict(zip(names, designs)),
               "cpu_wall_s": time.time() - t0}, f, indent=1)
'''

# One seed of the reference's [scenario x scheme x seed] grid fleet
# (``benchmarks.scenario_sweep._grid_fleet``) at full width: paper_mlp, the
# task's own batch (full batch), eta 0.05, flat.  The grid shares ONE
# initial parameter draw across all its cells, which its seeds do not vary;
# the child starts from the port's draw (``cfg["params"]``, written by the
# parent from ``repro_torch``'s ``task.init_params(0)``), so that the
# curve check compares the two engines from the same weights rather than
# two fixed init draws.
_SCN_GRID_CHILD = r'''
import json, sys, time
cfg = json.loads(sys.argv[1])
import numpy as np
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
from benchmarks import scenario_sweep as ss
from repro import tasks

t0 = time.time()
task = tasks.get("paper_mlp", expect_runtime="fleet")
td = task.build_data(0)
run = task.run_config(eta=0.05, num_rounds=cfg["rounds"],
                      eval_every=cfg["every"], seed=0,
                      batch_size=int(task.defaults.get("batch_size", 0)))
with np.load(cfg["params"]) as f:
    params0 = {k: jax.numpy.asarray(f[k]) for k in f.files}
res = ss._grid_fleet(task, tuple(cfg["scenarios"]), tuple(cfg["schemes"]),
                     run, (cfg["seed"],), task_data=td, params=params0,
                     eval_fn=task.make_eval(td))
hist = {name: [{"round": int(t), "acc": float(ev["acc"][i, 0]),
                "global_loss": float(ev["global_loss"][i, 0])}
               for t, ev in res.evals]
        for i, name in enumerate(res.names)}
with open(cfg["out"], "w") as f:
    json.dump({"histories": hist, "cpu_wall_s": time.time() - t0}, f)
'''

# The reference's scenario layer at every registered scenario: ``realize``
# and ``make_ota_params``; the standalone ``FadingProcess`` stepped from a
# seed's key as the driver steps it, with the random numbers each step
# consumed, pulled with the step's own keys (the normals of
# ``ota.draw_fading``, Nakagami's Gamma variates and phase uniforms, the
# dropout uniforms and keep mask); and ``AdaptiveSCA``'s redesign of a
# given state (the default solver) for the scenarios named in
# ``cfg["redesign"]``.
_SCN_WORLDS_CHILD = r'''
import json, sys
cfg = json.loads(sys.argv[1])
import numpy as np
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
from jax import random as jr
from repro.core import power_control as pcm, scenarios as scn
from repro.fl.engine import FADING_INIT_SALT

FIELDS = ("d", "gmax", "es", "n0", "gains", "sigma_sq", "eta", "lsmooth",
          "kappa_sq", "dropout")
out = {}
for name in scn.scenario_names():
    sc = scn.get_scenario(name)
    dep = scn.realize(sc, seed=cfg["seed"])
    n = dep.num_devices
    out[name + "/distances"] = dep.distances
    out[name + "/gains"] = dep.gains
    out[name + "/shadowing_db"] = (np.zeros(0) if dep.shadowing_db is None
                                   else dep.shadowing_db)
    out[name + "/p_dropout"] = np.float64(dep.p_dropout)
    prm = scn.make_ota_params(dep, d=cfg["d"], gmax=10.0, eta=0.05,
                              kappa_sq=4.0)
    for f in FIELDS:
        out["%s/prm/%s" % (name, f)] = np.asarray(getattr(prm, f), np.float64)
    out[name + "/prm/family"] = np.asarray(
        "rayleigh" if prm.fading is None else prm.fading.family)
    fp = scn.make_fading_process(dep, sc.dynamics)
    key = jr.PRNGKey(cfg["seed"])
    ikey = jr.fold_in(key, FADING_INIT_SALT)
    state = fp.init(ikey)
    kr, ki = jr.split(ikey)
    out[name + "/init/n_re"] = np.asarray(jr.normal(kr, (n,)))
    out[name + "/init/n_im"] = np.asarray(jr.normal(ki, (n,)))
    out[name + "/init/state"] = np.asarray(state)
    dynamic = fp.rho > 0.0 or fp.p_dropout > 0.0
    for t in range(cfg["steps"]):
        key, sub = jr.split(key)
        new_state, h = fp.step(state, sub)
        k_fade, k_drop = jr.split(sub) if dynamic else (sub, None)
        p = "%s/step%d/" % (name, t)
        if fp.family == "nakagami":
            kp, kph = jr.split(k_fade)
            out[p + "gamma"] = np.asarray(jr.gamma(kp, fp.m, shape=(n,)))
            out[p + "phase_u"] = np.asarray(jr.uniform(kph, (n,)))
        else:
            kr, ki = jr.split(k_fade)
            out[p + "n_re"] = np.asarray(jr.normal(kr, (n,)))
            out[p + "n_im"] = np.asarray(jr.normal(ki, (n,)))
        if fp.p_dropout > 0.0:
            out[p + "drop_u"] = np.asarray(jr.uniform(k_drop, (n,)))
            out[p + "keep"] = np.asarray(
                jr.bernoulli(k_drop, 1.0 - fp.p_dropout, (n,)))
        out[p + "state_in"] = np.asarray(state)
        out[p + "state"] = np.asarray(new_state)
        out[p + "h"] = np.asarray(h)
        state = new_state
    if name in cfg["redesign"]:
        pc = pcm.make_adaptive_sca(dep, prm)
        keys = jr.split(jr.PRNGKey(7), cfg["redesign_rows"])
        st = np.asarray(fp.init_batch(keys))
        new = pc.redesign_fn(pc, fp, st)
        out[name + "/redesign/state"] = st
        for f in ("gamma", "alpha", "p", "thresholds", "noise_over_alpha"):
            out[name + "/redesign/" + f] = np.asarray(getattr(new, f),
                                                      np.float64)
np.savez(cfg["out"], **out)
'''

# The reference's fleets on scenario worlds (shrunk paper_mlp, minibatch,
# flat): a grid over ``cfg["grid"]`` x (sca, lcpc, zero_bias) through
# ``run_fleet(scenarios=...)`` (and the same grid at full batch, the
# card's protocol), and one fleet per ``cfg["fleets"]``
# scenario on its fading process with the Fig.-2 schemes (the global-CSI
# ones dropout-aware where the scenario drops devices).  Beside each: the
# per-row h it consumed, [T, R, S, N], from the driver's key recipe (the
# standalone process of each row; the reference pins the stack rows
# bitwise to them), the noise and minibatch draws, and the designs.
_SCN_FLEETS_CHILD = r'''
import json, sys
cfg = json.loads(sys.argv[1])
import numpy as np
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
from jax import random as jr
from repro.core import ota, power_control as pcm, scenarios as scn
from repro.fl import driver
from repro.fl.engine import FADING_INIT_SALT
from repro.tasks.image import make_paper_mlp
sys.path.insert(0, cfg["tests"])
import torch_ref

task = make_paper_mlp(hidden=cfg["hidden"],
                      samples_per_class=cfg["samples_per_class"])
td = task.build_data(0)
params0 = task.init_params(0)
seeds, T = cfg["seeds"], cfg["rounds"]
run = task.run_config(eta=0.05, num_rounds=T, eval_every=cfg["every"],
                      seed=0, batch_size=cfg["batch"])
out = {}
for k, v in params0.items():
    out["params0/" + k] = np.asarray(v)

def world(name, schemes):
    sc = scn.get_scenario(name)
    dep = scn.realize(sc, seed=0)
    prm = scn.make_ota_params(dep, d=task.param_dim, gmax=10.0, eta=0.05,
                              kappa_sq=4.0)
    pcs = [pcm.make_power_control(s, dep, prm, **(
        {"method": "scipy"} if s == "sca" else {})) for s in schemes]
    return sc, dep, pcs

def row_h(names):
    """[T, R, S, N]: each row's standalone process on the driver's keys."""
    hs = []
    for name in names:
        sc = scn.get_scenario(name)
        fp = scn.make_fading_process(scn.realize(sc, seed=0), sc.dynamics)
        per_seed = []
        for s in seeds:
            key = jr.PRNGKey(s)
            state = fp.init(jr.fold_in(key, FADING_INIT_SALT))
            h_t = []
            for _ in range(T):
                key, sub = jr.split(key)
                k_fade = jr.split(sub, 3)[0]
                state, h = fp.step(state, k_fade)
                h_t.append(np.asarray(h))
            per_seed.append(h_t)
        hs.append(per_seed)
    return np.transpose(np.asarray(hs), (2, 0, 1, 3))

def save(tag, res, pcs):
    for k, v in res.params.items():
        out["%s/params/%s" % (tag, k)] = np.asarray(v)
    for k, v in res.traces.items():
        out["%s/traces/%s" % (tag, k)] = np.asarray(v)
    out["%s/evals_t" % tag] = np.asarray([t for t, _ in res.evals])
    for k in res.evals[0][1]:
        out["%s/evals/%s" % (tag, k)] = np.stack(
            [np.asarray(ev[k]) for _, ev in res.evals])
    for i, pc in enumerate(pcs):
        for f, v in torch_ref.scheme_fields(pc).items():
            out["%s/scheme%d/%s" % (tag, i, f)] = v
        out["%s/scheme%d/name" % (tag, i)] = np.asarray(pc.name)

pcs = []
for name in cfg["grid"]:
    pcs += world(name, cfg["grid_schemes"])[2]
stack = scn.stack_scenarios(cfg["grid"], seed=0)
res = driver.run_fleet_task(task, pcs, None, run, task_data=td,
                            params=params0, seeds=tuple(seeds), flat=True,
                            etas=[0.05] * len(pcs), scenarios=stack)
save("grid", res, pcs)
full = task.run_config(eta=0.05, num_rounds=T, eval_every=cfg["every"],
                       seed=0, batch_size=0)
res = driver.run_fleet_task(task, pcs, None, full, task_data=td,
                            params=params0, seeds=tuple(seeds), flat=True,
                            etas=[0.05] * len(pcs), scenarios=stack)
save("grid_full_batch", res, pcs)
out["grid/names"] = np.asarray(res.names)
out["grid/h"] = row_h(cfg["grid"])
for name in cfg["fleets"]:
    sc, dep, fl_pcs = world(name, cfg["fleet_schemes"])
    res = driver.run_fleet_task(
        task, fl_pcs, dep.gains, run, task_data=td, params=params0,
        seeds=tuple(seeds), flat=True, etas=[0.05] * len(fl_pcs),
        fading=scn.make_fading_process(dep, sc.dynamics))
    save(name, res, fl_pcs)
    out[name + "/h"] = row_h([name])
sizes = [int(np.asarray(params0[k]).size) for k in sorted(params0)]
x_dev = td.train[0]
draws = torch_ref.reference_draws(jr, ota, np.ones(x_dev.shape[0]), seeds,
                                  T, sizes, x_dev.shape[0], cfg["batch"],
                                  x_dev.shape[1])
for k in ("z", "idx", "coin"):
    out["draws/" + k] = draws[k]
np.savez(cfg["out"], **out)
'''

SCN_GRID_TEST = ("disk_rayleigh", "disk_rician", "disk_nakagami",
                 "urban_canyon")
SCN_FLEET_TEST = ("disk_dropout", "urban_canyon")


def run_reference_scenario_worlds(out_path: Path, *, seed: int = 0,
                                  steps: int = 3, d: int = 814090,
                                  redesign=("disk_markov",),
                                  redesign_rows: int = 2,
                                  timeout: float = 900.0) -> dict:
    """The reference's scenario layer in a child process: per registered
    scenario, its deployment, OTA params and ``steps`` fading steps with
    the random numbers they consumed; the redesign of a given state for
    the ``redesign`` scenarios.  See ``_SCN_WORLDS_CHILD``."""
    cfg = dict(seed=seed, steps=steps, d=d, redesign=list(redesign),
               redesign_rows=redesign_rows, out=str(out_path))
    return _run_child(_SCN_WORLDS_CHILD, cfg, "reference scenario worlds",
                      timeout)


def run_reference_scenario_fleets(out_path: Path, *, hidden: int = 16,
                                  samples_per_class: int = 40,
                                  batch: int = 8, rounds: int = 4,
                                  every: int = 2, seeds=(0, 1),
                                  grid=SCN_GRID_TEST,
                                  fleets=SCN_FLEET_TEST,
                                  timeout: float = 900.0) -> dict:
    """The reference's grid and scenario fleets on a shrunk paper_mlp, in
    a child process.  See ``_SCN_FLEETS_CHILD``."""
    cfg = dict(hidden=hidden, samples_per_class=samples_per_class,
               batch=batch, rounds=rounds, every=every, seeds=list(seeds),
               grid=list(grid), grid_schemes=list(SCN_SCHEMES),
               fleets=list(fleets), fleet_schemes=list(FIG2_SCHEMES),
               tests=str(ROOT / "tests"), out=str(out_path))
    return _run_child(_SCN_FLEETS_CHILD, cfg, "reference scenario fleets",
                      timeout)


SCN_REF_DIR = ROOT / "experiments" / "scenario_reference"
SCN_FAMILIES = ("disk_rayleigh", "disk_rician", "disk_shadowed",
                "two_cluster")
SCN_SCHEMES = ("sca", "lcpc", "zero_bias")
SCN_ROUNDS, SCN_EVERY = 100, 20


def write_scenario_theory(out_dir: Path = SCN_REF_DIR, seed: int = 0) -> str:
    """experiments/scenario_reference/theory_seed<seed>.json: the
    reference's sweep over every registered scenario, with its designs."""
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"theory_seed{seed}.json"
    _child(_SCN_THEORY_CHILD, {"seed": seed, "out": str(path)},
           "reference scenario theory", 3600.0)
    with open(path) as f:
        wall = json.load(f)["cpu_wall_s"]
    return f"theory seed {seed}: {wall:.1f} s (reference on the CPU)"


def _scn_grid_job(job) -> str:
    seed, out_dir = job
    import tempfile
    from repro_torch import tasks
    task = tasks.get("paper_mlp", expect_runtime="fleet")
    with tempfile.TemporaryDirectory() as tmp:
        out, params = Path(tmp) / "grid.json", Path(tmp) / "params0.npz"
        np.savez(params, **to_numpy(task.init_params(0, torch.device("cpu"))))
        _child(_SCN_GRID_CHILD, dict(seed=int(seed), rounds=SCN_ROUNDS,
                                     every=SCN_EVERY,
                                     scenarios=list(SCN_FAMILIES),
                                     schemes=list(SCN_SCHEMES),
                                     params=str(params), out=str(out)),
               "reference scenario grid", 7200.0)
        with open(out) as f:
            got = json.load(f)
    _write_json(Path(out_dir) / "grid" / f"histories_seed{seed}.json",
                got["histories"])
    return f"grid seed {seed}: {got['cpu_wall_s']:.1f} s (reference on the CPU)"


# The reference's population mode and single-run API on a shrunk paper_mlp
# (hidden 16, minibatch or full batch).  Part "population":
# ``run_fleet(population=...)`` of the cohort-sized (10-device) Fig.-2
# world's (sca, lcpc, zero_bias) over a parametric traffic-weighted
# population, with its cohort trace and the h it consumed, rebuilt from the
# driver's keys on each round's cohort gains ([T, S, N]);
# ``AdaptiveSCA.redesign_cohort_fn`` on the tick-0 cohorts' gains; and
# ``engine.chunk_lengths`` with cohort boundaries.  Part "run_fl":
# ``run_fl`` of sca at seed 0 with its draws, and the legacy loop's host
# minibatches (``server._sample_batches``).
_POP_CHILD = r"""
import json, sys
cfg = json.loads(sys.argv[1])
import numpy as np
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
from jax import random as jr
from repro.core import channel, ota, power_control as pcm, scenarios as scn
from repro.core.theory import OTAParams
from repro.fl import driver, server
from repro.tasks.image import make_paper_mlp
sys.path.insert(0, cfg["tests"])
import torch_ref

task = make_paper_mlp(hidden=cfg["hidden"],
                      samples_per_class=cfg["samples_per_class"])
td = task.build_data(0)
params0 = task.init_params(0)
w = channel.WirelessConfig(num_devices=cfg["cohort"], seed=0)
dep = channel.deploy(w)
prm = OTAParams(d=task.param_dim, gmax=10.0, es=w.energy_per_sample,
                n0=w.noise_psd, gains=dep.gains,
                sigma_sq=np.zeros(cfg["cohort"]), eta=0.05, lsmooth=1.0,
                kappa_sq=4.0)
pcs = [pcm.make_power_control(n, dep, prm, **(
    {"method": "scipy"} if n == "sca" else {})) for n in cfg["schemes"]]
pop = scn.Population(spec=scn.PopulationSpec(
    size=cfg["size"], shadowing=scn.ShadowingSpec(), sampling="traffic",
    seed=cfg["pop_seed"]))
seeds, T = cfg["seeds"], cfg["rounds"]
out = {"gains": dep.gains}
for k, v in params0.items():
    out["params0/" + k] = np.asarray(v)
for i, pc in enumerate(pcs):
    for f, v in torch_ref.scheme_fields(pc).items():
        out["scheme%d/%s" % (i, f)] = v
    out["scheme%d/name" % i] = np.asarray(pc.name)
sizes = [int(np.asarray(params0[k]).size) for k in sorted(params0)]
x_dev, y_dev = td.train
if "population" in cfg["parts"]:
    for tag, batch, flat in (("minibatch", cfg["batch"], True),
                             ("full_batch", 0, False)):
        run = task.run_config(eta=0.05, num_rounds=T,
                              eval_every=cfg["every"], seed=0,
                              batch_size=batch)
        res = driver.run_fleet_task(
            task, pcs, dep.gains, run, task_data=td, params=params0,
            seeds=tuple(seeds), flat=flat, etas=[0.05] * len(pcs),
            population=pop, cohort_size=cfg["cohort"],
            cohort_rounds=cfg["cohort_rounds"], stream=False)
        for k, v in res.params.items():
            out["%s/params/%s" % (tag, k)] = np.asarray(v)
        for k, v in res.traces.items():
            out["%s/traces/%s" % (tag, k)] = np.asarray(v)
        out["%s/evals_t" % tag] = np.asarray([t for t, _ in res.evals])
        for k in res.evals[0][1]:
            out["%s/evals/%s" % (tag, k)] = np.stack(
                [np.asarray(ev[k]) for _, ev in res.evals])
        out["%s/cohorts_t" % tag] = np.asarray([t for t, _ in res.cohorts])
        out["%s/cohorts_idx" % tag] = np.stack([i for _, i in res.cohorts])
    cohorts = res.cohorts
    hs = []
    for si, s in enumerate(seeds):
        key, h_t = jr.PRNGKey(s), []
        for t in range(T):
            key, sub = jr.split(key)
            idx = [i for t0, i in cohorts if t0 <= t][-1][si]
            h_t.append(np.asarray(ota.draw_fading(
                jr.split(sub, 3)[0], jax.numpy.asarray(pop.gains_of(idx)))))
        hs.append(h_t)
    out["h"] = np.swapaxes(np.asarray(hs), 0, 1)             # [T, S, N]
    draws = torch_ref.reference_draws(jr, ota, np.ones(cfg["cohort"]),
                                      seeds, T, sizes, cfg["cohort"],
                                      cfg["batch"], x_dev.shape[1])
    for k in ("z", "idx", "coin"):
        out["draws/" + k] = draws[k]
    # the cohort redesign of the tick-0 cohorts
    ad = pcm.make_adaptive_sca(dep, prm)
    g0 = np.stack([pop.gains_of(pop.draw_cohort(cfg["cohort"], 0, s))
                   for s in seeds])
    new = ad.redesign_cohort_fn(ad, g0)
    out["redesign/gains"] = g0
    for f in ("gamma", "alpha", "p", "thresholds", "noise_over_alpha"):
        out["redesign/" + f] = np.asarray(getattr(new, f), np.float64)
    from repro.fl.engine import chunk_lengths
    for case in cfg["chunk_cases"]:
        out["chunk_lengths/%d-%d-%d" % tuple(case)] = np.asarray(
            chunk_lengths(case[0], case[1], True, cohort_rounds=case[2]),
            np.int64)
if "run_fl" in cfg["parts"]:
    # run_fl: sca, seed 0, on the 10-device data world, with its draws
    single = torch_ref.reference_draws(jr, ota, dep.gains, [0], T, sizes,
                                       x_dev.shape[0], cfg["batch"],
                                       x_dev.shape[1])
    for k, v in single.items():
        out["run_fl/draws/" + k] = v
    for tag, batch, flat in (("minibatch", cfg["batch"], True),
                             ("full_batch", 0, False)):
        run = task.run_config(eta=0.05, num_rounds=T,
                              eval_every=cfg["every"], seed=0,
                              batch_size=batch)
        p, hist = server.run_fl(task.loss_fn, params0, pcs[0], dep.gains,
                                td.train, run, task.make_eval(td),
                                flat=flat)
        for k, v in p.items():
            out["run_fl/%s/params/%s" % (tag, k)] = np.asarray(v)
        for k, v in hist.traces.items():
            out["run_fl/%s/traces/%s" % (tag, k)] = np.asarray(v)
        for k in ("acc", "global_loss", "round", "active"):
            out["run_fl/%s/hist/%s" % (tag, k)] = np.asarray(
                [r[k] for r in hist])
    # the legacy loop's host minibatches
    rng = np.random.default_rng(cfg["legacy_seed"])
    for t in range(T):
        xb, yb = server._sample_batches(x_dev, y_dev, cfg["batch"], rng)
        out["legacy/xb%d" % t], out["legacy/yb%d" % t] = xb, yb
np.savez(cfg["out"], **out)
"""

POP_SCHEMES = ("sca", "lcpc", "zero_bias")
# (num_rounds, eval_every, cohort_rounds): tests/test_population.py's cases
POP_CHUNK_CASES = ((9, 3, 3), (10, 4, 3), (12, 5, 4), (7, 10, 2), (6, 2, 6))


def run_reference_population(out_path: Path, *, hidden: int = 16,
                             samples_per_class: int = 40, batch: int = 8,
                             rounds: int = 4, every: int = 2,
                             cohort_rounds: int = 2, cohort: int = 10,
                             size: int = 2000, pop_seed: int = 3,
                             seeds=(0, 1), parts=("population",),
                             legacy_seed: int = 0,
                             timeout: float = 900.0) -> dict:
    """The reference's population fleet and cohort redesign (part
    "population"), or its ``run_fl`` and legacy host minibatches (part
    "run_fl"), on a shrunk paper_mlp, in a child process; see
    ``_POP_CHILD``."""
    cfg = dict(parts=list(parts), legacy_seed=legacy_seed,
               chunk_cases=[list(c) for c in POP_CHUNK_CASES],
               hidden=hidden, samples_per_class=samples_per_class,
               batch=batch, rounds=rounds, every=every,
               cohort_rounds=cohort_rounds, cohort=cohort, size=size,
               pop_seed=pop_seed, seeds=list(seeds),
               schemes=list(POP_SCHEMES), tests=str(ROOT / "tests"),
               out=str(out_path))
    return _run_child(_POP_CHILD, cfg, "reference population", timeout)


# The reference data the card's phase 10 reads: the cohorts of
# ``benchmarks.fig2.make_population(1_000_000)`` at ticks 0-4 for seeds
# 0-1 (cohort 50) with their gains, and the cohort redesigns of seed 0 at
# ticks 0 and 4 in the population benchmark's world
# (``fig2.build_world(task, 0, num_devices=50)``, ``make_schemes(...,
# ["adaptive_sca"])``); tick 4's cohort holds a device so weak (gain
# 3e-15) that the solver's first inner stage overflows.
_POP_REF_CHILD = r"""
import json, sys, time
cfg = json.loads(sys.argv[1])
import numpy as np
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
from benchmarks import fig2
from repro import tasks

t0 = time.time()
pop = fig2.make_population(cfg["size"])
cohorts = {}
for s in cfg["seeds"]:
    for tick in cfg["ticks"]:
        idx = pop.draw_cohort(cfg["cohort"], tick, s)
        cohorts["%d/%d" % (s, tick)] = {"idx": idx.tolist(),
                                        "gains": pop.gains_of(idx).tolist()}
task = tasks.get("paper_mlp", expect_runtime="fleet")
dep, prm, _ = fig2.build_world(task, 0, num_devices=cfg["cohort"])
pc = fig2.make_schemes(task, dep, prm, ["adaptive_sca"])[0]
redesigns = {}
for key in cfg["redesigns"]:
    g = np.asarray(cohorts[key]["gains"])
    new = pc.redesign_cohort_fn(pc, g[None])
    redesigns[key] = {k: np.asarray(getattr(new, k),
                                    np.float64).reshape(-1).tolist()
                      for k in ("gamma", "alpha", "p")}
with open(cfg["out"], "w") as f:
    json.dump({"size": cfg["size"], "cohort": cfg["cohort"],
               "seeds": cfg["seeds"], "ticks": cfg["ticks"],
               "describe": pop.describe(), "cohorts": cohorts,
               "redesigns": redesigns,
               "cpu_wall_s": time.time() - t0}, f, indent=1)
"""

POP_REF_DIR = ROOT / "experiments" / "population_reference"


def write_population_reference(out_dir: Path = POP_REF_DIR) -> str:
    """experiments/population_reference/population.json (see
    ``_POP_REF_CHILD``)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "population.json"
    _child(_POP_REF_CHILD, dict(size=1_000_000, cohort=50, seeds=[0, 1],
                                ticks=[0, 1, 2, 3, 4],
                                redesigns=["0/0", "0/4"], out=str(path)),
           "reference population", 3600.0)
    with open(path) as f:
        wall = json.load(f)["cpu_wall_s"]
    return f"population reference: {wall:.1f} s (reference on the CPU)"


# The reference's LM training run (``repro.launch.train.main``'s loop) at
# the example's preset, one seed, from the port's initial weights of the
# seed (an archive in the reference's stacked layout, read with the
# reference's ``checkpoint.restore``); everything else is the reference's
# own: the task's data, the world, the ``sca`` design of its default
# solver, the step's key stream from PRNGKey(seed + 1), the jitted step and
# the held-out eval.
_LM_REF_CHILD = r"""
import json, sys, time
cfg = json.loads(sys.argv[1])
import numpy as np
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
import jax.numpy as jnp
from repro import tasks
from repro.checkpoint import checkpoint as ckpt
from repro.core import power_control as pcm
from repro.core.channel import WirelessConfig, deploy
from repro.core.theory import OTAParams
from repro.launch import steps as steps_lib

p, seed = cfg["preset"], cfg["seed"]
t0 = time.time()
task = tasks.get("token_stream", expect_runtime="steps", arch=p["arch"],
                 smoke=p["smoke"], d_model=p["d_model"],
                 n_layers=p["n_layers"], clients=p["clients"],
                 per_client_batch=p["per_client_batch"], seq=p["seq"])
bundle = task.aux["bundle"]
wcfg = WirelessConfig(num_devices=p["clients"], seed=seed)
dep = deploy(wcfg)
prm = OTAParams(d=bundle.num_params, gmax=10.0, es=wcfg.energy_per_sample,
                n0=wcfg.noise_psd, gains=dep.gains,
                sigma_sq=np.zeros(p["clients"]), eta=p["eta"], lsmooth=1.0,
                kappa_sq=4.0)
scheme = pcm.make_power_control(p["scheme"], dep, prm)
step = steps_lib.make_train_step(bundle, scheme, dep.gains,
                                 steps_lib.TrainStepConfig(eta=p["eta"]))
step = jax.jit(step, donate_argnums=(0,))
params = ckpt.restore(cfg["init"], task.init_params(seed))
td = task.build_data(seed, steps=p["steps"])
eval_fn = jax.jit(task.make_eval(td))
key = jax.random.PRNGKey(seed + 1)
losses, active = [], []
for t in range(p["steps"]):
    key, sub = jax.random.split(key)
    batch = jnp.asarray(td.train[t].reshape(-1, p["seq"] + 1))
    params, metrics = step(params, batch, sub)
    losses.append(float(metrics["loss"]))
    active.append(float(metrics["active_clients"]))
held_out = float(eval_fn(params)["loss"])
with open(cfg["out"], "w") as f:
    json.dump({"seed": seed, "preset": p, "num_params": bundle.num_params,
               "losses": losses, "active_clients": active,
               "held_out_loss": held_out, "p": np.asarray(scheme.p).tolist(),
               "cpu_wall_s": time.time() - t0}, f, indent=1)
"""

LM_REF_DIR = ROOT / "experiments" / "lm_reference"

# The reference's OTA-FL train step (``repro.launch.steps.make_train_step``
# and ``make_ideal_train_step``) on smoke configs, f32, from its own
# PRNGKey(0) weights with the leaves it inits to 0 or 1 perturbed by seeded
# noise (as tests/test_torch_lm.py does), over ``steps`` steps of the
# reference's own client batches: per step the draws it consumed, by its
# recipe (``key, sub = split(key)``; ``k_fade, k_coeff, k_noise =
# split(sub, 3)``; h = ``draw_fading(k_fade, gains)``; the coin
# ``bernoulli(k_coeff, 0.5)``; leaf l's noise ``normal(split(k_noise,
# n_leaves)[l], shape_l)`` in tree-flatten order over the STACKED params),
# the metrics, and the params after the first and the last step; the same
# for the ideal step.  An encoder-decoder case's batches are the reference's
# (frames, tokens) pairs, its frames ``case_frames``.  Keys are the
# reference checkpoint's '/'-joined paths.
_TRAIN_CHILD = r"""
import json, sys
cfg = json.loads(sys.argv[1])
import numpy as np
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
import jax.numpy as jnp
from repro import configs
from repro.checkpoint.checkpoint import _flatten
from repro.core import ota, power_control as pcm
from repro.core.channel import WirelessConfig, deploy
from repro.core.theory import OTAParams
from repro.launch import steps as steps_lib
from repro.models.registry import build_bundle
from repro.tasks.lm import client_batches
sys.path.insert(0, cfg["tests"])
import torch_ref

def perturb(tree, seed=0):
    rng = np.random.default_rng(seed)
    def one(path, a):
        name = jax.tree_util.keystr(path)
        if any(t in name for t in ("'b'", "bkv", "ln", "norm", "a_log",
                                   "dt_bias", "d_skip", "conv_b")):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return jnp.asarray(a, jnp.float32)
    return jax.tree_util.tree_map_with_path(one, tree)

out = {}
for c in cfg["cases"]:
    name = c["name"]
    jcfg = configs.get_config(c["arch"]).smoke(**c["smoke"])
    bundle = build_bundle(jcfg, tp=1, dp=1)
    params0 = perturb(bundle.init(jax.random.PRNGKey(0)))
    for k, v in _flatten(params0).items():
        out[f"{name}/params0/{k}"] = v
    data = client_batches(jcfg.vocab_size, c["clients"], c["per_client"],
                          c["seq"], c["steps"], seed=c["seed"])
    out[f"{name}/data"] = data
    tokens = [jnp.asarray(data[t].reshape(-1, c["seq"] + 1))
              for t in range(c["steps"])]
    if jcfg.is_enc_dec:
        frames = torch_ref.case_frames(c, jcfg.d_model)
        tokens = [(jnp.asarray(f), tk) for f, tk in zip(frames, tokens)]
    wcfg = WirelessConfig(num_devices=c["clients"], seed=0)
    dep = deploy(wcfg)
    prm = OTAParams(d=bundle.num_params, gmax=10.0,
                    es=wcfg.energy_per_sample, n0=wcfg.noise_psd,
                    gains=dep.gains, sigma_sq=np.zeros(c["clients"]),
                    eta=c["eta"], lsmooth=1.0, kappa_sq=4.0)
    scheme = pcm.make_power_control(c["scheme"], dep, prm)
    out[f"{name}/gains"] = np.asarray(dep.gains)
    for f, v in torch_ref.scheme_fields(scheme).items():
        out[f"{name}/scheme/{f}"] = v
    tcfg = steps_lib.TrainStepConfig(eta=c["eta"])
    step = jax.jit(steps_lib.make_train_step(bundle, scheme, dep.gains, tcfg))
    gains_j = jnp.asarray(np.asarray(dep.gains), jnp.float32)
    key = jax.random.PRNGKey(c["seed"] + 1)
    params = params0
    metrics = {"loss": [], "active_clients": [], "noise_scale": []}
    for t in range(c["steps"]):
        key, sub = jax.random.split(key)
        k_fade, k_coeff, k_noise = jax.random.split(sub, 3)
        out[f"{name}/h/{t}"] = np.asarray(ota.draw_fading(k_fade, gains_j))
        out[f"{name}/coin/{t}"] = np.asarray(
            jax.random.bernoulli(k_coeff, 0.5))
        leaves, treedef = jax.tree.flatten(params)
        keys = jax.random.split(k_noise, len(leaves))
        z = jax.tree.unflatten(treedef, [jax.random.normal(k, l.shape)
                                         for k, l in zip(keys, leaves)])
        for k, v in _flatten(z).items():
            out[f"{name}/z/{t}/{k}"] = v
        params, m = step(params, tokens[t], sub)
        for k in metrics:
            metrics[k].append(np.asarray(m[k]))
        if t in (0, c["steps"] - 1):
            for k, v in _flatten(params).items():
                out[f"{name}/params/{t}/{k}"] = v
    for k, v in metrics.items():
        out[f"{name}/{k}"] = np.asarray(v)
    ideal = jax.jit(steps_lib.make_ideal_train_step(bundle, tcfg))
    params, losses = params0, []
    for t in range(c["steps"]):
        params, m = ideal(params, tokens[t], None)
        losses.append(np.asarray(m["loss"]))
        if t in (0, c["steps"] - 1):
            for k, v in _flatten(params).items():
                out[f"{name}/ideal_params/{t}/{k}"] = v
    out[f"{name}/ideal_loss"] = np.asarray(losses)
np.savez(cfg["out"], **out)
"""

# the train-step parity cases: qwen1.5-0.5b's smoke (QKV bias, GQA),
# mamba2-1.3b's (a ragged 40-token input against its chunk of 32) and
# recurrentgemma-9b's at 4 layers (RG-LRU layers under the scan and in the
# tail, a local layer whose window of 64 the 24 tokens stay inside), sca;
# and one bbfl_alternative case, whose coefficients read the coin (its
# seed's key stream draws both outcomes over the 4 steps); and
# deepseek-v3-671b's smoke (MLA, a dense lead layer and an MoE layer, the
# MTP term in the loss) for 2 steps; and seamless-m4t-medium's smoke (2
# encoder and 2 decoder layers), its batches (frames, tokens)
TRAIN_CASES = (
    dict(name="qwen", arch="qwen1.5-0.5b", smoke={}, scheme="sca", steps=4,
         clients=4, per_client=1, seq=32, eta=0.05, seed=0),
    dict(name="mamba2", arch="mamba2-1.3b", smoke={}, scheme="sca",
         steps=4, clients=2, per_client=2, seq=40, eta=0.05, seed=1),
    dict(name="recurrentgemma", arch="recurrentgemma-9b",
         smoke=dict(n_layers=4), scheme="sca", steps=4, clients=2,
         per_client=1, seq=24, eta=0.05, seed=2),
    dict(name="bbfl", arch="qwen1.5-0.5b", smoke=dict(n_layers=1),
         scheme="bbfl_alternative", steps=4, clients=4, per_client=1,
         seq=16, eta=0.05, seed=4),
    dict(name="deepseek", arch="deepseek-v3-671b", smoke={}, scheme="sca",
         steps=2, clients=2, per_client=1, seq=24, eta=0.05, seed=5),
    dict(name="seamless", arch="seamless-m4t-medium", smoke={}, scheme="sca",
         steps=4, clients=2, per_client=1, seq=24, eta=0.05, seed=6),
)


def case_frames(c: dict, d_model: int) -> np.ndarray:
    """An encoder-decoder train case's frames, [steps, gb, seq, d_model]
    float32 standard normals from the case's seed (numpy): the same on
    both sides."""
    gb = c["clients"] * c["per_client"]
    return np.random.default_rng(c["seed"]).standard_normal(
        (c["steps"], gb, c["seq"], d_model)).astype(np.float32)


def run_reference_train(out_path: Path, cases=TRAIN_CASES,
                        timeout: float = 900.0) -> dict:
    """The reference's train and ideal steps on ``cases``, with the draws
    they consumed (``_TRAIN_CHILD``), in a child process."""
    return _run_child(_TRAIN_CHILD, dict(cases=list(cases), out=str(out_path),
                                         tests=str(ROOT / "tests")),
                      "reference train step", timeout)


def _lm_ref_job(job) -> str:
    """One seed of ``write_lm_reference``."""
    import tempfile
    from repro_torch.checkpoint import checkpoint as tckpt
    from repro_torch.lm_curves import PRESET
    from repro_torch.tasks.lm import make_token_stream
    seed, out_dir = job
    task = make_token_stream(
        arch=PRESET["arch"], smoke=PRESET["smoke"],
        d_model=PRESET["d_model"], n_layers=PRESET["n_layers"],
        clients=PRESET["clients"],
        per_client_batch=PRESET["per_client_batch"], seq=PRESET["seq"],
        device="cpu")
    out = Path(out_dir) / f"losses_seed{seed}.json"
    with tempfile.TemporaryDirectory() as tmp:
        init = str(Path(tmp) / "init.npz")
        tckpt.save_lm(init, task.aux["cfg"],
                      task.init_params(seed, torch.device("cpu")))
        _child(_LM_REF_CHILD, dict(preset=PRESET, seed=int(seed), init=init,
                                   out=str(out)),
               "reference LM run", 4 * 3600.0)
    with open(out) as f:
        got = json.load(f)
    return (f"lm seed {seed}: {got['cpu_wall_s']:.1f} s (reference on the "
            f"CPU), first {got['losses'][0]:.4f}, last "
            f"{got['losses'][-1]:.4f}, held out {got['held_out_loss']:.4f}")


# The reference's cifar_conv fleet and run telemetry, at the smoke widths
# of tests/test_tasks.py (SMOKE_KW): a [2 scheme x 2 seed] cifar fleet on
# the fused flat path with telemetry on and a checkpoint in its run dir,
# its draws (the port replays them), and a kill-and-resume pair of the same
# fleet in another run dir; then a population fleet with ``adaptive_sca``
# on a Gauss-Markov population (stream off, so its events come in one
# order) under telemetry.  Each run dir's ``events.jsonl`` and the
# reference's ``repro.telemetry.report`` text of it are returned.
_TEL_CHILD = r"""
import contextlib, io, json, os, sys
cfg = json.loads(sys.argv[1])
import numpy as np
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # the shim: child only
from jax import random as jr
from repro import tasks
from repro.core import channel, ota, power_control as pcm, scenarios as scn
from repro.core.theory import OTAParams
from repro.fl import driver
from repro.telemetry import Telemetry, read_events
from repro.telemetry import report as treport
sys.path.insert(0, cfg["tests"])
import torch_ref

out = {}


def world(task, n):
    w = channel.WirelessConfig(num_devices=n, seed=0)
    dep = channel.deploy(w)
    prm = OTAParams(d=task.param_dim, gmax=10.0, es=w.energy_per_sample,
                    n0=w.noise_psd, gains=dep.gains, sigma_sq=np.zeros(n),
                    eta=0.05, lsmooth=1.0, kappa_sq=4.0)
    return dep, prm


def record(tag, run_dir):
    out[tag + "/events"] = np.asarray(json.dumps(read_events(run_dir)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        treport.report(run_dir)
    out[tag + "/report"] = np.asarray(buf.getvalue())


def save_result(tag, res):
    for k, v in res.params.items():
        out["%s/params/%s" % (tag, k)] = np.asarray(v)
    for k, v in res.traces.items():
        out["%s/traces/%s" % (tag, k)] = np.asarray(v)
    out["%s/evals_t" % tag] = np.asarray([t for t, _ in res.evals])
    for k in res.evals[0][1]:
        out["%s/evals/%s" % (tag, k)] = np.stack(
            [np.asarray(ev[k]) for _, ev in res.evals])


task = tasks.get("cifar_conv", **cfg["cifar_kw"])
td = task.build_data(0)
params0 = task.init_params(0)
dep, prm = world(task, task.num_devices)
pcs = [pcm.make_power_control(n, dep, prm.replace(eta=task.eta_for(n, 0.05)),
                              **({"method": "scipy"} if n == "sca" else {}))
       for n in cfg["schemes"]]
out["gains"] = dep.gains
for k, v in params0.items():
    out["params0/" + k] = np.asarray(v)
for pc in pcs:
    for f, v in torch_ref.scheme_fields(pc).items():
        out["scheme/%s/%s" % (pc.name, f)] = v
run = task.run_config(num_rounds=cfg["rounds"], eval_every=cfg["every"],
                      seed=0, batch_size=cfg["batch"])
kw = dict(task_data=td, params=params0, seeds=tuple(cfg["seeds"]),
          flat=True)
tel = Telemetry(run_dir=os.path.join(cfg["dir"], "cifar"), kappa_sq=4.0)
res = driver.run_fleet_task(task, pcs, dep.gains, run, telemetry=tel,
                            checkpoint_path=os.path.join(tel.run_dir,
                                                         "fleet"), **kw)
save_result("cifar", res)
record("cifar", tel.run_dir)
sizes = [int(np.asarray(params0[k]).size) for k in sorted(params0)]
x_dev = td.train[0]
draws = torch_ref.reference_draws(jr, ota, dep.gains, cfg["seeds"],
                                  cfg["rounds"], sizes, x_dev.shape[0],
                                  cfg["batch"], x_dev.shape[1])
for k, v in draws.items():
    out["draws/" + k] = v
if "telemetry" not in cfg["parts"]:
    np.savez(cfg["out"], **out)
    sys.exit(0)
resume_dir = os.path.join(cfg["dir"], "resume")
for extra in (dict(max_chunks=1), dict(resume=True)):
    driver.run_fleet_task(task, pcs, dep.gains, run, telemetry=resume_dir,
                          checkpoint_path=os.path.join(resume_dir, "fleet"),
                          **kw, **extra)
record("resume", resume_dir)

mlp = tasks.get("paper_mlp", hidden=16, samples_per_class=40)
mtd = mlp.build_data(0)
pdep, pprm = world(mlp, cfg["cohort"])
ad = pcm.make_adaptive_sca(pdep, pprm)
for f, v in torch_ref.scheme_fields(ad).items():
    out["adaptive/" + f] = v
pop = scn.Population(spec=scn.PopulationSpec(
    size=cfg["size"], shadowing=scn.ShadowingSpec(), sampling="traffic",
    dynamics=scn.DynamicsSpec(rho=cfg["rho"]), seed=cfg["pop_seed"]))
prun = mlp.run_config(eta=0.05, num_rounds=cfg["pop_rounds"],
                      eval_every=cfg["pop_every"], seed=0,
                      batch_size=cfg["batch"])
pop_dir = os.path.join(cfg["dir"], "population")
driver.run_fleet_task(mlp, [ad], pdep.gains, prun, task_data=mtd,
                      params=mlp.init_params(0), seeds=tuple(cfg["seeds"]),
                      flat=True, population=pop, cohort_size=cfg["cohort"],
                      cohort_rounds=cfg["cohort_rounds"], stream=False,
                      telemetry=Telemetry(run_dir=pop_dir, kappa_sq=4.0),
                      checkpoint_path=os.path.join(pop_dir, "fleet"))
record("population", pop_dir)
np.savez(cfg["out"], **out)
"""

TEL_SCHEMES = ("ideal", "sca")
# tests/test_tasks.py's SMOKE_KW["cifar_conv"]
CIFAR_SMOKE_KW = dict(channels=(8, 16), hidden=32, samples_per_class=20,
                      test_per_class=10, alpha=1.0)
# the telemetry population run: a Gauss-Markov population (so the cohort
# events carry staleness off the re-entry table), adaptive_sca re-designed
# on every fresh cohort
TEL_POP = dict(size=200, rho=0.95, pop_seed=3, cohort=10, cohort_rounds=2,
               pop_rounds=4, pop_every=2)


def run_reference_telemetry(out_dir: Path, *, rounds: int = 4,
                            every: int = 2, batch: int = 8, seeds=(0, 1),
                            telemetry: bool = True,
                            timeout: float = 900.0) -> dict:
    """The reference's cifar_conv fleet and run telemetry (see
    ``_TEL_CHILD``) in a child process; the run dirs are written under
    ``out_dir``.  Keys: ``gains``, ``params0/*``, ``scheme/<name>/*``,
    ``cifar/{params,traces,evals}/*``, ``cifar/evals_t``, ``draws/*`` and,
    for each run dir tag (cifar; with ``telemetry``, also resume and
    population), ``<tag>/events`` (JSON text) and ``<tag>/report`` (the
    reference's report text); with ``telemetry``, ``adaptive/*``.
    ``telemetry=False`` stops after the cifar fleet."""
    cfg = dict(dir=str(out_dir), out=str(Path(out_dir) / "ref.npz"),
               parts=["cifar"] + (["telemetry"] if telemetry else []),
               rounds=rounds, every=every, batch=batch, seeds=list(seeds),
               schemes=list(TEL_SCHEMES),
               cifar_kw={k: list(v) if isinstance(v, tuple) else v
                         for k, v in CIFAR_SMOKE_KW.items()},
               tests=str(ROOT / "tests"), **TEL_POP)
    return _run_child(_TEL_CHILD, cfg, "reference telemetry", timeout)


def prefixed(blob: dict, prefix: str) -> dict:
    """The entries of ``blob`` under ``prefix/``, prefix stripped."""
    p = prefix + "/"
    return {k[len(p):]: v for k, v in blob.items() if k.startswith(p)}


def tensors(tree: dict, dtype=torch.float32) -> dict:
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype)
            for k, v in tree.items()}


def tf32(v: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 on the bit pattern: add half of the 13 dropped
    bits' range to the magnitude and clear them (ties away from zero), as
    the kernels' ``to_tf32`` does."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b with TF32 operands and f32 sums: big . big alone, or with
    small . big and big . small before it (small . small dropped)."""
    a_big, b_big = tf32(a), tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def write_sca_design(out_dir: Path = FIG2_REF_DIR,
                     task: str = "paper_mlp") -> None:
    """<out_dir>/sca_design.json: the reference's default ``sca`` design at
    ``task``'s full-width Fig.-2 world (``run_reference_sca``), so the card
    can hold the port's solver without JAX."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        got = run_reference_sca(Path(tmp) / "sca.npz", task=task)
    _write_json(out_dir / "sca_design.json",
                {k: np.asarray(v).tolist() for k, v in got.items()})


def _fig2_job(job) -> str:
    protocol, seed, rounds, every, out_dir, task = job
    import tempfile
    batch = TASKS[task][1][protocol]
    with tempfile.TemporaryDirectory() as tmp:
        got = run_reference_fig2(Path(tmp) / "hist.json", seed=seed,
                                 batch=batch, rounds=rounds, every=every,
                                 task=task, timeout=3 * 3600.0)
    _write_json(Path(out_dir) / protocol / f"histories_seed{seed}.json",
                got["histories"])
    return (f"{protocol} seed {seed}: {got['cpu_wall_s']:.1f} s "
            f"(reference on the CPU)")


def main(argv=None) -> None:
    """Regenerate the reference curves the port's curve check holds against:

        PYTHONPATH=src python -m tests.torch_ref [--seeds 0 1 2 3]
            [--protocols full_batch minibatch128] [--rounds 150]
            [--every 10] [--jobs 3] [--sca-design]

    writes experiments/fig2_reference/<protocol>/histories_seed<s>.json
    (and sca_design.json with ``--sca-design``).  With
    ``--scenarios all|theory|grid`` it writes experiments/
    scenario_reference/ instead: theory_seed0.json (every registered
    scenario) and grid/histories_seed<s>.json for each of ``--seeds``
    (the card's gate reads seeds 0-7).  With ``--population`` it writes
    experiments/population_reference/population.json.  With ``--cifar``
    it writes experiments/cifar_reference/: the reference's cifar_conv
    curves (``benchmarks.fig2.run(task="cifar_conv", save=False)`` at its
    minibatch 32, ``minibatch32/histories_seed<s>.json`` for each of
    ``--seeds``) and its ``sca`` design (``sca_design.json``); the
    reference's convolutions on the CPU take ~30 min a seed, so
    ``--jobs`` defaults to 1 there."""
    import argparse
    from concurrent.futures import ThreadPoolExecutor
    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--protocols", nargs="+", default=list(PROTOCOLS),
                    choices=list(PROTOCOLS))
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--jobs", type=int, default=None,
                    help="reference runs at once (default 3; 1 with "
                         "--cifar)")
    ap.add_argument("--sca-design", action="store_true")
    ap.add_argument("--scenarios", choices=("all", "theory", "grid"),
                    nargs="?", const="all", default=None,
                    help="write experiments/scenario_reference/ instead: the "
                         "theory sweep of every registered scenario, and/or "
                         "the full-width grid's histories for --seeds")
    ap.add_argument("--population", action="store_true",
                    help="write experiments/population_reference/ instead: "
                         "the reference's 1M-device population cohorts "
                         "and its tick-0 cohort redesign")
    ap.add_argument("--cifar", action="store_true",
                    help="write experiments/cifar_reference/ instead: the "
                         "reference's cifar_conv curves for --seeds and its "
                         "sca design")
    ap.add_argument("--lm", action="store_true",
                    help="write experiments/lm_reference/ instead: the "
                         "reference's LM training runs at the example's "
                         "preset for --seeds, from the port's initial "
                         "weights")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if a.jobs is None:
        a.jobs = 1 if a.cifar else 3
    if a.lm:
        out = Path(a.out) if a.out else LM_REF_DIR
        out.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(max_workers=a.jobs) as pool:
            for line in pool.map(_lm_ref_job, [(s, out) for s in a.seeds]):
                print(line, flush=True)
        return
    if a.population:
        print(write_population_reference(
            Path(a.out) if a.out else POP_REF_DIR), flush=True)
        return
    if a.scenarios:
        out = Path(a.out) if a.out else SCN_REF_DIR
        jobs = [(s, out) for s in a.seeds] \
            if a.scenarios in ("all", "grid") else []
        with ThreadPoolExecutor(max_workers=a.jobs) as pool:
            futs = [pool.submit(_scn_grid_job, j) for j in jobs]
            if a.scenarios in ("all", "theory"):
                print(write_scenario_theory(out), flush=True)
            for fut in futs:
                print(fut.result(), flush=True)
        return
    task, protocols = "paper_mlp", a.protocols
    if a.cifar:
        task, protocols = "cifar_conv", list(CIFAR_PROTOCOLS)
        a.out = a.out or str(CIFAR_REF_DIR)
        a.sca_design = True
    a.out = a.out or str(FIG2_REF_DIR)
    if a.sca_design:
        write_sca_design(Path(a.out), task)
        print("sca_design.json written", flush=True)
    jobs = [(p, s, a.rounds, a.every, a.out, task)
            for p in protocols for s in a.seeds]
    with ThreadPoolExecutor(max_workers=a.jobs) as pool:
        for line in pool.map(_fig2_job, jobs):
            print(line, flush=True)


if __name__ == "__main__":
    main()
