"""The one-card dry-run: count every (arch x shape) step at full width and
depth on fake tensors, with no card and no allocation.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod \
        --arch qwen1.5-0.5b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod \
        --arch granite-8b --shape train_4k

The analog of ``repro.launch.dryrun`` (which lowers and compiles each step
for a TPU mesh) for the port on one card.  Each step is built as the port
runs it, on fakes (``launch.count.fake_mode``) that take the card's path
by default: K3 in every prefill, K4 in the mamba2 prefill, each counted by
its own ``work`` and never launched or built.  The fakes are CUDA
tensors where PyTorch has CUDA; a build without it cannot run every op on
fake CUDA tensors (an index raises, autograd aborts), so there they are
CPU fakes inside ``fake_mode(card=True)``, which the kernel wrappers
treat as the card's (``count.on_card``): the step takes no other branch
on the device, so the count is the same (``fake_device`` in the record
says which; ``run_one(device="cpu")`` counts the plain versions
instead, ``path`` "plain").  The fakes are made (``lower_s``), then the step runs once
inside a ``launch.count.Count`` (``compile_s``), which gives its FLOPs,
its bytes accessed and the kernel tally:

* ``train_4k``: ``launch.steps.make_train_step`` over the whole global
  batch (256 x 4,097 tokens, or (frames, tokens) for the encoder-decoder)
  among ``CLIENTS`` = 16 clients (``num_clients`` of the reference's
  (16, 16) pod mesh), with its draws (h, the coin, one f32 z per leaf) as
  fakes.  The scheme (default ``sca``, as the reference's
  ``_scheme_for``) is designed once per arch on the host's CPU with real
  numbers (``launch.train.make_design``).  The forward runs the plain
  attention and SSD (``use_kernel=False``), as the card's train step
  does, so the kernel tally is empty;
* ``prefill_32k``: ``make_prefill_step`` against caches of ``seq_len``;
* ``decode_32k`` and ``long_500k``: one ``make_serve_step`` at the last
  position of a cache of ``seq_len`` (``long_500k`` through
  ``configs.long_context_config``).

``run_one`` also takes an explicit ``InputShape`` and config (``cfg=``),
so that ``chip_smoke.py`` counts the shapes and depths it measures.

The record keeps the reference's keys: ``arch``, ``shape``, ``mesh``
(``{"data": 1, "model": 1}``), ``devices`` (1), ``scheme``,
``num_params``, ``param_bytes_total``, ``flops_per_device``,
``bytes_accessed_per_device``, ``collective_bytes_per_device`` (every op
0: one card; model sharding over cards is module 12b),
``memory_analysis`` (``argument_bytes``: the step's arguments,
parameters, inputs and caches, and a train step's draws, which the
reference makes inside its step; ``output_bytes``: what it returns;
and, where a reckoning was built for the arch and the kind
(``RECKONINGS``), its terms under ``reckoned``; no
``temp_bytes``: eager PyTorch has no compiled program to ask),
``lower_s`` and ``compile_s``; and adds ``card`` (``card.peaks``'s name
of the card whose peaks the roofline uses), ``fake_device``, ``path`` and
``kernels`` (the tally: calls, FLOPs and bytes by kernel).  There are no
``*_corrected`` keys: XLA counts a scanned body once and the reference
corrects for it (``repro/launch/cost.py``), but eager counting sees every
layer (a test holds the count linear in depth).  Records go to
``experiments/dryrun_torch/<arch>_<shape>_card.json``.

On a mesh (module 12b; ``mesh="pod"``, the reference's (16, 16)
("data", "model") mesh of 256 ranks, ``"multipod"`` (``--multi-pod``),
its (2, 16, 16) ("pod", "data", "model") mesh of 512, or a debug shape):
``run_one`` builds the step on the mesh as the port runs it there
(``launch.steps.shard_params`` / ``shard_caches``, the ``mesh=`` steps,
``models.sharded``), on fakes, standing as rank 0 of a simulated world
(``distributed.simulated_world``: the collectives return at once).  The
counts are rank 0's: per device.  The record adds ``collective_bytes_per
_device`` by op and ``total`` (``launch.count``: each collective by the
bytes of its result on one device) and ``collective_calls``; a train
step's clients are the mesh's ``num_clients`` (16, or 32 on the
multi-pod mesh); ``memory_analysis`` holds rank 0's shards of the
arguments and outputs (a train step's draws as each rank's shard of z).
Records go to ``experiments/dryrun_torch/<arch>_<shape>_pod.json`` or
``_multipod.json``, the reference's tags; only the nine archs whose model
runs on a mesh (``SHARDED_ARCHS``: all but deepseek-v3-671b, whose MLA and
MTP ``models.sharded.check_sharded`` refuses) are counted there.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import time
import traceback
from typing import Optional, Union

import torch

import numpy as np

from repro_torch import configs
from repro_torch import distributed as dist
from repro_torch.card import peaks
from repro_torch.configs.shapes import InputShape
from repro_torch.core import power_control as pcm
from repro_torch.kernels import ref
from repro_torch.launch import count, memory
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.train import TrainDesign, make_design
from repro_torch.models import moe
from repro_torch.models.param import param_leaves
from repro_torch.models.sharded import check_sharded
from repro_torch.models.registry import build_bundle

ARTIFACT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments",
    "dryrun_torch"))
CLIENTS = 16                # num_clients of the reference's (16, 16) mesh
ETA = 1e-2                  # the reference's dry-run eta
# (arch, kind) -> the memory reckoning built for it, and its arguments
RECKONINGS = {
    ("qwen1.5-0.5b", "train"): "train_reckoning",
    ("recurrentgemma-9b", "train"): "train_reckoning",
    ("seamless-m4t-medium", "train"): "train_reckoning",
    ("mixtral-8x22b", "prefill"): "mixtral_reckoning",
    ("deepseek-v3-671b", "prefill"): "deepseek_reckoning",
}
COLLECTIVES = count.COLLECTIVES
# mesh name -> (shape, axis names): the reference's production meshes
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def config_for(arch: str, shape_name: str):
    """The arch's config for a shape: ``long_500k`` takes its
    long-context variant, as the reference's."""
    return (configs.long_context_config(arch) if shape_name == "long_500k"
            else configs.get_config(arch))


def card_name() -> str:
    """``card.peaks``'s name of the card the roofline reads: this machine's
    card, or the H100 SXM without one."""
    return peaks(torch.cuda.get_device_name(0) if torch.cuda.is_available()
                 else "H100")[0]


def _nbytes(tree) -> int:
    """Bytes of a tree's tensors; a DTensor's local shard's (one
    device's)."""
    if dist.is_dtensor(tree):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, torch.nn.Module):
        return _nbytes(list(param_leaves(tree).values()))
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return 0


def build_step_and_args(cfg, shape: InputShape, device,
                        design: Optional[TrainDesign] = None):
    """(step, args, bundle) of ``shape``'s kind at ``cfg``, its parameters
    and inputs as fakes on ``device``; inside ``count.fake_mode()``.  A
    train step needs ``design`` (its scheme and the world's gains)."""
    bundle = build_bundle(cfg, device)
    dev = bundle.device
    params = bundle.abstract()
    gb, s = shape.global_batch, shape.seq_len
    ct = cfg.compute_dtype

    def tokens(n):
        return torch.zeros((gb, n), dtype=torch.long, device=dev)

    def frames():
        return torch.zeros((gb, s, cfg.d_model), dtype=ct, device=dev)

    if shape.kind == "train":
        pc = copy.copy(design.pc)
        pc._f32 = {}          # its device leaves are made as fakes here
        step = steps_lib.make_train_step(bundle, pc, design.prm.gains,
                                         steps_lib.TrainStepConfig(eta=ETA))
        n = len(design.prm.gains)
        draws = steps_lib.StepDraws(
            h=torch.zeros(n, dtype=torch.complex64, device=dev),
            coin=torch.zeros((), dtype=torch.bool, device=dev),
            z={k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
               for k, v in param_leaves(params).items()})
        # its design leaves reach the device once, as in a run's first step
        pc.round_coeffs(draws.h[None], draws.coin.reshape(1))
        batch = (frames(), tokens(s + 1)) if cfg.is_enc_dec \
            else tokens(s + 1)
        return step, (params, batch, draws), bundle
    if shape.kind == "prefill":
        inputs = (frames(), tokens(s)) if cfg.is_enc_dec else tokens(s)
        return (steps_lib.make_prefill_step(bundle),
                (params, inputs, bundle.init_caches(gb, s)), bundle)
    if shape.kind == "decode":
        caches = bundle.init_caches(gb, s)
        if cfg.is_enc_dec:
            dh = cfg.resolved_head_dim
            caches = (caches, [
                {kv: torch.zeros((gb, s, cfg.n_kv_heads, dh), dtype=ct,
                                 device=dev) for kv in ("k", "v")}
                for _ in range(cfg.n_layers)])
        # the last position: the cache is full but for this token
        return (steps_lib.make_serve_step(bundle),
                (params, caches, tokens(1), s - 1), bundle)
    raise ValueError(f"unknown kind {shape.kind!r}")


def mesh_shape(mesh) -> tuple:
    """(shape, axis names) of a mesh name of ``MESHES`` or a debug shape:
    (data, model), or (pod, data, model)."""
    if isinstance(mesh, str):
        return MESHES[mesh]
    mesh = tuple(int(n) for n in mesh)
    return mesh, (("pod", "data", "model") if len(mesh) == 3
                  else ("data", "model"))


def mesh_tag(mesh) -> str:
    """The record's tag: the reference's ``pod`` / ``multipod``, or the
    debug shape's sizes."""
    return mesh if isinstance(mesh, str) else "x".join(
        str(n) for n in mesh_shape(mesh)[0])


def build_mesh_step_and_args(cfg, shape: InputShape, mesh,
                             design: Optional[TrainDesign] = None):
    """(step, args, bundle) of ``shape``'s kind at ``cfg`` on ``mesh`` (a
    ``ShardMesh``): the parameters, caches and inputs as DTensors of
    fakes laid out by the reference's specs; inside ``count.fake_mode()``
    and a ``simulated_world`` of the mesh's size."""
    check_sharded(cfg)
    bundle = build_bundle(cfg, "cpu", tp=mesh.shape.get("model", 1),
                          dp=mesh.shape.get("data", 1))
    params = steps_lib.shard_params(bundle.abstract(), bundle, mesh)
    gb, s = shape.global_batch, shape.seq_len

    def batch(shp, dtype, extra=1):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(
            torch.zeros(shp, dtype=dtype), mesh.device_mesh,
            steps_lib.named(mesh, steps_lib.batch_spec(mesh, gb, extra)),
            src_data_rank=None)

    def tokens(n):
        return batch((gb, n), torch.long)

    def inputs(n):
        """tokens, or the encoder-decoder's (frames, tokens)"""
        if not cfg.is_enc_dec:
            return tokens(n)
        return (batch((gb, s, cfg.d_model), cfg.compute_dtype, 2), tokens(n))

    if shape.kind == "train":
        from torch.distributed.tensor import distribute_tensor
        pc = copy.copy(design.pc)
        pc._f32 = {}
        step = steps_lib.make_train_step(
            bundle, pc, design.prm.gains, steps_lib.TrainStepConfig(eta=ETA),
            mesh=mesh)
        n = len(design.prm.gains)
        z = {k: distribute_tensor(torch.zeros(v.shape, dtype=torch.float32),
                                  mesh.device_mesh, v.placements,
                                  src_data_rank=None)
             for k, v in param_leaves(params).items()}
        draws = steps_lib.StepDraws(
            h=torch.zeros(n, dtype=torch.complex64),
            coin=torch.zeros((), dtype=torch.bool), z=z)
        pc.round_coeffs(draws.h[None], draws.coin.reshape(1))
        return step, (params, inputs(s + 1), draws), bundle
    caches = steps_lib.shard_caches(bundle.init_caches(gb, s), mesh, gb)
    if shape.kind == "prefill":
        return (steps_lib.make_prefill_step(bundle, mesh),
                (params, inputs(s), caches), bundle)
    if shape.kind == "decode":
        if cfg.is_enc_dec:
            kv = torch.zeros((gb, s, cfg.n_kv_heads, cfg.resolved_head_dim),
                             dtype=cfg.compute_dtype)
            caches = (caches, steps_lib.shard_caches(
                [{"k": kv, "v": kv} for _ in range(cfg.n_layers)], mesh, gb))
        return (steps_lib.make_serve_step(bundle, mesh),
                (params, caches, tokens(1), s - 1), bundle)
    raise ValueError(f"unknown kind {shape.kind!r}")


@contextlib.contextmanager
def _counters_kept():
    """Leave the plain versions' call counts and the MoE's kept-assignment
    record as they were: a dry-run's calls are fakes, not runs."""
    kept = (ref.attention_ref.calls, ref.ssd_chunked.calls,
            moe.experts.calls, list(moe.experts.kept))
    try:
        yield
    finally:
        (ref.attention_ref.calls, ref.ssd_chunked.calls,
         moe.experts.calls) = kept[:3]
        moe.experts.kept.clear()
        moe.experts.kept.extend(kept[3])


def run_one(arch: str, shape: Union[str, InputShape], *,
            scheme: str = "sca", save: bool = True, cfg=None,
            design: Optional[TrainDesign] = None, device: str = "cuda",
            fakes: Optional[str] = None, mesh=None) -> dict:
    """Count one step and return its record (and write it, ``save``).
    ``shape``: a name of ``configs.SHAPES`` or an ``InputShape``; ``cfg``:
    another config than the arch's (a cut depth, a smoke width); a train
    step's ``design`` (default: ``scheme``'s design of ``CLIENTS``
    clients, made here on the host's CPU); ``device``: ``cuda``, the
    card's path, or ``cpu``, the plain versions'; ``fakes``: the fakes'
    device (default: ``device`` where this build of PyTorch has it, else
    the CPU, standing for the card); ``mesh``: count the step on a mesh
    of ranks (a name of ``MESHES`` or a debug shape) as rank 0, on CPU
    fakes standing for the card's."""
    shape = configs.get_shape(shape) if isinstance(shape, str) else shape
    cfg = cfg if cfg is not None else config_for(arch, shape.name)
    if mesh is not None:
        return _run_mesh(arch, shape, cfg, mesh, scheme, design, save)
    card = torch.device(device).type == "cuda"
    fake_device = fakes or (device if not card or torch.cuda.is_available()
                            else "cpu")
    if shape.kind == "train" and design is None:
        d = build_bundle(cfg, "cpu").num_params
        design = make_design(scheme, CLIENTS, d, ETA, seed=0, device="cpu")
    if design is not None:
        scheme = design.pc.name
    with _counters_kept(), count.fake_mode(card=card):
        t0 = time.time()
        step, args, bundle = build_step_and_args(cfg, shape, fake_device,
                                                 design)
        t_lower = time.time() - t0
        with count.Count() as c:
            out = step(*args)
        t_compile = time.time() - t0 - t_lower
        mem = {"argument_bytes": _nbytes(args), "output_bytes": _nbytes(out)}
        del out, args
    rk = RECKONINGS.get((arch, shape.kind))
    if rk:
        fn = getattr(memory, rk)
        mem["reckoned"] = {"reckoning": rk, **(
            fn(cfg, shape.global_batch, shape.seq_len)
            if rk == "train_reckoning"
            else fn(cfg, shape.global_batch, shape.seq_len, 0))}
    rep = c.report()
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": {"data": 1, "model": 1},
        "devices": 1,
        "card": card_name(),
        "fake_device": str(torch.device(fake_device)),
        "path": "card" if card else "plain",
        "scheme": scheme,
        "num_params": int(bundle.num_params),
        "param_bytes_total": int(memory.def_bytes(bundle.defs)),
        "flops_per_device": float(rep["flops"]),
        "bytes_accessed_per_device": float(rep["bytes"]),
        "collective_bytes_per_device": {
            **dict.fromkeys(COLLECTIVES, 0), "total": 0,
            "note": "one card: no collectives"},
        "memory_analysis": mem,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "kernels": rep["kernels"],
    }
    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        path = os.path.join(ARTIFACT_DIR, f"{arch}_{shape.name}_card.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def _run_mesh(arch: str, shape: InputShape, cfg, mesh, scheme: str,
              design: Optional[TrainDesign], save: bool) -> dict:
    dims, axes = mesh_shape(mesh)
    n_dev = int(np.prod(dims))
    check_sharded(cfg)
    if shape.kind == "train" and design is None:
        d = build_bundle(cfg, "cpu").num_params
        clients = int(np.prod(dims[:-1]))
        design = make_design(scheme, clients, d, ETA, seed=0, device="cpu")
    if design is not None:
        scheme = design.pc.name
    with _counters_kept(), dist.simulated_world(n_dev):
        sm = mesh_lib.make_device_mesh(dims, axes, "cpu")
        record = _count_mesh(arch, shape, cfg, sm, scheme, design)
    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        path = os.path.join(ARTIFACT_DIR,
                            f"{arch}_{shape.name}_{mesh_tag(mesh)}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def _count_mesh(arch, shape, cfg, sm, scheme, design) -> dict:
    with count.fake_mode(card=True):
        t0 = time.time()
        step, args, bundle = build_mesh_step_and_args(cfg, shape, sm, design)
        t_lower = time.time() - t0
        with count.Count() as c:
            out = step(*args)
        t_compile = time.time() - t0 - t_lower
        mem = {"argument_bytes": _nbytes(args), "output_bytes": _nbytes(out)}
        del out, args
    rep = c.report()
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": dict(sm.shape),
        "devices": sm.size,
        "card": card_name(),
        "fake_device": "cpu",
        "path": "card",
        "scheme": scheme,
        "num_params": int(bundle.num_params),
        "param_bytes_total": int(memory.def_bytes(bundle.defs)),
        "flops_per_device": float(rep["flops"]),
        "bytes_accessed_per_device": float(rep["bytes"]),
        "collective_bytes_per_device": rep["collectives"],
        "collective_calls": rep["collective_calls"],
        "memory_analysis": mem,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "kernels": rep["kernels"],
    }
    return record


SHARDED_ARCHS = ("qwen1.5-0.5b", "qwen3-1.7b", "mamba2-1.3b", "granite-8b",
                 "qwen2.5-14b", "chameleon-34b", "recurrentgemma-9b",
                 "seamless-m4t-medium", "mixtral-8x22b")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=configs.ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=tuple(configs.SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="on the (2, 16, 16) multi-pod mesh (--mesh "
                         "multipod)")
    ap.add_argument("--mesh", default=None, choices=tuple(MESHES),
                    help="on the reference's pod or multi-pod mesh, as "
                         "rank 0 of a simulated world")
    ap.add_argument("--scheme", default="sca", choices=pcm.SCHEMES)
    ap.add_argument("--all", action="store_true",
                    help="run every supported (arch x shape)")
    args = ap.parse_args(argv)
    mesh = "multipod" if args.multi_pod else args.mesh
    if args.all:
        archs = SHARDED_ARCHS if mesh else configs.ARCH_IDS
        pairs = [(arch, shp) for arch in archs
                 for shp in configs.supported_shapes(arch)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        pairs = [(args.arch, args.shape)]

    failures = []
    for arch, shp in pairs:
        try:
            rec = run_one(arch, shp, scheme=args.scheme, mesh=mesh)
            print(f"OK   {arch:22s} {shp:12s} {mesh or 'card':8s} "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"bytes/dev={rec['bytes_accessed_per_device']:.3e}B "
                  f"coll/dev="
                  f"{rec['collective_bytes_per_device']['total']:.3e}B "
                  f"kernels={json.dumps(rec['kernels'])} "
                  f"count={rec['compile_s']}s", flush=True)
        except Exception as e:
            failures.append((arch, shp, repr(e)))
            traceback.print_exc()
            print(f"FAIL {arch:22s} {shp:12s} {e!r}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")


if __name__ == "__main__":
    main()
