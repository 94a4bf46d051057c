"""List every collective of one layer unit's step on the production mesh,
largest first, and their bytes by op: the port of
``benchmarks/collective_detail.py``.

    PYTHONPATH=src python -m repro_torch.collective_detail \
        --arch granite-8b --shape train_4k [--kind fwd] [--mesh multipod]

The reference compiles one scan unit's forward and gradient for its
(16, 16) pod mesh and reads the collectives out of the HLO.  The port
compiles nothing: it runs the unit (``models.sharded.apply_layer`` over
``repro_torch.models.transformer``'s repeating unit of ``layer_plan``:
one layer for the dense archs, mamba2 and mixtral, three for
recurrentgemma, a decoder block with its cross-attention for the
encoder-decoder) at the shape's global batch
and sequence on the mesh, on fakes, standing as rank 0 of a simulated
world of 256 (or 512) ranks, and ``launch.count.Count`` records each
collective that DTensor asks for, by the bytes of its result on one
device.  ``--kind grad`` (the default, as the reference's) takes the
gradient of the unit's output summed in f32 with respect to its
parameters and input: the forward's collectives and the backward's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch import distributed as dist
from repro_torch.launch import count
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import sharded
from repro_torch.models import transformer as tfm
from repro_torch.models.param import abstract_params, layer_groups


def unit_collectives(arch: str, shape_name: str = "train_4k",
                     kind: str = "grad", mesh: str = "pod") -> dict:
    """{"rows": [(bytes, op, result shape, dtype), ...] largest first,
    "aggregate": {op: bytes}, "calls": {op: count}} of one layer unit's
    forward (``kind="fwd"``) or forward and gradient (``"grad"``)."""
    shape = configs.get_shape(shape_name)
    cfg = dryrun.config_for(arch, shape_name)
    sharded.check_sharded(cfg)
    dims, axes = dryrun.mesh_shape(mesh)
    _, unit, _, _ = layer_groups(cfg)
    gb, s = shape.global_batch, shape.seq_len
    with dist.simulated_world(int(np.prod(dims))):
        sm = mesh_lib.make_device_mesh(dims, axes, "cpu")
        tp, dp = sm.shape["model"], sm.shape["data"]
        with count.fake_mode(card=True), dist.mesh_rules(sm):
            # the encoder-decoder's unit: a decoder block, its
            # cross-attention over a memory of the input's shape
            cross = cfg.is_enc_dec
            defs = {"layers": [tfm.layer_def(cfg, sig, tp, dp, cross=cross)
                               for sig in unit]}
            params = steps_lib.shard_params(
                abstract_params(defs, torch.device("cpu")), defs, sm)
            ctx = sharded._Ctx(gb)
            x = dist.distribute(
                torch.zeros((gb, s, cfg.d_model), dtype=cfg.compute_dtype),
                sm, dist.placements(sm, ctx.act()))

            def unit_fwd(p, x_):
                for i, sig in enumerate(unit):
                    x_, _ = sharded.apply_layer(
                        ctx, p["layers"][i], x_, cfg, sig, use_kernel=False,
                        memory=x_ if cross else None)
                return x_

            with count.Count() as c:
                if kind == "fwd":
                    with torch.no_grad():
                        unit_fwd(params, x)
                else:
                    from repro_torch.models.param import trainable
                    view, leaves = trainable(params)
                    xg = x.detach().requires_grad_(True)
                    out = unit_fwd(view, xg).float().sum()
                    torch.autograd.grad(out, list(leaves.values()) + [xg])
    rows = sorted(c.collective_log, reverse=True)
    agg = {op: b for op, b in c.collectives.items() if b}
    return {"rows": rows, "aggregate": agg,
            "calls": {op: n for op, n in c.collective_calls.items() if n}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=dryrun.SHARDED_ARCHS)
    ap.add_argument("--shape", default="train_4k",
                    choices=tuple(configs.SHAPES))
    ap.add_argument("--kind", default="grad", choices=["fwd", "grad"])
    ap.add_argument("--mesh", default="pod", choices=tuple(dryrun.MESHES))
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    res = unit_collectives(args.arch, args.shape, args.kind, args.mesh)
    print(f"== aggregate bytes by op (per device, one layer unit; "
          f"{args.arch} {args.shape} {args.kind} on the {args.mesh} mesh) ==")
    for op, b in sorted(res["aggregate"].items(), key=lambda kv: -kv[1]):
        print(f"  {op:22s} {b / 1e9:8.3f} GB  ({res['calls'][op]} ops)")
    print("== top collectives ==")
    for b, op, shp, dt in res["rows"][:args.top]:
        print(f"  {b / 1e6:10.1f} MB  {op:18s} {dt}{list(shp)}")
    return res


if __name__ == "__main__":
    main()
