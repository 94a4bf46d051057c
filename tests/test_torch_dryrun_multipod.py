"""The dry-run on a mesh of ranks (module 12b) on the CPU: each step built
on the mesh, on fakes, as rank 0 of a simulated world, its collectives
tallied.

The counterpart of ``tests/test_dryrun_small.py::
test_debug_mesh_dryrun_all_kinds`` (the reference's granite train step and
mamba2 decode step at smoke size on a (2, 2, 2) mesh: FLOPs, collective
bytes and argument bytes all > 0); the tally held to a hand-built DTensor
program whose collectives are known, byte for byte; the qwen1.5-0.5b
``decode_32k`` step on the reference's (16, 16) pod mesh within 1 % of the
reference record's argument and output bytes (``experiments/dryrun/``:
the KV cache's shards and the parameters' are the reference's specs end to
end); the committed records of the nine archs on the pod and multi-pod
meshes (K3 once per attention layer: 12 of recurrentgemma's 38, 36 for
seamless, 56 for mixtral); ``collective_detail`` gathering weights, not activations; the
roofline's collective term.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import collective_detail, configs, roofline, tables
from repro_torch import distributed as dist
from repro_torch.card import link_rate
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import count, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.train import make_design
from repro_torch.models.registry import build_bundle
from torch_ref import one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
REF_RECORD = ROOT / "experiments" / "dryrun" / \
    "qwen1.5-0.5b_decode_32k_pod.json"
PAIRS = [(arch, shp) for arch in dryrun.SHARDED_ARCHS
         for shp in configs.supported_shapes(arch)]


@pytest.mark.parametrize("arch,kind", [("granite-8b", "train"),
                                       ("mamba2-1.3b", "decode"),
                                       ("qwen2.5-14b", "prefill"),
                                       ("recurrentgemma-9b", "decode"),
                                       ("seamless-m4t-medium", "train"),
                                       ("mixtral-8x22b", "prefill")])
def test_debug_mesh_dryrun_all_kinds(arch, kind):
    """Smoke configs at (S 64, global batch 16) on a (2, 2, 2) mesh of 8
    ranks: FLOPs, collective bytes and argument bytes all > 0."""
    cfg = configs.get_config(arch).smoke()
    shape = InputShape("t", 64, 16, kind)
    design = None
    if kind == "train":
        d = build_bundle(cfg, "cpu").num_params
        design = make_design("vanilla", 4, d, 0.01, seed=0, device="cpu")
    rec = dryrun.run_one(arch, shape, cfg=cfg, mesh=(2, 2, 2), save=False,
                         design=design)
    assert rec["devices"] == 8
    assert rec["mesh"] == {"pod": 2, "data": 2, "model": 2}
    assert rec["flops_per_device"] > 0
    assert rec["collective_bytes_per_device"]["total"] > 0
    assert rec["memory_analysis"]["argument_bytes"] > 0
    assert set(rec["collective_bytes_per_device"]) == set(
        count.COLLECTIVES) | {"total"}
    if kind == "prefill":                  # K3 per layer, counted on fakes
        assert rec["kernels"]["flash_attention"]["calls"] == cfg.n_layers


def test_collective_tally_of_a_known_program():
    """On a (2, 2) mesh of real CPU tensors, as rank 0 of a simulated
    world: an all-gather over "data" of an [8, 6] f32 shard to [8, 6]
    whole; a partial sum over "model" all-reduced, [4, 6]; a partial sum
    over "data" reduce-scattered to [2, 6]; a shard moved from dim 0 to
    dim 1 over "data" (DTensor's all-to-all, which a CPU mesh carries out
    as an all-gather and a chunk): each counted by its result's bytes on
    one device, the all-to-all as one."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    with dist.simulated_world(4):
        mesh = mesh_lib.make_debug_device_mesh(2, 2)
        dm = mesh.device_mesh
        with count.Count() as c:
            x = DTensor.from_local(torch.ones(4, 6), dm,
                                   (Shard(0), Replicate()), run_check=False)
            x.redistribute(dm, (Replicate(), Replicate())).to_local()
            p = DTensor.from_local(torch.ones(4, 6), dm,
                                   (Shard(0), Partial()), run_check=False)
            p.redistribute(dm, (Shard(0), Replicate())).to_local()
            q = DTensor.from_local(torch.ones(4, 6), dm,
                                   (Partial(), Replicate()), run_check=False)
            q.redistribute(dm, (Shard(0), Replicate())).to_local()
            y = DTensor.from_local(torch.ones(4, 6), dm,
                                   (Shard(0), Replicate()), run_check=False)
            y.redistribute(dm, (Shard(1), Replicate())).to_local()
    rep = c.report()
    assert rep["collective_calls"] == {"all-gather": 1, "all-reduce": 1,
                                       "reduce-scatter": 1, "all-to-all": 1,
                                       "collective-permute": 0}
    assert rep["collectives"] == {"all-gather": 8 * 6 * 4,
                                  "all-reduce": 4 * 6 * 4,
                                  "reduce-scatter": 2 * 6 * 4,
                                  "all-to-all": 8 * 3 * 4,
                                  "collective-permute": 0,
                                  "total": (48 + 24 + 12 + 24) * 4}


def test_qwen_decode_pod_record_within_one_percent_of_the_reference():
    """The step on the (16, 16) mesh of 256 ranks: rank 0's arguments
    (its shards of the parameters and of 24 layers' KV caches, the token)
    and outputs within 1 % of the reference's compiled step's."""
    rec = dryrun.run_one("qwen1.5-0.5b", "decode_32k", mesh="pod",
                         save=False)
    ref = json.loads(REF_RECORD.read_text())
    assert rec["devices"] == ref["devices"] == 256
    assert rec["mesh"] == ref["mesh"]
    for key in ("argument_bytes", "output_bytes"):
        got, want = rec["memory_analysis"][key], \
            ref["memory_analysis"][key]
        assert abs(got - want) <= 0.01 * want, (key, got, want)
    assert set(ref) - {"memory_analysis"} <= set(rec)
    assert set(ref["collective_bytes_per_device"]) <= set(
        rec["collective_bytes_per_device"])
    assert rec["collective_bytes_per_device"]["total"] > 0
    # the cache alone: 24 layers x k, v [128 / 16, 32768, 16 / 16, 64] bf16
    assert rec["memory_analysis"]["argument_bytes"] > \
        24 * 2 * 8 * 32768 * 1 * 64 * 2


def kernel_layers(cfg) -> int:
    """The layers of a prefill that launch K3 (or K4, for mamba2): every
    layer but the RG-LRU's (recurrentgemma: 12 local layers of its 38);
    the encoder-decoder's encoder layers and its decoder layers twice
    (self and cross: 36 for seamless)."""
    if cfg.is_enc_dec:
        return cfg.encoder_layers + 2 * cfg.n_layers
    return sum(k != "rglru" for k in cfg.block_kinds())


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_committed_mesh_records(mesh):
    """One record per (arch, shape) of the nine archs that run on a mesh,
    with the reference's keys; collectives in every step; K3 in every
    prefill of an attention arch, one call an attention layer; K4 in
    mamba2's, one call a layer."""
    recs = {(r["arch"], r["shape"]): r
            for r in roofline.load_records(mesh=mesh)}
    assert sorted(recs) == sorted(PAIRS)
    ref = json.loads(REF_RECORD.read_text())
    n = 256 if mesh == "pod" else 512
    for (arch, shp), r in recs.items():
        assert set(ref) - {"memory_analysis"} <= set(r)
        assert r["devices"] == n and sum(r["mesh"].values()) > 0
        assert r["collective_bytes_per_device"]["total"] > 0, (arch, shp)
        assert r["flops_per_device"] > 0
        cfg = dryrun.config_for(arch, shp)
        if configs.get_shape(shp).kind == "prefill":
            key = "ssd_scan" if arch == "mamba2-1.3b" else "flash_attention"
            assert r["kernels"][key]["calls"] == kernel_layers(cfg), \
                (arch, shp)
        else:
            assert r["kernels"] == {}, (arch, shp)


def test_tables_print_the_mesh_records(capsys):
    tables.main(["--mesh", "pod"])
    out = capsys.readouterr().out
    assert "### Dry-run (the pod mesh)" in out
    assert out.count("| qwen1.5-0.5b |") == 2 * len(
        configs.supported_shapes("qwen1.5-0.5b"))
    assert "lower bound" in out


def test_roofline_collective_term_over_the_link():
    rec = json.loads((Path(dryrun.ARTIFACT_DIR)
                      / "granite-8b_train_4k_pod.json").read_text())
    row = roofline.roofline_row(rec)
    _, link = link_rate(rec["card"])
    assert row["collective_s"] == \
        rec["collective_bytes_per_device"]["total"] / link
    assert "lower bound" in row["collective_note"]
    assert row["dominant"] in ("compute", "memory", "collective")


def test_collective_detail_gathers_weights_not_activations():
    """One qwen1.5-0.5b layer's forward at train_4k on the pod mesh: every
    all-gather's result is a weight's size (the FSDP gathers), none an
    activation's [16, 4096, ...]; the all-reduces are the two partial
    sums over "model" (attention's and the MLP's output projections)."""
    res = collective_detail.unit_collectives("qwen1.5-0.5b", "train_4k",
                                             "fwd")
    gathers = [shp for _, op, shp, _ in res["rows"] if op == "all-gather"]
    assert gathers and all(16 * 4096 > int(np.prod(shp[:2]))
                           or shp[0] != 16 for shp in gathers)
    assert res["calls"]["all-reduce"] == 2
    assert all(shp == (16, 4096, 1024) for _, op, shp, _ in res["rows"]
               if op == "all-reduce")
