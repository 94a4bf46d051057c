"""The port's roofline and tables (module 13: ``repro_torch.roofline``,
``repro_torch.tables``) against the reference's ``benchmarks.roofline``
and ``benchmarks.tables``, and the committed records of
``experiments/dryrun_torch/``.

The reference's functions run in a child process (``torch_ref._child``):
its ``active_params`` and ``model_flops`` for every (arch, shape), its
fused round-step rows and peaks, and its ``dryrun_table`` on the port's
records.
"""
import json
import math
from pathlib import Path

import pytest
import torch

from repro_torch import configs, roofline, tables
from repro_torch.card import peaks
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
import torch_ref
from torch_ref import one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
PAIRS = [(arch, shp) for arch in configs.ARCH_IDS
         for shp in configs.supported_shapes(arch)]

_ROOFLINE_CHILD = r"""
import json, sys
cfg = json.loads(sys.argv[1])
from benchmarks import roofline, tables
from repro import configs
from repro.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
with open(cfg["records"]) as f:
    records = json.load(f)
out = {"active": {}, "model_flops": {},
       "ota": roofline.ota_round_step_roofline(n=10, d=814_090),
       "hbm_bw": HBM_BW, "peak_bf16": PEAK_FLOPS_BF16,
       "dryrun_table": tables.dryrun_table(records)}
for arch, shp in cfg["pairs"]:
    c = (configs.long_context_config(arch) if shp == "long_500k"
         else configs.get_config(arch))
    out["active"][arch + "/" + shp] = roofline.active_params(c)
    out["model_flops"][arch + "/" + shp] = roofline.model_flops(arch, shp)
with open(cfg["out"], "w") as f:
    json.dump(out, f)
"""


def smoke_record(kind="prefill"):
    """A record of qwen1.5-0.5b's smoke config, K3 on the card's path."""
    cfg = configs.get_config("qwen1.5-0.5b").smoke()
    return dryrun.run_one("qwen1.5-0.5b", InputShape(kind, 40, 2, kind),
                          cfg=cfg, save=False)


@pytest.fixture(scope="module")
def records():
    """The committed records and one made here."""
    return roofline.load_records() + [smoke_record()]


@pytest.fixture(scope="module")
def reference(records, tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    (d / "records.json").write_text(json.dumps(records))
    torch_ref._child(_ROOFLINE_CHILD, {
        "out": str(d / "out.json"), "records": str(d / "records.json"),
        "pairs": PAIRS}, "reference roofline", 300)
    return json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("arch, shp", PAIRS)
def test_active_params_and_model_flops_match_reference(reference, arch, shp):
    cfg = dryrun.config_for(arch, shp)
    assert roofline.active_params(cfg) == reference["active"][f"{arch}/{shp}"]
    assert roofline.model_flops(arch, shp) \
        == reference["model_flops"][f"{arch}/{shp}"]


def test_ota_round_step_roofline_is_the_reference_at_the_card(reference):
    """The reference's bytes and FLOPs; the memory times are its times x
    (its 819 GB/s / the card's bytes/s), the compute times x (its bf16
    peak / the card's)."""
    _, (bw, _, bf16) = peaks("H100")
    mem = reference["hbm_bw"] / bw
    comp = reference["peak_bf16"] / bf16
    rows = roofline.ota_round_step_roofline(n=10, d=814_090)
    assert len(rows) == len(reference["ota"])
    for got, want in zip(rows, reference["ota"]):
        for k in ("kernel", "uplink_dtype", "n", "d", "flops_per_byte",
                  "fused_bytes_mb", "unfused_bytes_mb"):
            assert got[k] == want[k], k
        for k in ("memory_s", "unfused_memory_s"):
            assert math.isclose(got[k], want[k] * mem, rel_tol=1e-12), k
        assert math.isclose(got["compute_s"], want["compute_s"] * comp,
                            rel_tol=1e-12)
        assert got["dominant"] == "memory"


@pytest.mark.parametrize("c, n, d", [(7, 10, 1000), (3, 4, 517)])
def test_k1_f32_bytes_are_phase_2s(c, n, d):
    """The fused f32 launch's bytes x C cells, plus the per-cell
    coefficients the reference's reckoning leaves out (s and its scales
    [C, N], the noise scale and eta [C]), are the bytes behind phase 2's
    K1 bound (``profile_ota.ota_cases``); at the main path's [7, 10,
    814,090] over 3.35 TB/s that bound is 0.0885 ms."""
    from repro_torch.profile_ota import draw, ota_cases
    gen = torch.Generator().manual_seed(0)
    case = ota_cases(*draw((c, n, d), torch.device("cpu"), gen))[0]
    assert case[:2] == ("ota_round_step", "f32")
    row = roofline.ota_round_step_roofline(n=n, d=d)[0]
    assert c * round(row["fused_bytes_mb"] * 1e6) + 4 * c * (2 * n + 2) \
        == case[4]
    _, (bw, _, _) = peaks("H100")
    main = roofline.ota_round_step_roofline(n=10, d=814_090)[0]
    assert round(1e3 * 7 * main["fused_bytes_mb"] * 1e6 / bw, 4) == 0.0885


def test_dryrun_table_is_the_reference_rendering(records, reference):
    assert tables.dryrun_table(records) == reference["dryrun_table"]


def test_roofline_row_reads_the_card_peaks():
    rec = smoke_record()
    _, (bw, _, bf16) = peaks(rec["card"])
    row = roofline.roofline_row(dict(rec, shape="prefill_32k"))
    assert row["compute_s"] == rec["flops_per_device"] / bf16
    assert row["memory_s"] == rec["bytes_accessed_per_device"] / bw
    assert row["collective_s"] == 0.0
    assert row["dominant"] == max(("compute", "memory"),
                                  key=lambda k: row[k + "_s"])
    mf = roofline.model_flops("qwen1.5-0.5b", "prefill_32k")
    assert row["useful_flops_ratio"] == mf / rec["flops_per_device"]
    t = roofline.terms(rec)
    assert (t["compute_s"], t["memory_s"]) \
        == (row["compute_s"], row["memory_s"])
    assert t["bound_s"] == max(row["compute_s"], row["memory_s"])


def test_committed_records_cover_every_pair():
    """34 records, one per supported (arch, shape), on one card with no
    collectives; K3 in every prefill of an arch with attention, one call
    an attention layer, K4 in mamba2's, one a layer; no kernel in a
    train or decode step."""
    recs = {(r["arch"], r["shape"]): r for r in roofline.load_records()}
    assert sorted(recs) == sorted(PAIRS)
    for (arch, shp), r in recs.items():
        assert r["devices"] == 1 and r["path"] == "card"
        assert r["collective_bytes_per_device"]["total"] == 0
        assert r["flops_per_device"] > 0 and r["bytes_accessed_per_device"] > 0
        cfg = dryrun.config_for(arch, shp)
        if configs.get_shape(shp).kind != "prefill":
            assert r["kernels"] == {}, (arch, shp)
            continue
        kinds = cfg.block_kinds()
        want = {}
        n_attn = sum(k in ("attn", "swa", "local") for k in kinds) + (
            cfg.encoder_layers + cfg.n_layers if cfg.is_enc_dec else 0)
        if n_attn:
            want["flash_attention"] = n_attn
        if "ssd" in kinds:
            want["ssd_scan"] = kinds.count("ssd")
        assert {k: v["calls"] for k, v in r["kernels"].items()} == want, \
            (arch, shp)


def test_tables_render_the_records(capsys):
    tables.main([])
    out = capsys.readouterr().out
    n = len(roofline.load_records())
    assert out.count("\n| ") >= 2 * n
    assert "not measured" in out
