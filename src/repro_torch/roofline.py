"""Roofline terms of the dry-run's records, the dominant bound, and the
model-FLOPs ratio: the port of ``benchmarks/roofline.py``.

    PYTHONPATH=src python -m repro_torch.roofline [--mesh card|pod|multipod]

    compute    = counted FLOPs / the card's bf16 tensor-core peak
    memory     = counted bytes accessed / the card's memory bytes/s
    collective = collective bytes per device / the card's link rate each
                 way (``card.link_rate``: NVLink 4's 450 GB/s on the H100
                 SXM); 0 on one card.  Reckoned, and a lower bound for a
                 mesh of more than one node: the reference's 256 (512)
                 ranks are 32 (64) nodes of 8 cards, and traffic between
                 nodes crosses a slower network

The counts are the port's (``launch.dryrun``: the eager step on fakes,
K3 and K4 by their own work) and the peaks the card's published ones
(``card.peaks``; the records name the card, the H100 SXM at 700 W where
they were made without one): every time here is reckoned from those
peaks, not measured.  The compute term takes the bf16 rate for every op,
as the reference takes its bf16 peak; the bytes are an upper bound on
device-memory traffic (``launch.count``), so the memory term is too.
``active_params`` and ``model_flops`` are copies of the reference's (pure
Python on a config).  ``ota_round_step_roofline`` is the reference's
reckoning of one fused K1 launch, at the card's peaks.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch import configs
from repro_torch.card import link_rate, peaks
from repro_torch.launch.dryrun import ARTIFACT_DIR, config_for
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# MODEL_FLOPS: 6 N D (dense train) / 6 N_active D (MoE train) / 2 N D decode
# ---------------------------------------------------------------------------

def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (embedding lookup excluded, unembed
    matmul included — it executes as a matmul)."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    total = 0
    kinds = cfg.block_kinds()
    for i, kind in enumerate(kinds):
        if kind in ("attn", "swa", "local", "enc_attn"):
            if cfg.attn_kind == "mla":
                qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                q = (cfg.q_lora_rank * (d + cfg.n_heads * qk)
                     if cfg.q_lora_rank else d * cfg.n_heads * qk)
                kv = d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) \
                    + cfg.kv_lora_rank * cfg.n_heads * (
                        cfg.qk_nope_head_dim + cfg.v_head_dim)
                o = cfg.n_heads * cfg.v_head_dim * d
                total += q + kv + o
            else:
                total += d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                    + cfg.n_heads * dh * d
        elif kind == "ssd":
            d_inner = cfg.ssm_expand * d
            nheads = d_inner // cfg.ssm_headdim
            gn = cfg.ssm_ngroups * cfg.ssm_state
            total += d * (2 * d_inner + 2 * gn + nheads) + d_inner * d
        elif kind == "rglru":
            w = cfg.lru_width or d
            total += 2 * d * w + 2 * w * w + w * d
        # ffn
        if kind == "ssd" and cfg.ffn_kind == "none":
            continue
        n_mats = 3 if cfg.ffn_kind in ("swiglu", "geglu") else 2
        if cfg.layer_is_moe(i):
            active_e = cfg.moe_top_k + cfg.moe_shared_experts
            total += cfg.moe_num_experts * d \
                + active_e * n_mats * d * cfg.expert_d_ff
        else:
            total += n_mats * d * cfg.d_ff
    if cfg.is_enc_dec:
        # encoder layers + decoder cross-attention
        enc = cfg.encoder_layers * (d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads)
                                    + cfg.n_heads * dh * d
                                    + 2 * d * cfg.d_ff)
        cross = cfg.n_layers * (d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads)
                                + cfg.n_heads * dh * d)
        total += enc + cross
    total += d * cfg.padded_vocab           # unembed matmul
    return total


def model_flops(arch: str, shape_name: str) -> float:
    shape = configs.get_shape(shape_name)
    n_act = active_params(config_for(arch, shape_name))
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens
    return 2.0 * n_act * shape.global_batch        # decode: 1 token/request


def terms(record: dict) -> dict:
    """A record's compute and memory times at its card's peaks (the bf16
    tensor-core rate for the FLOPs, the memory rate for the bytes), the
    larger of them (``bound_s``, the step's roofline time) and which it
    is (``bound_by``)."""
    _, (bw, _, bf16_peak) = peaks(record.get("card", "H100"))
    t = {"compute_s": record["flops_per_device"] / bf16_peak,
         "memory_s": record["bytes_accessed_per_device"] / bw}
    t["bound_s"] = max(t["compute_s"], t["memory_s"])
    t["bound_by"] = ("compute" if t["compute_s"] > t["memory_s"]
                     else "memory")
    return t


def roofline_row(record: dict) -> dict:
    """The reference's row for one record at its card's peaks
    (``terms``) and its collective term at the card's link rate
    (``collective_note`` says what it is)."""
    t = terms(record)
    n_dev = record["devices"]
    coll = record["collective_bytes_per_device"].get("total", 0)
    link_name, link = link_rate(record.get("card", "H100"))
    if n_dev == 1:
        note = "one card: no collective"
    else:
        note = (f"reckoned: {coll / 1e9:.3f} GB a device over {link_name}'s "
                f"NVLink at {link / 1e9:g} GB/s each way, a lower bound: "
                f"{n_dev} cards span {-(-n_dev // 8)} nodes and between "
                "them traffic crosses a slower network")
    flops = record["flops_per_device"]
    mf_dev = model_flops(record["arch"], record["shape"]) / n_dev
    return {
        "arch": record["arch"],
        "shape": record["shape"],
        "devices": n_dev,
        "compute_s": t["compute_s"],
        "memory_s": t["memory_s"],
        "collective_s": coll / link,
        "collective_note": note,
        "dominant": max((("compute", t["compute_s"]),
                         ("memory", t["memory_s"]),
                         ("collective", coll / link)),
                        key=lambda kv: kv[1])[0],
        "model_flops_per_device": mf_dev,
        "useful_flops_ratio": mf_dev / flops if flops > 0 else 0.0,
        "hbm_gb_per_device": record["memory_analysis"].get(
            "argument_bytes", 0) / 1e9,
    }


# ---------------------------------------------------------------------------
# The fused OTA round step (K1): the reference's reckoning of one launch
# per uplink dtype, against the unfused four-op chain, at the card's peaks
# ---------------------------------------------------------------------------

_UPLINK_WIRE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}


def ota_round_step_roofline(n: int = 10, d: int = 814_090,
                            card: str = "H100") -> list:
    """Compute/memory terms of one fused round-step launch at [N, D]:
    the [N, D] uplink at wire precision in, z and the params in and the
    params out in f32 (the unfused chain adds a ghat f32 write and read);
    ~3ND FLOPs to dequantize, precode-weight and accumulate, ~4D for the
    noise and the SGD step.  Bytes and FLOPs are the reference's; the
    times are at ``card``'s peaks (the compute term at its bf16 rate, as
    the reference's)."""
    _, (bw, _, bf16_peak) = peaks(card)
    rows = []
    for ud, wire in _UPLINK_WIRE_BYTES.items():
        fused_bytes = n * d * wire + 3 * d * 4
        unfused_bytes = fused_bytes + 2 * d * 4
        flops = 3.0 * n * d + 4.0 * d
        t_compute = flops / bf16_peak
        t_memory = fused_bytes / bw
        rows.append({
            "kernel": "ota_round_step", "uplink_dtype": ud,
            "n": n, "d": d,
            "compute_s": t_compute,
            "memory_s": t_memory,
            "unfused_memory_s": unfused_bytes / bw,
            "dominant": "compute" if t_compute > t_memory else "memory",
            "flops_per_byte": flops / fused_bytes,
            "fused_bytes_mb": fused_bytes / 1e6,
            "unfused_bytes_mb": unfused_bytes / 1e6,
        })
    return rows


def load_records(directory: str = ARTIFACT_DIR, mesh: str = "card") -> list:
    """The records of one mesh: ``card`` (one card), ``pod`` or
    ``multipod``."""
    rows = []
    for path in sorted(glob.glob(os.path.join(directory,
                                              f"*_{mesh}.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def run(directory: str = ARTIFACT_DIR, mesh: str = "card") -> list:
    return [roofline_row(r) for r in load_records(directory, mesh)]


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="card",
                    choices=["card", "pod", "multipod"])
    for row in run(mesh=ap.parse_args().mesh):
        print(row)
    for row in ota_round_step_roofline():
        print(row)
