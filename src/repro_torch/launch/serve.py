"""Batched decode driver: prefill a batch of prompts, then step the decoder
greedily against the KV cache (GQA layers) or the recurrent state (ssd
and rglru layers).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --batch 8 --prompt-len 1024 --decode-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --batch 8 --prompt-len 1024 --decode-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --batch 8 --prompt-len 1024 \
        --decode-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --batch 8 --prompt-len 1024 \
        --decode-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch mixtral-8x22b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --smoke --device cpu

The port of ``repro.launch.serve``, with ``--device`` (default: the CUDA
card; without one it raises unless ``--device cpu`` is given).  Weights are
random, drawn from ``--seed`` with the reference's init laws; prompts are
drawn from ``--seed`` + 1.  An encoder-decoder also takes frames, as the
reference serves it: ``[B, prompt_len, d_model]`` float32 standard
normals (the stub front end's embeddings), drawn from the same generator
before the prompts.  On the card, one untimed prefill and decode
step of the same shapes runs first (the build of the kernels the arch
uses, library loading); each time printed is then a host clock between two
device synchronizations.  Prints the reference's lines, then one JSON line
with the times, the tokens per second, the launches per prefill of K3
(flash attention) and K4 (the SSD scan), and the card's name and power
limit.  mixtral-8x22b at full depth (281 GB in bf16) and
deepseek-v3-671b (1.34 TB) do not fit one card: ``serve.run`` takes any
config, and ``chip_smoke.py`` and ``profile_serve --layers`` serve their
first layers at full width.  Serving never runs deepseek's MTP head (the
reference's ``forward`` does not).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.device import DeviceLike
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_bundle


@dataclasses.dataclass
class ServeResult:
    cfg: ModelConfig
    params: torch.nn.Module
    prompts: torch.Tensor        # [B, prompt_len]
    logits: torch.Tensor         # prefill logits [B, prompt_len, V] f32
    tokens: torch.Tensor         # greedy tokens [B, decode_tokens]
    stats: dict                  # what the JSON line prints
    frames: Optional[torch.Tensor] = None   # enc-dec: [B, prompt_len, D]

    @property
    def inputs(self):
        """What the prefill took: the prompts, or (frames, prompts)."""
        return self.prompts if self.frames is None \
            else (self.frames, self.prompts)


def card_line() -> Optional[str]:
    """``name, power limit`` of the first card, as nvidia-smi gives it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def kernel_libraries(cfg: ModelConfig) -> list:
    """The CUDA libraries a prefill of ``cfg`` launches: K3's for GQA and
    MLA layers (an encoder-decoder's decoder has them), K4's for ssd
    layers."""
    kinds = {kind for kind, _ in tfm.layer_sigs(cfg)}
    return ([name for name, uses in (("flash_attention", tfm.GQA_KINDS),
                                     ("ssd_scan", ("ssd",)))
             if kinds & set(uses)])


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def run(cfg: ModelConfig, *, batch: int, prompt_len: int, decode_tokens: int,
        seed: int = 0, device: DeviceLike = None) -> ServeResult:
    """Prefill ``batch`` random prompts, then decode ``decode_tokens``
    greedy tokens (the first from the prefill's logits)."""
    if decode_tokens < 1:
        raise ValueError("decode_tokens must be >= 1")
    if cfg.input_mode != "tokens" and not cfg.is_enc_dec:
        # the reference hands such a model token ids, which it cannot take
        raise ValueError(f"{cfg.name}: a decoder-only model of "
                         f"{cfg.input_mode} inputs has no token loop to serve")
    bundle = build_bundle(cfg, device)
    dev = bundle.device
    params = bundle.init(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    frames = torch.randn((batch, prompt_len, cfg.d_model), generator=gen,
                         device=dev) if cfg.is_enc_dec else None
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev)
    inputs = prompts if frames is None else (frames, prompts)
    max_len = prompt_len + decode_tokens
    prefill = steps_lib.make_prefill_step(bundle)
    serve = steps_lib.make_serve_step(bundle)

    if dev.type == "cuda":                  # untimed warm-up, same shapes
        for name in kernel_libraries(cfg):
            build.library(name)
        caches = bundle.init_caches(batch, max_len)
        logits, caches = prefill(params, inputs, caches)
        serve(params, caches, logits[:, -1:].argmax(-1), prompt_len)
        del logits, caches

    caches = bundle.init_caches(batch, max_len)
    k3, k4 = flash_attention.launches, ssd_scan.launches
    t0 = _sync(dev)
    logits, caches = prefill(params, inputs, caches)
    t_prefill = _sync(dev) - t0
    k3, k4 = flash_attention.launches - k3, ssd_scan.launches - k4
    tok = torch.argmax(logits[:, -1:, :], dim=-1)
    outs = [tok]
    t0 = _sync(dev)
    for i in range(decode_tokens - 1):
        tok, caches = serve(params, caches, tok, prompt_len + i)
        outs.append(tok)
    t_decode = _sync(dev) - t0
    tokens = torch.cat(outs, dim=1)

    n_dec = decode_tokens - 1
    stats = {
        "arch": cfg.name, "params": bundle.num_params,
        "device": str(dev), "batch": batch, "prompt_len": prompt_len,
        "decode_tokens": decode_tokens,
        "prefill_ms": 1e3 * t_prefill,
        "prefill_tok_s": batch * prompt_len / max(t_prefill, 1e-9),
        "decode_ms_per_token": 1e3 * t_decode / max(n_dec, 1),
        "decode_tok_s": n_dec * batch / max(t_decode, 1e-9),
        "k3_launches_per_prefill": k3,
        "k4_launches_per_prefill": k4,
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else None,
        "card_line": card_line() if dev.type == "cuda" else None,
    }
    return ServeResult(cfg, params, prompts, logits, tokens, stats, frames)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=configs.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-tokens", type=int, default=32)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    res = run(cfg, batch=args.batch, prompt_len=args.prompt_len,
              decode_tokens=args.decode_tokens, seed=args.seed,
              device=args.device)
    st, b = res.stats, args.batch
    print(f"arch={cfg.name} params={st['params'] / 1e6:.1f}M")
    print(f"prefill: {st['prefill_ms']:.1f} ms "
          f"({st['prefill_tok_s']:.0f} tok/s)")
    print(f"decode:  {st['decode_ms_per_token'] * (args.decode_tokens - 1):.1f}"
          f" ms ({st['decode_tok_s']:.0f} tok/s, batch={b})")
    print("sample next tokens:", res.tokens[:, 0].tolist())
    print(json.dumps(st), flush=True)
    return res


if __name__ == "__main__":
    main()
