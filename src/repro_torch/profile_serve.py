"""Where the LM serve path's time goes, on the card.

    python -m repro_torch.profile_serve [--arch qwen1.5-0.5b|mamba2-1.3b|
        recurrentgemma-9b|seamless-m4t-medium|...] [--batch 8]
        [--prompt-len 1024] [--decode-tokens 32]
    python -m repro_torch.profile_serve --arch mixtral-8x22b --layers 12
    python -m repro_torch.profile_serve --arch deepseek-v3-671b --layers 4

Runs ``repro_torch.launch.serve.run`` at full width (warm-up, then a timed
prefill and decode on the host clock between device synchronizations),
then one more prefill (of the same inputs: an encoder-decoder's frames
and prompts) and the same decode steps under ``torch.profiler``, through
the model's bundle.  ``--layers`` cuts the arch's depth at full width,
for a model that fits the card only so (mixtral-8x22b's 56 layers are
281 GB in bf16, 12 are 61 GB; deepseek-v3-671b's 61 are 1.34 TB, its
first 4, three dense and one MoE, 31.6 GB).
For each of the two phases it prints the unprofiled wall, the device time
summed over every kernel the profiler saw, the device's busy share (one
stream, so kernels do not overlap), the kernel launches, the port's own
kernels (K3 flash attention, K4 the SSD scan: device ms, launches, share
of the phase's device time), and the kernels that take the most device
time.  The last line is one JSON object with those numbers.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import collections
import json

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models.registry import build_bundle

# the port's kernels, by a part of their symbol's name
PORT_KERNELS = {"K3": "flash_attention_kernel", "K4": "ssd_scan_kernel"}


def _device_events(prof):
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events; time "
                           "the steps with CUDA events instead")
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    return len(kernels), by_name


def _report(label, wall_ms, per, prof, top_n=12):
    """One phase's numbers, per prefill or per decode step (``per``)."""
    n, by_name = _device_events(prof)
    device_ms = sum(us for _, us in by_name.values()) / 1e3 / per
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]
    print(f"{label}: wall {wall_ms:.3f} ms; device time {device_ms:.3f} ms; "
          f"busy share {device_ms / wall_ms:.3f}; {n / per:.1f} launches")
    port = {}
    for key, part in PORT_KERNELS.items():
        k = sum(c for name, (c, _) in by_name.items() if part in name)
        ms = sum(us for name, (_, us) in by_name.items()
                 if part in name) / 1e3 / per
        port[key] = {"ms": ms, "launches": k / per,
                     "share": ms / device_ms if device_ms else 0.0}
        if k:
            print(f"  {key}: {ms:.4f} ms in {k / per:.1f} launches, "
                  f"{port[key]['share']:.3f} of the device time")
    rows = []
    for name, (k, us) in top:
        print(f"  {us / 1e3 / per:8.4f} ms  {k / per:6.1f} launches  "
              f"{name[:100]}")
        rows.append({"name": name[:100], "ms": us / 1e3 / per,
                     "launches": k / per})
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "launches": n / per,
            "port_kernels": port, "top": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=configs.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--decode-tokens", type=int, default=32)
    ap.add_argument("--layers", type=int, default=0,
                    help="serve the first N layers (default: all)")
    a = ap.parse_args(argv)
    cfg = configs.get_config(a.arch)
    if a.layers:
        cfg = cfg.replace(n_layers=a.layers)
    res = serve.run(cfg, batch=a.batch, prompt_len=a.prompt_len,
                    decode_tokens=a.decode_tokens)
    st = res.stats
    dev = res.prompts.device
    steps = a.decode_tokens - 1
    bundle = build_bundle(cfg, dev)
    caches = bundle.init_caches(a.batch, a.prompt_len + a.decode_tokens)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof_prefill:
        _, caches = bundle.prefill(res.params, res.inputs, caches)
        torch.cuda.synchronize(dev)
    with profile(activities=acts) as prof_decode:
        for i in range(steps):
            _, caches = bundle.decode(res.params, caches,
                                      res.tokens[:, i:i + 1],
                                      a.prompt_len + i)
        torch.cuda.synchronize(dev)
    print(f"card {st['card_line']}; {cfg.name}, {cfg.n_layers} layers, "
          f"batch {a.batch}, prompt {a.prompt_len}, {steps} decode steps")
    out = {"card": st["card_line"], "arch": cfg.name,
           "layers": cfg.n_layers, "batch": a.batch,
           "prompt_len": a.prompt_len,
           "prefill": _report("prefill", st["prefill_ms"], 1, prof_prefill),
           "decode_step": _report("decode step", st["decode_ms_per_token"],
                                  steps, prof_decode)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
