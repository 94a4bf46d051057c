"""Serving on the port: batched prefill and decode for three architecture
families, a dense KV cache, an SSM state and a hybrid ring cache
(``examples/serve_decode.py``).

    python -m repro_torch.examples.serve_decode [--device D]

Each arch runs through ``python -m repro_torch.launch.serve`` at its smoke
width, batch 2, prompt 32, 16 decode tokens: qwen1.5-0.5b's prefill
through K3, mamba2-1.3b's through K4 (on the card).
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve

ARCHS = ("qwen1.5-0.5b", "mamba2-1.3b", "recurrentgemma-9b")
SERVE_ARGS = ("--smoke", "--batch", "2", "--prompt-len", "32",
              "--decode-tokens", "16")


def main(argv=None) -> dict:
    """The CLI.  Returns {arch: ``serve.ServeResult``}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    dev = [] if a.device is None else ["--device", a.device]
    out = {}
    for arch in ARCHS:
        print(f"\n=== {arch} ===", flush=True)
        out[arch] = serve.main(["--arch", arch, *SERVE_ARGS, *dev])
    return out


if __name__ == "__main__":
    main()
