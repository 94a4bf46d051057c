"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Copies of the reference's registry (``repro.configs``) for the archs the
port runs: the dense GQA decoders (qwen1.5, qwen3, granite, qwen2.5 and
chameleon's token-in, token-out backbone), mamba2, recurrentgemma (RG-LRU
with local attention), seamless-m4t-medium (the encoder-decoder),
mixtral-8x22b (MoE with sliding-window attention) and deepseek-v3-671b
(MoE with latent attention, MLA, and a multi-token-prediction head).  Any
other arch raises and names ROADMAP.md, where the reference's other archs
are queued.  ``SHAPES`` are the reference's input shapes
(``configs.shapes``); ``launch.train --seq 4096`` trains at ``TRAIN_4K``'s
length.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import (SHAPES, TRAIN_4K,  # noqa: F401
                                        InputShape, get_shape)

_MODULES = {
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_17b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_13b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "qwen2.5-14b": "repro_torch.configs.qwen25_14b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
}
ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"arch {arch!r} is not in repro_torch (ported: "
                         f"{ARCH_IDS}); the reference's other archs are "
                         "queued in ROADMAP.md")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str):
    return _module(arch).CONFIG


def long_context_ok(arch: str) -> bool:
    return bool(getattr(_module(arch), "LONG_CONTEXT_OK", False))


def long_context_config(arch: str):
    """Config used for the long_500k shape (may be a sub-quadratic variant)."""
    mod = _module(arch)
    variant = getattr(mod, "LONG_CONTEXT_VARIANT", None)
    return mod.CONFIG.replace(**variant) if variant else mod.CONFIG


def supported_shapes(arch: str) -> tuple:
    """Shapes this arch runs, per DESIGN.md §Arch-applicability."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if long_context_ok(arch):
        names.append("long_500k")
    return tuple(names)
