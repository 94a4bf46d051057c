"""PyTorch + CUDA port of the OTA-FL fleet (the JAX package ``repro`` stays
the reference).

The layout mirrors ``src/repro/`` where that helps a reader find the
counterpart of a module.  The package imports ``torch``, ``numpy`` and
``scipy`` only: never ``jax`` and nothing of ``repro``.  Entry points take
``device=None``, which means CUDA, and raise when no card is present unless
the caller passes ``device="cpu"`` (``repro_torch.device.resolve_device``).
"""
