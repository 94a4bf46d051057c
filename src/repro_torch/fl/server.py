"""Run configuration of an FL experiment (``repro.fl.server.FLRunConfig``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FLRunConfig:
    eta: float = 0.05
    num_rounds: int = 200
    gmax: float = 10.0
    batch_size: int = 0            # 0 = full batch (paper §IV)
    eval_every: int = 10
    seed: int = 0
    clip_to_gmax: bool = True
    uplink_dtype: str = "f32"      # wire precision devices transmit on the
    #                                uplink: f32 | bf16 | int8 (per-device
    #                                symmetric scale); non-f32 requires the
    #                                flat aggregation path.  See
    #                                kernels.ops.quantize_uplink.
