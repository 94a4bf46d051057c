"""The paper's own experiment configuration (§IV).

MNIST-like 10-class 28x28 task, 1-hidden-layer MLP (d = 814,090), N = 10
devices in a 1750 m disk, non-iid 2-labels-per-device split, full-batch
local gradients, G_max = 10.  A copy of ``repro.configs.paper_mlp``: the
port keeps its own so that it never imports the JAX package.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.channel import WirelessConfig


@dataclasses.dataclass(frozen=True)
class PaperExperiment:
    num_devices: int = 10
    samples_per_class: int = 1000
    num_classes: int = 10
    labels_per_device: int = 2
    max_devices_per_label: int = 2
    gmax: float = 10.0
    local_batch: int = 0          # 0 = full batch (sigma_m = 0, as in §IV)
    num_rounds: int = 400
    eta: float = 0.05             # grid-searched per scheme in benchmarks
    seed: int = 0

    def wireless(self) -> WirelessConfig:
        return WirelessConfig(num_devices=self.num_devices, seed=self.seed)


CONFIG = PaperExperiment()
