"""OTA-FL training of a transformer on the port
(``examples/train_fl_transformer.py``).

    python -m repro_torch.examples.train_fl_transformer [--full]
        [--steps N] [--scheme sca] [--device D]

Wraps ``python -m repro_torch.launch.train`` with a qwen-family config
sized by the reference: by default d_model 512 and 8 layers for 200 steps
(``lm_curves.PRESET``, the preset the LM curves gate runs), ``--full``
d_model 768 and 12 layers for 300.  The workload is the registry's
``token_stream`` task; the script picks sizes and a power-control scheme.
At 50 steps or more the mean of the last 10 losses must be below that of
the first 10.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.launch import train
from repro_torch.lm_curves import PRESET


def train_argv(full: bool = False, steps: int = 0,
               scheme: str = "sca") -> list:
    """``launch.train``'s arguments at the reference's two sizes."""
    d, layers, n = (768, 12, 300) if full else \
        (PRESET["d_model"], PRESET["n_layers"], PRESET["steps"])
    return ["--arch", PRESET["arch"], "--smoke", "--d-model",
            str(d), "--layers", str(layers),
            "--steps", str(steps or n), "--seq", str(PRESET["seq"]),
            "--clients", str(PRESET["clients"]), "--scheme", scheme,
            "--eta", str(PRESET["eta"]), "--log-every",
            str(PRESET["log_every"])]


def check_losses(losses) -> str:
    """The reference's check: at 50 steps or more the last 10 losses'
    mean is below the first 10's (single steps carry the OTA receiver
    noise by design, so a window is compared)."""
    if len(losses) >= 50:
        early, late = np.mean(losses[:10]), np.mean(losses[-10:])
        assert late < early, \
            f"training did not reduce the loss: {early} -> {late}"
        return f"OK: loss improved under OTA-FL SGD ({early:.3f} -> " \
               f"{late:.3f})"
    return f"short run ({len(losses)} steps): loss {losses[0]:.3f} -> " \
           f"{losses[-1]:.3f}"


def main(argv=None):
    """The CLI.  Returns the ``TrainResult``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="d_model 768, 12 layers, 300 steps")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--scheme", default="sca")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    argv_t = train_argv(a.full, a.steps, a.scheme)
    if a.device is not None:
        argv_t += ["--device", a.device]
    res = train.main(argv_t)
    print(check_losses(res.losses), flush=True)
    return res


if __name__ == "__main__":
    main()
