"""``python -m repro_torch.grid_smoke --launch --device cpu``: two worker
processes, four CPU slots each, joined through
``distributed.initialize_multiprocess``'s ``TCPStore``, each running its
``process_grid_slice`` of the scenario axis as one sharded grid fleet and
the C = 1 canary; the canary digests agree across the processes and the
slices compose the axis.  A corrupted canary digest (the workers'
``--corrupt-canary`` fault injection) makes both workers and the parent
exit non-zero.

The designs are made once, on the CPU, and handed to both launches
(``write_designs``; the parent would otherwise make them itself).  Each
launch has a timeout of its own, so a hung worker fails its test and is
killed.  The workers run one intra-op thread (``OMP_NUM_THREADS=1``):
their ops are tiny, and the suite's workers share the cores.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import grid_smoke
from torch_ref import one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240


@pytest.fixture(scope="module")
def designs(tmp_path_factory):
    return grid_smoke.write_designs(
        tmp_path_factory.mktemp("grid_smoke") / "designs.pkl")


def _launch(designs, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_TORCH_DEVICE_SLOTS", None)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.grid_smoke", "--launch",
         "--device", "cpu", "--designs", str(designs),
         "--timeout", str(TIMEOUT), *extra],
        capture_output=True, text=True, env=env, cwd=str(ROOT),
        timeout=TIMEOUT + 60)


def test_grid_smoke_two_processes(designs):
    proc = _launch(designs)
    out = proc.stdout
    assert proc.returncode == 0, out[-3000:] + proc.stderr[-3000:]
    assert "[p0] joined: 2 processes, 4 local slots on ['cpu']" in out
    assert "[p1] joined: 2 processes, 4 local slots on ['cpu']" in out
    assert "[p0] slice ['disk_rayleigh', 'disk_rician'] on " \
        "sharded[data=2,model=2,cells=8,pad=0/8]" in out
    assert "[p1] slice ['disk_markov', 'disk_dropout']" in out
    assert out.count("canary bitwise across 2 processes") == 2
    assert "[p0] 4 scenarios covered by 2 disjoint process slices; " \
        "16 cells total" in out
    assert "grid smoke OK" in out


def test_grid_smoke_corrupted_canary_fails(designs):
    proc = _launch(designs, "--corrupt-canary", "1")
    assert proc.returncode != 0
    assert "grid smoke FAILED" in proc.stderr
    assert proc.stdout.count("canary digest mismatch") == 2
