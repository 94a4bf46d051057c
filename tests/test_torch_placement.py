"""The port's placement primitives against the reference's.

``repro_torch.launch.mesh``, ``repro_torch.distributed`` and
``repro_torch.fl.placement`` on CPU slots, held against ``repro.launch.mesh``,
``repro.distributed`` and ``repro.fl.placement`` run in a child process with
eight forced host devices (``tests/torch_ref.py::run_reference_placement``,
the ``enable_x64`` shim and ``XLA_FLAGS`` set before jax is imported):

* the meshes' structure (shape, axis names, ``grid_axes``,
  ``num_clients``, ``batch_axes``), ``grid_devices``, ``num_devices``, the
  default axes and the ``describe`` strings, equal for the same meshes and
  cell counts;
* ``process_grid_slice`` for g in 0..9 and P in 1..4, equal;
* ``shard_vmap`` on a batch that fills the four slots, equal to the
  reference's; its padding and masking (G = 7 over 4 slots) against the
  whole-batch call, bitwise: the reference's own padded path raises on
  jax 0.9.0 (slicing the padding off a sharded output is "not
  implemented"), so it has no numbers to compare with there;
* a ``ShardedPlacement`` fleet (4 schemes x 2 seeds, minibatch 8, the
  fused flat tail) on the reference's replayed draws, its initial params
  and its designs, against the reference's ``ShardedPlacement`` fleet at
  the port's usual rtol 1e-4 / atol 1e-5 (``test_torch_fleet.py`` says
  why: the two sides order their f32 sums differently).
"""
import numpy as np
import pytest
import torch

import torch_ref
from repro_torch import distributed
from repro_torch.core import power_control as tpc
from repro_torch.fl import driver as tdriver
from repro_torch.fl.draws import ReplayDraws
from repro_torch.fl.placement import ShardedPlacement, VmapPlacement
from repro_torch.kernels import ref as kref
from repro_torch.launch import mesh as tmesh
from repro_torch.models.param import params_from_jax
from repro_torch.tasks.image import make_paper_mlp
from torch_ref import one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
ROUNDS, EVERY, BATCH, SEEDS = 4, 2, 8, (0, 1)
SCHEMES = ("ideal", "sca", "vanilla", "zero_bias")
XS = np.arange(24, dtype=np.float32).reshape(8, 3)
BIAS = 2.0


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return torch_ref.run_reference_placement(
        tmp_path_factory.mktemp("placement") / "placement.npz", xs=XS,
        bias=BIAS, schemes=SCHEMES, seeds=SEEDS, batch=BATCH, rounds=ROUNDS,
        every=EVERY)


def _meshes():
    return {"debug": tmesh.make_debug_mesh(2, 2, slots=[CPU] * 4),
            "multi_pod": tmesh.make_debug_mesh(2, 2, multi_pod=True,
                                               slots=[CPU] * 8)}


def _f(x, b):
    """The reference test's cell function, batched over the leading axis
    (the port's form of vmap)."""
    return {"out": x * x + b, "norm": torch.sum(x, dim=-1)}


def test_visible_slots_and_the_slot_count(monkeypatch):
    monkeypatch.delenv(tmesh.SLOTS_ENV, raising=False)
    assert tmesh.visible_slots("cpu") == [CPU]
    with pytest.raises(ValueError, match="needs 4 slots"):
        tmesh.make_debug_mesh(2, 2, slots=tmesh.visible_slots("cpu"))
    monkeypatch.setenv(tmesh.SLOTS_ENV, "4")
    assert tmesh.visible_slots("cpu") == [CPU] * 4
    mesh = tmesh.make_debug_mesh(2, 2, slots=tmesh.visible_slots("cpu"))
    assert mesh.size == 4 and mesh.slots() == [CPU] * 4
    monkeypatch.setenv(tmesh.SLOTS_ENV, "0")
    with pytest.raises(ValueError, match="at least one slot"):
        tmesh.visible_slots("cpu")


@pytest.mark.parametrize("label", ["debug", "multi_pod"])
def test_mesh_structure_matches_reference(ref, label):
    want, mesh = ref["meta"][label], _meshes()[label]
    assert mesh.shape == want["shape"]
    assert list(mesh.axis_names) == want["axis_names"]
    assert list(tmesh.grid_axes(mesh)) == want["grid_axes"]
    assert tmesh.num_clients(mesh) == want["num_clients"]
    assert list(tmesh.batch_axes(mesh)) == want["batch_axes"]


@pytest.mark.parametrize("label,axes", [
    (label, axes) for label, options in torch_ref.PLACEMENT_AXES.items()
    for axes in options])
def test_placement_describe_matches_reference(ref, label, axes):
    """``grid_devices``, ``num_devices``, the default axes, ``pad`` (the
    reference's ``_pad``) and the ``describe`` strings, character for
    character."""
    mesh = _meshes()[label]
    pl = ShardedPlacement(mesh) if axes is None \
        else ShardedPlacement(mesh, tuple(axes))
    want = ref["meta"][label]["placements"][",".join(axes or ["default"])]
    assert list(pl.axes) == want["axes"]
    assert pl.num_devices == want["num_devices"] == len(pl.slots)
    assert distributed.grid_devices(mesh, pl.axes) == want["grid_devices"]
    assert pl.describe() == want["describe"]
    for c in torch_ref.PLACEMENT_CELLS:
        assert pl.describe(cells=c) == want["cells"][str(c)]
        assert list(pl.pad(c)) == want["pad"][str(c)]
    assert [VmapPlacement().describe(), VmapPlacement().describe(cells=6)] \
        == ref["meta"]["vmap"]


def test_process_grid_slice_matches_reference(ref):
    got = {}
    for g in range(10):
        for p in range(1, 5):
            for i in range(p):
                sl = distributed.process_grid_slice(g, i, p)
                got["%d/%d/%d" % (g, p, i)] = [sl.start, sl.stop]
            covered = [r for i in range(p) for r in range(
                g)[distributed.process_grid_slice(g, i, p)]]
            assert covered == list(range(g))
    assert got == ref["meta"]["slices"]
    with pytest.raises(ValueError, match="outside"):
        distributed.process_grid_slice(4, 2, 2)
    assert distributed.process_grid_slice(5) == slice(0, 5)   # one process


def test_shard_vmap_matches_reference(ref):
    mesh = _meshes()["debug"]
    got = distributed.shard_vmap(_f, mesh, num_sharded=1)(
        torch.as_tensor(XS), torch.tensor(BIAS))
    np.testing.assert_array_equal(got["out"].numpy(), ref["shard_vmap/out"])
    np.testing.assert_array_equal(got["norm"].numpy(),
                                  ref["shard_vmap/norm"])


def test_shard_vmap_padding_and_masking():
    """G = 7 over 4 slots: padded with copies of row 0 to 8, cut into
    blocks of 2 in slot order, the padding sliced off; every row equals
    the whole-batch call, and ``fn`` saw blocks of 2 with row 0 repeated
    in the last."""
    mesh = tmesh.make_debug_mesh(2, 2, slots=[CPU] * 4)
    xs = torch.arange(21, dtype=torch.float32).reshape(7, 3)
    seen = []

    def f(x, b):
        seen.append(x.clone())
        return _f(x, b)
    got = distributed.shard_vmap(f, mesh, num_sharded=1)(xs,
                                                         torch.tensor(BIAS))
    want = _f(xs, torch.tensor(BIAS))
    assert got["out"].shape == (7, 3) and got["norm"].shape == (7,)
    assert torch.equal(got["out"], want["out"])
    assert torch.equal(got["norm"], want["norm"])
    assert [tuple(b.shape) for b in seen] == [(2, 3)] * 4
    assert torch.equal(seen[3], torch.stack([xs[6], xs[0]]))


def test_sharded_fleet_matches_reference(ref):
    """The port's ShardedPlacement fleet on the reference's draws, params
    and designs against the reference's ShardedPlacement fleet; the round
    tail ran once a slot a round (its plain version, on the CPU)."""
    task = make_paper_mlp(hidden=16, samples_per_class=40)
    td = task.build_data(0)
    schemes = [tpc.scheme_from_jax(n, torch_ref.prefixed(ref, f"scheme/{n}"))
               for n in SCHEMES]
    draws = ReplayDraws(ref["draws/h"], ref["draws/z"], ref["draws/idx"],
                        ref["draws/coin"], CPU)
    run = task.run_config(num_rounds=ROUNDS, eval_every=EVERY, seed=0,
                          batch_size=BATCH)
    pl = ShardedPlacement(tmesh.make_debug_mesh(2, 2, slots=[CPU] * 4))
    before = kref.ota_round_step_ref.calls
    res = tdriver.run_fleet_task(
        task, schemes, ref["gains"], run, task_data=td,
        params=params_from_jax(torch_ref.prefixed(ref, "params0")),
        seeds=SEEDS, flat=True, draws=draws, placement=pl, device="cpu")
    assert kref.ota_round_step_ref.calls - before == 4 * ROUNDS
    assert res.names == SCHEMES and res.seeds == SEEDS
    want = torch_ref.prefixed(ref, "sharded/params")
    for k in ("b1", "b2", "w1", "w2"):
        np.testing.assert_allclose(res.params[k].numpy(), want[k], **TOL,
                                   err_msg=k)
    want = torch_ref.prefixed(ref, "sharded/traces")
    assert set(res.traces) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(res.traces[k], v, **TOL, err_msg=k)
    assert [t for t, _ in res.evals] == list(ref["sharded/evals_t"])
    for k, v in torch_ref.prefixed(ref, "sharded/evals").items():
        np.testing.assert_allclose(np.stack([ev[k] for _, ev in res.evals]),
                                   v, **TOL, err_msg=k)
