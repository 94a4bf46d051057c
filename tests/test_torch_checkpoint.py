"""The port's checkpoints (``repro_torch.checkpoint``) and the fleet's
chunk-boundary save and resume (``fl.driver``, ``fig2.run``).

* The archive is the reference's format: npz, '/'-joined keys, the meta as
  JSON bytes under ``__meta__`` inside it.  The reference's
  ``repro.checkpoint.checkpoint`` (numpy and jax only, no x64 shim
  needed) reads what the port writes, and the port reads what it writes.
* The reference's resume contract: a run stopped after its first chunk
  (``max_chunks=1``) and resumed ends bitwise equal to an uninterrupted
  run (params, traces, evals), on a shrunk paper_mlp, minibatch fused and
  unfused and full batch.  The draws are keyed per (seed, round), so the
  resumed rounds see the same draws.
* A checkpoint of another run (its identity differs) is refused.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro_torch import fig2, tasks
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.fl.driver import run_fleet_task
from torch_ref import one_thread  # noqa: F401 (autouse)

CPU = "cpu"
ROUNDS, EVERY, BATCH = 7, 3, 8


def _tree():
    return {"params": {"w": torch.arange(6, dtype=torch.float32)
                       .reshape(2, 3), "b": torch.ones(3, dtype=torch.float64)},
            "evals_t": np.asarray([0, 3], np.int64),
            "list": [torch.zeros(2, dtype=torch.int32), np.float32(1.5)]}


def test_save_restore_round_trip(tmp_path):
    path = str(tmp_path / "a" / "ck")
    tree = _tree()
    ckpt.save(path, tree, meta={"chunks_done": 2})
    assert ckpt.exists(path) and not ckpt.exists(str(tmp_path / "nope"))
    assert not list(tmp_path.rglob("*.tmp*"))
    got = ckpt.restore(path, tree)
    for key, leaf in ckpt._leaves(tree):
        want = dict(ckpt._leaves(got))[key]
        if isinstance(leaf, torch.Tensor):
            assert want.dtype == leaf.dtype and torch.equal(want, leaf)
        else:
            np.testing.assert_array_equal(want, leaf)
            assert np.asarray(want).dtype == np.asarray(leaf).dtype
    assert isinstance(got["list"], list)
    assert ckpt.load_meta(path) == {"chunks_done": 2}


def test_restore_walks_the_template(tmp_path):
    """Extra keys in the archive are ignored; a key the template names and
    the archive lacks raises, and so does a shape mismatch."""
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, _tree())
    got = ckpt.restore(path, {"params": {"w": torch.zeros(2, 3)}})
    assert torch.equal(got["params"]["w"], _tree()["params"]["w"])
    with pytest.raises(KeyError):
        ckpt.restore(path, {"params": {"missing": torch.zeros(1)}})
    with pytest.raises(ValueError):
        ckpt.restore(path, {"params": {"w": torch.zeros(3, 2)}})
    with pytest.raises(ValueError):
        ckpt.save(path, {"__meta__": np.zeros(1)})


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_archive_matches_reference_format(tmp_path, writer):
    flat = {"carry": {"params": {"w": np.arange(4, dtype=np.float32)}},
            "evals_t": np.asarray([0, 9], np.int64)}
    meta = {"chunks_done": 3, "rounds_done": 10, "names": ["a", "b"]}
    path = str(tmp_path / "ck")
    if writer == "port":
        ckpt.save(path, {"carry": {"params": {"w": torch.from_numpy(
            flat["carry"]["params"]["w"])}}, "evals_t": flat["evals_t"]},
            meta=meta)
        got, got_meta = jckpt.load_flat(path), jckpt.load_meta(path)
    else:
        jckpt.save(path, flat, meta=meta)
        got, got_meta = ckpt.load_flat(path), ckpt.load_meta(path)
    assert got_meta == meta
    assert sorted(got) == ["carry/params/w", "evals_t"]
    np.testing.assert_array_equal(got["carry/params/w"],
                                  flat["carry"]["params"]["w"])
    np.testing.assert_array_equal(got["evals_t"], flat["evals_t"])


@pytest.fixture(scope="module")
def world():
    task = tasks.get("paper_mlp", hidden=16, samples_per_class=40)
    dep, prm, td = fig2.build_world(task, 0)
    return task, dep, td, fig2.make_schemes(task, dep, prm, device=CPU)


VARIANTS = {"fused": dict(batch_size=BATCH, flat=True),
            "unfused": dict(batch_size=BATCH, flat=True, fuse_round=False),
            "full_batch": dict(batch_size=0, flat=False)}


def _run(world, variant, **kw):
    task, dep, td, schemes = world
    v = dict(VARIANTS[variant])
    run = task.run_config(num_rounds=ROUNDS, eval_every=EVERY, seed=0,
                          batch_size=v.pop("batch_size"))
    return run_fleet_task(task, schemes, dep.gains, run, task_data=td,
                          seeds=(0, 1), device=CPU, **v, **kw)


def _assert_bitwise(a, b):
    assert set(a.params) == set(b.params)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert set(a.traces) == set(b.traces)
    for k in a.traces:
        np.testing.assert_array_equal(a.traces[k], b.traces[k], err_msg=k)
    assert [t for t, _ in a.evals] == [t for t, _ in b.evals]
    for (_, ea), (_, eb) in zip(a.evals, b.evals):
        assert set(ea) == set(eb)
        for k in ea:
            np.testing.assert_array_equal(ea[k], eb[k], err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kill_after_chunk_one_and_resume_bitwise(world, tmp_path, variant):
    path = str(tmp_path / "fleet")
    whole = _run(world, variant)
    first = _run(world, variant, checkpoint_path=path, max_chunks=1)
    assert [n for n, _ in first.chunk_walls] == [1]    # chunk 1: round 0
    assert len(first.evals) == 1 and ckpt.load_meta(path)["rounds_done"] == 1
    rest = _run(world, variant, checkpoint_path=path, resume=True)
    assert sum(n for n, _ in rest.chunk_walls) == ROUNDS - 1
    _assert_bitwise(whole, rest)
    meta = ckpt.load_meta(path)
    assert meta["chunks_done"] == len(whole.evals) == 3    # rounds 0, 3, 6
    assert meta["rounds_done"] == ROUNDS and meta["task"] == "paper_mlp"


def test_resume_without_a_checkpoint_runs_from_the_start(world, tmp_path):
    whole = _run(world, "fused")
    got = _run(world, "fused", checkpoint_path=str(tmp_path / "none"),
               resume=True)
    _assert_bitwise(whole, got)


MISMATCHES = {
    "etas": dict(etas=[0.01] * 7),
    "seeds": dict(seeds=(0, 2)),
    "fuse_round": dict(fuse_round=False),
    "uplink_dtype": dict(uplink_dtype="bf16"),
    "schemes": "drop the last scheme",
    "design": "the same names, another sca design",
    "run": "another eval cadence",
}


@pytest.mark.parametrize("what", list(MISMATCHES))
def test_resume_refuses_another_runs_checkpoint(world, tmp_path, what):
    task, dep, td, schemes = world
    path = str(tmp_path / "fleet")
    run = task.run_config(num_rounds=ROUNDS, eval_every=EVERY, seed=0,
                          batch_size=BATCH)
    kw = dict(task_data=td, seeds=(0, 1), flat=True, device=CPU)
    run_fleet_task(task, schemes, dep.gains, run, checkpoint_path=path,
                   max_chunks=1, **kw)
    change = MISMATCHES[what]
    if what == "schemes":
        schemes = schemes[:-1]
    elif what == "design":
        schemes = [dataclasses.replace(pc, gamma=0.5 * pc.gamma)
                   if pc.name == "sca" else pc for pc in schemes]
    elif what == "run":
        run = task.run_config(num_rounds=ROUNDS, eval_every=EVERY + 1,
                              seed=0, batch_size=BATCH)
    else:
        kw.update(change)
    with pytest.raises(ValueError, match="does not match this fleet"):
        run_fleet_task(task, schemes, dep.gains, run, checkpoint_path=path,
                       resume=True, **kw)


def test_fig2_run_checkpoint_and_resume(world, tmp_path):
    """The entry point's knobs: ``fig2.run(checkpoint_path, max_chunks)``,
    then ``resume=True``, equal to one uninterrupted ``fig2.run``."""
    task, dep, td, schemes = world
    kw = dict(num_rounds=5, eval_every=2, seed=0, batch_size=BATCH,
              task=task, save=False, designs=schemes, device=CPU)
    hist, whole = fig2.run(**kw)
    path = str(tmp_path / "fig2")
    fig2.run(checkpoint_path=path, max_chunks=2, **kw)
    hist2, rest = fig2.run(checkpoint_path=path, resume=True, **kw)
    _assert_bitwise(whole, rest)
    assert hist2 == {k: [dict(r, wall=rest.wall) for r in v]
                     for k, v in hist.items()}
