"""The dense decoders and Mamba-2 on a simulated mesh (module 12b), on the
CPU: ``LocalTensorMode`` runs every rank of a (2, 2) ("data", "model") or
(2, 2, 2) ("pod", "data", "model") mesh for real, at smoke size.

Each case carries the reference's ``PRNGKey(0)`` weights across
(``lm_params_from_jax``, the leaves it inits to 0 or 1 perturbed as in
``test_torch_lm.py``), lays them out by the reference's specs
(``launch.steps.shard_params``) and holds the sharded prefill logits,
then the greedy decode steps' logits and tokens, against the unsharded
port and the reference's own bundle; the caches after them against the
unsharded caches.  The sharded OTA train step is held against the
unsharded step on the reference's replayed draws
(``torch_ref.reference_draws``).  The query-sequence split (heads that
"model" does not divide) and the per-rank KV-head selection (KV heads
that it does not divide) run on (1, 4) and (2, 2) meshes.

Tolerances: the sharded forward is the same f32 math as the unsharded
one with its sums split over ranks (the MLP's and the attention's
output projections are partial sums over "model", the gated norm's sum
of squares too), so the logits agree within rtol 1e-4 / atol 1e-5 of
both, as the port's agree with the reference (``test_torch_lm.py``);
greedy tokens equal.  The train step's parameters within 1e-6 + 1e-5 of
their size after two steps (the gradient's reduction over the batch
slices is a sum in another order), its losses within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor.debug import CommDebugMode

from repro import configs as jconfigs
from repro.core import ota as jota
from repro.models.param import init_params as jinit
from repro.models.registry import build_bundle as jbuild
from repro_torch import configs as tconfigs
from repro_torch import distributed as dist
from repro_torch.kernels import ref as tref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import make_design
from repro_torch.models import sharded
from repro_torch.models.param import (lm_params_from_jax, param_leaves)
from repro_torch.models.registry import build_bundle as tbuild
import torch_ref
from torch_ref import one_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")
# (arch, smoke overrides, mesh shape, batch)
SERVE = {
    "qwen1.5-0.5b-2x2": ("qwen1.5-0.5b", {}, (2, 2), 4),
    "granite-8b-2x2x2": ("granite-8b", {}, (2, 2, 2), 4),
    "mamba2-1.3b-2x2": ("mamba2-1.3b", {}, (2, 2), 4),
    # two SSD groups: the mixer whole on every "model" rank
    "mamba2-1.3b-g2-2x2x2": ("mamba2-1.3b", dict(ssm_ngroups=2), (2, 2, 2),
                             4),
    # the query-sequence split: 6 heads over a "model" axis of 4
    "qwen2.5-14b-h6-1x4": ("qwen2.5-14b", dict(n_heads=6, n_kv_heads=2),
                           (1, 4), 2),
    # 4 q heads over 4, their 2 KV heads selected per rank
    "qwen3-1.7b-1x4": ("qwen3-1.7b", {}, (1, 4), 2),
    # a ring cache of 16 slots and a batch of 1: the cache over "data" by
    # its sequence (the long-context rule), gathered and written back
    "qwen1.5-0.5b-swa16-b1": ("qwen1.5-0.5b", dict(window=16), (2, 2), 1),
}


def _perturb(tree, seed=0):
    rng = np.random.default_rng(seed)

    def one(path, a):
        a = np.asarray(a, np.float32)
        name = jax.tree_util.keystr(path)
        if any(t in name for t in ("'b'", "bkv", "ln", "norm", "a_log",
                                   "dt_bias", "d_skip", "conv_b")):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(one, tree)


def _cfgs(arch, kw):
    return jconfigs.get_config(arch).smoke(**kw), \
        tconfigs.get_config(arch).smoke(**kw)


def _np(x):
    if dist.is_dtensor(x):
        x = x.full_tensor()
    if dist.is_local(x):
        vals = list(x._local_tensors.values())
        for v in vals[1:]:                 # every rank holds the same
            torch.testing.assert_close(v, vals[0], rtol=0, atol=0)
        x = vals[0]
    return np.asarray(x.detach().float().numpy(), np.float32)


def _world(shape):
    return dist.simulated_world(int(np.prod(shape)), local=True)


def _mesh(shape):
    return mesh_lib.make_debug_device_mesh(
        shape[-2], shape[-1], multi_pod=len(shape) == 3)


@pytest.mark.parametrize("case", list(SERVE))
def test_sharded_serve_matches_unsharded_and_reference(case):
    arch, kw, shape, b = SERVE[case]
    jcfg, tcfg = _cfgs(arch, kw)
    tp, dp = shape[-1], shape[-2]
    jb, tb = jbuild(jcfg, tp=1, dp=1), tbuild(tcfg, CPU, tp=tp, dp=dp)
    jp = _perturb(jinit(jb.defs, jax.random.PRNGKey(0)))
    params = lm_params_from_jax(tcfg, jp)
    s, n_dec = 21, 2
    prompts = np.random.default_rng(11).integers(0, jcfg.vocab_size, (b, s))
    want, jcache = jax.jit(jb.prefill)(jp, jnp.asarray(prompts, jnp.int32),
                                       jb.init_caches(b, s + n_dec))
    caches = tb.init_caches(b, s + n_dec)
    plain, caches = tsteps.make_prefill_step(tb)(
        params, torch.from_numpy(prompts), caches)
    np.testing.assert_allclose(_np(plain), np.asarray(want), **TOL)
    with _world(shape):
        mesh = _mesh(shape)
        sp = tsteps.shard_params(params, tb, mesh)
        sc = tsteps.shard_caches(tb.init_caches(b, s + n_dec), mesh, b)
        # the parameters are split: each rank holds less than all of them
        local = sum(_np(torch.tensor(float(v.to_local().numel())))
                    for v in param_leaves(sp).values())
        assert local < tb.num_params
        with CommDebugMode() as comms:
            got, sc = tsteps.make_prefill_step(tb, mesh)(
                sp, torch.from_numpy(prompts), sc)
        assert comms.get_total_counts() > 0
        np.testing.assert_allclose(_np(got), _np(plain), **TOL)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        serve, tserve = tsteps.make_serve_step(tb, mesh), \
            tsteps.make_serve_step(tb)
        jtok = jnp.argmax(want[:, -1:], -1)
        tok = torch.argmax(plain[:, -1:], -1)
        for i in range(n_dec):
            wl, jcache = jax.jit(jb.decode)(jp, jcache, jtok,
                                            jnp.asarray(s + i))
            jtok = jnp.argmax(wl[:, -1, :], -1)[:, None]
            stok, sc = serve(sp, sc, tok, s + i)
            tok, caches = tserve(params, caches, tok, s + i)
            np.testing.assert_array_equal(_np(stok), tok.numpy())
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        for lc, slc in zip(caches, sc):
            for name in lc:
                np.testing.assert_allclose(_np(slc[name]), _np(lc[name]),
                                           **TOL)


def _replayed_draws(gains, params, steps):
    """The reference's draws of ``steps`` rounds (seed 0) as StepDraws:
    h, the coin and one z per leaf, in the ParamTree's leaf order."""
    leaves = param_leaves(params)
    sizes = [v.numel() for v in leaves.values()]
    d = torch_ref.reference_draws(jax.random, jota, gains, [0], steps, sizes,
                                  len(gains), 1, 1)
    out = []
    for t in range(steps):
        z, at = {}, 0
        for (name, v), n in zip(leaves.items(), sizes):
            z[name] = torch.from_numpy(np.array(d["z"][t, 0, at:at + n])
                                       ).reshape(v.shape)
            at += n
        out.append(tsteps.StepDraws(
            h=torch.from_numpy(np.array(d["h"][t, 0])),
            coin=torch.tensor(bool(d["coin"][t, 0])), z=z))
    return out


@pytest.mark.parametrize("arch,shape", [("qwen1.5-0.5b", (2, 2)),
                                        ("mamba2-1.3b", (2, 2, 2))])
def test_sharded_train_step_matches_unsharded(arch, shape):
    """Two OTA train steps: the clients are the mesh's batch slices (2 or
    4), the noise is added once after the reduction."""
    _, tcfg = _cfgs(arch, {})
    tb = tbuild(tcfg, CPU, tp=shape[-1], dp=shape[-2])
    clients = int(np.prod(shape[:-1]))
    design = make_design("vanilla", clients, tb.num_params, 0.02, seed=0,
                         device="cpu")
    tc = tsteps.TrainStepConfig(eta=0.02)
    p0 = tb.init(0)
    draws = _replayed_draws(design.prm.gains, p0, 2)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (clients, 17)))
    ref = tb.init(0)
    step = tsteps.make_train_step(tb, design.pc, design.prm.gains, tc)
    losses = [float(step(ref, tokens, d)[1]["loss"]) for d in draws]
    with _world(shape):
        mesh = _mesh(shape)
        sp = tsteps.shard_params(p0, tb, mesh)
        sstep = tsteps.make_train_step(tb, design.pc, design.prm.gains, tc,
                                       mesh=mesh)
        with pytest.raises(ValueError, match="batch slices"):
            tsteps.make_train_step(tb, design.pc, design.prm.gains[:1], tc,
                                   mesh=mesh)
        calls = tref.attention_ref.calls
        got = [float(_np(sstep(sp, tokens, d)[1]["loss"])) for d in draws]
        np.testing.assert_allclose(got, losses, rtol=1e-5, atol=1e-5)
        for name, v in param_leaves(sp).items():
            want = param_leaves(ref)[name].numpy()
            np.testing.assert_allclose(_np(v), want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    if arch != "mamba2-1.3b":
        assert tref.attention_ref.calls > calls      # the plain attention


def test_query_sequence_split_takes_the_block_offset():
    """6 heads over a "model" axis of 4: a prefill splits the query
    sequence (``_attn_mode`` "seq"), rank r attends from row r S / 4 on
    (its plain attention's query offset); a decode step is whole."""
    _, tcfg = _cfgs("qwen2.5-14b", dict(n_heads=6, n_kv_heads=2))
    tb = tbuild(tcfg, CPU, tp=4, dp=1)
    params = tb.init(0)
    seen = []
    orig = tref.attention_ref

    def spy(q, k, v, *, causal=True, window=None, q_offset=0):
        seen.append((tuple(q.shape), str(q_offset)))
        return orig(q, k, v, causal=causal, window=window, q_offset=q_offset)
    spy.calls = 0
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 16)))
    want, _ = tsteps.make_prefill_step(tb)(params, prompts, None)
    with _world((1, 4)):
        mesh = _mesh((1, 4))
        with dist.mesh_rules(mesh):
            ctx = sharded._Ctx(2)
            assert sharded._attn_mode(ctx, tcfg, 16, False) == "seq"
            assert sharded._attn_mode(ctx, tcfg, 1, True) == "whole"
            assert sharded._attn_mode(ctx, tcfg, 18, False) == "whole"
        sp = tsteps.shard_params(params, tb, mesh)
        tref.attention_ref = spy
        try:
            got, _ = tsteps.make_prefill_step(tb, mesh)(sp, prompts, None)
        finally:
            tref.attention_ref = orig
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    # serving runs each rank's body on its own tensors: one call a rank
    # and layer, on the rank's block of 16 / 4 query rows, from rows 0, 4,
    # 8, 12
    assert len(seen) == 4 * tcfg.n_layers
    assert all(shp == (2, 4, 6, 64) for shp, _ in seen)
    assert [off for _, off in seen[:4]] == ["0", "4", "8", "12"]


def test_unported_archs_are_refused_on_a_mesh():
    for arch in ("recurrentgemma-9b", "seamless-m4t-medium", "mixtral-8x22b",
                 "deepseek-v3-671b"):
        with pytest.raises(NotImplementedError, match="12c"):
            sharded.check_sharded(tconfigs.get_config(arch))
    for arch in ("qwen1.5-0.5b", "qwen3-1.7b", "mamba2-1.3b", "granite-8b",
                 "qwen2.5-14b", "chameleon-34b"):
        sharded.check_sharded(tconfigs.get_config(arch))


def test_simulated_world_is_torn_down_on_failure():
    import torch.distributed as tdist
    with pytest.raises(KeyError):
        with dist.simulated_world(4, local=True):
            assert tdist.is_initialized() and dist.local_mode() is not None
            raise KeyError("inside")
    assert not tdist.is_initialized() and dist.local_mode() is None
    with dist.simulated_world(4):
        with pytest.raises(RuntimeError, match="already open"):
            with dist.simulated_world(2):
                pass
    assert not tdist.is_initialized()


def test_constrain_is_a_no_op_off_the_mesh():
    x = torch.ones(2, 3)
    assert dist.constrain(x, ("batch", None)) is x
    with _world((2, 2)):
        mesh = _mesh((2, 2))
        with dist.mesh_rules(mesh):
            assert dist.constrain(x, ("batch", None)) is x   # plain tensor
            from torch.distributed.tensor import (Replicate, Shard,
                                                  distribute_tensor)
            xd = distribute_tensor(torch.arange(8.).reshape(4, 2),
                                   mesh.device_mesh,
                                   (Replicate(), Replicate()))
            y = dist.constrain(xd, ("batch", None))
            assert tuple(y.placements) == (Shard(0), Replicate())
            # a batch of 1 on a data axis of 2 stays whole
            one = distribute_tensor(torch.ones(1, 2), mesh.device_mesh,
                                    (Replicate(), Replicate()))
            assert tuple(dist.constrain(one, ("batch", None)).placements) \
                == (Replicate(), Replicate())
