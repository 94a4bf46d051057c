"""The language models on a simulated mesh (modules 12b and 12c), on the
CPU: ``LocalTensorMode`` runs every rank of a (2, 2) ("data", "model") or
(2, 2, 2) ("pod", "data", "model") mesh for real, at smoke size: the
dense decoders, Mamba-2, RecurrentGemma (the RG-LRU and its local
attention), the encoder-decoder (frames and tokens, self and cross
caches) and MoE (experts over "data", or over D where the data axis does
not divide E).

Each case carries the reference's ``PRNGKey(0)`` weights across
(``lm_params_from_jax`` / ``encdec_params_from_jax``, the leaves it inits
to 0 or 1 perturbed as in ``test_torch_lm.py``), lays them out by the
reference's specs
(``launch.steps.shard_params``) and holds the sharded prefill logits,
then the greedy decode steps' logits and tokens, against the unsharded
port and the reference's own bundle; the caches after them against the
unsharded caches.  The sharded OTA train step is held against the
unsharded step on the reference's replayed draws
(``torch_ref.reference_draws``), the MoE's aux loss included.  An MoE
layer moves no activation over the batch axes (its dispatch and combine
are local to the batch shard): its collectives over "data" are its
weights' gathers and the aux loss's [E] sums, the same bytes at any
batch.  The query-sequence split (heads that
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
from torch.utils._python_dispatch import TorchDispatchMode

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
from repro_torch.models import moe as tmoe
from repro_torch.models import sharded
from repro_torch.models.param import (encdec_params_from_jax,
                                      lm_params_from_jax, param_leaves)
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
    # the RG-LRU's channels over "model", and its local attention layer
    "recurrentgemma-9b-2x2": ("recurrentgemma-9b", dict(n_layers=3), (2, 2),
                              4),
    # a width of 255 channels: the RG-LRU whole on every "model" rank
    "recurrentgemma-9b-w255-2x2": ("recurrentgemma-9b",
                                   dict(n_layers=3, lru_width=255), (2, 2),
                                   4),
    # frames and tokens; the self and the cross caches
    "seamless-m4t-medium-2x2": ("seamless-m4t-medium", {}, (2, 2), 4),
    "seamless-m4t-medium-2x2x2": ("seamless-m4t-medium", {}, (2, 2, 2), 4),
    # 4 heads over 4 ranks: the cross-attention's 2 KV heads selected per
    # rank
    "seamless-m4t-medium-1x4": ("seamless-m4t-medium", {}, (1, 4), 2),
    # 6 heads over 4: every attention whole on every "model" rank
    "seamless-m4t-medium-h6-1x4": ("seamless-m4t-medium",
                                   dict(n_heads=6, n_kv_heads=6), (1, 4), 2),
    # 4 experts over the data axis of 2
    "mixtral-8x22b-2x2": ("mixtral-8x22b", {}, (2, 2), 4),
    # 3 experts: the data axis does not divide them, D over it instead
    "mixtral-8x22b-e3-2x2": ("mixtral-8x22b", dict(moe_num_experts=3), (2, 2),
                             4),
    # a dense lead layer, then MoE layers with a shared expert; an expert
    # width of 126: the experts and the shared expert whole on every
    # "model" rank
    "mixtral-8x22b-lead-shared-f126-2x2": (
        "mixtral-8x22b", dict(n_layers=3, moe_first_dense=1,
                              moe_shared_experts=1, moe_d_ff=126), (2, 2), 4),
}


def _perturb(tree, seed=0):
    rng = np.random.default_rng(seed)

    def one(path, a):
        a = np.asarray(a, np.float32)
        name = jax.tree_util.keystr(path)
        if any(t in name for t in ("'b'", "bkv", "ln", "norm", "a_log",
                                   "dt_bias", "d_skip", "conv_b", "'b_a'",
                                   "'b_x'", "'lam'")):
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


def _from_jax(tcfg, jp):
    return (encdec_params_from_jax if tcfg.is_enc_dec
            else lm_params_from_jax)(tcfg, jp)


def _cache_dicts(caches):
    """Each layer's cache dict; the encoder-decoder's (self, cross) pair
    as the self caches, then the cross caches."""
    if isinstance(caches, tuple):
        return list(caches[0]) + list(caches[1])
    return list(caches)


@pytest.mark.parametrize("case", list(SERVE))
def test_sharded_serve_matches_unsharded_and_reference(case):
    arch, kw, shape, b = SERVE[case]
    jcfg, tcfg = _cfgs(arch, kw)
    tp, dp = shape[-1], shape[-2]
    jb, tb = jbuild(jcfg, tp=1, dp=1), tbuild(tcfg, CPU, tp=tp, dp=dp)
    jp = _perturb(jinit(jb.defs, jax.random.PRNGKey(0)))
    params = _from_jax(tcfg, jp)
    s, n_dec = 21, 2
    prompts = np.random.default_rng(11).integers(0, jcfg.vocab_size, (b, s))
    jin, tin = jnp.asarray(prompts, jnp.int32), torch.from_numpy(prompts)
    if tcfg.is_enc_dec:
        frames = np.random.default_rng(12).standard_normal(
            (b, 17, tcfg.d_model)).astype(np.float32)
        jin, tin = (jnp.asarray(frames), jin), (torch.from_numpy(frames), tin)
    want, jcache = jax.jit(jb.prefill)(jp, jin, jb.init_caches(b, s + n_dec))
    caches = tb.init_caches(b, s + n_dec)
    tmoe.experts.kept.clear()
    plain, caches = tsteps.make_prefill_step(tb)(params, tin, caches)
    kept = tmoe.kept_and_dropped()
    np.testing.assert_allclose(_np(plain), np.asarray(want), **TOL)
    with _world(shape):
        mesh = _mesh(shape)
        sp = tsteps.shard_params(params, tb, mesh)
        sc = tsteps.shard_caches(tb.init_caches(b, s + n_dec), mesh, b)
        # the parameters are split: each rank holds less than all of them
        local = sum(_np(torch.tensor(float(v.to_local().numel())))
                    for v in param_leaves(sp).values())
        assert local < tb.num_params
        tmoe.experts.kept.clear()
        with CommDebugMode() as comms:
            got, sc = tsteps.make_prefill_step(tb, mesh)(sp, tin, sc)
        assert comms.get_total_counts() > 0
        if tcfg.moe_num_experts:
            # each rank records its batch rows, each "model" rank the same
            # rows: per layer, the ranks' sum over tp is the unsharded one
            per = np.array(tmoe.kept_and_dropped()).reshape(
                len(kept), int(np.prod(shape)), 2).sum(1)
            np.testing.assert_array_equal(per, np.array(kept) * tp)
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
        for lc, slc in zip(_cache_dicts(caches), _cache_dicts(sc)):
            assert set(lc) == set(slc)
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
                                        ("mamba2-1.3b", (2, 2, 2)),
                                        ("seamless-m4t-medium", (2, 2)),
                                        ("mixtral-8x22b", (2, 2))])
def test_sharded_train_step_matches_unsharded(arch, shape):
    """Two OTA train steps: the clients are the mesh's batch slices (2 or
    4), the noise is added once after the reduction; the encoder-decoder
    on (frames, tokens), MoE with its aux loss."""
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
    if tcfg.is_enc_dec:
        tokens = (torch.from_numpy(np.random.default_rng(4).standard_normal(
            (clients, 13, tcfg.d_model)).astype(np.float32)), tokens)
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
    """deepseek-v3-671b alone is refused, naming MLA, MTP and module
    12c.4; the other nine archs run on a mesh."""
    with pytest.raises(NotImplementedError) as err:
        sharded.check_sharded(tconfigs.get_config("deepseek-v3-671b"))
    for word in ("MLA", "MTP", "12c.4"):
        assert word in str(err.value)
    others = [a for a in tconfigs.ARCH_IDS if a != "deepseek-v3-671b"]
    assert len(others) == 9
    for arch in others:
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


class _AxisBytes(TorchDispatchMode):
    """The bytes of each functional collective's input, by the mesh axis
    of its process group."""

    def __init__(self, mesh):
        super().__init__()
        self.axis = {mesh.device_mesh.get_group(a).group_name: a
                     for a in mesh.axis_names}
        self.bytes = dict.fromkeys(mesh.axis_names, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        groups = [a for a in args if isinstance(a, str) and a in self.axis]
        if func.namespace == "_c10d_functional" and groups:
            ts = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
            self.bytes[self.axis[groups[-1]]] += sum(
                t.numel() * t.element_size() for t in ts)
        return func(*args, **(kwargs or {}))


def test_moe_moves_no_activation_over_the_batch_axes():
    """One MoE layer on (2, 2) at batch 4 and at batch 8: the same bytes
    over "data" (the experts' weights gathered, the aux loss's [E] sums)
    and as many collectives, while the bytes over "model" (the partial
    sum's all-reduce) grow with the batch; the aux loss and the router's
    gradient from it as the unsharded layer's."""
    _, tcfg = _cfgs("mixtral-8x22b", {})
    tb = tbuild(tcfg, CPU, tp=2, dp=2)
    params = tb.init(0)
    p = params["layers"][0]["ffn"]
    seen = {}
    with _world((2, 2)):
        mesh = _mesh((2, 2))
        sp = tsteps.shard_params(params, tb, mesh)["layers"][0]["ffn"]
        for b in (4, 8):
            x = torch.from_numpy(np.random.default_rng(b).standard_normal(
                (b, 16, tcfg.d_model)).astype(np.float32))
            want_y, want_aux = tmoe.moe_apply(p, x, tcfg)
            with dist.mesh_rules(mesh):
                ctx = sharded._Ctx(b)
                xs = sharded._batch(ctx, x)
                with CommDebugMode() as comms, _AxisBytes(mesh) as by_axis:
                    y, aux = sharded._moe(ctx, sp, xs, tcfg)
            seen[b] = (comms.get_total_counts(), dict(by_axis.bytes))
            np.testing.assert_allclose(_np(y), want_y.numpy(), **TOL)
            np.testing.assert_allclose(float(_np(aux)), float(want_aux),
                                       rtol=1e-6)
        # the aux loss's gradient reaches the router once, not once per
        # "model" rank
        router = p["router"].detach().requires_grad_(True)
        want = torch.autograd.grad(tmoe.moe_apply(
            {**sharded._params(p), "router": router}, x, tcfg)[1],
            router)[0]
        rs = sp["router"].detach().requires_grad_(True)
        with dist.mesh_rules(mesh), torch.enable_grad():
            ctx = sharded._Ctx(8)
            aux = sharded._moe(ctx, {**sharded._params(sp), "router": rs},
                               sharded._batch(ctx, x), tcfg)[1]
            got = torch.autograd.grad(aux, rs)[0]
        np.testing.assert_allclose(_np(got), want.numpy(), rtol=1e-5,
                                   atol=1e-7)
    (n4, b4), (n8, b8) = seen[4], seen[8]
    assert n4 == n8 and b4["data"] == b8["data"] > 0
    assert b8["model"] == 2 * b4["model"] > 0


def test_distribute_copies_each_ranks_shard():
    """Under ``LocalTensorMode`` a plain tensor is cut rank by rank: each
    rank holds a copy of its own shard (the batch over "data", the columns
    over "model"), and an in-place update of one rank's copy touches
    neither the other ranks' nor the whole tensor."""
    from torch.distributed.tensor import Replicate, Shard
    t = torch.arange(24.).reshape(4, 6)
    with _world((2, 2)):
        mesh = _mesh((2, 2))
        for pl in ((Shard(0), Shard(1)), (Replicate(), Replicate())):
            d = dist.distribute(t, mesh, pl)
            np.testing.assert_array_equal(_np(d), t.numpy())
            shards = d.to_local()._local_tensors
            for r, piece in shards.items():
                dd, mm = divmod(r, 2)
                want = t[2 * dd:2 * dd + 2, 3 * mm:3 * mm + 3] \
                    if pl[0] != Replicate() else t
                np.testing.assert_array_equal(piece.numpy(), want.numpy())
                assert piece.data_ptr() != t.data_ptr()
            ptrs = {piece.data_ptr() for piece in shards.values()}
            assert len(ptrs) == 4
            shards[0].add_(100.)
            assert float(shards[1].max()) < 100 and float(t.max()) == 23.


@pytest.mark.parametrize("placements", [
    ("S0", "S1"), ("S0", "S0"), ("S1", "R"), ("R", "S0"), ("R", "R")])
@pytest.mark.parametrize("shape", [(4, 6), (5, 7)])
def test_assemble_is_the_inverse_of_distribute(placements, shape):
    """``assemble`` puts the simulated ranks' shards back together where
    ``distribute`` cut them: evenly or not (``torch.chunk``'s pieces, an
    empty one past the end), one tensor dim over both mesh axes."""
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Replicate() if p == "R" else Shard(int(p[1]))
               for p in placements)
    t = torch.arange(float(np.prod(shape))).reshape(shape)
    with _world((2, 2)):
        d = dist.distribute(t, _mesh((2, 2)), pl)
        with dist.local_mode().disable():
            got = dist.assemble(d)
            np.testing.assert_array_equal(got.numpy(), t.numpy())
