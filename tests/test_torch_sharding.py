"""The sharding rules of the port (module 12b) against the reference's, on
the CPU with no mesh of devices: the parameters' specs of every arch, the
logical-axis rules, the batch spec and every cache leaf's spec.

The reference's ``param_specs`` lay the layers out as ``lead``, ``scan``
(each unit's leaves stacked over its repetitions, a None prepended to
their specs) and ``tail``; the port keeps one entry per layer, so its
specs are put in the reference's layout (``_stacked``) and compared as
tuples.  The reference's ``logical_to_spec``, ``batch_spec`` and
``_cache_leaf_spec`` read only a mesh's ``shape`` and ``axis_names``, so
stand-in meshes serve both sides.
"""
import pytest
import torch

from repro import distributed as jdist
from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models.param import param_specs as jparam_specs
from repro.models.registry import build_bundle as jbuild_bundle

from repro_torch import configs
from repro_torch import distributed as dist
from repro_torch.launch import steps
from repro_torch.models.param import P, layer_groups, param_specs
from repro_torch.models.registry import build_bundle
from torch_ref import one_thread  # noqa: F401 (autouse)

TP_DP = ((16, 16), (2, 2))


class StandIn:
    """A mesh as the sharding rules read one: sizes and axis names."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


MESHES = {"pod": StandIn((16, 16), ("data", "model")),
          "multipod": StandIn((2, 16, 16), ("pod", "data", "model")),
          "debug": StandIn((2, 2), ("data", "model"))}


def _tuples(tree):
    """Specs as plain tuples (the reference's PartitionSpecs too)."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tuples(v) for v in tree]
    return tuple(tree)


def _stack(spec):
    if isinstance(spec, dict):
        return {k: _stack(v) for k, v in spec.items()}
    return (None,) + tuple(spec)


def _stacked(cfg, specs) -> dict:
    """The port's specs in the reference's layout."""
    if cfg.is_enc_dec:
        enc, dec = specs["enc_layers"], specs["dec_layers"]
        assert all(e == enc[0] for e in enc) and all(d == dec[0] for d in dec)
        return {"enc_scan": {"u0": _stack(enc[0])},
                "enc_ln_f": specs["enc_ln_f"], "embed": specs["embed"],
                "dec_scan": {"u0": _stack(dec[0])}, "ln_f": specs["ln_f"],
                "unembed": specs["unembed"]}
    lead, unit, n_rep, _ = layer_groups(cfg)
    layers, k = specs["layers"], len(unit)
    body = layers[len(lead):]
    out = {"embed": specs["embed"]} if "embed" in specs else {}
    out["lead"] = layers[:len(lead)]
    if n_rep:
        scan = {}
        for i in range(k):
            reps = body[i:n_rep * k:k]
            assert all(r == reps[0] for r in reps)
            scan[f"u{i}"] = _stack(reps[0])
        out["scan"] = scan
    out["tail"] = body[n_rep * k:]
    for key in ("ln_f", "unembed", "mtp"):
        if key in specs:
            out[key] = specs[key]
    return out


@pytest.mark.parametrize("tp,dp", TP_DP)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_reference(arch, tp, dp):
    """Every parameter's spec, every arch, at (tp, dp) = (16, 16) and
    (2, 2)."""
    cfg = configs.get_config(arch)
    ours = _stacked(cfg, _tuples(param_specs(
        build_bundle(cfg, "cpu", tp=tp, dp=dp).defs)))
    ref = _tuples(jparam_specs(jbuild_bundle(jget_config(arch), tp=tp,
                                             dp=dp).defs))
    assert ours == ref


@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_to_spec_matches_reference(mesh):
    m = MESHES[mesh]
    logicals = [("batch", "seq", None), ("batch_pod", "seq", None),
                ("batch", ("model",), None, None), ("batch", None, "heads"),
                ("kv_seq", "heads", "vocab"), ("embed", "ff", "expert"),
                (None, "data", ("pod", "data"))]
    rules = [None, {"kv_seq": ("data",)}]
    for r in rules:
        with dist.mesh_rules(m, r):
            ours = [tuple(dist.logical_to_spec(lg)) for lg in logicals]
            ours_bl = dist.batch_logical()
        jdist.bind(m, r)
        try:
            ref = [tuple(jdist.logical_to_spec(lg)) for lg in logicals]
            ref_bl = jdist.batch_logical()
        finally:
            jdist.unbind()
        assert ours == ref and ours_bl == ref_bl
    # unbound: the default rules, every axis kept
    assert tuple(dist.logical_to_spec(("batch_pod", None))) == (
        ("pod", "data"), None)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_matches_reference(mesh):
    m = MESHES[mesh]
    for gb in (1, 2, 4, 32, 128, 256, 3):
        for extra in (1, 2):
            assert tuple(steps.batch_spec(m, gb, extra)) == \
                tuple(jsteps.batch_spec(m, gb, extra))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_leaf_specs_match_reference(mesh):
    """Every cache leaf name, with and without stacked layer axes, batch
    dividing the batch axes or not, heads and widths dividing "model" or
    not."""
    m = MESHES[mesh]
    shapes = {"k": [(128, 32768, 16, 64), (1, 4096, 8, 128),
                    (32, 24, 2, 128, 3)],
              "v": [(128, 32768, 16, 64), (1, 500, 40, 128)],
              "ckv": [(128, 32768, 512), (1, 4096, 100)],
              "krope": [(128, 32768, 64), (3, 1, 4096, 64)],
              "ssm": [(128, 64, 64, 128), (1, 3, 64, 128)],
              "conv": [(128, 3, 4352), (1, 3, 4351)],
              "h": [(128, 4096), (1, 4095), (5, 128, 4096)]}
    for name, cases in shapes.items():
        for shape in cases:
            for div in (True, False):
                assert tuple(steps._cache_leaf_spec(name, shape, m, div)) \
                    == tuple(jsteps._cache_leaf_spec(name, shape, m, div)), \
                    (name, shape, div)


def test_filter_spec_and_placements():
    """Axes a mesh lacks are dropped, as the reference's ``_filter_spec``;
    a tuple of axes splits one dim over them, major first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    m = MESHES["debug"]
    spec = P(("pod", "data"), None, "model")
    assert tuple(steps._filter_spec(spec, m)) == \
        tuple(jsteps._filter_spec(jsteps.P(("pod", "data"), None, "model"),
                                  m))
    assert steps.named(m, spec) == (Shard(0), Shard(2))
    mp = MESHES["multipod"]
    assert dist.placements(mp, spec) == (Shard(0), Shard(0), Shard(2))
    assert dist.placements(m, P(None, None), ("data",)) == (Partial(),
                                                             Replicate())
    with pytest.raises(ValueError):
        dist.placements(m, P("data", "data"))


def test_cache_shardings_of_the_port_layout():
    """``cache_shardings`` over the port's caches (one dict a layer) gives
    each leaf the placements of its reference spec."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = configs.get_config("mamba2-1.3b").smoke()
    caches = build_bundle(cfg, "cpu", tp=2, dp=2).init_caches(4, 8)
    pl = steps.cache_shardings(caches, MESHES["debug"], 4)
    assert len(pl) == cfg.n_layers
    assert pl[0]["ssm"] == (Shard(0), Shard(1))
    assert pl[0]["conv"] == (Shard(0), Shard(2))
    pl1 = steps.cache_shardings(caches, MESHES["debug"], 3)
    assert pl1[0]["ssm"] == (Replicate(), Shard(1))


def test_production_and_slot_meshes():
    """The reference's production meshes over a simulated world of 256 and
    512 ranks, and a slot mesh's shape over ranks (``from_slots``); a mesh
    of another size than the world is refused."""
    from repro_torch.launch import mesh as mesh_lib
    with dist.simulated_world(256):
        m = mesh_lib.make_production_mesh()
        assert m.shape == {"data": 16, "model": 16} and m.size == 256
        assert m.axis_names == ("data", "model")
        with pytest.raises(RuntimeError, match="512"):
            mesh_lib.make_production_mesh(multi_pod=True)
    with dist.simulated_world(512):
        m = mesh_lib.make_production_mesh(multi_pod=True)
        assert m.shape == {"pod": 2, "data": 16, "model": 16}
    with dist.simulated_world(4):
        slots = mesh_lib.make_debug_mesh(2, 2, slots=[torch.device("cpu")] * 4)
        m = mesh_lib.from_slots(slots)
        assert m.shape == slots.shape and m.device_type == "cpu"


def test_input_shardings_follow_the_batch_and_cache_rules():
    """The shardings half of the reference's ``input_specs``: tokens over
    the batch axes when the global batch divides them, the caches by
    ``cache_shardings``, the position and key replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs.shapes import InputShape
    m = MESHES["multipod"]
    tb = build_bundle(configs.get_config("qwen1.5-0.5b"), "cpu")
    dec = steps.input_shardings(tb, InputShape("d", 32768, 128, "decode"), m)
    assert dec["token"] == (Shard(0), Shard(0), Replicate())
    assert dec["pos"] == (Replicate(),) * 3
    assert len(dec["caches"]) == 24
    assert dec["caches"][0]["k"] == (Shard(0), Shard(0), Shard(2))
    one = steps.input_shardings(tb, InputShape("l", 4096, 1, "decode"), m)
    # a batch of 1: the KV cache over "data" by its sequence instead
    assert one["token"] == (Replicate(),) * 3
    assert one["caches"][0]["k"] == (Replicate(), Shard(1), Shard(2))
    tr = steps.input_shardings(tb, InputShape("t", 4096, 256, "train"), m)
    assert tr["tokens"] == (Shard(0), Shard(0), Replicate())
    sb = build_bundle(configs.get_config("seamless-m4t-medium"), "cpu")
    pre = steps.input_shardings(sb, InputShape("p", 64, 32, "prefill"), m)
    assert pre["frames"] == (Shard(0), Shard(0), Replicate())
    ddec = steps.input_shardings(sb, InputShape("d", 64, 32, "decode"), m)
    assert len(ddec["cross_caches"]) == 12
