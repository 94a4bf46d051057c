"""The port's dry-run (module 13: ``launch.count``, ``launch.dryrun``,
``launch.memory``) on the CPU.

The count is held to what it must be: linear in depth for a dense, an SSD,
an MoE and the encoder-decoder config in each kind of step; a dense
prefill's FLOPs are the products of its active parameters and of the
attention's allowed pairs; the fake count equals the count of the same
step on real CPU tensors.  K3 and K4 on fakes that stand for the card are
tallied by their own ``work`` and launch nothing, and ``work`` equals the
arithmetic of ``profile_attention.bound`` and ``kernel_bench.ssd_flops``.
One full-width record has the reference's keys; the parameter bytes and
counts of every arch equal the reference's, from a child process
(``torch_ref._child``).  No test here needs a card: the CUDA cases are in
``test_torch_kernels_cuda.py``.
"""
import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs, kernel_bench, profile_attention
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels import build, flash_attention as fa, ssd_scan as ss
from repro_torch.launch import count, dryrun, memory
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.train import make_design
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.param import abstract_params, param_leaves
from repro_torch.models.registry import build_bundle
from repro_torch.roofline import active_params
import torch_ref

ROOT = Path(__file__).resolve().parents[1]
REF_RECORD = ROOT / "experiments" / "dryrun" / "qwen1.5-0.5b_decode_32k_pod.json"
# a dense, an SSD, an MoE (sliding window) and the encoder-decoder config
DEPTH_ARCHS = ("qwen1.5-0.5b", "mamba2-1.3b", "mixtral-8x22b",
               "seamless-m4t-medium")
KINDS = ("train", "prefill", "decode")

_PARAMS_CHILD = r"""
import json, sys
cfg = json.loads(sys.argv[1])
from repro import configs
from repro.models.param import param_bytes, param_count
from repro.models.registry import build_bundle
out = {}
for arch in configs.ARCH_IDS:
    defs = build_bundle(configs.get_config(arch)).defs
    out[arch] = [int(param_bytes(defs)), int(param_count(defs))]
with open(cfg["out"], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many tiny ops, which threads
    only slow down, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference_params(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "params.json"
    torch_ref._child(_PARAMS_CHILD, {"out": str(out)},
                     "reference param bytes", 300)
    return json.loads(out.read_text())


def smoke_cfg(arch: str, depth: int):
    """The arch's smoke config at ``depth`` repetitions of its block
    pattern (both sides of the encoder-decoder)."""
    cfg = configs.get_config(arch).smoke()
    n = depth * len(cfg.block_pattern)
    return cfg.replace(n_layers=n, **(
        {"encoder_layers": n} if cfg.is_enc_dec else {}))


def design_for(cfg, clients=2):
    """A vanilla design (no solve): the count reads only its shapes."""
    return make_design("vanilla", clients,
                       build_bundle(cfg, "cpu").num_params, device="cpu")


def count_of(arch, cfg, shape, **kw):
    if shape.kind == "train" and "design" not in kw:
        kw["design"] = design_for(cfg)
    return dryrun.run_one(arch, shape, cfg=cfg, save=False, **kw)


def totals(rec):
    return (rec["flops_per_device"], rec["bytes_accessed_per_device"],
            json.dumps(rec["kernels"], sort_keys=True))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", DEPTH_ARCHS)
def test_count_is_linear_in_depth(arch, kind):
    """record(3n) - record(2n) = record(2n) - record(n), exactly: eager
    counting sees every layer, so no loop correction is needed."""
    shape = InputShape("t", 48, 2, kind)
    recs = [count_of(arch, smoke_cfg(arch, n), shape) for n in (1, 2, 3)]
    f, b = ([r[k] for r in recs] for k in (
        "flops_per_device", "bytes_accessed_per_device"))
    assert f[2] - f[1] == f[1] - f[0] > 0
    assert b[2] - b[1] == b[1] - b[0] > 0
    for name in recs[2]["kernels"]:
        for key in ("calls", "flops", "bytes"):
            k = [r["kernels"][name][key] for r in recs]
            assert k[2] - k[1] == k[1] - k[0] > 0, (name, key)


@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "qwen3-1.7b", "granite-8b"))
def test_dense_prefill_flops_are_the_products(arch):
    """2 x tokens x ``active_params`` (every matmul of a dense prefill,
    the unembedding's at every position) plus K3's products of the pairs
    the causal mask allows."""
    cfg = configs.get_config(arch).smoke()
    b, s = 2, 40
    rec = count_of(arch, cfg, InputShape("p", s, b, "prefill"))
    dh = cfg.resolved_head_dim
    attn = cfg.n_layers * 2 * b * cfg.n_heads * 2 * dh * fa.pairs(s, s)
    assert rec["kernels"]["flash_attention"]["flops"] == attn
    assert rec["flops_per_device"] == 2 * b * s * active_params(cfg) + attn


def _real_step(cfg, shape, design):
    """The step of ``shape``'s kind on real CPU tensors, from a seed."""
    bundle = build_bundle(cfg, "cpu")
    params = bundle.init(0)
    gb, s = shape.global_batch, shape.seq_len
    tokens = torch.randint(0, cfg.vocab_size, (gb, s + 1),
                           generator=torch.Generator().manual_seed(1))
    if shape.kind == "train":
        step = steps_lib.make_train_step(
            bundle, design.pc, design.prm.gains,
            steps_lib.TrainStepConfig(eta=dryrun.ETA))
        n = len(design.prm.gains)
        draws = steps_lib.StepDraws(
            h=torch.ones(n, dtype=torch.complex64),
            coin=torch.zeros((), dtype=torch.bool),
            z={k: torch.zeros(v.shape) for k, v in
               param_leaves(params).items()})
        return step, (params, tokens, draws)
    caches = bundle.init_caches(gb, s)
    if shape.kind == "prefill":
        return steps_lib.make_prefill_step(bundle), (params, tokens[:, :s],
                                                     caches)
    return steps_lib.make_serve_step(bundle), (params, caches,
                                               tokens[:, :1], s - 1)


@pytest.mark.parametrize("kind", KINDS)
def test_fake_count_equals_the_count_on_real_cpu_tensors(kind):
    """The same step counted on fakes and run on real CPU tensors: the
    FLOPs equal ``FlopCounterMode``'s, the bytes the byte counter's."""
    arch = "qwen1.5-0.5b"
    cfg = configs.get_config(arch).smoke()
    shape = InputShape("t", 24, 2, kind)
    design = design_for(cfg)
    rec = count_of(arch, cfg, shape, design=design, device="cpu")
    assert rec["path"] == "plain" and rec["kernels"] == {}
    step, args = _real_step(cfg, shape, design)
    with FlopCounterMode(display=False) as fc, count.Count() as c:
        step(*args)
    assert rec["flops_per_device"] == fc.get_total_flops() == c.flops > 0
    assert rec["bytes_accessed_per_device"] == c.bytes > 0


@pytest.fixture
def no_build(monkeypatch):
    """Fail on any kernel build or library load."""
    def refuse(*a, **k):
        raise AssertionError("a dry-run built or loaded a kernel library")
    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "build", refuse)


def test_card_fakes_tally_k3_by_its_work(no_build):
    """On fakes that stand for the card, every prefill attention goes
    through K3's wrapper: one call a layer, totals of calls x ``work``;
    nothing is launched or built; decode and train steps call no
    kernel."""
    arch = "qwen1.5-0.5b"
    cfg = smoke_cfg(arch, 3)
    b, s = 2, 40
    launches = fa.flash_attention.launches
    rec = count_of(arch, cfg, InputShape("p", s, b, "prefill"))
    dh = cfg.resolved_head_dim
    q = torch.empty((b, s, cfg.n_heads, dh), device="meta")
    kv = torch.empty((b, s, cfg.n_kv_heads, dh), device="meta")
    one = fa.work(q, kv, kv, causal=True)
    assert rec["kernels"] == {"flash_attention": {
        "calls": 3, "flops": 3 * one["flops"], "bytes": 3 * one["bytes"]}}
    assert rec["path"] == "card"
    for kind in ("decode", "train"):
        assert count_of(arch, cfg, InputShape("t", s, b, kind))["kernels"] \
            == {}
    assert fa.flash_attention.launches == launches


def test_card_fakes_tally_k4_by_its_work(no_build):
    arch = "mamba2-1.3b"
    cfg = smoke_cfg(arch, 2)
    b, s = 2, 40
    launches = ss.ssd_scan.launches
    rec = count_of(arch, cfg, InputShape("p", s, b, "prefill"))
    d_inner = cfg.ssm_expand * cfg.d_model
    h, p = d_inner // cfg.ssm_headdim, cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    f32 = dict(device="meta", dtype=cfg.compute_dtype)
    one = ss.work(torch.empty((b, s, h, p), **f32),
                  torch.empty((b, s, h), **f32),
                  torch.empty(h, device="meta"),
                  torch.empty((b, s, g, n), **f32),
                  torch.empty((b, s, g, n), **f32),
                  torch.empty((b, h, p, n), device="meta"))   # the cache's
    assert rec["kernels"] == {"ssd_scan": {
        "calls": 2, "flops": 2 * one["flops"], "bytes": 2 * one["bytes"]}}
    assert ss.ssd_scan.launches == launches


def test_a_fake_on_the_card_path_without_a_count_raises(no_build):
    with count.fake_mode(card=True):
        q = torch.empty((1, 16, 2, 64))
        with pytest.raises(RuntimeError, match="no launch.count.Count"):
            fa.flash_attention(q, q, q)
        x = torch.empty((1, 16, 2, 32))
        bc = torch.empty((1, 16, 1, 32))
        with pytest.raises(RuntimeError, match="no launch.count.Count"):
            ss.ssd_scan(x, torch.empty((1, 16, 2)), torch.empty(2), bc, bc,
                        chunk=8)
        # outside card=True a CPU fake takes the plain version
        with count.fake_mode(), count.Count() as c:
            fa.flash_attention(q, q, q)
        assert c.kernels == {} and c.flops > 0


def test_abstract_params_makes_fakes_only_in_fake_mode():
    defs = tfm.model_defs(configs.get_config("qwen1.5-0.5b").smoke())
    with pytest.raises(RuntimeError, match="fake_mode"):
        abstract_params(defs, torch.device("cpu"))
    with count.fake_mode():
        tree = abstract_params(defs, torch.device("cpu"))
        leaves = param_leaves(tree)
        assert all(count.is_fake(t) for t in leaves.values())
    assert sum(t.numel() for t in leaves.values()) \
        == build_bundle(configs.get_config("qwen1.5-0.5b").smoke(),
                        "cpu").num_params


def test_work_gives_the_docstring_numbers():
    """K3 at the main path's shape: 17.2 GFLOP and 67.1 MB
    (``flash_attention.py``'s docstring)."""
    q = torch.empty((8, 1024, 16, 64), dtype=torch.bfloat16, device="meta")
    w = fa.work(q, q, q, causal=True)
    assert round(w["flops"] / 1e9, 1) == 17.2
    assert round(w["bytes"] / 1e6, 1) == 67.1


@pytest.mark.parametrize("shape", profile_attention.SHAPES,
                         ids=lambda s: s.label)
def test_k3_work_equals_profile_attention_bound(shape):
    dt = profile_attention.DTYPES[shape.dtype]
    q = torch.empty((shape.b, shape.s, shape.h, shape.dh), dtype=dt,
                    device="meta")
    k = torch.empty((shape.b, shape.keys, shape.kh, shape.dh), dtype=dt,
                    device="meta")
    v = torch.empty((shape.b, shape.keys, shape.kh, shape.v_width), dtype=dt,
                    device="meta")
    w = fa.work(q, k, v, causal=shape.causal, window=shape.window)
    bd = profile_attention.bound(shape, "H100")
    assert (w["flops"], w["bytes"]) == (bd["flops"], bd["bytes"])


@pytest.mark.parametrize("sq, sk, causal, window", [
    (1, 1, True, None), (7, 7, True, 3), (100, 100, True, None),
    (100, 100, False, None), (64, 200, False, None), (200, 64, True, None),
    (300, 300, True, 64), (129, 1024, True, 5), (50, 70, False, 20)])
def test_pairs_equal_profile_attention_pairs(sq, sk, causal, window):
    assert fa.pairs(sq, sk, causal, window) \
        == profile_attention.pairs(sq, sk, causal, window)


@pytest.mark.parametrize("state0", (False, True))
def test_k4_work_equals_kernel_bench(state0):
    """``ssd_scan.work`` at ``kernel_bench``'s shape: its FLOPs are
    ``ssd_flops``, its bytes the inputs and outputs ``kernel_bench``
    counts (and the state in)."""
    b, s, h, p, g, n = kernel_bench.SSD
    x, dt = torch.empty((b, s, h, p)), torch.empty((b, s, h))
    a_neg, bm = torch.empty(h), torch.empty((b, s, g, n))
    st = torch.empty((b, h, p, n))
    s0 = st if state0 else None
    w = ss.work(x, dt, a_neg, bm, bm, s0)
    assert w["flops"] == kernel_bench.ssd_flops(b, s, h, p, n, g, state0)
    assert w["bytes"] == kernel_bench.nbytes(x, dt, a_neg, bm, bm, x, st,
                                             s0)


def test_full_width_record_has_the_reference_keys(tmp_path, monkeypatch):
    """qwen1.5-0.5b decode_32k at full width and depth, written by the
    CLI: the reference record's keys (``experiments/dryrun/``), one
    device, collectives 0, no ``temp_bytes`` invented."""
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k"])
    rec = json.loads(
        (tmp_path / "qwen1.5-0.5b_decode_32k_card.json").read_text())
    ref = json.loads(REF_RECORD.read_text())
    assert set(ref) <= set(rec)
    assert set(ref["collective_bytes_per_device"]) \
        <= set(rec["collective_bytes_per_device"])
    assert rec["devices"] == 1 and rec["mesh"] == {"data": 1, "model": 1}
    assert rec["collective_bytes_per_device"]["total"] == 0
    assert set(rec["memory_analysis"]) == {"argument_bytes", "output_bytes"}
    assert (rec["num_params"], rec["param_bytes_total"]) \
        == (ref["num_params"], ref["param_bytes_total"])
    assert rec["card"] == "H100" and rec["kernels"] == {}
    # the caches dominate the arguments: 24 layers x k, v [128, 32768, 16,
    # 64] in bf16, beside the weights and the token
    caches = 24 * 2 * 128 * 32768 * 16 * 64 * 2
    assert rec["memory_analysis"]["argument_bytes"] \
        == caches + rec["param_bytes_total"] + 128 * 8


def test_param_bytes_equal_the_reference(reference_params):
    for arch in configs.ARCH_IDS:
        defs = build_bundle(configs.get_config(arch), "cpu").defs
        got = [memory.def_bytes(defs),
               build_bundle(configs.get_config(arch), "cpu").num_params]
        assert got == reference_params[arch], arch


def test_cli_refuses_multi_pod_and_needs_a_pair():
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                     "--multi-pod"])
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen1.5-0.5b"])


def test_dryrun_leaves_the_moe_record_and_plain_counts():
    """A dry-run's MoE calls are fakes: ``experts.kept`` and the plain
    versions' call counts stay as they were."""
    from repro_torch.kernels import ref
    kept = list(moe.experts.kept)
    calls = (moe.experts.calls, ref.attention_ref.calls)
    arch = "mixtral-8x22b"
    count_of(arch, configs.get_config(arch).smoke(),
             InputShape("t", 24, 2, "train"))
    assert list(moe.experts.kept) == kept
    assert (moe.experts.calls, ref.attention_ref.calls) == calls


@pytest.mark.parametrize("arch, layers, gb, digits", [
    ("qwen1.5-0.5b", 0, 35.005, 3), ("recurrentgemma-9b", 3, 59.054, 3),
    ("seamless-m4t-medium", 0, 48.74, 2)])
def test_moved_reckonings_give_the_smoke_numbers(arch, layers, gb, digits):
    """``train_reckoning`` at phases 19's and 20's shapes (4 x 4,096)."""
    cfg = configs.get_config(arch)
    cfg = cfg.replace(n_layers=layers) if layers else cfg
    peak = memory.train_reckoning(cfg, 4, 4096)["peak"]
    assert round(peak / 1e9, digits) == gb


def test_serve_reckonings_at_the_smoke_shapes():
    """``mixtral_reckoning`` and ``deepseek_reckoning`` keep their terms:
    the peak is the weights plus the larger of the init's f32 leaf and
    the prefill's transients and caches."""
    for fn, arch, layers in ((memory.mixtral_reckoning, "mixtral-8x22b", 12),
                             (memory.deepseek_reckoning, "deepseek-v3-671b",
                              4)):
        cfg = configs.get_config(arch).replace(n_layers=layers)
        r = fn(cfg, 8, 1024, 32)
        assert r["weights"] == memory.def_bytes(tfm.model_defs(cfg))
        rest = sum(v for k, v in r.items()
                   if k not in ("weights", "init_f32_leaf", "peak"))
        assert r["peak"] == r["weights"] + max(r["init_f32_leaf"], rest)
