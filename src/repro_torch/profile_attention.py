"""K3 (flash attention) at the smoke's shapes on the card, against other
builds of its source.

    python -m repro_torch.profile_attention [--against LABEL=PATH] \
        [--reps 4] [--dtype f32|bf16|all] [--long]

Builds ``kernels/csrc/flash_attention.cu`` (label ``this``) and each
``--against`` source (another checkout's ``flash_attention.cu``, or a
variant under trial) with nvcc for sm_90a and ``-Xptxas -v``, one process
each, all at once, and prints the registers and spills of the kernels of
the chosen dtype.  For each shape of ``SHAPES`` in that dtype (B 8, S 1024
or 1000, the train eval's B 4, S 128, recurrentgemma's B 2, S 4096 past
its window, or mixtral's B 1, S 8192 past its window, causal;
seamless-m4t-medium's encoder at B 8, S 1024 and its ragged
cross-attention, Sq 128 over Sk 1,024, non-causal, and its train eval's
encoder and cross-attention at B 4, Sq = Sk = 4,096; deepseek-v3's MLA
prefill, B 8, S 1024, H = KH = 128, q.k width 192, v width 128) it
launches every
build through its C entry on the same inputs and compares the output
with the plain version (f32 to 2e-5; bf16 to two bf16 ulps plus 1e-2),
then times every build and one
``scaled_dot_product_attention`` call on the same inputs
(``card.median_ms``: CUDA events around batches of 20 back-to-back
launches, the median of 5 batches) in ``--reps`` rounds whose order
alternates (A B S, S B A, ...).  Per shape it prints each build's median
of the rounds' medians, its share of the bound and its max abs error,
and SDPA's time (with the backend that ran it, or null and the error's
first line where no backend takes the shape); the last line is one JSON
object.  The C entries take the v width after the q.k width since the
(192, 128) instance: a source older than it cannot be built ``--against``
this one.  Fails if this
source's kernel disagrees with the plain version.  ``--long`` first
holds every build's f32 kernel against the plain version at long
sequences (``LONG``: B 1, H 2, KH 1, S up to 16,384) and prints the max
abs error and its share of the f32 tolerance, which shows whether the
error grows with the number of key tiles.  Needs a CUDA device.

``SHAPES``, ``draw``, ``bound`` and ``sdpa`` also make ``chip_smoke.py``'s
K3 rows.
"""
from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.card import median_ms, peaks
from repro_torch.device import resolve_device
from repro_torch.kernels import build, ref

F32_TOL = dict(rtol=2e-5, atol=2e-5)
ATTN_BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# (S, Dh, window) of the --long accuracy rows, at B 1, H 2, KH 1, causal
LONG = [(1024, 64, None), (4096, 64, None), (16384, 64, None),
        (4096, 128, None), (16384, 128, None), (16384, 128, 4096)]


class Shape(NamedTuple):
    """One K3 call: q [B, S, H, Dh], k [B, Sk, KH, Dh], v [B, Sk, KH,
    Dv]."""
    label: str
    b: int
    s: int                       # query rows
    h: int
    kh: int
    dh: int
    dtype: str                   # "bf16" | "f32"
    window: Optional[int] = None
    causal: bool = True
    sk: Optional[int] = None     # key rows (None: S)
    dv: Optional[int] = None     # v's width (None: Dh)

    @property
    def keys(self) -> int:
        return self.s if self.sk is None else self.sk

    @property
    def v_width(self) -> int:
        return self.dh if self.dv is None else self.dv


# the first is the qwen serve path's prefill at full width; granite-8b's,
# qwen2.5-14b's and chameleon-34b's prefills at batch 8 x 1,024; the LM
# train run's held-out eval (qwen1.5-0.5b, 4 clients x 128 tokens);
# recurrentgemma-9b's local layers (Dh 256, 16 heads over one KV head) at
# its serve prefill, whose window of 2,048 does not bite at 1,024 (the same
# function as causal attention), and past the window (2 x 4,096);
# seamless-m4t-medium's non-causal calls (its decoder's causal
# self-attention has "main"'s shape): the encoder's self-attention at its
# serve prefill (frames 1,024) and a ragged cross-attention, a short text
# prompt (128) over long audio (1,024 frames); mixtral-8x22b's
# sliding-window layers (48 heads over 8, Dh 128, window 4,096) at its serve
# prefill (8 x 1,024: K3 takes the window as the serve path hands it, but it
# does not bite, so SDPA runs plain causal) and past the window (1 x 8,192);
# deepseek-v3-671b's MLA prefill (its expanded form: 128 heads, q and k 192
# wide, v 128) at 8 x 1,024; the held-out evals of the train runs at
# train_4k's length (4 clients x 4,096): qwen1.5-0.5b's (Dh 64, causal)
# and recurrentgemma-9b's local layers (Dh 256, window 2,048), and
# seamless-m4t-medium's non-causal ones, in bf16 and in f32: the encoder's
# self-attention and the cross-attention over the encoder's 4,096 frames
# (the same function at Sq = Sk; its decoder's causal self-attention has
# "train_4k_eval"'s shape)
SHAPES = [Shape(*t) for t in (
    ("main", 8, 1024, 16, 16, 64, "bf16", None),
    ("qwen3", 8, 1024, 16, 8, 128, "bf16", None),
    ("qwen3_window256", 8, 1024, 16, 8, 128, "bf16", 256),
    ("ragged_s1000", 8, 1000, 16, 16, 64, "bf16", None),
    ("granite-8b", 8, 1024, 32, 8, 128, "bf16", None),
    ("qwen2.5-14b", 8, 1024, 40, 8, 128, "bf16", None),
    ("chameleon-34b", 8, 1024, 64, 8, 128, "bf16", None),
    ("train_eval", 4, 128, 16, 16, 64, "bf16", None),
    ("main_f32", 8, 1024, 16, 16, 64, "f32", None),
    ("qwen3_f32", 8, 1024, 16, 8, 128, "f32", None),
    ("qwen3_window256_f32", 8, 1024, 16, 8, 128, "f32", 256),
    ("recurrentgemma-9b", 8, 1024, 16, 1, 256, "bf16", None),
    ("recurrentgemma-9b_f32", 8, 1024, 16, 1, 256, "f32", None),
    ("recurrentgemma-9b_window2048", 2, 4096, 16, 1, 256, "bf16", 2048),
    ("recurrentgemma-9b_window2048_f32", 2, 4096, 16, 1, 256, "f32", 2048),
    ("seamless_encoder", 8, 1024, 16, 16, 64, "bf16", None, False),
    ("seamless_encoder_f32", 8, 1024, 16, 16, 64, "f32", None, False),
    ("seamless_cross", 8, 128, 16, 16, 64, "bf16", None, False, 1024),
    ("seamless_cross_f32", 8, 128, 16, 16, 64, "f32", None, False, 1024),
    ("mixtral-8x22b", 8, 1024, 48, 8, 128, "bf16", 4096),
    ("mixtral-8x22b_f32", 8, 1024, 48, 8, 128, "f32", 4096),
    ("mixtral-8x22b_window4096_f32", 1, 8192, 48, 8, 128, "f32", 4096),
    ("deepseek-v3", 8, 1024, 128, 128, 192, "bf16", None, True, None, 128),
    ("deepseek-v3_f32", 8, 1024, 128, 128, 192, "f32", None, True, None,
     128),
    ("train_4k_eval", 4, 4096, 16, 16, 64, "bf16", None),
    ("recurrentgemma-9b_train_4k_eval", 4, 4096, 16, 1, 256, "bf16", 2048),
    ("seamless_train_4k_encoder", 4, 4096, 16, 16, 64, "bf16", None, False),
    ("seamless_train_4k_encoder_f32", 4, 4096, 16, 16, 64, "f32", None,
     False),
    ("seamless_train_4k_cross", 4, 4096, 16, 16, 64, "bf16", None, False,
     4096),
    ("seamless_train_4k_cross_f32", 4, 4096, 16, 16, 64, "f32", None, False,
     4096))]


def pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks allow, positions from 0 on both sides."""
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def draw(shape: Shape, dev, gen):
    """q, k, v of one shape of ``SHAPES``, unit normal, in its dtype."""
    return [torch.randn((shape.b, rows, hh, width), generator=gen,
                        device=dev).to(DTYPES[shape.dtype])
            for rows, hh, width in ((shape.s, shape.h, shape.dh),
                                    (shape.keys, shape.kh, shape.dh),
                                    (shape.keys, shape.kh, shape.v_width))]


def bound(shape: Shape, card: str) -> dict:
    """The least time the card could take: the larger of q, k, v and o
    read or written once over the memory rate, and the products of the
    (query, key) pairs the masks allow (all Sq * Sk of them when
    non-causal), 2 (Dh + Dv) operations a pair, over the tensor cores'
    bf16 rate, or in f32 over the cheaper of the FMA units and three TF32
    products (f32's precision)."""
    b, s, sk, h, kh, dh, dv = (shape.b, shape.s, shape.keys, shape.h,
                               shape.kh, shape.dh, shape.v_width)
    _, (bw, f32_peak, bf16_peak) = peaks(card)
    size = torch.finfo(DTYPES[shape.dtype]).bits // 8
    byts = size * b * ((s * h + sk * kh) * dh + (sk * kh + s * h) * dv)
    flops = 2 * b * h * (dh + dv) * pairs(s, sk, shape.causal, shape.window)
    ops_s = flops / bf16_peak if shape.dtype == "bf16" else min(
        flops / f32_peak, 3 * flops / (bf16_peak / 2))
    return {"bytes": byts, "flops": flops,
            "bound_ms": 1e3 * max(byts / bw, ops_s),
            "bound_by": "bytes" if byts / bw >= ops_s else "operations"}


def sdpa(q, k, v, window, causal=True):
    """One ``scaled_dot_product_attention`` call of the same function, as a
    yardstick (the port never calls it); a window is a causal one.  A
    window of S or more keys does not bite: the call is then plain causal
    (``is_causal``, no mask), since an explicit mask keeps SDPA off its
    flash kernel.  v may be narrower than q and k (the scale stays
    1/sqrt(q's width))."""
    s, h, kh = q.shape[1], q.shape[2], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(s, device=q.device)
    mask = None if window is None or window >= s else (
        (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=h != kh).transpose(1, 2)


def sdpa_backend(fn):
    """(name, error): the SDPA backend that the default dispatch runs
    ``fn`` on -- the first in PyTorch's priority order that takes it -- or
    (None, the first line of the error) when none does."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    err = None
    for backend in (SDPBackend(i) for i in torch._C._get_sdp_priority_order()):
        if backend == SDPBackend.OVERRIDEABLE:
            continue
        try:
            with sdpa_kernel(backend):
                fn()
            return backend.name.lower(), None
        except RuntimeError as e:
            err = (str(e).strip().splitlines() or [repr(e)])[0]
    return None, err


def launch(lib, q, k, v, out, window, stream, causal=True):
    """One call of a build's C entry for q's dtype, into ``out``."""
    name = "flash_attention_" + ("f32" if q.dtype == torch.float32
                                 else "bf16")
    build.check(getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
        q.shape[3], v.shape[3], int(causal), window or 0, stream), name)
    return out


def long_errors(libs, dev, stream) -> None:
    """Each build's f32 error against the plain version at ``LONG``."""
    gen = torch.Generator(device=dev).manual_seed(3)
    for s, dh, window in LONG:
        q, k, v = (torch.randn((1, s, hh, dh), generator=gen, device=dev)
                   for hh in (2, 1, 1))
        want = ref.attention_ref(q, k, v, causal=True, window=window)
        row = {}
        for name, lib in libs.items():
            err = (launch(lib, q, k, v, torch.empty_like(q), window, stream)
                   - want).abs()
            row[name] = {"max_abs_err": float(err.max()), "tol_share": float(
                (err / (F32_TOL["atol"] + F32_TOL["rtol"] * want.abs()))
                .max())}
        print(f"long S {s} Dh {dh} window {window}: " + json.dumps(row),
              flush=True)
        del q, k, v, want


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[],
                    metavar="LABEL=PATH")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--dtype", choices=("f32", "bf16", "all"), default="f32")
    ap.add_argument("--long", action="store_true")
    a = ap.parse_args(argv)
    dev = resolve_device(None)
    card = torch.cuda.get_device_name(0)
    dtypes = ("f32", "bf16") if a.dtype == "all" else (a.dtype,)
    sources = {"this": build.SOURCES["flash_attention"]}
    for spec in a.against:
        label, path = spec.split("=", 1)
        sources[label] = Path(path)
    libs = build.build_variants(
        "flash_attention", sources,
        *(f"flash_attention_kernel_{d}" for d in dtypes))

    stream = torch.cuda.current_stream(dev).cuda_stream
    if a.long:
        long_errors(libs, dev, stream)
    gen = torch.Generator(device=dev).manual_seed(1)
    names = [*libs, "sdpa"]
    results = {}
    for shape in SHAPES:
        label, dt, window, causal = (shape.label, shape.dtype, shape.window,
                                     shape.causal)
        if dt not in dtypes:
            continue
        q, k, v = draw(shape, dev, gen)
        want = ref.attention_ref(q, k, v, causal=causal,
                                 window=window).float()
        out = q.new_empty(q.shape[:3] + (shape.v_width,))
        tol = F32_TOL if dt == "f32" else ATTN_BF16_TOL
        fns = {name: (lambda lib=lib, q=q, k=k, v=v, out=out, w=window:
                      launch(lib, q, k, v, out, w, stream, causal))
               for name, lib in libs.items()}
        backend, lib_err = sdpa_backend(sdpa(q, k, v, window, causal))
        if backend is not None:
            fns["sdpa"] = sdpa(q, k, v, window, causal)
        row = {"shape": [shape.b, shape.s, shape.keys, shape.h, shape.kh,
                         shape.dh, shape.v_width], "dtype": dt,
               "window": window, "causal": causal, "sdpa_backend": backend,
               "sdpa_error": lib_err, **bound(shape, card)}
        for name, fn in fns.items():
            got = fn().float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            row[name] = {"max_abs_err": float(err.max()),
                         "ok": bool((err <= tol["atol"]
                                     + tol["rtol"] * want.abs()).all()),
                         "ms_reps": []}
        timed = [name for name in names if name in fns]
        for rep in range(a.reps):
            for name in timed if rep % 2 == 0 else timed[::-1]:
                row[name]["ms_reps"].append(median_ms(fns[name]))
        for name in timed:
            row[name]["ms"] = statistics.median(row[name]["ms_reps"])
            row[name]["bound_share"] = row["bound_ms"] / row[name]["ms"]
        results[label] = row
        print(f"{label}: " + json.dumps(row), flush=True)
        if not row["this"]["ok"]:
            raise SystemExit(f"{label}: this source's kernel disagrees with "
                             "the plain version")
        del q, k, v, want, out
    print(json.dumps({"card": card, "shapes": {
        label: {name: row[name]["ms"] if name in row else None
                for name in names}
        | {"bound_ms": row["bound_ms"]} for label, row in results.items()}}),
        flush=True)


if __name__ == "__main__":
    main()
