"""What holds a kernel back: its time on the card with one part of its work
taken out.

    python -m repro_torch.launch.ablate [--out FILE]

Each variant is a kernel's source (``csrc/``) with named text replacements
that remove one part of the work, built with the port's nvcc flags into
``build/ablate/`` and launched through ctypes at the shape of its main path:
``flash_attention`` at q (8, 4096, 9, 64), k, v (8, 4096, 3, 64), causal, f32
and bf16; ``hist_level`` at the embedding's rows (8, 28,311,552) f32, S = 1,
at the top level (every element matches) and at a prefix no element has
(the bytes alone); ``ssd_intra_chunk`` at mamba2-130m's 8 × 1024 prefill
(G = 64 chunks of 128, 24 heads of 64, state 128), f32 and bf16;
``quantile_fused`` at the f32 round's ``wk``/``wv`` rows (240, 110,592),
f32, int8 and bf16.  A variant's results are wrong by construction: only its
time means something.  ``quantile_candidates`` and
``quantile_cluster_times`` measure ``quantile_fused``'s route and its time
at each cluster size on given rows (``chip_smoke.py`` passes them the main
path's).  A replacement that no longer matches its source
raises.  Prints one JSON object: the card, and ms per variant (mean of 10
launches, CUDA events).  Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fedfa_quantile.multilevel import HIST_LEVEL
from repro_torch.kernels.fedfa_quantile import ref as qref
from repro_torch.kernels.fedfa_quantile.ops import (_GATHER, QUANTILE_FUSED,
                                                    cluster_geometry)
from repro_torch.kernels.flash_attention.ops import FLASH_ATTENTION
from repro_torch.kernels.ssd.ops import SSD_INTRA_CHUNK, heads_per_block

OUT_DIR = build.BUILD_DIR.parent / "ablate"

# (variant, [(text in the source, its replacement)])
_SKIP_TILE_WORK = (
    "    unsigned char* vs = ks + P::tile_bytes;\n    if constexpr (P::kSplit) {",
    "    unsigned char* vs = ks + P::tile_bytes;\n    if (Sq > 0) continue;\n"
    "    if constexpr (P::kSplit) {")
FLASH_VARIANTS = [
    ("as is", []),
    ("no exponentials", [
        ("    return expf(x);", "    return x + 1.f;"),
        ('    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : '
         '"f"(x * 1.4426950408889634f));', "    y = x + 1.f;")]),
    ("no s = q k^T", [
        ("          mma_ss<BK>(sc,\n", "          if (j < 0) mma_ss<BK>(sc,\n"),
        ("        mma_ss<BK>(sc, smem_desc(qh", "        if (j < 0) mma_ss<BK>("
         "sc, smem_desc(qh"),
        ("    float sc[BK / 2];\n", "    float sc[BK / 2] = {};\n")]),
    ("no o += p v", [
        ("          mma_rs<HDP>(tile, a,\n", "          if (j < 0) mma_rs<HDP>("
         "tile, a,\n"),
        ("        mma_rs<HDP>(acc, a,\n", "        if (j < 0) mma_rs<HDP>("
         "acc, a,\n")]),
    ("no split pass (f32)", [
        ("    if constexpr (P::kSplit) {\n      // k in place -> hi",
         "    if constexpr (false) {\n      // k in place -> hi")]),
    ("one head per block", [
        ("  for (int w = kMaxHeadsPerBlock; w > 1; --w)",
         "  for (int w = 1; w > 1; --w)")]),
    ("the k, v copies and barriers alone", [_SKIP_TILE_WORK]),
    ("neither copies nor tile work", [
        _SKIP_TILE_WORK,
        ("    for (int c = tid; c < BK * nch; c += nthreads) {",
         "    for (int c = tid; c < BK * nch * (Sq < 0); c += nthreads) {")]),
]
HIST_VARIANTS = [
    ("as is", []),
    ("no segment map read", [
        ("#pragma unroll\n    for (int i = 0; i < V; i += W)\n"
         "      *reinterpret_cast<Vec<int, W>*>(sn.e + i) =\n"
         "          *reinterpret_cast<const Vec<int, W>*>(seg_id + c + i);",
         "#pragma unroll\n    for (int i = 0; i < V; ++i) sn.e[i] = 0;")]),
    ("no shared atomics for the elements off the hot keys", [
        ("      atomicAdd(cnt + k, 1);\n      add_sum(sq_lo + k, sq_hi + k, "
         "v);", "      if (v == 1u) atomicAdd(cnt + k, 1);")]),
]

_NO_Y = ("mma_rs<kHp>(yacc,", "if (Q < 0) mma_rs<kHp>(yacc,")
_NO_STATE = ("mma_rs<64>(st,", "if (Q < 0) mma_rs<64>(st,")
_NO_CB = ("    auto cb = [&](uint64_t a, uint64_t b) {",
          "    auto cb = [&](uint64_t a, uint64_t b) {\n"
          "      if (N > 0) return;")
SSD_VARIANTS = [
    ("as is", []),
    ("no C B^T", [_NO_CB]),
    ("no y = M x", [_NO_Y]),
    ("no state", [_NO_STATE]),
    ("copies, x^T, L and barriers alone", [_NO_CB,
        ("    {\n      float yacc[kHp / 2];", "    if (Q < 0) {\n      float "
         "yacc[kHp / 2];"),
        ("    {\n      float st[kHp / 2];", "    if (Q < 0) {\n      float "
         "st[kHp / 2];")]),
]
QUANTILE_VARIANTS = [
    ("as is", []),
    ("first level only", [("  level(1, true);\n  level(2, true);\n", "")]),
    ("no histogram adds", [
        ("        if (key[0] >= 0) atomicAdd(&hist[key[0]], V);",
         "        if (key[0] >= 0 && L < 0) atomicAdd(&hist[key[0]], V);"),
        ("          if (key[u] >= 0) atomicAdd(&hist[key[u]], 1);",
         "          if (key[u] >= 0 && L < 0) atomicAdd(&hist[key[u]], 1);")]),
    ("loads alone", [("  level(0, false);\n", "  if (L > 0) return;\n"
                      "  level(0, false);\n")]),
]


_BUILT = {}


def variant_library(kernel, name: str, edits) -> ctypes.CDLL:
    """Build the kernel's source with ``edits`` and load it (once a run)."""
    if (kernel.symbol, name) in _BUILT:
        return _BUILT[kernel.symbol, name]
    src = kernel.source.read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{kernel.source.name}, variant {name!r}: "
                               f"{old!r} is not in the source")
        src = src.replace(old, new)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    stem = kernel.source.stem + "-" + "".join(
        c if c.isalnum() else "_" for c in name)
    cu, so = OUT_DIR / f"{stem}.cu", OUT_DIR / f"{stem}.so"
    cu.write_text(src)
    subprocess.run([build._nvcc(), *kernel.flags, "-I", str(build.CSRC),
                    "-o", str(so), str(cu)], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(so)), kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    _BUILT[kernel.symbol, name] = fn
    return fn


def time_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_times(gen) -> dict:
    out = {}
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 2)):
        q, k, v = (torch.randn((8, 4096, n, 64), generator=gen,
                               device="cuda").to(dtype) for n in (9, 3, 3))
        o = torch.empty_like(q)
        for name, edits in FLASH_VARIANTS:
            fn = variant_library(FLASH_ATTENTION, name, edits)
            run = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), code, 8, 4096, 4096, 9, 3, 64, 1,
                             -1, 0, 0.125, stream)
            if run() != 0:
                raise RuntimeError(f"flash_attention {name!r} did not launch")
            out[f"{str(dtype)[6:]}: {name}"] = time_ms(run)
    return out


def hist_times(gen) -> dict:
    out = {}
    R, L = 8, 28_311_552
    x = torch.randn((R, L), generator=gen, device="cuda")
    seg = torch.zeros(L, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    cnt = torch.zeros((R, 2, 1, 256), dtype=torch.int32, device="cuda")
    sq = torch.zeros((R, 2, 1, 256), dtype=torch.int64, device="cuda")
    # the top level, and a prefix of bits 8..31 that no |x| has (sign set)
    levels = (("top level", 24, 0), ("nothing matches", 0, -1))
    for name, edits in HIST_VARIANTS:
        fn = variant_library(HIST_LEVEL, name, edits)
        for level, shift, prefix in levels:
            hi = torch.full((R, 2, 1), prefix, dtype=torch.int32,
                            device="cuda")
            run = lambda: fn(x.data_ptr(), 0, seg.data_ptr(), None,
                             hi.data_ptr(), cnt.data_ptr(), sq.data_ptr(),
                             R, L, 1, shift, sms, stream)
            if run() != 0:
                raise RuntimeError(f"hist_level {name!r} did not launch")
            out[f"{level}: {name}"] = time_ms(run)
    return out


def ssd_times(gen) -> dict:
    out = {}
    G, Q, nh, hp, N = 64, 128, 24, 64, 128
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    dt = torch.rand((G, Q, nh), generator=gen, device="cuda")
    A = -torch.rand(nh, generator=gen, device="cuda")
    y = torch.empty((G, Q, nh, hp), device="cuda")
    state = torch.empty((G, nh, hp, N), device="cuda")
    L = torch.empty((G, Q, nh), device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((G, Q, nh, hp), generator=gen, device="cuda").to(dtype)
        B, C = (torch.randn((G, Q, N), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        hg = heads_per_block(G, Q, nh, hp, N, sms, x.element_size())
        for name, edits in SSD_VARIANTS:
            fn = variant_library(SSD_INTRA_CHUNK, name, edits)
            run = lambda: fn(x.data_ptr(), build.DTYPE_CODES[dtype],
                             dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                             C.data_ptr(), y.data_ptr(), state.data_ptr(),
                             L.data_ptr(), G, Q, nh, hp, N, hg, stream)
            if run() != 0:
                raise RuntimeError(f"ssd_intra_chunk {name!r} did not launch")
            out[f"{str(dtype)[6:]}: {name}"] = time_ms(run)
    return out


def quantile_times(gen) -> dict:
    out = {}
    R, Lr = 240, 110_592
    stream = torch.cuda.current_stream().cuda_stream
    q = 1.0 - 0.05 * torch.rand(R, generator=gen, device="cuda")
    s = torch.full((R,), 0.02, device="cuda")
    t, ss = torch.empty(R, device="cuda"), torch.empty(R, device="cuda")
    x = torch.randn((R, Lr), generator=gen, device="cuda")
    rows = {"float32": (x, None),
            "int8": ((x * 30).round().clamp(-127, 127).to(torch.int8), s),
            "bfloat16": (x.to(torch.bfloat16), s)}
    for dtype, (xr, sc) in rows.items():
        cs, per, _ = cluster_geometry(Lr, xr.element_size())
        for name, edits in QUANTILE_VARIANTS:
            fn = variant_library(QUANTILE_FUSED, name, edits)
            run = lambda: fn(xr.data_ptr(), build.DTYPE_CODES[xr.dtype],
                             q.data_ptr(),
                             None if sc is None else sc.data_ptr(),
                             t.data_ptr(), ss.data_ptr(), R, Lr, cs, per,
                             stream)
            if run() != 0:
                raise RuntimeError(f"quantile_fused {name!r} did not launch")
            out[f"{dtype}: {name}"] = time_ms(run)
    return out


def quantile_candidates(rows: torch.Tensor, q: torch.Tensor,
                        scale: Optional[torch.Tensor] = None):
    """(candidates of each row, how many CTA 0 holds) of a ``quantile_fused``
    call, by the kernel's rule: the elements of the first level's bins
    (bits 20..30 of |x|) from the floor statistic's to the ceil
    statistic's.  A row with more than CTA 0 holds runs every select level
    over the whole cluster.  None for int8 rows, which take one level."""
    if rows.dtype == torch.int8:
        return None
    mag = qref.dequantize_rows(rows, scale).abs()
    r0, r1, _ = qref.interpolation_ranks(q, torch.tensor(mag.shape[1]))
    srt = mag.sort(dim=1).values
    key = mag.view(torch.int32) >> 20
    b0 = srt.gather(1, r0[:, None]).view(torch.int32) >> 20
    b1 = srt.gather(1, r1[:, None]).view(torch.int32) >> 20
    return ((key >= b0) & (key <= b1)).sum(1), _GATHER // rows.element_size()


def quantile_cluster_times(rows: torch.Tensor, q: torch.Tensor,
                           scale: Optional[torch.Tensor] = None) -> dict:
    """ms of ``quantile_fused`` on these rows at every cluster size that
    holds them, launched through its library (the wrapper's counts do not
    move)."""
    fn = QUANTILE_FUSED._load()
    R, L = rows.shape
    stream = torch.cuda.current_stream().cuda_stream
    t, ss = torch.empty(R, device="cuda"), torch.empty(R, device="cuda")
    out = {}
    for cs in (1, 2, 4, 8):
        try:
            _, per, _ = cluster_geometry(L, rows.element_size(), cs)
        except ValueError:
            continue
        run = lambda: fn(rows.data_ptr(), build.DTYPE_CODES[rows.dtype],
                         q.data_ptr(),
                         None if scale is None else scale.data_ptr(),
                         t.data_ptr(), ss.data_ptr(), R, L, cs, per, stream)
        if run() != 0:
            raise RuntimeError(f"quantile_fused did not launch at {cs} CTAs")
        out[cs] = time_ms(run)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": smi.stdout.strip().splitlines()[0],
              "flash_attention_ms": flash_times(gen),
              "hist_level_ms": hist_times(gen),
              "ssd_intra_chunk_ms": ssd_times(gen),
              "quantile_fused_ms": quantile_times(gen)}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
