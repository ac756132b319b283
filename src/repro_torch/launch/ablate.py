"""What holds a kernel back: its time on the card with one part of its work
taken out.

    python -m repro_torch.launch.ablate [--out FILE]

Each variant is a kernel's source (``csrc/``) with named text replacements
that remove one part of the work, built with the port's nvcc flags into
``build/ablate/`` and launched through ctypes at the shape of its main path:
``flash_attention`` at q (8, 4096, 9, 64), k, v (8, 4096, 3, 64), causal, f32
and bf16; ``hist_level`` at the embedding's rows (8, 28,311,552) f32, S = 1,
at the top level (every element matches) and at a prefix no element has
(the bytes alone).  A variant's results are wrong by construction: only its
time means something.  A replacement that no longer matches its source
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

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fedfa_quantile.multilevel import HIST_LEVEL
from repro_torch.kernels.flash_attention.ops import FLASH_ATTENTION

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


def variant_library(kernel, name: str, edits) -> ctypes.CDLL:
    """Build the kernel's source with ``edits`` and load it."""
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
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(so)), kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
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
                             -1, 0.125, stream)
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
    sq = torch.zeros((R, 2, 1, 256), device="cuda")
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
              "hist_level_ms": hist_times(gen)}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
