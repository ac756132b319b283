"""The benchmark's one command, from the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's inputs from the seed, warms up, measures a closed loop
for ``--seconds``, checks what the timed path produced against the plain
reference (``bench/reference``), and prints one JSON line last on
standard output.  Exits non-zero, printing no result, without as many
CUDA devices as the cell asks for, when the program is missing, or when
a module of JAX or of the JAX package was loaded."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def prepare_environment() -> None:
    """The program's package on the path, and every cache the program or
    PyTorch may write kept inside the checkout, at fixed paths."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / "build" / "bench-cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))
    os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args, device: str = "cuda", config=None, traffic=None,
        t_start: float = T_START) -> dict:
    """One run of a cell; returns the result line's object.  ``device``
    "cpu" (with a small ``config``) is for the benchmark's own tests."""
    import torch
    from bench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h = harness.Harness(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start, device, config, traffic)
    if device == "cuda":
        need = int(h.cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise SystemExit(f"cell {args.workload} needs {need} CUDA "
                             f"device(s), found "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    harness.entry(h.traffic["entry"]).run(h)
    t0 = time.perf_counter()
    h.read_trace()
    h.diag["trace_read_s"] = time.perf_counter() - t0
    out = h.result(harness.benchmark())
    h.diag.update(h.e2e)
    h.diag["memory_peak_bytes"] = h.memory_peak
    print("diag " + json.dumps(h.diag), file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    prepare_environment()
    args = parse(argv)
    try:
        out = run(args)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    from bench import harness
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
