"""Build and bind the hand-written CUDA kernels in ``repro_torch/csrc``.

Each ``.cu`` source has a plain C entry point and is compiled by ``nvcc``
into its own shared library (for ``sm_90a``), loaded with ``ctypes``.  A
library is built at first use into ``build/kernels/`` at the repository
root (listed in ``.gitignore``), named by a hash of its source, of every
header (``*.cuh``) beside it and of the flags (with the ``-D`` values a
wrapper passes its kernel), so that an edited source, shared header or
value is rebuilt.  ``build_all`` starts one ``nvcc`` per source
at once.  Nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


class CudaKernel:
    """One kernel's shared library, its C entry point and launch counts.

    ``defines`` are compile-time constants of the source (``-D`` flags),
    set where the wrapper also reads them.  ``launches`` grows by one each
    time ``launch`` runs the kernel, and ``by_shape[shape]`` too where the
    wrapper names the shape it launched at; ``reset`` zeroes both."""

    def __init__(self, source: str, symbol: str, argtypes: List,
                 defines: Optional[dict] = None):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.flags = NVCC_FLAGS + tuple(
            f"-D{k}={v}" for k, v in sorted((defines or {}).items()))
        self.launches = 0
        self.by_shape = collections.Counter()
        self._fn = None

    def reset(self) -> None:
        self.launches = 0
        self.by_shape.clear()

    @property
    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:12]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this kernel unless its library is already built."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        log = open(self.library.with_suffix(".log"), "w")
        proc = subprocess.Popen([_nvcc(), *self.flags, "-I", str(CSRC),
                                 "-o", str(tmp), str(self.source)],
                                stdout=log, stderr=subprocess.STDOUT)
        proc.tmp, proc.log = tmp, log
        return proc

    def _load(self):
        if self._fn is None:
            build_all([self])
            fn = getattr(ctypes.CDLL(str(self.library)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args, shape: Optional[tuple] = None) -> None:
        """Run the kernel on the current stream; raise if it did not launch.
        ``shape`` names the launch's shape in ``by_shape``."""
        rc = self._load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error "
                               f"{rc}")
        self.launches += 1
        if shape is not None:
            self.by_shape[shape] += 1


# contexts a recorder (``analysis.dispatch.Recorder``) pushes while it
# runs: each is called as hook(name, inputs, writes) and gives the context
# a kernel call runs in
SCOPE_HOOKS: list = []


@contextlib.contextmanager
def kernel_scope(name: str, *inputs, writes=()):
    """The context in which every wrapper runs its kernel's launch and its
    plain version: nothing outside a recording, and inside one a single
    read of ``inputs`` whose ops are not counted (the reference's
    ``pallas_call`` rule), so that both routes count alike.  ``writes``:
    the tensors the kernel writes in place, recorded as written."""
    if not SCOPE_HOOKS:
        yield
        return
    with SCOPE_HOOKS[-1](name, inputs, writes):
        yield


def build_all(kernels: Iterable[CudaKernel]) -> None:
    """Compile every kernel not built yet, all nvcc processes at once."""
    procs = [(k, p) for k in kernels if (p := k.start_build()) is not None]
    failed = []
    for k, p in procs:
        p.wait()
        p.log.close()
        if p.returncode == 0:
            os.replace(p.tmp, k.library)
        else:
            failed.append(f"{k.source.name}:\n"
                          + k.library.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


# element-type codes of the kernels' C entry points
DTYPE_CODES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_input(name: str, t: torch.Tensor, dtype: torch.dtype,
                shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (the kernels take no strides).  Wrappers check on every
    device, so the CPU path rejects what the kernel would."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on {device}: the kernels run on CUDA "
                         f"and their plain versions on the CPU")


def runs_plain(t: torch.Tensor, use_kernel: Optional[bool] = None) -> bool:
    """Whether a wrapper runs its plain version on ``t`` instead of its
    kernel.  ``use_kernel`` None (auto): the kernel on a CUDA tensor, the
    plain version on a CPU tensor; True: the kernel, and a CPU tensor
    raises; False: the plain version on any device (the port's stand-in
    for Pallas interpret mode, ``FLConfig.interpret``).  A kernel that
    fails to build or launch raises; it never gives way to the plain
    version."""
    if use_kernel is False:
        return True
    if t.device.type == "cpu":
        if use_kernel:
            raise RuntimeError("use_kernel=True: the CUDA kernels run on "
                               "CUDA tensors, got a CPU tensor")
        return True
    return False
