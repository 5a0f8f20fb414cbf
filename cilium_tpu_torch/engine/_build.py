"""Build and bind the hand-written CUDA kernels (``engine/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``cilium_tpu_torch/_build/``
(git-ignored) at first use, and loaded with ``ctypes``. Every C entry
point takes its pointers and the stream as ``void*``, launches on the
stream it is given and returns ``cudaGetLastError()``; :meth:`Kernel.
launch` raises on anything but 0. A build failure raises too: there is
no fallback to the plain versions on a CUDA tensor.

The library name carries a hash of its source and of the shared
headers (``csrc/*.cuh``), so an edited kernel is rebuilt and a stale
library is never loaded. Nothing here runs at
import time: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int


def _headers() -> List[str]:
    """The shared headers under ``csrc`` (part of every library's hash)."""
    return sorted(os.path.join(CSRC, n) for n in os.listdir(CSRC)
                  if n.endswith(".cuh"))


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from engine/csrc at first use")


class Kernel:
    """One hand-written kernel: its source, its C symbol and argument
    types, the reference function it replaces (``file:line``), and a
    count of launches (one per call of :meth:`launch`, and nowhere
    else), also kept per variant for a kernel that has several."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self.launches_by_variant: Dict[str, int] = {}
        self._fn = None
        self._lib = None

    @property
    def source_path(self) -> str:
        return os.path.join(CSRC, self.source)

    def library_path(self) -> str:
        h = hashlib.sha256()
        for path in [self.source_path, *_headers()]:
            with open(path, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:12]
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")

    def build_command(self, out: str) -> List[str]:
        return [nvcc_path(), *NVCC_FLAGS, "-o", out, self.source_path]

    def _load(self):
        path = self.library_path()
        if not os.path.exists(path):
            build([self])
        lib = ctypes.CDLL(path)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        lib.ct_error_string.argtypes = [ctypes.c_int]
        lib.ct_error_string.restype = ctypes.c_char_p
        self._lib, self._fn = lib, fn

    def launch(self, *args, variant: Optional[str] = None) -> None:
        """Call the C entry point; raise on a refused or failed launch.
        ``variant`` names which of the kernel's variants the arguments
        launch, for :attr:`launches_by_variant`."""
        if self._fn is None:
            self._load()
        rc = self._fn(*args)
        if rc != 0:
            msg = self._lib.ct_error_string(rc).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"{msg} (cudaError {rc})")
        self.launches += 1
        if variant is not None:
            self.launches_by_variant[variant] = \
                self.launches_by_variant.get(variant, 0) + 1


def build(kernels: Optional[Sequence[Kernel]] = None) -> float:
    """Compile the given kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns seconds."""
    kernels = list(KERNELS.values()) if kernels is None else list(kernels)
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for k in kernels:
        out = k.library_path()
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs.append((k, out, tmp, subprocess.Popen(
            k.build_command(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)))
    errors = []
    for k, out, tmp, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            errors.append(f"{k.source}: nvcc exit {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)      # atomic: a half-written .so is never seen
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.launches_by_variant = {}


KERNELS: Dict[str, Kernel] = {
    "KD": Kernel(
        "dfa_dense", "dfa_dense.cu", "ct_dfa_dense",
        [_P],                   # one int64 array of its 25 arguments
        # dfa_scan_banked, a lax.scan of gathers, not Pallas
        replaces="cilium_tpu/engine/dfa_kernel.py:180"),
    "K1": Kernel(
        "nfa_scan", "nfa_scan.cu", "ct_nfa_scan",
        [_P] * 7 + [_I] * 5 + [_P],
        replaces="cilium_tpu/engine/pallas_nfa.py:85"),
    "K2": Kernel(
        "dfa_oblivious", "dfa_oblivious.cu", "ct_dfa_oblivious",
        [_P] * 6 + [_I] * 5 + [_P],
        replaces="cilium_tpu/engine/pallas_dfa.py:82"),
}


def cuda_check(t, dtype, what: str) -> None:
    """Check one kernel argument: a CUDA tensor of ``dtype``. Raises on
    a CPU tensor or a wrong type — the kernels take nothing else, and
    the wrapper never converts silently."""
    if not getattr(t, "is_cuda", False):
        raise ValueError(f"{what}: the CUDA kernel takes a CUDA tensor, "
                         f"got {getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")


def cuda_arg(t, dtype, what: str):
    """:func:`cuda_check`, then the tensor made contiguous."""
    cuda_check(t, dtype, what)
    return t.contiguous()


def stream_ptr(device_index: Optional[int] = None) -> int:
    """The handle of the current CUDA stream of the device (the current
    device when not given), without building a ``torch.cuda.Stream``."""
    import torch

    if device_index is None:
        device_index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(device_index)
