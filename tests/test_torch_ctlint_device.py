"""The port's ctlint device family and its own tree.

The eight rules the reference states in JAX's terms (``jit-purity``,
``shape-dtype``, ``recompile-hazard``, ``implicit-sync``,
``hot-loop-h2d``, ``readback-ordering``, ``missing-donation``,
``pallas-block-shape``) are restated in the port for torch and CUDA
(each module's docstring says how). Here: a torch counterpart of each
reference corpus ``tests/analysis_corpus/device_*_{bad,good}.py`` as a
string, with the lines each finding must carry; the premises of
``shape-dtype``, checked by running torch on the CPU; the two Hopper
launch faces of ``pallas-block-shape``; the reference's JAX spellings,
which have no torch counterpart and find nothing; and the port's own
tree — linted once for the module — clean, with the report, the AST
cache, ``--changed-only`` and the wall budget of the reference's.
"""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

import test_ctlint as REF_TESTS
from cilium_tpu_torch.analysis import core
from cilium_tpu_torch.analysis import devicedataflow as dd_rule
from cilium_tpu_torch.analysis import pallas_shapes as hopper_rule
from cilium_tpu_torch.analysis import purity as purity_rule
from cilium_tpu_torch.analysis import recompile as rec_rule
from cilium_tpu_torch.analysis import shapes as shape_rule
from cilium_tpu_torch.analysis.callgraph import Project, project_for
from cilium_tpu_torch.analysis.core import ProjectIndex

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = "cilium_tpu_torch/engine"


def _check(sources, checker, **kw):
    """One rule over an in-memory corpus, the disable filter applied as
    ``core.run`` applies it."""
    index, errors = ProjectIndex.from_sources(sources)
    assert not errors, errors
    out = []
    for f in checker(index, **kw):
        sf = index.by_path.get(f.path)
        if sf is not None and sf.disabled(f.line, f.rule):
            continue
        out.append(f)
    return out


def _device(name, src):
    """The device family over one corpus placed on the hot path."""
    return _check({f"{ENGINE}/{name}.py": src}, dd_rule.check)


# -- jit-purity ---------------------------------------------------------------

PURITY_BAD = """\
import time

import torch


def helper(x):
    return x + time.time()


def kern_step(x):
    if torch.any(x > 0):
        return helper(x)
    return x.sum().item()
"""

PURITY_GOOD = """\
import torch


def helper(x):
    return torch.sum(x)


def kern_step(x):
    return torch.where(x > 0, helper(x), x)
"""

#: a kernel module: its wrapper launches through the KERNELS idiom, and
#: Kernel.launch takes a lock — reached from the wrapper
KERNEL_BUILD = """\
import threading


class Kernel:
    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0

    def launch(self, *args):
        with self._lock:
            self.launches += 1


KERNELS = {"KX": Kernel()}
"""

KERNEL_WRAPPER = """\
import torch

from cilium_tpu_torch.engine import _build

KERNEL = _build.KERNELS["KX"]


def scan_cuda(data):
    out = torch.empty_like(data)
    KERNEL.launch(data.data_ptr(), out.data_ptr())
    return out


def scan_plain(data):
    print(data)
    return data
"""


def test_purity_bad_corpus():
    found = _check({f"{ENGINE}/kern.py": PURITY_BAD}, purity_rule.check)
    msgs = "\n".join(f.message for f in found)
    assert all(f.rule == "jit-purity" for f in found)
    assert "time.time" in msgs                      # via the helper
    assert "branch on a device value" in msgs       # if torch.any(...)
    assert ".item()" in msgs
    assert "device entry `kern_step`" in msgs


def test_purity_good_corpus():
    assert _check({f"{ENGINE}/kern.py": PURITY_GOOD},
                  purity_rule.check) == []


def test_purity_kernel_wrapper_reaches_the_launch_lock():
    """The wrapper (it launches) and its plain version are entries; the
    walk follows ``KERNEL.launch`` into ``Kernel.launch``."""
    found = _check({f"{ENGINE}/_build.py": KERNEL_BUILD,
                    f"{ENGINE}/scan.py": KERNEL_WRAPPER},
                   purity_rule.check)
    got = sorted((f.path.rsplit("/", 1)[-1], f.line) for f in found)
    assert got == [("_build.py", 10), ("scan.py", 15)], found
    assert any("lock acquisition" in f.message
               and "`scan_cuda`" in f.message for f in found)


def test_purity_compile_call_form_and_lock():
    src = ("import threading\nimport torch\nLOCK = threading.Lock()\n"
           "def step(x):\n    with LOCK:\n        return x\n"
           "fn = torch.compile(step)\n")
    found = _check({"pkg/m.py": src}, purity_rule.check)
    assert [f.line for f in found] == [5]
    assert "lock acquisition" in found[0].message


def test_purity_outside_entries_is_quiet():
    """The same body, neither a kernel module's function nor an engine
    step nor compiled, is not an entry."""
    assert _check({"cilium_tpu_torch/tools/kern.py": PURITY_BAD},
                  purity_rule.check) == []


# -- shape-dtype ----------------------------------------------------------------

SHAPES_BAD = """\
import torch


def kern_step(
    table,   # [128, 64] int32
    probe,   # [100] int32
    data,    # [B, L] uint8
    lengths, # [B] int32
):
    bad = table[:, 0] + probe                     # 128 vs 100 broadcast
    acc = torch.sum(lengths, dtype=torch.int32)   # narrow acc over B
    wrapped = data + 1000                         # uint8 wrap
    idx = torch.argmax(data, dim=1)               # [B]
    picked = torch.gather(data, 1, idx)           # rank 2 vs 1
    resh = table.reshape(32, 64)                  # 8192 -> 2048
    mm = table @ table                            # 64 vs 128
    return bad, acc, wrapped, picked, resh, mm
"""

SHAPES_GOOD = """\
import torch


def fold(words, lengths):
    return torch.sum(words & 1, dim=1)


def kern_step(
    trans,      # [S, K] int32
    byteclass,  # [256] int32
    data,       # [B, L] uint8
    lengths,    # [B] int32
):
    cls = byteclass[data.long()]                         # [B, L]
    valid = torch.arange(data.shape[1])[None, :] < lengths[:, None]
    rows = torch.where(valid, cls, 0)
    total = lengths.sum()            # torch accumulates int32 in int64
    return fold(rows.to(torch.int32), lengths), total
"""


def test_shape_dtype_bad_corpus():
    found = _check({f"{ENGINE}/kern.py": SHAPES_BAD}, shape_rule.check)
    by_line = {f.line: f.message for f in found}
    assert all(f.rule == "shape-dtype" for f in found)
    assert "shape mismatch in `Add`" in by_line[10]
    assert "int32-overflow-prone accumulation" in by_line[11]
    assert "explicit dtype=int32" in by_line[11]
    assert "weak-type wrap: int literal 1000" in by_line[12]
    assert "`gather` requires equal ranks" in by_line[14]
    assert "reshape element-count mismatch" in by_line[15]
    assert "matmul contraction mismatch" in by_line[16]
    assert sorted(by_line) == [10, 11, 12, 14, 15, 16]


def test_shape_dtype_good_corpus():
    assert _check({f"{ENGINE}/kern.py": SHAPES_GOOD},
                  shape_rule.check) == []


def test_shape_dtype_symbolic_dims_do_not_conflict():
    src = ("import torch\n@torch.compile\ndef k(\n    a,  # [B] int32\n"
           "    b,  # [N] int32\n):\n    return a + b\n")
    assert _check({"pkg/m.py": src}, shape_rule.check) == []


def test_shape_dtype_interprocedural():
    src = ("import torch\ndef helper(x, y):\n    return x + y\n"
           "@torch.compile\ndef k(\n    a,  # [8] int32\n"
           "    b,  # [9] int32\n):\n    return helper(a, b)\n")
    found = _check({"pkg/m.py": src}, shape_rule.check)
    assert [f.line for f in found] == [3]


def test_premise_integer_sums_promote_to_int64():
    """torch accumulates an int32 sum or cumsum in int64 unless told
    otherwise: the implicit narrow-accumulator face does not exist."""
    x = torch.full((8,), 2 ** 30, dtype=torch.int32)
    assert x.sum().dtype == torch.int64 and int(x.sum()) == 2 ** 33
    assert x.cumsum(0).dtype == torch.int64
    wrapped = torch.sum(x, dtype=torch.int32)
    assert wrapped.dtype == torch.int32 and int(wrapped) != 2 ** 33
    assert torch.ones(4, dtype=torch.uint8).sum().dtype == torch.int64


def test_premise_a_python_scalar_keeps_the_narrow_dtype():
    """``uint8 + 1000`` stays uint8 and wraps, silently."""
    got = torch.tensor([200], dtype=torch.uint8) + 1000
    assert got.dtype == torch.uint8 and int(got[0]) == 176


@pytest.mark.parametrize("op", ["gather", "take_along_dim"])
def test_premise_gather_needs_equal_ranks(op):
    data = torch.zeros((2, 3))
    idx = torch.zeros(2, dtype=torch.long)
    with pytest.raises(RuntimeError):
        if op == "gather":
            torch.gather(data, 1, idx)
        else:
            torch.take_along_dim(data, idx, dim=1)
    ok = torch.gather(data, 1, idx[:, None])
    assert ok.shape == (2, 1)


def test_shape_entries_nonvacuous(port_tree):
    assert shape_rule.entry_count(port_tree.index) >= 10


# -- recompile-hazard -----------------------------------------------------------

REWRAP_BAD = """\
import ctypes

import torch


def hot(x):
    fn = torch.compile(lambda v: v + 1)
    return fn(x)


def bind(path):
    return ctypes.CDLL(path)
"""

REWRAP_GOOD = """\
import ctypes
import functools

import torch


def step(x):
    return x


STEP = torch.compile(step)         # module-level: one graph, ever
LIB = ctypes.CDLL("libk.so")       # module-level binding


class Kernel:
    def __init__(self):
        self._cache = {}
        self._lib = None

    def load(self, path):
        lib = ctypes.CDLL(path)
        fn = lib.run
        self._lib, self._fn = lib, fn    # memoized onto self

    def graph(self, key):
        fn = self._cache.get(key)
        if fn is None:
            fn = torch.compile(step)     # memoized via a self dict
            self._cache[key] = fn
        return fn


@functools.lru_cache(maxsize=None)
def factory(key):
    return torch.compile(step)           # cached factory


_LIB = None


def native(path):
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(path)          # memoized into a module global
        _LIB = lib
    return _LIB
"""

DYNAMIC = """\
import torch


@torch.compile
def shaped(cfg, data):
    B, L = data.shape
    pad = (-L) % 8
    if pad:
        data = torch.nn.functional.pad(data, (0, pad))
    out = torch.zeros((cfg.engine.batch_size, 4))
    return data, out
"""


def test_recompile_rewrap_bad():
    found = _check({"pkg/m.py": REWRAP_BAD}, rec_rule.check)
    msgs = sorted(f.message.split(" built")[0] for f in found)
    assert msgs == ["`ctypes.CDLL`", "`torch.compile`"]


def test_recompile_rewrap_good_patterns_exempt():
    assert _check({"pkg/m.py": REWRAP_GOOD}, rec_rule.check) == []


def test_recompile_package_builders_per_call():
    src = ("from cilium_tpu_torch.engine import _build\n\n\n"
           "def hot(x):\n    _build.build()\n"
           "    k = _build.Kernel('k', 'k.cu', 'ct_k', [], '')\n"
           "    return k\n")
    found = _check({f"{ENGINE}/m.py": src, f"{ENGINE}/_build.py":
                    "def build():\n    pass\nclass Kernel:\n    pass\n"},
                   rec_rule.check)
    assert [(f.line, f.message.split(" built")[0]) for f in found] == \
        [(5, "`_build.build`"), (6, "`_build.Kernel`")]


def test_recompile_dynamic_faces_on_compiled_entries():
    found = _check({"pkg/m.py": DYNAMIC}, rec_rule.check)
    msgs = "\n".join(f.message for f in found)
    assert "shape-dependent Python branch on `pad`" in msgs
    assert "config-derived scalar `cfg.engine.batch_size`" in msgs


def test_recompile_dynamic_faces_do_not_apply_to_eager_steps():
    """The same body as an eager device step (no compile): a shape
    branch compiles nothing, so the two faces find nothing."""
    eager = DYNAMIC.replace("@torch.compile\ndef shaped", "def shaped_step")
    assert _check({f"{ENGINE}/m.py": eager}, rec_rule.check) == []


# -- the device-dataflow family ---------------------------------------------

SYNC_BAD = """\
import numpy as np
import torch


def verdict_step(batch):
    return torch.sum(batch, dim=-1)


def serve(chunks):
    out = verdict_step(chunks[0])
    if out:                        # truthiness blocks on the device
        raise ValueError("empty verdict batch")
    total = float(out)             # scalar coercion blocks again
    results = []
    for c in chunks:
        r = verdict_step(c)
        results.append(r.cpu())    # one readback PER chunk
    idx = torch.nonzero(out)       # the host reads the count first
    sel = out[out > 0]             # a boolean mask: the same
    host = np.asarray(out)
    return total, results, idx, sel, host
"""

SYNC_GOOD = """\
import torch


def verdict_step(batch):
    return torch.sum(batch, dim=-1)


def serve(chunks, repeats):
    outs = [verdict_step(c) for c in chunks]
    first = outs[0]
    if first.is_cuda and first.size(0) > 0 and "verdict" in {}:
        pass
    dup = first.repeat_interleave(2)       # an int count fixes the size
    host = torch.stack(outs).cpu().numpy()
    return [float(h) for h in host], dup
"""

H2D_BAD = """\
import torch


def verdict_step(batch):
    return torch.sum(batch, dim=-1)


def replay(chunks, device):
    outs = []
    for c in chunks:
        dev = torch.as_tensor(c, device=device)   # per-iteration H2D
        outs.append(verdict_step(dev))
        outs.append(verdict_step(torch.from_numpy(c).to(device)))
        outs.append(verdict_step(torch.from_numpy(c).cuda()))
    return torch.stack(outs).cpu()
"""

H2D_GOOD = """\
import torch


def verdict_step(batch):
    return torch.sum(batch, dim=-1)


class Replay:
    def __init__(self, device):
        self.device = device
        self._next = None

    def prime(self, chunk):
        self._next = torch.as_tensor(chunk, device=self.device)

    def run(self, chunks):
        outs = []
        for c in chunks[1:]:
            cur = self._next
            # staged store: a pinned upload double-buffers the step
            self._next = torch.from_numpy(c).pin_memory().to(
                self.device, non_blocking=True)
            outs.append(verdict_step(cur))
        outs.append(verdict_step(self._next))
        return torch.stack(outs).cpu()
"""

READBACK_BAD = """\
import torch


def a_step(x):
    return torch.sum(x, dim=-1)


def b_step(x):
    return torch.amax(x, dim=-1)


def serve(xa, xb):
    a = a_step(torch.as_tensor(xa, device="cuda"))
    host_a = a.cpu()               # blocks before b_step is issued
    b = b_step(torch.as_tensor(xb, device="cuda"))
    return host_a, b
"""

READBACK_GOOD = """\
import torch


def a_step(x):
    return torch.sum(x, dim=-1)


def b_step(x):
    return torch.amax(x, dim=-1)


def serve(xa, xb):
    a = a_step(torch.as_tensor(xa, device="cuda"))
    b = b_step(torch.as_tensor(xb, device="cuda"))
    return torch.stack((a, b)).cpu()
"""

#: the memo-refill shape: the memo's resident table (``self.table``, a
#: device table in ``engine/memo.py``) and a buffer a caller passes in
DONATION_BAD = """\
import torch


def verdict_step(batch):
    return torch.sum(batch, dim=-1)


def merge(lanes, out):
    lanes = torch.where(out > 0, out, lanes)  # the caller's buffer
    return lanes


class Memo:
    def refill(self, chunk, idx):
        out = verdict_step(chunk)
        self.table = self.table.index_copy(0, idx, out)   # a fresh table
        lanes = torch.zeros_like(out)
        merge(out, lanes)
        tmp = torch.where(out > 0, out, lanes)
        tmp = torch.where(tmp > 1, tmp, out)      # its own temporary
        return tmp
"""

DONATION_GOOD = """\
import torch


def verdict_step(batch):
    return torch.sum(batch, dim=-1)


def merge(lanes, out):
    torch.where(out > 0, out, lanes, out=lanes)
    return lanes


class Memo:
    def refill(self, chunk, idx):
        out = verdict_step(chunk)
        self.table.index_copy_(0, idx, out)       # in place
        lanes = torch.zeros_like(out)
        merge(out, lanes)
        return lanes
"""


def test_device_sync_bad_corpus():
    out = _device("sync_bad", SYNC_BAD)
    sync = {f.line: f.message for f in out if f.rule == "implicit-sync"}
    assert sorted(sync) == [11, 13, 17, 18, 19], out
    assert "`truthiness`" in sync[11]
    assert "`float()`" in sync[13]
    assert "`.cpu()`" in sync[17] and "inside a loop" in sync[17]
    assert "`torch.nonzero`" in sync[18]
    assert "`boolean-mask index`" in sync[19]
    for f in out:
        assert f.residency and any("verdict_step" in r
                                   for r in f.residency), f


def test_device_sync_good_clean():
    assert _device("sync_good", SYNC_GOOD) == []


def test_device_h2d_bad_and_prefetch_suppression():
    out = _device("h2d_bad", H2D_BAD)
    h2d = {f.line: f.message for f in out if f.rule == "hot-loop-h2d"}
    assert sorted(h2d) == [11, 13, 14], out
    assert "`torch.as_tensor(device=)`" in h2d[11]
    assert "`.to(device)`" in h2d[13]
    assert "`.cuda()`" in h2d[14]
    assert _device("h2d_good", H2D_GOOD) == []


def test_device_donation_bad_good():
    """Only buffers that outlive the call: the memo's table and the
    caller's ``lanes``; the temporaries ``refill`` builds are its own."""
    out = _device("memo", DONATION_BAD)
    don = {f.line: f.message for f in out if f.rule == "missing-donation"}
    assert sorted(don) == [9, 16], out
    assert "`torch.where`" in don[9] and "out=" in don[9]
    assert "`.index_copy`" in don[16] and "`index_copy_`" in don[16]
    assert "self.table" in don[16]
    assert _device("memo", DONATION_GOOD) == []


def test_device_readback_ordering_bad_good():
    out = _device("readback_bad", READBACK_BAD)
    order = [f for f in out if f.rule == "readback-ordering"]
    assert [f.line for f in order] == [14], out
    assert "b_step" in order[0].message
    assert _device("readback_good", READBACK_GOOD) == []


def test_device_findings_carry_residency_in_json():
    out = _device("sync_bad", SYNC_BAD)
    assert out
    for f in out:
        assert f.as_dict()["residency"] == list(f.residency)


def test_device_residency_survives_depth2_chain():
    src = (
        "import torch\n"
        "\n"
        "\n"
        "def verdict_step(x):\n"
        "    return x\n"
        "\n"
        "def stage(c):\n"
        "    return torch.as_tensor(c, device='cuda')\n"
        "\n"
        "def middle(c):\n"
        "    return stage(c)\n"
        "\n"
        "def hot(chunks):\n"
        "    dev = middle(chunks)\n"
        "    out = verdict_step(dev)\n"
        "    host = out.cpu()\n"
        "    return float(dev), host\n")
    out = _check({f"{ENGINE}/chain.py": src}, dd_rule.check)
    sync = [f for f in out if f.rule == "implicit-sync"]
    assert [f.line for f in sync] == [17], out
    assert any("chain.py:8 torch.as_tensor(device=)" in r
               for r in sync[0].residency), sync[0]


def test_device_residency_follows_the_device_of_a_tensor():
    """``device=x.device`` lies where ``x`` lies: a host tensor's device
    puts nothing on the card (the plain versions' idiom)."""
    src = ("import torch\n\n\ndef verdict_step(x):\n    return x\n\n\n"
           "def serve(x):\n    out = verdict_step(x)\n"
           "    z = torch.zeros((4,), device=x.device)\n"
           "    if z.any():\n        pass\n"
           "    w = torch.zeros((4,), device=out.device)\n"
           "    if w.any():\n        pass\n    return out\n")
    out = _check({f"{ENGINE}/dev.py": src}, dd_rule.check)
    assert [(f.rule, f.line) for f in out] == [("implicit-sync", 14)], out


def test_device_walk_follows_lazy_imports_and_casts():
    """A function-local ``from mod import fn`` resolves like a module
    import; ``.to(torch.int32)`` is a cast, not an upload; ``list()`` of
    device values stays device-resident and ``len()`` of it is a host
    length."""
    helper = ("import torch\n\n\ndef verdict_step(x):\n    return x\n")
    src = ("import torch\n\n\ndef serve(x, dev):\n"
           "    from cilium_tpu_torch.engine.helper import verdict_step\n"
           "    i32 = torch.int32\n"
           "    out = verdict_step(x.to(dev))\n"
           "    lanes = list(out.items())\n"
           "    if len(lanes) == 0:\n        return {}\n"
           "    return [float(v.to(i32)) for _, v in lanes]\n")
    out = _check({f"{ENGINE}/helper.py": helper, f"{ENGINE}/lazy.py": src},
                 dd_rule.check)
    assert [(f.rule, f.line) for f in out] == [("implicit-sync", 11)], out


def test_device_disable_honored():
    src = SYNC_BAD.replace(
        "    total = float(out)             # scalar coercion blocks again\n",
        "    # ctlint: disable=implicit-sync  # debug probe, not serving\n"
        "    total = float(out)\n")
    out = _device("sync_bad", src)
    assert not any("`float()`" in f.message for f in out), out
    assert any("`truthiness`" in f.message for f in out)


def test_device_out_of_scope_is_quiet():
    assert _check({"cilium_tpu_torch/tools/sync_bad.py": SYNC_BAD},
                  dd_rule.check) == []


# -- pallas-block-shape: the Hopper launch faces -------------------------------

CU_GOOD = """\
#include "shared.cuh"

__global__ void __launch_bounds__(kThreads) k_small(int* p) {}
__global__ void __launch_bounds__(kThreads) k_big(int* p) {}

extern "C" int run(int* p, size_t smem, cudaStream_t s) {
  k_small<<<1, kThreads, 1024, s>>>(p);
  void (*ks[])(int*) = {k_big};
  for (auto k : ks)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
  k_big<<<dim3(4, 2), kThreads, smem, s>>>(p);
  return 0;
}
"""

CUH = """\
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSmem = 232448;
"""

CU_BAD = """\
constexpr int kOdd = 100;
constexpr int kHuge = 2048;
__global__ void __launch_bounds__(128) k_odd(int* p) {}
__global__ void k_huge(int* p) {}
__global__ void k_smem(int* p) {}

extern "C" int run(int* p, size_t smem, cudaStream_t s) {
  k_odd<<<1, kOdd, 0, s>>>(p);
  k_huge<<<1, kHuge, 0, s>>>(p);
  k_smem<<<1, 256, 65536, s>>>(p);
  k_smem<<<1, 256, smem, s>>>(p);
  cudaFuncSetAttribute(k_odd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       300000);
  return 0;
}
"""


def test_hopper_launch_faces_bad():
    found = hopper_rule.check_launches({f"{ENGINE}/csrc/bad.cu": CU_BAD})
    got = sorted((f.line, f.message) for f in found)
    lines = [ln for ln, _ in got]
    assert lines == [8, 8, 9, 10, 11, 12], got
    msgs = "\n".join(m for _, m in got)
    assert "100 threads per CTA, not a multiple of the 32-thread warp" \
        in msgs
    assert "__launch_bounds__ is 128" in msgs
    assert "2048 threads per CTA, above the 1024" in msgs
    assert "`k_smem` launches with dynamic shared memory `65536`" in msgs
    assert "dynamic shared memory `smem`" in msgs
    assert "opt-in of 300000 bytes exceeds Hopper's 232448" in msgs


def test_hopper_launch_faces_good():
    """Constants through a local header, a block under 48 KB without an
    opt-in, a runtime size behind the kernel-pointer array opt-in."""
    assert hopper_rule.check_launches({
        f"{ENGINE}/csrc/good.cu": CU_GOOD,
        f"{ENGINE}/csrc/shared.cuh": CUH}) == []


def test_hopper_smem_max_above_the_opt_in_limit():
    found = _check({f"{ENGINE}/k.py": "SMEM_MAX = 262144\n"},
                   hopper_rule.check, cuda_sources={})
    assert [(f.line, f.rule) for f in found] == [(1, "pallas-block-shape")]
    assert _check({f"{ENGINE}/k.py": "SMEM_MAX = 232448\n"},
                  hopper_rule.check, cuda_sources={}) == []


PRODUCT_BAD = """\
import torch


def step(states, table, n):
    oh = torch.nn.functional.one_hot(states, n).float()
    return torch.bmm(oh, table)


def count(live, follow):
    hit = (live > 0).float()
    return hit @ follow
"""

PRODUCT_GOOD = """\
import torch


def _check_exact_matmul():
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32")


def step(states, table, n):
    _check_exact_matmul()

    def one_hot(s):
        return (s[..., None] == torch.arange(n)).to(torch.float32)

    return torch.bmm(one_hot(states), table)


def dense(a, b):
    return torch.matmul(a, b)      # no one-hot: not this face's


def host_step(states, table, n):
    import numpy as np

    oh = (states[:, None] == np.arange(n)).astype(np.float32)
    return np.matmul(oh, table)    # numpy's product: not CUDA's
"""


def test_hopper_exact_products():
    found = _check({"pkg/p.py": PRODUCT_BAD}, hopper_rule.check,
                   cuda_sources={})
    assert sorted((f.line, f.message.split(" over")[0]) for f in found) == \
        [(6, "float product `torch.bmm`"), (11, "float product `@`")]
    assert _check({"pkg/p.py": PRODUCT_GOOD}, hopper_rule.check,
                  cuda_sources={}) == []


# -- the reference's JAX spellings: no torch counterpart -------------------------

def _corpus(name):
    with open(os.path.join(REPO, "tests", "analysis_corpus", name)) as fp:
        return fp.read()


JAX_FACES = [
    ("purity", {f"{ENGINE}/kern.py": REF_TESTS.PURITY_BAD},
     purity_rule.check),
    ("shapes", {f"{ENGINE}/kern.py": REF_TESTS.SHAPES_BAD},
     shape_rule.check),
    ("rewrap", {"pkg/m.py": REF_TESTS.REWRAP_BAD}, rec_rule.check),
    ("dynamic", {"pkg/m.py": REF_TESTS.DYNAMIC_BAD}, rec_rule.check),
    ("pallas", {"pkg/k.py": REF_TESTS.PALLAS_BAD}, hopper_rule.check),
] + [(name[:-3], {f"{ENGINE}/{name}": _corpus(name)}, dd_rule.check)
     for name in ("device_donation_bad.py", "device_h2d_bad.py",
                  "device_readback_bad.py")]


@pytest.mark.parametrize("case", JAX_FACES, ids=[c[0] for c in JAX_FACES])
def test_jax_spellings_have_no_torch_counterpart(case):
    """``jax.jit`` / ``donate_argnums`` / ``device_put`` /
    ``pl.BlockSpec`` / ``preferred_element_type``: the port's rules read
    torch and CUDA, so the reference's bad corpora find nothing."""
    _name, sources, checker = case
    assert _check(sources, checker) == []


# -- fixes in the port the lint found -------------------------------------------

def test_host_lanes_is_one_readback_of_every_lane_exactly():
    """``engine/verdict.host_lanes`` replaces the per-lane ``.cpu()`` of
    the replay and engine paths (the reference reads a step's lanes back
    in one ``jax.device_get``): every dtype round-trips exactly."""
    from cilium_tpu_torch.engine.verdict import host_lanes

    out = {"verdict": torch.tensor([1, 5], dtype=torch.int32),
           "allowed": torch.tensor([True, False]),
           "big": torch.tensor([2 ** 40, -1]),
           "u8": torch.tensor([[1, 255], [0, 7]], dtype=torch.uint8),
           "f32": torch.tensor([1.5, float("nan")]),
           "f64": torch.tensor(3.25, dtype=torch.float64)}
    got = host_lanes(out)
    assert list(got) == list(out)
    for k, v in out.items():
        want = v.numpy()
        assert got[k].dtype == want.dtype and got[k].shape == want.shape
        assert np.array_equal(got[k], want, equal_nan=True), k
    assert host_lanes({}) == {}


def test_chunk_readbacks_are_batched_like_the_reference():
    """The per-lane readback of ``CaptureReplay.verdict_chunk`` and
    ``TorchVerdictEngine._run`` (a sync per lane on the card) was a
    difference from the reference's one ``jax.device_get``: the device
    family flags that shape, and the port's modules no longer have it."""
    before = ("import torch\n\n\ndef verdict_step(x):\n    return x\n\n\n"
              "def chunk(x):\n    out = verdict_step(x)\n"
              "    return {k: v.cpu().numpy() for k, v in out.items()}\n")
    found = _device("chunk", before)
    assert [(f.rule, f.line) for f in found] == [("implicit-sync", 10)]
    for mod in ("replay.py", "verdict.py"):
        with open(os.path.join(REPO, ENGINE, mod)) as fp:
            assert "v.cpu().numpy() for k, v in" not in fp.read(), mod


def test_memo_invalidation_reasons_are_the_reference_s():
    """The port's memo had no ``INVALIDATION_REASONS`` registry, so the
    doc-parity rule saw ``session-reset`` and ``bank-swap`` emitted
    nowhere: the tuple is now the reference's."""
    from cilium_tpu.engine import memo as ref_memo
    from cilium_tpu_torch.engine import memo

    assert memo.INVALIDATION_REASONS == ref_memo.INVALIDATION_REASONS


def test_metric_catalog_declares_the_reference_s_families():
    """The port declares its metric families the reference's way
    (``METRICS.describe``), with the reference's HELP text; it adds
    only its own stream-route family."""
    from cilium_tpu.runtime.metrics import METRICS as REF
    from cilium_tpu_torch.runtime import metrics

    assert set(metrics.HELP) - set(REF._help) == {metrics.STREAM_CHUNKS}
    assert set(REF._help) <= set(metrics.HELP)
    for name, text in REF._help.items():
        assert metrics.HELP[name] == text, name


# -- the port's tree ----------------------------------------------------------

class _TreeRun:
    def __init__(self):
        self.findings, self.suppressed = core.run(REPO)
        self.timings = dict(core.LAST_TIMINGS)
        self.index, errors = ProjectIndex.from_tree(REPO)
        assert not errors


@pytest.fixture(scope="module")
def port_tree():
    """One whole run of the port's lint over its tree (``core.run``),
    and the index the structural checks read (the AST cache makes the
    second parse cheap)."""
    return _TreeRun()


def test_port_tree_is_clean(port_tree):
    assert port_tree.findings == [], \
        "\n".join(f.format() for f in port_tree.findings)
    assert port_tree.suppressed >= 35


def test_every_pragma_in_the_port_is_justified(port_tree):
    bare = core._bare_disable_findings(port_tree.index)
    assert bare == []
    n = sum(len(sf.disables) for sf in port_tree.index.files.values())
    assert n >= 35


def test_report_schema_and_timings(port_tree):
    report = json.loads(core.render_json(port_tree.findings,
                                         port_tree.suppressed,
                                         port_tree.timings))
    assert report["schema_version"] == 4
    assert report["findings"] == [] and report["count"] == 0
    assert report["wall_budget_ms"] == 40000
    for key in ("parse", "wall", "shapes", "recompile", "abi",
                "configsurface", "threadsafety", "devicedataflow",
                "pallas_shapes", "purity"):
        assert key in report["timings_ms"], key


def test_report_is_stable_across_runs(tmp_path):
    """The findings part of the report is byte-stable: a cold run (no
    AST cache) and a warm one over a copy of the engine give the same
    report but its timings."""
    import shutil

    shutil.copytree(os.path.join(REPO, ENGINE),
                    tmp_path / "cilium_tpu_torch" / "engine")

    def snapshot():
        found, sup = core.run(str(tmp_path), targets=("cilium_tpu_torch",))
        report = json.loads(core.render_json(found, sup))
        report.pop("timings_ms")
        return report

    cold = snapshot()
    assert (tmp_path / ".ctlint_cache" / "ast.pkl").exists()
    assert snapshot() == cold


def test_lock_graph_is_nontrivial(port_tree):
    from cilium_tpu_torch.analysis import locks as lock_rule

    a = lock_rule._Analyzer(Project(port_tree.index))
    assert len(a.kinds) >= 30
    edges = 0
    for s in a.summaries.values():
        edges += sum(1 for held, _l, _k, _ln in s.acquires if held)
        edges += sum(1 for held, _c, _ln in s.calls if held)
    assert edges >= 10


def test_device_entries_found_in_tree(port_tree):
    names = {getattr(fn, "name", "<lambda>") for _mi, fn
             in purity_rule.find_entries(Project(port_tree.index))}
    for want in ("fused_verdict_step", "verdict_step",
                 "verdict_step_capture", "dense_scan_cuda",
                 "dense_scan_plain", "nfa_finals_cuda", "nfa_finals_plain",
                 "dfa_finals_oblivious_cuda",
                 "dfa_finals_oblivious_plain"):
        assert want in names, want


def test_device_hot_root_discovery_nonvacuous(port_tree):
    labels = {label for _, _, _, label
              in dd_rule.find_hot_roots(project_for(port_tree.index))}
    assert len(labels) >= 10, labels
    for want in ("engine/ring.py::VerdictRing.pack",
                 "engine/session.py::IncrementalSession.serve_ids",
                 "engine/replay.py::CaptureReplay.verdict_chunk",
                 "runtime/serveloop.py::ServeLoop.step",
                 "fqdn/dnsproxy.py::DNSProxy.check_batch",
                 "engine/megakernel.py::fused_verdict_step",
                 "engine/attribution.py::ServedPack.host"):
        assert f"cilium_tpu_torch/{want}" in labels, want


def test_abi_surface_sees_the_port_s_kernels(port_tree):
    from cilium_tpu_torch.analysis import abi as abi_rule

    names = abi_rule.surfaces(port_tree.index)
    assert "native/capture/capture.cpp" not in names
    assert f"{ENGINE}/csrc/dfa_dense.cu" in names
    assert abi_rule.symbol_count(port_tree.index) >= 12
    src = hopper_rule.kernel_sources(port_tree.index)
    assert {f"{ENGINE}/csrc/{n}" for n in (
        "dfa_dense.cu", "dfa_oblivious.cu", "nfa_scan.cu",
        "tile16.cuh", "wgmma.cuh")} <= set(src)


def test_abi_kernel_binding_drift_is_found():
    """``Kernel(name, source, symbol, argtypes, replaces)`` is read as
    the symbol's argtypes: one missing parameter is drift."""
    from cilium_tpu_torch.analysis import abi as abi_rule

    cu = ('extern "C" int ct_nfa_scan(const void* a, int n, '
          'void* stream) { return 0; }\n'
          'extern "C" const char* ct_error_string(int code) '
          '{ return ""; }\n')
    py = ("import ctypes\n_P = ctypes.c_void_p\n_I = ctypes.c_int\n"
          "K = Kernel('k', 'k.cu', 'ct_nfa_scan', [_P] + [_I] * {n}, '')\n"
          "lib = ctypes.CDLL('x')\n"
          "lib.ct_error_string.argtypes = [ctypes.c_int]\n"
          "lib.ct_error_string.restype = ctypes.c_char_p\n")
    good, _ = ProjectIndex.from_sources(
        {f"{ENGINE}/_build.py": py.replace("{n}", "1 + [_P]")})
    assert abi_rule.check_abi(good, cpp_sources={"k.cu": cu},
                              extra_py={}) == []
    bad, _ = ProjectIndex.from_sources(
        {f"{ENGINE}/_build.py": py.replace("{n}", "1")})
    found = abi_rule.check_abi(bad, cpp_sources={"k.cu": cu}, extra_py={})
    assert [f.line for f in found] == [4]
    assert "argtypes declares 2 parameter(s)" in found[0].message


def test_config_surface_unported_knob_is_not_stale():
    """A knob the shared docs name for a reference module with no port
    (``runtime/xla_cache.py``) is not stale documentation for the port;
    any other undocumented-in-code variable still is."""
    from cilium_tpu_torch.analysis import configsurface as cfg_rule

    src = ("import dataclasses\n\n\n@dataclasses.dataclass\n"
           "class Config:\n    enable: bool = False\n")
    docs = {"docs/CONFIG.md": "`enable` CILIUM_TPU_XLA_CACHE "
                              "CILIUM_TPU_GHOST"}
    for pkg in ("cilium_tpu", "cilium_tpu_torch"):
        index, _ = ProjectIndex.from_sources(
            {f"{pkg}/core/config.py": src,
             f"{pkg}/use.py": "def f(c):\n    return c.enable\n"})
        stale = sorted(f.message.split("`")[1]
                       for f in cfg_rule.check_config(index, docs=docs))
        want = ["CILIUM_TPU_GHOST"] + (
            [] if pkg == "cilium_tpu_torch" else ["CILIUM_TPU_XLA_CACHE"])
        assert stale == sorted(want), (pkg, stale)


def test_ast_cache_roundtrip(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text("import os\n")
    cold, _ = core.run(str(tmp_path), targets=("pkg",))
    cache_file = tmp_path / ".ctlint_cache" / "ast.pkl"
    assert cache_file.exists()
    warm, _ = core.run(str(tmp_path), targets=("pkg",))
    assert [f.as_dict() for f in warm] == [f.as_dict() for f in cold]
    cache_file.write_bytes(b"not a pickle")
    broken, _ = core.run(str(tmp_path), targets=("pkg",))
    assert [f.as_dict() for f in broken] == [f.as_dict() for f in cold]
    assert [f.rule for f in cold] == ["unused-import"]


def test_changed_only_filters_findings(tmp_path, capsys):
    from cilium_tpu_torch.cli import main

    def git(*args):
        subprocess.run(["git", "-C", str(tmp_path), *args], check=True,
                       capture_output=True)

    git("init")
    git("config", "user.email", "t@t")
    git("config", "user.name", "t")
    (tmp_path / "old.py").write_text(
        "def f():\n    try:\n        g()\n    except:\n        pass\n")
    git("add", "old.py")
    git("commit", "-m", "x")
    (tmp_path / "new.py").write_text("import os\n\n\ndef g():\n"
                                     "    return 1\n")
    rc = main(["lint", "--root", str(tmp_path), "old.py", "new.py",
               "--changed-only"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "new.py" in out and "unused-import" in out
    assert "old.py" not in out


def test_wall_budget_gate(tmp_path, capsys):
    from cilium_tpu_torch.analysis import run_cli

    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text("X = 1\n")
    argv = ["pkg", "--root", str(tmp_path)]
    assert run_cli(argv + ["--wall-budget-ms", "600000"]) == 0
    capsys.readouterr()
    assert run_cli(argv + ["--wall-budget-ms", "0"]) == 1
    assert "exceeds budget" in capsys.readouterr().err
