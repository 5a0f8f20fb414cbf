"""Environment provenance for bench lines (the reference's
``runtime/provenance.py``, on the card).

Every lane's result line carries a **provenance fingerprint**: the
host platform, the card's name and power limit as ``nvidia-smi`` reports
them, the device kind and count torch sees, the torch and CUDA versions,
a host-to-device round-trip probe and the git revision that produced the
number. A card may be capped below its maximum power and then runs
slower under load, so a number without its card and limit cannot be
compared with another.

Everything here is best-effort: a fingerprint must never break the
one-JSON-line bench contract, so a missing card or absent git checkout
degrades fields to ``None`` rather than raising.
"""

from __future__ import annotations

import os
import platform
import subprocess
import sys
import time
from typing import Dict, Optional

#: version of the stamped bench-line schema (the reference's)
BENCH_SCHEMA = 1


def git_revision(root: Optional[str] = None) -> Dict[str, object]:
    """``{"git_rev": short-hash or None, "git_dirty": bool or None}``
    for the checkout containing ``root`` (default: this file's repo)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    try:
        rev = subprocess.run(
            ["git", "-C", root, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10)
        if rev.returncode != 0:
            return {"git_rev": None, "git_dirty": None}
        dirty = subprocess.run(
            ["git", "-C", root, "status", "--porcelain"],
            capture_output=True, text=True, timeout=10)
        return {"git_rev": rev.stdout.strip(),
                "git_dirty": (bool(dirty.stdout.strip())
                              if dirty.returncode == 0 else None)}
    except (OSError, subprocess.TimeoutExpired):
        return {"git_rev": None, "git_dirty": None}


def card_line() -> Optional[str]:
    """The first card's ``name, power.limit`` as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints it; None without ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def rtt_probe(n: int = 7) -> Dict[str, Optional[float]]:
    """(p50, max) ms of a tiny round trip: a pinned host tensor copied
    to ``cuda``, then a synchronise. Nones without a card."""
    try:
        import torch

        if not torch.cuda.is_available():
            return {"rtt_p50_ms": None, "rtt_max_ms": None}
        xs = torch.zeros(16, dtype=torch.int32).pin_memory()
        xs.to("cuda", non_blocking=True)
        torch.cuda.synchronize()                    # connection warm
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            xs.to("cuda", non_blocking=True)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return {"rtt_p50_ms": round(ts[len(ts) // 2] * 1e3, 3),
                "rtt_max_ms": round(ts[-1] * 1e3, 3)}
    except Exception:  # noqa: BLE001 — probe is best-effort by contract
        return {"rtt_p50_ms": None, "rtt_max_ms": None}


def fingerprint(rtt: bool = True,
                root: Optional[str] = None) -> Dict[str, object]:
    """The full provenance fingerprint. ``rtt=False`` skips the round
    trip probe."""
    fp: Dict[str, object] = {
        "schema": BENCH_SCHEMA,
        # ctlint: disable=wall-clock  # provenance stamps record when the REAL world produced this artifact
        "captured_unix": int(time.time()),
        "host_platform": platform.platform(),
        "python": platform.python_version(),
        "argv0": os.path.basename(sys.argv[0]) if sys.argv else None,
        "torch_version": None,
        "cuda_version": None,
        "backend": None,
        "device_kind": None,
        "device_count": None,
        "card": None,
    }
    fp.update(git_revision(root))
    try:
        import torch

        fp["torch_version"] = torch.__version__
        fp["cuda_version"] = torch.version.cuda
        if torch.cuda.is_available():
            fp["backend"] = "cuda"
            fp["device_kind"] = torch.cuda.get_device_name(0)
            fp["device_count"] = torch.cuda.device_count()
            fp["card"] = card_line()
        else:
            fp["backend"] = "cpu"
    except Exception as e:  # noqa: BLE001 — no backend is a valid
        # environment; the fingerprint says so instead of raising
        fp["torch_error"] = str(e)[:120]
    if rtt and fp["backend"] == "cuda":
        fp.update(rtt_probe())
    else:
        fp.update({"rtt_p50_ms": None, "rtt_max_ms": None})
    return fp


def dst_stamp() -> Optional[Dict[str, object]]:
    """The deterministic-simulation rider: when a lane runs under a
    seeded schedule (``CILIUM_TPU_DST_SEED`` set), its line carries the
    seed, the schedule digest and any armed mutation."""
    seed = os.environ.get("CILIUM_TPU_DST_SEED")
    if seed is None:
        return None
    out: Dict[str, object] = {}
    try:
        out["dst_seed"] = int(seed)
    except ValueError:
        out["dst_seed"] = seed
    digest = os.environ.get("CILIUM_TPU_DST_DIGEST")
    if digest:
        out["schedule_digest"] = digest
    mutation = os.environ.get("CILIUM_TPU_DST_MUTATION")
    if mutation:
        out["mutation"] = mutation
    return out


def stamp(obj: Dict, rtt: bool = True) -> Dict:
    """Stamp ``obj`` (a bench line dict) in place with the schema tag,
    the fingerprint and ``host_id`` (``parallel/multihost.host_id``;
    a caller's own ``host_id`` wins); returns ``obj``. Never raises."""
    try:
        obj["bench_schema"] = BENCH_SCHEMA
        obj["provenance"] = fingerprint(rtt=rtt)
        from cilium_tpu_torch.parallel.multihost import host_id

        obj.setdefault("host_id", host_id())
        dst = dst_stamp()
        if dst is not None:
            obj["dst"] = dst
    except Exception as e:  # noqa: BLE001 — the bench line must still
        # print; the stamp records its own failure instead of raising
        obj.setdefault("provenance", None)
        obj["provenance_error"] = str(e)[:120]
    return obj
