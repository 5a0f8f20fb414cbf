"""bugtool: one-shot diagnostics bundle (the reference's ``bugtool.py``).

Reference: ``bugtool/`` — ``cilium-bugtool`` collects agent status,
config, BPF map dumps, metrics and logs into an archive for support.
Ours dumps the same strata of the port's stack: agent status, config,
the staged engine's summary (the "BPF map dump" analog: the staged
tensors' shapes and numpy dtype names, the bytes they hold, the
revision), the metrics exposition, the torch and CUDA environment, the
endpoints and the identities — one file a section plus a
``MANIFEST.json``, optionally tarred.

Where the port differs from the reference:

* the ``environment`` section's ``torch`` entry (torch's version, the
  CUDA device's name and capability, the device count) takes the place
  of the reference's ``jax`` entry;
* the ``engine`` section lists the tensors as staged
  (``weights.stage_array``): a uint32 array of the policy reads
  ``int32`` (its bit pattern) and a 0-d array one element; the bytes
  are the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import shutil
import sys
import tarfile
import time
from typing import Dict

from cilium_tpu_torch.runtime.metrics import METRICS


def _dtype_name(dtype) -> str:
    """A staged tensor's dtype by its numpy name (``int32``, not
    ``torch.int32``), so the section reads as the reference's."""
    return str(dtype).removeprefix("torch.")


def _engine_summary(agent) -> Dict:
    eng = agent.loader.engine
    if eng is None:
        return {"staged": False}
    arrays = getattr(eng, "_arrays", {})
    return {
        "staged": True,
        "revision": agent.loader.revision,
        "tensors": {
            k: {"shape": list(v.shape), "dtype": _dtype_name(v.dtype)}
            for k, v in sorted(arrays.items())
        },
        # ``size`` is a method on a tensor: bytes are numel x element size
        "hbm_bytes": int(sum(v.numel() * v.element_size()
                             for v in arrays.values())),
    }


def _torch_info() -> Dict:
    """torch's version, and the CUDA device's name, capability and
    count (no device: ``cuda`` False)."""
    try:
        import torch

        info = {"version": torch.__version__,
                "cuda_build": torch.version.cuda,
                "cuda": torch.cuda.is_available()}
        if info["cuda"]:
            info["device_count"] = torch.cuda.device_count()
            info["devices"] = [
                {"name": torch.cuda.get_device_name(i),
                 "capability": list(torch.cuda.get_device_capability(i))}
                for i in range(info["device_count"])]
        return info
    except Exception as e:  # noqa: BLE001 — a section, not a failure
        return {"error": str(e)}


def collect(agent, out_dir: str, archive: bool = True) -> str:
    """Write the bundle; returns the archive (or directory) path."""
    ts = time.strftime("%Y%m%d-%H%M%S")
    root = os.path.join(out_dir, f"cilium-tpu-bugtool-{ts}")
    os.makedirs(root, exist_ok=True)
    sections = {
        "status": agent.status(),
        "config": dataclasses.asdict(agent.config),
        "engine": _engine_summary(agent),
        "endpoints": [dict(ep.to_json(), state=str(ep.state))
                      for ep in agent.endpoint_manager.endpoints()],
        "identities": {
            str(nid): list(lbls.format())
            for nid, lbls in sorted(
                (n, agent.allocator.lookup(n))
                for n in agent.allocator.identities())
            if lbls is not None
        },
        "metrics": METRICS.expose(),
        "environment": {
            "python": sys.version,
            "platform": platform.platform(),
            "argv": sys.argv,
            "torch": _torch_info(),
        },
    }
    names = []
    for name, payload in sections.items():
        fname = f"{name}.json" if not isinstance(payload, str) else f"{name}.txt"
        with open(os.path.join(root, fname), "w") as f:
            if isinstance(payload, str):
                f.write(payload)
            else:
                json.dump(payload, f, indent=2, default=str)
        names.append(fname)
    with open(os.path.join(root, "MANIFEST.json"), "w") as f:
        json.dump({"created": ts, "files": sorted(names)}, f, indent=2)
    if not archive:
        return root
    tar_path = root + ".tar.gz"
    with tarfile.open(tar_path, "w:gz") as tar:
        tar.add(root, arcname=os.path.basename(root))
    shutil.rmtree(root)  # only the archive survives
    return tar_path
