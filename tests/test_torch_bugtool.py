"""The port's bugtool (``cilium_tpu_torch/bugtool.py``) against the JAX
package's, on the CPU.

Both packages' agents, built from one configuration (the port's with
``device="cpu"``), take the same endpoints and policy; each package's
``collect`` writes its bundle, and the bundles are compared section by
section:

* the same file set and ``MANIFEST.json`` file list;
* an equal ``engine`` section (the staged tensors' names, shapes and
  numpy dtype names, the bytes they hold, the revision) with the gate
  on, once the reference's arrays are read as the port stages them
  (``weights.stage_array``: a uint32 array as its int32 bit pattern; a
  0-d array as one element), and ``{"staged": ...}`` alike with it
  off;
* equal ``endpoints``, ``identities`` and ``config`` sections, and the
  ``status`` section but for its stamps;
* the ``environment`` section names torch and the card where the
  reference names JAX (the port's one deviation);
* the service's ``bugtool`` op answers the bundle's path, or ``no agent
  attached``, as the reference's does; without ``out`` the port writes
  under ``TMPDIR``.

Tolerance: exact.
"""

import importlib
import json
import os
import tarfile
import tempfile

import pytest

from test_torch_agent import (
    FIXTURES,
    PKGS,
    PORT,
    differing,
    make_agent,
    short_dir,
)


def bugtool_of(P):
    return importlib.import_module(f"{P.root}.bugtool")


def as_staged(engine):
    """The reference's engine section as the port stages the same
    arrays: uint32 as int32 bit patterns, a 0-d array as one element
    (the bytes are the same)."""
    if not engine.get("staged"):
        return engine
    tensors = {k: {"dtype": "int32" if t["dtype"] == "uint32"
                   else t["dtype"], "shape": t["shape"] or [1]}
               for k, t in engine["tensors"].items()}
    return dict(engine, tensors=tensors)


def _bundle(P, tmp, offload):
    agent = make_agent(P, tmp, offload=offload, start=False)
    try:
        agent.endpoint_add(1, {"app": "service"}, ipv4="10.0.0.1")
        agent.endpoint_add(2, {"app": "frontend"}, ipv4="10.0.0.2")
        agent.policy_add_file(os.path.join(FIXTURES, "l7", "http-api.yaml"))
        root = bugtool_of(P).collect(agent, os.path.join(tmp, "bt"),
                                     archive=False)
    finally:
        agent.stop()
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name)) as f:
            out[name] = (json.load(f) if name.endswith(".json")
                         else f.read())
    return out


@pytest.mark.parametrize("offload", [True, False])
def test_bundle_equal_reference(offload):
    """The bundle of the same agent state in both packages: the file
    set, the engine section (gate on: every staged tensor), endpoints,
    identities and config equal; status equal but for its stamps."""
    got = {}
    for P in PKGS:
        with short_dir() as tmp:
            got[P.root] = _bundle(P, tmp, offload)
    ref, port = got["cilium_tpu"], got["cilium_tpu_torch"]
    assert sorted(ref) == sorted(port)
    assert ref["MANIFEST.json"]["files"] == port["MANIFEST.json"]["files"]
    ref["engine.json"] = as_staged(ref["engine.json"])
    for name in ("engine.json", "endpoints.json", "identities.json"):
        assert not differing(ref[name], port[name]), (
            name, differing(ref[name], port[name])[:10])
    for cfg in (ref["config.json"], port["config.json"]):
        cfg["loader"].pop("cache_dir")
    assert not differing(ref["config.json"], port["config.json"])
    strip = ("controllers", "backend")
    assert ({k: v for k, v in ref["status.json"].items() if k not in strip}
            == {k: v for k, v in port["status.json"].items()
                if k not in strip})
    eng = port["engine.json"]
    if offload:
        assert eng["staged"] is True and eng["tensors"]
        assert eng["hbm_bytes"] > 0
        assert not any(t["dtype"].startswith("torch.")
                       for t in eng["tensors"].values())
    assert "torch" in port["environment.json"]
    assert "jax" in ref["environment.json"]
    assert "cilium_tpu_" in port["metrics.txt"]


def test_environment_names_torch_and_the_card(monkeypatch):
    """The ``environment`` section's ``torch`` entry: torch's version,
    and with a CUDA device its name, capability and the device count
    (the device functions stubbed here, on the CPU)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=0: (9, 0))
    info = bugtool_of(PORT)._torch_info()
    assert info == {"version": torch.__version__,
                    "cuda_build": torch.version.cuda, "cuda": True,
                    "device_count": 1,
                    "devices": [{"name": "NVIDIA H100 80GB HBM3",
                                 "capability": [9, 0]}]}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bugtool_of(PORT)._torch_info()["cuda"] is False


def test_engine_summary_bytes_are_the_tensors_bytes():
    """``hbm_bytes`` is the staged tensors' ``numel * element_size``
    (``size`` is a method on a torch tensor), equal to the reference's
    ``size * itemsize`` over the same policy."""
    got = []
    for P in PKGS:
        with short_dir() as tmp:
            agent = make_agent(P, tmp, offload=True, start=False)
            try:
                agent.endpoint_add(1, {"app": "service"})
                agent.policy_add_file(os.path.join(FIXTURES, "l7",
                                                   "http-api.yaml"))
                summary = bugtool_of(P)._engine_summary(agent)
                if not P.jax:
                    arrays = agent.loader.engine._arrays
                    assert summary["hbm_bytes"] == sum(
                        v.numel() * v.element_size()
                        for v in arrays.values())
                got.append(summary)
            finally:
                agent.stop()
    assert not differing(as_staged(got[0]), got[1])
    assert got[1]["hbm_bytes"] == got[0]["hbm_bytes"] > 0


def test_service_bugtool_op_equal_reference(monkeypatch):
    """The service's ``bugtool`` op: with an agent, the bundle's path
    (an archive, or a directory with ``archive`` false); without one,
    ``no agent attached``; with no ``out``, the port's bundle lands
    under ``TMPDIR``."""
    res = []
    for P in PKGS:
        with short_dir() as tmp:
            agent = make_agent(P, tmp, start=False)
            try:
                svc = P.service.VerdictService(
                    agent.loader, os.path.join(tmp, "v.sock"), agent=agent)
                bare = P.service.VerdictService(
                    agent.loader, os.path.join(tmp, "w.sock"))
                try:
                    arch = svc.handle({"op": "bugtool",
                                       "out": os.path.join(tmp, "a")})
                    plain = svc.handle({"op": "bugtool",
                                        "out": os.path.join(tmp, "d"),
                                        "archive": False})
                    none = bare.handle({"op": "bugtool", "out": tmp})
                    if not P.jax:
                        monkeypatch.setattr(tempfile, "tempdir",
                                            os.path.join(tmp, "t"))
                        os.makedirs(os.path.join(tmp, "t"))
                        default = svc.handle({"op": "bugtool"})
                        assert default["path"].startswith(
                            os.path.join(tmp, "t", "cilium-tpu-bugtool-"))
                finally:
                    svc.bridge.batcher.close()
                    bare.bridge.batcher.close()
                with tarfile.open(arch["path"]) as tar:
                    names = sorted(os.path.basename(n.name)
                                   for n in tar.getmembers() if n.isfile())
                res.append({"archive": names,
                            "dir": sorted(os.listdir(plain["path"])),
                            "none": none})
            finally:
                agent.stop()
    assert res[0] == res[1]
    assert res[1]["none"] == {"error": "no agent attached"}
    assert "MANIFEST.json" in res[1]["dir"]
