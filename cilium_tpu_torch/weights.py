"""Stage a compiled policy's arrays as the port's device tensors — the
port's "weights carried across".

``arrays_from_reference`` takes a ``CompiledPolicy.arrays`` dict plus
the ``plan_for_engine`` extras, built by either package (their arrays
are byte-equal), and returns tensors on ``device``. uint32 arrays
(accept words, ruleset and group masks, the kafka api-key masks) are
re-read as int32 bit patterns: torch's uint32 lacks the bitwise and
comparison operators the resolve needs, and the bits are what matter.

``lb_arrays_from_reference`` stages a load balancer's packed service
table (``PackedLB``) for ``loadbalancer.lb_lookup``. There the uint32
columns are addresses that the lookup orders and hashes, so they are
widened to int64, not re-read as bit patterns.

``store_from_reference`` is the cluster state carried across: a
kvstore's contents (``list_prefix("")`` of either package's store) as
a port ``KVStore``, so a port identity allocator or clustermesh watcher
started over it sees the reference's identities and announcements.

``resources_from_reference`` is the same for the apiserver: a
reference ``ResourceStore``'s objects (by plural) and its current
resourceVersion as a port ``ResourceStore``, so port informers started
over it list the reference's objects at the reference's versions.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from cilium_tpu_torch.core.device import DeviceLike, resolve_device


def stage_array(v, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(v))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    # ctlint: disable=hot-loop-h2d  # staging: one upload per array when an automaton or a policy is first staged; the callers cache what it returns (DNSProxy._get_banked)
    return torch.from_numpy(a.copy()).to(device)


def arrays_from_reference(arrays: Dict[str, np.ndarray],
                          device: DeviceLike = None
                          ) -> Dict[str, torch.Tensor]:
    """{name: numpy array} → {name: tensor on ``device``} (default
    ``cuda``; raises without it)."""
    dev = resolve_device(device)
    return {k: stage_array(v, dev) for k, v in arrays.items()}


#: the ``PackedLB`` fields ``lb_lookup`` takes, in its argument order
LB_FIELDS = ("svc_ip", "svc_l4", "svc_affinity", "tables", "backend_ip",
             "backend_port")


def lb_arrays_from_reference(packed, device: DeviceLike = None
                             ) -> Tuple[torch.Tensor, ...]:
    """A ``PackedLB`` (either package's) → the six tensors ``lb_lookup``
    takes (:data:`LB_FIELDS`), on ``device`` (default ``cuda``; raises
    without it). The uint32 columns (``svc_ip``, ``svc_l4``,
    ``backend_ip``) become int64 holding the unsigned value: as int32,
    the empty manager's ``0xFFFFFFFF`` sentinel and every address at or
    above 128.0.0.0 would be negative and sort first."""
    dev = resolve_device(device)
    out = []
    for f in LB_FIELDS:
        a = np.asarray(getattr(packed, f))
        a = a.astype(np.int64) if a.dtype == np.uint32 else a.copy()
        out.append(torch.from_numpy(a).to(dev))
    return tuple(out)


def store_from_reference(items: Mapping[str, str]):
    """{key: value} (a store's ``list_prefix("")``) → a port
    ``KVStore`` holding the same keys and values, set in sorted key
    order. Leases do not carry: every key is set without one."""
    from cilium_tpu_torch.kvstore import KVStore

    store = KVStore()
    for key in sorted(items):
        store.set(key, items[key])
    return store


def resources_from_reference(objects: Mapping[str, list],
                             resource_version):
    """{plural: [object, ...]} (each object with its
    ``metadata.resourceVersion``, as a store's ``list(plural)`` gives
    them) and the store's current resourceVersion → a port
    ``ResourceStore`` holding the same objects at the same versions.

    The event history does not carry: the new store's ring starts
    empty and compacted at ``resource_version``, so a watch from that
    version goes live and one from an older version is told 410 Gone
    (and relists), as against a compacted apiserver."""
    import json

    from cilium_tpu_torch.k8s.apiserver import (
        RESOURCES,
        ResourceStore,
        _key,
    )

    store = ResourceStore()
    rv = int(resource_version)
    uid = 0
    for plural, items in objects.items():
        _, namespaced = RESOURCES[plural]
        for obj in items:
            obj = json.loads(json.dumps(obj))
            meta = obj["metadata"]
            obj_rv = int(meta["resourceVersion"])
            if obj_rv > rv:
                raise ValueError(
                    f"{plural} {meta.get('name')!r}: resourceVersion "
                    f"{obj_rv} is past the store's {rv}")
            ns = meta.get("namespace", "") if namespaced else ""
            store._objs[plural][_key(ns, meta["name"])] = obj
            tail = str(meta.get("uid", "")).rpartition("-")[2]
            if tail.isdigit():
                uid = max(uid, int(tail))
    store._rv = rv
    store._compacted_rv = rv
    store._uid = uid
    return store
