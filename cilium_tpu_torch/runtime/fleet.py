"""Fleet-scale policy-plane churn driver (the reference's
``runtime/fleet.py``, through the port's ``Loader`` on the card).

The cluster-mesh scale deployment — 10k identities × 5k
CiliumNetworkPolicy, streaming verdicts — as a churn STORM through the
live serving plane: ``identities`` endpoint identities grouped into
service classes (production meshes run thousands of pods over hundreds
of distinct policy shapes), ``cnps`` CNP-shaped L7 rules spread across
the classes, and a sustained add/delete update stream driven through
one Loader + one live capture-replay session while every update is
checked for staleness against the serving engine (and a sampled CPU
oracle).

What the lane gates:

* **zero stale / zero ERROR verdicts** — the session is bit-equal to
  the serving engine after every committed update, and the sampled
  oracle agrees;
* **O(Δ) compile** — bank compiles per update stay within 1.1× the
  27-bank churn lane's ratio (:data:`BASELINE_COMPILES_PER_UPDATE`), so
  two orders of magnitude more policy does NOT mean more work per
  change;
* **update→enforcement p99** ≤ 2× the 27-bank lane's p99, which the
  caller supplies (``base_p99_ms``) from a run on the same device: a
  time measured elsewhere is no denominator for this one;
* **bounded memory** — peak RSS under the declared bound.

    python -m cilium_tpu_torch.runtime.fleet --no-p99-gate

prints one provenance-stamped line (``--out`` appends it to a file).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

#: identities per service class at full scale: 10k identities over
#: 200 distinct resolved policies (the distillery dedup makes the
#: mapstate table scale with CLASSES; identity count scales only the
#: enforcement table)
DEFAULT_CLASS_SIZE = 50

#: declared peak-RSS bound for the full-scale lane, MiB
DEFAULT_MAX_RSS_MB = 8192

#: O(Δ) gate: compiles/update must stay within this factor of the
#: committed 27-bank churn ratio
ODELTA_FACTOR = 1.1

#: p99 gate: update→enforcement p99 must stay within this factor of
#: the committed 27-bank churn p99
P99_FACTOR = 2.0


#: bank compiles per update of the 27-bank churn lane (the JAX
#: package's ``BENCH_CHURN_r06.jsonl``, every line). A count, not a
#: time: it does not depend on the device, so the O(Δ) gate keeps it
BASELINE_COMPILES_PER_UPDATE = 0.929


class P99GateError(AssertionError):
    """An update→enforcement p99 blew ``P99_FACTOR`` × the 27-bank
    lane's p99: the storm's here, the cross-cluster leg's in
    ``tools/bench_protocols``. Raised after every other gate held;
    ``result`` is the run's full result dict."""

    def __init__(self, msg: str, result: Dict):
        super().__init__(msg)
        self.result = result


def _peak_rss_mb() -> float:
    """This process's peak resident set, MiB: the high-water mark of its
    own address space (``VmHWM``), which an exec starts afresh. The
    reference reads ``ru_maxrss``, which Linux carries across exec, so a
    spawned child would report its parent's peak; that stays the
    fallback where ``/proc`` is missing."""
    try:
        with open("/proc/self/status") as fp:
            for line in fp:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1024.0     # KiB
    except OSError:
        pass
    import resource

    # ru_maxrss is KiB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


class FleetWorld:
    """The resolved world: ``n_classes`` distinct policies shared by
    ``identities`` endpoint identities, ``cnps`` HTTP rules + one DNS
    rule per class, a live replay session over a sampled corpus."""

    def __init__(self, identities: int, cnps: int, cache_dir: str,
                 seed: int = 8, class_size: int = DEFAULT_CLASS_SIZE,
                 workers: int = 4, device=None):
        import numpy as np

        from cilium_tpu_torch.core.config import Config
        from cilium_tpu_torch.core.identity import IdentityAllocator
        from cilium_tpu_torch.core.labels import LabelSet
        from cilium_tpu_torch.runtime.loader import Loader

        self.rng = np.random.default_rng(seed)
        self.n_classes = max(1, min(identities,
                                    (identities + class_size - 1)
                                    // class_size))
        self.identities = identities
        self.cnps = cnps
        self.alloc = IdentityAllocator()
        self.web = self.alloc.allocate(LabelSet.from_dict(
            {"app": "web"}))
        #: class → list of (kind, pattern): the DESIRED rule state;
        #: CNP j lands in class j % n_classes
        self.rules_of: Dict[int, List[Tuple[str, str]]] = {
            c: [] for c in range(self.n_classes)}
        for j in range(cnps):
            c = j % self.n_classes
            self.rules_of[c].append(
                ("http", f"/cls{c}/cnp{j}/.*"))
        for c in range(self.n_classes):
            self.rules_of[c].append(("dns", f"cls{c}.corp.io"))
        #: fleet identity ids: synthetic, disjoint from the allocator
        #: range; identity i belongs to class i % n_classes
        self.ids = [100_000 + i for i in range(identities)]
        #: class → resolved MapState, REUSED across updates for
        #: unchanged classes (what makes the loader's fingerprint
        #: store O(Δ) — and what production resolvers achieve with
        #: their own per-endpoint caches)
        self._class_ms = {c: self._resolve_class(c)
                          for c in range(self.n_classes)}
        cfg = Config()
        cfg.enable_tpu_offload = True
        cfg.loader.cache_dir = cache_dir
        cfg.compile.workers = workers
        self.cfg = cfg
        self.loader = Loader(cfg, device=device)

    # -- policy -----------------------------------------------------------
    def _resolve_class(self, c: int):
        """One class's MapState via the real repository/resolver path
        (a fresh object per call — the immutability contract of the
        fingerprint store)."""
        from cilium_tpu_torch.core.flow import Protocol
        from cilium_tpu_torch.core.identity import IdentityAllocator
        from cilium_tpu_torch.core.labels import LabelSet
        from cilium_tpu_torch.policy.api import (
            EndpointSelector,
            IngressRule,
            PortProtocol,
            PortRule,
            Rule,
        )
        from cilium_tpu_torch.policy.api.l7 import (
            L7Rules,
            PortRuleDNS,
            PortRuleHTTP,
        )
        from cilium_tpu_torch.policy.mapstate import PolicyResolver
        from cilium_tpu_torch.policy.repository import Repository
        from cilium_tpu_torch.policy.selectorcache import SelectorCache

        http = tuple(PortRuleHTTP(path=p, method="GET")
                     for k, p in self.rules_of[c] if k == "http")
        dns = tuple(PortRuleDNS(match_name=p)
                    for k, p in self.rules_of[c] if k == "dns")
        repo = Repository()
        repo.add([Rule(
            endpoint_selector=EndpointSelector.from_labels(
                app=f"cls{c}"),
            ingress=(IngressRule(
                from_endpoints=(
                    EndpointSelector.from_labels(app="web"),),
                to_ports=(
                    PortRule(ports=(PortProtocol(80, Protocol.TCP),),
                             rules=L7Rules(http=http)),
                    PortRule(ports=(PortProtocol(53, Protocol.UDP),),
                             rules=L7Rules(dns=dns)),)),),
        )], sanitize=False)
        # a private allocator whose "web" maps to the SAME identity id
        # as the world's (first allocation is deterministic), so every
        # class's entries key on one peer id
        alloc = IdentityAllocator()
        web = alloc.allocate(LabelSet.from_dict({"app": "web"}))
        assert web == self.web
        cls_id = alloc.allocate(LabelSet.from_dict({"app": f"cls{c}"}))
        resolver = PolicyResolver(repo, SelectorCache(alloc))
        return resolver.resolve(alloc.lookup(cls_id))

    def per_identity(self) -> Dict[int, object]:
        return {ep: self._class_ms[i % self.n_classes]
                for i, ep in enumerate(self.ids)}

    # -- traffic ----------------------------------------------------------
    def _http(self, ep: int, path: str):
        from cilium_tpu_torch.core.flow import (
            Flow,
            HTTPInfo,
            L7Type,
            Protocol,
            TrafficDirection,
        )

        return Flow(src_identity=self.web, dst_identity=ep,
                    dport=80, protocol=Protocol.TCP,
                    direction=TrafficDirection.INGRESS, l7=L7Type.HTTP,
                    http=HTTPInfo(method="GET", path=path))

    def _dns(self, ep: int, qname: str):
        from cilium_tpu_torch.core.flow import (
            DNSInfo,
            Flow,
            L7Type,
            Protocol,
            TrafficDirection,
        )

        return Flow(src_identity=self.web, dst_identity=ep,
                    dport=53, protocol=Protocol.UDP,
                    direction=TrafficDirection.INGRESS, l7=L7Type.DNS,
                    dns=DNSInfo(query=qname))

    def corpus(self, sample_ids: int = 48, repeat: int = 20):
        """A FIXED serving corpus over identities sampled across
        classes: allowed paths, never-allowed probes, DNS — repeated
        to capture-replay dedup shape."""
        flows = []
        step = max(1, len(self.ids) // max(1, sample_ids))
        for i in range(0, len(self.ids), step):
            ep = self.ids[i]
            c = i % self.n_classes
            pats = [p for k, p in self.rules_of[c]
                    if k == "http"][:3]
            for p in pats:
                flows.append(self._http(ep, p.replace("/.*", "/x")))
            flows.append(self._http(ep, "/never/allowed"))
            flows.append(self._dns(ep, f"cls{c}.corp.io"))
            flows.append(self._dns(ep, "evil.example"))
        return flows * repeat, len(flows)


def run(identities: int, cnps: int, updates: int, cache_dir: str,
        seed: int = 8, workers: int = 4,
        max_rss_mb: float = DEFAULT_MAX_RSS_MB,
        gate_p99: bool = True, base_p99_ms: Optional[float] = None,
        device=None, progress=print) -> Dict:
    """Drive the storm; returns the result dict (also asserted —
    a gate failure raises AssertionError; the p99 gate's, checked
    last, :class:`P99GateError` with the result). ``gate_p99`` needs
    ``base_p99_ms``, the 27-bank churn lane's update→enforcement p99 on
    the same device (``tools/churn_lane.run``)."""
    import numpy as np

    from cilium_tpu_torch.core.flow import Verdict
    from cilium_tpu_torch.engine.replay import CaptureReplay
    from cilium_tpu_torch.ingest.columnar import flows_to_columns

    if gate_p99 and base_p99_ms is None:
        raise ValueError("the p99 gate needs base_p99_ms: the 27-bank "
                         "churn lane's p99 on the same device")
    t_start = time.perf_counter()
    world = FleetWorld(identities, cnps, cache_dir, seed=seed,
                       workers=workers, device=device)
    loader = world.loader
    base_ratio = BASELINE_COMPILES_PER_UPDATE

    t0 = time.perf_counter()
    loader.regenerate(world.per_identity(), revision=1)
    cold_s = time.perf_counter() - t0
    banks_t0 = sum(len(k) for k in loader._bank_plan.values())
    compiles_t0 = loader.bank_registry.compiles
    progress(f"[fleet] t0: {identities} ids x {cnps} cnps "
             f"({world.n_classes} classes, {banks_t0} banks) "
             f"cold build {cold_s:.1f}s")

    flows, distinct = world.corpus()
    cols = flows_to_columns(flows)
    replay = CaptureReplay(loader.engine, cols.l7, cols.offsets,
                           cols.blob, world.cfg.engine, gen=cols.gen,
                           loader=loader)
    replay.stage_rows(cols.rec, cols.l7)
    replay.stage_unique()

    def session_verdicts():
        out = replay.verdict_chunk(cols.rec, cols.l7)
        # one bulk readback, then host ints — not one sync per row
        return [int(v) for v in np.asarray(out["verdict"])]

    def engine_verdicts(fl):
        return [int(v) for v in
                np.asarray(loader.engine.verdict_flows(fl)["verdict"])]

    base = session_verdicts()
    assert int(Verdict.ERROR) not in base, "ERROR at t0"
    assert base == engine_verdicts(flows), "session stale at t0"

    rng = world.rng
    added: List[Tuple[int, str]] = []
    update_ms: List[float] = []
    schedule = []
    changes = 0
    for step in range(updates):
        c = int(rng.integers(world.n_classes))
        if added and (step % 3 == 2):          # delete a churned rule
            j = int(rng.integers(len(added)))
            c, pat = added.pop(j)
            world.rules_of[c].remove(("http", pat))
            probe = None
        else:                                  # CNP add
            pat = f"/cls{c}/churn{step}/.*"
            world.rules_of[c].append(("http", pat))
            added.append((c, pat))
            probe = world._http(world.ids[c], pat.replace("/.*", "/x"))
        # only the touched class re-resolves — every other identity
        # keeps its MapState object, so the loader fingerprints O(Δ)
        world._class_ms[c] = world._resolve_class(c)
        changes += 1
        schedule.append((step, c, pat))
        t1 = time.perf_counter()
        loader.regenerate(world.per_identity(), revision=2 + step)
        if probe is not None:
            got = engine_verdicts([probe])
            assert got == [5], f"new rule not enforced: {got}"
        update_ms.append((time.perf_counter() - t1) * 1e3)
        got = session_verdicts()
        assert int(Verdict.ERROR) not in got, f"ERROR at step {step}"
        assert got == engine_verdicts(flows), f"stale at step {step}"
        if step % 10 == 0 or step == updates - 1:
            sample = flows[:distinct]
            oracle = loader.fallback_engine
            want = [int(v) for v in
                    oracle.verdict_flows(sample)["verdict"]]
            assert got[:distinct] == want, f"oracle mismatch @ {step}"
        if (step + 1) % 10 == 0:
            progress(f"[fleet] {step + 1}/{updates} updates, "
                     f"p50 so far "
                     f"{sorted(update_ms)[len(update_ms) // 2]:.0f}ms")

    # -- gates ------------------------------------------------------------
    fleet_compiles = loader.bank_registry.compiles - compiles_t0
    per_update = fleet_compiles / max(1, changes)
    ratio_bound = ODELTA_FACTOR * base_ratio
    assert per_update <= ratio_bound, (
        f"O(Δ) broke at fleet scale: {per_update:.3f} compiles/update "
        f"> {ratio_bound:.3f} (= {ODELTA_FACTOR} x the 27-bank "
        f"{base_ratio:.3f})")

    m = replay.memo
    hit_ratio = (m.hits / max(1, m.hits + m.misses)) if m else 0.0

    p99 = sorted(update_ms)[min(len(update_ms) - 1,
                                int(0.99 * len(update_ms)))]
    p50 = sorted(update_ms)[len(update_ms) // 2]
    p99_bound = (P99_FACTOR * base_p99_ms if base_p99_ms is not None
                 else None)

    rss_mb = _peak_rss_mb()
    assert rss_mb <= max_rss_mb, (
        f"peak RSS {rss_mb:.0f}MiB over the declared bound "
        f"{max_rss_mb}MiB — the plane is not serving in bounded "
        f"memory")

    st = loader.bank_status()
    result = {
        "metric": "churn_fleet_update_p99_ms",
        "value": round(p99, 3),
        "unit": "ms update->enforcement p99",
        "lane": "churn-fleet",
        "identities": identities,
        "cnps": cnps,
        "classes": world.n_classes,
        "updates": updates,
        "banks_t0": banks_t0,
        "cold_build_s": round(cold_s, 3),
        "bank_compiles": fleet_compiles,
        "compiles_per_update": round(per_update, 3),
        "odelta_bound": round(ratio_bound, 3),
        "baseline_ratio": base_ratio,
        "p50_ms": round(p50, 3),
        "p99_bound_ms": (round(p99_bound, 3) if p99_bound is not None
                         else None),
        "baseline_p99_ms": base_p99_ms,
        "p99_gated": bool(gate_p99),
        "memo_hit_ratio": round(hit_ratio, 6),
        "rss_peak_mb": round(rss_mb, 1),
        "rss_bound_mb": max_rss_mb,
        "registry_bytes": st.get("bytes"),
        "registry_evictions": st.get("evictions"),
        "artifact_hits": st.get("artifact_hits"),
        "compile_queue": st.get("queue"),
        "fp_store": st.get("fp_store"),
        "wall_s": round(time.perf_counter() - t_start, 1),
        "schedule_digest": hashlib.sha256(
            json.dumps(schedule, sort_keys=True).encode()
        ).hexdigest()[:16],
    }
    loader.close()
    if gate_p99 and p99 > p99_bound:
        raise P99GateError(
            f"update->enforcement p99 {p99:.0f}ms blew the bound "
            f"{p99_bound:.0f}ms (= {P99_FACTOR} x the 27-bank "
            f"{base_p99_ms:.0f}ms) at {identities} ids x {cnps} cnps",
            result)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    import tempfile

    ap = argparse.ArgumentParser(
        description="fleet-scale policy-plane churn lane "
                    "(10k identities x 5k CNP)")
    ap.add_argument("--identities", type=int, default=10000)
    ap.add_argument("--cnps", type=int, default=5000)
    ap.add_argument("--updates", type=int, default=56)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--max-rss-mb", type=float,
                    default=DEFAULT_MAX_RSS_MB)
    ap.add_argument("--base-p99-ms", type=float, default=None,
                    help="the 27-bank churn lane's update->enforcement "
                         "p99 on this device (the p99 gate's "
                         "denominator)")
    ap.add_argument("--no-p99-gate", action="store_true",
                    help="skip the p99 gate (smoke scales, or no "
                         "27-bank number from this device)")
    ap.add_argument("--device", default=None,
                    help="the loader's device (default cuda)")
    ap.add_argument("--out", default="",
                    help="append the stamped line to this file too")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="ct_fleet_") as cache:
        result = run(args.identities, args.cnps, args.updates, cache,
                     seed=args.seed, workers=args.workers,
                     max_rss_mb=args.max_rss_mb,
                     gate_p99=not args.no_p99_gate,
                     base_p99_ms=args.base_p99_ms, device=args.device)
    from cilium_tpu_torch.runtime.provenance import stamp

    os.environ["CILIUM_TPU_DST_SEED"] = str(args.seed)
    os.environ["CILIUM_TPU_DST_DIGEST"] = result["schedule_digest"]
    line = stamp(dict(result))
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as fp:
            fp.write(json.dumps(line) + "\n")
    print(f"[fleet] OK: {args.identities} ids x {args.cnps} cnps, "
          f"{args.updates} updates — p99 {result['value']:.0f}ms "
          f"(bound {result['p99_bound_ms']}), "
          f"{result['compiles_per_update']} compiles/update "
          f"(bound {result['odelta_bound']}), "
          f"RSS {result['rss_peak_mb']:.0f}MiB, "
          f"memo hit {result['memo_hit_ratio']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
