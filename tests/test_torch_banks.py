"""The port's content-addressed bank plane against the JAX package's, on
the CPU: ``policy/compiler/bankplan.py``, ``compilequeue.py``,
``runtime/checkpoint.py`` and ``runtime/fingerprints.py``.

Each case runs the same inputs through both packages and compares what
comes out: the partitions and bank keys (byte-equal: both packages hash
the same plain tuples), the compiled banks, the registry's reuse and
quarantine ledger (cover, then fail-closed, then TTL recovery), the
compile queue's priority, retry and deadline behaviour, the artifact
cache's LRU bound, protected keys and corrupt entries, and the
fingerprint store's O(Δ) walk. Mirrors ``tests/test_banks.py``,
``tests/test_compilequeue.py`` and ``tests/test_checkpoint.py``.

Clocks: the registry's TTL runs on an injected list clock and the
queue's deadline on each package's ``VirtualClock``, so no case waits
on wall time for a verdict on ordering.
"""

import dataclasses
import importlib
import os
import pickle
import threading
import time
import types

import numpy as np
import pytest


def _pkg(root):
    ns = types.SimpleNamespace(root=root)
    for attr, mod in (("bankplan", "policy.compiler.bankplan"),
                      ("compilequeue", "policy.compiler.compilequeue"),
                      ("dfa", "policy.compiler.dfa"),
                      ("checkpoint", "runtime.checkpoint"),
                      ("fingerprints", "runtime.fingerprints"),
                      ("faults", "runtime.faults"),
                      ("simclock", "runtime.simclock"),
                      ("metrics", "runtime.metrics"),
                      ("config", "core.config")):
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")
PKGS = (JAX, PORT)


def _cfg(pkg, bank_size=4):
    cfg = pkg.config.EngineConfig()
    cfg.bank_size = bank_size
    return cfg


def _inject(pkg, point, times=1):
    f = pkg.faults
    return f.inject(f.FaultPlan([f.FaultRule(point, times=times)]))


def _plain(x):
    """Dataclasses (each package has its own ``FieldBankStats``) as
    tuples, recursively, so both packages' results compare."""
    if dataclasses.is_dataclass(x):
        return tuple(_plain(v) for v in dataclasses.astuple(x))
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    return x


def _banks(banked):
    """A compiled BankedDFA as plain, comparable data."""
    return ([(b.trans.tolist(), b.accept.tolist(), b.byteclass.tolist(),
              int(b.start), int(b.n_patterns)) for b in banked.banks],
            banked.pattern_bank.tolist(), banked.pattern_lane.tolist(),
            tuple(banked.patterns))


def _matches(pkg, banked, strings):
    """(row, pattern) accept set via the CPU reference scan."""
    L = max(32, max(len(s) for s in strings))
    data = np.zeros((len(strings), L), dtype=np.uint8)
    lens = np.zeros(len(strings), dtype=np.int32)
    for i, s in enumerate(strings):
        data[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        lens[i] = len(s)
    out = set()
    for bi, bank in enumerate(banked.banks):
        w = pkg.dfa.match_bank_numpy(bank, data, lens)
        for p_i in range(banked.n_patterns):
            if int(banked.pattern_bank[p_i]) != bi:
                continue
            lane = int(banked.pattern_lane[p_i])
            for row in range(len(strings)):
                if w[row, lane // 32] >> (lane % 32) & 1:
                    out.add((row, banked.patterns[p_i]))
    return out


# ------------------------------------------------------------ partition
def _pattern_sets():
    rng = np.random.default_rng(7)
    words = ["api", "svc", "v1", "v2", "users", "orders", "img", "x"]
    out = []
    for n in (1, 9, 60, 240):
        pats = set()
        while len(pats) < n:
            k = int(rng.integers(1, 4))
            pats.add("/" + "/".join(rng.choice(words, k)) +
                     f"{int(rng.integers(0, 999))}/.*")
        out.append(sorted(pats))
    return out


@pytest.mark.parametrize("target", [1, 4, 8, 128])
@pytest.mark.parametrize("which", range(4))
def test_partition_and_bank_keys_equal_reference(which, target):
    pats = _pattern_sets()[which]
    opts = (8192, 64, False)
    got = [PORT.bankplan.partition_patterns(pats, target),
           JAX.bankplan.partition_patterns(list(reversed(pats)), target)]
    assert got[0] == got[1]
    assert sorted(p for g in got[0] for p in g) == sorted(set(pats))
    keys = [[pkg.bankplan.bank_key(g, opts) for g in got[0]]
            for pkg in PKGS]
    assert keys[0] == keys[1]
    ns_keys = [[pkg.bankplan.bank_key(g, opts, namespace="t1")
                for g in got[0]] for pkg in PKGS]
    assert ns_keys[0] == ns_keys[1] and not set(ns_keys[0]) & set(keys[0])
    assert [PORT.bankplan.registry_shard_of(k, 8) for k in keys[0]] == \
        [JAX.bankplan.registry_shard_of(k, 8) for k in keys[0]]
    assert [PORT.compilequeue.work_key(k) for k in keys[0]] == \
        [JAX.compilequeue.work_key(k) for k in keys[0]]


def test_partition_add_then_delete_and_local_perturbation():
    base = [f"/svc{i}/.*" for i in range(120)]
    opts = (8192, 64, False)
    for pkg in PKGS:
        bp = pkg.bankplan
        orig = bp.partition_patterns(base, 8)
        for extra in (["/zzz/.*"], ["/aaa/.*", "/mmm/.*"],
                      [f"/churn{i}/x" for i in range(9)]):
            grown = bp.partition_patterns(base + extra, 8)
            shrunk = bp.partition_patterns(
                [p for p in base + extra if p not in set(extra)], 8)
            assert shrunk == orig and grown != orig
            assert [bp.bank_key(g, opts) for g in shrunk] == \
                [bp.bank_key(g, opts) for g in orig]
        for extra in ("/added/a.*", "/added/b.*", "/zz/tail.*"):
            changed = set(bp.partition_patterns(base + [extra], 8)) ^ \
                set(orig)
            assert len(changed) <= 4
    # the tenant namer splits by namespace first, in both packages
    namer = (lambda p: "a" if "1" in p else "b")
    assert PORT.bankplan.partition_patterns(base, 8, namer=namer) == \
        JAX.bankplan.partition_patterns(base, 8, namer=namer)


def test_positional_mutation_equals_reference(monkeypatch):
    base = [f"/svc{i}/.*" for i in range(30)]
    monkeypatch.setenv("CILIUM_TPU_DST_MUTATION", "positional-banks")
    assert PORT.faults.mutation_active("positional-banks")
    assert PORT.bankplan.partition_patterns(base, 8) == \
        JAX.bankplan.partition_patterns(base, 8)


# ------------------------------------------------------------- registry
@pytest.mark.parametrize("case", ["plain", "ci", "overflow"])
def test_registry_compiles_reference_banks(case):
    pats = [f"/api/v{i}/.*" for i in range(20)] + ["GET", "PUT"]
    if case == "overflow":
        # a state cap small enough that groups split by halving
        pats = [f"/a{i}/[a-z]{{3}}/b{i}.*" for i in range(12)]
    runs = []
    for pkg in PKGS:
        cfg = _cfg(pkg)
        if case == "overflow":
            cfg.max_dfa_states = 64
        reg = pkg.bankplan.BankRegistry()
        banked, st = reg.compile_field("path", pats, cfg,
                                       case_insensitive=(case == "ci"))
        runs.append((_banks(banked), st, reg.compiles,
                     reg.bank_compiles))
    assert _plain(runs[0]) == _plain(runs[1])
    # and the registry's banks match exactly what the positional
    # compiler accepts
    greedy = PORT.dfa.compile_patterns(
        pats, bank_size=4, max_states=64 if case == "overflow" else 8192,
        case_insensitive=(case == "ci"))
    reg = PORT.bankplan.BankRegistry()
    cfg = _cfg(PORT)
    if case == "overflow":
        cfg.max_dfa_states = 64
    banked, _ = reg.compile_field("path", pats, cfg,
                                  case_insensitive=(case == "ci"))
    probes = [b"/api/v3/x", b"/API/V15/yy", b"GET", b"/nope",
              b"/a3/abc/b3zz"]
    assert _matches(PORT, banked, probes) == \
        _matches(PORT, greedy, probes)


def test_registry_reuse_ledger_equals_reference():
    pats = [f"/api/v{i}/.*" for i in range(24)]
    runs = []
    for pkg in PKGS:
        cfg = _cfg(pkg)
        reg = pkg.bankplan.BankRegistry()
        _, s1 = reg.compile_field("path", pats, cfg)
        c0 = reg.compiles
        _, s2 = reg.compile_field("path", pats, cfg)
        assert reg.compiles == c0 and s2.reused == len(s2.bank_keys)
        _, s3 = reg.compile_field("path", pats + ["/new/.*"], cfg)
        assert 1 <= reg.compiles - c0 <= 2
        assert set(s3.bank_keys) & set(s1.bank_keys)
        st = reg.status()
        runs.append((s1, s2, s3, {k: st[k] for k in (
            "groups", "compiles", "bank_compiles", "reuses",
            "quarantined", "evictions")}))
    assert _plain(runs[0]) == _plain(runs[1])


def test_quarantine_cover_fail_closed_then_ttl_recovery():
    """A forced compile failure on a changed bank: the old patterns
    serve from their last-good cover, the new one fails closed; inside
    the TTL nothing recompiles; past it the retry clears the
    quarantine. The same ledger in both packages."""
    base = [f"/api/v{i}/.*" for i in range(16)]
    probes = [b"/api/v3/x", b"/api/v12/y", b"/new/x"]
    runs = []
    for pkg in PKGS:
        clock = [0.0]
        cfg = _cfg(pkg)
        reg = pkg.bankplan.BankRegistry(quarantine_ttl_s=10.0,
                                        clock=lambda: clock[0])
        banked0, _ = reg.compile_field("path", base, cfg)
        with _inject(pkg, "loader.bank_compile"):
            banked1, s1 = reg.compile_field("path", base + ["/new/.*"],
                                            cfg)
        before = _matches(pkg, banked0, probes)
        after = _matches(pkg, banked1, probes)
        assert len(s1.quarantined) == 1
        assert {(r, p) for r, p in after if p != "/new/.*"} == before
        assert not any(p == "/new/.*" for _, p in after)
        c0 = reg.compiles
        _, s2 = reg.compile_field("path", base + ["/new/.*"], cfg)
        assert s2.quarantined and reg.compiles == c0
        clock[0] = 11.0
        assert reg.expired_quarantines() != ()
        banked3, s3 = reg.compile_field("path", base + ["/new/.*"], cfg)
        assert not s3.quarantined and reg.compiles == c0 + 1
        assert _matches(pkg, banked3, [b"/new/x"]) == {(0, "/new/.*")}
        runs.append((_banks(banked1), s1, s2, s3, reg.quarantine_events,
                     reg.quarantined_serves))
    assert _plain(runs[0]) == _plain(runs[1])


def test_quarantine_ttl_escalation_equals_reference():
    pats = ["/a/.*", "/b/.*"]
    runs = []
    for pkg in PKGS:
        clock = [1000.0]
        reg = pkg.bankplan.BankRegistry(quarantine_ttl_s=10.0,
                                        clock=lambda: clock[0])
        ttls = []
        with _inject(pkg, "loader.bank_compile", times=99):
            for _ in range(3):
                reg.compile_field("path", pats, _cfg(pkg))
                (q,) = reg._quarantine.values()
                ttls.append(q.until - clock[0])
                clock[0] = q.until + 1.0
        assert ttls[0] == pytest.approx(10.0)
        assert ttls[1] > 15.0 and ttls[2] > ttls[1] * 1.5
        runs.append(ttls)
    assert _plain(runs[0]) == _plain(runs[1])


def test_registry_dead_bank_when_nothing_covers():
    runs = []
    for pkg in PKGS:
        reg = pkg.bankplan.BankRegistry()
        with _inject(pkg, "loader.bank_compile", times=99):
            banked, st = reg.compile_field("path", ["/x/.*", "/y/.*"],
                                           _cfg(pkg))
        assert st.bank_keys == () and len(st.quarantined) == len(
            pkg.bankplan.partition_patterns(["/x/.*", "/y/.*"], 4))
        assert _matches(pkg, banked, [b"/x/1", b"/y/2"]) == set()
        runs.append((_banks(banked), st))
    assert _plain(runs[0]) == _plain(runs[1])


# --------------------------------------------------------- compile queue
def test_queue_priority_serving_pops_before_background():
    for pkg in PKGS:
        cq = pkg.compilequeue
        order = []
        gate = threading.Event()
        q = cq.CompileQueue(workers=1, deadline_s=5.0)
        try:
            q.submit("hold", lambda: (gate.wait(5), order.append("hold")))
            for i in range(3):
                q.submit(f"bg{i}", (lambda i=i: order.append(f"bg{i}")),
                         prio=cq.PRIO_BACKGROUND)
            ts = q.submit("urgent", lambda: order.append("serving"),
                          prio=cq.PRIO_SERVING)
            gate.set()
            assert q.wait(ts, timeout=10.0)
            assert order.index("serving") == 1, order
        finally:
            q.close()


def test_queue_dedup_retry_and_immediate_failure():
    for pkg in PKGS:
        cq = pkg.compilequeue
        q = cq.CompileQueue(workers=1, deadline_s=5.0,
                            backoff_base_s=0.01, max_retries=2)
        try:
            # worker death: re-queued with backoff, succeeds on retry
            with _inject(pkg, "compile.worker", times=1):
                t = q.submit("k", lambda: "ok")
                assert q.wait(t, timeout=10.0) and t.result == "ok"
            assert q.worker_deaths == 1 and q.retries == 1
            # retry exhaustion fails the task
            with _inject(pkg, "compile.worker", times=10):
                t = q.submit("doomed", lambda: "never")
                assert q.wait(t, timeout=10.0)
                assert isinstance(t.error, cq.WorkerDied)
            # a compile exception is deterministic: no retry
            calls = []

            def bad():
                calls.append(1)
                raise ValueError("bad pattern")

            retries = q.retries
            t = q.submit("bad", bad)
            assert q.wait(t, timeout=10.0)
            assert isinstance(t.error, ValueError) and calls == [1]
            assert q.retries == retries
            # one key in flight: a second submit coalesces onto it
            gate = threading.Event()
            t1 = q.submit("hot", lambda: (gate.wait(5), "c")[1])
            t2 = q.submit("hot", lambda: "other")
            assert t1 is t2
            gate.set()
            assert q.wait(t1, timeout=10.0) and t1.result == "c"
        finally:
            q.close()


def test_queue_deadline_lapses_at_the_exact_virtual_tick():
    for pkg in PKGS:
        clock = pkg.simclock.VirtualClock()
        with pkg.simclock.use(clock):
            q = pkg.compilequeue.CompileQueue(workers=1, deadline_s=10.0)
            release = threading.Event()
            t = q.submit("slow", lambda: (release.wait(5.0), "late")[1])
            got = []
            th = threading.Thread(target=lambda: got.append(q.wait(t)))
            th.start()
            for _ in range(400):        # the waiter must park first
                if clock._heap:
                    break
                time.sleep(0.005)
            clock.advance_to(t.deadline)
            th.join(timeout=5.0)
            assert got == [False] and q.deadline_lapses == 1
            release.set()
            for _ in range(400):
                if t.done:
                    break
                time.sleep(0.005)
            assert t.done and t.result == "late" and q.late_results == 1
            q.close()


def test_registry_queue_path_equals_serial_and_reference():
    pats = [f"/api/v{i}/.*" for i in range(24)]
    runs = []
    for pkg in PKGS:
        cfg = _cfg(pkg)
        serial = pkg.bankplan.BankRegistry()
        queued = pkg.bankplan.BankRegistry(
            queue=pkg.compilequeue.CompileQueue(workers=3,
                                                deadline_s=60.0))
        try:
            b1, s1 = serial.compile_field("path", pats, cfg)
            b2, s2 = queued.compile_field("path", pats, cfg)
            assert _banks(b1) == _banks(b2)
            assert s1.bank_keys == s2.bank_keys and not s2.quarantined
            _, s3 = queued.compile_field("path", pats, cfg)
            assert s3.rebuilt == () and s3.reused == len(s3.bank_keys)
            runs.append((_banks(b2), s2.bank_keys))
        finally:
            queued.close()
    assert _plain(runs[0]) == _plain(runs[1])


def test_registry_worker_death_quarantines_with_cover():
    pats = [f"/svc/p{i}/.*" for i in range(8)]
    runs = []
    for pkg in PKGS:
        cfg = _cfg(pkg)
        q = pkg.compilequeue.CompileQueue(workers=1, max_retries=1,
                                          backoff_base_s=0.01,
                                          deadline_s=60.0)
        reg = pkg.bankplan.BankRegistry(queue=q)
        try:
            reg.compile_field("path", pats, cfg)
            grown = pats + ["/svc/new/.*"]
            with _inject(pkg, "compile.worker", times=10):
                banked, s1 = reg.compile_field("path", grown, cfg)
            assert s1.quarantined and len(banked.patterns) == len(grown)
            for qq in reg._quarantine.values():
                qq.until = 0.0
            _, s2 = reg.compile_field("path", grown, cfg)
            assert not s2.quarantined and not reg._quarantine
            runs.append((_banks(banked), s1.quarantined))
        finally:
            reg.close()
    assert _plain(runs[0]) == _plain(runs[1])


# ------------------------------------------------- artifact cache / store
def test_artifact_cache_lru_bound_and_protection(tmp_path):
    payload = {"blob": list(range(4000))}
    for pkg in PKGS:
        m = pkg.metrics
        d = tmp_path / pkg.root
        cache = pkg.checkpoint.ArtifactCache(str(d / "lru"),
                                             max_bytes=70 << 10)
        before = m.METRICS.get(m.ARTIFACT_CACHE_EVICTIONS)
        for i in range(8):
            cache.put(f"k{i}", payload)
        assert cache.total_bytes() <= 70 << 10 and cache.evictions > 0
        assert m.METRICS.get(m.ARTIFACT_CACHE_EVICTIONS) - before == \
            cache.evictions
        assert cache.get("k7") is not None and cache.get("k0") is None
        prot = pkg.checkpoint.ArtifactCache(str(d / "prot"),
                                            max_bytes=70 << 10)
        prot.put("serving", payload)
        prot.set_protected({"serving"})
        for i in range(12):
            prot.put(f"churn{i}", payload)
        assert prot.get("serving") == payload and prot.evictions > 0
        free = pkg.checkpoint.ArtifactCache(str(d / "free"), max_bytes=0)
        for i in range(6):
            free.put(f"k{i}", payload)
        assert free.evictions == 0
    # same names, same bytes: both packages pickle the plain payload
    # identically
    assert sorted(os.listdir(tmp_path / "cilium_tpu" / "lru")) == \
        sorted(os.listdir(tmp_path / "cilium_tpu_torch" / "lru"))


def test_artifact_cache_corrupt_entries_and_disabled_cache(tmp_path):
    for pkg in PKGS:
        m = pkg.metrics
        d = tmp_path / pkg.root
        cache = pkg.checkpoint.ArtifactCache(str(d))
        cache.put("k", {"compiled": [1, 2, 3]})
        with open(cache._path("k"), "wb") as f:
            f.write(b"\x80\x05garbage not a pickle")
        before = m.METRICS.get(m.ARTIFACT_CACHE_CORRUPT)
        assert cache.get("k") is None
        assert not os.path.exists(cache._path("k"))
        assert m.METRICS.get(m.ARTIFACT_CACHE_CORRUPT) == before + 1
        assert cache.get("k") is None
        assert m.METRICS.get(m.ARTIFACT_CACHE_CORRUPT) == before + 1
        cache.put("t", list(range(1000)))
        blob = open(cache._path("t"), "rb").read()
        with open(cache._path("t"), "wb") as f:
            f.write(blob[: len(blob) // 2])
        assert cache.get("t") is None
        off = pkg.checkpoint.ArtifactCache(str(d / "off"), enable=False)
        off.put("k", "v")
        assert off.get("k") is None and not os.path.exists(str(d / "off"))


def test_bank_artifacts_fetch_verify_and_degrade(tmp_path):
    pats = [f"/art/{i}/.*" for i in range(6)]
    for pkg in PKGS:
        cp, bp = pkg.checkpoint, pkg.bankplan
        cfg = _cfg(pkg)
        store = cp.BankArtifactStore(cp.ArtifactCache(
            str(tmp_path / pkg.root)))
        producer = bp.BankRegistry(artifacts=store)
        b0, _ = producer.compile_field("path", pats, cfg)
        consumer = bp.BankRegistry(artifacts=store)
        b1, s = consumer.compile_field("path", pats, cfg)
        assert consumer.compiles == 0
        assert set(s.fetched) == set(s.bank_keys)
        assert _banks(b0) == _banks(b1)
        # a lost fetch recompiles
        lost = bp.BankRegistry(artifacts=store)
        with _inject(pkg, "artifact.fetch", times=99):
            _, s2 = lost.compile_field("path", pats, cfg)
        assert not s2.fetched and lost.compiles > 0
        # flipped payload bytes: the checksum catches them
        for name in os.listdir(str(tmp_path / pkg.root)):
            if name.startswith("bankart-"):
                p = str(tmp_path / pkg.root / name)
                with open(p, "rb") as f:
                    entry = pickle.load(f)
                payload = bytearray(entry["payload"])
                payload[len(payload) // 2] ^= 0xFF
                entry["payload"] = bytes(payload)
                with open(p, "wb") as f:
                    pickle.dump(entry, f)
        bad = bp.BankRegistry(artifacts=store)
        _, s3 = bad.compile_field("path", pats, cfg)
        assert not s3.fetched and bad.compiles > 0 and not s3.quarantined


# ---------------------------------------------------------- fingerprints
def test_fingerprint_store_is_o_delta():
    calls = []

    def bundle_of(ms):
        calls.append(ms)
        return (repr(ms), {})

    for pkg in PKGS:
        calls.clear()
        store = pkg.fingerprints.FingerprintStore()
        objs = {ep: ("state", ep) for ep in range(40)}
        first = store.bundle(objs, bundle_of)
        assert len(calls) == 40
        calls.clear()
        again = store.bundle(dict(objs), bundle_of)
        assert again == first and calls == []
        objs[3] = ("state", 3, "moved")
        store.bundle(objs, bundle_of)
        assert calls == [objs[3]]
        st = store.status()
        assert st["entries"] == 40
    assert PORT.fingerprints.FingerprintStore().status().keys() == \
        JAX.fingerprints.FingerprintStore().status().keys()


def test_ruleset_fingerprint_equals_reference_on_plain_tuples():
    parts = [("policy-v11", "g", ((1, "a"), (2, "b"))),
             ("bank-v1", ("/a/.*",), (8192, 64, False)), (), (None,)]
    for p in parts:
        assert PORT.checkpoint.ruleset_fingerprint(*p) == \
            JAX.checkpoint.ruleset_fingerprint(*p)
