"""The port's chunked binary verdict stream against the JAX package's,
on the CPU.

Each package's ``StreamClient`` streams the same capture images to its
own ``VerdictService`` (the reference gate on, ``JAX_PLATFORMS=cpu``;
the port's loader ``device="cpu"``): the verdict frames must be equal,
and equal to the port's engine. Covered: the frame and capture-image
codecs, the http, kafka and fqdn scenarios, per-sequence failure (a bad
image, a chunk that meets what the port does not serve yet — a
stand-in for the agent plane, queue 1's Q13 — answered with that error and no
breaker trip, and a chunk whose KD launch fails), v3 GENERIC chunks
(protocol-frontend records) equal to the reference's, empty chunks and many in flight, credits (the client
halts at zero and the window survives reconnect-with-resume), the
gate-off oracle backend, concurrent streams on private sessions and
through the serve loop's ring, a hot swap mid-stream with zero stale
verdicts, and the route a chunk takes.
"""

import socket
import struct
import threading

import pytest

from test_torch_loader import _World
from test_torch_service import (
    UNPORTED_PORT,
    JAX,
    PKGS,
    PORT,
    unported_on,
    failing_kd,
    make_loader,
    scenario,
    scenario_loaders,  # noqa: F401 (module-scoped fixture)
    served,
)

S = PORT.stream
CHUNKS = "cilium_tpu_stream_chunks_total"


def _route(route):
    return PORT.metrics.METRICS.get(CHUNKS, {"route": route})


def _breaker_counts():
    m = PORT.metrics.METRICS
    return (m.get("cilium_tpu_breaker_trips_total"),
            m.get("cilium_tpu_breaker_fallback_verdicts_total"))


def _stream(pkg, svc, images, **kw):
    """All images in flight, then every result in sequence order."""
    c = pkg.stream.StreamClient(svc.socket_path, timeout=60.0, **kw)
    try:
        seqs = [c.send_image(im) for im in images]
        out = []
        for s in seqs:
            try:
                out.append([int(v) for v in c.result(s)])
            except RuntimeError as e:
                out.append(str(e))
        c.finish()
        return out
    finally:
        c.close()


def _plain(ld, flows):
    return [int(v) for v in ld.engine.verdict_flows(flows)["verdict"]]


# ================================================================ codecs
def test_frames_round_trip_and_match_the_reference():
    a, b = socket.socketpair()
    try:
        for seq, kind, payload in ((0, S.KIND_CHUNK, b"abc"),
                                   (7, S.KIND_END, b""),
                                   (2**32 - 1, S.KIND_CREDIT,
                                    struct.pack("<I", 1))):
            S.send_frame(a, seq, kind, payload)
            assert S.recv_frame(b) == (seq, kind, payload)
        a.sendall(S.FRAME_HEADER.pack(S.MAX_FRAME + 1, 0, 0))
        with pytest.raises(ConnectionError, match="too large"):
            S.recv_frame(b)
    finally:
        a.close()
        b.close()
    for name in ("FRAME_HEADER", "KIND_CHUNK", "KIND_END", "KIND_ERROR",
                 "KIND_CHUNK_TRACED", "KIND_CREDIT", "MAX_FRAME",
                 "CHUNK_MAX", "PIPELINE_DEPTH"):
        want, got = getattr(JAX.stream, name), getattr(S, name)
        assert (got.format if name == "FRAME_HEADER" else got) == \
            (want.format if name == "FRAME_HEADER" else want), name


@pytest.mark.parametrize("name", ["http", "kafka", "fqdn"])
def test_capture_images_equal_the_reference(name):
    images = {}
    for pkg in PKGS:
        _, sc = scenario(pkg, name, 20, 128)
        images[pkg.root] = pkg.binary.capture_to_bytes(sc.flows)
    image = images["cilium_tpu_torch"]
    assert image == images["cilium_tpu"]
    rec, l7, offsets, blob, gen = PORT.binary.capture_from_bytes(image)
    assert len(rec) == 128 and gen is None
    assert PORT.binary.sections_to_bytes(rec, l7, offsets, blob) == image
    for bad in (b"not a capture", image[:-3], image + b"x"):
        with pytest.raises(PORT.binary.CaptureError):
            PORT.binary.capture_from_bytes(bad)


# ====================================================== stream verdicts
@pytest.mark.parametrize("name", ["http", "kafka", "fqdn"])
def test_stream_equals_the_reference(scenario_loaders, tmp_path,  # noqa
                                     name):
    got = {}
    session0 = _route("session")
    for pkg in PKGS:
        ld, sc = scenario_loaders[name][pkg.root]
        images = [pkg.binary.capture_to_bytes(sc.flows[i:i + 80])
                  for i in range(0, 240, 80)]
        with served(pkg, ld, tmp_path / f"{pkg.root}.sock") as svc:
            got[pkg.root] = _stream(pkg, svc, images)
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    ld, sc = scenario_loaders[name]["cilium_tpu_torch"]
    assert sum(got["cilium_tpu_torch"], []) == _plain(ld, sc.flows[:240])
    assert _route("session") - session0 == 3


def test_generic_chunk_fails_only_its_seq(scenario_loaders, tmp_path,  # noqa
                                          monkeypatch):
    """A chunk that meets what the port does not serve yet (a stand-in
    for the agent plane, :func:`unported_on`): its sequence fails with a
    Q13 message, its neighbours answer, and the breaker never hears of
    it."""
    import dataclasses

    ld, sc = scenario_loaders["http"]["cilium_tpu_torch"]
    good = PORT.binary.capture_to_bytes(sc.flows[:50])
    unported = PORT.binary.capture_to_bytes(
        [dataclasses.replace(f, dport=UNPORTED_PORT)
         for f in sc.flows[:20]])
    unported_on(monkeypatch)
    before = _breaker_counts()
    with served(PORT, ld, tmp_path / "g.sock") as svc:
        out = _stream(PORT, svc, [good, unported, good, unported])
        assert svc.verdictor.breaker.state == 0
    want = _plain(ld, sc.flows[:50])
    assert out[0] == out[2] == want
    for err in (out[1], out[3]):
        assert "NotImplementedError" in err and "Q13" in err
    assert _breaker_counts() == before


def test_generic_chunks_equal_the_reference(tmp_path):
    """v3 images of the protocols scenario (cassandra, memcache and
    r2d2 records) streamed to each package's service over its own
    loader: the verdict frames are equal, and equal to the port's
    engine; every chunk takes the session route."""
    got = {}
    session0 = _route("session")
    for pkg in PKGS:
        pi, sc = scenario(pkg, "protocols", 24, 240)
        ld = make_loader(pkg, tmp_path / f"{pkg.root}-cache")
        try:
            ld.regenerate(pi, revision=1)
            images = [pkg.binary.capture_to_bytes(sc.flows[i:i + 80])
                      for i in range(0, 240, 80)]
            assert pkg.binary.capture_from_bytes(images[0])[4] is not None
            with served(pkg, ld, tmp_path / f"{pkg.root}.sock") as svc:
                got[pkg.root] = _stream(pkg, svc, images)
            if not pkg.jax:
                assert sum(got[pkg.root], []) == _plain(ld, sc.flows[:240])
        finally:
            ld.close()
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    assert len(set(sum(got["cilium_tpu"], []))) > 1
    assert _route("session") - session0 == 3


def test_kernel_failure_fails_only_its_seq(scenario_loaders,  # noqa
                                           tmp_path, monkeypatch):
    """A chunk whose KD launch fails on the session route fails its
    sequence with the kernel's error: no trip, no oracle verdict; the
    next chunk, with the kernel whole again, answers."""
    ld, sc = scenario_loaders["http"]["cilium_tpu_torch"]
    image = PORT.binary.capture_to_bytes(sc.flows[:50])
    before, fallback0 = _breaker_counts(), _route("fallback")
    with served(PORT, ld, tmp_path / "k.sock") as svc:
        c = S.StreamClient(svc.socket_path, timeout=60.0)
        try:
            failed = failing_kd(monkeypatch)
            with pytest.raises(RuntimeError,
                               match="KernelError: dfa_dense kernel"):
                c.result(c.send_image(image))
            assert failed
            monkeypatch.undo()
            assert [int(v) for v in c.result(c.send_image(image))] == \
                _plain(ld, sc.flows[:50])
            c.finish()
        finally:
            c.close()
        assert svc.verdictor.breaker.state == 0
    assert _breaker_counts() == before
    assert _route("fallback") == fallback0


def test_bad_chunk_fails_only_its_seq(scenario_loaders, tmp_path):  # noqa
    ld, sc = scenario_loaders["http"]["cilium_tpu_torch"]
    good = PORT.binary.capture_to_bytes(sc.flows[:50])
    before = _breaker_counts()
    with served(PORT, ld, tmp_path / "b.sock") as svc:
        out = _stream(PORT, svc, [good, b"CTCAP1\x00\x00garbage-payload",
                                  good])
    want = _plain(ld, sc.flows[:50])
    assert out[0] == out[2] == want
    assert out[1].startswith("CaptureError")
    assert _breaker_counts() == before


def test_empty_chunk_and_many_in_flight(scenario_loaders, tmp_path):  # noqa
    ld, sc = scenario_loaders["kafka"]["cilium_tpu_torch"]
    image = PORT.binary.capture_to_bytes(sc.flows[:40])
    with served(PORT, ld, tmp_path / "e.sock") as svc:
        out = _stream(PORT, svc, [PORT.binary.capture_to_bytes([])]
                      + [image] * 20, pipeline_depth=4)
    assert out[0] == []
    assert all(o == _plain(ld, sc.flows[:40]) for o in out[1:])


def test_stream_oracle_backend(tmp_path):
    """Gate off → the oracle engine: the stream answers identically,
    through the oracle route."""
    per, sc = scenario(PORT, "http", 20, 64)
    ld = make_loader(PORT, tmp_path / "c", enable_tpu_offload=False)
    try:
        ld.regenerate(per, revision=1)
        oracle0 = _route("oracle")
        with served(PORT, ld, tmp_path / "o.sock") as svc:
            out = _stream(PORT, svc,
                          [PORT.binary.capture_to_bytes(sc.flows)])
        assert out == [_plain(ld, sc.flows)]
        assert _route("oracle") - oracle0 == 1
    finally:
        ld.close()


def test_chunks_take_the_session_route(scenario_loaders, tmp_path,  # noqa
                                       monkeypatch):
    """With the gate on a chunk goes through the IncrementalSession:
    the oracle's record reconstruction may raise and the stream still
    answers."""
    ld, sc = scenario_loaders["http"]["cilium_tpu_torch"]

    def refuse(*a, **k):
        raise AssertionError("the oracle route was taken")

    monkeypatch.setattr(S, "records_to_flows_l7", refuse)
    session0 = _route("session")
    with served(PORT, ld, tmp_path / "r.sock") as svc:
        out = _stream(PORT, svc, [PORT.binary.capture_to_bytes(
            sc.flows[i:i + 64]) for i in range(0, 192, 64)])
    assert sum(out, []) == _plain(ld, sc.flows[:192])
    assert _route("session") - session0 == 3


# =============================================================== credits
def test_credits_round_trip_and_accounting(scenario_loaders,  # noqa
                                           tmp_path):
    ld, sc = scenario_loaders["http"]["cilium_tpu_torch"]
    m = PORT.metrics.METRICS
    with served(PORT, ld, tmp_path / "c.sock") as svc:
        granted0 = m.get("cilium_tpu_stream_credits_granted_total")
        c = S.StreamClient(svc.socket_path)
        try:
            window = c._credits
            assert window == 32
            seqs = [c.send_flows(sc.flows[:64]) for _ in range(5)]
            c.finish()
            for seq in seqs:
                assert len(c.result(seq)) == 64
            with c._cond:
                assert c._credits == window
        finally:
            c.close()
    assert m.get("cilium_tpu_stream_credits_granted_total") == granted0 + 5


def test_client_halts_at_zero_credit(tmp_path):
    """A window-1 server that withholds its answer leaves the client's
    second send BLOCKED; the answer and its grant release it."""
    path = str(tmp_path / "fake.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)
    release = threading.Event()
    server_err = []
    recv_msg, send_msg = PORT.service.recv_msg, PORT.service.send_msg

    def fake_server():
        try:
            conn, _ = srv.accept()
            assert recv_msg(conn)["op"] == "stream_start"
            send_msg(conn, {"ok": True, "revision": 1, "credit": 1})
            seq, _, _ = S.recv_frame(conn)
            release.wait(10.0)
            S.send_frame(conn, seq, S.KIND_CHUNK, b"\x01")
            S.send_frame(conn, seq, S.KIND_CREDIT, struct.pack("<I", 1))
            seq2, _, _ = S.recv_frame(conn)
            S.send_frame(conn, seq2, S.KIND_CHUNK, b"\x01")
            S.send_frame(conn, seq2, S.KIND_CREDIT, struct.pack("<I", 1))
            S.recv_frame(conn)
            S.send_frame(conn, 99, S.KIND_END)
            conn.close()
        except Exception as e:  # noqa: BLE001 — asserted below
            server_err.append(e)

    t = threading.Thread(target=fake_server, daemon=True)
    t.start()
    client = S.StreamClient(path, timeout=10.0)
    try:
        assert client._credits == 1
        waits0 = PORT.metrics.METRICS.get(
            "cilium_tpu_stream_credit_waits_total")
        client.send_image(b"chunk-zero")
        sent2 = []
        t2 = threading.Thread(
            target=lambda: sent2.append(client.send_image(b"chunk-one")))
        t2.start()
        t2.join(timeout=0.3)
        assert t2.is_alive(), "send at zero credit did not block"
        release.set()
        t2.join(timeout=10.0)
        assert not t2.is_alive() and sent2 == [1]
        assert PORT.metrics.METRICS.get(
            "cilium_tpu_stream_credit_waits_total") > waits0
        client.finish()
        assert len(client.result(0)) == 1 and len(client.result(1)) == 1
    finally:
        client.close()
        t.join(timeout=10.0)
        srv.close()
    assert not t.is_alive() and not server_err, server_err


def test_credits_survive_reconnect_with_resume(scenario_loaders,  # noqa
                                               tmp_path):
    ld, sc = scenario_loaders["http"]["cilium_tpu_torch"]
    want = _plain(ld, sc.flows[:32])
    reconnects0 = PORT.metrics.METRICS.get(
        "cilium_tpu_stream_reconnects_total")
    with served(PORT, ld, tmp_path / "rc.sock") as svc:
        c = S.StreamClient(svc.socket_path, timeout=60.0, reconnect=True,
                           backoff_base=0.01, reconnect_seed=3)
        try:
            window = c._credits
            plan = PORT.faults.FaultPlan([PORT.faults.FaultRule(
                "stream.frame.client", after=1, times=1,
                exc=ConnectionError)], seed=17)
            with PORT.faults.inject(plan):
                seqs = [c.send_flows(sc.flows[:32]) for _ in range(6)]
                c.finish()
                for seq in seqs:
                    assert [int(v) for v in c.result(seq)] == want
            assert plan.counts("stream.frame.client")[1] == 1
            with c._cond:
                assert c._credits is not None
                assert 0 < c._credits <= window
        finally:
            c.close()
    assert PORT.metrics.METRICS.get(
        "cilium_tpu_stream_reconnects_total") == reconnects0 + 1


# ================================================== concurrent streams
@pytest.mark.parametrize("route", ["session", "ring"])
def test_concurrent_streams_are_exact(tmp_path, route):
    """Four streams at once, each on its private session, or (with
    ``serve.enabled``) leasing ring slots served by the serve loop's
    pack cycles: every verdict exact, every chunk on its route."""
    per, sc = scenario(PORT, "http", 20, 256)
    ld = make_loader(PORT, tmp_path / "c",
                     serve__enabled=route == "ring",
                     serve__pack_interval_ms=1.0)
    try:
        ld.regenerate(per, revision=1)
        r0 = _route(route)
        outs = {}
        with served(PORT, ld, tmp_path / "s.sock") as svc:
            def one(k):
                flows = sc.flows[k * 64:(k + 1) * 64]
                outs[k] = _stream(PORT, svc, [
                    PORT.binary.capture_to_bytes(flows[i:i + 16])
                    for i in range(0, 64, 16)])

            threads = [threading.Thread(target=one, args=(k,))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            status = (svc.serveloop.status() if route == "ring"
                      else None)
            assert (svc.serveloop is None) == (route == "session")
        for k in range(4):
            assert sum(outs[k], []) == _plain(
                ld, sc.flows[k * 64:(k + 1) * 64])
        assert _route(route) - r0 == 16
        if status is not None:
            assert status["occupancy"] == 0 and status["grants"] == 4
            assert status["served_records"] == 256
    finally:
        ld.close()


# ===================================================== hot swap mid-stream
def test_hot_swap_mid_stream_has_no_stale_verdicts(tmp_path):
    """Five chunks, a committed path rule, five more: each group equal
    to the plain engine of the revision it was sent under and to the
    reference's stream under the same swap; the session consumes the
    bank-scoped delta (no policy-swap reset)."""
    got, plains = {}, {}
    inv = "cilium_tpu_verdict_memo_invalidations_total"
    moved = {}
    for pkg in PKGS:
        world = _World(pkg, 20, 256)
        ld = make_loader(pkg, tmp_path / pkg.root)
        try:
            ld.regenerate(world.snapshot(), revision=1)
            probe = world.probe("/churn0/x")
            flows = [probe] + world.flows[:159]
            images = [pkg.binary.capture_to_bytes(flows[i:i + 32])
                      for i in range(0, 160, 32)]
            m = pkg.metrics.METRICS
            before = {r: m.get(inv, {"reason": r})
                      for r in ("policy-swap", "bank-swap")}
            with served(pkg, ld, tmp_path / f"{pkg.root}.sock") as svc:
                c = pkg.stream.StreamClient(svc.socket_path, timeout=60.0)
                try:
                    first = [[int(v) for v in c.result(c.send_image(im))]
                             for im in images]
                    if not pkg.jax:
                        plains[1] = _plain(ld, flows)
                    ld.regenerate(world.snapshot(("/churn0/.*",)),
                                  revision=2)
                    second = [[int(v) for v in c.result(c.send_image(im))]
                              for im in images]
                    c.finish()
                finally:
                    c.close()
            if not pkg.jax:
                plains[2] = _plain(ld, flows)
            got[pkg.root] = (first, second)
            moved[pkg.root] = {r: m.get(inv, {"reason": r}) - b
                               for r, b in before.items()}
        finally:
            ld.close()
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    first, second = got["cilium_tpu_torch"]
    assert sum(first, []) == plains[1] and sum(second, []) == plains[2]
    assert plains[1][0] != plains[2][0]  # the probe's verdict moved
    assert moved["cilium_tpu_torch"] == {"policy-swap": 0, "bank-swap": 1}
