"""The port's capture ingest — the access-log and JSONL readers
(``ingest/accesslog.py``, the JSONL half of ``ingest/hubble.py``) and
the replay cursor (``ingest/cursor.py``) — against the JAX package's,
on the CPU.

* every line of the reference's access-log fixture
  (``tests/test_accesslog_ingest.py``), of the reference-capture golden
  and of a set of edges (IPv6 and bad ports, nanosecond stamps, Denied
  entries, exporter envelopes, provenance, GENERIC records) gives equal
  flows (``parse_capture_line``) and equal column tuples
  (``accesslog_to_columns``, ``flow_dict_to_columns``,
  ``capture_line_to_columns``); ``write_jsonl`` writes byte-equal files
  and ``read_jsonl`` reads either package's back equal, with ``start``,
  ``limit`` and blank lines;
* ``replay_chunks`` over binary v1, v2 and v3, flowpb and JSONL
  captures gives the same ``(commit_index, chunk)`` sequence in both
  packages, with ``start``, ``limit``, blank lines and ``decode=False``
  (every ``RawChunk`` field equal); a killed-and-resumed
  ``ReplayCursor`` run equals the uninterrupted one (no chunk skipped,
  at most one run twice), and the cursor file's edge cases load alike;
* ``decode=False`` chunks go into the port's ``CaptureReplay`` and
  ``verdict_l7_records`` as the reference's ``cmd_replay`` passes them
  (``cli.py:266-284``), all ten lanes equal to the JAX package's.

Mirrors ``tests/test_accesslog_ingest.py`` and
``tests/test_replay_cursor.py``.
"""

import importlib
import json
import os
import types

import numpy as np
import pytest

import test_accesslog_ingest as ref_ingest
from test_torch_service import make_loader

GOLDEN = ref_ingest.GOLDEN
LANES = ("verdict", "match_spec", "ruleset", "allowed", "l3l4_allowed",
         "redirect", "l7_ok", "l7_log", "auth_required", "l7_match")


def _pkg(root):
    ns = types.SimpleNamespace(root=root, jax=root == "cilium_tpu")
    for attr, mod in (("flow", "core.flow"),
                      ("accesslog", "ingest.accesslog"),
                      ("hubble", "ingest.hubble"),
                      ("cursor", "ingest.cursor"),
                      ("flowpb", "ingest.flowpb"),
                      ("binary", "ingest.binary"),
                      ("synth", "ingest.synth"),
                      ("config", "core.config"),
                      ("loader", "runtime.loader")):
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    if ns.jax:
        from cilium_tpu.auth import AUTH_UNENFORCED
        from cilium_tpu.engine.verdict import CaptureReplay
    else:
        from cilium_tpu_torch.engine.replay import CaptureReplay
        from cilium_tpu_torch.engine.verdict import AUTH_UNENFORCED
    ns.unenforced, ns.Replay = AUTH_UNENFORCED, CaptureReplay
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")
PKGS = (JAX, PORT)

#: lines past the reference fixture: the edges of both schemas
EDGE_LINES = [
    {"entry_type": "Request", "is_ingress": False,
     "timestamp": "2026-07-30T10:00:00.123456789Z",
     "source_security_id": 7, "destination_security_id": 8,
     "source_address": "2001:db8::1", "destination_address": "10.0.0.1:x",
     "http": {"method": "PUT", "path": "/p", "host": "MiXeD.Local",
              "status": 503, "http_protocol": "HTTP/2",
              "headers": [{"key": "B", "value": "2"},
                          {"key": "a", "value": "1"}]}},
    {"entry_type": "denied", "source_address": "[::1]",
     "destination_address": "[fe80::1]:443",
     "kafka": {"api_key": 3, "api_version": 9, "topic": "t",
               "client_id": "cid", "correlation_id": 11}},
    {"is_ingress": True, "http": {}},
    {"source_security_id": None, "kafka": {}},
    {"flow": {"verdict": "REDIRECTED", "policy_match_type": 4,
              "trace_id": "abc",
              "provenance": {"word": 77, "rule": "r", "bank": "b",
                             "generation": 0, "memo": True},
              "IP": {"source": "10.1.1.1", "destination": "10.2.2.2"},
              "l4": {"UDP": {"destination_port": 53, "source_port": 9}},
              "l7": {"dns": {"query": "Foo.Example.COM.",
                             "qtypes": ["AAAA"], "ttl": 30}}},
     "node_name": "n2", "time": 1753866000.5},
    {"verdict": "NOPE", "traffic_direction": "SIDEWAYS",
     "source": {"identity": 3}, "l4": {"ICMPv6": {"type": 129}},
     "policy_match_type": 99},
    {"source": {"identity": 5, "labels": []},
     "l4": {"SCTP": {"destination_port": 3868}},
     "l7": {"generic": {"proto": "r2d2",
                        "fields": {"file": "f.txt", "cmd": "READ",
                                   "": "dropped"}}}},
    {"source": {}, "l7": {"kafka": {"api_key": -1, "topic": "x"}},
     "time": "not a time"},
    {"source": {}, "l7": {"http": {"url": "https://H.example/a/b?c=d",
                                   "headers": [{"key": "k"}]}}},
]


def _lines():
    with open(GOLDEN) as fp:
        golden = [json.loads(s) for s in fp if s.strip()]
    return ref_ingest._fixture_lines() + golden + EDGE_LINES


def _cols(t):
    """A column tuple as comparable data (floats by bit pattern)."""
    return tuple(repr(v) if isinstance(v, float) else v for v in t)


# ---------------------------------------------------- access log, JSONL
@pytest.mark.parametrize("i", range(len(_lines())))
def test_capture_line_gives_equal_flows_and_columns(i):
    got = {}
    for pkg in PKGS:
        d = _lines()[i]
        al = pkg.accesslog
        is_al = al.is_accesslog_entry(d)
        cols = al.capture_line_to_columns(d)
        half = (al.accesslog_to_columns(d) if is_al
                else pkg.hubble.flow_dict_to_columns(d))
        assert _cols(half) == _cols(cols)
        got[pkg.root] = (is_al, pkg.hubble.flow_to_dict(
            al.parse_capture_line(d)), _cols(cols))
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]


def test_split_addr_and_time_stamps():
    addrs = ["", "10.0.0.1:443", "10.0.0.1:x", "[2001:db8::1]:8080",
             "[2001:db8::1]:y", "[::1]", "2001:db8::1", "host"]
    times = [None, 0, 12.5, "2026-07-30T10:00:00Z",
             "2026-07-30T10:00:00.123456789Z", "2026-07-30T10:00:00+02:00",
             "garbage"]
    for pkg in PKGS:
        assert pkg.accesslog._split_addr("[::1]:80") == ("::1", 80)
    assert ([PORT.accesslog._split_addr(a) for a in addrs]
            == [JAX.accesslog._split_addr(a) for a in addrs])
    assert ([repr(PORT.hubble._to_time(t)) for t in times]
            == [repr(JAX.hubble._to_time(t)) for t in times])


def _capture_flows(pkg, lines):
    return [pkg.accesslog.parse_capture_line(d) for d in lines]


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-writes", "port-writes"])
def test_jsonl_round_trips_between_the_packages(tmp_path, writer, reader):
    lines = _lines()
    path = str(tmp_path / "cap.jsonl")
    n = writer.hubble.write_jsonl(path, _capture_flows(writer, lines))
    assert n == len(lines)
    other = str(tmp_path / "other.jsonl")
    assert reader.hubble.write_jsonl(
        other, _capture_flows(reader, lines)) == n
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()
    want = [writer.hubble.flow_to_dict(f)
            for f in writer.hubble.read_jsonl(path)]
    assert len(want) == n
    for start, limit in ((0, None), (3, None), (3, 4), (n, None), (0, 0)):
        got = [reader.hubble.flow_to_dict(f)
               for f in reader.hubble.read_jsonl(path, start, limit)]
        assert got == want[start:None if limit is None else start + limit]
    # blank lines count as lines and yield nothing
    with open(path) as fp:
        body = fp.read().splitlines()
    gappy = str(tmp_path / "gappy.jsonl")
    with open(gappy, "w") as fp:
        fp.write("\n".join(body[:2] + ["", "  "] + body[2:]) + "\n")
    assert ([reader.hubble.flow_to_dict(f)
             for f in reader.hubble.read_jsonl(gappy, 1, 5)]
            == [writer.hubble.flow_to_dict(f)
                for f in writer.hubble.read_jsonl(gappy, 1, 5)])


# ---------------------------------------------------------- the cursor
FORMATS = ("v1", "v2", "v3", "pb", "jsonl")


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """format → path; every capture written once, by the port's writers
    (v1 by the reference's: the port writes v2 and v3 only)."""
    d = tmp_path_factory.mktemp("caps")
    _, http = PORT.synth.realize_scenario(
        PORT.synth.scenario_by_name("http", 8, 90))
    _, kafka = PORT.synth.realize_scenario(
        PORT.synth.scenario_by_name("kafka", 8, 40))
    _, gen = PORT.synth.realize_scenario(
        PORT.synth.scenario_by_name("generic", 8, 50))
    flows = http.flows + kafka.flows
    paths = {f: str(d / f"cap.{f}") for f in FORMATS}
    _, jhttp = JAX.synth.realize_scenario(
        JAX.synth.scenario_by_name("http", 8, 90))
    JAX.binary.write_capture(paths["v1"], jhttp.flows)
    PORT.binary.write_capture_l7(paths["v2"], flows)
    PORT.binary.write_capture_l7(paths["v3"], http.flows[:40] + gen.flows)
    PORT.flowpb.write_pb_capture(paths["pb"], flows)
    PORT.hubble.write_jsonl(paths["jsonl"], flows)
    with open(paths["jsonl"]) as fp:
        body = fp.read().splitlines()
    # blank lines, and an access-log entry among the flowpb lines
    body[5:5] = ["", json.dumps(ref_ingest._fixture_lines()[-1]), "  "]
    body.insert(40, "")
    with open(paths["jsonl"], "w") as fp:
        fp.write("\n".join(body) + "\n")
    assert PORT.binary.capture_version(paths["v3"]) == 3
    return paths


def _arr(a):
    if a is None:
        return None
    a = np.asarray(a)
    return (str(a.dtype.descr), a.shape, a.tobytes())


def _chunk(pkg, chunk):
    if isinstance(chunk, pkg.cursor.RawChunk):
        return ("raw", len(chunk), _arr(chunk.records), _arr(chunk.l7),
                _arr(chunk.offsets), _arr(chunk.blob), chunk.widths,
                _arr(chunk.l7_all), _arr(chunk.gen), _arr(chunk.gen_all),
                chunk.start, _arr(chunk.records_all))
    return [pkg.hubble.flow_to_dict(f) for f in chunk]


def _sequence(pkg, path, **kw):
    return [(i, _chunk(pkg, c))
            for i, c in pkg.cursor.replay_chunks(path, **kw)]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kw", [{"chunk_size": 16},
                                {"chunk_size": 64, "start": 5},
                                {"chunk_size": 7, "limit": 30},
                                {"chunk_size": 8192, "start": 3,
                                 "limit": 11},
                                {"chunk_size": 16, "decode": False},
                                {"chunk_size": 33, "start": 20,
                                 "limit": 40, "decode": False}],
                         ids=["c16", "c64-s5", "c7-l30", "c8192-s3-l11",
                              "raw-c16", "raw-c33-s20-l40"])
def test_replay_chunks_equal_the_reference(captures, fmt, kw):
    path = captures[fmt]
    if kw.get("decode", True) is False and fmt in ("pb", "jsonl"):
        for pkg in PKGS:
            with pytest.raises(pkg.binary.CaptureError, match="bad magic"):
                list(pkg.cursor.replay_chunks(path, **kw))
        return
    want = _sequence(JAX, path, **kw)
    assert want and _sequence(PORT, path, **kw) == want


def _run(pkg, path, cursor_path, kill_after=None, uncommitted=False):
    """One pass under a cursor → the flows' source identities in the
    order processed; ``kill_after`` chunks then stop (the last of them
    processed but not committed when ``uncommitted``)."""
    cur = pkg.cursor.ReplayCursor(cursor_path, path)
    seen = []
    for n, (idx, chunk) in enumerate(pkg.cursor.replay_chunks(
            path, chunk_size=16, cursor=cur)):
        seen.extend(f.src_identity for f in chunk)
        if kill_after is not None and n + 1 == kill_after and uncommitted:
            return seen
        cur.commit(idx)
        if kill_after is not None and n + 1 == kill_after:
            return seen
    return seen


@pytest.mark.parametrize("fmt", ["v2", "pb", "jsonl"])
@pytest.mark.parametrize("uncommitted", [False, True],
                         ids=["committed", "killed-before-commit"])
def test_killed_and_resumed_cursor_equals_the_uninterrupted_run(
        tmp_path, captures, fmt, uncommitted):
    path = captures[fmt]
    got = {}
    for pkg in PKGS:
        whole = _run(pkg, path, str(tmp_path / f"{pkg.root}.whole"))
        cur = str(tmp_path / f"{pkg.root}.cur")
        first = _run(pkg, path, cur, kill_after=3, uncommitted=uncommitted)
        rest = _run(pkg, path, cur)
        # no chunk skipped; the uncommitted chunk (16 flows) runs twice
        twice = 16 if uncommitted else 0
        assert first[:len(first) - twice] + rest == whole
        got[pkg.root] = (whole, first, rest)
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]


def test_cursor_file_edge_cases_load_alike(tmp_path, captures):
    a, b = captures["v2"], captures["pb"]
    path = str(tmp_path / "cursor.json")
    got = {}
    for pkg in PKGS:
        C = pkg.cursor.ReplayCursor
        loads = [C(path, a).load()]           # absent
        C(path, a).commit(3)
        loads += [C(path, a).load(), C(path, b).load()]
        for body in ("{torn write", "[1, 2]", '{"capture": "%s"}' % a,
                     json.dumps({"capture": os.path.abspath(a),
                                 "index": -4}),
                     json.dumps({"capture": os.path.abspath(a),
                                 "index": "7"})):
            with open(path, "w") as fp:
                fp.write(body)
            loads.append(C(path, a).load())
        C(path, a).clear()
        C(path, a).clear()                    # clearing twice is fine
        loads.append(C(path, a).load())
        got[pkg.root] = loads
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    assert got["cilium_tpu_torch"] == [0, 3, 0, 0, 0, 0, 0, 7, 0]


# ------------------------------------------- decode=False into replay
def _fast_replay(pkg, loader, path, session):
    """``cmd_replay --fast``: raw chunks into one ``CaptureReplay``
    session (``session``) or ``verdict_l7_records`` per chunk."""
    cfg = pkg.config.Config()
    engine, replay, outs = loader.engine, None, []
    for _, chunk in pkg.cursor.replay_chunks(path, chunk_size=32,
                                             decode=False):
        if session:
            if replay is None:
                replay = pkg.Replay(engine, chunk.l7_all, chunk.offsets,
                                    chunk.blob, cfg.engine,
                                    gen=chunk.gen_all, loader=loader)
                replay.stage_rows(chunk.records_all, chunk.l7_all)
                replay.stage_unique(cfg.engine.stage_unique_drop_ratio)
            out = replay.verdict_chunk(chunk.records, chunk.l7,
                                       authed_pairs=pkg.unenforced,
                                       start=chunk.start)
        else:
            out = engine.verdict_l7_records(
                chunk.records, chunk.l7, chunk.offsets, chunk.blob,
                authed_pairs=pkg.unenforced, widths=chunk.widths,
                gen=chunk.gen)
        outs.append({k: np.asarray(out[k]) for k in LANES})
    return {k: np.concatenate([o[k] for o in outs]) for k in LANES}


@pytest.mark.parametrize("session", [True, False],
                         ids=["capture-replay", "l7-records"])
def test_raw_chunks_verdict_equal_through_each_package(tmp_path, captures,
                                                       session):
    got = {}
    for pkg in PKGS:
        per_identity, _ = pkg.synth.realize_scenario(
            pkg.synth.scenario_by_name("http", 8, 90))
        ld = make_loader(pkg, tmp_path / pkg.root)
        try:
            ld.regenerate(per_identity, revision=1)
            got[pkg.root] = _fast_replay(pkg, ld, captures["v2"], session)
        finally:
            ld.close()
    for k in LANES:
        np.testing.assert_array_equal(got["cilium_tpu_torch"][k],
                                      got["cilium_tpu"][k], k)
    assert len(got["cilium_tpu_torch"]["verdict"]) == 130
    assert len(set(got["cilium_tpu_torch"]["verdict"].tolist())) > 1
