"""The reference's semantics on hand-made records."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import deployment, reference
from benchmark.reference import DROPPED, FORWARDED, REDIRECTED
from benchmark.tests import small
from benchmark.traffic import HTTP, Records, generate, header_block, intern

CONFIG = {
    "name": "hand",
    "identities": [
        {"count": 1, "labels": {"app": "client"},
         "id": {"cluster": "1", "local": "256"}},
        {"count": 1, "labels": {"app": "server"},
         "id": {"cluster": "1", "local": "257"}},
        {"count": 1, "labels": {"app": "db"},
         "id": {"cluster": "1", "local": "258"}},
        {"count": 1, "labels": {"app": "free"},
         "id": {"cluster": "2", "local": "256"}},
    ],
    "policies": [
        {"count": 1, "name": "web", "select": {"app": "server"},
         "peer": {"app": "client"}, "port": "80",
         "http": {"count": 2, "shapes": [
             {"rule": {"method": "GET", "path": "/api/[a-z]+"}},
             {"rule": {"method": "PUT", "path": "/admin",
                       "headers": ["X-Role: admin"]}}]}},
        {"count": 1, "name": "db", "select": {"app": "db"},
         "peer": {"app": "server"}, "port": "5432"},
        {"count": 1, "name": "db-deny", "select": {"app": "db"},
         "peer": {"app": "server"}, "port": "5432", "deny_every": 1},
        {"count": 1, "name": "db-from-client", "select": {"app": "db"},
         "peer": {"app": "client"}, "port": "5432"},
    ],
}
CLIENT, SERVER, DB, FREE = 0x10100, 0x10101, 0x10102, 0x20100


def records(rows):
    """rows: (src, dst, port, method, path, headers) per record."""
    n = len(rows)
    strings = {}
    for f, k in (("method", 3), ("path", 4)):
        table, idx = intern([r[k].encode() for r in rows])
        strings[f] = (table, idx)
    strings["host"] = ([b""], np.zeros(n, dtype=np.int64))
    strings["headers"] = intern([header_block(r[5]) for r in rows])
    return Records(
        src=np.array([r[0] for r in rows], dtype=np.uint32),
        dst=np.array([r[1] for r in rows], dtype=np.uint32),
        dport=np.array([r[2] for r in rows], dtype=np.uint16),
        proto=np.full(n, 6, dtype=np.uint8),
        direction=np.ones(n, dtype=np.uint8),
        l7=np.array([HTTP if r[3] else 0 for r in rows], dtype=np.uint8),
        strings=strings)


CASES = [
    # (src, dst, port, method, path, headers), verdict, l3l4, redirect
    ((CLIENT, SERVER, 80, "GET", "/api/items", ()), REDIRECTED, True, True),
    ((CLIENT, SERVER, 80, "GET", "/api/items?u=7", ()), DROPPED, True, True),
    ((CLIENT, SERVER, 80, "POST", "/api/items", ()), DROPPED, True, True),
    ((CLIENT, SERVER, 80, "PUT", "/admin", (("X-Role", "admin"),)),
     REDIRECTED, True, True),
    ((CLIENT, SERVER, 80, "PUT", "/admin", (("x-role", "admin"),)),
     REDIRECTED, True, True),
    ((CLIENT, SERVER, 80, "PUT", "/admin", (("X-Role", "guest"),)),
     DROPPED, True, True),
    ((CLIENT, SERVER, 80, "PUT", "/admin", ()), DROPPED, True, True),
    ((CLIENT, SERVER, 80, "", "", ()), DROPPED, True, True),
    ((CLIENT, SERVER, 81, "GET", "/api/items", ()), DROPPED, False, False),
    ((DB, SERVER, 80, "GET", "/api/items", ()), DROPPED, False, False),
    ((SERVER, DB, 5432, "", "", ()), DROPPED, False, False),
    ((CLIENT, DB, 5432, "", "", ()), FORWARDED, True, False),
    ((SERVER, FREE, 9999, "", "", ()), FORWARDED, True, False),
    ((0x999999, SERVER, 80, "GET", "/api/x", ()), DROPPED, False, False),
]


@pytest.mark.parametrize("row,verdict,l3l4,redirect", CASES)
def test_hand_made_record(row, verdict, l3l4, redirect):
    dep = deployment.from_dict(CONFIG)
    got = reference.decide(dep, records([row]))
    assert (int(got.verdict[0]), bool(got.l3l4_allowed[0]),
            bool(got.redirect[0])) == (verdict, l3l4, redirect)


def test_all_cases_in_one_capture_agree_with_one_at_a_time():
    dep = deployment.from_dict(CONFIG)
    got = reference.decide(dep, records([c[0] for c in CASES]))
    assert got.verdict.tolist() == [c[1] for c in CASES]


def test_each_control_breaks_its_guarantee():
    dep = deployment.from_dict(CONFIG)
    rec = records([c[0] for c in CASES])
    want = reference.decide(dep, rec).verdict
    prefix = reference.decide(dep, rec, control="prefix_match").verdict
    assert prefix[1] == REDIRECTED and want[1] == DROPPED   # ?u=7 suffix
    deny = reference.decide(dep, rec, control="deny_ignored").verdict
    assert deny[10] == FORWARDED and want[10] == DROPPED
    default = reference.decide(dep, rec, control="default_allow").verdict
    assert default[8] == FORWARDED and want[8] == DROPPED


@pytest.mark.parametrize("pattern,prefix", [
    ("/api/v1/items/17(/.*)?", "/api/v1/items/17"),
    ("/api/v3/svc12/[a-z0-9]+", "/api/v3/svc12/"),
    ("/static/3/[0-9]+", "/static/3/"),
    ("/admin/4/config", "/admin/4/config"),
    ("/ab*", "/a"), ("/ab?c", "/a"), ("/ab{2}", "/a"),
    ("GET|HEAD", ""), ("[.]x", ""), (r"\.x", ""), ("", ""),
])
def test_literal_prefix(pattern, prefix):
    assert reference.literal_prefix(pattern) == prefix


def test_candidates_by_prefix_decide_as_every_rule_would():
    """The prefix index changes no verdict: against a plain loop over
    every rule on the small http deployment."""
    import re

    dep = deployment.from_dict(small.config("http-1k"))
    rec = generate(dep, small.traffic(4096, 1024), 5)
    got = reference.decide(dep, rec)
    rules = dep.policies[0].http
    tabs = {f: rec.strings[f] for f in ("method", "path", "host", "headers")}
    for n in range(0, len(rec), 37):
        s = {f: t[i] for f, (t, idx) in tabs.items() for i in [idx[n]]}
        ok = any(
            (not r.path or re.fullmatch(r.path.encode(), s["path"]))
            and (not r.method or re.fullmatch(r.method.encode(),
                                              s["method"]))
            and (not r.host or re.fullmatch(r.host.encode(), s["host"],
                                            re.IGNORECASE))
            and all(f"{k.lower()}:{v}\n".encode() in s["headers"]
                    for k, v in r.headers)
            for r in rules)
        assert got.verdict[n] == (REDIRECTED if ok else DROPPED)


def test_the_distinct_header_keeps_every_verdict_and_every_record_apart():
    """The cell's traffic with and without its per-record header: the
    same verdict on every record, and every record distinct."""
    dep = deployment.from_dict(small.config("http-1k"))
    mix = small.traffic(4096, 1024)
    with_id = generate(dep, mix, 9)
    plain = generate(dep, dict(mix, distinct_header=None), 9)
    a = reference.decide(dep, with_id)
    b = reference.decide(dep, plain)
    assert a.verdict.tolist() == b.verdict.tolist()
    assert {REDIRECTED, DROPPED} <= set(a.verdict.tolist())
    table, idx = with_id.strings["headers"]
    assert len(set(idx.tolist())) == len(with_id)
    assert len(set(table)) == len(table)


@pytest.mark.parametrize("base", [(), (("X-Role", "admin3"),),
                                  (("a", "1"), ("zz", "2")),
                                  (("x-req", "1"), ("x-requests", "2"))])
def test_an_added_header_lands_where_the_block_sorts_it(base):
    from benchmark.traffic import add_header

    strings = {"headers": intern([header_block(base)] * 3)}
    add_header(strings, np.arange(3), "X-Request-Id", "{n*7}")
    table, idx = strings["headers"]
    for n in range(3):
        want = header_block(tuple(base) + (("x-request-id", str(n * 7)),))
        assert table[idx[n]] == want
