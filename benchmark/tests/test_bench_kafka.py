"""Kafka through the harness: the reference's rule semantics on records
worked out by hand, the capture's Kafka columns read back by the
program's reader, the step's byte count, and a small Kafka deployment
run through the program on the CPU, correct, with its control not."""

from __future__ import annotations

import sys

import numpy as np
import pytest

from benchmark import capture, control, deployment, reference, registry, run
from benchmark import traffic
from benchmark.metrics import step_roofline_pct as srp
from benchmark.reference import DROPPED, FORWARDED, REDIRECTED
from benchmark.tests import kafka_small
from benchmark.traffic import HTTP, KAFKA, Records, intern

CLIENT, BROKER = 0x10100, 0x10101

# one Kafka rule a port, so that each case is worked against one rule
RULES = {
    9001: {"role": "produce"},
    9002: {"role": "consume"},
    9003: {"apiKey": "offsetcommit"},
    9004: {"apiKey": "fetch", "apiVersion": "4"},
    9005: {"clientID": "reader"},
    9006: {"role": "consume", "topic": "orders"},
    9007: {"role": "produce", "apiVersion": "3", "clientID": "app",
           "topic": "orders"},
}
CONFIG = {
    "name": "kafka-hand",
    "identities": [
        {"count": 1, "labels": {"app": "client"},
         "id": {"cluster": "1", "local": "256"}},
        {"count": 1, "labels": {"app": "broker"},
         "id": {"cluster": "1", "local": "257"}},
    ],
    "policies": [
        {"count": 1, "name": f"p{port}", "select": {"app": "broker"},
         "peer": {"app": "client"}, "port": str(port),
         "kafka": {"count": 1, "shapes": [{"rule": rule}]}}
        for port, rule in RULES.items()],
}


def kafka_records(rows):
    """rows: (port, l7 type, API key, API version, client id, topic)."""
    n = len(rows)
    strings = {f: intern([r[k].encode() for r in rows])
               for f, k in (("kafka_client", 4), ("kafka_topic", 5))}
    return Records(
        src=np.full(n, CLIENT, dtype=np.uint32),
        dst=np.full(n, BROKER, dtype=np.uint32),
        dport=np.array([r[0] for r in rows], dtype=np.uint16),
        proto=np.full(n, 6, dtype=np.uint8),
        direction=np.ones(n, dtype=np.uint8),
        l7=np.array([r[1] for r in rows], dtype=np.uint8),
        strings=strings,
        kafka_api_key=np.array([r[2] for r in rows], dtype=np.int16),
        kafka_api_version=np.array([r[3] for r in rows], dtype=np.int16))


K = KAFKA
CASES = [
    # (port, l7, key, version, client, topic), verdict
    # role produce: Produce 0, Metadata 3, ApiVersions 18
    ((9001, K, 0, 7, "", "t"), REDIRECTED),
    ((9001, K, 3, 7, "", "t"), REDIRECTED),
    ((9001, K, 18, 7, "", "t"), REDIRECTED),
    ((9001, K, 1, 7, "", "t"), DROPPED),
    ((9001, K, 8, 7, "", "t"), DROPPED),
    # role consume: Fetch 1, ListOffsets 2, Metadata 3, OffsetCommit 8,
    # OffsetFetch 9, FindCoordinator 10, JoinGroup 11, Heartbeat 12,
    # LeaveGroup 13, SyncGroup 14, ApiVersions 18
    ((9002, K, 1, 0, "", "t"), REDIRECTED),
    ((9002, K, 2, 0, "", "t"), REDIRECTED),
    ((9002, K, 12, 0, "", "t"), REDIRECTED),
    ((9002, K, 14, 0, "", "t"), REDIRECTED),
    ((9002, K, 0, 0, "", "t"), DROPPED),
    ((9002, K, 15, 0, "", "t"), DROPPED),
    ((9002, K, 19, 0, "", "t"), DROPPED),
    # a named apiKey: that key alone
    ((9003, K, 8, 0, "", "t"), REDIRECTED),
    ((9003, K, 9, 0, "", "t"), DROPPED),
    # an apiVersion: that version exactly
    ((9004, K, 1, 4, "", "t"), REDIRECTED),
    ((9004, K, 1, 5, "", "t"), DROPPED),
    ((9004, K, 0, 4, "", "t"), DROPPED),
    # a clientID alone: any API key, that client exactly
    ((9005, K, 33, 0, "reader", "t"), REDIRECTED),
    ((9005, K, 0, 0, "readers", "t"), DROPPED),
    ((9005, K, 0, 0, "", "t"), DROPPED),
    # a topic: that topic exactly, where the record carries one
    ((9006, K, 1, 0, "", "orders"), REDIRECTED),
    ((9006, K, 1, 0, "", "payments"), DROPPED),
    ((9006, K, 0, 0, "", "orders"), DROPPED),
    # a record without a topic is judged on the rule's other parts
    ((9006, K, 12, 0, "", ""), REDIRECTED),
    ((9006, K, 0, 0, "", ""), DROPPED),
    # every part at once
    ((9007, K, 0, 3, "app", "orders"), REDIRECTED),
    ((9007, K, 0, 3, "app", ""), REDIRECTED),
    ((9007, K, 0, 3, "app", "payments"), DROPPED),
    ((9007, K, 0, 2, "app", "orders"), DROPPED),
    ((9007, K, 0, 3, "other", "orders"), DROPPED),
    ((9007, K, 1, 3, "app", "orders"), DROPPED),
    # not a Kafka record on a Kafka port; a port no policy opens
    ((9001, 0, 0, 0, "", ""), DROPPED),
    ((9001, HTTP, 0, 0, "", ""), DROPPED),
]


@pytest.mark.parametrize("row,verdict", CASES)
def test_hand_made_kafka_record(row, verdict):
    dep = deployment.from_dict(CONFIG)
    got = reference.decide(dep, kafka_records([row]))
    assert int(got.verdict[0]) == verdict
    assert bool(got.l3l4_allowed[0]) and bool(got.redirect[0])
    assert int(got.kafka_policy[0]) == list(RULES).index(row[0])
    assert int(got.http_policy[0]) == -1


def test_a_port_no_policy_opens_is_dropped_before_the_proxy():
    dep = deployment.from_dict(CONFIG)
    got = reference.decide(dep, kafka_records([(9999, K, 0, 0, "", "t")]))
    assert (int(got.verdict[0]), bool(got.l3l4_allowed[0]),
            bool(got.redirect[0]), int(got.kafka_policy[0])) \
        == (DROPPED, False, False, -1)


def test_all_kafka_cases_in_one_capture_agree_with_one_at_a_time():
    dep = deployment.from_dict(CONFIG)
    got = reference.decide(dep, kafka_records([c[0] for c in CASES]))
    assert got.verdict.tolist() == [c[1] for c in CASES]


def test_kafka_key_ignored_lets_a_produce_through_a_consume_rule():
    dep = deployment.from_dict(CONFIG)
    rec = kafka_records([(9002, K, 0, 0, "", "t"), (9004, K, 0, 4, "", "t"),
                         (9004, K, 1, 5, "", "t")])
    want = reference.decide(dep, rec).verdict.tolist()
    got = reference.decide(dep, rec, control="kafka_key_ignored")
    assert want == [DROPPED, DROPPED, DROPPED]
    # the key goes unchecked; the version still is
    assert got.verdict.tolist() == [REDIRECTED, REDIRECTED, DROPPED]


def test_the_role_table_is_the_program_s():
    """Drift on either side shows: the reference keeps its own copy."""
    from cilium_tpu_torch.policy.api.l7 import (
        KAFKA_API_KEYS as PORT_KEYS,
        KAFKA_ROLE_API_KEYS as PORT_ROLES,
    )

    assert reference.KAFKA_ROLE_API_KEYS == PORT_ROLES
    assert {k: deployment.KAFKA_API_KEYS[k] for k in PORT_KEYS} == PORT_KEYS


@pytest.mark.parametrize("rule", [
    {"role": "produce", "apiKey": "fetch"}, {"role": "admin"},
    {"apiKey": "nosuchkey"}, {"apiVersion": "40000"},
    {"topic": "a topic"}, {"topic": "t" * 256},
])
def test_a_kafka_rule_upstream_refuses_is_refused(rule):
    cfg = dict(CONFIG, policies=[dict(CONFIG["policies"][0], kafka={
        "count": 1, "shapes": [{"rule": rule}]})])
    with pytest.raises(ValueError):
        deployment.from_dict(cfg)


def test_a_policy_carries_one_l7_family():
    pol = dict(CONFIG["policies"][0],
               http={"count": 1, "shapes": [{"rule": {"path": "/"}}]})
    with pytest.raises(ValueError):
        deployment.from_dict(dict(CONFIG, policies=[pol]))


def test_a_kafka_group_expands_by_index():
    cfg = dict(CONFIG, policies=[dict(
        CONFIG["policies"][0], count=4, name="k{i}", deny_every=1,
        kafka={"every": 2, "count": 3, "shapes": [
            {"rule": {"role": "consume", "topic": "t{i}-{j}"}},
            {"rule": {"apiKey": "Produce", "apiVersion": "{j}"}}]})])
    pols = deployment.from_dict(cfg).policies
    assert [len(p.kafka) for p in pols] == [3, 0, 3, 0]
    # a policy is a deny only where it has no L7 rules of either family
    assert [p.deny for p in pols] == [False, True, False, True]
    assert pols[2].kafka == (
        deployment.KafkaRule(role="consume", topic="t2-0"),
        deployment.KafkaRule(api_key="produce", api_version="1"),
        deployment.KafkaRule(role="consume", topic="t2-2"))


# -- the capture ------------------------------------------------------------
def test_the_capture_s_kafka_columns_read_back_through_the_program(tmp_path):
    from cilium_tpu_torch.ingest.binary import read_l7_sidecar

    rows = [c[0] for c in CASES]
    rec = kafka_records(rows)
    path = str(tmp_path / "k.bin")
    capture.write(path, rec)
    l7, offsets, blob = read_l7_sidecar(path)

    def string(i):
        return blob[int(offsets[i]):int(offsets[i + 1])].tobytes().decode()
    assert len(l7) == len(rows)
    for r, got in zip(rows, l7):
        assert (int(got["kafka_api_key"]), int(got["kafka_api_version"]),
                string(got["kafka_client"]), string(got["kafka_topic"])) \
            == (r[2], r[3], r[4], r[5])
        assert all(int(got[f]) == 0 for f in ("path", "method", "host",
                                               "headers", "qname"))


# -- the step's byte count --------------------------------------------------
def test_kafka_rule_words_count_each_needed_rule_set_once():
    dep = deployment.from_dict(CONFIG)
    rows = [(9001, K, 0, 0, "", "t"), (9001, K, 1, 0, "", "u"),   # 9001
            (9006, K, 1, 0, "", "orders"),                        # 9006
            (9001, 0, 0, 0, "", ""),        # not Kafka: no rule set
            (9999, K, 0, 0, "", "t")]       # not redirected
    rec = kafka_records(rows)
    exp = reference.decide(dep, rec)
    words = srp.pattern_words(dep)
    assert words == {"method": 0, "path": 0, "host": 0, "headers": 0}
    got = srp.chunk_bytes(dep, rec, exp, 0, 5, row_bytes=60, lane_bytes=22,
                          words=words)
    entries_b = 16 * 2           # (client, broker, 9001) and 9006's
    rules_b = 4 * 4 * 2          # one rule in each of two rule sets
    assert got == 5 * 60 + entries_b + rules_b + 5 * 22


# -- a small Kafka deployment through the program ---------------------------
@pytest.fixture
def kafka_generator(monkeypatch):
    monkeypatch.setitem(sys.modules, kafka_small.MODULE, kafka_small)


def kafka_run(wrap=None, seed=2 ** 31 + 17, seconds=0.3):
    bench = registry.load_benchmark()
    cell = {"name": "kafka-small.replay", "config": "kafka-small",
            "traffic": "kafka-small", "chips": 1}
    return run.run_cell(bench, cell, seed, seconds, False, device="cpu",
                        config=kafka_small.CONFIG,
                        traffic_params=kafka_small.MIX, wrap=wrap)


def test_the_small_kafka_mix_holds_both_verdicts(kafka_generator):
    dep = deployment.from_dict(kafka_small.CONFIG)
    rec = traffic.generate(dep, kafka_small.MIX, 5)
    exp = reference.decide(dep, rec)
    assert len(dep.policies[0].kafka) == 20
    assert {dep.policies[0].kafka[j].role for j in range(5)} \
        >= {"produce", "consume"}
    assert (rec.l7 == KAFKA).all() and (exp.redirect).all()
    counts = np.bincount(exp.verdict, minlength=6)
    assert counts[REDIRECTED] > 0.3 * len(rec)
    assert counts[DROPPED] > 0.3 * len(rec)
    assert counts[FORWARDED] == 0
    # every record carries a topic (the program and upstream agree there)
    assert (rec.strings["kafka_topic"][1] > 0).all()


def test_a_small_kafka_run_is_correct(kafka_generator):
    res = kafka_run()
    assert res["correct"] and res["failed"] == 0
    assert res["readings"]["records_compared"] == res["attempted"] > 0


def test_a_small_kafka_run_with_an_altered_answer_is_not_correct(
        kafka_generator):
    from benchmark.tests.test_bench_harness import altered

    res = kafka_run(wrap=altered, seconds=0.5)
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 11])
def test_the_kafka_control_is_not_correct(kafka_generator, seed):
    assert kafka_small.CONFIG["control"] == "kafka_key_ignored"
    assert kafka_small.CONFIG["control"] in reference.CONTROLS
    readings, ok = control.control_readings(kafka_small.CONFIG,
                                            kafka_small.MIX, seed)
    assert not ok and readings["mismatched_records"] > 0
    assert readings["records_compared"] == kafka_small.MIX["records"]


def test_the_kafka_reference_loads_nothing_of_the_program():
    from benchmark.tests.test_bench_isolation import top_level_modules

    names = top_level_modules(
        "import sys\n"
        "from benchmark import control\n"
        "from benchmark.tests import kafka_small\n"
        "sys.modules[kafka_small.MODULE] = kafka_small\n"
        "r, ok = control.control_readings(kafka_small.CONFIG, "
        "kafka_small.MIX, 1)\n"
        "assert not ok")
    assert not names & {"cilium_tpu_torch", "cilium_tpu", "jax", "torch"}
