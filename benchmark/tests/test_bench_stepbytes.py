"""The step's byte count against a count written out by hand."""

from __future__ import annotations

import numpy as np

from benchmark import deployment, reference
from benchmark.metrics import step_roofline_pct as srp
from benchmark.tests.test_bench_reference import CONFIG, records


def test_step_bytes_terms():
    # 4 rows of 15 int32; path: 3 strings x 2 words, method: 1 x 1;
    # 2 mapstate entries; one rule set of 5 rules; 22 bytes of lanes
    got = srp.step_bytes(4, 60, {"path": (3, 2), "method": (1, 1)}, 2, 5,
                         22)
    assert got == 4 * 60 + 4 * (3 * 2 + 1 * 1) + 16 * 2 + 4 * 4 * 5 + 4 * 22


def test_chunk_bytes_by_hand():
    dep = deployment.from_dict(CONFIG)
    rows = [
        (0x10100, 0x10101, 80, "GET", "/api/a", ()),        # redirect
        (0x10100, 0x10101, 80, "GET", "/api/b", ()),        # same key
        (0x10100, 0x10101, 80, "PUT", "/admin",
         (("X-Role", "admin"),)),
        (0x10100, 0x10102, 5432, "", "", ()),               # plain allow
        (0x10101, 0x20100, 9, "", "", ()),                  # no policy
    ]
    rec = records(rows)
    exp = reference.decide(dep, rec)
    words = srp.pattern_words(dep)
    # patterns: path 2, method 2, host 0, headers 1 -> 1 word each but host
    assert words == {"method": 1, "path": 1, "host": 0, "headers": 1}
    got = srp.chunk_bytes(dep, rec, exp, 0, 5, row_bytes=60,
                          lane_bytes=22, words=words)
    rows_b = 5 * 60
    # HTTP records' distinct strings: paths 3, methods 2 (GET, PUT),
    # hosts 0 (all empty), header blocks 1 (the one non-empty)
    words_b = 4 * (3 * 1 + 2 * 1 + 0 + 1 * 1)
    entries_b = 16 * 2           # (client, server, 80) and (client, db)
    rules_b = 4 * 4 * 2          # the web policy's 2 rules
    lanes_b = 5 * 22
    assert got == rows_b + words_b + entries_b + rules_b + lanes_b


def test_roofline_share_reads_bytes_over_device_time():
    from benchmark.trace import Reading

    r = Reading(chunks=2, window_s=1.0, busy_s=0.5, kernel_s=0.002,
                kernels=10, copy_s=0.0, device_ops=[], gaps=[])
    got = srp.read({"trace": r, "step_bytes": [3.35e9, 3.35e9]})
    # 3.35e9 bytes take 1 ms at 3.35 TB/s; the step took 1 ms a chunk
    assert np.isclose(got, 100.0)
    assert srp.read({"trace": r, "step_bytes": []}) is None


def test_the_http_capture_and_its_byte_count_are_pinned(tmp_path):
    """The small HTTP cell's capture and step bytes, as written before
    the harness took Kafka: the same file to the byte, the same count."""
    import hashlib

    from benchmark import capture, traffic
    from benchmark.tests import small

    dep = deployment.from_dict(small.config("http-1k"))
    mix = small.traffic()
    rec = traffic.generate(dep, mix, 2 ** 31 + 17)
    path = tmp_path / "capture.bin"
    capture.write(str(path), rec)
    assert hashlib.sha256(path.read_bytes()).hexdigest() == \
        "b91fb3f783ae05a079921b71a67f4964fe350855b0ba7b88fce7fec05afdb1a3"
    exp = reference.decide(dep, rec)
    words = srp.pattern_words(dep)
    assert [srp.chunk_bytes(dep, rec, exp, s, mix["chunk"], 60, 22, words)
            for s in range(0, mix["records"], mix["chunk"])] == [178168] * 4
