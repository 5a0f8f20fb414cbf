"""The port's TP, Ulysses, EP and CP lanes against the reference's own
lane functions, on the CPU, at n = 2 and 4.

The reference runs on the conftest's virtual mesh of n devices; the
port on n spawned ``gloo`` ranks (one world of 2 and one of 4 for the
module), each rank given the same numpy arrays and running
``tools/parallel_lanes.run_lane`` (``torch`` and ``cilium_tpu_torch``
only). Integer outputs: tolerance 0. The collective ledger of one port
call (rank 0's; every rank's rows are equal) must equal the
reference's snapshot of a fresh trace: site, op, axis, count per block
and bytes per call.

* TP, single bank and banked, with an accept word whose bit 31 is set;
* the Ulysses raw scan;
* the EP one-shot verdict step on all ten lanes, one all-to-all row;
* the CP scan: the match that straddles a rank boundary
  (``tests/test_multichip.py``'s case), one carry exchange;
* the CP verdict step on the batch widened to 256 columns;
* ``payload_scan_cp`` on ``tests/test_longscan.py``'s PATTERNS bank;
* a hypothesis CP property (few examples), held against the
  single-device ``dfa_scan_banked``;
* the EP batch-divisibility error.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from cilium_tpu.engine.dfa_kernel import dfa_scan_banked  # noqa: E402
from cilium_tpu.parallel.collectives import LEDGER  # noqa: E402
from cilium_tpu.parallel.mesh import make_mesh  # noqa: E402
from cilium_tpu.policy.compiler.dfa import compile_patterns  # noqa: E402

from cilium_tpu_torch.engine.verdict import OUTPUT_LANES  # noqa: E402
from cilium_tpu_torch.parallel.mesh import LocalWorld  # noqa: E402
from cilium_tpu_torch.tools.parallel_lanes import run_lane  # noqa: E402

NS = (2, 4)
PATTERNS = ["/api/v[0-9]+", "/health", "GET", "foo.*bar",
            "/metrics", "abc", "x+y", "/static/.*[.]js"]
LONG_PATTERNS = [".*attack-signature.*", ".*(GET|POST) /evil.*",
                 ".*xx[0-9]{3}yy.*"]
ROW_KEYS = ("site", "op", "axis", "count_per_block", "bytes_per_block",
            "bytes_per_call")


@pytest.fixture(scope="module")
def worlds():
    ws = {n: LocalWorld(n, timeout_s=300.0) for n in NS}
    yield ws
    for w in ws.values():
        w.close()


def _fresh_reference(fn):
    """Run a reference lane on a fresh trace (its factories' caches and
    jax's cleared) with the ledger reset → (numpy result, ledger rows)."""
    from cilium_tpu.engine import longscan
    from cilium_tpu.parallel import cp, tp, ulysses

    for f in (tp._tp_step, tp._tp_banked_step, ulysses._ulysses_step,
              ulysses._ep_verdict_factory, cp._cp_banked_step,
              cp._cp_verdict_factory, longscan._cp_step):
        f.cache_clear()
    jax.clear_caches()
    LEDGER.reset()
    out = jax.block_until_ready(fn())
    rows = LEDGER.snapshot()
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}, rows
    if isinstance(out, tuple):
        return tuple(np.asarray(v) for v in out), rows
    return np.asarray(out), rows


def _rows(rows):
    return [{k: r[k] for k in ROW_KEYS} for r in rows]


def _same_ledger(res, ref_rows):
    for r in res:
        assert _rows(r["ledger"]) == _rows(ref_rows)


def _words(a):
    """int32 bit patterns → the reference's uint32 words."""
    return np.asarray(a).view(np.uint32)


def _stacked(patterns, bank_size):
    return compile_patterns(patterns, bank_size=bank_size).stacked()


def _batch(rng, B=16, L=32):
    """Random rows, ``/api`` prefixes, and three rows that match
    (``GET``, ``/health``, ``/api/v12``) so accept words are read."""
    data = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    data[::3, :4] = np.frombuffer(b"/api", dtype=np.uint8)
    lengths = rng.integers(1, L + 1, size=(B,)).astype(np.int32)
    for row, text in ((1, b"GET"), (2, b"/health"), (4, b"/api/v12")):
        data[row, :len(text)] = np.frombuffer(text, dtype=np.uint8)
        lengths[row] = len(text)
    return data, lengths


def _set_bit31(accept):
    """Every accepting state's first word gains bit 31: the accept
    planes' shifts must carry it."""
    accept = accept.copy()
    acc = accept[..., 0] != 0
    accept[..., 0][acc] |= np.uint32(1 << 31)
    assert acc.any()
    return accept


@pytest.mark.parametrize("n", NS)
def test_tp_single_bank(worlds, n):
    from cilium_tpu.parallel.tp import dfa_scan_tp, pad_states

    rng = np.random.default_rng(0)
    arrs = _stacked(PATTERNS[:4], 4)
    trans, accept = arrs["trans"][0], _set_bit31(arrs["accept"][0])
    bc, start = arrs["byteclass"][0], int(arrs["start"][0])
    data, lengths = _batch(rng)
    tp_, ap = pad_states(trans, accept, n)
    mesh = make_mesh((n,), ("state",), jax.devices()[:n])
    (finals, words), rows = _fresh_reference(lambda: dfa_scan_tp(
        mesh, jnp.asarray(tp_), jnp.asarray(bc), start, jnp.asarray(ap),
        jnp.asarray(data), jnp.asarray(lengths)))
    assert (words >> 31).any()
    res = worlds[n].run(run_lane, "tp", {
        "trans": trans, "byteclass": bc, "start": start, "accept": accept,
        "data": data, "lengths": lengths}, device="cpu")
    got_f, got_w = res[0]["out"]
    np.testing.assert_array_equal(got_f, finals)
    np.testing.assert_array_equal(_words(got_w), words)
    _same_ledger(res, rows)
    assert sum(r["count_per_block"] for r in rows
               if r["site"] == "tp.scan_step") == data.shape[1]


@pytest.mark.parametrize("n", NS)
def test_tp_banked(worlds, n):
    from cilium_tpu.parallel.tp import dfa_scan_banked_tp, pad_states

    rng = np.random.default_rng(1)
    arrs = _stacked(PATTERNS, 3)
    accept = _set_bit31(arrs["accept"])
    data, lengths = _batch(rng, B=8, L=24)
    tp_, ap = pad_states(arrs["trans"], accept, n)
    mesh = make_mesh((n,), ("state",), jax.devices()[:n])
    words, rows = _fresh_reference(lambda: dfa_scan_banked_tp(
        mesh, jnp.asarray(tp_), jnp.asarray(arrs["byteclass"]),
        jnp.asarray(arrs["start"]), jnp.asarray(ap), jnp.asarray(data),
        jnp.asarray(lengths)))
    ref = np.asarray(dfa_scan_banked(
        jnp.asarray(arrs["trans"]), jnp.asarray(arrs["byteclass"]),
        jnp.asarray(arrs["start"]), jnp.asarray(accept), jnp.asarray(data),
        jnp.asarray(lengths)))
    np.testing.assert_array_equal(words, ref)
    res = worlds[n].run(run_lane, "tp_banked", {
        "trans": arrs["trans"], "byteclass": arrs["byteclass"],
        "start": arrs["start"], "accept": accept, "data": data,
        "lengths": lengths}, device="cpu")
    np.testing.assert_array_equal(_words(res[0]["out"]), words)
    # the banks stack in one psum a byte; the reference vmaps them and
    # records one bank's bytes: the rows are equal
    _same_ledger(res, rows)


@pytest.mark.parametrize("n", NS)
def test_ulysses_raw_scan(worlds, n):
    from cilium_tpu.parallel.ulysses import ulysses_scan_banked

    rng = np.random.default_rng(2)
    arrs = _stacked(PATTERNS, 2)            # 8 patterns → 4 banks
    data, lengths = _batch(rng, B=16, L=24)
    mesh = make_mesh((n,), ("data",), jax.devices()[:n])
    g = {k: arrs[k] for k in ("trans", "byteclass", "start", "accept")}
    words, rows = _fresh_reference(lambda: ulysses_scan_banked(
        mesh, *(jnp.asarray(g[k]) for k in
                ("trans", "byteclass", "start", "accept")),
        jnp.asarray(data), jnp.asarray(lengths)))
    res = worlds[n].run(run_lane, "ulysses",
                        {**g, "data": data, "lengths": lengths},
                        device="cpu")
    np.testing.assert_array_equal(_words(res[0]["out"]), words)
    _same_ledger(res, rows)
    assert [r["site"] for r in rows] == ["ulysses.gather", "ulysses.switch"]


def _small(widen=False):
    import __graft_entry__ as ge

    policy, batch, _, _ = ge._small_policy_and_batch(
        n_rules=64, n_flows=56, bank_size=8, n_generic=8)
    if widen:
        batch = dict(batch)
        for key in ("path_data", "headers_data"):
            cur = batch[key]
            batch[key] = np.pad(cur, ((0, 0), (0, 256 - cur.shape[1])))
    return policy.arrays, batch


def _assert_lanes(got, want, what):
    assert set(got) == set(OUTPUT_LANES) == set(want)
    for lane in OUTPUT_LANES:
        a, b = np.asarray(want[lane]), np.asarray(got[lane])
        assert (a.shape, a.dtype) == (b.shape, b.dtype), (what, lane)
        np.testing.assert_array_equal(b, a, f"{what}: lane {lane!r}")


@pytest.mark.parametrize("n", NS)
def test_ep_verdict_step_ten_lanes_one_all_to_all(worlds, n):
    from cilium_tpu.parallel.ulysses import (
        make_ep_verdict_step,
        stage_ep_arrays,
        stage_replicated,
    )

    arrays, batch = _small()
    mesh = make_mesh((n,), ("expert",), jax.devices()[:n])
    a = stage_ep_arrays(arrays, mesh, "expert")
    b = stage_replicated(batch, mesh)
    ref, rows = _fresh_reference(
        lambda: make_ep_verdict_step(mesh, a, b, "expert")(a, b))
    res = worlds[n].run(run_lane, "ep", {"arrays": arrays, "batch": batch},
                        device="cpu")
    _assert_lanes(res[0]["out"], ref, f"ep n={n}")
    _same_ledger(res, rows)
    assert [(r["site"], r["op"], r["count_per_block"]) for r in rows] == \
        [("ulysses.switch", "all_to_all", 1)]


@pytest.mark.parametrize("n", NS)
def test_cp_scan_match_straddles_the_rank_boundary(worlds, n):
    from cilium_tpu.parallel.cp import dfa_scan_banked_cp

    arrs = _stacked([".*attack-signature.*"], 1)
    L = 1024
    shard = L // n
    rng = np.random.default_rng(0)
    data = rng.integers(97, 123, size=(4, L), dtype=np.uint8)
    sig = np.frombuffer(b"attack-signature", dtype=np.uint8)
    cut = (n // 2) * shard
    data[0, cut - 8:cut + 8] = sig        # centred on a rank boundary
    data[1, 10:26] = sig
    data[2, L - 16:] = sig
    lengths = np.full((4,), L, dtype=np.int32)
    g = {k: arrs[k] for k in ("trans", "byteclass", "start", "accept")}
    mesh = make_mesh((n,), ("seq",), jax.devices()[:n])
    ref, rows = _fresh_reference(lambda: dfa_scan_banked_cp(
        mesh, *(jnp.asarray(g[k]) for k in
                ("trans", "byteclass", "start", "accept")),
        jnp.asarray(data), jnp.asarray(lengths), block=64))
    res = worlds[n].run(run_lane, "cp_scan",
                        {**g, "data": data, "lengths": lengths}, cp_block=64,
                        device="cpu")
    got = _words(res[0]["out"])
    np.testing.assert_array_equal(got, ref)
    assert got[0].any(), "straddling match lost at the carry boundary"
    assert got[1].any() and got[2].any() and not got[3].any()
    _same_ledger(res, rows)
    assert [(r["site"], r["count_per_block"]) for r in rows] == \
        [("cp.carry_exchange", 1)]


@pytest.mark.parametrize("n", NS)
def test_cp_verdict_step_on_the_widened_batch(worlds, n):
    from cilium_tpu.parallel.cp import (
        cp_shard_batch,
        cp_sharded_keys,
        make_cp_verdict_step,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cilium_tpu.engine.verdict import verdict_step

    arrays, batch = _small(widen=True)
    mesh = make_mesh((n,), ("seq",), jax.devices()[:n])
    skeys = cp_sharded_keys(batch, mesh)
    assert "path_data" in skeys and "headers_data" in skeys
    a = {k: jax.device_put(v, NamedSharding(mesh, P()))
         for k, v in arrays.items()}
    # an inner block of 8 divides every sharded field's columns a rank
    # (the 32-byte host and qname buckets shard in 8 at n = 4), where
    # the reference's CP is exact
    ref, rows = _fresh_reference(
        lambda: make_cp_verdict_step(mesh, batch, block=8)(
            a, cp_shard_batch(batch, mesh)))
    inputs = {"arrays": arrays, "batch": batch}
    res = worlds[n].run(run_lane, "cp", inputs, cp_block=8, device="cpu")
    _assert_lanes(res[0]["out"], ref, f"cp n={n}")
    _same_ledger(res, rows)
    # at the default block of 256 too, the port equals the single-device
    # step (the reference's CP does not, where 256 leaves padding in a
    # shard: test_reference_cp_consumes_its_padding_...)
    single = jax.jit(verdict_step)(arrays, batch)
    res = worlds[n].run(run_lane, "cp", inputs, device="cpu")
    _assert_lanes(res[0]["out"], {k: np.asarray(v) for k, v in single.items()},
                  f"cp n={n} block 256")
    assert len(rows) == len(skeys)
    assert all(r["site"].startswith("cp.carry.") and r["op"] == "all_gather"
               and r["count_per_block"] == 1 for r in rows)


@pytest.mark.parametrize("n", NS)
def test_payload_scan_cp_on_the_patterns_bank(worlds, n):
    from cilium_tpu.engine.dfa_kernel import dfa_scan
    from cilium_tpu.engine.longscan import payload_scan_cp

    bank = compile_patterns(LONG_PATTERNS, bank_size=8).banks[0]
    rng = np.random.default_rng(0)
    L, B = 2048, 16
    data = rng.integers(97, 123, size=(B, L), dtype=np.uint8)
    data[0, 100:116] = np.frombuffer(b"attack-signature", dtype=np.uint8)
    data[1, L - 30:L - 19] = np.frombuffer(b"POST /evil!", dtype=np.uint8)
    data[2, 5:12] = np.frombuffer(b"xx123yy", dtype=np.uint8)
    lengths = rng.integers(L // 2, L, size=(B,)).astype(np.int32)
    lengths[:3] = L
    trans, bc = np.asarray(bank.trans), np.asarray(bank.byteclass)
    mesh = make_mesh((n,), ("seq",), jax.devices()[:n])
    ref, rows = _fresh_reference(lambda: payload_scan_cp(
        mesh, jnp.asarray(trans), jnp.asarray(bc), bank.start,
        jnp.asarray(data), jnp.asarray(lengths), seq_axis="seq", block=64))
    seq = np.asarray(dfa_scan(jnp.asarray(trans), jnp.asarray(bc),
                              jnp.int32(bank.start), jnp.asarray(data),
                              jnp.asarray(lengths), impl="gather"))
    np.testing.assert_array_equal(ref, seq)
    res = worlds[n].run(run_lane, "payload_cp", {
        "trans": trans, "byteclass": bc, "start": int(bank.start),
        "data": data, "lengths": lengths}, cp_block=64, device="cpu")
    np.testing.assert_array_equal(res[0]["out"], ref)
    _same_ledger(res, rows)
    assert {r["site"]: r["count_per_block"] for r in rows} == \
        {"cp.ring_carry": n - 1, "cp.final_gather": 1}


def test_hypothesis_cp_random_banks_payloads(worlds):
    """Random bank shapes × payload lengths × worlds × inner blocks: the
    port's payload-sharded scan equals the single-device
    ``dfa_scan_banked``, lengths inside any shard included (the
    reference's own property, held against its sequential scan)."""
    from hypothesis import given, settings, strategies as st

    POOL = ["/api/v[0-9]+", "/health", "GET", "foo.*bar", "abc",
            "x+y", ".*sig.*", "[a-d]{2}z"]

    @settings(max_examples=6, deadline=None)
    @given(st.tuples(
        st.integers(1, 255),              # payload length
        st.sampled_from(NS),              # world
        st.integers(1, 3),                # bank size
        st.lists(st.sampled_from(POOL), min_size=1, max_size=6,
                 unique=True),
        st.integers(0, 2 ** 31 - 1),      # data seed
        st.integers(8, 64)))              # inner block
    def prop(args):
        L, n, bank_size, pats, seed, block = args
        arrs = _stacked(pats, bank_size)
        rng = np.random.default_rng(seed)
        data = rng.integers(0, 256, size=(4, L), dtype=np.uint8)
        lengths = rng.integers(0, L + 1, size=(4,)).astype(np.int32)
        ref = np.asarray(dfa_scan_banked(
            jnp.asarray(arrs["trans"]), jnp.asarray(arrs["byteclass"]),
            jnp.asarray(arrs["start"]), jnp.asarray(arrs["accept"]),
            jnp.asarray(data), jnp.asarray(lengths)))
        g = {k: arrs[k] for k in ("trans", "byteclass", "start", "accept")}
        res = worlds[n].run(run_lane, "cp_scan",
                            {**g, "data": data, "lengths": lengths},
                            cp_block=block, device="cpu")
        np.testing.assert_array_equal(_words(res[0]["out"]), ref)

    prop()


def test_ep_batch_must_divide_axis():
    """B not divisible by the expert axis is a loud staging error in
    both packages, not silent wrong verdicts."""
    from cilium_tpu.parallel.ulysses import (
        make_ep_verdict_step as ref_step,
        stage_ep_arrays as ref_arrays,
        stage_replicated as ref_batch,
    )
    from cilium_tpu_torch.parallel.mesh import Mesh
    from cilium_tpu_torch.parallel.ulysses import (
        make_ep_verdict_step,
        stage_ep_arrays,
        stage_replicated,
    )

    arrays, batch = _small()
    odd = {k: v[:61] for k, v in batch.items()}
    rmesh = make_mesh((4,), ("expert",), jax.devices()[:4])
    with pytest.raises(ValueError, match="divisible"):
        ref_step(rmesh, ref_arrays(arrays, rmesh, "expert"),
                 ref_batch(odd, rmesh), "expert")
    # rank 0's view of a 4-rank mesh: the check runs before any
    # collective, so no world is needed
    mesh = Mesh(np.arange(4), ("expert",), {}, 0, "gloo",
                torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible"):
        make_ep_verdict_step(mesh, stage_ep_arrays(arrays, mesh, "expert"),
                             stage_replicated(odd, mesh), "expert")


def test_reference_cp_consumes_its_padding_where_the_block_does_not_divide(
        worlds):
    """A difference from the reference, stated: where the inner block
    does not divide a shard, the reference's CP scan consumes the
    shard's zero padding as bytes of rows longer than the shard
    (``cilium_tpu/parallel/cp.py:80-86``) and differs from its own
    single-device scan; the port's equals the single-device scan."""
    from cilium_tpu.parallel.cp import dfa_scan_banked_cp

    rng = np.random.default_rng(0)
    NB, S, K, W = 4, 13, 7, 2
    g = {"trans": rng.integers(0, S, (NB, S, K)).astype(np.int32),
         "byteclass": rng.integers(0, K, (NB, 256)).astype(np.int32),
         "start": rng.integers(0, S, NB).astype(np.int32),
         "accept": rng.integers(0, 2 ** 32, (NB, S, W), dtype=np.uint64)
         .astype(np.uint32),
         "data": rng.integers(0, 256, (16, 24)).astype(np.uint8),
         "lengths": rng.integers(13, 25, 16).astype(np.int32)}
    args = [jnp.asarray(g[k]) for k in
            ("trans", "byteclass", "start", "accept", "data", "lengths")]
    single = np.asarray(dfa_scan_banked(*args))
    res = worlds[2].run(run_lane, "cp_scan", g, cp_block=8, device="cpu")
    np.testing.assert_array_equal(_words(res[0]["out"]), single)
    mesh = make_mesh((2,), ("seq",), jax.devices()[:2])
    ref = np.asarray(dfa_scan_banked_cp(mesh, *args, block=8))
    assert not np.array_equal(ref, single)     # 12 columns a rank
