"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero before the result line):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the hand-written kernels (KD, K1, K2) from
   ``cilium_tpu_torch/engine/csrc`` — one nvcc per source, in parallel —
   and check in their SASS (``cuobjdump``) that every instantiation of
   K1 and K2 issues tensor-core instructions (HMMA, HGMMA) and that
   KD's shared-memory instantiations stage with the bulk copy on an
   mbarrier and read the table with shared loads;
3. kernel phase: each kernel against its plain PyTorch version on the
   card, exactly, on random banks (0/1/128 positions, 128 states,
   zero-length rows, batches that are not a multiple of the block), on
   the tile edges of the tensor-core kernels K1 and K2 (with random,
   all-zero and all-full lengths), on KD's edges (both variants, a bank
   over the shared-memory budget included; L from 1 to 1024; B around
   one CTA; W in 1, 3, 4 with and without the extra plane; finals only;
   a column slice of a wider blob at an odd offset; negative and
   past-L lengths) and on the http-1000 policy's own banks; then K2 and K1 timed at the http-1000 host shape on
   random bytes and on one repeated byte at full length: their times
   must agree within 1.25x (the data-oblivious property of the
   reference kernels);
4. main path: the http scenario at 1000 rules x 10000 flows, bank size
   128, batches of 8192, under ``auto``, ``nfa-bitset`` and the
   oblivious DFA. Each configuration is verdicted once with every
   launch count set to 0 just before and read just after (a kernel of
   the configuration's path that never launched fails the run); all ten
   output lanes are held equal to the port's plain-version path
   (``device="cpu"``) on the same batches; the verdict mix must be a
   plausible allow/deny split; then the median batch time over 25
   timed batches after warm-up, and each kernel's time for one launch
   at the shapes of every field it scans. The http-1000 path bank must
   have run KD's shared-memory variant, phase 3's over-budget banks its
   global one (launch counts by variant);
5. capture replay: the scenario's 10000 flows repeated to a
   200000-record v2 capture, written with the port's writer into a
   temporary directory and read back with its reader; under the gather
   arm (KD) and the oblivious arm (K2, the path table on KD with the
   reference's warning), three routes — the device verdict memo
   (``stage_rows``, ``stage_unique``, ``stage_unique_device``,
   ``stage_verdict_memo``, chunks of 65536 by ``verdict_idx``), the id
   stream without the memo, and the row stream — all ten lanes equal
   to each other and to the fused step on the same flows in capture
   order, the memo's fill equal to the plain path's on the unique
   rows; launch counts zeroed before and read after each arm; the
   staging split, unique rows, median chunk latency with forced
   completion and rows/s of each route (median of 5 windows). Then the
   same records made unique (the high-cardinality capture): the dedup
   declines, KD scans a ~200k-row path table, the rows stream, and an
   8192-row sample equals the plain path;
6. legacy step: ``kernel_impl="legacy"``, a policy whose resolve plan
   degenerated (``GROUP_CAP`` = 1) and ``verdict_flows_blob`` on the
   http-1000 batches against the fused step; the legacy step's batch
   median and device kernels per batch beside the fused step's, and the
   blob route's device kernels per batch (KD reads its byte fields and
   length columns in place);
7. online serving: the port's ``ServeLoop`` over the ``auto`` engine
   with 1024 leased streams, driven inline by ``step()``. Cold: the
   10000 flows in chunks of 64 spread over the leases, one pack, with
   provenance; verdict, ``l7_match`` and ``match_spec`` equal to the
   engine's direct ``verdict_flows`` and every attribution code
   resolving. Warm: the flows repeated to 200000 records, waves of one
   chunk a lease, ``step()`` until drained: zero memo misses and 4 bytes
   shipped a record; median pack ms, records per pack, records/s, and
   a separate traced pack's kernels, device ms and busy share (device
   over wall ms of that one traced pack). A sample of the warm traffic
   through a ring over the plain (CPU) engine equals the card's lanes.
   Growth: unique paths across the session's string cap: one reset,
   the chunk encoded before it resolves ``session-reset`` and serves
   when resubmitted; the delta-scan shapes the session launches KD at
   are noted. Thread: ``start()`` against eight submitter threads for
   a few seconds, then ``stop()``; every verdict equal, KD launched
   from the pack thread. The launch counts cover these serving passes
   alone; after they are read, KD is held against its plain version
   and timed at every growth shape that phase 3 lacks. A
   ``serve: {...}`` line carries the numbers;
8. the loader plane: the http-1000 policy built by the port's
   ``Loader`` with its defaults (gate on, content-addressed banks, two
   compile workers, a temporary cache directory): the cold build's
   compile and stage seconds, bank plan, path stack (7, 2048, 28) and
   KD's launch plan for it; the fused step over the 10000 flows on the
   loader's engine, all ten lanes equal to the plain engine of the same
   policy, and its batch median; then a ``ServeLoop`` over the loader
   serves the corpus (and 2000 L4-only records) while 20 committed
   updates add and delete one path rule on the server in turn: after
   each, zero stale verdicts against the plain engine of the committed
   snapshot (and, after every delete and the last add, against the CPU
   oracle on a 500-flow sample, computed in worker processes during
   phases 2-7), 1-3 bank compiles an add and none a delete (the banks
   are content-addressed), memo misses exactly on the rows the delta
   names, and update-to-enforcement ms (regenerate to the first pack
   served under it). Then a rollback (the swap point injected once: the
   previous engine serves, the rollback is counted, the retry commits),
   a warm restart (a same-artifact restore keeps the memo; a fresh
   loader restores with zero bank compiles and equal lanes) and the
   canary (a dropped-rules rollout refused with the serving triple
   untouched, a clean one committed); every pass from the rollback on
   is held against the plain engine of the policy it serves. The
   counts cover the batch run and the serving passes; KD, and K1 under
   ``nfa-bitset``, are then held against their plain versions at the
   cold build's arrays and KD timed at its path stack, and KD held and
   timed again at the rollback retry's arrays (its pattern adds a byte
   class: the path stack that the rest of the phase ran, over KD's
   shared-memory budget, so under its global variant). A
   ``loader: {...}`` line carries the numbers;
9. the service and stream plane: a fresh ``Loader(Config())`` on the
   card (content-addressed banks, the http-1000 snapshot, a temporary
   cache directory) behind the port's ``VerdictService`` on a Unix
   socket in a temporary directory, ``bench_service.py``'s defaults
   (micro-batches of up to 256, 2 ms deadline). Every verdict is held
   against a ``device="cpu"`` engine of the policy it was served under.
   ``check`` in a closed loop (16 clients x 50 requests at deadlines
   0.5, 2 and 8 ms, and three times with four drain workers: client
   p50/p99, requests/s, the micro-batch size histogram and mean
   micro-batch time); the bulk ``verdict`` op (256 flows, median of
   25); a stream of the 10000 flows repeated to 200000 records in
   chunks of 4096 at pipeline depth 8 (records/s, chunk p50/p99; every
   chunk through the private incremental session, none through the
   oracle), then depth 1 for 50 chunks with the credit window full,
   and 50 chunks one at a time (the client waits for each verdict
   before it sends the next: nothing overlaps); the same
   records over eight concurrent streams through the serve loop's ring;
   a hot swap mid-stream (a committed ``/churn0/.*`` rule: zero stale
   verdicts, the session consumes the bank delta without a reset);
   Kafka through proxylib (a second loader at ``bench.py``'s 1000 Kafka
   rules, 1000 ``on_data`` round trips of frames from
   ``proxylib.kafka.encode_request``, each PASS/DROP equal to the plain
   engine's verdict); the breaker (the engine's dispatch fault armed
   three times: one trip, eight checks answered by the oracle while
   open, one probe after 0.2 s recovers and KD launches again); and a
   drain (pending checks flushed, warm snapshot, ``ping`` answers). The
   breaker's counters stay at zero outside its pass, and KD's count
   rises in every device pass. KD is then held against its plain
   version and timed at the micro-batcher's B = 1 and 256 and at the
   stream session's first delta scan. A ``service: {...}`` line
   carries the numbers;
10. the cluster-mesh lanes, each through the port's entry points in a
   spawned process of its own, one after another (each reads its own
   peak RSS and launch counts): the churn storm (``runtime/fleet.run``
   at 10000 identities x 5000 CNPs, 200 classes, through the port's
   ``Loader``, its capture-replay session bit-equal to the serving
   engine after every update, to the CPU oracle on sampled updates and
   to a ``device="cpu"`` engine after the cold build and every tenth
   update, with the probe of every churned rule so far, added or
   deleted, replayed through a session on the card beside the corpus;
   compiles per update within 1.1 x 0.929; update to
   enforcement p50/p99 ms), the serve soak (``runtime/loadmodel`` at
   100000 virtual streams, the pack thread under an autojumping
   virtual clock, seeded serve faults, a fifth of its chunks
   cassandra, memcache and r2d2 records (``protocol_mix`` 0.2, the
   reference lane's); zero violations, concurrency >= 95 %) and the serving fleet (``runtime/fleetserve`` at 1050000
   streams over four replicas, one loader each, with a host killed,
   one partitioned, one drained and all rejoined warm: zero
   violations, zero unrecovered streams, zero survivor and rejoin
   compiles, explain coverage 1.0). The soak's and the fleet's pools
   of ground truth are held against a ``device="cpu"`` engine; their
   p50/p99 are virtual (the 50 ms pack interval on the simulation
   clock), printed as such beside the wall seconds, records per wall
   second and a traced pack's device kernels and ms. Then KD is held
   against its plain version at the storm's path stack (30, 2816, 18)
   at its corpus's B and the soak's mean pack, under both variants,
   and timed. A ``fleet: {...}`` line carries the numbers;
11. the protocol-frontend lanes: ``bench_protocols.py``'s throughput
   leg at its published settings (cassandra, memcache and r2d2 at 40
   rules x 120000 flows, protocols at 120 x 200000, http at 200 x
   120000), each through the port's ``Loader`` on the card (compile
   s), ``flows_to_columns`` (a v3 capture image: the GENERIC section),
   ``CaptureReplay(..., gen=, loader=)`` with ``stage_rows`` and
   ``stage_unique`` (stage ms), one whole-capture ``verdict_chunk``
   to fill the memo and three timed ones (verdicts/s, memo hit ratio,
   allow fraction): every lane of the output equal to a
   ``device="cpu"`` engine's replay, 512 flows equal to the CPU
   oracle, no ``ERROR``. Then the protocols policy (and the memcache
   one, whose ``l7g`` stack K1 and K2 take) as fused batches of 8192
   under ``auto``, ``nfa-bitset`` and the oblivious DFA (each batch's
   ten lanes equal to the plain engine; batch median, device kernels
   and busy share as in phase 4); the generic pair path (a
   ``test.lineparser`` policy, proxy-only, so off ``l7g``: fused step
   and capture replay against the plain engine); proxylib on the card
   (a ``VerdictService`` on the protocols loader, 200 ``on_data``
   round trips each of r2d2, memcache and cassandra frames, each
   PASS/DROP equal to the plain engine's verdict; p50/p99). Launch
   counts are zeroed before and read after each pass. Then KD, and K2
   and K1 wherever they take it, held exactly against their plain
   versions at each frontend policy's ``l7g`` stack and at its lane
   capture's ``l7g`` table, and timed, each stack's (NB, S, K) and L
   printed; each fused arm's ``impl_plan["l7g"]`` is checked against
   the arm's rule. A ``proto: {...}`` line carries the numbers;
12. one JSON line ``{"kernels": [...]}``, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

The kernel phase (3) also holds KD and K2 at the capture tables'
shapes (each field's largest table over the two captures, at the
capture's widths), on a synthetic L = 1024 batch, and KD at the
incremental session's delta shapes (``SESSION_DELTAS``), and the
per-kernel times cover those shapes.

It imports nothing of JAX. Run it from the root of a checkout: it
imports ``cilium_tpu_torch`` from the directory it lives in.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
import warnings

N_RULES, N_FLOWS, BATCH, BANK_SIZE = 1000, 10000, 8192, 128
DEVICE = "cuda"
TIMED_BATCHES, WARMUP = 25, 3
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and float32 outside
#: the tensor cores, which is the rate this file counts the kernels'
#: 32-bit integer/bit ops at
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12
#: and the dense int8 tensor-core peak, the lowest tensor-core bound of
#: the one-hot products K1 and K2 compute (their operands are exact in
#: int8)
TENSOR_INT8_OPS_PER_S = 1979e12
#: input-independence: the largest ratio allowed between K1's or K2's
#: times on two batches of one shape
TIMING_RATIO_MAX = 1.25
#: what the operation count of each kernel's bound counts
#: what the byte count of each kernel's bound counts (and the outputs)
BOUND_BYTES = {
    "KD": "the live flow bytes, the class tables, each transition entry "
          "the scan reads and the accept rows of its final states, once",
    "K1": "the live flow bytes and every table, once",
    "K2": "the live flow bytes and every table, once",
}
BOUND_OPS = {
    "KD": "2 per live byte and bank (one transition), non-tensor peak",
    "K1": "2*NB*B*(L-1)*P*P (D . Follow), int8 tensor-core peak",
    "K2": "2*NB*B*L*S*(K+1) (onehot(state) . table), int8 tensor-core "
          "peak",
}
#: phase 5: capture size and replay chunk (the reference benchmark's
#: ``--capture-flows`` and ``--replay-chunk`` defaults)
CAPTURE_RECORDS, REPLAY_CHUNK = 200_000, 65_536
#: phase 5: chunk-latency samples, target seconds of one throughput
#: window, and the high-cardinality pass's sample checked on the CPU
LATENCY_SAMPLES, WINDOW_S, HC_SAMPLE = 20, 0.25, 8192
#: the capture-staging phases of ``cilium_tpu_capture_stage_seconds``
STAGE_PHASES = ("tables", "featurize", "dedup", "table-h2d", "memo-fill")
#: phase 3: the incremental session's delta scans (KD, accept words
#: only) — field prefix → (B, L): a delta padded to at least 256 rows at
#: the session's field widths, and the path delta of one flush at the
#: string cap (``engine/session.py``)
SESSION_DELTAS = [("path", 256, 256), ("path", 131072, 256),
                  ("hdr", 256, 1024), ("method", 256, 16),
                  ("host", 256, 128), ("dns", 256, 256)]
#: phase 7: leased streams (the serve loop's default ring capacity) and
#: records per chunk; the warm pass's records (phase 5's capture size);
#: the string cap the growth pass crosses (the session's MAX_STRINGS);
#: the plain-path sample; the thread pass's submitters and seconds
SERVE_STREAMS, SERVE_CHUNK = 1024, 64
SERVE_WARM_RECORDS = CAPTURE_RECORDS
GROWTH_MAX_STRINGS = 1 << 16
#: growth pass: records per unique path, so that the records up to the
#: cap outnumber one pack's PACK_MAX (``engine/ring.py``)
GROWTH_REPEAT = 4
SERVE_PLAIN_SAMPLE, SERVE_THREADS, SERVE_THREAD_S = 2048, 8, 3.0
#: phase 8: committed updates of the churn pass (adding and deleting one
#: path rule on the server in turn), the L4-only records served beside
#: the corpus (rows no churn may refill), the oracle's sample of the
#: corpus and its worker processes, and the canary's sample floor and
#: the rules its dropped-rules snapshot keeps
LOADER_UPDATES, BYSTANDERS = 20, 2000
ORACLE_SAMPLE, ORACLE_WORKERS = 500, 4
CANARY_MIN_SAMPLES, CANARY_KEEP_RULES = 32, 100
#: phase 9: the verdict service at ``bench_service.py``'s defaults — the
#: micro-batcher's bound and deadline, the closed loop's client threads,
#: timed and warm requests a thread and its deadlines, the passes with
#: four drain workers; the stream's chunk and pipeline depth; the bulk
#: ``verdict`` op's flows a request and timed requests; the stream's
#: records (phase 5's capture size); the depth-1 and one-at-a-time
#: passes' chunks; the serve loop's concurrent streams; the hot
#: swap's chunks either side of the commit; the Kafka scenario's rules
#: (``bench.py``'s default) and its on_data round trips over concurrent
#: clients; the checks answered while the breaker is open and its probe
#: interval; and the drain pass's pending checks, held by a long deadline
SVC_BATCH_MAX, SVC_DEADLINE_MS = 256, 2.0
CHECK_THREADS, CHECK_PER_THREAD, CHECK_WARMUP = 16, 50, 10
CHECK_DEADLINES_MS = (0.5, 2.0, 8.0)
DW4_REPEATS = 3
STREAM_CHUNK, STREAM_DEPTH = 4096, 8
BULK_FLOWS, BULK_TIMED = 256, 25
STREAM_RECORDS, DEPTH1_CHUNKS = CAPTURE_RECORDS, 50
RING_CLIENTS, SWAP_CHUNKS = 8, 10
KAFKA_RULES, KAFKA_ROUND_TRIPS, KAFKA_CLIENTS = 1000, 1000, 8
BREAKER_OPEN_CHECKS, BREAKER_PROBE_S = 8, 0.2
DRAIN_PENDING, DRAIN_DEADLINE_MS = 16, 2000.0
#: phase 10: the cluster-mesh lanes at the reference's lane settings
#: (``make churn-fleet``, ``serve-soak``, ``serve-fleet``): the churn
#: storm's identities, CNPs, committed updates and compile workers; the
#: soak's streams, virtual seconds and armed serve faults; the fleet's
#: streams, hosts, virtual seconds, emitting fraction, armed heartbeat
#: and handoff faults and its handoff floor; and the time the three
#: lanes, run one after another, may take in all. To keep the three,
#: run in turn, near 300 s of wall, the soak's virtual seconds are cut
#: from the reference's 120 to 60 (every stream still arrives within
#: the 30 s ramp) and the storm's updates from 56 to 28. The fleet keeps
#: its 120: its wall is its 1.05M arrivals, which fewer virtual seconds
#: barely shorten, and at 60 its failover replays all but vanish
CHURN_IDENTITIES, CHURN_CNPS, CHURN_UPDATES, CHURN_WORKERS = \
    10_000, 5_000, 28, 4
SOAK_STREAMS, SOAK_VIRTUAL_S, SOAK_FAULTS = 100_000, 60.0, 12
FLEET_STREAMS, FLEET_HOSTS, FLEET_VIRTUAL_S = 1_050_000, 4, 120.0
FLEET_ACTIVE, FLEET_FAULTS, FLEET_MIN_HANDOFFS = 0.02, 8, 400
LANE_TIMEOUT_S = 600.0
#: phase 10: the soak's protocol mix (the reference lane's default): the
#: fraction of pool chunks carrying cassandra, memcache and r2d2 records
SOAK_PROTOCOL_MIX = 0.2
#: phase 11: ``bench_protocols.py``'s per-protocol throughput lanes at
#: its published settings (``PROTO_LANES``, not cut): (scenario, rules,
#: flows); the timed repetitions of a lane's whole capture and the CPU
#: oracle's sample; the batches of BATCH each fused arm runs and holds;
#: the generic pair path's test.lineparser rules and records; proxylib's
#: on_data round trips a frontend and their concurrent clients
PROTO_LANES = (("cassandra", 40, 120000), ("memcache", 40, 120000),
               ("r2d2", 40, 120000), ("protocols", 120, 200000),
               ("http", 200, 120000))
PROTO_REPS, PROTO_ORACLE_SAMPLE = 3, 512
PROTO_FUSED_BATCHES = 4
PAIR_RULES, PAIR_FLOWS = 40, 20000
ON_DATA_TRIPS, ON_DATA_CLIENTS = 200, 8
#: phase 11's fused arms: arm → (kernel_impl, CILIUM_TPU_DFA_IMPL)
PROTO_ARMS = {"auto": ("auto", "gather"),
              "nfa-bitset": ("nfa-bitset", "gather"),
              "oblivious-dfa": ("auto", "pallas")}
#: capture arm → (phase-4 configuration it replays on, kernels it must
#: launch)
CAPTURE_ARMS = {"gather": ("auto", ("KD",)),
                "oblivious": ("oblivious-dfa", ("KD", "K2"))}
#: configuration → (kernel_impl, CILIUM_TPU_DFA_IMPL, kernels its path
#: launches)
CONFIGS = {
    "auto": ("auto", "gather", ("KD",)),
    "nfa-bitset": ("nfa-bitset", "gather", ("KD", "K1")),
    "oblivious-dfa": ("auto", "pallas", ("KD", "K2")),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- timing
def time_launch(fn, reps: int = 20, warmup: int = 2) -> float:
    """ms per call, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def launch_ms(fn) -> float:
    """Device ms of one call, by CUDA events. A spin kernel keeps the
    stream busy while the host enqueues the call between the two events,
    so the wrapper's host time is not counted."""
    import torch

    torch.cuda._sleep(1_000_000)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1)


def profile_kernels(fn, reps: int):
    """Run ``fn`` ``reps`` times under torch.profiler → {kernel name:
    (launches, device ms)} over the device-side kernel events. Empty
    when the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        out[e.key] = (e.count, us / 1e3)
    return out


def queued_event_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` (one kernel launch) by CUDA
    events: the launches and their events are queued behind a sleep
    kernel, so each event pair brackets the kernel alone and none of
    the host's time between launches; the median over ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)      # ~25 ms at 2 GHz
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_device_ms(fn, symbol: str, reps: int = 20, tries: int = 6):
    """Device time of one launch of the kernel whose symbol contains
    ``symbol`` (profiler). A trace now and then comes back with no
    device events at all; after ``tries`` such traces (each logged),
    :func:`queued_event_ms` times it instead."""
    for i in range(tries):
        seen = profile_kernels(fn, reps)
        hits = [(n, ms) for k, (n, ms) in seen.items() if symbol in k]
        if hits:
            return sum(h[1] for h in hits) / sum(h[0] for h in hits)
        log(f"  (trace {i + 1} of {tries} saw no {symbol}; its device "
            f"events: {sorted(seen)[:4]})")
    ms = queued_event_ms(fn, reps)
    log(f"  ({symbol}: device time by queued CUDA events, {ms:.5f} ms)")
    return ms


def bound(n_bytes: float, ops: float, ops_per_s: float = NON_TENSOR_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and ops
    over the given peak (default: outside the tensor cores)."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def kd_needed_bytes(a, accept, extra) -> int:
    """Bytes KD must read for this run's data: the class tables and
    start states, the live flow bytes (:func:`flow_bytes`), each
    transition-table entry the scan reads (distinct bank, state and
    class over the live bytes: at most ``min(S, B·L)`` rows a bank), and
    the accept-plane rows of the final states (distinct bank and state:
    at most ``min(S, B)`` rows a bank), each once."""
    import torch

    trans, byteclass, start, data, lens = a
    NB, S, K = trans.shape
    B, L = data.shape
    dev = trans.device
    flat = trans.reshape(-1).long()
    base = (torch.arange(NB, device=dev) * (S * K))[:, None]
    states = start.long()[:, None].expand(NB, B)
    live = lens.long()[None, :]
    seen = torch.zeros(NB * S * K, dtype=torch.bool, device=dev)
    for t in range(L):
        idx = base + states * K + byteclass.long()[:, data[:, t].long()]
        on = (t < live).expand(NB, B)
        seen[idx[on]] = True
        states = torch.where(on, flat[idx], states)
    finals = torch.unique(base // K + states).numel()
    planes = sum(p.shape[2] * p.element_size() for p in (accept, extra)
                 if p is not None)
    return (int(seen.sum()) * trans.element_size() + finals * planes
            + nbytes(byteclass, start) + flow_bytes(data, lens))


def flow_bytes(data, lens) -> int:
    """Bytes a scan must read of a batch: the lengths, and each flow's
    first ``min(length, L)`` bytes (the padding past a flow's length is
    never read)."""
    live = int(lens.clamp(0, data.shape[1]).sum())
    return live * data.element_size() + nbytes(lens)


# ---------------------------------------------------------- kernel phase
#: (NB, S, K, B, L) and (NB, P, K, B, L) tile-edge cases of K2 and K1
K2_EDGES = [(1, 1, 1, 1, 1), (2, 16, 255, 15, 33), (1, 17, 256, 17, 1),
            (3, 128, 256, 65, 33), (1, 128, 255, 8193, 33),
            (2, 16, 1, 8193, 1), (1, 40, 7, 100, 300)]
K1_EDGES = [(1, 1, 1, 1, 1), (2, 16, 256, 15, 33), (1, 17, 1, 17, 33),
            (3, 128, 256, 65, 1), (1, 128, 1, 8193, 33),
            (2, 17, 256, 8193, 1), (1, 40, 7, 100, 300)]
#: (NB, S, K, B, L) edge cases of KD: B below one CTA's 512 flows, one
#: past it and 8193; L on and off the 16-byte load, past a chunk, 300
#: and 1024; banks over the shared-memory budget (S = 8192, K = 256:
#: 8 MB) take the global variant
KD_EDGES = [(1, 1, 1, 1, 1), (2, 17, 5, 511, 15), (3, 40, 7, 513, 16),
            (2, 128, 31, 8193, 17), (1, 300, 20, 100, 33),
            (2, 768, 31, 1000, 300), (1, 74, 16, 512, 1024),
            (1, 8192, 256, 8193, 33), (2, 8192, 256, 513, 1024)]
#: KD's lengths cases: random in [-3, L + 4], all zero, all L, negative,
#: past L
KD_LENGTHS = ("random", "zero", "full", "negative", "over")

def max_err(a, b) -> float:
    """Largest absolute difference; the kernels are exact, so 0."""
    import torch

    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"shape/dtype mismatch {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if not a.is_floating_point() else float((a - b).abs().max())


def hold(errs, kid, what, got, want):
    """Hold a kernel's result against its plain version's: exact, or
    fail; the largest error goes into ``errs``."""
    e = max_err(got, want)
    errs[kid] = max(errs.get(kid, 0.0), e)
    check(e == 0.0, f"{kid} disagrees with its plain version on "
                    f"{what}: max abs err {e}")
    log(f"  {kid} {what}: exact")


def session_check(errs, session_inputs):
    """KD against its plain version at the incremental session's delta
    scans: accept words only."""
    from cilium_tpu_torch.engine import dfa_dense_cuda

    for label, (prefix, arrays, data, lens) in session_inputs.items():
        a = (arrays[f"{prefix}_trans"], arrays[f"{prefix}_byteclass"],
             arrays[f"{prefix}_start"], data, lens)
        acc = arrays[f"{prefix}_accept"]
        hold(errs, "KD", f"{label} {tuple(a[0].shape)} B={data.shape[0]} "
                         f"L={data.shape[1]}",
             dfa_dense_cuda.dense_scan_cuda(*a, accept=acc),
             dfa_dense_cuda.dense_scan_plain(*a, accept=acc))


def kernel_phase(errs, field_inputs, capture_inputs, session_inputs):
    """Every kernel against its plain version on the card, exactly."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine import (
        dfa_dense_cuda,
        dfa_oblivious_cuda,
        nfa_cuda,
    )

    rng = np.random.default_rng(0)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    def flows(b, l):
        data = rng.integers(0, 256, (b, l)).astype(np.uint8)
        lens = rng.integers(0, l + 1, (b,)).astype(np.int32)
        lens[:3] = 0                                   # zero-length rows
        return T(data), T(lens)

    def record(kid, what, got, want):
        hold(errs, kid, what, got, want)

    for nb, s, k, w, b, l in [(1, 2, 1, 1, 7, 4), (3, 17, 5, 2, 50, 12),
                              (2, 128, 31, 1, 300, 9),
                              (8, 768, 31, 4, 1000, 32)]:
        trans = T(rng.integers(0, s, (nb, s, k)).astype(np.int32))
        bc = T(rng.integers(0, k, (nb, 256)).astype(np.int32))
        start = T(rng.integers(0, s, (nb,)).astype(np.int32))
        acc = T(rng.integers(-2 ** 31, 2 ** 31 - 1, (nb, s, w),
                             dtype=np.int64).astype(np.int32))
        data, lens = flows(b, l)
        args = (trans, bc, start, data, lens)
        what = f"random NB={nb} S={s} K={k} B={b} L={l}"
        record("KD", what + " words",
               dfa_dense_cuda.dense_scan_cuda(*args, accept=acc, extra=acc),
               dfa_dense_cuda.dense_scan_plain(*args, accept=acc, extra=acc))
        record("KD", what + " finals", dfa_dense_cuda.dense_scan_cuda(*args),
               dfa_dense_cuda.dense_scan_plain(*args))
        if s <= 128:
            record("K2", what,
                   dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*args),
                   dfa_oblivious_cuda.dfa_finals_oblivious_plain(*args))
    kd_variants = kd_edges(T, rng, record)
    for nb, p, k, b, l in [(1, 1, 1, 7, 4), (2, 17, 5, 50, 12),
                           (3, 128, 13, 300, 9), (2, 33, 4, 129, 1),
                           (1, 64, 9, 257, 32)]:
        fol = T((rng.random((nb, p, p)) < 0.1).astype(np.float32))
        ac = T((rng.random((nb, p, k)) < 0.5).astype(np.float32))
        bc = T(rng.integers(0, k, (nb, 256)).astype(np.int32))
        st = T((rng.random((nb, p)) < 0.3).astype(np.float32))
        data, lens = flows(b, l)
        args = (fol, ac, bc, st, data, lens)
        record("K1", f"random NB={nb} P={p} K={k} B={b} L={l}",
               nfa_cuda.nfa_finals_cuda(*args),
               nfa_cuda.nfa_finals_plain(*args))
    # the tile edges of the tensor-core kernels: S or P off and on the
    # 16-row k-step, K + 1 off the 8-column n-tile, B below one warp's
    # 16 flows and past a CTA's 64, L = 1, 33 and past the 256-byte
    # staging chunk; random, all-zero and all-full lengths
    def length_cases(b, l):
        return [("random", T(rng.integers(0, l + 1, (b,)).astype(np.int32))),
                ("zero", T(np.zeros(b, np.int32))),
                ("full", T(np.full(b, l, np.int32)))]

    for nb, s, k, b, l in K2_EDGES:
        tables = (T(rng.integers(0, s, (nb, s, k)).astype(np.int32)),
                  T(rng.integers(0, k, (nb, 256)).astype(np.int32)),
                  T(rng.integers(0, s, (nb,)).astype(np.int32)))
        data = T(rng.integers(0, 256, (b, l)).astype(np.uint8))
        for name, lens in length_cases(b, l):
            args = (*tables, data, lens)
            record("K2", f"edge NB={nb} S={s} K={k} B={b} L={l} {name} "
                         f"lengths",
                   dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*args),
                   dfa_oblivious_cuda.dfa_finals_oblivious_plain(*args))
    for nb, p, k, b, l in K1_EDGES:
        tables = (T((rng.random((nb, p, p)) < 0.1).astype(np.float32)),
                  T((rng.random((nb, p, k)) < 0.5).astype(np.float32)),
                  T(rng.integers(0, k, (nb, 256)).astype(np.int32)),
                  T((rng.random((nb, p)) < 0.3).astype(np.float32)))
        data = T(rng.integers(0, 256, (b, l)).astype(np.uint8))
        for name, lens in length_cases(b, l):
            args = (*tables, data, lens)
            record("K1", f"edge NB={nb} P={p} K={k} B={b} L={l} {name} "
                         f"lengths",
                   nfa_cuda.nfa_finals_cuda(*args),
                   nfa_cuda.nfa_finals_plain(*args))
    # a 0-position bank: nothing to scan, the wrapper launches nothing
    z = nfa_cuda.nfa_finals_cuda(
        T(np.zeros((1, 0, 0), np.float32)), T(np.zeros((1, 0, 1),
                                                       np.float32)),
        T(np.zeros((1, 256), np.int32)), T(np.zeros((1, 0), np.float32)),
        *flows(5, 4))
    check(tuple(z.shape) == (1, 5, 0), "K1 P=0 shape")

    # the http-1000 policy's own banks, on its first batch
    for prefix, (arrays, data, lens) in field_inputs.items():
        a = (arrays[f"{prefix}_trans"], arrays[f"{prefix}_byteclass"],
             arrays[f"{prefix}_start"], data, lens)
        extra = arrays.get("rp_path_gaccept") if prefix == "path" else None
        acc = arrays[f"{prefix}_accept"]
        record("KD", f"http-1000 {prefix} {tuple(a[0].shape)}",
               dfa_dense_cuda.dense_scan_cuda(*a, accept=acc, extra=extra),
               dfa_dense_cuda.dense_scan_plain(*a, accept=acc, extra=extra))
        if a[0].shape[1] <= 128:
            record("K2", f"http-1000 {prefix} {tuple(a[0].shape)}",
                   dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*a),
                   dfa_oblivious_cuda.dfa_finals_oblivious_plain(*a))
        if f"{prefix}_nfa_follow" in arrays:
            n = [arrays[f"{prefix}_nfa_{k}"] for k in
                 ("follow", "acc_cls", "byteclass", "start")] + [data, lens]
            record("K1", f"http-1000 {prefix} P={n[0].shape[1]}",
                   nfa_cuda.nfa_finals_cuda(*n), nfa_cuda.nfa_finals_plain(*n))

    # the capture tables of phase 5 (the largest B of each field's
    # table, at the capture's widths) and a synthetic L = 1024 batch
    for label, (prefix, arrays, data, lens) in capture_inputs.items():
        a = (arrays[f"{prefix}_trans"], arrays[f"{prefix}_byteclass"],
             arrays[f"{prefix}_start"], data, lens)
        extra = arrays.get("rp_path_gaccept") if prefix == "path" else None
        acc = arrays[f"{prefix}_accept"]
        what = f"{label} {tuple(a[0].shape)} B={data.shape[0]} " \
               f"L={data.shape[1]}"
        record("KD", what,
               dfa_dense_cuda.dense_scan_cuda(*a, accept=acc, extra=extra),
               dfa_dense_cuda.dense_scan_plain(*a, accept=acc, extra=extra))
        if a[0].shape[1] <= 128:
            record("K2", what,
                   dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*a),
                   dfa_oblivious_cuda.dfa_finals_oblivious_plain(*a))
    session_check(errs, session_inputs)
    return kd_variants


def kd_edges(T, rng, record):
    """KD against its plain version on KD_EDGES: every lengths case of
    KD_LENGTHS with W in (1, 3, 4) and the extra plane on and off, a
    finals-only call, a data tensor that is a column slice of a wider
    u8 blob at an odd offset with its lengths a strided int32 column.
    Returns KD's launches by variant over these cases."""
    import numpy as np

    from cilium_tpu_torch.engine import _build, dfa_dense_cuda as kd

    def lens_of(case, b, l):
        return {"random": rng.integers(-3, l + 5, (b,)),
                "zero": np.zeros(b), "full": np.full(b, l),
                "negative": np.full(b, -7),
                "over": np.full(b, l + 9)}[case].astype(np.int32)

    _build.reset_launches()
    for nb, s, k, b, l in KD_EDGES:
        tables = (T(rng.integers(0, s, (nb, s, k)).astype(np.int32)),
                  T(rng.integers(0, k, (nb, 256)).astype(np.int32)),
                  T(rng.integers(0, s, (nb,)).astype(np.int32)))
        planes = {w: T(rng.integers(-2 ** 31, 2 ** 31 - 1, (nb, s, w),
                                    dtype=np.int64).astype(np.int32))
                  for w in (1, 3, 4)}
        data = T(rng.integers(0, 256, (b, l)).astype(np.uint8))
        plan = kd.plan_launch(nb, s, k, b, l)
        what = f"edge NB={nb} S={s} K={k} B={b} L={l} ({plan.variant})"
        for i, case in enumerate(KD_LENGTHS):
            args = (*tables, data, T(lens_of(case, b, l)))
            acc = planes[(1, 3, 4)[i % 3]]
            extra = planes[(4, 1, 3)[i % 3]] if i % 2 == 0 else None
            record("KD", f"{what} {case} lengths W={acc.shape[2]} "
                         f"extra={extra is not None}",
                   kd.dense_scan_cuda(*args, accept=acc, extra=extra),
                   kd.dense_scan_plain(*args, accept=acc, extra=extra))
        args = (*tables, data, T(lens_of("random", b, l)))
        record("KD", f"{what} finals", kd.dense_scan_cuda(*args),
               kd.dense_scan_plain(*args))
        blob = T(rng.integers(0, 256, (b, l + 9)).astype(np.uint8))
        cols = T(np.stack([lens_of("random", b, l)] * 3, axis=1))
        args = (*tables, blob[:, 3:3 + l], cols[:, 1])
        record("KD", f"{what} blob column slice at offset 3, strided "
                     f"lengths", kd.dense_scan_cuda(*args, accept=planes[4],
                                                    extra=planes[1]),
               kd.dense_scan_plain(*args, accept=planes[4], extra=planes[1]))
    variants = dict(kd.KERNEL.launches_by_variant)
    log(f"  KD edge cases: launches by variant {variants}")
    check(variants.get("global", 0) > 0 and variants.get("smem", 0) > 0,
          f"KD edge cases: both variants must launch ({variants})")
    return variants


def sass_kd():
    """KD's shared-memory instantiations stage the table with the bulk
    copy (UBLKCP) on an mbarrier (SYNCS) and read it with shared loads
    (LDS); the global ones issue no bulk copy. Returns {variant:
    {"UBLKCP": n, "LDS": n}} over the instantiations."""
    from cilium_tpu_torch.engine import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass",
                          _build.KERNELS["KD"].library_path()],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump KD: {out.stderr[-500:]}")
    counts = {}
    for f in out.stdout.split("Function : ")[1:]:
        name = f.splitlines()[0]
        if "dfa_dense_kernel" not in name:
            continue
        variant = "smem" if "ILb1E" in name else "global"
        c = {op: f.count(op) for op in ("UBLKCP", "SYNCS", "LDS")}
        if variant == "smem":
            check(c["UBLKCP"] > 0 and c["SYNCS"] > 0 and c["LDS"] > 0,
                  f"KD {name}: no bulk copy on an mbarrier or no shared "
                  f"load ({c})")
        else:
            check(c["UBLKCP"] == 0, f"KD {name}: a bulk copy ({c})")
        agg = counts.setdefault(variant, {"instantiations": 0})
        agg["instantiations"] += 1
        for op, n in c.items():
            agg[op] = agg.get(op, 0) + n
    check(set(counts) == {"smem", "global"}, f"KD instantiations {counts}")
    log(f"  KD: {counts}")
    return counts


def sass_tensor_ops():
    """K1 and K2 run on the tensor cores: every instantiation of their
    kernels in the built libraries holds tensor-core instructions, HMMA
    (mma.sync) or HGMMA (wgmma), by cuobjdump of the toolkit that built
    them. Returns {kernel id: {"HMMA": n, "HGMMA": n}}."""
    from cilium_tpu_torch.engine import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    counts = {}
    for kid, sym in (("K1", "nfa_scan_kernel"), ("K2", "dfa_oblivious_kernel")):
        out = subprocess.run(
            [cuobjdump, "-sass", _build.KERNELS[kid].library_path()],
            capture_output=True, text=True, timeout=300)
        check(out.returncode == 0, f"cuobjdump {kid}: {out.stderr[-500:]}")
        funcs = [f for f in out.stdout.split("Function : ")[1:]
                 if sym in f.splitlines()[0]]
        per = [(f.count("HMMA"), f.count("HGMMA")) for f in funcs]
        check(bool(per) and min(h + g for h, g in per) > 0,
              f"{kid}: an instantiation of {sym} issues no tensor-core "
              f"instruction ({per})")
        counts[kid] = {"HMMA": sum(h for h, _ in per),
                       "HGMMA": sum(g for _, g in per)}
        log(f"  {kid}: tensor-core instructions in all {len(per)} "
            f"instantiations of {sym}: {counts[kid]}")
    return counts


def timing_independence(dense_fields, nfa_fields, card):
    """K2 and K1 at the http-1000 host shape on two batches of that
    shape: random bytes with random lengths, and one byte value repeated
    at full length. The median of 20 launches of each (CUDA events, in
    turns) must agree within TIMING_RATIO_MAX. Returns {kernel id:
    (random ms, repeated ms, ratio)}."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine import dfa_oblivious_cuda, nfa_cuda

    arr, data, _ = dense_fields["host"]
    B, L = data.shape
    rng = np.random.default_rng(1)
    batches = {
        "random": (torch.from_numpy(rng.integers(0, 256, (B, L))
                                    .astype(np.uint8)).cuda(),
                   torch.from_numpy(rng.integers(0, L + 1, (B,))
                                    .astype(np.int32)).cuda()),
        "repeated": (torch.full((B, L), ord("a"), dtype=torch.uint8,
                                device="cuda"),
                     torch.full((B,), L, dtype=torch.int32, device="cuda")),
    }
    narr = nfa_fields["host"][0]
    kernels = {
        "K2": (dfa_oblivious_cuda.dfa_finals_oblivious_cuda,
               [arr[f"host_{k}"] for k in ("trans", "byteclass", "start")]),
        "K1": (nfa_cuda.nfa_finals_cuda,
               [narr[f"host_nfa_{k}"] for k in
                ("follow", "acc_cls", "byteclass", "start")]),
    }
    out = {}
    for kid, (fn, tables) in kernels.items():
        times = {name: [] for name in batches}
        for _ in range(20):
            for name, (d, ln) in batches.items():
                times[name].append(launch_ms(lambda: fn(*tables, d, ln)))
        med = {name: statistics.median(v) for name, v in times.items()}
        ratio = max(med.values()) / min(med.values())
        out[kid] = (med["random"], med["repeated"], ratio)
        log(f"  {kid} host B={B} L={L}: random bytes {med['random']:.5f} ms,"
            f" one repeated byte {med['repeated']:.5f} ms, ratio "
            f"{ratio:.4f} (limit {TIMING_RATIO_MAX}) on {card}")
        check(ratio <= TIMING_RATIO_MAX,
              f"{kid}: time depends on the input (ratio {ratio:.4f})")
    return out


# ------------------------------------------------------------- main path
def build_policy():
    from cilium_tpu_torch.core.config import EngineConfig
    from cilium_tpu_torch.engine.compiled import CompiledPolicy
    from cilium_tpu_torch.ingest import synth

    t0 = time.perf_counter()
    per_identity, scenario = synth.realize_scenario(
        synth.scenario_by_name("http", N_RULES, N_FLOWS))
    cfg = EngineConfig()
    cfg.bank_size = BANK_SIZE
    policy = CompiledPolicy.build(per_identity, cfg)
    log(f"policy: http {N_RULES} rules, {len(scenario.flows)} flows, "
        f"compiled in {time.perf_counter() - t0:.2f}s; path stack "
        f"{tuple(policy.arrays['path_trans'].shape)}, "
        f"{policy.resolve_meta['groups']} resolve groups")
    return per_identity, scenario, cfg


def host_batches(policy, flows, cfg):
    from cilium_tpu_torch.engine.compiled import (
        encode_flows,
        flowbatch_to_host_dict,
    )

    out = []
    for lo in range(0, len(flows), BATCH):
        fb = encode_flows(flows[lo:lo + BATCH], policy.kafka_interns, cfg)
        out.append(flowbatch_to_host_dict(fb))
    return out


def setup_config(name, per_identity, scenario, base_cfg):
    """Compile and stage one configuration (no kernel launches)."""
    import dataclasses

    import torch

    from cilium_tpu_torch.engine.compiled import CompiledPolicy
    from cilium_tpu_torch.engine.verdict import (
        TorchVerdictEngine,
        batch_to_device,
    )

    mode, dfa_impl, _ = CONFIGS[name]
    cfg = dataclasses.replace(base_cfg, kernel_impl=mode)
    policy = CompiledPolicy.build(per_identity, cfg)
    host = host_batches(policy, scenario.flows, cfg)
    # the engine reads its DFA arm from the environment when it is built
    os.environ["CILIUM_TPU_DFA_IMPL"] = dfa_impl
    engine = TorchVerdictEngine(policy, device=DEVICE, cfg=cfg)
    plain = TorchVerdictEngine(policy, device="cpu", cfg=cfg)
    batches = [batch_to_device(h, DEVICE) for h in host]
    torch.cuda.synchronize()
    return {"engine": engine, "plain": plain, "host": host,
            "batches": batches, "full": batches[0],
            "host_cpu": [batch_to_device(h, "cpu") for h in host]}


def drive_config(name, setup, n_flows, card, label=None):
    """One configuration of the main path; returns its report.
    ``label`` names it in the log (default: the configuration)."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine import _build

    _, dfa_impl, path_kernels = CONFIGS[name]
    tag = label or name
    engine, plain = setup["engine"], setup["plain"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        # the main path's run: counts to 0 just before, read just after
        _build.reset_launches()
        outs = [engine.verdict_batch_arrays(b) for b in setup["batches"]]
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in _build.KERNELS.items()}
        variants = kd_variants()
        want = [plain.verdict_batch_arrays(b) for b in setup["host_cpu"]]
    log(f"[{tag}] impl_plan {json.dumps(engine.impl_plan, sort_keys=True)}"
        f" CILIUM_TPU_DFA_IMPL={dfa_impl} launches {launches}, KD by "
        f"variant {variants}")
    for kid in path_kernels:
        check(launches[kid] > 0,
              f"[{tag}] kernel {kid} never launched on the main path")
    if dfa_impl == "pallas":
        check(any("constant-time guarantee" in str(w.message)
                  for w in caught),
              f"[{tag}] the >128-state path stack must warn on fallback")
    got = {k: np.concatenate([o[k].cpu().numpy() for o in outs])
           for k in outs[0]}
    check(got["verdict"].shape == (n_flows,),
          f"[{tag}] {got['verdict'].shape} verdicts for {n_flows} flows")
    assert_lanes(f"[{tag}] vs the plain-version path", got,
                 {k: np.concatenate([o[k].numpy() for o in want])
                  for k in want[0]})
    mix = np.bincount(got["verdict"], minlength=6).tolist()
    log(f"[{tag}] all 10 lanes equal to the plain path on "
        f"{n_flows} flows; verdict mix [code 0..5] {mix}")
    check(mix[5] > 0.2 * n_flows and mix[2] > 0.2 * n_flows,
          f"[{tag}] implausible verdict mix {mix} (identity wiring?)")

    med, busy, kernels = batch_timing(engine, setup["full"], tag, card)
    return {"launches": launches, "kd_variants": variants, "batch_ms": med,
            "mix": mix, "busy_share": busy, "device_kernels": kernels}


def kd_plan_check(arrays, path_data, auto_variants, edge_variants):
    """Phase 4's variant check: the http-1000 path bank plans, and ran
    on the main path, through KD's shared-memory variant; phase 3's
    over-budget banks ran through the global one."""
    from cilium_tpu_torch.engine import dfa_dense_cuda as kd

    NB, S, K = arrays["path_trans"].shape
    plan = kd.plan_launch(NB, S, K, *path_data.shape,
                          arrays["path_accept"].shape[2],
                          arrays["rp_path_gaccept"].shape[2])
    log(f"[auto] KD plan for the path bank {(NB, S, K)} at "
        f"{tuple(path_data.shape)}: {plan}; main path by variant "
        f"{auto_variants}; phase 3 edge cases by variant {edge_variants}")
    check(plan.variant == "smem" and auto_variants.get("smem", 0) > 0,
          "[auto] the http-1000 path bank must run KD's shared-memory "
          "variant")
    check(edge_variants.get("global", 0) > 0,
          "the over-budget banks must run KD's global variant")


def field_inputs_of(engine, batch):
    """prefix → (staged arrays, data, lengths) of one batch."""
    from cilium_tpu_torch.engine.megakernel import SCAN_FIELDS
    from cilium_tpu_torch.engine.verdict import batch_field, unpack_batch

    b = unpack_batch(batch)
    out = {}
    for prefix, field in SCAN_FIELDS:
        data, lens, _ = batch_field(b, field)
        out[prefix] = (engine._arrays, data.contiguous(), lens.contiguous())
    return out


def kernel_times(fields_dense, fields_nfa, capture_inputs, session_inputs,
                 card, tag="", suffix="", variant=None):
    """One launch of each kernel at the shape of every field it scans
    on the main path: its device time (profiler), its wall time per
    call from Python (CUDA events, wrapper included), the plain
    version's wall time per call, and the bound. The bound's bytes are,
    for KD, what this run's data makes it read (:func:`kd_needed_bytes`)
    and its outputs; its operations are KD's transitions over live
    bytes at the non-tensor peak, and
    the one-hot products of K2 (2·NB·B·L·S·(K+1)) and K1
    (2·NB·B·(L−1)·P²) at the int8 tensor-core peak. ``tag`` prefixes
    and ``suffix`` ends the labels of the field rows; ``variant`` names
    KD's variant (default: the one its plan picks)."""
    import torch

    from cilium_tpu_torch.engine import (
        dfa_dense_cuda,
        dfa_oblivious_cuda,
        nfa_cuda,
    )

    rows = {"KD": [], "K1": [], "K2": []}
    dense = [(f"{tag}{p}{suffix}", (p, *v)) for p, v in fields_dense.items()]
    for label, (prefix, arr, data, lens) in dense + list(
            capture_inputs.items()) + list(session_inputs.items()):
        live = lens.clamp(0, data.shape[1]).to(torch.int64)
        a = (arr[f"{prefix}_trans"], arr[f"{prefix}_byteclass"],
             arr[f"{prefix}_start"], data, lens)
        NB = a[0].shape[0]
        acc = arr[f"{prefix}_accept"]
        # the session's delta scans read no group plane
        extra = arr.get("rp_path_gaccept") if prefix == "path" \
            and label not in session_inputs else None
        steps = NB * int(live.sum())
        tables = nbytes(*a[:3]) + flow_bytes(data, lens)
        out = dfa_dense_cuda.dense_scan_cuda(*a, accept=acc, extra=extra,
                                             _variant=variant)
        kd_bytes = kd_needed_bytes(a, acc, extra) + nbytes(
            *(out if extra is not None else (out,)))
        def kd():
            return dfa_dense_cuda.dense_scan_cuda(*a, accept=acc,
                                                  extra=extra,
                                                  _variant=variant)
        rows["KD"].append((label, tuple(a[0].shape) + tuple(data.shape),
                           kernel_device_ms(kd, "dfa_dense_kernel"),
                           time_launch(kd),
                           time_launch(lambda: dfa_dense_cuda.dense_scan_plain(
                               *a, accept=acc, extra=extra), reps=3),
                           *bound(kd_bytes, 2 * steps)))
        if a[0].shape[1] <= 128 and label not in session_inputs:
            def k2():
                return dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*a)
            fin = k2()
            rows["K2"].append((label,
                               tuple(a[0].shape) + tuple(data.shape),
                               kernel_device_ms(k2, "dfa_oblivious_kernel"),
                               time_launch(k2),
                               time_launch(lambda: dfa_oblivious_cuda
                                           .dfa_finals_oblivious_plain(*a),
                                           reps=3),
                               # the one-hot product over every byte:
                               # the trip count is fixed by the shape
                               *bound(tables + nbytes(fin),
                                      2 * NB * data.numel()
                                      * a[0].shape[1] * (a[0].shape[2] + 1),
                                      TENSOR_INT8_OPS_PER_S)))
    for prefix, (arr, data, lens) in fields_nfa.items():
        if f"{prefix}_nfa_follow" not in arr:
            continue
        n = [arr[f"{prefix}_nfa_{k}"] for k in
             ("follow", "acc_cls", "byteclass", "start")] + [data, lens]
        NB, P, _ = n[1].shape
        # D . Follow over every byte after the first (the trip count is
        # fixed by the shape)
        ops = 2 * NB * data.shape[0] * max(data.shape[1] - 1, 0) * P * P
        def k1():
            return nfa_cuda.nfa_finals_cuda(*n)
        fin = k1()
        rows["K1"].append((f"{tag}{prefix}{suffix}",
                           (NB, P, n[1].shape[2]) + tuple(data.shape),
                           kernel_device_ms(k1, "nfa_scan_kernel"),
                           time_launch(k1),
                           time_launch(lambda: nfa_cuda.nfa_finals_plain(*n),
                                       reps=3),
                           *bound(nbytes(*n[:4], fin)
                                  + flow_bytes(data, lens), ops,
                                  TENSOR_INT8_OPS_PER_S)))
    for kid, rs in rows.items():
        for prefix, shape, dev_ms, ms, plain_ms, bms, by in rs:
            check(dev_ms > 0, f"{kid} {prefix}: no device time for "
                              f"the kernel")
            log(f"  {kid} {prefix:12s} {str(shape):30s} device "
                f"{dev_ms:.5f} ms, "
                f"call {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
                f"{bms:.3g} ms by {by}) on {card}")
    return rows


# ------------------------------------------------------ capture replay
def uniquify_flows(flows):
    """Clone flows so every record carries a unique string (query-
    suffixed http path, instance-suffixed kafka client, qname-left
    label): the high-cardinality capture of the reference benchmark's
    ``--capture-cardinality high`` (``bench.py`` ``_uniquify_flows``)."""
    import dataclasses

    for i, f in enumerate(flows):
        if f.http is not None:
            f = dataclasses.replace(f, http=dataclasses.replace(
                f.http, path=f"{f.http.path}?u={i}"))
        elif f.kafka is not None:
            f = dataclasses.replace(f, kafka=dataclasses.replace(
                f.kafka, client_id=f"{f.kafka.client_id}-u{i}"))
        elif f.dns is not None and f.dns.query:
            f = dataclasses.replace(f, dns=dataclasses.replace(
                f.dns, query=f"u{i}.{f.dns.query}"))
        yield f


def write_captures(scenario, policy, cfg, n_records):
    """The scenario's flows repeated to ``n_records``, as written by
    the reference benchmark's capture lane, and the same records made
    unique: each written with the port's writer into a temporary
    directory (never the repo), read back with the port's reader, and
    featurized (host only, no launch)."""
    import tempfile

    import numpy as np

    from cilium_tpu_torch.engine.compiled import CaptureFeaturizer
    from cilium_tpu_torch.ingest import binary

    flows = scenario.flows
    reps = -(-n_records // len(flows))
    low = (flows * reps)[:n_records]
    caps = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, fl in (("low", low), ("high", list(uniquify_flows(low)))):
            path = os.path.join(tmp, f"{kind}.bin")
            t0 = time.perf_counter()
            n = binary.write_capture_l7(path, fl)
            write_s = time.perf_counter() - t0
            check(n == n_records and binary.capture_version(path) == 2
                  and binary.read_gen_sidecar(path) is None,
                  f"{kind} capture: {n} records, v"
                  f"{binary.capture_version(path)}")
            rec = np.array(binary.map_capture(path))
            l7, offsets, blob = binary.read_l7_sidecar(path)
            feat = CaptureFeaturizer(l7, offsets, blob,
                                     policy.kafka_interns, cfg)
            caps[kind] = {"flows": fl, "sections": (rec, l7, offsets, blob),
                          "feat": feat, "bytes": os.path.getsize(path)}
            log(f"  {kind}-cardinality capture: {n} records, "
                f"{caps[kind]['bytes']} bytes, {len(offsets) - 1} strings, "
                f"written in {write_s:.2f}s; table rows "
                f"{ {f: t[0].shape for f, t in feat.tables.items()} }")
    return caps


def capture_inputs_of(arrays, caps):
    """label → (prefix, staged arrays, data, lengths) on the card: each
    field's capture table at its largest B over the two captures, and a
    synthetic L = 1024 batch through the header and path banks."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine.verdict import _TABLE_FIELDS

    out = {}
    for field, prefix in _TABLE_FIELDS:
        data, lens, _ = max((c["feat"].tables[field] for c in caps.values()),
                            key=lambda t: t[0].shape[0])
        out[f"capture-{prefix}"] = (
            prefix, arrays, torch.from_numpy(data).cuda(),
            torch.from_numpy(lens).cuda())
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, (4096, 1024)).astype(np.uint8)
    lens = rng.integers(0, 1025, (4096,)).astype(np.int32)
    lens[:64] = 1024
    for prefix in ("hdr", "path"):
        out[f"L1024-{prefix}"] = (prefix, arrays,
                                  torch.from_numpy(data).cuda(),
                                  torch.from_numpy(lens).cuda())
    return out


def session_inputs_of(arrays, deltas=SESSION_DELTAS, seed=4):
    """label → (prefix, staged arrays, data, lengths) on the card: a
    session delta scan of B random strings at the field's width L."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = {}
    for prefix, b, l in deltas:
        data = rng.integers(0, 256, (b, l)).astype(np.uint8)
        lens = rng.integers(0, l + 1, (b,)).astype(np.int32)
        lens[:8] = l
        out[f"session-{prefix}-{b}"] = (
            prefix, arrays, torch.from_numpy(data).to(DEVICE),
            torch.from_numpy(lens).to(DEVICE))
    return out


def stage_marks():
    from cilium_tpu_torch.runtime.metrics import (
        CAPTURE_STAGE_SECONDS,
        METRICS,
    )

    return {ph: METRICS.histo_sum(CAPTURE_STAGE_SECONDS, {"phase": ph})
            for ph in STAGE_PHASES}


def force(out) -> None:
    """Forced completion: a two-element read back of the verdict lane
    (the stream is in order, so everything before it has run)."""
    out["verdict"][:2].cpu()


def replay_all(replay, rec, l7):
    """Every chunk of the capture through ``verdict_chunk`` →
    {lane: numpy array} in capture order."""
    import numpy as np

    outs = [replay.verdict_chunk(rec[s:s + REPLAY_CHUNK],
                                 l7[s:s + REPLAY_CHUNK], start=s)
            for s in range(0, len(rec), REPLAY_CHUNK)]
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def assert_lanes(label, got, want, lanes=None):
    import numpy as np

    from cilium_tpu_torch.engine.verdict import OUTPUT_LANES

    for lane in lanes or OUTPUT_LANES:
        a, b = np.asarray(got[lane]), np.asarray(want[lane])
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{label} lane {lane}: {a.shape}/{a.dtype} vs "
              f"{b.shape}/{b.dtype}")
        check(np.array_equal(a, b),
              f"{label} lane {lane} differs in {int((a != b).sum())} rows")


def route_rate(chunk_fn, n_chunks, rows_per_chunk):
    """(median chunk latency ms with forced completion, rows/s): the
    reference benchmark's method — per-chunk latency over
    LATENCY_SAMPLES chunks, then the median of 5 windows that each
    replay the file R× with one forced completion at the end."""
    force(chunk_fn(0))
    lat = []
    for i in range(LATENCY_SAMPLES):
        t0 = time.perf_counter()
        force(chunk_fn(i % n_chunks))
        lat.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    out = None
    for c in range(n_chunks):
        out = chunk_fn(c)
    force(out)
    reps = max(1, int(WINDOW_S / max(time.perf_counter() - t0, 1e-4)))
    windows = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            for c in range(n_chunks):
                out = chunk_fn(c)
        force(out)
        windows.append(time.perf_counter() - t0)
    return (statistics.median(lat),
            reps * n_chunks * rows_per_chunk / statistics.median(windows))


def trace_route(fn, label, card, reps=3):
    """Device kernels and device ms of one replay chunk (profiler), and
    the device's busy share of the chunk's forced wall time."""
    kern = profile_kernels(lambda: force(fn(0)), reps)
    t0 = time.perf_counter()
    force(fn(0))
    wall = (time.perf_counter() - t0) * 1e3
    if not kern:
        log(f"{label} traced: the profiler saw no device time")
        return {}
    dev = sum(ms for _, ms in kern.values()) / reps
    n = sum(c for c, _ in kern.values()) / reps
    log(f"{label} traced: {n:.0f} device kernels, {dev:.4f} ms of device "
        f"time per chunk (busy share {dev / wall:.3f} of a {wall:.4f} ms "
        f"forced chunk) on {card}")
    return {"device_ms": dev, "kernels": n, "busy_share": dev / wall}


def capture_phase(arm, setups, caps, cfg, card):
    """One arm of phase 5 on the low-cardinality capture: the memo, id
    and row routes, each staged as a user stages it; lanes against each
    other, the fused step and (for the memo fill) the plain path."""
    import dataclasses

    import numpy as np
    import torch

    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine.replay import CaptureReplay

    setup = setups[CAPTURE_ARMS[arm][0]]
    engine, plain = setup["engine"], setup["plain"]
    rec, l7, offsets, blob = caps["low"]["sections"]
    N = len(rec)
    no_memo = dataclasses.replace(cfg, verdict_memo=False)
    drop = cfg.stage_unique_drop_ratio
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        # the arm's run: counts to 0 just before, read just after
        _build.reset_launches()
        marks = stage_marks()
        t0 = time.perf_counter()
        memo_r = CaptureReplay(engine, l7, offsets, blob, cfg)
        torch.cuda.synchronize()
        tables_forced_ms = (time.perf_counter() - t0) * 1e3
        memo_r.stage_rows(rec, l7)
        ratio = memo_r.stage_unique(drop)
        check(memo_r.row_idx is not None and
              memo_r.row_idx.dtype == np.uint16,
              f"[{arm}] the low-cardinality capture must dedup "
              f"(ratio {ratio})")
        memo_r.stage_unique_device()
        t0 = time.perf_counter()
        m = memo_r.stage_verdict_memo()
        m.table[:2].cpu()
        memo_fill_ms = (time.perf_counter() - t0) * 1e3
        split = {ph: (v - marks[ph]) * 1e3
                 for ph, v in stage_marks().items()}
        lanes = {"memo": replay_all(memo_r, rec, l7)}
        id_r = CaptureReplay(engine, l7, offsets, blob, no_memo)
        id_r.stage_rows(rec, l7)
        id_r.stage_unique(drop)
        lanes["id"] = replay_all(id_r, rec, l7)
        row_r = CaptureReplay(engine, l7, offsets, blob, cfg)
        row_r.stage_rows(rec, l7)
        row_r.stage_unique(drop_if_ratio_at_least=0.0)
        lanes["row"] = replay_all(row_r, rec, l7)
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in _build.KERNELS.items()}
        variants = kd_variants()
    log(f"[capture {arm}] launches {launches}, KD by variant {variants}")
    for kid in CAPTURE_ARMS[arm][1]:
        check(launches[kid] > 0,
              f"[capture {arm}] kernel {kid} never launched")
    if arm == "oblivious":
        check(any("constant-time guarantee" in str(w.message)
                  for w in caught),
              "[capture oblivious] the path table must warn on fallback")
    check(m.misses == memo_r.n_unique and id_r.memo is None
          and row_r.row_idx is None, f"[capture {arm}] route set-up")
    # the fused step on the same flows in capture order: the capture
    # is the scenario's flows repeated, so its lanes repeat too
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fused = [engine.verdict_batch_arrays(b) for b in setup["batches"]]
    reps = -(-N // sum(len(o["verdict"]) for o in fused))
    want = {k: np.tile(np.concatenate([o[k].cpu().numpy() for o in fused]),
                       reps)[:N] for k in fused[0]}
    for route, got in lanes.items():
        assert_lanes(f"[capture {arm}] {route} route", got, want)
    # the memo's fill over the unique rows against the plain path
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        plain_r = CaptureReplay(plain, l7, offsets, blob, cfg)
        plain_r.stage_rows(rec, l7)
        plain_r.stage_unique(drop)
        plain_m = plain_r.stage_verdict_memo()
    check(np.array_equal(plain_r._uniq_host, memo_r._uniq_host)
          and np.array_equal(plain_r.row_idx, memo_r.row_idx),
          f"[capture {arm}] dedup differs from the plain path's")
    check(torch.equal(m.table.cpu(), plain_m.table),
          f"[capture {arm}] memo fill differs from the plain path's")
    log(f"[capture {arm}] all 10 lanes equal across the memo, id and row "
        f"routes and to the fused step on {N} records; memo fill equal "
        f"to the plain path's on {memo_r.n_unique} unique rows")
    log(f"[capture {arm}] staging split ms "
        f"{ {k: round(v, 3) for k, v in split.items()} } (tables with "
        f"forced completion {tables_forced_ms:.3f} ms, memo fill with "
        f"forced completion {memo_fill_ms:.3f} ms); unique rows "
        f"{memo_r.n_unique}/{N} ({ratio:.5f}) on {card}")
    ids = memo_r.row_idx
    rows_all = row_r.rows_all
    n_chunks = N // REPLAY_CHUNK
    chunk = {
        "memo": lambda c: memo_r.verdict_idx(
            ids[c * REPLAY_CHUNK:(c + 1) * REPLAY_CHUNK]),
        "id": lambda c: id_r.verdict_idx(
            ids[c * REPLAY_CHUNK:(c + 1) * REPLAY_CHUNK]),
        "row": lambda c: row_r.verdict_rows(
            rows_all[c * REPLAY_CHUNK:(c + 1) * REPLAY_CHUNK]),
    }
    rates = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for route, fn in chunk.items():
            lat, rate = route_rate(fn, n_chunks, REPLAY_CHUNK)
            rates[route] = {"chunk_ms": lat, "rows_per_s": rate}
            log(f"[capture {arm}] {route} route: chunk {REPLAY_CHUNK} "
                f"median {lat:.4f} ms forced, {rate:.0f} rows/s (median "
                f"of 5 windows) on {card}")
            rates[route].update(trace_route(
                fn, f"[capture {arm}] {route} route", card))
    return {"launches": launches, "kd_variants": variants,
            "split_ms": split, "rates": rates,
            "unique": memo_r.n_unique, "records": N,
            "tables_forced_ms": tables_forced_ms,
            "memo_fill_ms": memo_fill_ms}


def high_cardinality_phase(setups, caps, cfg, card):
    """Phase 5's high-cardinality pass (gather arm): every record
    unique, so ``stage_unique`` declines at the default ratio and the
    rows stream; lanes on a sample against the plain path."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine.replay import CaptureReplay

    setup = setups["auto"]
    engine, plain = setup["engine"], setup["plain"]
    cap = caps["high"]
    rec, l7, offsets, blob = cap["sections"]
    N = len(rec)
    _build.reset_launches()
    marks = stage_marks()
    r = CaptureReplay(engine, l7, offsets, blob, cfg)
    r.stage_rows(rec, l7)
    ratio = r.stage_unique(cfg.stage_unique_drop_ratio)
    split = {ph: (v - marks[ph]) * 1e3 for ph, v in stage_marks().items()}
    got = replay_all(r, rec, l7)
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    variants = kd_variants()
    path_rows = r.feat.tables["path"][0].shape
    log(f"[capture high-cardinality] launches {launches}, KD by variant "
        f"{variants}; path table "
        f"{path_rows}; unique rows {r.n_unique}/{N} ({ratio:.5f})")
    check(launches["KD"] > 0, "[capture high-cardinality] KD never launched")
    check(r.row_idx is None, "[capture high-cardinality] stage_unique "
                             "must decline at the default drop ratio")
    sample = np.sort(np.random.default_rng(3).choice(N, HC_SAMPLE,
                                                     replace=False))
    want = plain.verdict_flows([cap["flows"][i] for i in sample])
    assert_lanes("[capture high-cardinality] sample",
                 {k: v[sample] for k, v in got.items()}, want)
    log(f"[capture high-cardinality] all 10 lanes equal to the plain path "
        f"on a {HC_SAMPLE}-row sample; staging split ms "
        f"{ {k: round(v, 3) for k, v in split.items()} } on {card}")
    rows_all = r.rows_all

    def chunk(c):
        return r.verdict_rows(rows_all[c * REPLAY_CHUNK:
                                       (c + 1) * REPLAY_CHUNK])

    lat, rate = route_rate(chunk, N // REPLAY_CHUNK, REPLAY_CHUNK)
    log(f"[capture high-cardinality] row route: chunk {REPLAY_CHUNK} "
        f"median {lat:.4f} ms forced, {rate:.0f} rows/s (median of 5 "
        f"windows) on {card}")
    row = {"chunk_ms": lat, "rows_per_s": rate,
           **trace_route(chunk, "[capture high-cardinality] row route",
                         card)}
    return {"launches": launches, "kd_variants": variants,
            "split_ms": split, "unique": r.n_unique,
            "records": N, "path_table": list(path_rows),
            "rates": {"row": row}}


# ----------------------------------------------------------- legacy step
def batch_timing(engine, full, label, card):
    """The median of TIMED_BATCHES staged batches after WARMUP (host
    clock around the step and a synchronize), then a separate traced
    run of 5: device kernels and device ms per batch, the busy share
    of the untraced median, and the hand-written kernels' ms per batch.
    Returns (median ms, busy share or None, device kernels per batch or
    None)."""
    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(WARMUP):
            engine.verdict_batch_arrays(full)
        torch.cuda.synchronize()
        samples = []
        for _ in range(TIMED_BATCHES):
            t0 = time.perf_counter()
            engine.verdict_batch_arrays(full)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        reps = 5
        kern = profile_kernels(lambda: engine.verdict_batch_arrays(full),
                               reps)
    med = statistics.median(samples)
    log(f"[{label}] batch {BATCH}: median {med:.4f} ms over "
        f"{TIMED_BATCHES} batches (min {min(samples):.4f}, max "
        f"{max(samples):.4f}) = {BATCH / med * 1e3:.0f} verdicts/s "
        f"on {card}")
    if not kern:
        log(f"[{label}] traced: the profiler saw no device time "
            f"(device busy share not measured)")
        return med, None, None
    dev_ms = sum(ms for _, ms in kern.values()) / reps
    n_launch = sum(n for n, _ in kern.values()) / reps
    ours = {sym: round(sum(ms for k, (_, ms) in kern.items()
                           if sym in k) / reps, 5)
            for sym in ("dfa_dense_kernel", "nfa_scan_kernel",
                        "dfa_oblivious_kernel")}
    log(f"[{label}] traced: {n_launch:.0f} device kernels per batch, "
        f"{dev_ms:.4f} ms of device time per batch (busy share "
        f"{dev_ms / med:.3f} of the untraced median); hand-written "
        f"kernels ms/batch {ours}")
    return med, dev_ms / med, n_launch


def legacy_phase(per_identity, base_cfg, setups, scenario, card):
    """Phase 6: the legacy step, a degenerate plan and the blob
    transport against the fused step on the http-1000 batches."""
    import dataclasses

    import numpy as np
    import torch

    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine import megakernel as mk
    from cilium_tpu_torch.engine.compiled import CompiledPolicy
    from cilium_tpu_torch.engine.verdict import (
        OUTPUT_LANES,
        TorchVerdictEngine,
    )

    fused = setups["auto"]
    os.environ["CILIUM_TPU_DFA_IMPL"] = "gather"

    def run(engine):
        outs = [engine.verdict_batch_arrays(b) for b in fused["batches"]]
        return {k: np.concatenate([o[k].cpu().numpy() for o in outs])
                for k in outs[0]}

    want = run(fused["engine"])
    launches = {}
    cfg_l = dataclasses.replace(base_cfg, kernel_impl="legacy")
    legacy = TorchVerdictEngine(CompiledPolicy.build(per_identity, cfg_l),
                                device=DEVICE, cfg=cfg_l)
    check(legacy.impl_plan == {}, "legacy engine staged a plan")
    _build.reset_launches()
    got = run(legacy)
    launches["legacy"] = {k: v.launches for k, v in _build.KERNELS.items()}
    variants = {"legacy": kd_variants()}
    assert_lanes("[legacy] kernel_impl=legacy", got, want)

    cap = mk.GROUP_CAP
    mk.GROUP_CAP = 1
    try:
        pol_d = CompiledPolicy.build(per_identity, base_cfg)
    finally:
        mk.GROUP_CAP = cap
    check(pol_d.resolve_meta is None and "rp_g_method" not in pol_d.arrays,
          "GROUP_CAP=1 left a resolve plan")
    degen = TorchVerdictEngine(pol_d, device=DEVICE, cfg=base_cfg)
    _build.reset_launches()
    got_d = run(degen)
    launches["degenerate-plan"] = {k: v.launches
                                   for k, v in _build.KERNELS.items()}
    variants["degenerate-plan"] = kd_variants()
    want_d = [TorchVerdictEngine(pol_d, device="cpu", cfg=base_cfg)
              .verdict_batch_arrays(b) for b in fused["host_cpu"]]
    assert_lanes("[legacy] degenerate plan vs its plain path", got_d,
                 {k: np.concatenate([o[k].numpy() for o in want_d])
                  for k in want_d[0]})
    # l7_match names a rule here (no rule → group map staged) and a
    # group under the plan; every other lane equals the fused step's
    assert_lanes("[legacy] degenerate plan vs fused", got_d, want,
                 [k for k in OUTPUT_LANES if k != "l7_match"])

    _build.reset_launches()
    flows = scenario.flows
    got_b = {}
    for lo in range(0, len(flows), BATCH):
        o = fused["engine"].verdict_flows_blob(flows[lo:lo + BATCH])
        for k, v in o.items():
            got_b.setdefault(k, []).append(v)
    torch.cuda.synchronize()
    launches["blob"] = {k: v.launches for k, v in _build.KERNELS.items()}
    variants["blob"] = kd_variants()
    assert_lanes("[legacy] verdict_flows_blob",
                 {k: np.concatenate(v) for k, v in got_b.items()}, want)
    for name, ln in launches.items():
        check(ln["KD"] > 0, f"[legacy] {name}: KD never launched")
    log(f"[legacy] all 10 lanes equal to the fused step for "
        f"kernel_impl=legacy and verdict_flows_blob, and to the plain "
        f"path for the degenerate plan (its other 9 lanes equal the "
        f"fused step's) on {len(want['verdict'])} flows; launches "
        f"{launches}")
    full = fused["full"]
    timing = {"legacy": batch_timing(legacy, full, "legacy step", card),
              "fused": batch_timing(fused["engine"], full, "fused step",
                                    card),
              "degenerate-plan": batch_timing(degen, full,
                                              "degenerate plan", card)}
    return {"launches": launches, "kd_variants": variants, "timing": timing,
            "blob": blob_route_kernels(fused["engine"], flows, card)}


def blob_route_kernels(engine, flows, card):
    """Device kernels and device ms per batch of the blob route: the
    fused step over a [B, W] u8 blob staged on the card and unpacked
    there, whose byte fields and length columns KD reads in place
    (profiler, 5 batches)."""
    import torch

    from cilium_tpu_torch.engine.compiled import (
        encode_flows,
        flowbatch_to_host_dict,
        pack_blob_host,
    )
    from cilium_tpu_torch.engine.verdict import unpack_blob

    blob, layout = pack_blob_host(flowbatch_to_host_dict(
        encode_flows(flows[:BATCH], engine.policy.kafka_interns, None)))
    blob = torch.from_numpy(blob).to(DEVICE)
    kern = profile_kernels(
        lambda: engine.verdict_batch_arrays(unpack_blob(blob, layout)), 5)
    if not kern:
        log("[blob route] traced: the profiler saw no device time")
        return {}
    out = {"device_kernels": sum(n for n, _ in kern.values()) / 5,
           "device_ms": sum(ms for _, ms in kern.values()) / 5,
           "kd_launches": sum(n for k, (n, _) in kern.items()
                              if "dfa_dense_kernel" in k) / 5}
    log(f"[blob route] traced: {out['device_kernels']:.0f} device kernels "
        f"per batch of {BATCH} ({out['kd_launches']:.0f} of them KD), "
        f"{out['device_ms']:.4f} ms of device time per batch on {card}")
    return out


# ---------------------------------------------------------- online serving
class StubLoader:
    """What the serve loop reads of a loader: its engine."""

    def __init__(self, engine):
        self.engine = engine


def chunk_sections(flows):
    """Capture sections of one stream chunk (the unit a stream submits,
    as the reference's stream transport ships it)."""
    from cilium_tpu_torch.ingest import binary

    return binary.capture_from_bytes(binary.capture_to_bytes(flows))


def serve_loop(engine, **kw):
    """A serve loop over ``engine`` with SERVE_STREAMS leases granted
    (a lease TTL longer than the phase: no lease lapses mid-pass)."""
    from cilium_tpu_torch.runtime.serveloop import ServeLoop

    loop = ServeLoop(StubLoader(engine), capacity=SERVE_STREAMS,
                     lease_ttl_s=600.0, **kw)
    leases = [loop.connect(f"s{i}") for i in range(SERVE_STREAMS)]
    return loop, leases


def ticket_lanes(tickets):
    """The served lanes of resolved tickets, concatenated."""
    import numpy as np

    return {k: np.concatenate([getattr(t.prov, k) for t in tickets])
            for k in ("verdict", "l7_match", "match_spec")}


def trace_once(fn):
    """(device kernels, device ms, wall ms) of one call of ``fn``, all
    three from the same traced call (profiler on, so the wall includes
    its overhead); kernels and device ms are None when the profiler saw
    no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if "CUDA" in str(getattr(e, "device_type", ""))]
    if not ev:
        return None, None, wall_ms
    return (sum(e.count for e in ev),
            sum(getattr(e, "self_device_time_total", 0.0) for e in ev) / 1e3,
            wall_ms)


@contextlib.contextmanager
def delta_scans_noted(arrays, shapes):
    """While open, append (field prefix, bank shape, B, L) of every
    delta scan the incremental session launches to ``shapes``: the
    session's scan call is wrapped, and runs unchanged."""
    from cilium_tpu_torch.engine import session

    scan = session.dfa_scan_banked
    prefix_of = {id(v): k[:-len("_trans")] for k, v in arrays.items()
                 if k.endswith("_trans")}

    def noted(trans, byteclass, start, accept, data, lens):
        shapes.append((prefix_of[id(trans)], tuple(trans.shape),
                       *data.shape))
        return scan(trans, byteclass, start, accept, data, lens)

    session.dfa_scan_banked = noted
    try:
        yield
    finally:
        session.dfa_scan_banked = scan


def serve_phase(setups, scenario, card):
    """Phase 7: online serving through the port's serve loop on the
    ``auto`` engine — cold, warm, plain, growth and thread passes. The
    launch counts cover the serving passes alone: the direct steps the
    passes are held against run before the counts are set to 0. Returns
    the counts, the growth pass's delta-scan shapes (KD is held and
    timed at them outside this phase's count) and the report."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine.attribution import (
        AttributionMap,
        flow_family,
    )
    from cilium_tpu_torch.runtime.serveloop import ShedError

    t_phase = time.perf_counter()
    engine, plain = setups["auto"]["engine"], setups["auto"]["plain"]
    flows = scenario.flows
    N = len(flows)
    direct = engine.verdict_flows(flows)
    lanes = ("verdict", "l7_match", "match_spec")
    # the warm stream: the flows repeated; a chunk's records depend only
    # on its start modulo N, so its sections are built once
    cache = {}

    def warm_chunk(c):
        s = (c * SERVE_CHUNK) % N
        if s not in cache:
            cache[s] = chunk_sections([flows[(s + i) % N]
                                       for i in range(SERVE_CHUNK)])
        return s, cache[s]

    def want_of(s, n):
        return {k: np.asarray(direct[k])[(s + np.arange(n)) % N]
                for k in lanes}

    # the growth pass's flows: unique paths, each in GROWTH_REPEAT
    # consecutive records, past the path table's cap; their direct
    # verdicts, a batch at a time
    copies = GROWTH_MAX_STRINGS // N + 1
    unique = list(uniquify_flows(flows * copies))
    uflows = [f for f in unique for _ in range(GROWTH_REPEAT)]
    ucheck = {}
    for lo in range(0, len(unique), BATCH):
        o = engine.verdict_flows(unique[lo:lo + BATCH])
        for k in lanes:
            ucheck.setdefault(k, []).append(np.asarray(o[k]))
    udirect = {k: np.repeat(np.concatenate(v), GROWTH_REPEAT)
               for k, v in ucheck.items()}
    # every chunk's sections (host featurize, set-up)
    cold = [chunk_sections(flows[s:s + SERVE_CHUNK])
            for s in range(0, N, SERVE_CHUNK)]
    n_chunks = SERVE_WARM_RECORDS // SERVE_CHUNK
    for c in range(n_chunks):
        warm_chunk(c)
    ucache = [(s, chunk_sections(uflows[s:s + SERVE_CHUNK]))
              for s in range(0, len(uflows), SERVE_CHUNK)]

    out = {"card": card, "streams": SERVE_STREAMS, "chunk": SERVE_CHUNK}
    # the serving passes' run: counts to 0 just before, read just after
    torch.cuda.synchronize()
    _build.reset_launches()
    t_serve = time.perf_counter()

    # -- cold: the scenario's flows once, one pack
    loop, leases = serve_loop(engine, provenance=True)
    tickets = [loop.submit(leases[k % SERVE_STREAMS], *sec)
               for k, sec in enumerate(cold)]
    t0 = time.perf_counter()
    served = loop.step()
    cold_ms = (time.perf_counter() - t0) * 1e3
    check(served == N and all(t.done and t.error is None for t in tickets),
          f"[serve cold] {served} of {N} records served")
    got = ticket_lanes(tickets)
    assert_lanes("[serve cold] vs the direct step", got, direct, lanes)
    amap = AttributionMap.from_policy(engine.policy)
    codes = got["l7_match"]
    unresolved = sum(1 for i in np.nonzero(codes >= 0)[0]
                     if amap.resolve(flow_family(flows[i]),
                                     int(codes[i])) is None)
    check(unresolved == 0, f"[serve cold] {unresolved} attribution codes "
                           f"do not resolve")
    memo = loop.ring.session.memo
    out["cold"] = {"records": N, "chunks": len(cold),
                   "unique_rows": loop.ring.session.n_rows,
                   "pack_ms": cold_ms, "memo_misses": memo.misses,
                   "codes_resolved": int((codes >= 0).sum())}
    # its kernels: a fresh ring's cold pack, traced
    tl, tleases = serve_loop(engine, provenance=True)
    for k, sec in enumerate(cold):
        tl.submit(tleases[k % SERVE_STREAMS], *sec)
    kern, dev_ms, tr_ms = trace_once(tl.step)
    out["cold"].update(device_kernels=kern, device_ms=dev_ms,
                       traced_pack_ms=tr_ms,
                       busy_share=None if dev_ms is None else dev_ms / tr_ms)
    log(f"[serve cold] {N} records in {len(cold)} chunks over "
        f"{SERVE_STREAMS} leases: one pack of {cold_ms:.3f} ms, "
        f"{out['cold']['unique_rows']} unique rows; verdict, l7_match and "
        f"match_spec equal to the direct step; "
        f"{out['cold']['codes_resolved']} attribution codes resolve; "
        f"traced cold pack {kern} device kernels, {dev_ms} ms of device "
        f"time in {tr_ms:.3f} ms, busy share {out['cold']['busy_share']} "
        f"on {card}")

    # -- warm: the flows repeated to SERVE_WARM_RECORDS, waves of one
    # chunk per lease, step() until drained
    ring = loop.ring
    misses0, shipped0, saved0, hits0 = (memo.misses, ring.bytes_shipped,
                                        ring.bytes_saved, memo.hits)
    warm, packs = [], []
    t_all = time.perf_counter()
    for w0 in range(0, n_chunks, SERVE_STREAMS):
        for c in range(w0, min(n_chunks, w0 + SERVE_STREAMS)):
            s, sec = warm_chunk(c)
            warm.append((s, loop.submit(leases[c % SERVE_STREAMS], *sec)))
        while not all(t.done for _, t in warm):
            t0 = time.perf_counter()
            n = loop.step()
            packs.append(((time.perf_counter() - t0) * 1e3, n))
    wall = time.perf_counter() - t_all
    records = n_chunks * SERVE_CHUNK
    check(all(t.error is None for _, t in warm), "[serve warm] errors")
    for s, t in warm:
        if not np.array_equal(t.verdicts, want_of(s, t.n)["verdict"]):
            raise SmokeFailure(f"[serve warm] chunk at {s} differs from "
                               f"the direct step")
    check(memo.misses == misses0,
          f"[serve warm] {memo.misses - misses0} memo misses")
    check(ring.bytes_shipped - shipped0 == 4 * records,
          f"[serve warm] {ring.bytes_shipped - shipped0} bytes shipped for "
          f"{records} records (4 each expected)")
    pack_ms = statistics.median(p for p, _ in packs)
    out["warm"] = {
        "records": records, "packs": len(packs),
        "pack_ms_median": pack_ms,
        "records_per_pack": statistics.median(n for _, n in packs),
        "records_per_s": records / wall,
        "pack_records_per_s": records / (sum(p for p, _ in packs) / 1e3),
        "memo_hits": memo.hits - hits0, "memo_misses": memo.misses - misses0,
        "bytes_saved": ring.bytes_saved - saved0,
        "bytes_shipped": ring.bytes_shipped - shipped0}
    # a separate traced pack of one full wave
    for c in range(SERVE_STREAMS):
        loop.submit(leases[c], *warm_chunk(c)[1])
    kern, dev_ms, tr_ms = trace_once(loop.step)
    out["warm"].update(device_kernels=kern, device_ms=dev_ms,
                       traced_pack_ms=tr_ms,
                       busy_share=None if dev_ms is None else dev_ms / tr_ms)
    log(f"[serve warm] {records} records, {len(packs)} packs: median pack "
        f"{pack_ms:.3f} ms, {out['warm']['records_per_pack']:.0f} records "
        f"per pack, {out['warm']['records_per_s']:.0f} records/s submit to "
        f"verdict ({out['warm']['pack_records_per_s']:.0f} in the packs); "
        f"memo hits {out['warm']['memo_hits']}, misses 0; bytes saved "
        f"{out['warm']['bytes_saved']}, shipped "
        f"{out['warm']['bytes_shipped']} (4 a record); traced pack {kern} "
        f"device kernels, {dev_ms} ms of device time in {tr_ms:.3f} ms, "
        f"busy share {out['warm']['busy_share']} on {card}")

    # -- plain: a sample of the warm traffic through a ring on the CPU
    pl, pleases = serve_loop(plain, provenance=True)
    n_s = SERVE_PLAIN_SAMPLE // SERVE_CHUNK
    pt = [pl.submit(pleases[c], *warm_chunk(c)[1]) for c in range(n_s)]
    pl.step()
    assert_lanes("[serve plain] the card's warm lanes vs a ring on the CPU",
                 ticket_lanes([t for _, t in warm[:n_s]]), ticket_lanes(pt),
                 lanes)
    log(f"[serve plain] {n_s * SERVE_CHUNK} records of the warm traffic: "
        f"the ring on the CPU serves the card's lanes")

    # -- growth: the unique paths until the path table passes the cap
    gl, gleases = serve_loop(engine, provenance=True)
    sess = gl.ring.session
    sess.max_strings = GROWTH_MAX_STRINGS
    shapes, done, stale = [], [], []
    todo = list(ucache)
    k = 0
    with delta_scans_noted(engine._arrays, shapes):
        # wave A: until the path table reaches the cap. The pack takes
        # the first PACK_MAX records, but the flush scans every pending
        # string: the largest delta a flush can hold. The chunks left in
        # the slots were encoded before the reset the next submit
        # triggers
        while todo and sess.tables["path"].n < GROWTH_MAX_STRINGS:
            s, sec = todo.pop(0)
            done.append((s, gl.submit(gleases[k % SERVE_STREAMS], *sec)))
            k += 1
        gl.step()
        # wave B: the rest, from a fresh session
        for s, sec in todo:
            done.append((s, gl.submit(gleases[k % SERVE_STREAMS], *sec)))
            k += 1
        gl.step()
        check(sess.resets == 1, f"[serve growth] {sess.resets} resets (1 "
                                f"expected)")
        for s, t in done:
            if t.error is not None:
                check(t.error == "session-reset",
                      f"[serve growth] chunk at {s}: {t.error}")
                stale.append(s)
        check(stale, "[serve growth] no chunk was orphaned by the reset")
        redo = [(s, gl.submit(gleases[i % SERVE_STREAMS],
                              *dict(ucache)[s]))
                for i, s in enumerate(stale)]
        gl.step()
    check(sess.resets == 1, "[serve growth] a second reset")
    for s, t in [d for d in done if d[1].error is None] + redo:
        if not np.array_equal(t.verdicts,
                              udirect["verdict"][s:s + t.n]):
            raise SmokeFailure(f"[serve growth] chunk at {s} differs from "
                               f"the direct step")
    out["growth"] = {
        "records": len(uflows), "unique_paths": len(unique),
        "resets": sess.resets, "stale_chunks": len(stale)}
    log(f"[serve growth] {len(uflows)} records, {len(unique)} unique "
        f"paths: 1 session reset, {len(stale)} chunks resolved "
        f"session-reset and served when resubmitted; all verdicts equal "
        f"the direct step; delta scans (prefix, bank, B, L): {shapes}")

    # -- thread: the pack thread against concurrent submitters
    kd0 = _build.KERNELS["KD"].launches
    th, tleases = serve_loop(engine, provenance=False,
                             pack_interval_s=0.002)
    per = SERVE_STREAMS // SERVE_THREADS
    results = [[] for _ in range(SERVE_THREADS)]
    sheds = [0] * SERVE_THREADS
    deadline = time.perf_counter() + SERVE_THREAD_S

    def submitter(i):
        c = i
        while time.perf_counter() < deadline:
            s, sec = warm_chunk(c)
            try:
                t = th.submit(tleases[i * per + (c // SERVE_THREADS) % per],
                              *sec)
            except ShedError:
                sheds[i] += 1
                time.sleep(0.001)
                continue
            results[i].append((s, t))
            c += SERVE_THREADS

    import threading

    th.start()
    t0 = time.perf_counter()
    try:
        workers = [threading.Thread(target=submitter, args=(i,))
                   for i in range(SERVE_THREADS)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        for rs in results:
            for s, t in rs:
                v = t.wait(timeout=120.0)
                if not np.array_equal(v, want_of(s, t.n)["verdict"]):
                    raise SmokeFailure(f"[serve thread] chunk at {s} "
                                       f"differs from the direct step")
    finally:
        th.stop()
    t_wall = time.perf_counter() - t0
    n_rec = sum(t.n for rs in results for _, t in rs)
    kd_thread = _build.KERNELS["KD"].launches - kd0
    check(th.pack_failures == 0, f"[serve thread] {th.pack_failures} "
                                 f"pack failures")
    check(kd_thread > 0, "[serve thread] KD never launched from the pack "
                         "thread")
    out["thread"] = {"records": n_rec, "packs": th.ring.packs,
                     "wall_s": t_wall, "records_per_s": n_rec / t_wall,
                     "sheds": sum(sheds), "kd_launches": kd_thread}
    log(f"[serve thread] {SERVE_THREADS} submitters over {per} leases "
        f"each for {SERVE_THREAD_S} s, pack thread on: {n_rec} records in "
        f"{th.ring.packs} packs, {t_wall:.3f} s to the last verdict "
        f"({n_rec / t_wall:.0f} records/s), {sum(sheds)} queue-full sheds "
        f"retried, KD launched {kd_thread} times from the pack thread; "
        f"every verdict equal to the direct step on {card}")

    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    variants = kd_variants()
    out["serve_wall_s"] = time.perf_counter() - t_serve
    check(launches["KD"] > 0, "[serve] kernel KD never launched")
    out["setup_wall_s"] = t_serve - t_phase
    log(f"[serve] serving passes: launches {launches}, KD by variant "
        f"{variants}, {out['serve_wall_s']:.1f} s (set-up "
        f"{out['setup_wall_s']:.1f} s)")
    return {"launches": launches, "kd_variants": variants,
            "delta_shapes": shapes, "report": out}


def growth_kd(errs, rows, arrays, serve, card):
    """KD at the growth pass's delta shapes, through phases 3 and 4's
    code and outside the serve count: the shapes SESSION_DELTAS lacks
    are held against the plain version and timed here (their rows join
    ``rows``); the serve report gains KD's device ms at every delta
    scan of the pass, and is returned."""
    deltas = sorted({(p, b, l) for p, _, b, l in serve["delta_shapes"]}
                    - set(SESSION_DELTAS))
    log(f"phase 7: KD at the growth pass's delta shapes {deltas}, against "
        f"its plain version")
    inputs = session_inputs_of(arrays, deltas, seed=5)
    session_check(errs, inputs)
    rows["KD"].extend(kernel_times({}, {}, {}, inputs, card)["KD"])
    kd_ms = {r[0]: r[2] for r in rows["KD"]}
    report = serve["report"]
    report["growth"]["delta_scans"] = [
        [p, list(bank), b, l, kd_ms[f"session-{p}-{b}"]]
        for p, bank, b, l in serve["delta_shapes"]]
    log(f"[serve growth] KD device ms at each delta scan (prefix, bank, "
        f"B, L, ms; exact): {report['growth']['delta_scans']} on {card}")
    return report


# --------------------------------------------------------- loader plane
class ChurnWorld:
    """The http scenario's server and client, resolved through the
    port's policy repository, with churn: one extra rule on the server
    per churned path (the reference fleet's ``/churn{step}/.*`` shape).
    ``keep`` cuts the scenario rule to its first ``keep`` http rules
    (the canary's dropped-rules snapshot). Only the server re-resolves:
    the client keeps its MapState object, so the loader fingerprints
    O(Δ)."""

    def __init__(self):
        from cilium_tpu_torch.core.identity import IdentityAllocator
        from cilium_tpu_torch.core.labels import LabelSet
        from cilium_tpu_torch.ingest import synth
        from cilium_tpu_torch.policy.selectorcache import SelectorCache

        _, self.scenario = synth.realize_scenario(
            synth.scenario_by_name("http", N_RULES, N_FLOWS),
            resolve=False)
        self.ids = self.scenario.ids
        alloc = IdentityAllocator()
        self.labels = {}
        for name, lbls in self.scenario.endpoints.items():
            self.labels[name] = LabelSet.from_dict(lbls)
            check(alloc.allocate(self.labels[name]) == self.ids[name],
                  "identity allocation differs from the scenario's")
        self.cache = SelectorCache(alloc)
        self.client = self._resolve((), None)["client"]

    def _rules(self, paths, keep):
        import dataclasses

        from cilium_tpu_torch.core.flow import Protocol
        from cilium_tpu_torch.policy import api

        rules = list(self.scenario.rules)
        if keep is not None:
            r = rules[0]
            ing = r.ingress[0]
            pr = ing.to_ports[0]
            pr = dataclasses.replace(pr, rules=dataclasses.replace(
                pr.rules, http=pr.rules.http[:keep]))
            rules[0] = dataclasses.replace(r, ingress=(
                dataclasses.replace(ing, to_ports=(pr,)),))
        sel = api.EndpointSelector.from_labels
        return rules + [api.Rule(
            endpoint_selector=sel(app="server"),
            ingress=(api.IngressRule(
                from_endpoints=(sel(app="client"),),
                to_ports=(api.PortRule(
                    ports=(api.PortProtocol(80, Protocol.TCP),),
                    rules=api.L7Rules(http=(api.PortRuleHTTP(
                        path=p, method="GET"),))),)),),
            labels=("synth=churn",)) for p in paths]

    def _resolve(self, paths, keep):
        from cilium_tpu_torch.policy.mapstate import PolicyResolver
        from cilium_tpu_torch.policy.repository import Repository

        repo = Repository()
        repo.add(self._rules(paths, keep), sanitize=False)
        res = PolicyResolver(repo, self.cache)
        return {n: res.resolve(ls) for n, ls in self.labels.items()}

    def snapshot(self, paths=(), keep=None):
        return {self.ids["server"]: self._resolve(paths, keep)["server"],
                self.ids["client"]: self.client}

    def probe(self, path):
        """A GET of ``path``'s churned prefix, from client to server."""
        import dataclasses

        f = self.scenario.flows[0]
        return dataclasses.replace(f, http=dataclasses.replace(
            f.http, method="GET", path=path.replace("/.*", "/x")))

    def sample(self, paths=()):
        """The oracle sample: every 20th flow (ORACLE_SAMPLE of them),
        and the probe of the last churned path."""
        flows = self.scenario.flows[::N_FLOWS // ORACLE_SAMPLE]
        return flows[:ORACLE_SAMPLE] + [self.probe(p) for p in paths[-1:]]


def oracle_verdicts(paths, lo, hi):
    """The CPU oracle's verdicts of the oracle sample's flows [lo, hi)
    under the snapshot with churned ``paths``. Runs in a worker process
    (the oracle is the correctness reference, not a fast path: at 1000
    rules its regex matching takes seconds per hundred flows)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cilium_tpu_torch.policy.oracle import OracleVerdictEngine

    w = ChurnWorld()
    flows = w.sample(paths)[lo:hi]
    out = OracleVerdictEngine(w.snapshot(paths)).verdict_flows(flows)
    return [int(v) for v in out["verdict"]]


def start_oracle(pool):
    """Submit the oracle samples phase 8 checks against: the base
    snapshot (what every delete commits) and the last add's, each split
    in halves over the pool's processes."""
    last_add = (f"/churn{LOADER_UPDATES - 2}/.*",)
    n = ORACLE_SAMPLE
    jobs = {}
    for paths in ((), last_add):
        m = n + len(paths)
        jobs[paths] = [pool.submit(oracle_verdicts, paths, lo, hi)
                       for lo, hi in ((0, m // 2), (m // 2, m))]
    return jobs


def oracle_results(jobs):
    return {paths: sum((f.result() for f in fs), [])
            for paths, fs in jobs.items()}


def loader_phase(card, oracle_jobs):
    """Phase 8: the policy built, staged, hot-swapped and rolled back
    through the port's ``Loader`` with its defaults (gate on,
    content-addressed banks, two compile workers) into a temporary
    cache directory. Returns the report, the batch configuration's and
    the serving passes' launch counts, and the engines KD is held and
    timed at after the counts are read: the cold build's, and the
    rollback retry's (its pattern adds a byte class, and the wider path
    stack runs KD's global variant for the rest of the phase)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.core.flow import L7Type
    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine import dfa_dense_cuda as kd
    from cilium_tpu_torch.engine import memo as memo_mod
    from cilium_tpu_torch.engine.verdict import (
        TorchVerdictEngine,
        batch_to_device,
    )
    from cilium_tpu_torch.runtime import faults
    from cilium_tpu_torch.runtime.canary import (
        CanaryController,
        CanaryRefused,
    )
    from cilium_tpu_torch.runtime.loader import Loader
    from cilium_tpu_torch.runtime.metrics import (
        LOADER_ROLLBACKS,
        METRICS,
        WARM_RESTORES,
    )
    from cilium_tpu_torch.runtime.serveloop import ServeLoop

    t_phase = time.perf_counter()
    world = ChurnWorld()
    flows = world.scenario.flows
    server = world.ids["server"]
    # the loader's engine reads its DFA arm when it is staged: the
    # gather arm (KD), as the batch configuration ``auto``
    os.environ["CILIUM_TPU_DFA_IMPL"] = "gather"
    out = {"card": card, "updates": LOADER_UPDATES}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_loader_")
    loaders = []
    try:
        cfg = Config()
        cfg.loader.cache_dir = tmp.name
        check(cfg.enable_tpu_offload and cfg.loader.bank_isolation
              and cfg.compile.workers == 2,
              "the port's Config must default to the gate on, "
              "content-addressed banks and two compile workers")

        # -- 1. cold build
        def span_s(name):
            return METRICS.histo_sum("cilium_tpu_span_seconds",
                                     {"span": name})

        spans0 = {s: span_s(s) for s in ("policy_compile", "policy_stage")}
        loader = Loader(cfg)
        loaders.append(loader)
        t0 = time.perf_counter()
        engine = loader.regenerate(world.snapshot(), revision=1)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        check(isinstance(engine, TorchVerdictEngine)
              and engine.device.type == DEVICE,
              "Loader() must stage a TorchVerdictEngine on the card")
        arrays = engine.policy.arrays
        path_shape = tuple(arrays["path_trans"].shape)
        status = loader.bank_status()
        reg = loader.bank_registry
        plan = kd.plan_launch(*path_shape, BATCH, 32,
                              arrays["path_accept"].shape[2],
                              arrays["rp_path_gaccept"].shape[2])
        out["cold"] = {
            "wall_s": cold_s,
            "compile_s": span_s("policy_compile") - spans0["policy_compile"],
            "stage_s": span_s("policy_stage") - spans0["policy_stage"],
            "plan": status["plan"], "kernel_plan": status["kernel_plan"],
            "bank_compiles": reg.compiles, "path_stack": list(path_shape),
            "kd_plan": plan._asdict()}
        log(f"[loader cold] regenerate {cold_s:.3f} s (compile "
            f"{out['cold']['compile_s']:.3f} s, stage "
            f"{out['cold']['stage_s']:.3f} s); bank plan {status['plan']}, "
            f"{reg.compiles} bank groups compiled; path stack {path_shape}; "
            f"KD plan at B={BATCH}, L=32: {plan}")
        check(status["degraded"] is False and status["quarantined"] == 0,
              "[loader cold] a bank quarantined")
        check(plan.variant == "smem",
              "[loader cold] the loader's path bank must plan KD's "
              "shared-memory variant")

        # -- 2. batch: the fused step on the loader's engine
        plain = TorchVerdictEngine(engine.policy, device="cpu",
                                   cfg=cfg.engine)
        host = host_batches(engine.policy, flows, cfg.engine)
        setup = {"engine": engine, "plain": plain, "host": host,
                 "batches": [batch_to_device(h, DEVICE) for h in host],
                 "host_cpu": [batch_to_device(h, "cpu") for h in host]}
        setup["full"] = setup["batches"][0]
        batch = drive_config("auto", setup, len(flows), card,
                             label="loader batch")
        out["batch"] = {k: batch[k] for k in (
            "batch_ms", "mix", "busy_share", "device_kernels")}

        # -- 4.-7. the serving passes on the real loader
        ctrl = CanaryController(loader, sample_fraction=1.0,
                                diff_budget=0.0,
                                min_samples=CANARY_MIN_SAMPLES)
        bystanders = [dataclasses.replace(f, l7=L7Type.NONE, http=None)
                      for f in flows[:BYSTANDERS]]
        corpus = flows + bystanders
        corpus_secs = [chunk_sections(corpus[s:s + SERVE_CHUNK])
                       for s in range(0, len(corpus), SERVE_CHUNK)]
        http_rows = len({(f.http.method, f.http.path, f.http.host,
                          f.http.headers) for f in flows})
        sample_idx = list(range(0, N_FLOWS, N_FLOWS // ORACLE_SAMPLE))[
            :ORACLE_SAMPLE]
        torch.cuda.synchronize()
        _build.reset_launches()
        loop = ServeLoop(loader, capacity=SERVE_STREAMS, lease_ttl_s=600.0,
                         canary=ctrl)
        leases = [loop.connect(f"s{i}") for i in range(SERVE_STREAMS)]

        def serve(secs):
            tickets = [loop.submit(leases[k % SERVE_STREAMS], *sec)
                       for k, sec in enumerate(secs)]
            while not all(t.done for t in tickets):
                loop.step()
            check(all(t.error is None for t in tickets),
                  "[loader] a chunk failed")
            return np.concatenate([t.verdicts for t in tickets])

        got = serve(corpus_secs)
        memo = loop.ring.session.memo
        check(memo.misses == loop.ring.session.n_rows == http_rows + 1,
              f"[loader churn] cold pack: {memo.misses} misses, "
              f"{loop.ring.session.n_rows} rows, want {http_rows} http rows "
              f"and one L4 row")
        check(np.array_equal(got, plain.verdict_flows(corpus)["verdict"]),
              "[loader churn] cold pack differs from the plain engine")

        # 4. churn: alternate adding and deleting one path rule
        updates, probes = [], set()
        oracle = None
        for step in range(LOADER_UPDATES):
            add = step % 2 == 0
            path = f"/churn{step if add else step - 1}/.*"
            paths = (path,) if add else ()
            snap = world.snapshot(paths)
            probe = world.probe(path)
            probe_chunk = [probe] + corpus[:SERVE_CHUNK - 1]
            probe_secs = chunk_sections(probe_chunk)
            c0, m0 = reg.compiles, memo.misses
            g0 = memo_mod.policy_generation()
            t0 = time.perf_counter()
            loader.regenerate(snap, revision=2 + step)
            tk = loop.submit(leases[step % SERVE_STREAMS], *probe_secs)
            loop.step()
            enforce_ms = (time.perf_counter() - t0) * 1e3
            check(tk.done and tk.error is None,
                  f"[loader churn] update {step}: probe chunk not served")
            probes.add(probe.http.path)
            got = np.concatenate([tk.verdicts, serve(corpus_secs)])
            delta = memo_mod.POLICY_GENERATION.deltas_since(g0)
            compiles = reg.compiles - c0
            misses = memo.misses - m0
            want = TorchVerdictEngine(loader.engine.policy, device="cpu",
                                      cfg=cfg.engine).verdict_flows(
                probe_chunk + corpus)["verdict"]
            stale = int((got != want).sum())
            stack = tuple(loader.engine.policy.arrays["path_trans"].shape)
            updates.append({"step": step, "op": "add" if add else "delete",
                            "enforce_ms": enforce_ms, "compiles": compiles,
                            "misses": misses, "stale": stale,
                            "path_stack": stack,
                            "kd_variant": kd.plan_launch(
                                *stack, BATCH, 32).variant})
            check(stale == 0, f"[loader churn] update {step}: {stale} stale "
                              f"verdicts against the plain engine")
            check(int(got[0]) == (5 if add else 2),
                  f"[loader churn] update {step}: probe {path} verdict "
                  f"{int(got[0])}")
            check(not delta.full and delta.changed_identities ==
                  frozenset({server}),
                  f"[loader churn] update {step}: delta {delta} is not "
                  f"scoped to the server identity")
            check((1 <= compiles <= 3) if add else compiles == 0,
                  f"[loader churn] update {step} ({'add' if add else 'delete'}"
                  f"): {compiles} bank compiles")
            check(misses == http_rows + len(probes),
                  f"[loader churn] update {step}: {misses} memo misses, the "
                  f"delta names {http_rows + len(probes)} rows")
            if not add or step == LOADER_UPDATES - 2:
                if oracle is None:
                    t_w = time.perf_counter()
                    oracle = oracle_results(oracle_jobs)
                    out["oracle_wait_s"] = time.perf_counter() - t_w
                served = [int(got[SERVE_CHUNK + i]) for i in sample_idx]
                if add:
                    served.append(int(got[0]))
                wrong = sum(a != b for a, b in zip(served, oracle[paths]))
                check(wrong == 0 and len(served) == len(oracle[paths]),
                      f"[loader churn] update {step}: {wrong} of "
                      f"{len(served)} sampled verdicts differ from the "
                      f"oracle")
        ms = sorted(u["enforce_ms"] for u in updates)
        out["churn"] = {
            "enforce_ms_p50": statistics.median(ms),
            "enforce_ms_p99": ms[min(len(ms) - 1,
                                     int(round(0.99 * (len(ms) - 1))))],
            "compiles": [u["compiles"] for u in updates],
            "misses": [u["misses"] for u in updates],
            "stale": sum(u["stale"] for u in updates),
            # the committed path stacks and KD's variant for each: a
            # churned pattern can widen a bank past the shared-memory
            # budget
            "path_stacks": sorted({u["path_stack"] for u in updates}),
            "kd_variants": [u["kd_variant"] for u in updates],
            "records_per_update": len(corpus) + SERVE_CHUNK,
            "oracle_checks": sum(1 for u in updates if u["op"] == "delete")
            + 1}
        log(f"[loader churn] {LOADER_UPDATES} updates (add/delete of one "
            f"path rule on the server): update to enforcement p50 "
            f"{out['churn']['enforce_ms_p50']:.3f} ms, p99 "
            f"{out['churn']['enforce_ms_p99']:.3f} ms; bank compiles "
            f"{out['churn']['compiles']}; path stacks "
            f"{out['churn']['path_stacks']}, KD variants "
            f"{out['churn']['kd_variants']}; memo misses "
            f"{out['churn']['misses']} (the server's http rows and the "
            f"probes; the {BYSTANDERS} L4 records never refill); 0 stale "
            f"verdicts against the plain engine over "
            f"{len(corpus) + SERVE_CHUNK} records an update, and the oracle "
            f"sample equal at {out['churn']['oracle_checks']} updates on "
            f"{card}")

        # 5. rollback: the swap point fires once
        rb0 = METRICS.get(LOADER_ROLLBACKS)
        serving, rev = loader.engine, loader.revision
        path = "/churn-rollback/.*"
        probe_secs = chunk_sections([world.probe(path)])
        raised = False
        with faults.inject(faults.FaultPlan(
                [faults.FaultRule("loader.swap", times=1)])):
            try:
                loader.regenerate(world.snapshot((path,)), revision=rev + 1)
            except faults.FaultInjected:
                raised = True
        check(raised and loader.engine is serving and loader.revision == rev
              and METRICS.get(LOADER_ROLLBACKS) == rb0 + 1,
              "[loader rollback] the previous engine must keep serving "
              "and the rollback be counted")
        # a rollback commits a full delta: the session re-interns the
        # corpus on these packs. Every pass from here on is held against
        # a plain engine of the policy it serves
        probe_all = [world.probe(path)] + corpus

        def held(label, got, want):
            stale = int((got != want).sum())
            check(stale == 0, f"[loader {label}] {stale} stale verdicts "
                              f"against the plain engine")
            return stale

        want_before = TorchVerdictEngine(
            serving.policy, device="cpu", cfg=cfg.engine).verdict_flows(
            probe_all)["verdict"]
        got = serve([probe_secs] + corpus_secs)
        stale = held("rollback", got, want_before)
        before = int(got[0])
        loader.regenerate(world.snapshot((path,)), revision=rev + 1)
        retry = loader.engine
        plain_retry = TorchVerdictEngine(retry.policy, device="cpu",
                                         cfg=cfg.engine)
        want_all = plain_retry.verdict_flows(probe_all)
        got = serve([probe_secs] + corpus_secs)
        stale += held("rollback retry", got, want_all["verdict"])
        after = int(got[0])
        check(before == 2 and after == 5 and loader.revision == rev + 1,
              f"[loader rollback] probe {before} while rolled back, "
              f"{after} after the retry")
        retry_stack = tuple(retry.policy.arrays["path_trans"].shape)
        out["rollback"] = {"rollbacks": METRICS.get(LOADER_ROLLBACKS) - rb0,
                           "probe_before": before, "probe_after": after,
                           "stale": stale, "path_stack": list(retry_stack),
                           "kd_variant": kd.plan_launch(
                               *retry_stack, BATCH, 32).variant}
        log(f"[loader rollback] injected swap fault: rolled back (counted), "
            f"the previous engine served (probe {before}); the retry "
            f"committed (probe {after}), path stack {retry_stack} (KD "
            f"{out['rollback']['kd_variant']}); both passes equal to the "
            f"plain engine")

        # 6. warm restart: a same-artifact restore on the serving
        # loader first (it keeps the engine and the memo), then a fresh
        # loader on the same cache (its full delta would refill the
        # serving loop's memo: both loaders share the process's policy
        # generation)
        w0 = METRICS.get(WARM_RESTORES)
        check(loader.snapshot_warm(), "[loader warm] snapshot_warm")
        m0, serving = memo.misses, loader.engine
        check(loader.restore_warm() and loader.engine is serving,
              "[loader warm] a same-artifact restore must keep the engine")
        warm_stale = held("warm", serve(corpus_secs), want_all["verdict"][1:])
        check(memo.misses == m0, f"[loader warm] {memo.misses - m0} memo "
                                 f"misses after a same-artifact restore")
        fresh = Loader(cfg)
        loaders.append(fresh)
        t0 = time.perf_counter()
        check(fresh.restore_warm(), "[loader warm] restore_warm missed")
        restore_s = time.perf_counter() - t0
        check(fresh.bank_registry.compiles == 0
              and fresh.revision == loader.revision,
              f"[loader warm] {fresh.bank_registry.compiles} bank compiles "
              f"on a warm restore")
        restored = fresh.engine.verdict_flows(probe_all)
        assert_lanes("[loader warm] the restored engine vs the drained one",
                     restored, loader.engine.verdict_flows(probe_all))
        assert_lanes("[loader warm] the restored engine vs the plain one",
                     restored, want_all)
        fresh.close()
        out["warm"] = {"restore_s": restore_s,
                       "bank_compiles": fresh.bank_registry.compiles,
                       "same_artifact_misses": memo.misses - m0,
                       "restores": METRICS.get(WARM_RESTORES) - w0,
                       "stale": warm_stale}
        log(f"[loader warm] a same-artifact restore kept the engine and "
            f"the memo (0 misses on the next pack, equal to the plain "
            f"engine); a fresh loader on the cache restored in "
            f"{restore_s:.3f} s with 0 bank compiles, all ten lanes equal "
            f"to the drained engine and to the plain one")

        # 7. canary: a dropped-rules snapshot is refused, a clean one
        # commits
        rev, per = loader.revision, loader.per_identity
        n_chunks = -(-CANARY_MIN_SAMPLES // 8)
        ctrl.stage(world.snapshot((path,), keep=CANARY_KEEP_RULES),
                   revision=rev + 1)
        n_canary = min(n_chunks * SERVE_CHUNK, len(corpus))
        held("canary", serve(corpus_secs[:n_chunks]),
             want_all["verdict"][1:1 + n_canary])
        refused = False
        try:
            ctrl.try_commit()
        except CanaryRefused:
            refused = True
        bad = ctrl.report()
        check(refused and bad["diffs"] > 0 and loader.revision == rev
              and loader.engine is serving and loader.per_identity is per,
              f"[loader canary] the dropped-rules rollout must be refused "
              f"with the serving triple untouched: {bad}")
        ctrl.stage(world.snapshot((path,)), revision=rev + 1)
        held("canary", serve(corpus_secs[:n_chunks]),
             want_all["verdict"][1:1 + n_canary])
        committed = ctrl.try_commit()
        good = ctrl.report()
        check(good["diffs"] == 0 and loader.revision == rev + 1
              and committed is loader.engine,
              f"[loader canary] the clean rollout must commit: {good}")
        out["canary"] = {"refused": bad, "committed": good}
        log(f"[loader canary] dropped-rules rollout refused ({bad['diffs']} "
            f"of {bad['samples']} sampled verdicts differ), serving triple "
            f"untouched; clean rollout committed ({good['samples']} samples, "
            f"0 diffs)")
        torch.cuda.synchronize()
        serving_launches = {k: v.launches for k, v in _build.KERNELS.items()}
        serving_variants = kd_variants()
        launches = {k: batch["launches"][k] + serving_launches[k]
                    for k in serving_launches}
        variants = dict(batch["kd_variants"])
        for v, n in serving_variants.items():
            variants[v] = variants.get(v, 0) + n
        check(serving_launches["KD"] > 0,
              "[loader] KD never launched on the serving passes")
        out["launches"] = launches
        out["wall_s"] = time.perf_counter() - t_phase
        # KD is held and timed at the cold build's arrays (the path
        # stack the reference's headline bench builds) and at the
        # retry's, which the rest of the phase ran
        return out, launches, variants, {"loader-path": engine,
                                         "loader-path-retry": retry}
    finally:
        for ld in loaders:
            ld.close()
        tmp.cleanup()


def loader_kernels(errs, rows, engine, flows, card, suffix="",
                   nfa_arm=True):
    """KD (and K1 under ``nfa-bitset``, with ``nfa_arm``) at one of the
    loader's staged engines' arrays, against the plain versions and
    timed through phase 4's code, after phase 8's counts were read.
    Returns the KD row of the path field (``loader-path`` + ``suffix``)
    and the variants KD ran for the path field."""
    from cilium_tpu_torch.engine import dfa_dense_cuda
    from cilium_tpu_torch.engine.verdict import batch_to_device

    host = host_batches(engine.policy, flows, engine.cfg)
    full = batch_to_device(host[0], DEVICE)
    fields = field_inputs_of(engine, full)
    path_variants = {}
    for prefix, (arr, data, lens) in fields.items():
        a = (arr[f"{prefix}_trans"], arr[f"{prefix}_byteclass"],
             arr[f"{prefix}_start"], data, lens)
        acc = arr[f"{prefix}_accept"]
        extra = arr.get("rp_path_gaccept") if prefix == "path" else None
        v0 = kd_variants()
        hold(errs, "KD", f"loader{suffix} {prefix} {tuple(a[0].shape)} "
                         f"B={data.shape[0]} L={data.shape[1]}",
             dfa_dense_cuda.dense_scan_cuda(*a, accept=acc, extra=extra),
             dfa_dense_cuda.dense_scan_plain(*a, accept=acc, extra=extra))
        if prefix == "path":
            path_variants = {v: n - v0.get(v, 0)
                             for v, n in kd_variants().items()
                             if n - v0.get(v, 0)}
    nfa_fields = nfa_fields_of(errs, engine, full) if nfa_arm else {}
    got = kernel_times({"path": fields["path"]}, nfa_fields, {}, {}, card,
                       tag="loader-", suffix=suffix)
    for kid, rs in got.items():
        rows[kid].extend(rs)
    return (next(r for r in got["KD"] if r[0] == f"loader-path{suffix}"),
            path_variants)


def nfa_fields_of(errs, engine, full):
    """K1 held at ``engine``'s policy staged under ``nfa-bitset``, for
    each field whose banks fit it; returns those fields' inputs."""
    import dataclasses

    from cilium_tpu_torch.engine import nfa_cuda
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine

    nfa = TorchVerdictEngine(engine.policy, device=DEVICE,
                             cfg=dataclasses.replace(
                                 engine.cfg, kernel_impl="nfa-bitset"))
    nfa_fields = {p: v for p, v in field_inputs_of(nfa, full).items()
                  if f"{p}_nfa_follow" in v[0]}
    log(f"[loader nfa-bitset] impl_plan {json.dumps(nfa.impl_plan, sort_keys=True)}")
    for prefix, (arr, data, lens) in nfa_fields.items():
        n = [arr[f"{prefix}_nfa_{k}"] for k in
             ("follow", "acc_cls", "byteclass", "start")] + [data, lens]
        hold(errs, "K1", f"loader {prefix} {tuple(n[1].shape)} "
                         f"B={data.shape[0]} L={data.shape[1]}",
             nfa_cuda.nfa_finals_cuda(*n), nfa_cuda.nfa_finals_plain(*n))
    return nfa_fields


# ------------------------------------------------ the service and stream
def quantiles_ms(seconds):
    """p50/p99 in ms (nearest rank) of a list of seconds."""
    xs = sorted(seconds)
    check(bool(xs), "no latency samples")
    q = lambda p: xs[min(len(xs) - 1, int(p * len(xs)))] * 1e3  # noqa
    return {"p50_ms": q(0.50), "p99_ms": q(0.99), "samples": len(xs)}


def run_threads(fn, n, what):
    """``fn(i)`` on ``n`` threads; fails the run if any raised or hung."""
    import threading

    errors = []

    def wrap(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(f"{type(e).__name__}: {e}")

    ts = [threading.Thread(target=wrap, args=(i,), daemon=True)
          for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    check(not errors and not any(t.is_alive() for t in ts),
          f"[service {what}] a client thread failed: {errors[:3]}")


def kd_rose(k0, what):
    """Fail unless KD launched since its count read ``k0``."""
    from cilium_tpu_torch.engine import _build

    check(_build.KERNELS["KD"].launches > k0,
          f"[service {what}] KD never launched: the pass did not reach "
          f"the card")


def breaker_counts():
    from cilium_tpu_torch.runtime.metrics import (
        BREAKER_FALLBACK_VERDICTS,
        BREAKER_RECOVERIES,
        BREAKER_TRIPS,
        METRICS,
    )

    return tuple(METRICS.get(n) for n in (
        BREAKER_TRIPS, BREAKER_RECOVERIES, BREAKER_FALLBACK_VERDICTS))


def route_counts():
    from cilium_tpu_torch.runtime.metrics import METRICS, STREAM_CHUNKS

    return {r: METRICS.get(STREAM_CHUNKS, {"route": r})
            for r in ("session", "ring", "oracle", "fallback")}


@contextlib.contextmanager
def verdict_service(loader, path, **kw):
    from cilium_tpu_torch.runtime.service import VerdictService

    svc = VerdictService(loader, path, **kw)
    svc.start()
    try:
        yield svc
    finally:
        svc.stop()


def check_pass(loader, path, dicts, want, deadline_ms, drain_workers):
    """bench_service.py's closed loop: CHECK_THREADS clients, each
    CHECK_WARMUP warm requests then CHECK_PER_THREAD timed ``check``s
    of its own flows; every verdict exact."""
    import threading

    from cilium_tpu_torch.runtime.metrics import (
        METRICS,
        MICROBATCH_SECONDS,
        MICROBATCH_SIZE,
    )
    from cilium_tpu_torch.runtime.service import VerdictClient

    n = CHECK_THREADS
    lat = [[] for _ in range(n)]
    wrong = []
    start = threading.Barrier(n + 1, timeout=120)
    with verdict_service(loader, path, batch_max=SVC_BATCH_MAX,
                         deadline_ms=deadline_ms,
                         drain_workers=drain_workers):
        def worker(t):
            mine = list(range(t, len(dicts), n))
            c = VerdictClient(path)
            try:
                for i in range(CHECK_WARMUP):
                    c.call({"op": "check", "flow": dicts[mine[i]]})
                start.wait()
                for i in range(CHECK_PER_THREAD):
                    k = mine[i % len(mine)]
                    t0 = time.perf_counter()
                    r = c.call({"op": "check", "flow": dicts[k]})
                    lat[t].append(time.perf_counter() - t0)
                    if r.get("verdict") != int(want[k]):
                        wrong.append((k, r))
            finally:
                c.close()

        main = threading.Thread(target=run_threads,
                                args=(worker, n, "check"), daemon=True)
        main.start()
        try:
            start.wait()
        except threading.BrokenBarrierError:
            check(False, "[service check] a client failed before the "
                         "timed requests")
        h0 = METRICS.histogram(MICROBATCH_SIZE)
        s0 = METRICS.histo_sum(MICROBATCH_SIZE)
        b0 = METRICS.histo_sum(MICROBATCH_SECONDS)
        t0 = time.perf_counter()
        main.join(timeout=600)
        wall = time.perf_counter() - t0
        h1 = METRICS.histogram(MICROBATCH_SIZE)
        s1 = METRICS.histo_sum(MICROBATCH_SIZE)
        b1 = METRICS.histo_sum(MICROBATCH_SECONDS)
    check(not main.is_alive(), "[service check] the clients hung")
    check(not wrong, f"[service check] {len(wrong)} verdicts differ from "
                     f"the plain engine, e.g. {wrong[:2]}")
    samples = sum(lat, [])
    check(len(samples) == n * CHECK_PER_THREAD,
          "[service check] a client thread failed")
    hist = {k: h1[k] - h0.get(k, 0) for k in h1 if h1[k] - h0.get(k, 0)}
    batches = sum(hist.values())
    return {"deadline_ms": deadline_ms, "drain_workers": drain_workers,
            **quantiles_ms(samples), "rps": len(samples) / wall,
            "batches": batches, "mean_batch": (s1 - s0) / max(1, batches),
            "mean_batch_ms": (b1 - b0) * 1e3 / max(1, batches),
            "batch_size_hist": hist}


def stream_pass(path, images, expects, depth, one_at_a_time=False):
    """One StreamClient (credit on, ``depth`` chunks in the server's
    pipeline) sends every image while a second thread collects the
    verdicts as they land: records/s first send to last verdict, chunk
    send→verdict p50/p99; every verdict exact. ``one_at_a_time``: the
    client waits for each chunk's verdict before it sends the next, so
    no two chunks overlap anywhere (the control for the pipeline)."""
    import threading

    import numpy as np

    from cilium_tpu_torch.runtime.stream import StreamClient

    client = StreamClient(path, pipeline_depth=depth, timeout=300.0)
    sent, landed, got = {}, {}, {}
    answered = threading.Condition()

    def collect():
        for seq, r in client.results():
            with answered:
                landed[seq] = time.perf_counter()
                got[seq] = r
                answered.notify_all()

    th = threading.Thread(target=collect, daemon=True)
    try:
        th.start()
        t0 = time.perf_counter()
        for im in images:
            seq = client.send_image(im, trace_id="")
            sent[seq] = time.perf_counter()
            if one_at_a_time:
                with answered:
                    check(answered.wait_for(lambda: seq in got,
                                            timeout=300),
                          f"[service stream] seq {seq} unanswered")
        client.finish()
        th.join(timeout=300)
    finally:
        client.close()
    check(not th.is_alive() and len(got) == len(images),
          f"[service stream] {len(got)} of {len(images)} chunks answered")
    for seq, want in enumerate(expects):
        r = got[seq]
        check(not isinstance(r, Exception), f"[service stream] seq {seq} "
                                            f"failed: {r}")
        check(np.array_equal(r, want), f"[service stream] seq {seq} "
                                       f"differs from the plain engine")
    records = sum(len(e) for e in expects)
    return {"chunks": len(images), "records": records, "depth": depth,
            "one_at_a_time": one_at_a_time,
            "records_per_s": records / (max(landed.values()) - t0),
            **{f"chunk_{k}": v for k, v in quantiles_ms(
                [landed[s] - sent[s] for s in sent]).items()}}


def kafka_frames(kafka, flows):
    """One request frame per flow, as ``bench.py``'s Kafka lane encodes
    them, and the flows the parser will verdict for each."""
    import dataclasses

    from cilium_tpu_torch.core.flow import L7Type

    frames, parsed = [], []
    for i, f in enumerate(flows):
        fr = kafka.encode_request(
            f.kafka.api_key, 0 if f.kafka.api_key == kafka.API_METADATA
            else 1, i, f.kafka.client_id, f.kafka.topic)
        frames.append(fr)
        parsed.append([dataclasses.replace(f, l7=L7Type.KAFKA, kafka=r)
                       for r in kafka.parse_request_records(fr[4:])])
    return frames, parsed


def service_phase(card):
    """Phase 9: the port's ``VerdictService`` and stream over a fresh
    ``Loader(Config())`` on the card (content-addressed banks, the
    http-1000 snapshot, a temporary cache directory), every verdict held
    against a ``device="cpu"`` engine of the policy it was served under.
    Returns the report, the passes' launch counts and KD's variants,
    and what KD is held and timed at afterwards."""
    import base64
    import tempfile
    import threading

    import numpy as np
    import torch

    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.core.flow import Verdict
    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
    from cilium_tpu_torch.ingest import binary, synth
    from cilium_tpu_torch.ingest.columnar import flows_to_columns
    from cilium_tpu_torch.ingest.hubble import flow_to_dict
    from cilium_tpu_torch.proxylib import kafka
    from cilium_tpu_torch.runtime.loader import Loader
    from cilium_tpu_torch.runtime.metrics import (
        METRICS,
        VERDICT_MEMO_INVALIDATIONS,
        VERDICT_MEMO_MISSES,
    )
    from cilium_tpu_torch.runtime.service import VerdictClient
    from cilium_tpu_torch.runtime.stream import StreamClient

    t_phase = time.perf_counter()
    os.environ["CILIUM_TPU_DFA_IMPL"] = "gather"
    world = ChurnWorld()
    flows = world.scenario.flows
    out = {"card": card}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_service_")
    sock = lambda name: os.path.join(tmp.name, f"{name}.sock")  # noqa
    loaders = []
    try:
        cfg = Config()
        cfg.loader.cache_dir = os.path.join(tmp.name, "http")
        cfg.breaker.probe_interval = BREAKER_PROBE_S
        check(cfg.enable_tpu_offload and cfg.loader.bank_isolation
              and not cfg.serve.enabled,
              "the port's Config must default to the gate on, "
              "content-addressed banks and no serve loop")
        loader = Loader(cfg, device=DEVICE)
        loaders.append(loader)
        engine = loader.regenerate(world.snapshot(), revision=1)
        check(isinstance(engine, TorchVerdictEngine)
              and engine.device.type == DEVICE,
              "[service] the loader must stage a TorchVerdictEngine on "
              "the card")
        plain = TorchVerdictEngine(engine.policy, device="cpu",
                                   cfg=cfg.engine)
        want = np.asarray(plain.verdict_flows(flows)["verdict"])
        dicts = [flow_to_dict(f) for f in flows[:CHECK_THREADS * 64]]
        # the Kafka loader is built before any stream opens: a fresh
        # loader's full delta would reset a live stream's session
        kcfg = Config()
        kcfg.loader.cache_dir = os.path.join(tmp.name, "kafka")
        kper, ksc = synth.realize_scenario(synth.scenario_by_name(
            "kafka", KAFKA_RULES, KAFKA_ROUND_TRIPS))
        kloader = Loader(kcfg, device=DEVICE)
        loaders.append(kloader)
        kengine = kloader.regenerate(kper, revision=1)
        frames, parsed = kafka_frames(kafka, ksc.flows)
        kplain = TorchVerdictEngine(kengine.policy, device="cpu",
                                    cfg=kcfg.engine)
        kv = kplain.verdict_flows(sum(parsed, []))["verdict"]
        passing = {int(Verdict.FORWARDED), int(Verdict.AUDIT),
                   int(Verdict.REDIRECTED)}
        allowed, k = [], 0
        for recs in parsed:
            allowed.append(all(int(v) in passing
                               for v in kv[k:k + len(recs)]))
            k += len(recs)
        # the stream's chunks: the 10000 flows repeated to
        # STREAM_RECORDS records, chunks of STREAM_CHUNK
        cols = flows_to_columns(flows)
        reps = -(-STREAM_RECORDS // len(flows))
        rec = np.concatenate([cols.rec] * reps)[:STREAM_RECORDS]
        l7 = np.concatenate([cols.l7] * reps)[:STREAM_RECORDS]
        expect = np.tile(want, reps)[:STREAM_RECORDS]
        bounds = [(a, min(a + STREAM_CHUNK, STREAM_RECORDS))
                  for a in range(0, STREAM_RECORDS, STREAM_CHUNK)]
        images = [binary.sections_to_bytes(rec[a:b], l7[a:b], cols.offsets,
                                           cols.blob) for a, b in bounds]
        expects = [expect[a:b] for a, b in bounds]
        out["set_up_s"] = time.perf_counter() - t_phase
        log(f"[service set-up] http-{N_RULES} and kafka-{KAFKA_RULES} loaders, "
            f"plain verdicts, {len(images)} stream chunks in "
            f"{out['set_up_s']:.1f} s")

        torch.cuda.synchronize()
        m0 = breaker_counts()
        _build.reset_launches()
        kd = _build.KERNELS["KD"]

        def unmoved(what):
            check(breaker_counts() == m0,
                  f"[service {what}] the breaker moved outside the fault "
                  f"pass: {m0} -> {breaker_counts()}")

        # -- 1. check, closed loop
        out["check"] = []
        for dl, workers in [(d, 1) for d in CHECK_DEADLINES_MS] + [
                (SVC_DEADLINE_MS, 4)] * DW4_REPEATS:
            k0 = kd.launches
            r = check_pass(loader, sock(f"check{len(out['check'])}"),
                           dicts, want, dl, workers)
            kd_rose(k0, "check")
            unmoved("check")
            out["check"].append(r)
            log(f"[service check] deadline {dl} ms, {workers} drain "
                f"worker(s): p50 {r['p50_ms']:.3f} ms, p99 "
                f"{r['p99_ms']:.3f} ms, {r['rps']:.1f} requests/s, "
                f"{r['batches']} batches, mean {r['mean_batch']:.2f} "
                f"flows and {r['mean_batch_ms']:.3f} ms, sizes "
                f"{r['batch_size_hist']} on {card}")

        # -- 2. verdict, bulk
        k0 = kd.launches
        req = {"op": "verdict", "flows": dicts[:BULK_FLOWS]}
        times = []
        with verdict_service(loader, sock("bulk"),
                             batch_max=SVC_BATCH_MAX,
                             deadline_ms=SVC_DEADLINE_MS) as svc:
            c = VerdictClient(svc.socket_path)
            try:
                for i in range(3 + BULK_TIMED):
                    t0 = time.perf_counter()
                    r = c.call(req)
                    if i >= 3:
                        times.append(time.perf_counter() - t0)
                    check(r.get("verdicts") == [int(v) for v in
                                                want[:BULK_FLOWS]],
                          f"[service verdict] differs: {str(r)[:200]}")
            finally:
                c.close()
        kd_rose(k0, "verdict")
        unmoved("verdict")
        out["verdict"] = {"flows": BULK_FLOWS,
                          "median_ms": statistics.median(times) * 1e3}
        log(f"[service verdict] {BULK_FLOWS} flows a request: median "
            f"{out['verdict']['median_ms']:.3f} ms over {BULK_TIMED} on "
            f"{card}")

        # -- 3. stream, private session
        k0, r0 = kd.launches, route_counts()
        shapes = []
        with verdict_service(loader, sock("stream"),
                             batch_max=SVC_BATCH_MAX,
                             deadline_ms=SVC_DEADLINE_MS) as svc:
            with delta_scans_noted(engine._arrays, shapes):
                out["stream"] = stream_pass(svc.socket_path, images,
                                            expects, STREAM_DEPTH)
            kd_rose(k0, "stream")
            cyc = [i % len(images) for i in range(DEPTH1_CHUNKS)]
            out["stream_depth1"] = stream_pass(
                svc.socket_path, [images[i] for i in cyc],
                [expects[i] for i in cyc], 1)
            out["stream_serial"] = stream_pass(
                svc.socket_path, [images[i] for i in cyc],
                [expects[i] for i in cyc], 1, one_at_a_time=True)
        r1 = route_counts()
        check(r1["session"] - r0["session"] == len(images)
              + 2 * DEPTH1_CHUNKS
              and all(r1[k] == r0[k] for k in ("ring", "oracle",
                                               "fallback")),
              f"[service stream] routes {r0} -> {r1}: every chunk must "
              f"take the session")
        unmoved("stream")
        first = next(s for s in shapes if s[0] == "path")
        out["stream"]["first_delta_scan"] = [first[0], list(first[1]),
                                             first[2], first[3]]
        for key in ("stream", "stream_depth1", "stream_serial"):
            s = out[key]
            log(f"[service {key}] {s['records']} records in {s['chunks']} "
                f"chunks at depth {s['depth']}"
                f"{', one at a time' if s['one_at_a_time'] else ''}: "
                f"{s['records_per_s']:.0f} "
                f"records/s, chunk p50 {s['chunk_p50_ms']:.3f} ms, p99 "
                f"{s['chunk_p99_ms']:.3f} ms on {card}")

        # -- 4. stream through the serve loop's ring
        k0, r0 = kd.launches, route_counts()
        cfg.serve.enabled = True
        try:
            with verdict_service(loader, sock("ring"),
                                 batch_max=SVC_BATCH_MAX,
                                 deadline_ms=SVC_DEADLINE_MS) as svc:
                ring = {}

                def ring_client(i):
                    mine = list(range(i, len(images), RING_CLIENTS))
                    ring[i] = stream_pass(
                        svc.socket_path, [images[j] for j in mine],
                        [expects[j] for j in mine], STREAM_DEPTH)

                t0 = time.perf_counter()
                run_threads(ring_client, RING_CLIENTS, "ring")
                wall = time.perf_counter() - t0
                check(svc.serveloop is not None,
                      "[service ring] the serve loop was not built")
                st = svc.serveloop.status()
        finally:
            cfg.serve.enabled = False
        r1 = route_counts()
        kd_rose(k0, "ring")
        unmoved("ring")
        check(st["served_records"] == STREAM_RECORDS and st["packs"] > 0
              and r1["ring"] - r0["ring"] == len(images)
              and r1["session"] == r0["session"],
              f"[service ring] served {st['served_records']} records in "
              f"{st['packs']} packs, routes {r0} -> {r1}")
        out["ring"] = {"clients": RING_CLIENTS, "records": STREAM_RECORDS,
                       "records_per_s": STREAM_RECORDS / wall,
                       "packs": st["packs"],
                       "chunk_p50_ms": statistics.median(
                           r["chunk_p50_ms"] for r in ring.values()),
                       "chunk_p99_ms": max(r["chunk_p99_ms"]
                                           for r in ring.values())}
        log(f"[service ring] {RING_CLIENTS} streams, {STREAM_RECORDS} "
            f"records: {out['ring']['records_per_s']:.0f} records/s, "
            f"{st['packs']} packs on {card}")

        # -- 5. hot swap mid-stream
        k0 = kd.launches
        path = "/churn0/.*"
        probe = world.probe(path)
        pcols = flows_to_columns([probe])
        group = images[:SWAP_CHUNKS] + [binary.sections_to_bytes(
            pcols.rec, pcols.l7, pcols.offsets, pcols.blob)]
        before = [*expects[:SWAP_CHUNKS],
                  plain.verdict_flows([probe])["verdict"]]
        inv = {r: METRICS.get(VERDICT_MEMO_INVALIDATIONS, {"reason": r})
               for r in ("policy-swap", "bank-swap")}
        with verdict_service(loader, sock("swap")) as svc:
            c = StreamClient(svc.socket_path, timeout=300.0)
            try:
                got1 = [c.result(c.send_image(im)) for im in group]
                m1 = METRICS.get(VERDICT_MEMO_MISSES)
                t0 = time.perf_counter()
                engine2 = loader.regenerate(world.snapshot((path,)),
                                            revision=2)
                swap_s = time.perf_counter() - t0
                got2 = [c.result(c.send_image(im)) for im in group]
                misses = METRICS.get(VERDICT_MEMO_MISSES) - m1
                c.finish()
            finally:
                c.close()
        plain2 = TorchVerdictEngine(engine2.policy, device="cpu",
                                    cfg=cfg.engine)
        want2 = np.asarray(plain2.verdict_flows(flows)["verdict"])
        after = [np.tile(want2, reps)[a:b]
                 for a, b in bounds[:SWAP_CHUNKS]] + [
            plain2.verdict_flows([probe])["verdict"]]
        stale = sum(int(np.sum(g != w)) for g, w in
                    zip(got1 + got2, before + after))
        inv1 = {r: METRICS.get(VERDICT_MEMO_INVALIDATIONS, {"reason": r})
                - inv[r] for r in inv}
        kd_rose(k0, "swap")
        unmoved("swap")
        check(stale == 0, f"[service swap] {stale} stale verdicts")
        check(int(before[-1][0]) != int(after[-1][0]),
              "[service swap] the probe's verdict did not change")
        check(inv1 == {"policy-swap": 0, "bank-swap": 1},
              f"[service swap] the session must consume the bank delta, "
              f"not reset: invalidations {inv1}")
        http_rows = len({(f.http.method, f.http.path, f.http.host,
                          f.http.headers) for f in flows}) + 1
        out["swap"] = {"chunks": len(group), "stale": stale,
                       "regenerate_s": swap_s, "memo_misses": misses,
                       "http_rows": http_rows, "invalidations": inv1}
        log(f"[service swap] {len(group)} chunks either side of the "
            f"commit, 0 stale; the session refilled {misses:.0f} memo "
            f"rows ({http_rows} http rows with the probe), invalidations "
            f"{inv1}, regenerate {swap_s:.3f} s")

        # -- 6. Kafka through proxylib
        k0 = kd.launches
        lat, wrong = [], []
        with verdict_service(kloader, sock("kafka"),
                             batch_max=SVC_BATCH_MAX,
                             deadline_ms=SVC_DEADLINE_MS) as svc:
            def kafka_client(t):
                c = VerdictClient(svc.socket_path)
                try:
                    for i in range(t, len(frames), KAFKA_CLIENTS):
                        f = ksc.flows[i]
                        r = c.call({"op": "on_new_connection",
                                    "proto": "kafka", "conn": i,
                                    "ingress": True,
                                    "src": f.src_identity,
                                    "dst": f.dst_identity,
                                    "dport": f.dport})
                        check(r.get("ok"), f"[service kafka] {r}")
                        t0 = time.perf_counter()
                        r = c.call({"op": "on_data", "conn": i,
                                    "data_b64": base64.b64encode(
                                        frames[i]).decode()})
                        lat.append(time.perf_counter() - t0)
                        last = r["ops"][-1]
                        if last != [1 if allowed[i] else 2,
                                    len(frames[i])]:
                            wrong.append((i, r["ops"]))
                        c.call({"op": "close_connection", "conn": i})
                finally:
                    c.close()

            run_threads(kafka_client, KAFKA_CLIENTS, "kafka")
        kd_rose(k0, "kafka")
        unmoved("kafka")
        check(not wrong, f"[service kafka] {len(wrong)} ops differ from "
                         f"the plain engine, e.g. {wrong[:2]}")
        out["kafka"] = {"rules": KAFKA_RULES, "round_trips": len(frames),
                        "clients": KAFKA_CLIENTS,
                        "pass": int(sum(allowed)), **quantiles_ms(lat)}
        log(f"[service kafka] {len(frames)} on_data round trips over "
            f"{KAFKA_CLIENTS} clients ({out['kafka']['pass']} PASS): p50 "
            f"{out['kafka']['p50_ms']:.3f} ms, p99 "
            f"{out['kafka']['p99_ms']:.3f} ms on {card}")

        # -- 7. breaker: the engine's dispatch fault, then recovery
        out["breaker"] = breaker_pass(loader, sock("breaker"), flows,
                                      want2, m0)

        # -- 8. drain
        k0 = kd.launches
        m0 = breaker_counts()
        with verdict_service(loader, sock("drain"), batch_max=SVC_BATCH_MAX,
                             deadline_ms=DRAIN_DEADLINE_MS) as svc:
            got = {}

            def pending(i):
                c = VerdictClient(svc.socket_path)
                try:
                    got[i] = c.call({"op": "check", "flow": dicts[i]})
                finally:
                    c.close()

            th = threading.Thread(target=run_threads,
                                  args=(pending, DRAIN_PENDING, "drain"),
                                  daemon=True)
            th.start()
            # every check queued (the batch waits out its long
            # deadline) before the drain flushes them
            t_end = time.perf_counter() + 10.0
            while (len(svc.bridge.batcher._pending) < DRAIN_PENDING
                   and time.perf_counter() < t_end):
                time.sleep(0.005)
            c = VerdictClient(svc.socket_path)
            try:
                drained = c.call({"op": "drain"})
                th.join(timeout=60)
                pong = c.call({"op": "ping"})
                late = c.call({"op": "check", "flow": dicts[0]})
            finally:
                c.close()
        check(not th.is_alive() and len(got) == DRAIN_PENDING
              and all(got[i].get("verdict") == int(want2[i])
                      for i in got),
              f"[service drain] pending checks: {got}")
        check(drained.get("ok") and drained.get("warm_snapshot") is True
              and drained.get("flushed") == DRAIN_PENDING and pong.get("ok")
              and late.get("shed") is True,
              f"[service drain] drain {drained}, ping {pong}, a check "
              f"after it {late}")
        kd_rose(k0, "drain")
        unmoved("drain")
        out["drain"] = {"flushed": drained["flushed"],
                        "warm_snapshot": drained["warm_snapshot"]}
        log(f"[service drain] flushed {drained['flushed']} pending "
            f"checks, warm snapshot, ping answers")

        torch.cuda.synchronize()
        launches = {kid: k.launches for kid, k in _build.KERNELS.items()}
        variants = kd_variants()
        out["wall_s"] = time.perf_counter() - t_phase
        return out, launches, variants, {"engine": engine,
                                         "flows": flows,
                                         "delta": first}
    finally:
        for ld in loaders:
            ld.close()
        tmp.cleanup()


def breaker_pass(loader, path, flows, want, m0):
    """The engine's dispatch fault armed ``failure_threshold`` times:
    one trip; BREAKER_OPEN_CHECKS checks while open, answered by the
    oracle; once the probe interval has passed one probe recovers and
    KD launches again. The breaker's clock is held still from before
    the first fault until the open checks are answered, so none of them
    probes however long the oracle takes; then it runs again."""
    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.ingest.hubble import flow_to_dict
    from cilium_tpu_torch.runtime import faults
    from cilium_tpu_torch.runtime.service import VerdictClient

    kd = _build.KERNELS["KD"]
    with verdict_service(loader, path, batch_max=SVC_BATCH_MAX,
                         deadline_ms=SVC_DEADLINE_MS) as svc:
        br = svc.verdictor.breaker
        check(br.probe_interval == BREAKER_PROBE_S and br.state == br.CLOSED,
              "[service breaker] Config.breaker was not read")
        real = br.clock
        t_hold = real()
        held = [t_hold]
        br.clock = lambda: held[0] if held[0] is not None else real()
        n = br.failure_threshold
        dicts = [flow_to_dict(f) for f in flows[:n + 2 * BREAKER_OPEN_CHECKS]]
        c = VerdictClient(path)
        try:
            t0 = time.perf_counter()
            plan = faults.FaultPlan([faults.FaultRule("engine.dispatch",
                                                      times=n)])
            with faults.inject(plan):
                for i in range(n):
                    r = c.call({"op": "check", "flow": dicts[i]})
                    check(r.get("verdict") == int(want[i]),
                          f"[service breaker] fallback {i}: {r}")
            check(plan.counts("engine.dispatch")[1] == n
                  and br.state == br.OPEN,
                  f"[service breaker] {plan.counts('engine.dispatch')} "
                  f"faults, state {br.state}")
            k0 = kd.launches
            got = {}

            def open_check(j):
                cc = VerdictClient(path)
                try:
                    got[j] = cc.call({"op": "check",
                                      "flow": dicts[n + j]})
                finally:
                    cc.close()

            run_threads(open_check, BREAKER_OPEN_CHECKS, "breaker")
            check(all(got[j].get("verdict") == int(want[n + j])
                      for j in got) and kd.launches == k0,
                  f"[service breaker] open checks {got}, KD "
                  f"{kd.launches - k0} launches")
            m_open = breaker_counts()
            open_s = time.perf_counter() - t0
            held[0] = None
            while real() - t_hold < br.probe_interval:
                time.sleep(0.01)
            k0 = kd.launches
            for i in range(n + BREAKER_OPEN_CHECKS,
                           n + 2 * BREAKER_OPEN_CHECKS):
                r = c.call({"op": "check", "flow": dicts[i]})
                check(r.get("verdict") == int(want[i]),
                      f"[service breaker] after recovery {i}: {r}")
            kd_rose(k0, "breaker recovery")
        finally:
            c.close()
        m1 = breaker_counts()
        events = [e for e, _ in br.events]
    check(events == ["trip", "probe", "recover"] and br.state == br.CLOSED,
          f"[service breaker] transitions {events}")
    check((m_open[0] - m0[0], m_open[2] - m0[2]) == (
        1, n + BREAKER_OPEN_CHECKS)
          and (m1[0] - m0[0], m1[1] - m0[1], m1[2] - m0[2]) == (
              1, 1, n + BREAKER_OPEN_CHECKS),
          f"[service breaker] counters {m0} -> {m_open} -> {m1}: want one "
          f"trip, one recovery, {n + BREAKER_OPEN_CHECKS} oracle verdicts")
    rep = {"failure_threshold": n, "probe_interval_s": br.probe_interval,
           "open_checks": BREAKER_OPEN_CHECKS,
           "oracle_verdicts": int(m1[2] - m0[2]), "trips": 1,
           "recoveries": 1, "fault_and_open_s": open_s}
    log(f"[service breaker] {n} dispatch faults: one trip; "
        f"{BREAKER_OPEN_CHECKS} open checks answered by the oracle "
        f"(exact); probe after {br.probe_interval} s recovered, KD "
        f"launched again")
    return rep


def service_kernels(errs, rows, held, card):
    """KD at phase 9's shapes, after its counts were read: the fused
    step's path field at the micro-batcher's B = 1 and B = SVC_BATCH_MAX
    (on the loader's engine, path stack (7, 2048, 28), L = 32), and the
    stream session's delta scan at its first chunk's shape — each held
    against the plain version and timed through phase 4's code."""
    from cilium_tpu_torch.engine import dfa_dense_cuda
    from cilium_tpu_torch.engine.verdict import batch_to_device

    engine, flows = held["engine"], held["flows"]
    labels = []
    for b in (1, SVC_BATCH_MAX):
        host = host_batches(engine.policy, flows[:b], engine.cfg)
        fields = field_inputs_of(engine, batch_to_device(host[0], DEVICE))
        arr, data, lens = fields["path"]
        a = (arr["path_trans"], arr["path_byteclass"], arr["path_start"],
             data, lens)
        hold(errs, "KD", f"service path {tuple(a[0].shape)} B={b} "
                         f"L={data.shape[1]}",
             dfa_dense_cuda.dense_scan_cuda(*a, accept=arr["path_accept"],
                                            extra=arr["rp_path_gaccept"]),
             dfa_dense_cuda.dense_scan_plain(*a, accept=arr["path_accept"],
                                             extra=arr["rp_path_gaccept"]))
        got = kernel_times({"path": fields["path"]}, {}, {}, {}, card,
                           tag="service-", suffix=f"-b{b}")
        rows["KD"].extend(got["KD"])
        labels.append(f"service-path-b{b}")
    prefix, _, b, l = held["delta"]
    inputs = {f"service-stream-{k}": v for k, v in session_inputs_of(
        engine._arrays, [(prefix, b, l)], seed=9).items()}
    session_check(errs, inputs)
    rows["KD"].extend(kernel_times({}, {}, {}, inputs, card)["KD"])
    labels += list(inputs)
    return [list(r) for r in rows["KD"] if r[0] in labels]


# ------------------------------------------------ the cluster-mesh lanes
def lane_log(lane: str, msg: str) -> None:
    log(f"[fleet {lane}] {msg}")


def mem_mb() -> float:
    """Device memory the process's tensors have held at most, MiB."""
    import torch

    return torch.cuda.max_memory_allocated() / 2 ** 20


def rss_mb() -> float:
    """The process's own peak resident set so far, MiB (a spawned lane's
    ``ru_maxrss`` would start at its parent's peak)."""
    from cilium_tpu_torch.runtime import fleet

    return fleet._peak_rss_mb()


def traced_pack(loop, pool, chunks: int, name: str):
    """One pack of ``chunks`` pool chunks (one a fresh lease, released
    after) through ``loop.step()``, traced: (device kernels, device ms,
    wall ms, records). The loop's own pack thread, if any, sleeps on
    the virtual clock while the caller holds it."""
    leases = [loop.connect(f"traced-{name}-{i}") for i in range(chunks)]
    tickets = [loop.submit(lease, *pool[i % len(pool)].sections)
               for i, lease in enumerate(leases)]
    kernels, dev_ms, wall_ms = trace_once(loop.step)
    check(all(t.done and t.error is None for t in tickets),
          f"[fleet {name}] the traced pack left a chunk unserved")
    for lease in leases:
        loop.disconnect(lease)
    return {"kernels": kernels, "device_ms": dev_ms, "wall_ms": wall_ms,
            "records": sum(len(t.verdicts) for t in tickets),
            "busy_share": (dev_ms / wall_ms if dev_ms is not None
                           else None)}


def pool_held_plain(policy, cfg, pool, lane):
    """Every pool chunk's ground truth (the lane's serving engine on the
    card) against a ``device="cpu"`` engine of the same policy."""
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine

    plain = TorchVerdictEngine(policy, device="cpu", cfg=cfg)
    wrong = 0
    for chunk in pool:
        rec, l7, offsets, blob, gen = chunk.sections
        want = plain.verdict_l7_records(rec, l7, offsets, blob,
                                        gen=gen)["verdict"]
        wrong += sum(int(a) != int(b) for a, b in zip(chunk.truth, want))
    check(wrong == 0, f"[fleet {lane}] {wrong} pool verdicts differ "
                      f"from the plain engine's")
    return sum(chunk.n for chunk in pool)


def lane_counts():
    """(launches by kernel, KD's launches by variant) since the counts
    were set to 0."""
    from cilium_tpu_torch.engine import _build

    return ({k: v.launches for k, v in _build.KERNELS.items()},
            kd_variants())


def churn_lane(card):
    """Phase 10 (a), the churn storm: ``fleet.run`` at CHURN_IDENTITIES x
    CHURN_CNPS through the port's ``Loader`` on the card. The session's
    verdicts after the cold build, after every tenth update and after
    the last are held against a ``device="cpu"`` engine of the policy
    then serving (``run`` itself holds every update against the
    loader's engine and the sampled ones against the CPU oracle). The
    corpus keeps the reference's flows, whose verdicts no churned rule
    changes; so at each of those holds the probe of every churned rule
    so far (the flow its add enforces) is replayed too, through a
    session on the card over the loader: the live rules' probes must be
    allowed, the deleted ones' not, as the plain engine says."""
    import tempfile

    import numpy as np

    from cilium_tpu_torch.core.flow import Verdict
    from cilium_tpu_torch.engine import _build, replay
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
    from cilium_tpu_torch.ingest.columnar import flows_to_columns
    from cilium_tpu_torch.runtime import fleet
    from cilium_tpu_torch.runtime.metrics import METRICS

    held, worlds, mem, stacks, churned = [], [], {}, [], {}
    inner = replay.CaptureReplay.verdict_chunk
    World = fleet.FleetWorld

    def probe_verdicts(self, world):
        """(probes, live flags, verdicts) of every churned rule so far,
        through a session on the card that follows the loader."""
        probes = [world._http(world.ids[c], pat.replace("/.*", "/x"))
                  for c, pat in churned]
        live = [(("http", pat) in world.rules_of[c]) for c, pat in churned]
        cols = flows_to_columns(probes)
        session = replay.CaptureReplay(
            self.loader.engine, cols.l7, cols.offsets, cols.blob,
            world.cfg.engine, gen=cols.gen, loader=self.loader)
        session.stage_rows(cols.rec, cols.l7)
        session.stage_unique()
        got = inner(session, cols.rec, cols.l7)["verdict"]
        return probes, live, np.asarray(got).tolist()

    def noted(self, *a, **k):
        out = inner(self, *a, **k)
        engine = self.loader.engine
        n = len(stacks)
        stacks.append(tuple(engine.policy.arrays["path_trans"].shape))
        world = worlds[0]
        for c, rules in world.rules_of.items():
            for kind, pat in rules:
                if "/churn" in pat:
                    churned.setdefault((c, pat), None)
        if n % 10 == 0 or n == CHURN_UPDATES:
            held.append((n, np.asarray(out["verdict"]).tolist(),
                         engine.policy, engine.cfg,
                         probe_verdicts(self, world) if churned else None))
        return out

    class Noted(World):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            worlds.append(self)

    def spans():
        return {s: METRICS.histo_sum("cilium_tpu_span_seconds",
                                     {"span": s})
                for s in ("policy_compile", "policy_stage")}

    def progress(msg):
        mem.setdefault("after_build_mb", mem_mb())
        mem.setdefault("rss_after_build_mb", rss_mb())
        # the first call comes right after the cold build
        mem.setdefault("spans_t0", spans())
        lane_log("churn", msg)

    replay.CaptureReplay.verdict_chunk = noted
    fleet.FleetWorld = Noted
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as cache:
            _build.reset_launches()
            t0 = time.perf_counter()
            try:
                result = fleet.run(CHURN_IDENTITIES, CHURN_CNPS,
                                   CHURN_UPDATES, cache,
                                   workers=CHURN_WORKERS, gate_p99=False,
                                   device=DEVICE, progress=progress)
            except AssertionError as e:
                raise SmokeFailure(f"[fleet churn] {e}") from e
            wall = time.perf_counter() - t0
            launches, variants = lane_counts()
            # the updates' compile and stage seconds (the loader's
            # spans), each an update on average
            split = {s.replace("policy_", "") + "_ms":
                     (v - mem["spans_t0"][s]) * 1e3 / CHURN_UPDATES
                     for s, v in spans().items()}
    finally:
        replay.CaptureReplay.verdict_chunk = inner
        fleet.FleetWorld = World
    world = worlds[0]
    flows, distinct = world.corpus()
    probed = {"live": 0, "deleted": 0}
    for n, got, policy, cfg, probes in held:
        plain = TorchVerdictEngine(policy, device="cpu", cfg=cfg)
        want = plain.verdict_flows(flows)["verdict"]
        stale = sum(int(a) != int(b) for a, b in zip(got, want))
        check(stale == 0, f"[fleet churn] after update {n}: {stale} of "
                          f"{len(got)} session verdicts differ from the "
                          f"plain engine")
        if probes is None:
            continue
        flows_p, live, got_p = probes
        want_p = [int(v) for v in plain.verdict_flows(flows_p)["verdict"]]
        check(got_p == want_p, f"[fleet churn] after update {n}: the "
                               f"churned rules' probes {got_p} through "
                               f"the session differ from the plain "
                               f"engine's {want_p}")
        allowed = [v == int(Verdict.REDIRECTED) for v in want_p]
        check(allowed == live, f"[fleet churn] after update {n}: probes "
                               f"allowed {allowed}, rules live {live}")
        probed["live"] += sum(live)
        probed["deleted"] += len(live) - sum(live)
    check(probed["live"] > 0 and probed["deleted"] > 0,
          f"[fleet churn] the probe holds saw no live or no deleted "
          f"rule: {probed}")
    first, final = held[0][2], held[-1][2]
    stack = stacks[0]
    out = {k: result[k] for k in (
        "identities", "cnps", "classes", "updates", "banks_t0",
        "cold_build_s", "bank_compiles", "compiles_per_update",
        "odelta_bound", "p50_ms", "memo_hit_ratio", "rss_peak_mb",
        "rss_bound_mb", "registry_bytes", "artifact_hits",
        "schedule_digest")}
    out.update({
        "p99_ms": result["value"], "wall_s": wall,
        "stale": 0, "errors": 0, "held_plain": [h[0] for h in held],
        "probes_held": probed, "update_split_mean": split,
        "oracle_checks": len(range(0, CHURN_UPDATES, 10))
        + ((CHURN_UPDATES - 1) % 10 != 0),
        "corpus": len(flows), "distinct": distinct,
        # the cold build's path stack, and each committed one after it
        # (a churned pattern may add byte classes)
        "path_stack": stack,
        "path_stacks": sorted(set(stacks)),
        "first_widened_update": next(
            (n for n, st in enumerate(stacks) if st != stack), None),
        "dns_stack": tuple(first.arrays["dns_trans"].shape),
        "device_mem_mb": {"after_build": mem.get("after_build_mb"),
                          "end": mem_mb()},
        "rss_mb": {"after_build": mem["rss_after_build_mb"],
                   "end": rss_mb()},
        "launches": launches, "kd_variants": variants,
        # what the parent holds and times KD at
        "policies": {"t0": first, "final": final}, "flows": flows})
    check(launches["KD"] > 0, "[fleet churn] KD never launched")
    lane_log("churn", f"{CHURN_IDENTITIES} identities x {CHURN_CNPS} CNPs "
             f"({out['classes']} classes, {out['banks_t0']} banks, path "
             f"stack {stack}, then {out['path_stacks']} from update "
             f"{out['first_widened_update']}): cold build "
             f"{out['cold_build_s']} s; "
             f"{CHURN_UPDATES} updates, update to enforcement p50 "
             f"{out['p50_ms']} ms, p99 {out['p99_ms']} ms (of which, "
             f"an update on average, compile {split['compile_ms']:.1f} "
             f"ms, stage {split['stage_ms']:.1f} ms); "
             f"{out['compiles_per_update']} compiles an update (bound "
             f"{out['odelta_bound']}); memo hit ratio "
             f"{out['memo_hit_ratio']}; 0 stale, 0 ERROR; churned-rule "
             f"probes held {probed}; peak RSS "
             f"{out['rss_peak_mb']} MiB; device memory "
             f"{out['device_mem_mb']}; wall {wall:.1f} s; KD {variants} "
             f"on {card}")
    return out


def soak_lane(card):
    """Phase 10 (b), the serve soak: ``LoadModel`` at SOAK_STREAMS
    virtual streams in ``thread`` mode (the pack thread under an
    autojumping clock) with the lane's seeded serve faults, a
    SOAK_PROTOCOL_MIX share of its chunks protocol-frontend records."""
    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.runtime import faults, loadmodel, simclock

    built = {}
    build_world = loadmodel._build_world

    def noted(*a, **k):
        built["loader"], built["pool"] = out = build_world(*a, **k)
        built["after_build_mb"] = mem_mb()
        return out

    class Traced(loadmodel.LoadModel):
        def _drive(self, loop, pool, clock, autojump):
            super()._drive(loop, pool, clock, autojump)
            st = loop.status()
            chunks = max(1, round(st["records_packed"] / max(1, st["packs"])
                                  / self.chunk_flows))
            with simclock.hold():
                built["traced"] = traced_pack(loop, pool, chunks, "soak")

    rules = [faults.FaultRule("serve.lease", prob=0.0005,
                              times=SOAK_FAULTS),
             faults.FaultRule("serve.ring_slot", prob=0.0005,
                              times=SOAK_FAULTS)]
    model = Traced(streams=SOAK_STREAMS, virtual_s=SOAK_VIRTUAL_S,
                   fault_rules=rules, mode="thread",
                   protocol_mix=SOAK_PROTOCOL_MIX, device=DEVICE)
    loadmodel._build_world = noted
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        result = model.run()
        wall = time.perf_counter() - t0
        launches, variants = lane_counts()
    finally:
        loadmodel._build_world = build_world
    check(not result["violations"],
          f"[fleet soak] invariant violations: {result['violations'][:3]}")
    check(result["concurrency_peak"] >= int(0.95 * SOAK_STREAMS),
          f"[fleet soak] concurrency peak {result['concurrency_peak']} "
          f"< 95% of {SOAK_STREAMS}")
    check(result["sampled_checks"] > 0, "[fleet soak] no sampled check")
    check(launches["KD"] > 0, "[fleet soak] KD never launched")
    loader = built["loader"]
    held = pool_held_plain(loader.engine.policy, loader.engine.cfg,
                           built["pool"], "soak")
    out = {k: result[k] for k in (
        "streams", "mode", "virtual_s", "simulated_s", "concurrency_peak",
        "submissions", "resolved", "served_records", "packs",
        "records_packed", "grants", "expiries", "releases", "sheds",
        "shed_rate", "retries", "chunk_errors", "bytes_saved",
        "bytes_shipped", "memo", "sampled_checks", "explain_coverage",
        "slo_burn_p99", "slo_burn_shed")}
    traced = built["traced"]
    out.update({
        "wall_s": wall, "records_per_wall_s": result["served_records"] / wall,
        "virtual_p50_ms": result["p50_ms"],
        "virtual_p99_ms": result["p99_ms"],
        "virtual_p99_unloaded_ms": result["p99_unloaded_ms"],
        "violations": 0, "pool_records_held_plain": held,
        "pack_records": max(1, round(result["records_packed"]
                                     / max(1, result["packs"]))),
        "traced_pack": traced,
        "device_mem_mb": {"after_build": built["after_build_mb"],
                          "end": mem_mb()},
        "launches": launches, "kd_variants": variants})
    lane_log("soak", f"{SOAK_STREAMS} streams, {SOAK_VIRTUAL_S} virtual s "
             f"(thread mode): wall {wall:.1f} s, {result['packs']} packs, "
             f"{result['served_records']} records "
             f"({out['records_per_wall_s']:.0f} a wall second), "
             f"{result['sheds']} sheds, 0 violations, concurrency peak "
             f"{result['concurrency_peak']}; virtual p50 "
             f"{result['p50_ms']} ms, virtual p99 {result['p99_ms']} ms "
             f"(pack interval on the simulation clock, not a card time); "
             f"traced pack of {traced['records']} records: "
             f"{traced['kernels']} kernels, {traced['device_ms']} device "
             f"ms in {traced['wall_ms']:.3f} ms; KD {variants} on {card}")
    return out


def fleet_lane(card):
    """Phase 10 (c), the serving fleet: ``FleetModel`` at FLEET_STREAMS
    streams over FLEET_HOSTS replicas (one loader each, host 0 compiles,
    the rest and every warm rejoin served from the shared artifact
    store) with the lane's host kill, partition, drain and rejoins and
    its seeded heartbeat and handoff faults. Each replica's packs are
    counted over every loop it ran (a rejoin starts a fresh one)."""
    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.runtime import faults, fleetserve

    loops, held = {}, {}
    make_loop = fleetserve.HostReplica._make_loop

    def noted(self):
        loop = make_loop(self)
        loops.setdefault(self.name, []).append(loop)
        return loop

    class Held(fleetserve.FleetModel):
        def _build_fleet(self):
            router, pool = super()._build_fleet()
            engine = router.replicas[0].loader.engine
            held.update(pool=pool, policy=engine.policy, cfg=engine.cfg,
                        after_build_mb=mem_mb(),
                        build_compiles=[r.loader.bank_status()["compiles"]
                                        for r in router.replicas])
            return router, pool

        def _drive(self, router, pool, clock):
            index = super()._drive(router, pool, clock)
            packs = sum(r.loop.status()["packs"] for r in router.replicas
                        if r.alive) or 1
            served = sum(r.loop.status()["records_packed"]
                         for r in router.replicas if r.alive)
            chunks = max(1, round(served / packs / self.chunk_flows))
            held["traced"] = {r.name: traced_pack(r.loop, pool, chunks,
                                                  r.name)
                              for r in router.replicas if r.alive}
            return index

    rules = [faults.FaultRule("fleet.heartbeat", prob=0.002,
                              times=FLEET_FAULTS),
             faults.FaultRule("fleet.handoff", prob=0.01,
                              times=FLEET_FAULTS)]
    model = Held(streams=FLEET_STREAMS, hosts=FLEET_HOSTS,
                 virtual_s=FLEET_VIRTUAL_S, active_fraction=FLEET_ACTIVE,
                 fault_rules=rules, trace_sample_every=8, device=DEVICE)
    fleetserve.HostReplica._make_loop = noted
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        result = model.run()
        wall = time.perf_counter() - t0
        launches, variants = lane_counts()
    finally:
        fleetserve.HostReplica._make_loop = make_loop
    r = result
    check(not r["violations"],
          f"[fleet serve] invariant violations: {r['violations'][:3]}")
    for key, want in (("unrecovered", 0), ("survivor_recompiles", 0),
                      ("rejoin_compiles", 0), ("explain_coverage", 1.0)):
        check(r[key] == want, f"[fleet serve] {key} {r[key]} != {want}")
    check(r["concurrency_peak"] >= int(0.95 * FLEET_STREAMS)
          and r["host_deaths"] >= 1 and r["rejoins"] >= 1
          and r["rejoin_warm_restores"] >= 1
          and r["handoffs"] >= FLEET_MIN_HANDOFFS
          and r["journal_consistent"] and r["sampled_checks"] > 0,
          f"[fleet serve] the schedule did not run its course: {r}")
    check(launches["KD"] > 0, "[fleet serve] KD never launched")
    # host 0 compiles; the shared artifact store serves every other host
    built = held["build_compiles"]
    check(built[0] > 0 and not any(built[1:]),
          f"[fleet serve] bank compiles by host at the build: {built}")
    held_n = pool_held_plain(held["policy"], held["cfg"], held["pool"],
                             "serve")
    out = {k: r[k] for k in (
        "streams", "hosts", "capacity_per_host", "concurrency_peak",
        "virtual_s", "simulated_s", "active_fraction", "submissions",
        "resolved", "served_records", "packs", "sheds", "shed_rate",
        "retries", "replays", "unrecovered", "sampled_checks", "handoffs",
        "partial_handoffs", "host_deaths", "rejoins", "spilled_streams",
        "handoff_rows_resident", "handoff_bytes_avoided",
        "survivor_recompiles", "rejoin_compiles", "rejoin_artifact_hits",
        "rejoin_warm_restores", "explain_coverage", "traced_chunks",
        "handoff_replays", "stitched_replays", "stitch_coverage",
        "flows_aggregated", "journal_events", "journal_consistent",
        "obs_seconds")}
    out.update({
        "wall_s": wall, "records_per_wall_s": r["served_records"] / wall,
        "obs_overhead_pct": 100.0 * r["obs_seconds"] / wall,
        "virtual_p50_ms": r["p50_ms"], "virtual_p99_ms": r["p99_ms"],
        "virtual_failover_p99_ms": r["failover_p99_ms"],
        "violations": 0, "pool_records_held_plain": held_n,
        "build_compiles": built,
        "replica_packs": {name: sum(lp.status()["packs"] for lp in ls)
                          for name, ls in sorted(loops.items())},
        "traced_packs": held["traced"],
        "device_mem_mb": {"after_build": held["after_build_mb"],
                          "end": mem_mb()},
        "launches": launches, "kd_variants": variants})
    lane_log("serve", f"{FLEET_STREAMS} streams over {FLEET_HOSTS} hosts, "
             f"{FLEET_VIRTUAL_S} virtual s: wall {wall:.1f} s, "
             f"{r['served_records']} records "
             f"({out['records_per_wall_s']:.0f} a wall second); "
             f"{r['host_deaths']} deaths, {r['rejoins']} rejoins, "
             f"{r['handoffs']} handoffs, stitch coverage "
             f"{r['stitch_coverage']}, 0 unrecovered, 0 survivor and 0 "
             f"rejoin compiles; packs by replica {out['replica_packs']}; "
             f"virtual p99 {r['p99_ms']} ms; KD {variants} on {card}")
    return out


def lane_child(name, card):
    """One lane in a spawned process: its own interpreter, CUDA context,
    registries and peak RSS. Returns (report, None), or (None, the
    failure) — the parent raises it."""
    import traceback

    import torch

    os.environ["CILIUM_TPU_DFA_IMPL"] = "gather"
    try:
        torch.cuda.init()
        rss0 = rss_mb()                # the interpreter, torch and CUDA
        report = LANES[name](card)
        report["rss_start_mb"] = rss0
        return report, None
    except SmokeFailure as e:
        return None, str(e)
    except Exception:  # noqa: BLE001 — reported by the parent
        return None, traceback.format_exc()[-4000:]


LANES = {"churn": churn_lane, "soak": soak_lane, "serve": fleet_lane}


def fleet_phase(card):
    """Phase 10: the three cluster-mesh lanes, one after another, each
    in a spawned process of its own (its own interpreter, CUDA context
    and peak RSS), so that no lane's host clock runs beside another's.
    Returns the report and each lane's counts."""
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    got, walls = {}, {}
    for n in LANES:
        t1 = time.perf_counter()
        left = LANE_TIMEOUT_S - (t1 - t0)
        pool = ctx.Pool(1)
        try:
            job = pool.apply_async(lane_child, (n, card))
            try:
                report, err = job.get(timeout=max(1.0, left))
            except multiprocessing.TimeoutError:
                raise SmokeFailure(f"[fleet {n}] the lanes ran past "
                                   f"{LANE_TIMEOUT_S} s") from None
        finally:
            pool.terminate()
            pool.join()
        check(err is None, f"[fleet {n}] the lane failed: {err}")
        got[n] = report
        # the lane's process, spawn and import included
        walls[n] = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    soak, serve = got["soak"], got["serve"]
    # the fleet's p99 gate: at most twice the single host's, both read
    # on the simulation clock of this run
    check(serve["virtual_p99_ms"] <= 2.0 * soak["virtual_p99_ms"],
          f"[fleet serve] virtual p99 {serve['virtual_p99_ms']} ms over "
          f"twice the soak's {soak['virtual_p99_ms']} ms")
    serve["single_host_virtual_p99_ms"] = soak["virtual_p99_ms"]
    launches = {n: r.pop("launches") for n, r in got.items()}
    variants = {n: r.pop("kd_variants") for n, r in got.items()}
    held = {"policies": got["churn"].pop("policies"),
            "flows": got["churn"].pop("flows"),
            "pack_records": soak["pack_records"]}
    report = {"card": card, "wall_s": wall, "process_wall_s": walls,
              "churn": got["churn"], "soak": soak, "serve": serve,
              "cuts": {"churn_updates": (CHURN_UPDATES, 56),
                       "soak_virtual_s": (SOAK_VIRTUAL_S, 120.0),
                       "serve_virtual_s": (FLEET_VIRTUAL_S, 120.0)}}
    log(f"phase 10 wall {wall:.1f} s (the lanes one after another; each "
        f"lane's process {', '.join(f'{n} {w:.1f} s' for n, w in walls.items())})")
    return report, launches, variants, held


def gpu_clocks() -> str:
    """The card's SM clock, power draw and temperature now
    (``nvidia-smi``), to read beside a timing window."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def fleet_kernels(errs, rows, held, churn_variants, card):
    """KD at the churn storm's path stacks, after phase 10's counts were
    read: the cold build's (its table fits in shared memory) and the
    last update's (churned patterns add byte classes). Every scan field
    is held against the plain version at the storm's corpus (B = its
    flows) and at the soak's mean pack (B = records a pack); the path
    field under each variant its table allows, each timed through phase
    4's code, the variants in turn twice. Returns the path rows."""
    from cilium_tpu_torch.engine import dfa_dense_cuda
    from cilium_tpu_torch.engine.verdict import (
        TorchVerdictEngine,
        batch_to_device,
    )

    flows = held["flows"]
    labels = []
    log(f"  SM clock, power, temperature before: {gpu_clocks()}")
    for when, policy in held["policies"].items():
        engine = TorchVerdictEngine(policy, device=DEVICE)
        # the variants the path stack can take: shared memory only when
        # the table fits
        timed = ("smem", "global") if dfa_dense_cuda.plan_launch(
            *policy.arrays["path_trans"].shape, 1, 32).variant == "smem" \
            else ("global",)
        for b in (len(flows), held["pack_records"]):
            sample = (flows * -(-b // len(flows)))[:b]
            host = host_batches(policy, sample, engine.cfg)
            check(len(host) == 1, f"[fleet] B={b} is over one batch")
            fields = field_inputs_of(engine,
                                     batch_to_device(host[0], DEVICE))
            for prefix, (arr, data, lens) in fields.items():
                a = (arr[f"{prefix}_trans"], arr[f"{prefix}_byteclass"],
                     arr[f"{prefix}_start"], data, lens)
                acc = arr[f"{prefix}_accept"]
                extra = (arr.get("rp_path_gaccept") if prefix == "path"
                         else None)
                want = dfa_dense_cuda.dense_scan_plain(*a, accept=acc,
                                                       extra=extra)
                plan = dfa_dense_cuda.plan_launch(
                    *a[0].shape, *data.shape, acc.shape[2],
                    0 if extra is None else extra.shape[2])
                for variant in (timed if prefix == "path"
                                else (plan.variant,)):
                    v0 = kd_variants()
                    hold(errs, "KD", f"fleet {when} {prefix} "
                                     f"{tuple(a[0].shape)} B={data.shape[0]} "
                                     f"L={data.shape[1]} {variant}",
                         dfa_dense_cuda.dense_scan_cuda(
                             *a, accept=acc, extra=extra, _variant=variant),
                         want)
                    ran = {v: n - v0.get(v, 0)
                           for v, n in kd_variants().items()
                           if n - v0.get(v, 0)}
                    check(ran == {variant: 1},
                          f"[fleet] KD held as {variant} ran {ran}")
            # the variants in turn, twice: their order must not decide
            # which one the card's clocks favour
            for again in ("", "-again"):
                for variant in timed:
                    suffix = f"-b{b}-{variant}{again}"
                    got = kernel_times({"path": fields["path"]}, {}, {}, {},
                                       card, tag=f"fleet-{when}-",
                                       suffix=suffix, variant=variant)
                    rows["KD"].extend(got["KD"])
                    labels.append(f"fleet-{when}-path{suffix}")
    log(f"  SM clock, power, temperature after: {gpu_clocks()}")
    check(set(churn_variants) >= {"smem"},
          f"[fleet] the storm ran KD {churn_variants}: no shared-memory "
          f"launch at its cold build's path stack")
    return [list(r) for r in rows["KD"] if r[0] in labels]


# ------------------------------------------- the protocol-frontend lanes
def proto_scenario(name: str, n_rules: int, n_flows: int):
    """``bench_protocols.py``'s lane scenarios: a single frontend
    reuses the mixed generator at a 1.0 share; http and protocols use
    their own generators."""
    from cilium_tpu_torch.ingest import synth

    if name in ("http", "protocols"):
        return synth.scenario_by_name(name, n_rules, n_flows)
    return synth.synth_protocols_scenario(
        n_rules=n_rules, n_flows=n_flows, mix=((name, 1.0),))


def proto_loader(per_identity, cache_dir):
    """The port's ``Loader(Config())`` on the card (gate on,
    content-addressed banks) over a temporary cache; (loader, compile
    s of the cold build)."""
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.runtime.loader import Loader

    cfg = Config()
    cfg.loader.cache_dir = cache_dir
    loader = Loader(cfg, device=DEVICE)
    t0 = time.perf_counter()
    loader.regenerate(per_identity, revision=1)
    return loader, time.perf_counter() - t0


def replay_of(engine, cols, cfg, loader=None):
    """A ``CaptureReplay`` over a capture's columns, staged (rows and
    the dedup stream)."""
    from cilium_tpu_torch.engine.replay import CaptureReplay

    r = CaptureReplay(engine, cols.l7, cols.offsets, cols.blob, cfg,
                      gen=cols.gen, loader=loader)
    r.stage_rows(cols.rec, cols.l7)
    r.stage_unique()
    return r


def l7g_stack(policy):
    """``(NB, S, K)`` of a policy's l7g automaton, or None."""
    t = policy.arrays.get("l7g_trans")
    return tuple(t.shape) if t is not None else None


def proto_lane(name, n_rules, n_flows, cache_dir, card):
    """One throughput lane as ``bench_protocols.run_throughput`` runs
    it, through the port's entry points: ``Loader`` on the card,
    ``regenerate`` (compile s), ``flows_to_columns`` (a v3 image when a
    record is generic), ``CaptureReplay(..., gen=, loader=)`` with
    ``stage_rows`` and ``stage_unique`` (stage ms), one
    ``verdict_chunk`` of the whole capture to fill the memo, then
    PROTO_REPS timed ones. Every lane of the output is held against a
    ``device="cpu"`` engine's replay of the same capture, the
    PROTO_ORACLE_SAMPLE first flows against the CPU oracle; no
    ``ERROR`` verdict. The launch counts are set to 0 just before the
    replay is built and read just after the timed repetitions, before
    the oracle sample's fused step."""
    import numpy as np
    import torch

    from cilium_tpu_torch.core.flow import Verdict
    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
    from cilium_tpu_torch.ingest import synth
    from cilium_tpu_torch.ingest.columnar import flows_to_columns

    t_lane = time.perf_counter()
    per_identity, scenario = synth.realize_scenario(
        proto_scenario(name, n_rules, n_flows))
    loader, compile_s = proto_loader(per_identity, cache_dir)
    engine = loader.engine
    ecfg = loader.config.engine
    cols = flows_to_columns(scenario.flows)
    check((cols.gen is not None) == (name != "http"),
          f"[proto {name}] the capture's GENERIC section: "
          f"{cols.gen is not None}")
    _build.reset_launches()
    t0 = time.perf_counter()
    replay = replay_of(engine, cols, ecfg, loader=loader)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    out = replay.verdict_chunk(cols.rec, cols.l7)     # the memo fill
    check(int(Verdict.ERROR) not in out["verdict"],
          f"[proto {name}] ERROR verdicts")
    n = len(scenario.flows)
    t0 = time.perf_counter()
    for _ in range(PROTO_REPS):
        out = replay.verdict_chunk(cols.rec, cols.l7)
    dt = time.perf_counter() - t0
    launches, variants = lane_counts()
    check(launches["KD"] > 0, f"[proto {name}] KD never launched")
    # the oracle sample runs the fused step on the card: after the read
    sample = scenario.flows[:PROTO_ORACLE_SAMPLE]
    want = loader.fallback_engine.verdict_flows(sample)["verdict"]
    got = engine.verdict_flows(sample)["verdict"]
    check(list(map(int, got)) == list(map(int, want)),
          f"[proto {name}] the engine disagrees with the CPU oracle on "
          f"{sum(int(a) != int(b) for a, b in zip(got, want))} of "
          f"{len(sample)} flows")
    plain = TorchVerdictEngine(engine.policy, device="cpu", cfg=ecfg)
    assert_lanes(f"[proto {name}] vs the plain engine's replay", out,
                 replay_of(plain, cols, ecfg).verdict_chunk(cols.rec,
                                                            cols.l7))
    m = replay.memo
    allowed = float(np.mean(np.asarray(out["verdict"])
                            == int(Verdict.REDIRECTED)))
    stack = l7g_stack(engine.policy)
    line = {
        "protocol": name, "rules": n_rules, "flows": n,
        "verdicts_per_s": PROTO_REPS * n / dt,
        "compile_s": compile_s, "stage_ms": stage_s * 1e3,
        "memo_hit_ratio": (m.hits / max(1, m.hits + m.misses)
                           if m is not None else None),
        "allow_fraction": allowed, "unique_rows": replay.n_unique,
        "l7g_stack": stack,
        "l7g_table": (tuple(replay.feat.tables["l7g"][0].shape)
                      if "l7g" in replay.feat.tables else None),
        "oracle_sample": len(sample), "errors": 0,
        "lane_wall_s": time.perf_counter() - t_lane,
        "launches": launches, "kd_variants": variants}
    log(f"[proto {name}] {n_rules} rules x {n} flows: "
        f"{line['verdicts_per_s'] / 1e6:.3f}M verdicts/s (memo-gather "
        f"replay, {PROTO_REPS} reps), compile {compile_s:.3f} s, stage "
        f"{line['stage_ms']:.1f} ms, {replay.n_unique} unique rows, memo "
        f"hit ratio {line['memo_hit_ratio']}, allow {allowed:.4f}; l7g "
        f"stack {stack}, table {line['l7g_table']}; all 10 lanes equal to "
        f"the plain engine, {len(sample)} flows to the oracle; launches "
        f"{launches} on {card}")
    return line, loader, scenario, cols, replay


def proto_fused(name, policy, ecfg, flows, card):
    """The lane's policy as a fused batch: PROTO_FUSED_BATCHES batches of
    BATCH of its flows under each of PROTO_ARMS (the l7g field scanned
    by the arm wherever it can take its stack), every batch held on all
    ten lanes against the plain engine; then phase 4's batch timing.
    Counts to 0 just before each arm's batches, read just after."""
    import dataclasses

    import torch

    from cilium_tpu_torch.engine import _build, nfa_kernel
    from cilium_tpu_torch.engine.megakernel import IMPL_DENSE, IMPL_NFA
    from cilium_tpu_torch.engine.verdict import (
        TorchVerdictEngine,
        batch_to_device,
    )

    out, launches, variants = {}, {}, {}
    env0 = os.environ.get("CILIUM_TPU_DFA_IMPL", "gather")
    S = l7g_stack(policy)[1]
    # the arm each mode must give l7g: NFA under nfa-bitset, and under
    # auto past 128 DFA states, wherever the banks' positions fit
    nfa_fits = nfa_kernel.banks_from_dfa(policy.l7g_matcher.banked,
                                         ecfg) is not None
    try:
        for arm, (mode, dfa_impl) in PROTO_ARMS.items():
            tag = f"proto {name} {arm}"
            cfg = dataclasses.replace(ecfg, kernel_impl=mode)
            os.environ["CILIUM_TPU_DFA_IMPL"] = dfa_impl
            engine = TorchVerdictEngine(policy, device=DEVICE, cfg=cfg)
            plain = TorchVerdictEngine(policy, device="cpu", cfg=cfg)
            host = host_batches(policy, flows[:PROTO_FUSED_BATCHES * BATCH],
                                cfg)
            batches = [batch_to_device(h, DEVICE) for h in host]
            torch.cuda.synchronize()
            l7g_impl = engine.impl_plan["l7g"]
            expect = (IMPL_NFA if nfa_fits and (mode == IMPL_NFA or S > 128)
                      else IMPL_DENSE)
            check(l7g_impl == expect,
                  f"[{tag}] l7g ({S} states) took {l7g_impl}, not {expect}")
            l7g_kernel = ("K1" if l7g_impl == IMPL_NFA else
                          "K2" if dfa_impl == "pallas" and S <= 128
                          else "KD")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always", RuntimeWarning)
                _build.reset_launches()
                got = [engine.verdict_batch_arrays(b) for b in batches]
                torch.cuda.synchronize()
                launches[arm], variants[arm] = lane_counts()
                want = [plain.verdict_batch_arrays(batch_to_device(h, "cpu"))
                        for h in host]
            check(launches[arm][l7g_kernel] > 0,
                  f"[{tag}] the l7g field's kernel {l7g_kernel} never "
                  f"launched: {launches[arm]}")
            if dfa_impl == "pallas" and S > 128:
                check(any("constant-time guarantee" in str(w.message)
                          for w in caught),
                      f"[{tag}] the {S}-state l7g stack must warn on the "
                      f"oblivious arm's fallback")
            for i, (g, w) in enumerate(zip(got, want)):
                assert_lanes(f"[{tag}] batch {i} vs the plain engine",
                             {k: v.cpu().numpy() for k, v in g.items()},
                             {k: v.numpy() for k, v in w.items()})
            log(f"[{tag}] impl_plan {json.dumps(engine.impl_plan, sort_keys=True)} "
                f"CILIUM_TPU_DFA_IMPL={dfa_impl}: l7g ({l7g_impl}) on "
                f"{l7g_kernel}; {len(batches)} batches, all 10 lanes equal "
                f"to the plain engine; launches {launches[arm]}")
            med, busy, kernels = batch_timing(engine, batches[0], tag, card)
            # the device memory one batch takes beyond the staged policy
            # and batch: the frontend resolve's pair-subset check
            # broadcasts [B, G, Km, F] (G predicate groups, Km pairs a
            # group, F pair slots a flow)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            engine.verdict_batch_arrays(batches[0])
            torch.cuda.synchronize()
            peak_mb = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            G, Km = policy.arrays["rp_fe_pairs"].shape
            F = policy.kafka_interns["gen_fmax"]
            log(f"[{tag}] one batch's peak device memory above the staged "
                f"arrays {peak_mb:.1f} MiB; the pair-subset broadcast "
                f"[{BATCH}, {G}, {Km}, {F}] is "
                f"{BATCH * G * Km * F / 2 ** 20:.1f} MiB of bool")
            out[arm] = {"impl_plan": dict(engine.impl_plan),
                        "l7g_kernel": l7g_kernel, "batch_ms": med,
                        "busy_share": busy, "device_kernels": kernels,
                        "batches_held": len(batches),
                        "peak_batch_mib": peak_mb,
                        "pair_subset_shape": [BATCH, G, Km, F]}
    finally:
        os.environ["CILIUM_TPU_DFA_IMPL"] = env0
    return out, launches, variants


def pair_path_phase(cache_dir, card):
    """The generic pair path: the lineparser policy through the
    ``Loader``; its records through the fused step (batches of BATCH)
    and through capture replay, each held on all ten lanes against the
    plain engine, and the two paths against each other."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine.verdict import (
        TorchVerdictEngine,
        batch_to_device,
    )
    from cilium_tpu_torch.ingest import synth
    from cilium_tpu_torch.ingest.columnar import flows_to_columns

    per_identity, sc = synth.realize_scenario(
        synth.synth_lineparser_scenario(PAIR_RULES, PAIR_FLOWS))
    loader, compile_s = proto_loader(per_identity, cache_dir)
    try:
        engine = loader.engine
        policy, ecfg = engine.policy, loader.config.engine
        check("l7g_trans" not in policy.arrays and policy.gen_rules
              and not policy.fe_rules,
              "[proto pairs] the lineparser policy must stay on the "
              "generic pair path")
        host = host_batches(policy, sc.flows, ecfg)
        batches = [batch_to_device(h, DEVICE) for h in host]
        cols = flows_to_columns(sc.flows)
        plain = TorchVerdictEngine(policy, device="cpu", cfg=ecfg)
        torch.cuda.synchronize()
        _build.reset_launches()
        got = [engine.verdict_batch_arrays(b) for b in batches]
        replayed = replay_of(engine, cols, ecfg).verdict_chunk(cols.rec,
                                                               cols.l7)
        torch.cuda.synchronize()
        launches, variants = lane_counts()
        check(launches["KD"] > 0, "[proto pairs] KD never launched")
        fused = {k: np.concatenate([g[k].cpu().numpy() for g in got])
                 for k in got[0]}
        want = plain.verdict_flows(sc.flows)
        assert_lanes("[proto pairs] fused vs the plain engine", fused, want)
        assert_lanes("[proto pairs] replay vs the plain engine", replayed,
                     want)
        mix = np.bincount(fused["verdict"], minlength=6).tolist()
        check(mix[2] > 0 and mix[5] > 0,
              f"[proto pairs] implausible verdict mix {mix}")
        log(f"[proto pairs] test.lineparser {PAIR_RULES} rules x "
            f"{len(sc.flows)} records: generic rules "
            f"{len(policy.gen_rules)}, gen_fmax "
            f"{policy.kafka_interns['gen_fmax']}, no l7g; fused "
            f"({len(batches)} batches) and replay all 10 lanes equal to "
            f"the plain engine; mix {mix}; launches {launches} on {card}")
        return ({"rules": PAIR_RULES, "records": len(sc.flows),
                 "generic_rules": len(policy.gen_rules), "mix": mix,
                 "compile_s": compile_s}, launches, variants)
    finally:
        loader.close()


def frontend_frame(g) -> bytes:
    """One request frame of a frontend record: an r2d2 line, a
    memcached text command, a CQL QUERY frame."""
    import struct

    f = g.fields
    if g.proto == "r2d2":
        return (" ".join([f.get("cmd", "")] + (
            [f["file"]] if "file" in f else [])) + "\r\n").encode()
    if g.proto == "memcache":
        cmd, key = f.get("cmd", "get"), f.get("key", "")
        if cmd == "set":
            return f"set {key} 0 0 2\r\nhi\r\n".encode()
        return (f"{cmd} {key}".rstrip() + "\r\n").encode()
    action, table = f.get("query_action", ""), f.get("query_table", "")
    q = {"select": f"SELECT * FROM {table}",
         "insert": f"INSERT INTO {table} (a) VALUES (1)",
         "update": f"UPDATE {table} SET a = 1",
         "drop": f"DROP TABLE {table}"}.get(action, f"{action} {table}")
    body = struct.pack(">i", len(q.encode())) + q.encode()
    return struct.pack(">BBhBI", 4, 0, 1, 0x07, len(body)) + body


def proxylib_phase(loader, flows, tmpdir, card):
    """A ``VerdictService`` on the protocols loader answers ``on_data``
    for r2d2, memcache and cassandra frames, ON_DATA_TRIPS round trips
    each over ON_DATA_CLIENTS clients; each frame's PASS/DROP equals
    the plain engine's verdict on the records the parser reads from it.
    p50/p99 a protocol."""
    import base64
    import dataclasses

    from cilium_tpu_torch.core.flow import (
        Flow,
        L7Type,
        Protocol,
        TrafficDirection,
        Verdict,
    )
    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
    from cilium_tpu_torch.proxylib import Connection, create_parser
    from cilium_tpu_torch.runtime.service import VerdictClient

    plain = TorchVerdictEngine(loader.engine.policy, device="cpu",
                               cfg=loader.config.engine)
    policy_check_flow = Flow(protocol=Protocol.TCP,
                             direction=TrafficDirection.INGRESS,
                             l7=L7Type.GENERIC)
    passing = {int(Verdict.FORWARDED), int(Verdict.AUDIT),
               int(Verdict.REDIRECTED)}
    out = {}
    _build.reset_launches()
    for p_i, proto in enumerate(("r2d2", "memcache", "cassandra")):
        mine = [f for f in flows if f.generic is not None
                and f.generic.proto == proto][:ON_DATA_TRIPS]
        frames = [frontend_frame(f.generic) for f in mine]
        # what the parser reads from each frame, as the service's
        # PolicyBridge turns it into a flow, verdicted by the plain engine
        parsed = []
        for f, fr in zip(mine, frames):
            seen = []
            conn = Connection(proto=proto, connection_id=0, ingress=True,
                              src_identity=f.src_identity,
                              dst_identity=f.dst_identity, dport=f.dport)
            create_parser(proto, conn, lambda r: seen.append(r) or True)
            conn.on_data(False, False, fr)
            check(len(seen) == 1, f"[proto {proto}] {len(seen)} records "
                                  f"from frame {fr[:40]!r}")
            parsed.append(dataclasses.replace(
                policy_check_flow, src_identity=f.src_identity,
                dst_identity=f.dst_identity, dport=f.dport,
                generic=seen[0]))
        allowed = [int(v) in passing for v in plain.verdict_flows(
            parsed, outputs=("verdict",))["verdict"]]
        lat, wrong = [], []
        with verdict_service(loader, os.path.join(tmpdir, f"{proto}.sock"),
                             batch_max=SVC_BATCH_MAX,
                             deadline_ms=SVC_DEADLINE_MS) as svc:
            def client(t):
                c = VerdictClient(svc.socket_path)
                try:
                    for i in range(t, len(frames), ON_DATA_CLIENTS):
                        f, cid = mine[i], p_i * 100_000 + i
                        r = c.call({"op": "on_new_connection",
                                    "proto": proto, "conn": cid,
                                    "ingress": True,
                                    "src": f.src_identity,
                                    "dst": f.dst_identity,
                                    "dport": f.dport})
                        check(r.get("ok"), f"[proto {proto}] {r}")
                        t0 = time.perf_counter()
                        r = c.call({"op": "on_data", "conn": cid,
                                    "data_b64": base64.b64encode(
                                        frames[i]).decode()})
                        lat.append(time.perf_counter() - t0)
                        ops = [tuple(o) for o in r["ops"] if o[0] in (1, 2)]
                        if ops != [(1 if allowed[i] else 2, len(frames[i]))]:
                            wrong.append((i, r["ops"]))
                        c.call({"op": "close_connection", "conn": cid})
                finally:
                    c.close()

            run_threads(client, ON_DATA_CLIENTS, f"proto {proto}")
        check(not wrong, f"[proto {proto}] {len(wrong)} on_data ops differ "
                         f"from the plain engine, e.g. {wrong[:2]}")
        out[proto] = {"round_trips": len(frames), "pass": sum(allowed),
                      "clients": ON_DATA_CLIENTS, **quantiles_ms(lat)}
        log(f"[proto {proto} on_data] {len(frames)} round trips over "
            f"{ON_DATA_CLIENTS} clients ({sum(allowed)} PASS, each equal to "
            f"the plain engine): p50 {out[proto]['p50_ms']:.3f} ms, p99 "
            f"{out[proto]['p99_ms']:.3f} ms on {card}")
    launches, variants = lane_counts()
    check(launches["KD"] > 0, "[proto on_data] KD never launched")
    return out, launches, variants


def proto_phase(card):
    """Phase 11: the protocol-frontend lanes (see the module docstring).
    Returns (report, launches by pass, KD variants by pass, what the
    kernel holds need)."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_proto_")
    report = {"card": card, "lanes": {}}
    launches, variants, held = {}, {}, {"lanes": {}}
    kept = None          # the protocols lane's loader, for proxylib
    try:
        for name, n_rules, n_flows in PROTO_LANES:
            line, loader, scenario, cols, replay = proto_lane(
                name, n_rules, n_flows, os.path.join(tmp.name, name), card)
            launches[f"proto-{name}"] = line.pop("launches")
            variants[f"proto-{name}"] = line.pop("kd_variants")
            report["lanes"][name] = line
            if name != "http":
                held["lanes"][name] = {
                    "policy": loader.engine.policy,
                    "ecfg": loader.config.engine,
                    "flows": scenario.flows[:PROTO_FUSED_BATCHES * BATCH],
                    "table": replay.feat.tables.get("l7g")}
            if name == "protocols":
                kept = loader
            else:
                loader.close()
        # the fused arms: the protocols policy, and the memcache one,
        # whose l7g stack K2 and K1 both take
        report["fused"] = {}
        for name in ("protocols", "memcache"):
            lane = held["lanes"][name]
            out, ln, vr = proto_fused(name, lane["policy"], lane["ecfg"],
                                      lane["flows"], card)
            report["fused"][name] = out
            launches.update({f"proto-fused-{name}-{a}": v
                             for a, v in ln.items()})
            variants.update({f"proto-fused-{name}-{a}": v
                             for a, v in vr.items()})
        report["pairs"], launches["proto-pairs"], variants["proto-pairs"] = \
            pair_path_phase(os.path.join(tmp.name, "pairs"), card)
        report["on_data"], launches["proto-on_data"], \
            variants["proto-on_data"] = proxylib_phase(
                kept, held["lanes"]["protocols"]["flows"], tmp.name, card)
    finally:
        if kept is not None:
            kept.close()
        tmp.cleanup()
    report["wall_s"] = time.perf_counter() - t_phase
    report["cuts"] = {"repetitions": (PROTO_REPS, 3)}
    return report, launches, variants, held


def proto_kernels(errs, rows, held, card):
    """Each kernel that takes a frontend policy's l7g stack held exactly
    against its plain version at the stack and the lane's first BATCH
    records' scan values (KD always; K2 where S <= 128; K1 where the
    banks' positions fit), and KD at the lane capture's l7g table;
    then timed, with bounds, through phase 4's code. Prints each stack's
    (NB, S, K) and L."""
    import dataclasses

    import numpy as np
    import torch

    from cilium_tpu_torch.engine import (
        dfa_dense_cuda,
        dfa_oblivious_cuda,
        nfa_cuda,
    )
    from cilium_tpu_torch.engine.verdict import (
        TorchVerdictEngine,
        batch_field,
        batch_to_device,
        unpack_batch,
    )

    out = {}
    for name, lane in held["lanes"].items():
        policy = lane["policy"]
        engine = TorchVerdictEngine(policy, device=DEVICE, cfg=lane["ecfg"])
        b = unpack_batch(batch_to_device(
            host_batches(policy, lane["flows"][:BATCH], engine.cfg)[0],
            DEVICE))
        data, lens, _ = batch_field(b, "l7g")
        data, lens = data.contiguous(), lens.contiguous()
        arr = engine._arrays
        a = (arr["l7g_trans"], arr["l7g_byteclass"], arr["l7g_start"],
             data, lens)
        NB, S, K = a[0].shape
        shape = f"{(NB, S, K)} B={data.shape[0]} L={data.shape[1]}"
        hold(errs, "KD", f"proto {name} l7g {shape}",
             dfa_dense_cuda.dense_scan_cuda(*a, accept=arr["l7g_accept"]),
             dfa_dense_cuda.dense_scan_plain(*a, accept=arr["l7g_accept"]))
        takes = ["KD"]
        if S <= 128:
            hold(errs, "K2", f"proto {name} l7g {shape}",
                 dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*a),
                 dfa_oblivious_cuda.dfa_finals_oblivious_plain(*a))
            takes.append("K2")
        nfa = TorchVerdictEngine(policy, device=DEVICE, cfg=dataclasses.replace(
            engine.cfg, kernel_impl="nfa-bitset"))
        nfa_fields = {}
        if "l7g_nfa_follow" in nfa._arrays:
            n = [nfa._arrays[f"l7g_nfa_{k}"] for k in
                 ("follow", "acc_cls", "byteclass", "start")] + [data, lens]
            hold(errs, "K1", f"proto {name} l7g {tuple(n[1].shape)} "
                             f"B={data.shape[0]} L={data.shape[1]}",
                 nfa_cuda.nfa_finals_cuda(*n), nfa_cuda.nfa_finals_plain(*n))
            nfa_fields["l7g"] = (nfa._arrays, data, lens)
            takes.append("K1")
        capture = {}
        if lane["table"] is not None:
            tdata, tlens = (torch.from_numpy(np.ascontiguousarray(t))
                            .to(DEVICE) for t in lane["table"][:2])
            ta = a[:3] + (tdata, tlens)
            hold(errs, "KD", f"proto {name} capture l7g table {(NB, S, K)} "
                             f"B={tdata.shape[0]} L={tdata.shape[1]}",
                 dfa_dense_cuda.dense_scan_cuda(*ta, accept=arr["l7g_accept"]),
                 dfa_dense_cuda.dense_scan_plain(*ta,
                                                 accept=arr["l7g_accept"]))
            capture[f"proto-{name}-capture-l7g"] = ("l7g", arr, tdata,
                                                     tlens)
        log(f"[proto {name}] l7g stack (NB, S, K) = {(NB, S, K)}, L = "
            f"{data.shape[1]}: taken by {takes}"
            + ("" if S <= 128 else f"; K2 cannot take it ({S} states > "
               f"128)") + ("" if "K1" in takes else
                           "; K1 cannot take it (the banks' NFA positions "
                           "do not fit 128)"))
        got = kernel_times({"l7g": (arr, data, lens)}, nfa_fields, capture,
                           {}, card, tag=f"proto-{name}-")
        for kid, rs in got.items():
            rows[kid].extend(rs)
        out[name] = {"stack": (NB, S, K), "L": int(data.shape[1]),
                     "B": int(data.shape[0]), "taken_by": takes,
                     "rows": {kid: [list(r) for r in rs]
                              for kid, rs in got.items() if rs}}
    return out


def kd_variants():
    """KD's launches by variant since the counts were last set to 0."""
    from cilium_tpu_torch.engine import _build

    return dict(_build.KERNELS["KD"].launches_by_variant)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from cilium_tpu_torch.engine import _build  # noqa: F401 (fails alone)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    check(bool(smi), "nvidia-smi printed nothing")
    card = smi.splitlines()[0]
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    # phase 8's oracle samples, computed on the host's other cores while
    # phases 2-7 run (spawned processes: none of them touches the card)
    pool = concurrent.futures.ProcessPoolExecutor(
        ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        return run_phases(torch, smi, card, start_oracle(pool))
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run_phases(torch, smi, card, oracle_jobs) -> int:
    """Phases 2-12 (see the module docstring)."""
    from cilium_tpu_torch.engine import _build

    log("phase 2: build")
    secs = _build.build()
    log(f"  built {len(_build.KERNELS)} kernels in {secs:.1f}s "
        f"(nvcc in parallel)")
    tensor_ops = sass_tensor_ops()
    kd_sass = sass_kd()

    log("set-up: the http-1000 policy, staged under each configuration")
    per_identity, scenario, cfg = build_policy()
    setups = {name: setup_config(name, per_identity, scenario, cfg)
              for name in CONFIGS}

    log(f"set-up: phase 5's {CAPTURE_RECORDS}-record captures")
    auto_engine = setups["auto"]["engine"]
    caps = write_captures(scenario, auto_engine.policy, cfg,
                          CAPTURE_RECORDS)
    capture_inputs = capture_inputs_of(auto_engine._arrays, caps)
    session_inputs = session_inputs_of(auto_engine._arrays)

    log("phase 3: kernels against their plain versions (exact)")
    errs = {}
    dense_fields = field_inputs_of(auto_engine, setups["auto"]["full"])
    nfa_fields = field_inputs_of(setups["nfa-bitset"]["engine"],
                                 setups["nfa-bitset"]["full"])
    edge_variants = kernel_phase(
        errs, {**dense_fields, **{p: v for p, v in nfa_fields.items()
                                  if f"{p}_nfa_follow" in v[0]}},
        capture_inputs, session_inputs)
    log("phase 3: K2 and K1 timing against the input (data-oblivious)")
    oblivious = timing_independence(dense_fields, nfa_fields, card)

    reports = {}
    for name in CONFIGS:
        log(f"phase 4: main path [{name}]")
        reports[name] = drive_config(name, setups[name],
                                     len(scenario.flows), card)
    kd_plan_check(auto_engine._arrays, dense_fields["path"][1],
                  reports["auto"]["kd_variants"], edge_variants)

    log("phase 4: one launch per kernel at the http-1000 shapes and the "
        "capture shapes")
    rows = kernel_times(dense_fields, nfa_fields, capture_inputs,
                        session_inputs, card)

    captures = {}
    for arm in CAPTURE_ARMS:
        log(f"phase 5: capture replay [{arm}]")
        captures[arm] = capture_phase(arm, setups, caps, cfg, card)
    log("phase 5: capture replay [high cardinality]")
    captures["high-cardinality"] = high_cardinality_phase(setups, caps, cfg,
                                                          card)
    log("phase 6: legacy step")
    legacy = legacy_phase(per_identity, cfg, setups, scenario, card)
    log("phase 7: online serving")
    t7 = time.perf_counter()
    serve = serve_phase(setups, scenario, card)
    report = growth_kd(errs, rows, auto_engine._arrays, serve, card)
    report["wall_s"] = time.perf_counter() - t7
    log(f"phase 7 wall {report['wall_s']:.1f} s")
    log("phase 8: the loader plane")
    loader_report, loader_launches, loader_variants, loader_engines = \
        loader_phase(card, oracle_jobs)
    log(f"phase 8: KD and K1 at the loader's arrays, against their plain "
        f"versions")
    row_keys = ("label", "shape", "ms", "call_ms", "plain_ms", "bound_ms",
                "bound_by")
    row, ran = loader_kernels(errs, rows, loader_engines["loader-path"],
                              scenario.flows, card)
    loader_report["kd_path"] = {**dict(zip(row_keys, row)), "variants": ran}
    # the rollback retry's wider path stack, which ran the rest of the
    # phase: held and timed under the variant its plan picks
    retry = loader_report["rollback"]
    row, ran = loader_kernels(errs, rows, loader_engines["loader-path-retry"],
                              scenario.flows, card,
                              suffix=f"-{retry['kd_variant']}",
                              nfa_arm=False)
    check(set(ran) == {retry["kd_variant"]}
          and loader_variants.get(retry["kd_variant"], 0) > 0,
          f"[loader] KD at the retry's path stack {retry['path_stack']} ran "
          f"{ran} when held; phase 8 ran {loader_variants}")
    loader_report["kd_path_retry"] = {**dict(zip(row_keys, row)),
                                      "variants": ran}
    log(f"phase 8 wall {loader_report['wall_s']:.1f} s (serving passes), "
        f"oracle wait {loader_report.get('oracle_wait_s', 0.0):.1f} s")
    log("phase 9: the service and stream plane")
    service_report, service_launches, service_variants, service_held = \
        service_phase(card)
    log("phase 9: KD at the service's shapes, against its plain version")
    service_report["kd"] = service_kernels(errs, rows, service_held, card)
    log(f"phase 9 wall {service_report['wall_s']:.1f} s (passes and "
        f"set-up)")
    log("phase 10: the cluster-mesh lanes (churn storm, serve soak, "
        "serving fleet)")
    fleet_report, fleet_launches, fleet_variants, fleet_held = \
        fleet_phase(card)
    churn = fleet_report["churn"]
    churn["phase8_enforce_ms"] = {
        "p50": loader_report["churn"]["enforce_ms_p50"],
        "p99": loader_report["churn"]["enforce_ms_p99"]}
    log(f"[fleet churn] update to enforcement p50 / p99 {churn['p50_ms']} / "
        f"{churn['p99_ms']} ms at {CHURN_IDENTITIES} identities x "
        f"{CHURN_CNPS} CNPs, beside phase 8's "
        f"{churn['phase8_enforce_ms']['p50']:.3f} / "
        f"{churn['phase8_enforce_ms']['p99']:.3f} ms at http-1000 (this run; "
        f"the storm's p99 gate waits for the 27-bank lane's number)")
    log("phase 10: KD at the storm's path stack, against its plain version")
    fleet_report["kd"] = fleet_kernels(errs, rows, fleet_held,
                                       fleet_variants["churn"], card)
    log("phase 11: the protocol-frontend lanes (cassandra, memcache, r2d2, "
        "protocols, http) through the port's Loader and CaptureReplay")
    proto_report, proto_launches, proto_variants, proto_held = \
        proto_phase(card)
    log("phase 11: the kernels at the l7g stacks, against their plain "
        "versions")
    proto_report["kernels"] = proto_kernels(errs, rows, proto_held, card)
    log(f"phase 11 wall {proto_report['wall_s']:.1f} s")
    phase_launches = {n: r["launches"] for n, r in reports.items()}
    phase_launches.update({f"capture-{arm}": r["launches"]
                           for arm, r in captures.items()})
    phase_launches.update(legacy["launches"])
    phase_launches["serve"] = serve["launches"]
    phase_launches["loader"] = loader_launches
    phase_launches["service"] = service_launches
    phase_launches.update({f"fleet-{n}": ln
                           for n, ln in fleet_launches.items()})
    phase_launches.update(proto_launches)
    phase_variants = {n: r["kd_variants"] for n, r in reports.items()}
    phase_variants.update({f"capture-{arm}": r["kd_variants"]
                           for arm, r in captures.items()})
    phase_variants.update(legacy["kd_variants"])
    phase_variants["serve"] = serve["kd_variants"]
    phase_variants["loader"] = loader_variants
    phase_variants["service"] = service_variants
    phase_variants.update({f"fleet-{n}": v
                           for n, v in fleet_variants.items()})
    phase_variants.update(proto_variants)
    # the JSON line reports each kernel at its largest main-path shape
    pick = {"KD": "path", "K1": "host", "K2": "host"}
    kernels = []
    for kid, k in _build.KERNELS.items():
        row = next(r for r in rows[kid] if r[0] == pick[kid])
        kernels.append({
            "name": f"{kid}:{k.name}", "route": "cuda",
            "source": f"cilium_tpu_torch/engine/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": sum(ln[kid] for ln in phase_launches.values()),
            "phases": {n: ln[kid] for n, ln in phase_launches.items()
                       if ln[kid]},
            "max_abs_err": errs[kid],
            # ms: device time of one launch (profiler); call_ms: wall
            # time per call from Python, wrapper included
            "ms": row[2],
            "call_ms": row[3], "plain_ms": row[4], "bound_ms": row[5],
            "bound_by": row[6], "library_ms": None,
            "bound_bytes": BOUND_BYTES[kid],
            "bound_ops": BOUND_OPS[kid],
            "sass_tensor_ops": tensor_ops.get(kid),
            # KD: launches by variant in each phase, in phase 3's edge
            # cases, and the bulk copies and shared loads in its SASS
            **({"variants": {n: v for n, v in phase_variants.items() if v},
                "edge_variants": edge_variants, "sass": kd_sass,
                "loader_path": loader_report["kd_path"],
                "loader_path_retry": loader_report["kd_path_retry"],
                "service_shapes": service_report["kd"],
                "fleet_shapes": fleet_report["kd"]}
               if kid == "KD" else {}),
            # the l7g stacks of phase 11: the rows of this kernel
            "l7g_shapes": {n: r["rows"].get(kid, [])
                           for n, r in proto_report["kernels"].items()
                           if kid in r["taken_by"]},
            "timing_ratio": oblivious[kid][2] if kid in oblivious else None,
            # (NB, S or P, K, B, L) of the launch the times are from
            "shape": f"{pick[kid]} {row[1]}",
            "batch_ms": {n: r["batch_ms"] for n, r in reports.items()},
            "device_busy_share": {n: r["busy_share"]
                                  for n, r in reports.items()},
            # each row: (label, (NB, S|P, K, B, L), device ms, call ms,
            # plain ms, bound ms, bound by), capture shapes included
            "shapes": [list(r) for r in rows[kid]],
        })
    log("replay: " + json.dumps({
        "captures": {a: {k: v for k, v in r.items() if k != "launches"}
                     for a, r in captures.items()},
        "legacy_timing": legacy["timing"], "blob_route": legacy["blob"],
        "batch_device_kernels": {n: r["device_kernels"]
                                 for n, r in reports.items()},
        "card": card}))
    log("serve: " + json.dumps(report))
    log("loader: " + json.dumps(loader_report))
    log("service: " + json.dumps(service_report))
    log("fleet: " + json.dumps(fleet_report))
    log("proto: " + json.dumps(proto_report))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        rc = 1
    sys.exit(rc)
