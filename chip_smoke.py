"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line), in order
but for 15 and 14, which run, in that order, inside phase 10:

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
   phases 3-7), 1-3 bank compiles an add and none a delete (the banks
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
   spawned process of its own (each reads its own peak RSS and launch
   counts; the two lanes on the wall clock one after another with
   nothing beside them, then the two on the simulation clock side by
   side, with phases 15 and 14 in this process): first (step 0) the 27-bank churn lane
   (``tools/churn_lane.run``, the reference's ``make churn``: 12
   identities x 8 paths, bank size 4, 56 CNP and FQDN updates through a
   live replay session; zero stale and ERROR verdicts, O(delta) bank
   compiles, memo hit ratio >= 0.99), whose update-to-enforcement p99 on
   this card arms the storm's p99 gate; then the churn storm
   (``runtime/fleet.run``
   at 10000 identities x 5000 CNPs, 200 classes, through the port's
   ``Loader``, its capture-replay session bit-equal to the serving
   engine after every update, to the CPU oracle on sampled updates and
   to a ``device="cpu"`` engine after the cold build and every tenth
   update, with the probe of every churned rule so far, added or
   deleted, replayed through a session on the card beside the corpus;
   compiles per update within 1.1 x 0.929; update to
   enforcement p50/p99 ms; its p99 held to 2 x the 27-bank lane's, the
   reference's factor, checked after every other gate: where it does
   not hold, both p99s and their compile splits are logged and recorded
   as a finding in the ``fleet`` line), the serve soak
   (``runtime/loadmodel`` at
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
12. the BASELINE configs at ``bench.py``'s published sizes, each
   through the port's ``Loader(Config())`` on the card: fqdn (10 rules
   x 100 names x 10000 flows), mixed (the ``examples/policies`` corpus,
   loaded by the port's ``load_cnp_dir`` and its own YAML reader, x
   1000000 tuples) and clustermesh (10000 identities x 5000 CNPs x
   100000 flows). The host seconds of the scenario, the resolve, the
   compile, the encode and the staging are printed apart; then
   ``bench.py``'s timing: fqdn completion-forced batch p50/p99 and
   pipelined verdicts/s (median of 3 windows), mixed and clustermesh
   every chunk of 8192 staged before the timer, a forced latency pass
   per chunk and one throughput pass. All ten lanes equal a
   ``device="cpu"`` engine on every fqdn flow and on the first, the last
   and every tenth chunk; 500 flows equal the CPU oracle; the verdict
   mix holds both verdicts. Each policy is staged once more under
   ``kernel_impl="autotune"``: every field's pick with its card times,
   one ``cilium_tpu_kernel_autotune_picks_total`` a new shape key, the
   held batches' lanes equal to ``auto``'s. Then the DNS proxy
   (``DNSProxy(use_tpu=True)``, the fqdn rules for the crawler on port
   53): ``check_batch`` over the 10000 qnames at B = 8192 and B = 1
   under the gather arm (KD at L = 256) and the oblivious one (K2),
   every verdict equal to ``check_allowed``'s and the ``device="cpu"``
   proxy's, p50/p99 a batch size; the ``dnsproxy.query`` fault armed
   once (one fallback counted, none outside that pass); and its server
   on 127.0.0.1 over an in-process upstream (200 queries from 8
   clients, UDP and TCP, an unknown client; host only): allowed names
   answered and selected by the corpus's toFQDNs selector through
   ``NameManager`` and ``IPCache``, the rest REFUSED. Launch counts are
   zeroed before and read after each pass. KD, and K2 and K1 wherever
   they take it, are then held exactly against their plain versions
   and timed at every field stack of each lane and at the proxy's
   L = 256 batch. A ``baseline: {...}`` line carries the numbers;
13. the long-payload scan, the load balancer and the phase probes, each
   pass with the launch counts zeroed before and read after: (a)
   ``payload_scan_sp`` at ``bench_sp.py``'s grid (B = 10000, S in 16,
   64, 256, 1024, L in 1024 and 4096, K = 32, block 256; its seeded
   tables, classes, bytes and lengths) and on bank 0 of the http-1000
   loader path stack (7, 2048, 28) at B = 8192, L = 1024, each equal to
   KD (``dfa_finals_banked(..., impl="gather")``), to K2 at S <= 128
   and on 512 rows to the plain per-byte ``dfa_scan``; SP's and KD's
   medians of 10 forced calls, ``sp_vs_seq`` (KD ms / SP ms), SP's
   device kernels and ms a call and its peak memory; (b) ``lb_lookup``
   over 1024 services x 16 backends at the default Maglev table size
   (16381 slots: a 67 MB slab; a quarter of the services with ClientIP
   affinity, a quarter of the VIPs above 2**31), the manager built,
   packed and asked ``select()`` for 4096 flows in the worker pool
   during phases 3-7: 65536 flows (80 % to live frontends), all three
   outputs equal to the ``device="cpu"`` run, the sample to
   ``select()``, the empty manager's pack missing on the card; median
   of 25 forced calls, a traced call, the byte bound; (c) the phase
   probes: ``EnginePhaseProbe`` on phase 8's loader engine at B = 4096
   and 8192 under ``auto`` and ``nfa-bitset`` (the sub-steps' ten lanes
   equal to the fused step; coverage >= 0.9 where the plan is dense,
   one fused dispatch) and ``CapturePhaseProbe`` on phase 5's capture,
   one chunk of 65536 on the id and the row streams (lanes equal to
   ``verdict_step_capture``, coverage >= 0.9), each sub-step's device
   kernels and ms from one traced call beside its ms; both metric
   families must receive observations. A ``lb_sp_probe: {...}`` line
   carries the numbers;
14. (run after phase 15, while phase 10's soak and fleet are on: it
   holds bit-equality and the collective ledgers, and checks no time;
   its walls are read beside those lanes) the parallel layer
   (``cilium_tpu_torch/parallel``) at phase 8's
   loader-built http-1000 policy (path stack (7, 2048, 28)), B = 8192,
   every lane through ``tools/parallel_lanes.run_lane`` (the entry
   points ``stage_for_lane``, ``ulysses_scan_banked``,
   ``dfa_scan_banked_tp``, ``dfa_scan_banked_cp``, ``payload_scan_cp``)
   and held bit-equal to its single-device result: the DP, EP and CP
   verdict lanes to the fused step on all ten lanes, the raw scans to KD
   over the path stack (padded to 8 banks with inert zero banks),
   ``payload_scan_cp`` on the path bank at L = 1024 and on
   ``tests/test_longscan.py``'s PATTERNS bank at L = 2048 to
   ``payload_scan_sp``; every rank's collective ledger held to the
   reference's budget (EP one all-to-all, CP one carry exchange a
   sharded field, TP L psums and four accept planes). (a) a one-rank
   NCCL world in this process; (b) worlds of 2 and 4 spawned ranks
   sharing the one card, on ``gloo`` with each payload staged through
   pinned host memory — real sharded computations, NOT multi-GPU
   numbers, and every line says so; each lane's median wall a call (the
   slowest rank's), collective bytes, host staging ms and KD's launches
   in one call (the difference of each rank's KD count across the
   call); (c) ``run_pipelined`` over 8 host batches of 8192 against the
   sequential loop, both walls in 10 rounds, then the pipeline's pieces
   (pinning, the ring's host copy, events, ``record_stream``, the
   copies, the steps) each timed alone. The counts are set to 0
   after the single-device results and read after (a) and (c); the
   ranks of (b) count their own. A ``parallel: {...}`` line carries the
   numbers;
15. (run while phase 10's soak and fleet are on, right after its storm:
   DST is deterministic by construction and reads nothing off the wall
   clock that it checks) deterministic simulation testing
   (``runtime/dst.py``): ``DSTWorld``
   over the port's engine on the card — its loader's engine, session
   memo, serving ring and fleet staged there, its multichip arm on two
   gloo ranks sharing the card. (a) seeds 0-11 of ``generate(seed,
   max_events=12)`` through ``dst.sweep`` (12 of the 200-schedule
   sweep's seeds; the reference's own record has 25): zero
   violations; schedules, distinct schedules, simulated and wall
   seconds, KD launches and each event kind's wall ms; seeds 0-4 run
   again on the CPU in the worker pool during phases 2-10, their
   digests equal to the card's (their wall seconds are read beside
   phase 10's soak and fleet); (b) seeds 0-4 under
   ``CILIUM_TPU_DFA_IMPL=pallas``: traces equal to (a)'s, K2 launched,
   no fallback warning; (c) the committed regression case with its
   mutation (``rollback-artifact-key``: ``oracle-agreement`` at index
   4) and the reference search's first positional-banks seed (11:
   ``o-delta-compile`` at index 2), each caught on the card with the
   CPU run's violation, detail included, and clean without its
   mutation; (d) host only: 10000 label sets through two
   ``ClusterIdentityAllocator`` instances over one ``KVStore`` and a
   fresh replaying one, all equal, and 10000 announcements through
   ``LocalStatePublisher`` → ``KVStore`` → ``RemoteCluster`` into an
   ``IPCache``, each tagged with the remote cluster; host ms and
   events/s. The counts are set to 0 before (a), (b) and (c) and read
   after each (the multichip ranks' own launches are not in them). KD
   and K2 are then held exactly against their plain versions at every
   launch shape the worlds of (a) and (b) staged. A ``dst: {...}``
   line carries the numbers;
16. the bench plane, every tool in this process on the card with its
   standard output captured, each pass with the launch counts zeroed
   before and read after: ``tools/bench.py``'s headline config (http,
   1000 rules x 10000 flows, ``--check``) through a 200000-record
   capture written by ``synth.write_scenario_capture``, then fqdn, kafka
   and generic at their defaults (each with its capture lane);
   ``tools/bench_kernel`` (the fused step against the three-op path,
   lanes equal, the speedup logged beside the reference's 2.0 target;
   the literal / explosion / wide sweep through ``autotune_field``);
   ``tools/bench_stage`` at 200000 records; ``tools/bench_service``
   (one closed, one open and one stream point); ``tools/bench_protocols``'
   throughput leg; ``tools/bench_multichip`` on one NCCL rank and on two
   gloo ranks sharing the card (not a multi-GPU number); ``tools/bench_sp``
   at ``bench_sp.py``'s grid; the canary lane at ``make canary-smoke``'s
   sizes. Every line must carry the provenance stamp with the card, no
   ``bench_failed`` line may appear, every service point must report 0
   failed requests and the stream point 0 stale and lost chunks; then
   ``perf_report`` over every line (a temporary directory) must
   normalize and validate all of them and gate clean. Iterations (not shapes) are cut to keep the phase
   near 180 s (``BENCH16_*``). KD, K2 and K1 are then held exactly
   against their plain versions at every launch shape the tools staged
   in this process and at the sweep's banks, and timed at those banks
   (device, call and plain ms beside the bound). A ``bench: {...}``
   line carries the numbers;
17. the observability and ingest plane at phase 8's loader-built
   http-1000 policy: the scenario's flows repeated to 65536 records and
   written by the port's writers as a flowpb stream (absolute
   ``http.url``, as Hubble writes it), JSONL and a binary v2 capture.
   (a) The flowpb capture through ``replay_chunks`` under a
   ``ReplayCursor`` in chunks of 8192 (``cmd_replay``'s unit), each
   chunk verdicted on the card (``verdict_flows``, ``auto``: KD) and
   fanned out as the reference's ``Agent.fan_out`` does
   (``MonitorAgent.notify_batch``, ``annotate_flows`` with the engine's
   attribution map, ``Observer.observe``; one trace a chunk), while an
   ``Observer`` (capacity 4096) runs ``FlowMetrics``, a ``FlowExporter``
   and a sequence recorder, a ``HubbleServer`` serves a ``HubbleClient``
   following from seq 0, a ``MonitorServer`` serves two
   ``monitor_follow`` subscribers (``medium``, ``maximum``) and an
   ``AccessLogServer`` takes 1000 access-log records of the scenario's
   HTTP flows. Every flow the follower received equals the annotated
   flow at its seq, and received + lost = 66536 = ``server_status``'s
   ``seen``; each subscriber's events are ``events_from_outputs``' at
   its level, in order, and with its ``lost`` make up all of them; a
   filtered ``get_flows`` (``DROPPED``, an ``http_path`` regex) equals
   the same filter over the ring; the first chunk's fan-out on the card
   equals the plain path's (``device="cpu"``): annotated flows, events,
   exporter lines, ``FlowMetrics`` and monitor-event deltas, stamps
   aside. (b) The flowpb capture again under ``nfa-bitset`` (K1). (c)
   JSONL through the same object path; the binary capture through
   ``replay_chunks(decode=False)`` into ``CaptureReplay`` (``--fast``).
   (d) A replay killed after 3 committed chunks with the fourth
   processed and not committed, then resumed from the cursor. The
   verdict counts are equal across (a)-(d). Launch counts are zeroed
   before and read after the phase (KD and K1 must have launched); KD
   and K1 are then held exactly against their plain versions at every
   launch shape the phase staged. An ``observe: {...}`` line carries
   records/s a format, host ms a chunk by stage, the follower's and the
   subscribers' losses and the launches;
18. the node-local agent at the http scenario (1000 rules x 10000
   flows, batches of 8192, ``Config.from_env()``, uncut): (a)
   ``Agent(device="cuda")`` with its API, verdict-service, monitor and
   Hubble sockets in a temporary directory; (b) the scenario's endpoints,
   ``checkout`` and ``payments`` and 8 bystanders over ``PUT
   /v1/endpoint/{id}`` (IPs from IPAM's ``pod_cidr``), the 1000 rules by
   ``Agent.policy_add`` (one regeneration: its span split into the
   loader's compile and stage and the rest, the resolve), and
   ``auth-required.yaml`` as YAML over ``PUT /v1/policy``; ``GET
   /v1/healthz`` reports an engine revision; (c) ``process_flows`` over
   the 10000 flows, all ten lanes equal to a plain engine
   (``device="cpu"``) of the agent loader's policy, then timed (host ms a
   batch, a traced batch's device ms); (d) ``checkout`` -> ``payments``
   on 8443 drops, forwards after ``PUT /v1/auth``, drops after ``DELETE
   /v1/auth``; (e) ``PUT /v1/policy/trace`` on 32 of the endpoints'
   label pairs and ``GET /v1/explain`` for a chunk served through a
   ``ServeLoop`` on the agent's loader under a pinned trace id, each
   equal to the in-process call; ``PATCH /v1/config`` off (the CPU
   oracle, whose verdicts on 64 flows equal the card's) and on (a
   ``TorchVerdictEngine`` on the card again, KD launching); (f) ``PUT
   /v1/profile`` in device mode for 1 s while a thread runs
   ``process_flows`` (the Chrome trace names KD's kernel), then in host
   mode (the stacks hold ``process_flows``); (g) over the service socket
   ``policy_get``, ``status``, ``profile`` and a bulk ``verdict`` that
   reaches the monitor; the CNI plugin's ADD, CHECK and DEL as
   ``python -m cilium_tpu_torch.cni`` subprocesses against the API
   socket; ``POST /v1/drain``. Launch counts are zeroed before and read
   after the phase (KD must have launched); KD, K2 and K1 are then held
   exactly against their plain versions at every launch shape the phase
   staged. An ``agent: {...}`` line carries one regeneration's split,
   ``process_flows`` ms, each REST op's p50/p99, the CNI ADD's ms and
   the launches;
19. the cluster control services at the http scenario (1000 rules x
   10000 flows, batches of 8192, ``Config.from_env()``, uncut in shape):
   (a) ``python -m cilium_tpu_torch.kvstore_service``, ``.k8s.apiserver``,
   two ``.operator --leader-election --election-ttl 2`` (one leads, one
   stands by) and ``.hubble.relay --mode live`` as processes, sockets in
   a temporary directory; (b) two ``Agent(device="cuda")`` in this
   process, each in ``cluster-pool`` IPAM with ``crd`` identities, the
   apiserver's socket, a Hubble socket and a ``RemoteKVStore``: ``node-a``
   under ``kernel_impl="auto"`` (KD), ``node-b`` under ``nfa-bitset``
   (K1); each adopts its own /24 of the pool; (c) ``server`` on node-a,
   ``client`` on node-b and a second ``server`` on node-b, which gets
   node-a's identity through the CiliumIdentity objects; the scenario's
   rule rendered as a CiliumNetworkPolicy object (``parse_cnp`` gives the
   rule back) and applied with ``K8sClient``: apply -> enforcement
   seconds a node, each node's regeneration split into compile, stage
   and the rest; (d) ``process_flows`` over the 10000 flows on each
   node, all ten lanes equal to a plain engine (``device="cpu"``) of its
   policy and node-a's equal to node-b's, then 5 timed passes (host ms a
   batch) and a traced batch (device ms, kernels); (e) the CiliumEndpoints
   and CiliumNodes read back, a ``CESBatcher``'s slices, and 4096 fresh
   flows a node through ``process_flows``: the relay socket's stream
   equals the union of both nodes' rings, time-ordered; no control-plane
   pid in ``nvidia-smi --query-compute-apps`` and none with a
   ``/dev/nvidia*`` file open (the script's own process has them); (f) SIGTERM of the leading
   operator (rc 0): the standby takes the lock (seconds), a third agent
   ``node-c`` on the card gets its /24 from it; the CNP deleted through
   the apiserver, both nodes drop its enforcement (one batch held as in
   (d)); the agents stop leaving no thread, every process exits 0 on
   SIGTERM. Launch counts are zeroed before the agents start and read
   before they stop (KD and K1 must have launched); every launch shape is
   then held exactly against its plain version. A ``cluster: {...}`` line
   carries the numbers;
20. the daemon and the CLI at the http scenario (1000 rules x 10000
   flows, bank size 128, uncut in shape): (a) ``capture synth`` (a v2
   capture), ``capture info`` and ``capture convert`` of the same flows'
   JSONL export through ``cilium_tpu_torch.cli.main`` in this process; a
   TOML (``nfa-bitset``, bank size 128, warm restore); (b) ``python -m
   cilium_tpu_torch.daemon --config`` with its verdict, REST, Hubble and
   monitor sockets and a state directory, on the card (its pid holds
   ``/dev/nvidia*`` files): the scenario's two endpoints and its rule (a
   CNP file) through the CLI, import -> enforcement seconds from
   ``status`` and ``healthz``, the regeneration split from its metrics;
   (c) ``status``, ``policy get``, ``metrics``, ``healthz``, ``endpoint
   list``, ``identity list``, ``config get`` and ``policy trace`` timed
   (median ms); ``capture stream`` of the 10000 records: its counts and
   every record's verdict (the port's ``StreamClient``) equal to a plain
   engine of the same policy (an agent on the CPU with the same TOML,
   endpoints and CNP); ``profile --mode device`` while a stream runs
   (the daemon's Chrome trace names K1's ``nfa_scan`` kernel); ``monitor
   --count`` and ``observe`` see a bulk verdict's 64 flows (the stream
   path does not fan out, in either package); ``bugtool`` (the
   reference's sections, numpy dtype names, the card named); ``status``
   as a ``python -m cilium_tpu_torch.cli`` process, which holds no
   ``/dev/nvidia*`` file; (d) ``replay`` of the capture on the object
   path and ``--fast`` (``CaptureReplay``) and of the converted capture,
   in this process on the card under ``auto`` (KD): equal counts, equal
   to the plain engine's, ``--trace-out`` with one trace a chunk; (e)
   ``k8s apply|get|delete`` of the CNP against an ``APIServer`` here,
   its store read after each; (f) SIGTERM (drained, rc 0), a restart on
   the same state directory: the endpoints back, the snapshot restored
   warm with no compile submitted, the CNP re-imported with none either,
   one chunk held against the plain engine, SIGTERM rc 0; (g) the
   cross-cluster churn leg at 50 updates, beta on the card, its p99 gate
   at 2 x phase 10's 27-bank lane p99 (a miss recorded, not fatal; stale
   or ``ERROR`` verdicts end the run). Launches in this process are
   noted and held (``daemon_shapes_held``); a ``daemon: {...}`` line
   carries the numbers;
21. ctlint on the card's host and against the card: (a) ``python -m
   cilium_tpu_torch.analysis --format json --out
   chiprun_out/ctlint_torch.json --wall-budget-ms 40000`` as a process,
   rc 0 and no finding (its allowlisted count, each rule family's time
   and the wall printed); (b) the precommit face, ``python -m
   cilium_tpu_torch.cli lint --rule thread-safety --rule implicit-sync
   --rule hot-loop-h2d --rule readback-ordering --rule
   missing-donation`` (no ``--changed-only``: the checkout is an
   archive), rc 0 — both processes run beside (c) and (d); (c)
   ``pallas-block-shape``'s Hopper limits (warp, threads per block,
   opt-in shared memory per block) and KD's ``SMEM_MAX`` against the
   card's own properties, equal; (d) each of ``implicit-sync``'s named
   hot roots run once, warm, under ``torch.cuda.set_sync_debug_mode
   ("warn")`` — the fused step, ``ServeLoop.step`` with the
   ``VerdictRing.pack``, ``IncrementalSession.serve_ids`` and
   ``ServedPack.host`` it runs, ``CaptureReplay.verdict_chunk`` and
   ``DNSProxy.check_batch``: the synchronizing calls torch reports in
   each, beside the sync sites the rule's walk of that root sees and its
   findings; a sync at a site the rule does not see is printed as a
   miss (reported, not gated). A ``lint: {...}`` line carries the
   numbers;
22. KR, the group-space resolve, held exactly against its plain version
   at every launch shape the phases 3 to 21 staged in this process (the
   inputs of its first launch at each shape, kept while they ran; the
   spawned ranks' and the daemon's launches are in their own
   processes), then timed at the largest of them (device, call and
   plain ms, and its byte bound);
23. one JSON line ``{"kernels": [...]}`` (KR's launches counted by phase
   beside KD's, K1's and K2's), the nvidia-smi line, and last
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
import logging
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
    "KR": "each row's rule set, l7 type and the columns of the family "
          "its l7 type selects, the tables of the families the rows "
          "select and the three output lanes, once",
}
BOUND_OPS = {
    "KD": "2 per live byte and bank (one transition), non-tensor peak",
    "K1": "2*NB*B*(L-1)*P*P (D . Follow), int8 tensor-core peak",
    "K2": "2*NB*B*L*S*(K+1) (onehot(state) . table), int8 tensor-core "
          "peak",
    "KR": "none counted: a bitwise walk over the row's rule-set groups, "
          "bound by bytes",
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
#: lanes may take in all. The soak and the fleet run side by side (both
#: read their latencies on the simulation clock); the soak's virtual
#: seconds are cut from the reference's 120 to 40 (every stream still arrives within
#: the 30 s ramp; the soak's wall is ~0.13 s a 50 ms pack) and the
#: storm's updates from 56 to 20 (60 and 28 until phase 17 needed the
#: room). The fleet keeps
#: its 120: its wall is its 1.05M arrivals, which fewer virtual seconds
#: barely shorten, and at 60 its failover replays all but vanish
CHURN_IDENTITIES, CHURN_CNPS, CHURN_UPDATES, CHURN_WORKERS = \
    10_000, 5_000, 20, 4
SOAK_STREAMS, SOAK_VIRTUAL_S, SOAK_FAULTS = 100_000, 40.0, 12
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
#: phase 12: ``BASELINE.json`` configs[0], [3] and [4] at ``bench.py``'s
#: published sizes (``_DEFAULT_RULES``/``_DEFAULT_FLOWS``): (config,
#: rules, flows). configs[3]'s rules are the ``examples/policies``
#: corpus's; configs[4] is 10000 identities x 5000 CNPs
BASELINE_LANES = (("fqdn", 10, 10_000), ("mixed", 0, 1_000_000),
                  ("clustermesh", 5_000, 100_000))
CM_IDENTITIES = 10_000
#: ``bench.py``'s timing defaults: warm-up calls, batches a window
#: (``--iters``), latency samples (``--lat-iters``), the fqdn lane's
#: throughput windows (3, cut from 5 to make room for phase 17) and the
#: seconds a window is cycled to; the streamed lanes' latency chunks at
#: most
BENCH_WARMUP, BENCH_ITERS, BENCH_LAT_ITERS = 3, 20, 100
BENCH_WINDOWS, BENCH_WINDOW_S, BENCH_STREAM_LAT = 3, 1.5, 32
#: the streamed lanes' chunks held against the plain engine: the first,
#: the last and every tenth; the CPU oracle's sample (``--check``)
HOLD_EVERY, BASELINE_ORACLE_SAMPLE = 10, 500
#: the DNS proxy: the port its rules sit on, its batch sizes and the
#: timed calls at each size at least (whole passes over the qnames);
#: the server pass's queries, client threads and (of those) TCP clients and
#: unknown clients, and the records a fake upstream answer carries
DNS_PORT, DNS_BATCHES, DNS_MIN_CALLS = 53, (8192, 1), 100
DNS_QUERIES, DNS_CLIENTS, DNS_TCP_CLIENTS, DNS_UNKNOWN_CLIENTS = 200, 8, 2, 1
#: the DNS proxy pass's arms: arm → (rules, CILIUM_TPU_DFA_IMPL). The
#: fqdn rules' bank has 138 states, past K2's 128: under the oblivious
#: arm it warns and runs KD, as the reference does; the corpus's crawler
#: rules (``dns/fqdn-egress.yaml``) fit K2
DNS_ARMS = {"gather": ("fqdn", "gather"), "oblivious": ("fqdn", "pallas"),
            "oblivious-corpus": ("corpus", "pallas")}
#: phase 13a: ``bench_sp.py``'s published grid (``--flows``,
#: ``--states``, ``--lengths``, K, ``--block``, ``--iters``); the rows
#: held against the plain per-byte ``dfa_scan``; the http-1000 path
#: bank's batch at the header bucket its docstring names
SP_FLOWS, SP_STATES, SP_LENGTHS = 10_000, (16, 64, 256, 1024), (1024, 4096)
SP_K, SP_BLOCK, SP_ITERS, SP_SAMPLE = 32, 256, 10, 512
SP_BANK_B, SP_BANK_L = 8192, 1024
#: phase 13b: services x backends (at cilium's default
#: ``maglev-table-size``, 16381 slots a service: a 67 MB slab; Kubernetes'
#: scalability thresholds allow 10000 services a cluster, cut 10x), the
#: flows are REPLAY_CHUNK, the ``select()`` sample and the timed calls
LB_SERVICES, LB_BACKENDS, LB_SAMPLE, LB_TIMED = 1024, 16, 4096, 25
#: phase 13c: the engine probe's batches (``bench.py``'s probe batch and
#: phase 4's) and the probes' timed repetitions (rounds) of each
#: sub-step: the coverage is a ratio of host-bound medians, and 21
#: rounds of ~20 ms steady it
PROBE_BATCHES, PROBE_REPS = (4096, 8192), 21
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


#: the script's start, for the elapsed seconds of each phase's header
T_START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line. A phase's header also goes to standard error with
    the seconds since the start, so that the end of the error stream
    says where a run that overran its limit was."""
    print(msg, flush=True)
    if msg.startswith("phase "):
        print(f"chip_smoke +{time.perf_counter() - T_START:.1f} s: "
              f"{msg[:96]}", file=sys.stderr, flush=True)


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


def bank27_lane(card):
    """Phase 10, step 0: the 27-bank churn lane (``tools/churn_lane.run``,
    the reference's ``make churn``) on the card, at its defaults (56
    updates, seed 8). Its update → enforcement p99 is the storm's p99
    gate's denominator on this device."""
    from cilium_tpu_torch.tools import churn_lane as bank27

    reset_counts()
    t0 = time.perf_counter()
    try:
        line = bank27.run(device=DEVICE,
                          log=lambda msg: lane_log("bank27", msg))
    except AssertionError as e:
        raise SmokeFailure(f"[fleet bank27] {e}") from e
    launches, variants = lane_counts()
    check(launches["KD"] > 0, "[fleet bank27] KD never launched")
    out = {k: line[k] for k in (
        "value", "p50_ms", "updates", "banks_t0", "bank_compiles",
        "compiles_per_update", "memo_hit_ratio", "memo_invalidations",
        "cold_build_s", "compile_ms_per_update", "stage_ms_per_update",
        "oracle_checks", "stale", "errors")}
    out.update({"p99_ms": line["value"], "wall_s": time.perf_counter() - t0,
                "launches": launches, "kd_variants": variants})
    lane_log("bank27", f"{out['updates']} updates over {out['banks_t0']} "
             f"banks at t0: update to enforcement p50 {out['p50_ms']} ms, "
             f"p99 {out['p99_ms']} ms (an update on average compile "
             f"{out['compile_ms_per_update']} ms, stage "
             f"{out['stage_ms_per_update']} ms); {out['bank_compiles']} "
             f"bank compiles ({out['compiles_per_update']} an update); "
             f"memo hit ratio {out['memo_hit_ratio']}; 0 stale, 0 ERROR; "
             f"wall {out['wall_s']:.1f} s; KD {variants} on {card}")
    return out


def churn_lane(card, base_p99_ms=None):
    """Phase 10 (a), the churn storm: ``fleet.run`` at CHURN_IDENTITIES x
    CHURN_CNPS through the port's ``Loader`` on the card, its p99 gate
    armed against ``base_p99_ms``, the 27-bank lane's p99 on this card
    (step 0). The gate is checked last, after every other gate held: a
    p99 over ``fleet.P99_FACTOR`` x the lane's is logged and recorded as
    a finding with both p99s and their compile splits. The session's
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
            gate = {"armed": base_p99_ms is not None,
                    "base_p99_ms": base_p99_ms,
                    "factor": fleet.P99_FACTOR, "held": True}
            try:
                result = fleet.run(CHURN_IDENTITIES, CHURN_CNPS,
                                   CHURN_UPDATES, cache,
                                   workers=CHURN_WORKERS,
                                   gate_p99=gate["armed"],
                                   base_p99_ms=base_p99_ms,
                                   device=DEVICE, progress=progress)
            except fleet.P99GateError as e:
                # every other gate held; the p99 gate's outcome is the
                # finding this run records (the factor is the
                # reference's, not loosened)
                result = e.result
                gate.update(held=False, reason=str(e))
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
        "p99_gate": dict(gate, bound_ms=result["p99_bound_ms"]),
        # what the parent holds and times KD at
        "policies": {"t0": first, "final": final}, "flows": flows})
    check(launches["KD"] > 0, "[fleet churn] KD never launched")
    if gate["armed"]:
        lane_log("churn", f"p99 gate ({gate['factor']} x the 27-bank "
                 f"lane's {base_p99_ms} ms = {result['p99_bound_ms']} ms): "
                 f"storm p99 {result['value']} ms — "
                 + ("held" if gate["held"] else
                    "NOT held: recorded as a finding (the storm's update "
                    "compiles a ~2800-state bank, the lane's a 4-pattern "
                    "one)"))
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


def lane_child(name, card, kw=None):
    """One lane in a spawned process: its own interpreter, CUDA context,
    registries and peak RSS. Returns (report, None), or (None, the
    failure) — the parent raises it."""
    import traceback

    import torch

    os.environ["CILIUM_TPU_DFA_IMPL"] = "gather"
    try:
        torch.cuda.init()
        rss0 = rss_mb()                # the interpreter, torch and CUDA
        report = LANES[name](card, **(kw or {}))
        report["rss_start_mb"] = rss0
        return report, None
    except SmokeFailure as e:
        return None, str(e)
    except Exception:  # noqa: BLE001 — reported by the parent
        return None, traceback.format_exc()[-4000:]


LANES = {"bank27": bank27_lane, "churn": churn_lane, "soak": soak_lane,
         "serve": fleet_lane}


@contextlib.contextmanager
def fleet_phase(card):
    """Phase 10: the cluster-mesh lanes, each in a spawned process of
    its own (its own interpreter, CUDA context and peak RSS). The two
    lanes timed on the wall clock (the 27-bank lane, whose p99 arms the
    storm's gate, then the storm) run one after another while this
    process waits, so that no other work runs beside theirs; then the
    soak and the fleet, whose latencies are read on the simulation
    clock, are started side by side and the block runs (phase 15,
    deterministic by construction, and phase 14, which checks no time,
    run there). Yields a function that
    waits for them → (report, launches by lane, KD variants by lane,
    what the holds need)."""
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    got, walls, pools, jobs = {}, {}, {}, {}

    def start(n):
        pools[n] = ctx.Pool(1)
        # the storm's p99 gate: the 27-bank lane's p99 on this card
        kw = ({"base_p99_ms": got["bank27"]["p99_ms"]}
              if n == "churn" else None)
        jobs[n] = (pools[n].apply_async(lane_child, (n, card, kw)),
                   time.perf_counter())

    def wait_all():
        # each lane read as it ends, so that its wall is its own
        while jobs:
            for n, (job, t1) in list(jobs.items()):
                left = LANE_TIMEOUT_S - (time.perf_counter() - t0)
                if not job.ready() and left > 0:
                    continue
                del jobs[n]
                try:
                    report, err = job.get(timeout=max(1.0, left))
                except multiprocessing.TimeoutError:
                    raise SmokeFailure(f"[fleet {n}] the lanes ran past "
                                       f"{LANE_TIMEOUT_S} s") from None
                check(err is None, f"[fleet {n}] the lane failed: {err}")
                got[n] = report
                # the lane's process, spawn and import included
                walls[n] = time.perf_counter() - t1
                pool = pools.pop(n)
                pool.terminate()
                pool.join()
            time.sleep(0.05)

    def finish():
        wait_all()
        wall = time.perf_counter() - t0
        soak, serve = got["soak"], got["serve"]
        # the fleet's p99 gate: at most twice the single host's, both
        # read on the simulation clock of this run
        check(serve["virtual_p99_ms"] <= 2.0 * soak["virtual_p99_ms"],
              f"[fleet serve] virtual p99 {serve['virtual_p99_ms']} ms "
              f"over twice the soak's {soak['virtual_p99_ms']} ms")
        serve["single_host_virtual_p99_ms"] = soak["virtual_p99_ms"]
        launches = {n: got[n].pop("launches") for n in LANES}
        variants = {n: got[n].pop("kd_variants") for n in LANES}
        held = {"policies": got["churn"].pop("policies"),
                "flows": got["churn"].pop("flows"),
                "pack_records": soak["pack_records"]}
        report = {"card": card, "wall_s": wall, "process_wall_s": walls,
                  "side_by_side": ["soak", "serve", "phase 15",
                                   "phase 14"],
                  "bank27": got["bank27"],
                  "churn": got["churn"], "soak": soak, "serve": serve,
                  "cuts": {"churn_updates": (CHURN_UPDATES, 56),
                           "soak_virtual_s": (SOAK_VIRTUAL_S, 120.0),
                           "serve_virtual_s": (FLEET_VIRTUAL_S, 120.0)}}
        log(f"phase 10 wall {wall:.1f} s (bank27 then churn alone, then "
            f"soak and serve side by side, phases 15 and 14 beside them; "
            f"each lane's process "
            f"{', '.join(f'{n} {w:.1f} s' for n, w in walls.items())})")
        return report, launches, variants, held

    try:
        for n in ("bank27", "churn"):
            start(n)
            wait_all()
        start("soak")
        start("serve")
        yield finish
    finally:
        for pool in pools.values():
            pool.terminate()
            pool.join()


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

    from cilium_tpu_torch.engine import dfa_dense_cuda
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
        nfa = TorchVerdictEngine(policy, device=DEVICE, cfg=dataclasses.replace(
            engine.cfg, kernel_impl="nfa-bitset"))
        takes = hold_stack(errs, f"proto {name} l7g", arr, "l7g", data, lens,
                           nfa._arrays)
        nfa_fields = ({"l7g": (nfa._arrays, data, lens)} if "K1" in takes
                      else {})
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


# ------------------------------------------------------- BASELINE configs
def corpus_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "policies")


def baseline_scenario(name: str, n_rules: int, n_flows: int):
    """``bench.py``'s scenario of one BASELINE config."""
    from cilium_tpu_torch.ingest import synth

    if name == "fqdn":
        return synth.scenario_by_name("fqdn", n_rules, n_flows)
    if name == "mixed":
        return synth.synth_mixed_scenario(corpus_dir(), n_tuples=n_flows)
    return synth.synth_clustermesh_scenario(
        n_identities=CM_IDENTITIES, n_policies=n_rules, n_flows=n_flows)


def host_slice(host, lo, hi):
    return {k: v[lo:hi] for k, v in host.items()}


def lanes_np(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def verdict_mix(outs):
    import numpy as np

    v = np.concatenate([np.asarray(o["verdict"]) for o in outs])
    return np.bincount(v, minlength=6).tolist()


def bench_batch(engine, host):
    """``bench.py``'s unstreamed methodology (the fqdn config): distinct
    permuted copies of the whole batch, staged untimed; BENCH_LAT_ITERS
    completion-forced latency samples in windows of BENCH_ITERS; then
    BENCH_WINDOWS windows of BENCH_ITERS copies cycled to ~1.5 s with
    one forced completion each: verdicts/s of the median window."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine.verdict import batch_to_device

    step = engine.verdict_batch_arrays
    n = len(host["scalars"])
    prng = np.random.default_rng(0)

    def copies(k):
        out = []
        for _ in range(k):
            perm = prng.permutation(n)
            out.append(batch_to_device({key: v[perm]
                                        for key, v in host.items()}, DEVICE))
        torch.cuda.synchronize()
        return out

    wb = copies(BENCH_WARMUP + 1)
    for b in wb:
        force(step(b))
    times = []
    while len(times) < BENCH_LAT_ITERS:
        wb = copies(min(BENCH_ITERS, BENCH_LAT_ITERS - len(times)))
        force(step(wb[0]))
        for b in wb:
            t0 = time.perf_counter()
            force(step(b))
            times.append(time.perf_counter() - t0)
    windows, reps = [], 1
    for w in range(BENCH_WINDOWS):
        wb = copies(BENCH_ITERS)
        force(step(wb[0]))
        if w == 0:
            t0 = time.perf_counter()
            outs = [step(b) for b in wb]
            force(outs[-1])
            reps = max(1, int(BENCH_WINDOW_S
                              / max(time.perf_counter() - t0, 1e-3)))
        t0 = time.perf_counter()
        for _ in range(reps):
            outs = [step(b) for b in wb]
        force(outs[-1])
        windows.append(time.perf_counter() - t0)
    q = quantiles_ms(times)
    return {"p50_ms": q["p50_ms"], "p99_ms": q["p99_ms"],
            "latency_samples": len(times), "windows": len(windows),
            "reps": reps, "verdicts_per_s": n * BENCH_ITERS * reps
            / statistics.median(windows)}


def bench_stream(engine, host, bs):
    """``bench.py``'s streamed methodology (configs[3], [4]): every
    chunk of ``bs`` staged on the card before the timer starts; one
    compile call and BENCH_WARMUP warm-up chunks; a completion-forced
    latency pass per chunk; then the remaining chunks dispatched once
    (probe) and cycled to ~1.5 s with one forced completion.
    Returns (timing, staged chunks)."""
    import torch

    from cilium_tpu_torch.engine.verdict import batch_to_device

    step = engine.verdict_batch_arrays
    n_chunks = len(host["scalars"]) // bs
    check(n_chunks >= BENCH_WARMUP + 4,
          f"{n_chunks} chunks of {bs}: too few to time")
    t0 = time.perf_counter()
    chunks = [batch_to_device(host_slice(host, c * bs, (c + 1) * bs),
                              DEVICE) for c in range(n_chunks)]
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    force(step(chunks[0]))
    for i in range(BENCH_WARMUP):
        out = step(chunks[1 + i])
    force(out)
    n_lat = max(1, min(BENCH_STREAM_LAT, n_chunks - 1 - BENCH_WARMUP - 2))
    times = []
    for c in range(1 + BENCH_WARMUP, 1 + BENCH_WARMUP + n_lat):
        t0 = time.perf_counter()
        force(step(chunks[c]))
        times.append(time.perf_counter() - t0)
    first = 1 + BENCH_WARMUP + n_lat
    t0 = time.perf_counter()
    for c in range(first, n_chunks):
        out = step(chunks[c])
    force(out)
    reps = max(1, int(BENCH_WINDOW_S / max(time.perf_counter() - t0, 1e-3)))
    t0 = time.perf_counter()
    for _ in range(reps):
        outs = [step(chunks[c]) for c in range(first, n_chunks)]
    force(outs[-1])
    t_stream = time.perf_counter() - t0
    q = quantiles_ms(times)
    return ({"chunks": n_chunks, "chunk": bs, "stage_s": stage_s,
             "staged_mib": sum(nbytes(*c.values()) for c in chunks) / 2 ** 20,
             "p50_ms": q["p50_ms"], "p99_ms": q["p99_ms"],
             "latency_samples": len(times), "reps": reps,
             "streamed": (n_chunks - first) * bs * reps,
             "verdicts_per_s": (n_chunks - first) * bs * reps / t_stream},
            chunks)


def autotune_lane(name, engine, held, card):
    """The lane's policy staged once more under ``kernel_impl=
    "autotune"`` on the card: every field's pick with its card times,
    one ``cilium_tpu_kernel_autotune_picks_total`` a new shape key (by
    impl and field), and the held batches' lanes equal to ``auto``'s.
    Counts to 0 just before, read just after."""
    import dataclasses

    from cilium_tpu_torch.engine import _build, megakernel
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
    from cilium_tpu_torch.runtime.metrics import (
        KERNEL_AUTOTUNE_PICKS,
        METRICS,
    )

    def picks():
        return {(impl, f): METRICS.get(KERNEL_AUTOTUNE_PICKS,
                                       {"impl": impl, "field": f})
                for impl in (megakernel.IMPL_DENSE, megakernel.IMPL_NFA)
                for f in ("path", "method", "host", "hdr", "dns", "l7g")}

    keys0, picks0 = set(megakernel._AUTOTUNE_CACHE), picks()
    _build.reset_launches()
    t0 = time.perf_counter()
    at = TorchVerdictEngine(engine.policy, device=DEVICE, cfg=dataclasses
                            .replace(engine.cfg, kernel_impl="autotune"))
    build_s = time.perf_counter() - t0
    for i, (batch, want) in enumerate(held):
        assert_lanes(f"[baseline {name} autotune] held batch {i} vs auto",
                     lanes_np(at.verdict_batch_arrays(batch)), want)
    launches, variants = lane_counts()
    new = set(megakernel._AUTOTUNE_CACHE) - keys0
    picks1 = picks()
    for (impl, f), n0 in picks0.items():
        want_n = sum(1 for k in new if k[0] == f
                     and megakernel._AUTOTUNE_CACHE[k]["impl"] == impl)
        check(picks1[(impl, f)] - n0 == want_n,
              f"[baseline {name} autotune] {picks1[(impl, f)] - n0} picks "
              f"counted for ({impl}, {f}), {want_n} new shape keys")
    report = {f: {"impl": r["impl"], "dense_ms": r["dense_ms"],
                  "nfa_ms": r["nfa_ms"], "stack": (r["banks"],
                                                   r["dfa_states"]),
                  "nfa_positions": r["nfa_positions"]}
              for f, r in at.kernel_report.items()}
    for f, r in report.items():
        check(r["dense_ms"] is not None and r["dense_ms"] >= 0,
              f"[baseline {name} autotune] {f}: no dense time")
    log(f"[baseline {name} autotune] staged in {build_s:.3f} s, "
        f"{len(new)} new shape keys; picks (impl, dense ms, nfa ms) "
        + json.dumps({f: [r["impl"], r["dense_ms"], r["nfa_ms"]]
                      for f, r in report.items()})
        + f"; {len(held)} held batches equal to auto's; launches "
        f"{launches} on {card}")
    return ({"picks": report, "new_keys": len(new), "build_s": build_s,
             "held_batches": len(held)}, launches, variants)


def baseline_lane(name, n_rules, n_flows, cache_dir, card):
    """One BASELINE config as ``bench.py`` runs it, through the port's
    entry points: the scenario, ``realize_scenario`` (the resolve),
    ``Loader(Config())`` on the card (compile), ``encode_flows``; then
    the timed passes (:func:`bench_batch` or :func:`bench_stream`). All
    ten lanes are held against a ``device="cpu"`` engine of the same
    policy on every flow (fqdn) or on the first, the last and every
    tenth chunk; the counts are set to 0 before the first verdict and
    read after the holds; then BASELINE_ORACLE_SAMPLE flows against the
    CPU oracle, as ``bench.py --check`` does, and the autotune arm."""
    import numpy as np

    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.engine.compiled import (
        encode_flows,
        flowbatch_to_host_dict,
    )
    from cilium_tpu_torch.engine.megakernel import IMPL_NFA
    from cilium_tpu_torch.engine.verdict import (
        TorchVerdictEngine,
        batch_to_device,
    )
    from cilium_tpu_torch.ingest import synth
    from cilium_tpu_torch.policy.oracle import OracleVerdictEngine
    from cilium_tpu_torch.runtime.loader import Loader

    tag = f"baseline {name}"
    t_lane = time.perf_counter()
    host_s = {}
    t0 = time.perf_counter()
    scenario = baseline_scenario(name, n_rules, n_flows)
    host_s["scenario"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    per_identity, scenario = synth.realize_scenario(scenario)
    host_s["resolve"] = time.perf_counter() - t0
    cfg = Config()
    cfg.loader.cache_dir = cache_dir
    loader = Loader(cfg, device=DEVICE)
    try:
        t0 = time.perf_counter()
        loader.regenerate(per_identity, revision=1)
        host_s["compile"] = time.perf_counter() - t0
        engine, ecfg = loader.engine, loader.config.engine
        t0 = time.perf_counter()
        host = flowbatch_to_host_dict(encode_flows(
            scenario.flows, engine.policy.kafka_interns, ecfg))
        host_s["encode"] = time.perf_counter() - t0
        n = len(scenario.flows)
        stacks = {p: tuple(engine.policy.arrays[f"{p}_trans"].shape)
                  for p in ("path", "method", "host", "hdr", "dns", "l7g")
                  if f"{p}_trans" in engine.policy.arrays}
        log(f"[{tag}] {len(scenario.rules)} rules, {len(per_identity)} "
            f"identities, {n} flows; host s {json.dumps(host_s)}; impl_plan "
            f"{json.dumps(engine.impl_plan, sort_keys=True)}; stacks "
            f"{stacks}")
        plain = TorchVerdictEngine(engine.policy, device="cpu", cfg=ecfg)
        _build.reset_launches()
        if name == "fqdn":
            full = batch_to_device(host, DEVICE)
            timing = bench_batch(engine, host)
            held_idx = [0]
            held = [(full, lanes_np(engine.verdict_batch_arrays(full)))]
            wants = [lanes_np(plain.verdict_batch_arrays(
                batch_to_device(host, "cpu")))]
        else:
            bs = ecfg.batch_size
            timing, chunks = bench_stream(engine, host, bs)
            host_s["staging"] = timing["stage_s"]
            last = len(chunks) - 1
            held_idx = sorted(set(range(0, last + 1, HOLD_EVERY)) | {last})
            held = [(chunks[c], lanes_np(engine.verdict_batch_arrays(
                chunks[c]))) for c in held_idx]
            wants = [lanes_np(plain.verdict_batch_arrays(batch_to_device(
                host_slice(host, c * bs, (c + 1) * bs), "cpu")))
                for c in held_idx]
            del chunks
        for c, (_, got), want in zip(held_idx, held, wants):
            assert_lanes(f"[{tag}] chunk {c} vs the plain engine", got, want)
        launches, variants = lane_counts()
        check(launches["KD"] > 0, f"[{tag}] KD never launched: {launches}")
        if IMPL_NFA in engine.impl_plan.values():
            check(launches["K1"] > 0,
                  f"[{tag}] the NFA arm's K1 never launched: {launches}")
        mix = verdict_mix([w for _, w in held])
        held_flows = sum(len(w["verdict"]) for _, w in held)
        check(mix[2] > 0 and mix[1] + mix[5] > 0 and sum(mix) == held_flows,
              f"[{tag}] implausible verdict mix {mix} (identity wiring?)")
        sample = scenario.flows[:BASELINE_ORACLE_SAMPLE]
        want = OracleVerdictEngine(per_identity).verdict_flows(sample)
        got = engine.verdict_flows(sample, cfg=ecfg)
        bad = int((np.asarray(got["verdict"])
                   != np.asarray(want["verdict"])).sum())
        check(bad == 0, f"[{tag}] {bad} of {len(sample)} flows differ from "
                        f"the CPU oracle")
        log(f"[{tag}] {timing.get('chunks', 1)} "
            f"{'chunks' if 'chunks' in timing else 'batch'}: p50 / p99 "
            f"{timing['p50_ms']:.3f} / {timing['p99_ms']:.3f} ms (forced), "
            f"{timing['verdicts_per_s'] / 1e6:.3f}M verdicts/s; all 10 lanes "
            f"equal to the plain engine on {held_flows} flows ({len(held)} "
            f"held batches), {len(sample)} to the CPU oracle; verdict mix "
            f"[code 0..5] {mix}; launches {launches}, KD by variant "
            f"{variants} on {card}")
        autotune, at_launches, at_variants = autotune_lane(name, engine, held,
                                                          card)
        line = {"config": name, "rules": len(scenario.rules),
                "identities": len(per_identity), "flows": n,
                "host_s": host_s, "timing": timing, "mix": mix,
                "held_flows": held_flows, "held_batches": len(held),
                "oracle_sample": len(sample), "stacks": stacks,
                "impl_plan": dict(engine.impl_plan), "autotune": autotune,
                "lane_wall_s": time.perf_counter() - t_lane}
        kept = {"engine": engine, "batch": held[0][0], "scenario": scenario}
        return (line, {f"baseline-{name}": launches,
                       f"baseline-{name}-autotune": at_launches},
                {f"baseline-{name}": variants,
                 f"baseline-{name}-autotune": at_variants}, kept)
    finally:
        loader.close()


def dns_rules_of(rules, selects=None):
    """The ``toPorts.rules.dns`` of the egress rules (of the subjects
    matching ``selects``, a label dict, when given) on DNS_PORT."""
    from cilium_tpu_torch.core.labels import LabelSet

    out = []
    for r in rules:
        if selects is not None and not r.selects(
                LabelSet.from_dict(selects)):
            continue
        for er in r.egress:
            for pr in er.to_ports:
                if pr.rules is not None and any(
                        pp.port == DNS_PORT for pp in pr.ports):
                    out.extend(pr.rules.dns)
    return out


@contextlib.contextmanager
def kd_shapes_noted(shapes):
    """Note the (NB, S, K, B, L) of every dense scan the DFA arm runs."""
    from cilium_tpu_torch.engine import dfa_kernel

    real = dfa_kernel.dense_scan

    def noted(trans, byteclass, start, data, lengths, **kw):
        shapes.add(tuple(trans.shape) + tuple(data.shape))
        return real(trans, byteclass, start, data, lengths, **kw)

    dfa_kernel.dense_scan = noted
    try:
        yield
    finally:
        dfa_kernel.dense_scan = real


def dns_proxy_phase(scenario, card):
    """The DNS proxy on the card: ``DNSProxy(use_tpu=True)`` with the
    fqdn rules (or the corpus's crawler rules) installed for the crawler
    endpoint on DNS_PORT; ``check_batch`` over the scenario's qnames at
    each of DNS_BATCHES under each of DNS_ARMS, every verdict equal to
    ``check_allowed``'s and to a ``device="cpu"`` proxy's; counts to 0
    just before each arm, read just after: KD on the gather arm, its
    scans at L = 256; K2 on the oblivious arm where the stack fits, else
    KD with the reference's warning. Then the ``dnsproxy.query`` fault
    armed once: the same verdicts and one fallback counted; none counted
    outside that pass."""
    import numpy as np

    from cilium_tpu_torch.engine import _build
    from cilium_tpu_torch.fqdn.dnsproxy import QNAME_LEN, DNSProxy
    from cilium_tpu_torch.policy.api import load_cnp_dir
    from cilium_tpu_torch.runtime import faults
    from cilium_tpu_torch.runtime.metrics import DNSPROXY_FALLBACKS, METRICS

    ep = scenario.ids["crawler"]
    rule_sets = {"fqdn": dns_rules_of(scenario.rules),
                 "corpus": dns_rules_of(
                     [r for cnp in load_cnp_dir(corpus_dir())
                      for r in cnp.rules], {"app": "crawler"})}
    qnames = [f.dns.query for f in scenario.flows]
    n = len(qnames)
    wants = {}
    for name, rules in rule_sets.items():
        regex = DNSProxy(use_tpu=False)
        regex.update_allowed(ep, DNS_PORT, rules)
        wants[name] = np.array([regex.check_allowed(ep, DNS_PORT, q)
                                for q in qnames])
        cpu = DNSProxy(use_tpu=True, device="cpu")
        cpu.update_allowed(ep, DNS_PORT, rules)
        check(np.array_equal(cpu.check_batch(ep, DNS_PORT, qnames),
                             wants[name]),
              f"[dnsproxy] the device='cpu' proxy disagrees with "
              f"check_allowed on the {name} rules")
    fb0 = METRICS.get(DNSPROXY_FALLBACKS)
    env0 = os.environ.get("CILIUM_TPU_DFA_IMPL", "gather")
    out, launches, variants, held = {"qnames": n}, {}, {}, {}
    try:
        for arm, (rules_of, impl) in DNS_ARMS.items():
            want = wants[rules_of]
            os.environ["CILIUM_TPU_DFA_IMPL"] = impl
            proxy = DNSProxy(use_tpu=True, device=DEVICE)
            proxy.update_allowed(ep, DNS_PORT, rule_sets[rules_of])
            stack = tuple(proxy._get_banked((ep, DNS_PORT), proxy._rules[
                (ep, DNS_PORT)])["trans"].shape)
            kernel = "K2" if impl == "pallas" and stack[1] <= 128 else "KD"
            shapes = set()
            res = {}
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always", RuntimeWarning)
                _build.reset_launches()
                with kd_shapes_noted(shapes):
                    for B in DNS_BATCHES:
                        lat = []
                        # passes over the qnames: at least DNS_MIN_CALLS
                        # timed calls at each batch size
                        for _ in range(-(-DNS_MIN_CALLS // -(-n // B))):
                            got = []
                            for lo in range(0, n, B):
                                t0 = time.perf_counter()
                                got.append(proxy.check_batch(
                                    ep, DNS_PORT, qnames[lo:lo + B]))
                                lat.append(time.perf_counter() - t0)
                            check(np.array_equal(np.concatenate(got), want),
                                  f"[dnsproxy {arm}] B={B}: verdicts differ "
                                  f"from check_allowed's")
                        res[f"B{B}"] = {**quantiles_ms(lat),
                                        "calls": len(lat)}
                ln, vr = lane_counts()
            launches[f"baseline-dnsproxy-{arm}"] = ln
            variants[f"baseline-dnsproxy-{arm}"] = vr
            check(ln[kernel] > 0, f"[dnsproxy {arm}] {kernel} never "
                                  f"launched: {ln}")
            if kernel == "KD":
                check(shapes and all(s[4] == QNAME_LEN for s in shapes),
                      f"[dnsproxy {arm}] KD's scans {sorted(shapes)} are "
                      f"not at L = {QNAME_LEN}")
            if impl == "pallas" and kernel == "KD":
                check(any("constant-time guarantee" in str(w.message)
                          for w in caught),
                      f"[dnsproxy {arm}] the {stack[1]}-state stack must "
                      f"warn on the oblivious arm's fallback")
            log(f"[dnsproxy {arm}] {rules_of} rules, stack (NB, S, K) "
                f"{stack}: {n} qnames, {int(want.sum())} allowed, each "
                f"equal to check_allowed and the device='cpu' proxy; "
                + "; ".join(f"B={b}: p50 / p99 {r['p50_ms']:.3f} / "
                            f"{r['p99_ms']:.3f} ms over {r['calls']} calls"
                            for b, r in zip(DNS_BATCHES, res.values()))
                + f"; on {kernel}, KD scans at {sorted(shapes)}; launches "
                f"{ln} on {card}")
            out[arm] = {"rules": rules_of, "stack": stack, "kernel": kernel,
                        "allowed": int(want.sum()),
                        "kd_shapes": sorted(shapes), **res}
            held[arm] = proxy
        proxy, want = held["gather"], wants["fqdn"]
        fb1 = METRICS.get(DNSPROXY_FALLBACKS)
        check(fb1 == fb0, f"[dnsproxy] {fb1 - fb0} fallbacks outside the "
                          f"injected pass")
        os.environ["CILIUM_TPU_DFA_IMPL"] = "gather"
        with faults.inject(faults.FaultPlan(
                [faults.FaultRule("dnsproxy.query", times=1)])):
            got = np.concatenate([proxy.check_batch(
                ep, DNS_PORT, qnames[lo:lo + DNS_BATCHES[0]])
                for lo in range(0, n, DNS_BATCHES[0])])
        fb2 = METRICS.get(DNSPROXY_FALLBACKS)
        check(np.array_equal(got, want) and fb2 - fb1 == 1,
              f"[dnsproxy fault] {fb2 - fb1} fallbacks counted (want 1); "
              f"verdicts equal: {np.array_equal(got, want)}")
        log(f"[dnsproxy fault] dnsproxy.query armed once: the same {n} "
            f"verdicts, one fallback counted, none outside this pass")
        out["fallbacks"] = {"injected_pass": fb2 - fb1, "outside": fb1 - fb0}
    finally:
        os.environ["CILIUM_TPU_DFA_IMPL"] = env0
    return out, launches, variants, held


class FakeUpstream:
    """An in-process resolver on one UDP and one TCP socket of the same
    port: every A query is answered with :func:`answer_ip` of its name
    (TCP with RFC 7766 framing); the names asked are kept."""

    def __init__(self):
        import socket
        import threading

        for _ in range(10):
            self.udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self.udp.bind(("127.0.0.1", 0))
            self.address = self.udp.getsockname()
            self.tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                self.tcp.bind(self.address)
                break
            except OSError:
                self.udp.close()
                self.tcp.close()
        self.tcp.listen(16)
        self.udp.settimeout(0.2)
        self.tcp.settimeout(0.2)
        self.asked = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=f, daemon=True)
                         for f in (self._serve_udp, self._serve_tcp)]
        for t in self._threads:
            t.start()

    def _answer(self, data):
        import socket

        from cilium_tpu_torch.fqdn import wire

        msg = wire.decode(data)
        with self._lock:
            self.asked.append(msg.qname)
        return wire.encode_response(data, wire.RCODE_NOERROR, [
            (msg.qname, wire.QTYPE_A, 300,
             socket.inet_aton(answer_ip(msg.qname)))])

    def _serve_udp(self):
        import socket

        while not self._stop.is_set():
            try:
                data, client = self.udp.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                return
            self.udp.sendto(self._answer(data), client)

    def _serve_tcp(self):
        import socket

        from cilium_tpu_torch.fqdn.server import DNSProxyServer

        while not self._stop.is_set():
            try:
                conn, _ = self.tcp.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                conn.settimeout(2.0)
                hdr = DNSProxyServer._recvn(conn, 2)
                data = hdr and DNSProxyServer._recvn(
                    conn, int.from_bytes(hdr, "big"))
                if not data:
                    continue
                resp = self._answer(data)
                conn.sendall(len(resp).to_bytes(2, "big") + resp)

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self.udp.close()
        self.tcp.close()


def answer_ip(qname: str) -> str:
    import zlib

    h = zlib.crc32(qname.lower().encode())
    return f"10.99.{(h >> 8) & 255}.{h & 255}"


def dns_server_phase(scenario, card):
    """The DNS proxy server, host only: a ``DNSProxyServer`` on
    127.0.0.1 over a :class:`FakeUpstream`, the fqdn scenario's rules
    and the corpus's crawler rules (``dns/fqdn-egress.yaml``) installed
    for the crawler endpoint, the corpus's toFQDNs selectors registered
    with a ``NameManager`` over an ``IPCache``. DNS_QUERIES queries from
    DNS_CLIENTS client threads: UDP from 127.0.0.1, DNS_TCP_CLIENTS of
    them over one TCP connection each, DNS_UNKNOWN_CLIENTS over UDP
    from 127.0.0.2, which no endpoint owns. Allowed queries are answered
    NOERROR with the upstream's address, denied and unknown-client ones
    REFUSED without reaching the upstream; every answered name under a
    corpus selector has a CIDR identity in the ipcache that the
    selector selects."""
    import random
    import re
    import socket

    from cilium_tpu_torch.core.identity import IdentityAllocator
    from cilium_tpu_torch.fqdn import DNSProxy, DNSProxyServer, NameManager
    from cilium_tpu_torch.fqdn import wire
    from cilium_tpu_torch.ipcache import IPCache
    from cilium_tpu_torch.policy.api import load_cnp_dir
    from cilium_tpu_torch.policy.compiler import matchpattern
    from cilium_tpu_torch.policy.selectorcache import SelectorCache

    ep = scenario.ids["crawler"]
    corpus = [r for c in load_cnp_dir(corpus_dir()) for r in c.rules]
    fqdn_sels = [fs for r in corpus for er in r.egress for fs in er.to_fqdns]
    check(bool(fqdn_sels), "[dns server] the corpus has no toFQDNs selector")
    alloc = IdentityAllocator()
    cache = SelectorCache(alloc)
    ipc = IPCache(alloc, cache)
    nm = NameManager(cache, ipc)
    for fs in fqdn_sels:
        nm.register_selector(fs)
    proxy = DNSProxy(name_manager=nm, use_tpu=True, device=DEVICE)
    proxy.update_allowed(ep, DNS_PORT, dns_rules_of(scenario.rules)
                         + dns_rules_of(corpus, {"app": "crawler"}))
    universe = sorted({f.dns.query for f in scenario.flows}
                      | {"www.cilium.io", "example.com", "evil.io"})
    rng = random.Random(0)
    per_client = DNS_QUERIES // DNS_CLIENTS
    plans = [[rng.choice(universe) for _ in range(per_client)]
             for _ in range(DNS_CLIENTS)]
    upstream = FakeUpstream()
    server = DNSProxyServer(
        proxy, endpoint_of=lambda ip: ep if ip == "127.0.0.1" else None,
        upstream=upstream.address, dport=DNS_PORT).start()
    lat, answers = [], {}

    def ask_udp(i, source):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind((source, 0))
        s.settimeout(5.0)
        try:
            for j, q in enumerate(plans[i]):
                t0 = time.perf_counter()
                s.sendto(wire.encode_query(1000 * i + j, q), server.address)
                data, _ = s.recvfrom(4096)
                lat.append(time.perf_counter() - t0)
                answers[(i, j)] = wire.decode(data)
        finally:
            s.close()

    def ask_tcp(i):
        with socket.create_connection(server.address, timeout=5.0) as s:
            for j, q in enumerate(plans[i]):
                t0 = time.perf_counter()
                msg = wire.encode_query(1000 * i + j, q)
                s.sendall(len(msg).to_bytes(2, "big") + msg)
                hdr = DNSProxyServer._recvn(s, 2)
                data = DNSProxyServer._recvn(s, int.from_bytes(hdr, "big"))
                lat.append(time.perf_counter() - t0)
                answers[(i, j)] = wire.decode(data)

    kind = (["tcp"] * DNS_TCP_CLIENTS + ["unknown"] * DNS_UNKNOWN_CLIENTS
            + ["udp"] * (DNS_CLIENTS - DNS_TCP_CLIENTS
                         - DNS_UNKNOWN_CLIENTS))

    def client(i):
        if kind[i] == "tcp":
            ask_tcp(i)
        else:
            ask_udp(i, "127.0.0.2" if kind[i] == "unknown" else "127.0.0.1")

    t0 = time.perf_counter()
    try:
        run_threads(client, DNS_CLIENTS, "dns server")
    finally:
        wall = time.perf_counter() - t0
        server.stop()
        upstream.close()
    forwarded = []
    for i, plan in enumerate(plans):
        for j, q in enumerate(plan):
            msg = answers[(i, j)]
            allowed = kind[i] != "unknown" and proxy.check_allowed(
                ep, DNS_PORT, q)
            check(msg.txid == 1000 * i + j and msg.qname == q,
                  f"[dns server] answer {msg.txid} {msg.qname!r} to query "
                  f"{1000 * i + j} {q!r}")
            if allowed:
                forwarded.append(q)
                check(msg.rcode == wire.RCODE_NOERROR and [
                    a.ip for a in msg.answers] == [answer_ip(q)],
                      f"[dns server] allowed {q!r} answered rcode "
                      f"{msg.rcode} {[a.ip for a in msg.answers]}")
            else:
                check(msg.rcode == wire.RCODE_REFUSED and not msg.answers,
                      f"[dns server] {kind[i]} query {q!r} answered rcode "
                      f"{msg.rcode}, not REFUSED")
    check(sorted(upstream.asked) == sorted(forwarded),
          f"[dns server] the upstream saw {len(upstream.asked)} queries, "
          f"{len(forwarded)} were allowed")
    selected = set()
    for fs in fqdn_sels:
        rx = re.compile(matchpattern.name_to_regex(fs.match_name)
                        if fs.match_name else
                        matchpattern.to_regex(fs.match_pattern))
        ids = cache.get_selections(fs)
        for q in set(forwarded):
            if rx.match(matchpattern.sanitize_name(q)):
                nid = ipc.lookup(answer_ip(q))
                check(nid is not None and nid in ids,
                      f"[dns server] {q!r} → {answer_ip(q)}: identity {nid} "
                      f"not selected by {fs}")
                selected.add(nid)
    check(bool(selected), "[dns server] no answered name fell under a corpus "
                          "toFQDNs selector")
    q = quantiles_ms(lat)
    refused = sum(1 for m in answers.values()
                  if m.rcode == wire.RCODE_REFUSED)
    log(f"[dns server] {DNS_QUERIES} queries from {DNS_CLIENTS} clients "
        f"({DNS_TCP_CLIENTS} TCP, {DNS_UNKNOWN_CLIENTS} unknown) in "
        f"{wall:.3f} s: {len(forwarded)} forwarded and answered, {refused} "
        f"REFUSED; client p50 / p99 {q['p50_ms']:.3f} / {q['p99_ms']:.3f} "
        f"ms (host only: check_allowed is host regex); {len(selected)} CIDR "
        f"identities selected by the corpus's toFQDNs selectors; ipcache "
        f"{len(ipc)} prefixes")
    return {"queries": DNS_QUERIES, "clients": DNS_CLIENTS,
            "tcp_clients": DNS_TCP_CLIENTS,
            "unknown_clients": DNS_UNKNOWN_CLIENTS,
            "forwarded": len(forwarded), "refused": refused, "wall_s": wall,
            "p50_ms": q["p50_ms"], "p99_ms": q["p99_ms"],
            "selected_identities": len(selected), "ipcache": len(ipc),
            "host_only": True}


def baseline_phase(card):
    """Phase 12: the three BASELINE configs, the DNS proxy and its
    server (see the module docstring). Returns (report, launches by
    pass, KD variants by pass, what the kernel holds need)."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_baseline_")
    env0 = os.environ.get("CILIUM_TPU_DFA_IMPL", "gather")
    report = {"card": card, "lanes": {}}
    launches, variants, held = {}, {}, {"lanes": {}}
    try:
        # bench.py's arm: the default, gather
        os.environ["CILIUM_TPU_DFA_IMPL"] = "gather"
        for name, n_rules, n_flows in BASELINE_LANES:
            line, ln, vr, kept = baseline_lane(
                name, n_rules, n_flows, os.path.join(tmp.name, name), card)
            report["lanes"][name] = line
            launches.update(ln)
            variants.update(vr)
            held["lanes"][name] = kept
        fqdn = held["lanes"]["fqdn"]["scenario"]
        report["dnsproxy"], ln, vr, held["dnsproxy"] = dns_proxy_phase(fqdn,
                                                                       card)
        launches.update(ln)
        variants.update(vr)
        report["dns_server"] = dns_server_phase(fqdn, card)
    finally:
        os.environ["CILIUM_TPU_DFA_IMPL"] = env0
        tmp.cleanup()
    report["wall_s"] = time.perf_counter() - t_phase
    return report, launches, variants, held


def hold_stack(errs, label, arr, prefix, data, lens, nfa_arr=None):
    """KD exactly against its plain version at one field stack and
    batch (the group plane too on ``path``); K2 where the banks have at
    most 128 states; K1 where ``nfa_arr`` carries the field's NFA.
    Returns the kernels that took the stack."""
    from cilium_tpu_torch.engine import (
        dfa_dense_cuda,
        dfa_oblivious_cuda,
        nfa_cuda,
    )

    a = (arr[f"{prefix}_trans"], arr[f"{prefix}_byteclass"],
         arr[f"{prefix}_start"], data, lens)
    acc = arr[f"{prefix}_accept"]
    extra = arr.get("rp_path_gaccept") if prefix == "path" else None
    NB, S, K = a[0].shape
    shape = f"{(NB, S, K)} B={data.shape[0]} L={data.shape[1]}"
    hold(errs, "KD", f"{label} {shape}",
         dfa_dense_cuda.dense_scan_cuda(*a, accept=acc, extra=extra),
         dfa_dense_cuda.dense_scan_plain(*a, accept=acc, extra=extra))
    takes = ["KD"]
    if S <= 128:
        hold(errs, "K2", f"{label} {shape}",
             dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*a),
             dfa_oblivious_cuda.dfa_finals_oblivious_plain(*a))
        takes.append("K2")
    if nfa_arr is not None and f"{prefix}_nfa_follow" in nfa_arr:
        n = [nfa_arr[f"{prefix}_nfa_{k}"] for k in
             ("follow", "acc_cls", "byteclass", "start")] + [data, lens]
        hold(errs, "K1", f"{label} {tuple(n[1].shape)} B={data.shape[0]} "
                         f"L={data.shape[1]}",
             nfa_cuda.nfa_finals_cuda(*n), nfa_cuda.nfa_finals_plain(*n))
        takes.append("K1")
    return takes


def baseline_kernels(errs, rows, held, card):
    """KD, and K2 and K1 wherever they take it, held exactly against
    their plain versions at every scanned field of each lane's policy
    on the lane's first held batch (its L per field), at the fqdn
    policy's ``dns`` stack under the DNS proxy's batch (L = 256) and at
    the proxy's own stack; then timed through phase 4's code. Returns
    the stacks and the rows of each kernel."""
    import dataclasses

    import numpy as np
    import torch

    from cilium_tpu_torch.engine.megakernel import scan_fields
    from cilium_tpu_torch.engine.verdict import (
        TorchVerdictEngine,
        batch_field,
        unpack_batch,
    )
    from cilium_tpu_torch.fqdn.dnsproxy import QNAME_LEN
    from cilium_tpu_torch.policy.compiler import matchpattern

    out = {}
    for name, lane in held["lanes"].items():
        engine = lane["engine"]
        nfa = TorchVerdictEngine(engine.policy, device=DEVICE,
                                 cfg=dataclasses.replace(
                                     engine.cfg, kernel_impl="nfa-bitset"))
        b = unpack_batch(lane["batch"])
        dense, nfa_fields, taken = {}, {}, {}
        for prefix, field in scan_fields(engine._arrays):
            data, lens, _ = batch_field(b, field)
            data, lens = data.contiguous(), lens.contiguous()
            taken[prefix] = hold_stack(errs, f"baseline {name} {prefix}",
                                       engine._arrays, prefix, data, lens,
                                       nfa._arrays)
            dense[prefix] = (engine._arrays, data, lens)
            nfa_fields[prefix] = (nfa._arrays, data, lens)
        got = kernel_times(dense, nfa_fields, {}, {}, card,
                           tag=f"baseline-{name}-")
        for kid, rs in got.items():
            rows[kid].extend(rs)
        out[name] = {"taken_by": taken,
                     "rows": {kid: [list(r) for r in rs]
                              for kid, rs in got.items() if rs}}
    # the DNS proxy's batch: the fqdn qnames at L = 256, on the fqdn
    # policy's dns stack and on the proxies' own stacks
    qnames = [f.dns.query for f in held["lanes"]["fqdn"]["scenario"].flows]
    data = np.zeros((min(len(qnames), DNS_BATCHES[0]), QNAME_LEN), np.uint8)
    lens = np.zeros(len(data), np.int32)
    for i, q in enumerate(qnames[:len(data)]):
        bs = matchpattern.sanitize_name(q).encode("utf-8")[:QNAME_LEN]
        data[i, :len(bs)] = np.frombuffer(bs, np.uint8)
        lens[i] = len(bs)
    data = torch.from_numpy(data).to(DEVICE)
    lens = torch.from_numpy(lens).to(DEVICE)
    stacks = {"baseline-fqdn-dns-L256": (
        held["lanes"]["fqdn"]["engine"]._arrays, data, lens)}
    for arm in ("gather", "oblivious-corpus"):
        proxy = held["dnsproxy"][arm]
        key = next(iter(proxy._rules))
        st = proxy._get_banked(key, proxy._rules[key])
        stacks[f"baseline-dnsproxy-{DNS_ARMS[arm][0]}-L256"] = (
            {f"dns_{k}": v for k, v in st.items()}, data, lens)
    out["dns_L256"] = {}
    for label, (arr, d, ln) in stacks.items():
        out["dns_L256"][label] = hold_stack(errs, label, arr, "dns", d, ln)
    got = kernel_times({}, {}, {label: ("dns", *v)
                                for label, v in stacks.items()}, {}, card)
    for kid, rs in got.items():
        rows[kid].extend(rs)
    out["dns_L256"]["rows"] = {kid: [list(r) for r in rs]
                               for kid, rs in got.items() if rs}
    return out


# ------------------------------------------------------------- phase 13
def lb_services():
    """Phase 13's service world, from a seed: LB_SERVICES frontends of
    LB_BACKENDS backends each. A quarter of the services have ClientIP
    affinity; a quarter of the VIPs are LoadBalancer addresses above
    2**31 (192.168.x.y and 203.0.113.x), the rest ClusterIPs in
    10.96.0.0/12; backends in 10.0.0.0/8 with weights 1-3."""
    import random

    from cilium_tpu_torch.loadbalancer import (
        Backend,
        Frontend,
        Service,
        ServiceType,
    )

    rng = random.Random(13)
    out = []
    for i in range(LB_SERVICES):
        if i % 8 == 0:
            vip, kind = f"192.168.{i >> 8}.{i & 255}", \
                ServiceType.LOAD_BALANCER
        elif i % 8 == 4:
            vip, kind = f"203.0.113.{i >> 3 & 255}", \
                ServiceType.LOAD_BALANCER
        else:
            vip, kind = f"10.{96 + (i >> 8)}.{i & 255}.1", \
                ServiceType.CLUSTER_IP
        fe = Frontend(vip, (80, 443, 8080, 53)[i % 4],
                      17 if i % 4 == 3 else 6)
        out.append(Service(
            fe, [Backend(f"10.{i >> 6}.{(i & 63) * 4 + j // 4}."
                         f"{(j % 4) * 60 + 1}", 8000 + j,
                         weight=1 + rng.randrange(3))
                 for j in range(LB_BACKENDS)],
            svc_type=kind, affinity=i % 4 == 1, name=f"svc{i}"))
    return out


def lb_flow_columns(services, n, seed=14):
    """``n`` flows as the five columns ``lb_lookup`` takes (addresses as
    int64 holding the unsigned value): 80 % to live frontends, the rest
    to random addresses and ports."""
    import ipaddress

    import numpy as np

    rng = np.random.default_rng(seed)
    fes = [s.frontend for s in services]
    vip = np.array([int(ipaddress.IPv4Address(f.ip)) for f in fes],
                   np.int64)
    port = np.array([f.port for f in fes], np.int32)
    proto = np.array([f.proto for f in fes], np.int32)
    pick = rng.integers(0, len(fes), n)
    live = rng.random(n) < 0.8
    return (rng.integers(0, 2 ** 32, n, dtype=np.int64),
            rng.integers(1024, 65536, n).astype(np.int32),
            np.where(live, vip[pick], rng.integers(0, 2 ** 32, n,
                                                   dtype=np.int64)),
            np.where(live, port[pick],
                     rng.integers(1, 65536, n)).astype(np.int32),
            np.where(live, proto[pick],
                     rng.choice([6, 17], n)).astype(np.int32))


def lb_world():
    """Build phase 13's ``ServiceManager`` (one Maglev table of
    DEFAULT_TABLE_SIZE slots a service, ~0.1 s each on one core), pack
    it and answer ``select()`` for the first LB_SAMPLE flows. Runs in a
    worker process during phases 3-7; returns what pickles (the packed
    arrays, the flow columns, the answers as (ip, port) or None) — a
    ``ServiceManager`` holds a lock and does not."""
    import ipaddress

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cilium_tpu_torch.loadbalancer import ServiceManager

    t0 = time.perf_counter()
    services = lb_services()
    mgr = ServiceManager()
    for svc in services:
        mgr.upsert(svc)
    packed = mgr.pack()
    build_s = time.perf_counter() - t0
    cols = lb_flow_columns(services, REPLAY_CHUNK)
    answers = []
    for i in range(LB_SAMPLE):
        b = mgr.select(str(ipaddress.IPv4Address(int(cols[0][i]))),
                       int(cols[1][i]),
                       str(ipaddress.IPv4Address(int(cols[2][i]))),
                       int(cols[3][i]), int(cols[4][i]))
        answers.append(None if b is None else
                       (int(ipaddress.IPv4Address(b.ip)), b.port))
    return packed, cols, answers, build_s


def force_leaf(out) -> None:
    """Forced completion by a 2-element readback of the first tensor in
    ``out`` (a tensor, or dicts and tuples of them)."""
    while isinstance(out, dict):
        out = out[sorted(out)[0]]
    while isinstance(out, (tuple, list)):
        out = out[0]
    (out[:2] if out.ndim else out).cpu()


def forced_ms(fn, reps: int) -> float:
    """Median host ms of ``reps`` completion-forced calls, after one."""
    force_leaf(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        force_leaf(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def traced(fn, reps: int = 1, tries: int = 6):
    """(device kernels, device ms) of one forced call of ``fn``, averaged
    over ``reps``: torch.profiler with one warm-up step before the
    recorded ones, so the trace starts with the tracer running (a trace
    begun cold can miss the first kernels of its window). A trace with
    no device events is retried up to ``tries`` times (each logged);
    then (None, None)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for i in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=reps,
                                       repeat=1)) as prof:
            for _ in range(1 + reps):
                force_leaf(fn())
                prof.step()
        kern = [(e.count, getattr(e, "self_device_time_total", 0.0) / 1e3)
                for e in prof.key_averages()
                if "CUDA" in str(getattr(e, "device_type", ""))
                and not e.key.startswith("ProfilerStep")]
        if kern:
            return (sum(c for c, _ in kern) / reps,
                    sum(ms for _, ms in kern) / reps)
        log(f"  (trace {i + 1} of {tries} saw no device events)")
    return None, None


def reset_counts() -> None:
    from cilium_tpu_torch.engine import _build

    _build.reset_launches()


def counts():
    from cilium_tpu_torch.engine import _build

    return {k: v.launches for k, v in _build.KERNELS.items()}


def sp_shape(label, trans, byteclass, start, data, lengths, card):
    """One shape of phase 13a: SP held exactly against KD (and K2 at
    S <= 128) and, on SP_SAMPLE rows, the plain per-byte ``dfa_scan``;
    then SP's and KD's medians of SP_ITERS forced calls, SP's device
    kernels and ms a call and its peak memory."""
    import torch

    from cilium_tpu_torch.engine.dfa_kernel import (
        dfa_finals_banked,
        dfa_scan,
    )
    from cilium_tpu_torch.engine.longscan import payload_scan_sp

    t, bc, d, ln = (torch.from_numpy(a).to(DEVICE)
                    for a in (trans, byteclass, data, lengths))
    st = torch.full((1,), start, dtype=torch.int32, device=DEVICE)
    S, L = trans.shape[0], data.shape[1]

    def sp():
        return payload_scan_sp(t, bc, start, d, ln, block=SP_BLOCK)

    def kd():
        return dfa_finals_banked(t[None], bc[None], st, d, ln,
                                 impl="gather")[0]

    def k2():
        return dfa_finals_banked(t[None], bc[None], st, d, ln,
                                 impl="oblivious")[0]

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = sp()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(torch.equal(got, kd()), f"[sp {label}] SP differs from KD")
    held = ["KD"]
    if S <= 128:
        check(torch.equal(got, k2()), f"[sp {label}] SP differs from K2")
        held.append("K2")
    n = min(SP_SAMPLE, len(data))
    check(torch.equal(got[:n], dfa_scan(t, bc, st[0], d[:n], ln[:n])),
          f"[sp {label}] SP differs from the plain dfa_scan on {n} rows")
    sp_ms, kd_ms = forced_ms(sp, SP_ITERS), forced_ms(kd, SP_ITERS)
    k2_ms = forced_ms(k2, SP_ITERS) if S <= 128 else None
    kernels, dev_ms = traced(sp)
    row = {"shape": [int(len(data)), S, int(trans.shape[1]), L],
           "sp_ms": sp_ms, "kd_ms": kd_ms, "k2_ms": k2_ms,
           "sp_vs_seq": kd_ms / sp_ms, "sp_device_kernels": kernels,
           "sp_device_ms": dev_ms, "peak_mb": peak / 2 ** 20,
           "sp_extra_mb": (peak - base) / 2 ** 20, "held_against": held}
    log(f"[sp {label}] (B, S, K, L) {tuple(row['shape'])}, block "
        f"{SP_BLOCK}: SP equal to {held} and to dfa_scan on {n} rows; SP "
        f"{sp_ms:.3f} ms, KD {kd_ms:.4f} ms"
        + (f", K2 {k2_ms:.4f} ms" if k2_ms is not None else "")
        + f" (medians of {SP_ITERS} forced calls); sp_vs_seq "
        f"{row['sp_vs_seq']:.5f}; SP {kernels} device kernels, {dev_ms} "
        f"device ms a call; peak {row['peak_mb']:.1f} MiB allocated "
        f"({row['sp_extra_mb']:.1f} MiB above the call's start) on {card}")
    return row


def path_payload(flows, B, L):
    """A [B, L] payload batch over the scenario's paths: each row a
    flow's path then random printable bytes, lengths in [L/2, L] (the
    first 64 rows the path's own length)."""
    import numpy as np

    rng = np.random.default_rng(1)
    data = rng.integers(32, 127, size=(B, L)).astype(np.uint8)
    for i in range(B):
        f = flows[i % len(flows)]
        p = (f.http.path if f.http is not None else "").encode()[:L]
        data[i, :len(p)] = np.frombuffer(p, np.uint8)
    lengths = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    lengths[:64] = [len(flows[i].http.path) if flows[i].http is not None
                    else 0 for i in range(64)]
    return data, lengths


def sp_phase(loader_engine, flows, card):
    """Phase 13a: ``payload_scan_sp`` at ``bench_sp.py``'s grid (its
    seeded tables, classes, bytes and lengths, drawn in its order), then
    on bank 0 of the http-1000 loader path stack at the header bucket
    (B = SP_BANK_B, L = SP_BANK_L) over the scenario's paths."""
    import numpy as np

    reset_counts()
    rng = np.random.default_rng(0)
    rows = {}
    B, K = SP_FLOWS, SP_K
    for S in SP_STATES:
        for L in SP_LENGTHS:
            trans = rng.integers(0, S, size=(S, K), dtype=np.int32)
            byteclass = rng.integers(0, K, size=256, dtype=np.int32)
            data = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
            lengths = rng.integers(L // 2, L + 1, size=B, dtype=np.int32)
            rows[f"S{S}-L{L}"] = sp_shape(f"S{S} L{L}", trans, byteclass,
                                          0, data, lengths, card)
    arrays = loader_engine._arrays
    trans, byteclass, start = (arrays[f"path_{k}"][0].cpu().numpy()
                               for k in ("trans", "byteclass", "start"))
    data, lengths = path_payload(flows, SP_BANK_B, SP_BANK_L)
    rows["http1000-path-bank0"] = sp_shape(
        "http-1000 path bank 0", trans, byteclass, int(start), data,
        lengths, card)
    launches = counts()
    check(launches["KD"] > 0 and launches["K2"] > 0,
          f"[sp] KD and K2 must have launched: {launches}")
    return rows, launches


def lb_needed_bytes(arrays, flows, out) -> int:
    """Bytes ``lb_lookup`` must move for this run: the flow columns and
    the three outputs once, the service keys and affinity once, the slab
    entries the matched flows read (distinct service and slot) and the
    backend rows their backends read (distinct ids)."""
    import torch

    from cilium_tpu_torch.loadbalancer import kernel as lbk

    svc_ip, svc_l4, svc_aff, tables, b_ip, b_port = arrays
    src, sport, dst, dport, proto = flows
    p0, dp, pr = lbk._u32(dst), lbk._u32(dport), lbk._u32(proto)
    idx, found = lbk._lower_bound2(svc_ip, svc_l4, p0,
                                   ((pr << 16) & 0xFFFFFFFF) | dp)
    s = lbk._u32(src)
    z = torch.zeros_like(s)
    h = torch.where(svc_aff[idx], lbk._fnv1a_words([s, z, z, z, z]),
                    lbk._fnv1a_words([s, lbk._u32(sport), p0, dp, pr]))
    entries = torch.unique((idx * tables.shape[1] + h % tables.shape[1])
                           [found]).numel()
    backends = torch.unique(out["backend"][out["backend"] >= 0]).numel()
    return (nbytes(*flows, *out.values(), svc_ip, svc_l4, svc_aff)
            + entries * tables.element_size()
            + backends * (b_ip.element_size() + b_port.element_size()))


def lb_phase(lb_job, card):
    """Phase 13b: ``lb_lookup`` over the LB_SERVICES x DEFAULT_TABLE_SIZE
    slab on the card, held exactly against its ``device="cpu"`` run on
    every flow and against ``select()`` on the worker's sample; the
    empty manager's pack misses on the card; median of LB_TIMED forced
    calls, a traced call and the byte bound."""
    import torch

    from cilium_tpu_torch.loadbalancer import ServiceManager, lb_lookup
    from cilium_tpu_torch.weights import lb_arrays_from_reference

    t0 = time.perf_counter()
    packed, cols, answers, build_s = lb_job.result()
    wait_s = time.perf_counter() - t0
    arrays = lb_arrays_from_reference(packed, DEVICE)
    flows = [torch.from_numpy(c).to(DEVICE) for c in cols]
    reset_counts()
    out = lb_lookup(*arrays, *flows)
    torch.cuda.synchronize()
    launches = counts()
    plain = lb_lookup(*lb_arrays_from_reference(packed, "cpu"),
                      *(torch.from_numpy(c) for c in cols))
    for k in ("backend", "ip", "port"):
        check(torch.equal(out[k].cpu(), plain[k]),
              f"[lb] {k} differs from the device=cpu run in "
              f"{int((out[k].cpu() != plain[k]).sum())} of {len(cols[0])}")
    got_b, got_ip, got_port = (out[k][:LB_SAMPLE].cpu().tolist()
                               for k in ("backend", "ip", "port"))
    for i, want in enumerate(answers):
        check((got_b[i] < 0) if want is None
              else (got_ip[i], got_port[i]) == want,
              f"[lb] flow {i}: lb_lookup ({got_b[i]}, {got_ip[i]}, "
              f"{got_port[i]}) against select() {want}")
    empty = lb_lookup(*lb_arrays_from_reference(
        ServiceManager().pack(), DEVICE), *flows)
    check(bool((empty["backend"] == -1).all()) and not
          bool(empty["ip"].any()), "[lb] the empty manager's pack must miss")
    matched = int((plain["backend"] >= 0).sum())
    high = int(((cols[2] >= 2 ** 31) & (plain["backend"] >= 0).numpy())
               .sum())

    def call():
        return lb_lookup(*arrays, *flows)

    ms = forced_ms(call, LB_TIMED)
    kernels, dev_ms = traced(call, reps=3)
    n_bytes = lb_needed_bytes(arrays, flows, out)
    b_ms, _ = bound(n_bytes, 0)
    row = {"services": int(packed.n_services), "table_size":
           int(packed.tables.shape[1]), "slab_mb": packed.tables.nbytes / 1e6,
           "backends": int(len(packed.backend_ip)), "flows": len(cols[0]),
           "matched": matched, "matched_vip_above_2_31": high,
           "sample": len(answers), "build_s": build_s, "wait_s": wait_s,
           "ms": ms, "device_kernels": kernels, "device_ms": dev_ms,
           "bound_ms": b_ms, "bound_bytes": n_bytes, "launches": launches}
    log(f"[lb] {row['services']} services x {row['table_size']} slots "
        f"({row['slab_mb']:.1f} MB slab, {row['backends']} backends; built "
        f"in {build_s:.1f} s in a worker, waited {wait_s:.1f} s): "
        f"{len(cols[0])} flows, {matched} matched ({high} to VIPs above "
        f"2**31), backend/ip/port equal to the device=cpu run, "
        f"{len(answers)} equal to select(), the empty pack misses; median "
        f"{ms:.4f} ms of {LB_TIMED} forced calls, traced {kernels} device "
        f"kernels, {dev_ms} device ms; bound {b_ms:.6f} ms ({n_bytes} "
        f"bytes) on {card}")
    return row


def engine_probe(label, engine, flows, card):
    """Phase 13c, the live path: ``EnginePhaseProbe.measure_flows`` on
    ``flows`` (launch counts zeroed before, read after); the sub-steps'
    ten lanes held against the fused step on the card; coverage >= 0.9
    and one fused dispatch; each sub-step's device kernels and ms from
    one traced call."""
    from cilium_tpu_torch.engine import phases
    from cilium_tpu_torch.engine.compiled import (
        encode_flows,
        flowbatch_to_host_dict,
    )
    from cilium_tpu_torch.engine.verdict import batch_to_device

    reset_counts()
    report = phases.EnginePhaseProbe(engine).measure_flows(
        flows, engine.cfg, reps=PROBE_REPS)
    launches, variants = counts(), kd_variants()
    arrays = engine._arrays
    host = flowbatch_to_host_dict(encode_flows(
        flows, engine.policy.kafka_interns, engine.cfg))
    batch = batch_to_device(host, DEVICE)
    ms = phases._live_mapstate(arrays, batch)
    words = phases._live_scan(arrays, batch)
    assert_lanes(f"[probe {label}] sub-steps",
                 {k: v.cpu().numpy() for k, v in phases._live_resolve(
                     arrays, ms, words, batch).items()},
                 {k: v.cpu().numpy() for k, v in engine._step(
                     arrays, batch).items()})
    # the decomposition's scan lane is the dense arm's (KD), as in the
    # reference: it covers the step's scans only where the plan is dense
    dense = set(engine.impl_plan.values()) == {"dfa-dense"}
    check(report["fused_dispatches"] == 1 and
          (report["coverage"] >= 0.9 or not dense),
          f"[probe {label}] coverage {report['coverage']} (>= 0.9) and "
          f"fused dispatches {report['fused_dispatches']} (1); phases "
          f"{report['phases_ms']} ms")
    plan = tuple(sorted(engine.impl_plan.items()))
    steps = {"h2d": lambda: batch_to_device(host, DEVICE),
             "mapstate": lambda: phases._live_mapstate(arrays, batch),
             "dfa-scan": lambda: phases._live_scan(arrays, batch),
             "resolve": lambda: phases._live_resolve(arrays, ms, words,
                                                     batch),
             "fused-verdict": lambda: engine._step(arrays, batch)}
    for impl in sorted(set(engine.impl_plan.values())):
        steps[impl] = (lambda i=impl: phases._impl_scan(
            arrays, batch, plan, i, engine._dfa_impl, True))
    report["device"] = {}
    for name, fn in steps.items():
        kernels, dev_ms = traced(fn)
        report["device"][name] = {"kernels": kernels, "ms": dev_ms}
    report["launches"], report["kd_variants"] = launches, variants
    log(f"[probe {label}] B = {report['batch']}: "
        + ", ".join(f"{p} {v} ms (device {report['device'].get(p, {}).get('ms')}"
                    f" ms, {report['device'].get(p, {}).get('kernels')} "
                    f"kernels)" for p, v in report["phases_ms"].items())
        + f"; wall {report['wall_ms']} ms, coverage {report['coverage']}, "
        f"three-op {report['three_op_ms']} ms, compile {report['compile_ms']}"
        f" ms (the first call: CUDA's lazy start-up and first builds); "
        f"launches {launches}; sub-steps' 10 lanes equal to the fused step "
        f"on {card}")
    return report


def capture_probe(stream, engine, cap, cfg, card):
    """Phase 13c, the capture path: ``CapturePhaseProbe`` on phase 5's
    capture, one chunk of REPLAY_CHUNK, on the ``id`` or ``row`` stream;
    the sub-steps' lanes held against ``verdict_step_capture``; each
    sub-step's device kernels and ms from one traced call."""
    import torch

    from cilium_tpu_torch.engine import phases
    from cilium_tpu_torch.engine.replay import CaptureReplay, _ids_to_device
    from cilium_tpu_torch.engine.verdict import verdict_step_capture

    rec, l7, offsets, blob = cap["sections"]
    reset_counts()
    replay = CaptureReplay(engine, l7, offsets, blob, cfg)
    replay.stage_rows(rec, l7)
    replay.stage_unique(None if stream == "id" else 0.0)
    check((replay.row_idx is not None) == (stream == "id"),
          f"[probe capture {stream}] stream set-up")
    report = phases.CapturePhaseProbe(replay).measure(
        0, REPLAY_CHUNK, reps=PROBE_REPS)
    launches, variants = counts(), kd_variants()
    check(report["coverage"] >= 0.9,
          f"[probe capture {stream}] coverage {report['coverage']} (>= 0.9)")
    n = REPLAY_CHUNK
    if stream == "id":
        batch = {"rows": replay.stage_unique_device(),
                 "idx": _ids_to_device(replay.row_idx[:n], engine.device)}
    else:
        batch = {"rows": torch.from_numpy(replay.rows_all[:n]).to(DEVICE)}
    arrays, tw = engine._arrays, replay.table_words
    rows, words = phases._cap_gather(tw, batch)
    ms = phases._cap_mapstate(arrays, batch)
    assert_lanes(f"[probe capture {stream}] sub-steps",
                 {k: v.cpu().numpy() for k, v in phases._cap_resolve(
                     arrays, ms, rows, words, batch).items()},
                 {k: v.cpu().numpy() for k, v in verdict_step_capture(
                     arrays, tw, batch).items()})
    steps = {"gather": lambda: phases._cap_gather(tw, batch),
             "mapstate": lambda: phases._cap_mapstate(arrays, batch),
             "resolve": lambda: phases._cap_resolve(arrays, ms, rows, words,
                                                    batch),
             "step": lambda: verdict_step_capture(arrays, tw, batch)}
    report["device"] = {}
    for name, fn in steps.items():
        kernels, dev_ms = traced(fn)
        report["device"][name] = {"kernels": kernels, "ms": dev_ms}
    report["launches"], report["kd_variants"] = launches, variants
    log(f"[probe capture {stream}] chunk {n}: "
        + ", ".join(f"{p} {v} ms" for p, v in report["phases_ms"].items())
        + f"; wall {report['wall_ms']} ms, step {report['step_ms']} ms, "
        f"coverage {report['coverage']}; device "
        f"{ {k: (v['kernels'], v['ms']) for k, v in report['device'].items()} }"
        f" (kernels, ms); launches {launches}; sub-steps' 10 lanes equal to "
        f"verdict_step_capture on {card}")
    return report


def probe_phase(loader_engine, capture_engine, caps, flows, cfg, card):
    """Phase 13c: the engine probe on the loader's http-1000 engine under
    ``auto`` and ``nfa-bitset`` at PROBE_BATCHES, the capture probe on
    the id and row streams; both metric families must have received
    observations."""
    import dataclasses

    from cilium_tpu_torch.engine.phases import CAPTURE_PHASES
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
    from cilium_tpu_torch.runtime.metrics import (
        ENGINE_HOST_SYNCS,
        ENGINE_PHASE_SECONDS,
        METRICS,
    )

    labels = ("featurize", "h2d", "mapstate", "dfa-scan", "resolve",
              "fused-verdict", "compile", "execute") + CAPTURE_PHASES
    marks = {p: METRICS.histo_count(ENGINE_PHASE_SECONDS, {"phase": p})
             for p in labels}
    syncs = METRICS.get(ENGINE_HOST_SYNCS, {"site": "engine-mapstate"})
    engines = {"auto": loader_engine, "nfa-bitset": TorchVerdictEngine(
        loader_engine.policy, device=DEVICE, cfg=dataclasses.replace(
            loader_engine.cfg, kernel_impl="nfa-bitset"))}
    check("nfa-bitset" in engines["nfa-bitset"].impl_plan.values(),
          f"[probe] the nfa-bitset engine's plan "
          f"{engines['nfa-bitset'].impl_plan} runs no field on K1")
    out, launches, variants = {}, {}, {}
    for arm, engine in engines.items():
        for b in PROBE_BATCHES:
            label = f"{arm} B{b}"
            out[label] = engine_probe(label, engine, flows[:b], card)
            launches[f"probe-{arm}-b{b}"] = out[label].pop("launches")
            variants[f"probe-{arm}-b{b}"] = out[label].pop("kd_variants")
        kid = "K1" if arm == "nfa-bitset" else "KD"
        check(all(launches[f"probe-{arm}-b{b}"][kid] > 0
                  for b in PROBE_BATCHES),
              f"[probe {arm}] {kid} never launched")
    for stream in ("id", "row"):
        rep = capture_probe(stream, capture_engine, caps["low"], cfg, card)
        out[f"capture-{stream}"] = rep
        launches[f"probe-capture-{stream}"] = rep.pop("launches")
        variants[f"probe-capture-{stream}"] = rep.pop("kd_variants")
    grew = {p: METRICS.histo_count(ENGINE_PHASE_SECONDS, {"phase": p})
            - marks[p] for p in labels}
    check(all(v > 0 for v in grew.values()) and
          METRICS.get(ENGINE_HOST_SYNCS, {"site": "engine-mapstate"})
          > syncs, f"[probe] the metric families must have received "
                   f"observations: {grew}")
    log(f"[probe] {ENGINE_PHASE_SECONDS} observations by phase {grew}; "
        f"{ENGINE_HOST_SYNCS} rose")
    return out, launches, variants


def lb_sp_probe_phase(lb_job, loader_engine, capture_engine, caps, flows,
                      cfg, card):
    """Phase 13 (see the module docstring) → (report, launches by pass,
    KD variants by pass)."""
    t0 = time.perf_counter()
    report, launches = {}, {}
    report["sp"], launches["sp"] = sp_phase(loader_engine, flows, card)
    variants = {"sp": kd_variants()}
    report["lb"] = lb_phase(lb_job, card)
    launches["lb"] = report["lb"].pop("launches")
    report["probe"], probe_launches, probe_variants = probe_phase(
        loader_engine, capture_engine, caps, flows, cfg, card)
    launches.update(probe_launches)
    variants.update(probe_variants)
    report["wall_s"] = time.perf_counter() - t0
    report["card"] = card
    return report, launches, variants


# ------------------------------------------------------------- phase 14
#: phase 14: the parallel layer at the main path's width — phase 8's
#: loader-built http-1000 policy (path stack (7, 2048, 28)), one batch
#: of PAR_B flows — in a one-rank NCCL world in this process, then in
#: worlds of PAR_WORLDS spawned ranks sharing the card (gloo, payloads
#: staged through pinned host memory); PAR_REPS timed calls a lane (2,
#: cut from 3 to make room for phase 17);
#: payload_scan_cp on the path bank at PAR_PATH_L and on
#: tests/test_longscan.py's PATTERNS bank at PAR_PATTERNS_L; the
#: pipelined batches
PAR_B, PAR_WORLDS, PAR_REPS, PAR_TIMEOUT_S = 8192, (2, 4), 2, 300.0
PAR_PATH_L, PAR_PATTERNS_L = 1024, 2048
PAR_PIPE_BATCHES, PAR_PIPE_DEPTH, PAR_PIPE_ROUNDS = 8, 2, 10
LONG_PATTERNS = [".*attack-signature.*", ".*(GET|POST) /evil.*",
                 ".*xx[0-9]{3}yy.*"]
#: lane → its inputs in par_inputs (the payload lane runs once a bank)
PAR_LANES = {"dp": "verdict", "ep": "verdict", "cp": "verdict",
             "ulysses": "scan", "tp_banked": "scan", "cp_scan": "scan",
             "payload_cp": ("path", "patterns")}


def par_inputs(loader_engine, flows):
    """Phase 14's host inputs (numpy, as every rank gets them): the
    verdict lanes' policy arrays and packed batch; the path stack for
    the raw scans, padded with inert zero banks to a multiple of 4
    (Ulysses shards banks); payload_scan_cp's two banks."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine.compiled import (
        encode_flows,
        flowbatch_to_host_dict,
    )
    from cilium_tpu_torch.engine.verdict import unpack_batch
    from cilium_tpu_torch.policy.compiler.dfa import compile_patterns

    pol = loader_engine.policy
    host = flowbatch_to_host_dict(encode_flows(
        flows[:PAR_B], pol.kafka_interns, loader_engine.cfg))
    path = {k: pol.arrays[f"path_{k}"]
            for k in ("trans", "byteclass", "start", "accept")}
    pad = (-len(path["trans"])) % max(PAR_WORLDS)
    scan = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
            for k, v in path.items()}
    scan["data"] = host["path_data"]
    scan["lengths"] = unpack_batch({k: torch.from_numpy(v) for k, v in
                                    host.items()})["path_len"].numpy().copy()
    data, lengths = path_payload(flows, PAR_B, PAR_PATH_L)
    bank = compile_patterns(LONG_PATTERNS, bank_size=8).banks[0]
    rng = np.random.default_rng(0)
    L = PAR_PATTERNS_L
    ldata = rng.integers(97, 123, size=(PAR_B, L), dtype=np.uint8)
    for i, sig in enumerate((b"attack-signature", b"POST /evil!",
                             b"xx123yy")):
        for row in range(i, PAR_B, 97):
            at = int(rng.integers(0, L - len(sig)))
            ldata[row, at:at + len(sig)] = np.frombuffer(sig, np.uint8)
    llens = rng.integers(L // 2, L + 1, size=PAR_B).astype(np.int32)
    return {"verdict": {"arrays": dict(pol.arrays), "batch": host},
            "scan": scan,
            "path": {"trans": path["trans"][0],
                     "byteclass": path["byteclass"][0],
                     "start": int(path["start"][0]), "data": data,
                     "lengths": lengths},
            "patterns": {"trans": np.asarray(bank.trans, np.int32),
                         "byteclass": np.asarray(bank.byteclass, np.int32),
                         "start": int(bank.start), "data": ldata,
                         "lengths": llens}}


def par_wants(loader_engine, inputs):
    """The single-device results each lane is held against, on the
    card: the fused step on the loader's engine, KD over the padded path
    stack (the zero banks' words must be 0 and the rest KD's over the
    stack as built), ``payload_scan_sp`` on each payload bank."""
    import torch

    from cilium_tpu_torch.core.config import ParallelConfig
    from cilium_tpu_torch.engine.dfa_kernel import dfa_scan_banked
    from cilium_tpu_torch.engine.longscan import payload_scan_sp
    from cilium_tpu_torch.engine.verdict import batch_to_device
    from cilium_tpu_torch.weights import arrays_from_reference

    wants = {"verdict": {k: v.cpu().numpy() for k, v in
                         loader_engine.verdict_batch_arrays(batch_to_device(
                             inputs["verdict"]["batch"], DEVICE)).items()}}
    t = arrays_from_reference(inputs["scan"], DEVICE)
    words = dfa_scan_banked(t["trans"], t["byteclass"], t["start"],
                            t["accept"], t["data"], t["lengths"])
    nb = len(loader_engine.policy.arrays["path_trans"])
    real = dfa_scan_banked(*(t[k][:nb] for k in
                             ("trans", "byteclass", "start", "accept")),
                           t["data"], t["lengths"])
    check(bool(torch.equal(words[:, :nb], real))
          and not bool(words[:, nb:].any()),
          "[par] the zero banks padding the path stack are not inert")
    wants["scan"] = words.cpu().numpy()
    for name in ("path", "patterns"):
        g = arrays_from_reference({k: v for k, v in inputs[name].items()
                                   if k != "start"}, DEVICE)
        wants[name] = payload_scan_sp(
            g["trans"], g["byteclass"], inputs[name]["start"], g["data"],
            g["lengths"], block=ParallelConfig().cp_block).cpu().numpy()
    return wants


def par_budget(lane, n, inputs):
    """The reference's collective budget of one call of ``lane`` over n
    ranks: {site: count}."""
    from cilium_tpu_torch.engine.megakernel import SCAN_FIELDS
    from cilium_tpu_torch.parallel.cp import MIN_SHARD_COLS

    if lane == "dp":
        return {}
    if lane == "ep":
        return {"ulysses.switch": 1}
    if lane == "cp":
        batch = inputs["verdict"]["batch"]
        return {f"cp.carry.{p}": 1 for p, f in SCAN_FIELDS
                if batch[f"{f}_data"].shape[1] % n == 0
                and batch[f"{f}_data"].shape[1] // n >= MIN_SHARD_COLS}
    if lane == "ulysses":
        return {"ulysses.gather": 1, "ulysses.switch": 1}
    if lane == "tp_banked":
        return {"tp.scan_step": inputs["scan"]["data"].shape[1],
                "tp.accept_plane": 4}
    if lane == "cp_scan":
        return {"cp.carry_exchange": 1}
    return {"cp.final_gather": 1, **({"cp.ring_carry": n - 1} if n > 1
                                     else {})}


def par_lanes(n, backend, run, inputs, wants, card):
    """Every lane of phase 14 over one world: each held bit-equal to its
    single-device result, each rank's ledger held to the reference's
    budget; the median wall a call (the slowest rank's, each call
    completed), collective bytes, host staging and KD's launches in one
    call. → (report, KD launches in all the ranks' calls)."""
    import numpy as np

    shared = n > 1
    tag = f"[par n={n} {backend}]"
    note = (f" ({n} ranks sharing one card, collectives staged through "
            f"host memory: not a multi-GPU number)" if shared else "")
    report, kd_total = {}, 0
    for lane, which in PAR_LANES.items():
        for name in (which if isinstance(which, tuple) else (which,)):
            label = f"{lane}-{name}" if isinstance(which, tuple) else lane
            res = run(lane, inputs[name])
            got, want = res[0]["out"], wants[name]
            if name == "verdict":
                assert_lanes(f"{tag} {label}", got, want)
            else:
                check(got.shape == want.shape and np.array_equal(got, want),
                      f"{tag} {label} differs from its single-device "
                      f"result in {int((got != want).sum())} entries")
            budget = par_budget(lane, n, inputs)
            for r, rr in enumerate(res):
                seen = {row["site"]: row["count_per_block"]
                        for row in rr["ledger"]}
                check(seen == budget, f"{tag} {label} rank {r} ledger "
                                      f"{seen}, the reference's budget "
                                      f"{budget}")
            if lane == "ep":
                check(all(rr["kd_launches"] > 0 for rr in res),
                      f"{tag} ep: KD never launched on a rank")
            walls = [max(rr["wall_ms"][i] for rr in res)
                     for i in range(PAR_REPS)]
            row = {"median_ms": statistics.median(walls), "walls_ms": walls,
                   "collective_bytes": sum(x["bytes_per_block"]
                                           for x in res[0]["ledger"]),
                   "ledger": res[0]["ledger"],
                   "staging_ms": max(rr["staging"]["seconds"]
                                     for rr in res) * 1e3,
                   "staged_bytes": res[0]["staging"]["bytes"],
                   "kd_launches_one_call": [rr["kd_launches"] for rr in res]}
            kd_total += sum(rr["kd_launches_total"] for rr in res)
            report[label] = row
            log(f"{tag} {label}: equal to the single-device result, ledger "
                f"{budget}; median {row['median_ms']:.3f} ms a call "
                f"(slowest rank, {PAR_REPS} calls), collective bytes "
                f"{row['collective_bytes']}, host staging "
                f"{row['staging_ms']:.3f} ms ({row['staged_bytes']} B), KD "
                f"launches in one call (each rank's count difference "
                f"across it) {row['kd_launches_one_call']} on "
                f"{card}{note}")
    return report, kd_total


def par_one_rank(inputs, wants, card):
    """14a: a one-rank NCCL world in this process."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from cilium_tpu_torch.tools.parallel_lanes import run_lane

    def run(lane, g):
        return [run_lane(lane, g, device=DEVICE, reps=PAR_REPS)]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
        try:
            return par_lanes(1, "nccl", run, inputs, wants, card)
        finally:
            dist.destroy_process_group()


def par_spawned(n, inputs, wants, card):
    """14b: a world of n spawned gloo ranks on the one card."""
    from cilium_tpu_torch.parallel.mesh import LocalWorld
    from cilium_tpu_torch.tools.parallel_lanes import run_lane

    t0 = time.perf_counter()
    with LocalWorld(n, "gloo", PAR_TIMEOUT_S) as world:
        def run(lane, g):
            return world.run(run_lane, lane, g, device=DEVICE,
                             reps=PAR_REPS, timeout_s=PAR_TIMEOUT_S)

        report, kd = par_lanes(n, "gloo", run, inputs, wants, card)
    report["world_wall_s"] = time.perf_counter() - t0
    return report, kd


def pipeline_costs(step, arrays, batches):
    """The pipeline's per-batch pieces, each timed alone over all the
    batches (ms, completed; two passes, in turn): ``pin`` a fresh
    ``pin_memory()`` of every column (the per-batch pinning of the
    first design), ``ring_fill`` the pack of a batch's columns into one
    pinned slot (the ring's), ``events`` an event recorded on a side
    stream and waited on by the current one, ``record_stream`` one call
    a column (the first design's), ``copy_pageable`` a column at a
    time from pageable memory (the sequential loop's),
    ``copy_pinned`` one copy of a packed slot, ``steps`` the step on
    batches already on the card."""
    import numpy as np
    import torch

    from cilium_tpu_torch.parallel.pipeline import _PinnedRing

    dev = torch.device(DEVICE)
    side, compute = torch.cuda.Stream(), torch.cuda.current_stream()
    hosts = [{k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in b.items()} for b in batches]
    ring = _PinnedRing(1)
    slot, _ = ring.fill(0, batches[0])
    on_card = [{k: v.to(dev) for k, v in h.items()} for h in hosts]

    def pin():
        return [[v.pin_memory() for v in h.values()] for h in hosts]

    def ring_fill():
        for b in batches:
            ring.fill(0, b)

    def events():
        for _ in hosts:
            ev = torch.cuda.Event()
            ev.record(side)
            compute.wait_event(ev)

    def record_stream():
        for b in on_card:
            for v in b.values():
                v.record_stream(side)

    def copy_pageable():
        return [{k: v.to(dev) for k, v in h.items()} for h in hosts]

    def copy_pinned():
        return [slot.to(dev, non_blocking=True) for _ in hosts]

    def steps():
        return [step(arrays, b) for b in on_card]

    pieces = {"pin": pin, "ring_fill": ring_fill, "events": events,
              "record_stream": record_stream,
              "copy_pageable": copy_pageable, "copy_pinned": copy_pinned,
              "steps": steps}
    out = {name: [] for name in pieces}
    for _ in range(2):
        for name, fn in pieces.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) * 1e3)
    return out


def par_pipeline(loader_engine, host, card):
    """14c: ``run_pipelined`` over PAR_PIPE_BATCHES host batches (the
    batch's rows permuted) against the sequential loop (each batch
    copied and stepped in turn, read after the loop); PAR_PIPE_ROUNDS
    rounds of (sequential, pipelined, pipelined, sequential); then the
    pipeline's pieces, each timed alone (:func:`pipeline_costs`)."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine.verdict import batch_to_device
    from cilium_tpu_torch.parallel.pipeline import collect, run_pipelined

    rng = np.random.default_rng(14)
    batches = [host] + [{k: v[p] for k, v in host.items()} for p in
                        (rng.permutation(PAR_B)
                         for _ in range(PAR_PIPE_BATCHES - 1))]
    raw_step, arrays = loader_engine._step, loader_engine._arrays
    in_step = [0.0]

    def step(a, b):
        # host ms inside the step calls, apart from the loop's staging
        t0 = time.perf_counter()
        out = raw_step(a, b)
        in_step[0] += time.perf_counter() - t0
        return out

    def sequential():
        return collect([step(arrays, batch_to_device(b, DEVICE))
                        for b in batches])

    def pipelined():
        return collect(run_pipelined(step, arrays, batches, device=DEVICE,
                                     depth=PAR_PIPE_DEPTH))

    walls = {"sequential": [], "pipelined": []}
    steps_ms = {"sequential": [], "pipelined": []}
    outs = {}
    for _ in range(PAR_PIPE_ROUNDS):
        for name, fn in (("sequential", sequential),
                         ("pipelined", pipelined), ("pipelined", pipelined),
                         ("sequential", sequential)):
            torch.cuda.synchronize()
            in_step[0] = 0.0
            t0 = time.perf_counter()
            outs[name] = fn()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            steps_ms[name].append(in_step[0] * 1e3)
    for i, (a, b) in enumerate(zip(outs["pipelined"], outs["sequential"])):
        assert_lanes(f"[par pipeline] batch {i}", a, b)
    med = {k: statistics.median(v) for k, v in walls.items()}
    med_steps = {k: statistics.median(v) for k, v in steps_ms.items()}
    log(f"[par pipeline] {PAR_PIPE_BATCHES} batches of {PAR_B}, depth "
        f"{PAR_PIPE_DEPTH}: equal to the sequential loop; median wall ms "
        f"pipelined {med['pipelined']:.3f}, sequential "
        f"{med['sequential']:.3f}, of which host ms inside the step calls "
        f"{med_steps['pipelined']:.3f} and {med_steps['sequential']:.3f}; "
        f"walls pipelined {walls['pipelined']}, sequential "
        f"{walls['sequential']}; in the steps pipelined "
        f"{steps_ms['pipelined']}, sequential {steps_ms['sequential']} "
        f"({PAR_PIPE_ROUNDS} rounds of sequential, pipelined, pipelined, "
        f"sequential) on {card}")
    costs = pipeline_costs(raw_step, arrays, batches)
    log(f"[par pipeline] pieces alone, ms over all {PAR_PIPE_BATCHES} "
        f"batches (two passes): {costs} on {card}")
    return {"walls_ms": walls, "median_ms": med, "steps_ms": steps_ms,
            "pieces_ms": costs}


def parallel_phase(loader_engine, flows, card):
    """Phase 14 (see the module docstring) → (report, launches, KD
    variants of this process's launches)."""
    t0 = time.perf_counter()
    inputs = par_inputs(loader_engine, flows)
    wants = par_wants(loader_engine, inputs)
    # the counts cover the lanes and the pipeline, not the
    # single-device results above
    reset_counts()
    report = {}
    report["nccl"], _ = par_one_rank(inputs, wants, card)
    report["pipeline"] = par_pipeline(loader_engine,
                                      inputs["verdict"]["batch"], card)
    launches, variants = counts(), kd_variants()
    check(launches["KD"] > 0, f"[par] KD never launched: {launches}")
    for n in PAR_WORLDS:
        # the spawned ranks count their own launches
        report[f"gloo-{n}"], kd = par_spawned(n, inputs, wants, card)
        check(kd > 0, f"[par n={n}] KD never launched in the ranks")
        launches["KD"] += kd
    report["wall_s"] = time.perf_counter() - t0
    report["card"] = card
    return report, launches, variants


# ------------------------------------------------------------- phase 15
#: 15a: seeds 0..DST_SEEDS-1 of ``generate(seed, max_events=12)`` on
#: the card — 12 of the 200-schedule sweep's seeds, cut from the
#: reference's own 25-schedule record (``BENCH_DST_r06.jsonl``, line 2)
#: to make room for phase 17 (each seed ~4.5 s, its multichip worlds'
#: spawns the most of it); the 200-schedule sweep runs apart
DST_SEEDS, DST_MAX_EVENTS = 12, 12
#: 15a/15b: the seeds replayed once more on the CPU (digests equal to
#: the card's) and under ``CILIUM_TPU_DFA_IMPL=pallas`` (traces equal)
DST_RECHECK_SEEDS = 5
#: 15c: the committed regression case (mutation rollback-artifact-key)
#: and the first seed of ``search(25)`` that catches positional-banks in
#: the reference's search (the JAX package on the CPU: seed 11,
#: o-delta-compile at index 2)
DST_REGRESSION = os.path.join("tests", "dst", "regressions",
                              "dst_seed2_e27df4160b0adb25.json")
POSITIONAL_BANKS_SEED = 11
#: 15d: label sets and endpoint announcements (phase 10's identities)
MESH_SCALE = 10_000
#: the world's event kinds → the DSTWorld method that runs each
DST_EVENT_METHODS = {"world": "__init__", "churn": "churn",
                     "churn-burst": "churn_burst", "traffic": "traffic",
                     "serve": "serve", "fleet": "fleet",
                     "multichip": "multichip",
                     "clustermesh": "clustermesh_sync",
                     "tenant": "tenant_isolation", "storm": "storm",
                     "drain-restore": "drain_restore",
                     "liveness": "check_liveness"}


def dst_cpu_job(seed, events=None, mutation=""):
    """One schedule on the CPU (a worker process of the pool; it never
    touches the card) → its digest, trace and violation."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cilium_tpu_torch.runtime import dst, faults

    os.environ.pop(faults.MUTATION_ENV, None)
    if mutation:
        os.environ[faults.MUTATION_ENV] = mutation
    try:
        res = dst.run_schedule(seed, events=events, device="cpu")
    finally:
        os.environ.pop(faults.MUTATION_ENV, None)
    return {k: res[k] for k in ("seed", "digest", "trace", "violation")}


def start_dst_cpu(pool):
    """Submit phase 15's CPU replays: seeds 0-4, the regression case
    with its mutation and the positional-banks seed with its."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, DST_REGRESSION)) as fp:
        case = json.load(fp)
    jobs = {("seed", s): pool.submit(dst_cpu_job, s)
            for s in range(DST_RECHECK_SEEDS)}
    jobs["regression"] = pool.submit(dst_cpu_job, case["seed"],
                                     case["events"], case["mutation"])
    jobs["positional"] = pool.submit(dst_cpu_job, POSITIONAL_BANKS_SEED,
                                     None, "positional-banks")
    return case, jobs


@contextlib.contextmanager
def dst_event_timing(ms):
    """While open, append each outermost world event's wall ms (the
    host clock) to ``ms[kind]``: the world's methods are wrapped, and
    run unchanged."""
    from cilium_tpu_torch.runtime.dst import DSTWorld

    depth = [0]
    saved = {name: getattr(DSTWorld, name)
             for name in DST_EVENT_METHODS.values()}

    def wrap(kind, real):
        def timed(self, *a, **kw):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return real(self, *a, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    ms.setdefault(kind, []).append(
                        (time.perf_counter() - t0) * 1e3)
        return timed

    for kind, name in DST_EVENT_METHODS.items():
        setattr(DSTWorld, name, wrap(kind, saved[name]))
    try:
        yield
    finally:
        for name, real in saved.items():
            setattr(DSTWorld, name, real)


@contextlib.contextmanager
def dst_launches_noted(noted):
    """While open, keep the inputs of the first KD and K2 launch at
    each distinct shape (``noted[(kernel, key)]``): the launchers are
    wrapped, and run unchanged."""
    from cilium_tpu_torch.engine import dfa_dense_cuda, dfa_oblivious_cuda

    kd, k2 = (dfa_dense_cuda.dense_scan_cuda,
              dfa_oblivious_cuda.dfa_finals_oblivious_cuda)

    def key(trans, data, lengths, *extra):
        return (tuple(trans.shape), tuple(data.shape), tuple(data.stride()),
                tuple(lengths.shape)) + tuple(
                    None if e is None else tuple(e.shape) for e in extra)

    def kd_noted(trans, byteclass, start, data, lengths, accept=None,
                 extra=None, _variant=None):
        noted.setdefault(("KD", key(trans, data, lengths, accept, extra)),
                         ((trans, byteclass, start, data, lengths),
                          {"accept": accept, "extra": extra}))
        return kd(trans, byteclass, start, data, lengths, accept=accept,
                  extra=extra, _variant=_variant)

    def k2_noted(trans, byteclass, start, data, lengths):
        noted.setdefault(("K2", key(trans, data, lengths)),
                         ((trans, byteclass, start, data, lengths), {}))
        return k2(trans, byteclass, start, data, lengths)

    dfa_dense_cuda.dense_scan_cuda = kd_noted
    dfa_oblivious_cuda.dfa_finals_oblivious_cuda = k2_noted
    try:
        yield
    finally:
        dfa_dense_cuda.dense_scan_cuda = kd
        dfa_oblivious_cuda.dfa_finals_oblivious_cuda = k2


def dst_sweep(noted, card):
    """15a: the sweep on the card, each event kind's wall ms."""
    import torch

    from cilium_tpu_torch.runtime import dst

    results, ms = {}, {}
    reset_counts()
    with dst_event_timing(ms), dst_launches_noted(noted):
        line, failing, _ = dst.sweep(
            DST_SEEDS, max_events=DST_MAX_EVENTS, device=DEVICE,
            log=log, on_result=lambda r: results.__setitem__(r["seed"], r))
    torch.cuda.synchronize()
    launches = counts()
    check(failing is None and line["violations"] == 0,
          f"[dst] the sweep violated an invariant: "
          f"{failing and (failing['seed'], failing['violation'])}")
    check(line["value"] == DST_SEEDS, f"[dst] ran {line['value']} schedules")
    check(launches["KD"] > 0, f"[dst] KD never launched: {launches}")
    events = sum(len(r["events"]) + 1 for r in results.values())
    line.update({
        "launches": launches,
        "kd_launches_per_schedule": launches["KD"] / DST_SEEDS,
        "events": events,
        "wall_s_per_schedule": line["wall_s"] / DST_SEEDS,
        "event_ms": {k: {"n": len(v), "mean": statistics.fmean(v),
                         "p50": statistics.median(v), "max": max(v)}
                     for k, v in sorted(ms.items())},
        "card": card})
    log(f"[dst] 15a: {line['value']} schedules on the card, "
        f"{line['distinct_schedules']} distinct, 0 violations, "
        f"{line['simulated_s']} s simulated in {line['wall_s']} s wall "
        f"({line['speedup_vs_real_time']}x); KD {launches['KD']} launches "
        f"({line['kd_launches_per_schedule']:.0f} a schedule)")
    return line, results


def dst_pallas(results, noted):
    """15b: seeds 0-4 again with the oblivious arm (K2) picked by each
    world's engines: the same traces, K2 launched, no fallback."""
    import torch

    from cilium_tpu_torch.runtime import dst

    prev = os.environ.get("CILIUM_TPU_DFA_IMPL")
    os.environ["CILIUM_TPU_DFA_IMPL"] = "pallas"
    reset_counts()
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught, \
                dst_launches_noted(noted):
            warnings.simplefilter("always")
            got = {s: dst.run_schedule(s, max_events=DST_MAX_EVENTS,
                                       device=DEVICE)
                   for s in range(DST_RECHECK_SEEDS)}
    finally:
        if prev is None:
            os.environ.pop("CILIUM_TPU_DFA_IMPL", None)
        else:
            os.environ["CILIUM_TPU_DFA_IMPL"] = prev
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    fallbacks = [str(w.message) for w in caught
                 if "falling back" in str(w.message)]
    check(not fallbacks, f"[dst pallas] the oblivious arm fell back: "
                         f"{fallbacks[:2]}")
    check(launches["K2"] > 0, f"[dst pallas] K2 never launched: {launches}")
    for s, res in got.items():
        check(res["trace"] == results[s]["trace"]
              and res["digest"] == results[s]["digest"],
              f"[dst pallas] seed {s}: the trace under the oblivious arm "
              f"differs from the gather arm's")
    log(f"[dst] 15b: seeds 0-{DST_RECHECK_SEEDS - 1} under "
        f"CILIUM_TPU_DFA_IMPL=pallas: traces equal to 15a's, K2 "
        f"{launches['K2']} launches, KD {launches['KD']}, no fallback, "
        f"{wall:.1f} s")
    return {"seeds": DST_RECHECK_SEEDS, "wall_s": wall,
            "launches": launches, "warnings": len(caught)}


def dst_planted(case, cpu):
    """15c: the planted bugs on the card, each caught as the reference
    catches it (the recorded index and invariant; the case's recorded
    detail lists the 23 probe flows of an older world, so the detail is
    held to the CPU run's) and clean without its mutation."""
    from cilium_tpu_torch.runtime import dst, faults

    out = {}
    reset_counts()
    t0 = time.perf_counter()
    for name, seed, events, mutation, want in (
            ("regression", case["seed"], case["events"], case["mutation"],
             case["violation"]),
            ("positional-banks", POSITIONAL_BANKS_SEED, None,
             "positional-banks",
             {"index": 2, "invariant": "o-delta-compile"})):
        os.environ[faults.MUTATION_ENV] = mutation
        try:
            bad = dst.run_schedule(seed, events=events,
                                   max_events=DST_MAX_EVENTS, device=DEVICE)
        finally:
            os.environ.pop(faults.MUTATION_ENV, None)
        clean = dst.run_schedule(seed, events=events,
                                 max_events=DST_MAX_EVENTS, device=DEVICE)
        v = bad["violation"]
        check(v is not None and (v["index"], v["invariant"]) ==
              (want["index"], want["invariant"]),
              f"[dst planted {name}] on the card: {v}, want {want}")
        ref = cpu["regression" if name == "regression" else "positional"]
        check(v == ref["violation"],
              f"[dst planted {name}] the card's violation {v} differs from "
              f"the CPU's {ref['violation']}")
        check(clean["violation"] is None,
              f"[dst planted {name}] violates without the mutation: "
              f"{clean['violation']}")
        out[name] = {"seed": seed, "mutation": mutation, "violation": v}
        log(f"[dst] 15c: {mutation} caught on the card at seed {seed}: "
            f"{v['invariant']} at index {v['index']} (detail equal to the "
            f"CPU run's); clean without it")
    out["launches"] = counts()
    out["wall_s"] = time.perf_counter() - t0
    return out


def dst_mesh_scale():
    """15d (host only): the identity and clustermesh planes at phase
    10's 10000 identities."""
    from cilium_tpu_torch.clustermesh import (
        CLUSTER_LABEL_KEY,
        ClusterMesh,
        LocalStatePublisher,
    )
    from cilium_tpu_torch.core.identity import IdentityAllocator
    from cilium_tpu_torch.core.labels import SOURCE_K8S, LabelSet
    from cilium_tpu_torch.identity_kvstore import ClusterIdentityAllocator
    from cilium_tpu_torch.ipcache import IPCache
    from cilium_tpu_torch.kvstore import KVStore

    n = MESH_SCALE
    pool = [LabelSet.from_dict({"app": f"a{i % 97}", "ns": f"n{i // 97}"})
            for i in range(n)]
    store = KVStore()
    a = ClusterIdentityAllocator(store).start()
    b = ClusterIdentityAllocator(store).start()
    t0 = time.perf_counter()
    ids_a = [a.allocate(lbls) for lbls in pool]
    ids_b = [b.allocate(lbls) for lbls in pool]
    alloc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh = ClusterIdentityAllocator(store).start()
    ids_f = [fresh.lookup_by_labels(lbls) for lbls in pool]
    replay_s = time.perf_counter() - t0
    for x in (a, b, fresh):
        x.close()
    check(ids_a == ids_b == ids_f and len(set(ids_a)) == n,
          f"[dst mesh] the allocators disagree on {n} label sets")
    remote_alloc = IdentityAllocator()
    remote_ipc = IPCache(remote_alloc)
    mesh_store = KVStore()
    pub = LocalStatePublisher(mesh_store, "alpha", remote_alloc, remote_ipc,
                              lease_ttl=3600.0)
    local_alloc = IdentityAllocator()
    local_ipc = IPCache(local_alloc)
    mesh = ClusterMesh(local_alloc, local_ipc)
    rc = mesh.connect("alpha", mesh_store)
    ips = [f"10.{8 + i // 62500}.{(i // 250) % 250}.{i % 250 + 1}"
           for i in range(n)]
    t0 = time.perf_counter()
    for i, ip in enumerate(ips):
        nid = remote_alloc.allocate(LabelSet.from_dict(
            {"meshapp": f"m{i % 50}"}))
        remote_ipc.upsert(f"{ip}/32", nid)
    pub.heartbeat()
    announce_s = time.perf_counter() - t0
    tagged = 0
    for ip in ips:
        nid = local_ipc.lookup(ip)
        lbls = local_alloc.lookup(nid) if nid is not None else None
        tag = lbls.get(CLUSTER_LABEL_KEY, SOURCE_K8S) if lbls else None
        tagged += tag is not None and tag.value == "alpha"
    entries = rc.num_entries()
    mesh.close()
    check(tagged == n and entries == n,
          f"[dst mesh] {tagged} of {n} announcements resolved with the "
          f"remote cluster tag ({entries} entries)")
    out = {"label_sets": n, "allocate_ms": alloc_s * 1e3,
           "allocate_per_s": 2 * n / alloc_s, "replay_ms": replay_s * 1e3,
           "announcements": n, "announce_ms": announce_s * 1e3,
           "announce_per_s": n / announce_s, "host_only": True}
    log(f"[dst] 15d (host only, no device work): {n} label sets through "
        f"two allocators over one kvstore in {out['allocate_ms']:.0f} ms "
        f"({out['allocate_per_s']:.0f} allocations/s), a fresh replay in "
        f"{out['replay_ms']:.0f} ms, all equal; {n} announcements "
        f"publisher -> kvstore -> remote cluster -> ipcache in "
        f"{out['announce_ms']:.0f} ms ({out['announce_per_s']:.0f}/s), "
        f"every one tagged alpha")
    return out


def dst_hold(errs, noted):
    """KD and K2 exactly against their plain versions at every launch
    shape the DST worlds staged (15a and 15b)."""
    from cilium_tpu_torch.engine import dfa_dense_cuda, dfa_oblivious_cuda

    held = {"KD": 0, "K2": 0}
    for (kid, key), (args, kw) in sorted(noted.items(), key=str):
        NB, S, K = args[0].shape
        what = f"dst {(NB, S, K)} B={args[3].shape[0]} L={args[3].shape[1]}" \
               f"{' accept' if kw.get('accept') is not None else ''}" \
               f"{' extra' if kw.get('extra') is not None else ''}"
        if kid == "KD":
            hold(errs, "KD", what, dfa_dense_cuda.dense_scan_cuda(*args, **kw),
                 dfa_dense_cuda.dense_scan_plain(*args, **kw))
        else:
            hold(errs, "K2", what,
                 dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*args),
                 dfa_oblivious_cuda.dfa_finals_oblivious_plain(*args))
        held[kid] += 1
    return held


def dst_phase(errs, dst_jobs, card):
    """Phase 15 (see the module docstring) → (report, launches by
    pass)."""
    t0 = time.perf_counter()
    case, jobs = dst_jobs
    noted = {}
    log("phase 15a: the DST sweep on the card")
    sweep, results = dst_sweep(noted, card)
    cpu = {k: f.result() for k, f in jobs.items()}
    for s in range(DST_RECHECK_SEEDS):
        check(cpu[("seed", s)]["digest"] == results[s]["digest"],
              f"[dst] seed {s}: the card's digest {results[s]['digest']} "
              f"differs from the CPU's {cpu[('seed', s)]['digest']}")
    log(f"[dst] 15a: seeds 0-{DST_RECHECK_SEEDS - 1} on the CPU (in the "
        f"worker pool): digests equal to the card's")
    log("phase 15b: seeds 0-4 under CILIUM_TPU_DFA_IMPL=pallas")
    pallas = dst_pallas(results, noted)
    log("phase 15c: the planted bugs on the card")
    planted = dst_planted(case, cpu)
    log("phase 15d: the identity and clustermesh planes at mesh scale "
        "(host only)")
    mesh = dst_mesh_scale()
    log(f"phase 15: KD and K2 at the {len(noted)} launch shapes the DST "
        f"worlds staged, against their plain versions")
    held = dst_hold(errs, noted)
    report = {"sweep": sweep, "pallas": pallas, "planted": planted,
              "mesh": mesh, "held_shapes": held, "card": card,
              "wall_s": time.perf_counter() - t0,
              # its walls are read with phase 10's soak and fleet running
              "beside": ["fleet soak", "fleet serve"]}
    launches = {"dst-sweep": sweep["launches"], "dst-pallas":
                pallas["launches"], "dst-planted": planted["launches"]}
    return report, launches


#: phase 16: the bench plane. Each tool runs on the card at its
#: defaults but for the iterations cut to keep the phase near 180 s
#: (PERF.md section 4 lists each cut): bench.py's latency samples 100 ->
#: 20, its throughput windows 5 x 1.5 s -> 3 x 0.5 s, the capture lane's
#: chunk samples 200 -> 20 (its provenance A/B keeps its 6 pairs, each
#: window cycled to 0.5 s, not 1.5: BENCH16_PROV_WINDOW_S, to make room
#: for phase 17), the kafka frame windows 3 -> 1, the --check oracle sample 500 -> 50 flows
#: (at 1000 rules the oracle takes ~70 ms a flow on one core); the service's
#: closed loop one deadline (2 ms) of the three, its open and stream
#: points 1 s each at one offered rate; bench_sp's 10 forced calls a
#: shape -> 3; bench_multichip's 5 windows -> 3; bench_protocols' timed
#: replays a lane 3 -> 1 (phase 11 times the same lanes at 3)
BENCH16_BENCH_ARGS = ["--lat-iters", "20", "--windows", "3",
                      "--window-s", "0.5", "--capture-lat", "20",
                      "--frame-windows", "1"]
BENCH16_CHECK_SAMPLE = 50
BENCH16_PROV_WINDOW_S = 0.5
BENCH16_CAPTURE_RECORDS = 200_000
BENCH16_SERVICE_ARGS = ["--deadlines", "2", "--open-rates", "2000",
                        "--open-duration", "1", "--stream",
                        "--stream-rates", "200000", "--stream-duration",
                        "1"]
BENCH16_SP_ITERS, BENCH16_MC_WINDOWS = 3, 3
BENCH16_PROTOCOLS_ARGS = ["--reps", "1", "--skip-crosscluster"]
#: the canary lane at ``make canary-smoke``'s sizes
BENCH16_CANARY_ARGS = ["--chunks", "48", "--pool-chunks", "12"]
#: the reference's fused/three-op speedup target (bench_kernel.py)
BENCH16_SPEEDUP_TARGET = 2.0


@contextlib.contextmanager
def kernel_launches_noted(noted):
    """While open, keep the inputs of the first KD, K2 and K1 launch at
    each distinct shape (``noted[(kernel, key)]``): the launchers are
    wrapped and run unchanged."""
    from cilium_tpu_torch.engine import (
        dfa_dense_cuda,
        dfa_oblivious_cuda,
        nfa_cuda,
    )

    kd, k2, k1 = (dfa_dense_cuda.dense_scan_cuda,
                  dfa_oblivious_cuda.dfa_finals_oblivious_cuda,
                  nfa_cuda.nfa_finals_cuda)

    def key(*ts):
        return tuple(None if t is None else (tuple(t.shape), tuple(t.stride()))
                     for t in ts)

    def kd_noted(trans, byteclass, start, data, lengths, accept=None,
                 extra=None, _variant=None):
        noted.setdefault(("KD", key(trans, data, lengths, accept, extra)),
                         ((trans, byteclass, start, data, lengths),
                          {"accept": accept, "extra": extra}))
        return kd(trans, byteclass, start, data, lengths, accept=accept,
                  extra=extra, _variant=_variant)

    def k2_noted(trans, byteclass, start, data, lengths):
        noted.setdefault(("K2", key(trans, data, lengths)),
                         ((trans, byteclass, start, data, lengths), {}))
        return k2(trans, byteclass, start, data, lengths)

    def k1_noted(follow, acc_cls, byteclass, start, data, lengths):
        noted.setdefault(("K1", key(follow, acc_cls, data, lengths)),
                         ((follow, acc_cls, byteclass, start, data,
                           lengths), {}))
        return k1(follow, acc_cls, byteclass, start, data, lengths)

    dfa_dense_cuda.dense_scan_cuda = kd_noted
    dfa_oblivious_cuda.dfa_finals_oblivious_cuda = k2_noted
    nfa_cuda.nfa_finals_cuda = k1_noted
    try:
        yield
    finally:
        dfa_dense_cuda.dense_scan_cuda = kd
        dfa_oblivious_cuda.dfa_finals_oblivious_cuda = k2
        nfa_cuda.nfa_finals_cuda = k1


def tool_lines(main, argv, what):
    """A tool's ``main(argv)`` in this process, its standard output
    captured: → its JSON lines. Fails the run on a non-zero exit or a
    ``bench_failed`` line."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = [json.loads(s) for s in buf.getvalue().splitlines()
             if s.startswith("{")]
    check(rc == 0, f"[bench {what}] exited {rc}: {buf.getvalue()[-800:]}")
    check(bool(lines), f"[bench {what}] printed no JSON line")
    for ln in lines:
        check(not str(ln.get("metric", "")).startswith("bench_failed"),
              f"[bench {what}] {ln}")
        check(ln.get("bench_schema") == 1
              and isinstance(ln.get("provenance"), dict)
              and str(ln["provenance"].get("backend")) == "cuda",
              f"[bench {what}] line not stamped on the card: {ln}")
    return lines


def bench_phase(card):
    """Phase 16 (see the module docstring) → (report, launches by lane,
    KD variants by lane, the launch shapes noted)."""
    import tempfile

    import torch

    from cilium_tpu_torch import perf_report
    from cilium_tpu_torch.ingest import synth
    from cilium_tpu_torch.runtime import canary
    from cilium_tpu_torch.tools import (
        bench,
        bench_kernel,
        bench_multichip,
        bench_protocols,
        bench_service,
        bench_sp,
        bench_stage,
    )

    import gc

    t0 = time.perf_counter()
    noted, lines, launches, variants, walls = {}, {}, {}, {}, {}
    # the earlier phases' objects (a million flows of phase 12 among
    # them) are not the tools': kept out of every collection while they
    # time, as a tool run alone would find the heap
    gc.collect()
    gc.freeze()
    env0 = {k: os.environ.get(k) for k in (
        "CILIUM_TPU_CACHE_DIR", "CILIUM_TPU_DST_SEED",
        "CILIUM_TPU_DST_DIGEST")}
    prov_window_s = bench.PROV_WINDOW_S
    bench.PROV_WINDOW_S = BENCH16_PROV_WINDOW_S
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp, \
            kernel_launches_noted(noted):
        os.environ["CILIUM_TPU_CACHE_DIR"] = os.path.join(tmp, "cache")

        def lane(name, main, argv, kernels=("KD",)):
            reset_counts()
            t1 = time.perf_counter()
            got = tool_lines(main, argv, name)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t1
            launches[f"bench-{name}"] = counts()
            variants[f"bench-{name}"] = kd_variants()
            for kid in kernels:
                check(launches[f"bench-{name}"][kid] > 0,
                      f"[bench {name}] {kid} never launched: "
                      f"{launches[f'bench-{name}']}")
            lines[name] = got
            log(f"[bench {name}] {len(got)} line(s) in {walls[name]:.1f} s; "
                f"launches {launches[f'bench-{name}']} on {card}")
            return got

        try:
            # 16a: a capture written by synth's writer, then bench.py's
            # headline config through it with the oracle check
            t1 = time.perf_counter()
            _, sc = synth.realize_scenario(
                synth.scenario_by_name("http", 1000, 10000))
            cap = os.path.join(tmp, "http_capture.bin")
            n = synth.write_scenario_capture(cap, sc,
                                             BENCH16_CAPTURE_RECORDS)
            check(n == BENCH16_CAPTURE_RECORDS, f"[bench] wrote {n} records")
            walls["capture-write"] = time.perf_counter() - t1
            (http,) = lane("http", bench.main, [
                "--inner", "--config", "http", "--check", "--check-sample",
                str(BENCH16_CHECK_SAMPLE), "--from-capture", cap,
                *BENCH16_BENCH_ARGS])
            check(http["metric"] == "e2e_capture_replay_http_1000rules"
                  and http["check_mismatches"] == 0
                  and http["capture_records"] == BENCH16_CAPTURE_RECORDS,
                  f"[bench http] {http}")
            log(f"[bench http] {http['value']:.0f} verdicts/s file → "
                f"verdict (chunk p50 {http['p50_ms']} ms, p99 "
                f"{http['p99_ms']} ms); the batch lane "
                f"{http['device_verdicts_per_sec']:.0f} verdicts/s, p50 "
                f"{http['device_p50_ms']} ms; provenance overhead "
                f"{http['provenance_overhead_pct']} % "
                f"(A/B over {len(http['provenance_windows_ms']['base'])} "
                f"pairs of windows; the consumption timed apart "
                f"{http['provenance_consume_ms']} ms, "
                f"{http['provenance_consume_pct']} %; windows ms "
                f"{http['provenance_windows_ms']}); stage "
                f"{http['stage_ms']} ms, "
                f"unique {http['unique_rows']}; --check on "
                f"{http['check_flows']} flows: 0 mismatches")
            for config in ("fqdn", "kafka", "generic"):
                (ln,) = lane(config, bench.main, [
                    "--inner", "--config", config, "--from-capture",
                    os.path.join(tmp, f"{config}_capture.bin"),
                    *BENCH16_BENCH_ARGS])
                log(f"[bench {config}] {ln['metric']} {ln['value']:.0f} "
                    f"(batch lane {ln['device_verdicts_per_sec']:.0f} "
                    f"verdicts/s, p50 {ln['device_p50_ms']} ms; "
                    f"provenance overhead "
                    f"{ln['provenance_overhead_pct']} % "
                    f"(A/B over {len(ln['provenance_windows_ms']['base'])} "
                    f"pairs of windows; the consumption timed apart "
                    f"{ln['provenance_consume_ms']} ms, "
                    f"{ln['provenance_consume_pct']} %; windows ms "
                    f"{ln['provenance_windows_ms']}))"
                    + (f"; frames → verdict "
                       f"{ln['frames_to_verdict_per_sec']:.0f}/s"
                       if config == "kafka" else ""))
            # 16b: the fused step against the three-op path, the sweep
            kern = lane("kernel", bench_kernel.main, ["--min-speedup", "0"],
                        kernels=("KD", "K1"))
            head = kern[0]
            check(head["lanes_equal"], "[bench kernel] the three-op path's "
                                       "lanes differ from the fused step's")
            log(f"[bench kernel] fused {head['fused_p50_ms']} ms against "
                f"three-op {head['three_op_p50_ms']} ms: speedup "
                f"{head['fused_speedup']} (the reference's target "
                f"{BENCH16_SPEEDUP_TARGET}; a speed target, logged); sweep "
                + "; ".join(f"{ln['metric'].rsplit('_', 1)[-1]} dense "
                            f"{ln['dense_ms']} / nfa {ln['nfa_ms']} ms -> "
                            f"{ln['impl']}" for ln in kern[1:]))
            # 16c-16g
            lane("stage", bench_stage.main, [])
            svc = lane("service", bench_service.main, BENCH16_SERVICE_ARGS)
            # every request of every point answered, and every stream
            # chunk answered with its image's verdicts
            points = [ln for ln in svc if "errors" in ln]
            check(sorted(ln["lane"] if "lane" in ln else "closed"
                         for ln in points)
                  == ["closed", "open_loop", "stream"]
                  and all(ln["errors"] == 0 for ln in points)
                  and all(ln["stale"] == 0 and ln["lost"] == 0
                          for ln in points if ln.get("lane") == "stream"),
                  "[bench service] failed requests or stale chunks: "
                  + str([{k: ln.get(k) for k in (
                      "metric", "errors", "stale", "lost", "samples")}
                      for ln in points]))
            lane("protocols", bench_protocols.main, BENCH16_PROTOCOLS_ARGS)
            lane("multichip-1", bench_multichip.main, [
                "--ranks", "1", "--backend", "nccl", "--windows",
                str(BENCH16_MC_WINDOWS)])
            # the ranks' own launches are theirs (spawned processes)
            lane("multichip-2", bench_multichip.main, [
                "--ranks", "2", "--backend", "gloo", "--windows",
                str(BENCH16_MC_WINDOWS)])
            lane("sp", bench_sp.main, ["--iters", str(BENCH16_SP_ITERS)])
            (can,) = lane("canary", canary.main, BENCH16_CANARY_ARGS + [
                "--cache-dir", os.path.join(tmp, "canary")])
            check(all(can["gates"].values()), f"[bench canary] {can}")
            # 16h: the port's perf_report over every line phase 16 wrote
            flat = [ln for got in lines.values() for ln in got]
            with open(os.path.join(tmp, "BENCH_PORT_r14.jsonl"), "w") as f:
                for ln in flat:
                    if not ln["metric"].startswith("multichip"):
                        f.write(json.dumps(ln) + "\n")
            for ln in flat:
                if ln["metric"].startswith("multichip"):
                    with open(os.path.join(
                            tmp, f"MULTICHIP_PORT_{ln['ranks']}_r14.json"),
                            "w") as f:
                        json.dump(ln, f)
            entries, errors = perf_report.normalize_all(tmp)
            check(not errors, f"[bench perf_report] schema errors {errors}")
            check(len([e for e in entries if not str(e["metric"]).endswith(
                "_stage_ms")]) == len(flat),
                  f"[bench perf_report] {len(entries)} entries for "
                  f"{len(flat)} lines")
            import io

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = perf_report.run_cli(["--root", tmp, "--out",
                                          os.path.join(tmp, "traj.json")])
            check(rc == 0, f"[bench perf_report] gate rc {rc}: "
                           f"{buf.getvalue()[-1500:]}")
            with open(os.path.join(tmp, "traj.json")) as f:
                traj = json.load(f)
        finally:
            gc.unfreeze()
            bench.PROV_WINDOW_S = prov_window_s
            for k, v in env0.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
    log(f"[bench perf_report] {len(flat)} lines normalized and validated, "
        f"{traj['metrics']} metrics, gate clean: "
        f"{buf.getvalue().strip().splitlines()[-1]}")
    report = {"card": card, "wall_s": time.perf_counter() - t0,
              "walls_s": walls, "lines": len(flat),
              "perf_report": {"metrics": traj["metrics"],
                              "gate_regressions": traj["gate_regressions"]},
              "summary": {name: [{k: ln.get(k) for k in (
                  "metric", "value", "unit", "p50_ms", "p99_ms",
                  "fused_speedup", "dense_ms", "nfa_ms", "impl",
                  "stage_ms", "unique_rows", "capture_records",
                  "memo_hit_ratio", "canary_overhead_pct")
                  if ln.get(k) is not None} for ln in got]
                  for name, got in lines.items()},
              "speedup_target": BENCH16_SPEEDUP_TARGET,
              "cuts": {"bench": BENCH16_BENCH_ARGS,
                       "check_sample": (BENCH16_CHECK_SAMPLE, 500),
                       "prov_window_s": (BENCH16_PROV_WINDOW_S,
                                         prov_window_s),
                       "service": BENCH16_SERVICE_ARGS,
                       "sp_iters": (BENCH16_SP_ITERS, 10),
                       "protocols": BENCH16_PROTOCOLS_ARGS,
                       "multichip_windows": (BENCH16_MC_WINDOWS, 5)}}
    return report, launches, variants, noted


def hold_noted(errs, noted, tag):
    """Every launch shape ``kernel_launches_noted`` kept, held exactly
    against the kernel's plain version on those inputs → shapes held by
    kernel."""
    from cilium_tpu_torch.engine import (
        dfa_dense_cuda,
        dfa_oblivious_cuda,
        nfa_cuda,
    )

    held = {"KD": 0, "K1": 0, "K2": 0}
    for (kid, _), (args, kw) in sorted(noted.items(), key=str):
        what = (f"{tag} {tuple(args[0].shape)} B={args[-2].shape[0]} "
                f"L={args[-2].shape[1]}"
                f"{' accept' if kw.get('accept') is not None else ''}"
                f"{' extra' if kw.get('extra') is not None else ''}")
        if kid == "KD":
            hold(errs, "KD", what, dfa_dense_cuda.dense_scan_cuda(*args, **kw),
                 dfa_dense_cuda.dense_scan_plain(*args, **kw))
        elif kid == "K2":
            hold(errs, "K2", what,
                 dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*args),
                 dfa_oblivious_cuda.dfa_finals_oblivious_plain(*args))
        else:
            hold(errs, "K1", what, nfa_cuda.nfa_finals_cuda(*args),
                 nfa_cuda.nfa_finals_plain(*args))
        held[kid] += 1
    return held


@contextlib.contextmanager
def kr_launches_noted(noted):
    """While open, keep the inputs of KR's first launch at each distinct
    launch shape (``noted[key]``: the batch's rows, the groups, header
    and LOG lanes and mask words of each family, the words' widths, the
    per-row columns' strides, and which families the call carries); the
    launcher is wrapped and runs unchanged. The key is a few shape reads
    a call, so the phases' timed calls pay next to nothing for it."""
    from cilium_tpu_torch.engine import resolve_cuda

    kr = resolve_cuda.resolve_groups_cuda

    def kr_noted(arrays, ruleset, l7t, words, gwords, kafka_cols,
                 gen_cols=None):
        fe = "fe_lane" in arrays and "rp_fe_pairs" in arrays
        key = (ruleset.shape[0], ruleset.stride(0), l7t.stride(0),
               kafka_cols[0].stride(0), tuple(arrays["rp_g_hdr"].shape),
               arrays["rp_g_log"].shape[1],
               tuple(arrays["rp_rs_gmask"].shape),
               tuple(arrays["rp_dns_rsmask"].shape),
               arrays["rp_k_apikey_mask"].shape[0],
               tuple(arrays["rp_rs_kmask"].shape),
               tuple(arrays["rp_gen_pairs"].shape),
               tuple(arrays["rp_fe_pairs"].shape) if fe else None,
               tuple((w.shape[1], w.stride(0)) for w in (*words, gwords)),
               None if gen_cols is None else
               (gen_cols[0].stride(0), tuple(gen_cols[1].shape)))
        if key not in noted:
            # only what the resolve reads of the plan is kept: the staged
            # scan tables of every noted policy would stay on the card
            plan = {k: v for k, v in arrays.items()
                    if k in ("rs_http_mask", "fe_lane")
                    or (k.startswith("rp_") and k != "rp_path_gaccept")}
            noted[key] = ((plan, ruleset, l7t, words, gwords, kafka_cols),
                          {"gen_cols": gen_cols})
        return kr(arrays, ruleset, l7t, words, gwords, kafka_cols,
                  gen_cols=gen_cols)

    resolve_cuda.resolve_groups_cuda = kr_noted
    try:
        yield
    finally:
        resolve_cuda.resolve_groups_cuda = kr


def kr_needed_bytes(args, gen_cols) -> int:
    """Bytes KR must move at these arguments, each once: every row's rule
    set and l7 type; the columns of the family its l7 type selects (HTTP:
    the method, host, header and path-group words; DNS: the qname words;
    kafka: the four columns; generic, with a generic block: the proto and
    the pair ids; frontend, where staged: the l7g words and the pair ids,
    for a row of a family some frontend group names); the tables of each
    family some row selects (not the ``*_rule_group`` maps, which KR
    does not read); and the three output lanes."""
    import torch

    from cilium_tpu_torch.core.flow import L7Type

    arrays, ruleset, l7t, words, gwords, kafka = args
    t = l7t.cpu()

    def rows_of(mask):
        return int(mask.sum())

    def row(w):
        return w.shape[1] * w.element_size()

    def tables(*prefixes):
        return sum(v.numel() * v.element_size() for k, v in arrays.items()
                   if k.startswith(prefixes) and "rule_group" not in k)

    total = ruleset.shape[0] * (ruleset.element_size() + l7t.element_size()
                                + 1 + 1 + 4)
    n = rows_of(t == int(L7Type.HTTP))
    if n:
        total += n * (row(words[1]) + row(words[2]) + row(words[3])
                      + row(gwords)) + tables("rp_g_", "rp_rs_gmask")
    n = rows_of(t == int(L7Type.DNS))
    if n:
        total += n * row(words[4]) + tables("rp_dns_rsmask")
    n = rows_of(t == int(L7Type.KAFKA))
    if n:
        total += n * sum(c.element_size() for c in kafka) + tables(
            "rp_k_", "rp_rs_kmask")
    if gen_cols is None:
        return total
    gen = t == int(L7Type.GENERIC)
    fe = torch.zeros_like(gen)
    if len(words) > 5 and "fe_lane" in arrays and "rp_fe_family" in arrays:
        fam = arrays["rp_fe_family"].cpu()
        fe = torch.isin(t, fam[fam >= 0])
        if fe.any():
            total += rows_of(fe) * row(words[5]) + tables("rp_fe_",
                                                          "rp_rs_femask")
    if gen.any():
        total += rows_of(gen) * gen_cols[0].element_size() + tables(
            "rp_gen_", "rp_rs_genmask")
    return total + rows_of(gen | fe) * row(gen_cols[1])


def kr_hold(errs, rows, noted, card):
    """Phase 22: KR exactly against its plain version at every launch
    shape kept by :func:`kr_launches_noted`, then its device, call and
    plain times and its byte bound (:func:`kr_needed_bytes`) at the
    largest (a ``largest`` row in ``rows["KR"]``). Returns the count of
    shapes held, and the largest."""
    from cilium_tpu_torch.engine import resolve_cuda

    held = 0
    largest = None
    for _, (args, kw) in sorted(noted.items(), key=str):
        arrays, ruleset = args[0], args[1]
        G, Hm = arrays["rp_g_hdr"].shape
        B = ruleset.shape[0]
        what = (f"G={G} Hm={Hm} Lm={arrays['rp_g_log'].shape[1]} B={B}"
                f"{' gen' if kw['gen_cols'] is not None else ''}"
                f"{' fe' if len(args[3]) > 5 else ''}")
        hold(errs, "KR", what, resolve_cuda.resolve_groups_cuda(*args, **kw),
             resolve_cuda.resolve_groups_plain(*args, **kw))
        held += 1
        if largest is None or B > largest[1][1].shape[0]:
            largest = (what, args, kw)
    check(largest is not None, "[kr] no KR launch was noted in phases 3-21")
    what, args, kw = largest
    G = args[0]["rp_g_hdr"].shape[0]
    B = args[1].shape[0]

    def kr():
        return resolve_cuda.resolve_groups_cuda(*args, **kw)

    row = ("largest", (G, args[0]["rp_rs_gmask"].shape[1], B),
           kernel_device_ms(kr, "resolve_groups_kernel"), time_launch(kr),
           time_launch(lambda: resolve_cuda.resolve_groups_plain(
               *args, **kw), reps=3),
           *bound(kr_needed_bytes(args, kw["gen_cols"]), 0))
    rows["KR"] = [row]
    log(f"  KR largest {what}: device {row[2]:.5f} ms, call {row[3]:.5f} "
        f"ms, plain {row[4]:.3f} ms, bound {row[5]:.6f} ms ({row[6]}); "
        f"shapes held {held}; {card}")
    return {"held": held, "largest": what}


def bench_hold(errs, noted, card):
    """Phase 16's kernels held exactly against their plain versions: KD,
    K2 and K1 at every launch shape the tools staged in this process,
    and at ``tools/bench_kernel``'s sweep banks on its probe batch
    (K2 too, though the sweep's dense arm ran KD); then each kernel's
    device, call and plain times and its bound at the sweep banks
    (``sweep-<bank>`` rows, by :func:`kernel_times`)."""
    import numpy as np
    import torch

    from cilium_tpu_torch.engine import (
        dfa_dense_cuda,
        dfa_oblivious_cuda,
        nfa_cuda,
    )
    from cilium_tpu_torch.tools import bench_kernel
    from cilium_tpu_torch.weights import arrays_from_reference

    held = hold_noted(errs, noted, "bench")
    rows = {}
    rng = np.random.default_rng(16)
    B, L = bench_kernel.SWEEP_BATCH, bench_kernel.SWEEP_WIDTH
    sweep = {}
    for name, bank in bench_kernel.sweep_banks().items():
        st = arrays_from_reference(bank["stacked"], DEVICE)
        data = torch.from_numpy(rng.integers(0, 128, size=(B, L),
                                             dtype=np.uint8)).to(DEVICE)
        lens = torch.from_numpy(rng.integers(0, L + 1, size=B)
                                .astype(np.int32)).to(DEVICE)
        a = (st["trans"], st["byteclass"], st["start"], data, lens)
        shape = tuple(st["trans"].shape)
        hold(errs, "KD", f"sweep {name} {shape} B={B} L={L}",
             dfa_dense_cuda.dense_scan_cuda(*a, accept=st["accept"]),
             dfa_dense_cuda.dense_scan_plain(*a, accept=st["accept"]))
        check(shape[1] <= 128, f"[bench] sweep {name} past K2's states")
        hold(errs, "K2", f"sweep {name} {shape} B={B} L={L}",
             dfa_oblivious_cuda.dfa_finals_oblivious_cuda(*a),
             dfa_oblivious_cuda.dfa_finals_oblivious_plain(*a))
        nfa = [torch.from_numpy(bank["nfa"][f"nfa_{k}"]).to(DEVICE)
               for k in ("follow", "acc_cls", "byteclass", "start")]
        hold(errs, "K1", f"sweep {name} {tuple(nfa[1].shape)} B={B} L={L}",
             nfa_cuda.nfa_finals_cuda(*nfa, data, lens),
             nfa_cuda.nfa_finals_plain(*nfa, data, lens))
        sweep[name] = {"dense": list(shape),
                       "nfa": list(nfa[1].shape)}
        # device, call and plain times and the bound of each kernel at
        # the bank, by phase 4's code (the bank's arrays under the
        # bank's name as the field prefix)
        arr = {f"{name}_{k}": v for k, v in st.items()}
        arr.update({f"{name}_nfa_{k}": t for k, t in zip(
            ("follow", "acc_cls", "byteclass", "start"), nfa)})
        for kid, rs in kernel_times({name: (arr, data, lens)},
                                    {name: (arr, data, lens)}, {}, {},
                                    card, tag="sweep-").items():
            rows.setdefault(kid, []).extend(rs)
    return {"noted": held, "sweep": sweep, "rows": rows}


#: phase 17: the observability and ingest plane at phase 8's loader-built
#: http-1000 policy. The scenario's flows repeated to OBSERVE_RECORDS
#: records, replayed in chunks of BATCH (``cmd_replay``'s unit,
#: ``cfg.engine.batch_size``); the access-log records fed to the
#: access-log socket (the scenario's HTTP flows); the chunks the
#: kill-and-resume pass commits before it processes one more and stops;
#: the filtered query's path regex; how long a follower may take to
#: catch up once the replay ends
OBSERVE_RECORDS, OBSERVE_ACCESSLOG, OBSERVE_KILL_AFTER = 65536, 1000, 3
OBSERVE_FILTER_PATH = r"^/api/v[0-9]+/"
OBSERVE_CATCH_UP_S = 60.0


class _SeqRecorder:
    """An ``Observer`` handler that keeps every observed flow at its
    ring sequence (handlers run under the observer's write lock, right
    after the ring write, so the list index is the seq)."""

    def __init__(self):
        self.flows = []

    def process(self, flows):
        self.flows.extend(flows)


def _stampless(d):
    """A flow dict without the stamps that are not data (the annotate
    time and the trace id)."""
    return {k: v for k, v in d.items() if k not in ("time", "trace_id")}


def _wait_until(cond, what, timeout=OBSERVE_CATCH_UP_S):
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout,
              f"[observe] timed out waiting for {what}")
        time.sleep(0.01)


def _mix(out):
    import numpy as np

    return np.bincount(np.asarray(out["verdict"]), minlength=8)


def observe_captures(tmp, flows):
    """Phase 17's three captures of the same OBSERVE_RECORDS records:
    flowpb (absolute ``http.url``, as Hubble's parser writes it, so the
    host survives the wire), JSONL and binary v2 → (paths, write s)."""
    import dataclasses

    from cilium_tpu_torch.ingest import binary, flowpb
    from cilium_tpu_torch.ingest.hubble import write_jsonl

    n = len(flows)
    recs = [flows[i % n] for i in range(OBSERVE_RECORDS)]
    absolute = [dataclasses.replace(f, http=dataclasses.replace(
        f.http, path=f"http://{f.http.host}{f.http.path}"))
        if f.http is not None and f.http.host else f for f in flows]
    paths = {fmt: os.path.join(tmp, f"capture.{fmt}")
             for fmt in ("flowpb", "jsonl", "binary")}
    secs = {}
    for fmt, write in (("flowpb", lambda p: flowpb.write_pb_capture(
            p, (absolute[i % n] for i in range(OBSERVE_RECORDS)))),
                       ("jsonl", lambda p: write_jsonl(p, recs)),
                       ("binary", lambda p: binary.write_capture_l7(p, recs))):
        t0 = time.perf_counter()
        check(write(paths[fmt]) == OBSERVE_RECORDS,
              f"[observe] the {fmt} writer wrote a short capture")
        secs[fmt] = time.perf_counter() - t0
    check(flowpb.looks_like_pb_capture(paths["flowpb"])
          and binary.capture_version(paths["binary"]) == 2,
          "[observe] the captures do not sniff as written")
    return paths, secs


def accesslog_lines(flows):
    """OBSERVE_ACCESSLOG Envoy access-log records (JSON lines) of the
    scenario's HTTP flows."""
    out = []
    for i, f in enumerate(x for x in flows if x.http is not None):
        if i == OBSERVE_ACCESSLOG:
            break
        out.append(json.dumps({
            "entry_type": "Request", "is_ingress": True,
            "timestamp": 1753866000.0 + i,
            "source_security_id": f.src_identity,
            "destination_security_id": f.dst_identity,
            "source_address": f"10.0.0.9:{40000 + i}",
            "destination_address": f"10.0.0.2:{f.dport}",
            "http": {"method": f.http.method, "path": f.http.path,
                     "host": f.http.host,
                     "headers": [{"key": k, "value": v}
                                 for k, v in f.http.headers]}}))
    check(len(out) == OBSERVE_ACCESSLOG, "[observe] too few HTTP flows")
    return out


def fan_out_pass(engine, chunks, monitor, observer, stages=None,
                 cursor=None):
    """``cmd_replay``'s object path over ``chunks`` (``replay_chunks``'
    generator) with the fan-out sequence the reference keeps in
    ``Agent.fan_out``: ``verdict_flows`` (one readback a batch, numpy),
    ``monitor.notify_batch``, ``annotate_flows`` with the engine's
    attribution map, ``observer.observe``; one trace a chunk; then the
    chunk's index committed to ``cursor`` (commit after process).
    ``stages`` collects host ms a chunk by stage. → (verdict mix, the
    monitor's returned events, the chunks with their outputs)."""
    import numpy as np

    from cilium_tpu_torch.engine.verdict import AUTH_UNENFORCED
    from cilium_tpu_torch.hubble.observer import annotate_flows
    from cilium_tpu_torch.runtime.tracing import TRACER

    mix = np.zeros(8, dtype=np.int64)
    events, kept = [], []
    it = iter(chunks)
    while True:
        t0 = time.perf_counter()
        try:
            commit, chunk = next(it)
        except StopIteration:
            break
        t1 = time.perf_counter()
        with TRACER.trace("replay.chunk", chunk=int(commit)):
            out = engine.verdict_flows(chunk, authed_pairs=AUTH_UNENFORCED)
            t2 = time.perf_counter()
            events += monitor.notify_batch(chunk, out)
            t3 = time.perf_counter()
            annotate_flows(chunk, out,
                           amap=getattr(engine, "attribution", None))
            t4 = time.perf_counter()
            observer.observe(chunk)
            t5 = time.perf_counter()
        if cursor is not None:
            cursor.commit(commit)
        mix += _mix(out)
        kept.append((chunk, out))
        if stages is not None:
            for k, a, b in (("decode", t0, t1), ("verdict_flows", t1, t2),
                            ("monitor", t2, t3), ("annotate", t3, t4),
                            ("observe", t4, t5)):
                stages.setdefault(k, []).append((b - a) * 1e3)
    return mix, events, kept


def observe_cpu_hold(engine, capture, tmp):
    """The first chunk's fan-out on the card and on the plain path
    (``device="cpu"``), each into fresh consumers: annotated flows,
    returned events, the exporter's lines, the ``FlowMetrics`` and
    ``cilium_tpu_monitor_events_total`` deltas equal (stamps aside)."""
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
    from cilium_tpu_torch.hubble import FlowExporter, FlowMetrics, Observer
    from cilium_tpu_torch.ingest.cursor import replay_chunks
    from cilium_tpu_torch.ingest.hubble import flow_to_dict
    from cilium_tpu_torch.monitor import MonitorAgent, event_to_dict
    from cilium_tpu_torch.runtime.metrics import METRICS, Metrics

    def monitor_counts():
        with METRICS._lock:
            return {k: v for k, v in METRICS._counters.items()
                    if k[0] == "cilium_tpu_monitor_events_total"}

    got = {}
    plain = TorchVerdictEngine(engine.policy, device="cpu", cfg=engine.cfg)
    for name, eng in (("card", engine), ("plain", plain)):
        m = Metrics()
        path = os.path.join(tmp, f"first-chunk-{name}.jsonl")
        ex = FlowExporter(path)
        obs = Observer(handlers=[FlowMetrics(m), ex])
        before = monitor_counts()
        _, events, kept = fan_out_pass(
            eng, replay_chunks(capture, chunk_size=BATCH, limit=BATCH),
            MonitorAgent(), obs)
        ex.close()
        after = monitor_counts()
        with open(path) as f:
            lines = [_stampless(json.loads(s)) for s in f]
        ((chunk, out),) = kept
        check(all(f.trace_id for f in chunk),
              f"[observe {name}] a flow without its chunk's trace id")
        got[name] = {
            "flows": [_stampless(flow_to_dict(f)) for f in chunk],
            "events": [{k: v for k, v in event_to_dict(e).items()
                        if k != "ts"} for e in events],
            "exported": lines,
            "flow_metrics": dict(m._counters),
            "monitor_metrics": {k: v - before.get(k, 0.0)
                                for k, v in after.items()}}
    for k, want in got["plain"].items():
        check(got["card"][k] == want,
              f"[observe] the first chunk's {k} differ between the card "
              f"and the plain path")
    n = len(got["card"]["flows"])
    log(f"[observe plain] first chunk: {n} annotated flows, "
        f"{len(got['card']['events'])} events, {n} exported lines, "
        f"{len(got['card']['flow_metrics'])} FlowMetrics series and the "
        f"monitor-event deltas equal to the plain path (stamps aside)")
    return {"flows": n, "events": len(got["card"]["events"]),
            "monitor_events_delta": sum(
                got["card"]["monitor_metrics"].values())}


def monitor_reader(stream, out, errors):
    try:
        for ev in stream:
            out.append(ev)
    except (ConnectionError, OSError):
        pass                       # the stream closed: the phase is done
    except Exception as e:  # noqa: BLE001 — reported as the phase's failure
        errors.append(repr(e))


def observe_phase(engine, flows, card):
    """Phase 17 (see the module docstring) → (report, the phase's
    launches, KD's launches by variant, the launch shapes noted)."""
    import dataclasses
    import tempfile
    import threading

    import numpy as np
    import torch

    from cilium_tpu_torch.core.flow import Verdict
    from cilium_tpu_torch.engine.replay import CaptureReplay
    from cilium_tpu_torch.engine.verdict import (
        AUTH_UNENFORCED,
        TorchVerdictEngine,
    )
    from cilium_tpu_torch.hubble import (
        FlowExporter,
        FlowFilter,
        FlowMetrics,
        HubbleClient,
        HubbleServer,
        Observer,
    )
    from cilium_tpu_torch.hubble.accesslog_server import AccessLogServer
    from cilium_tpu_torch.hubble.server import filter_to_dict
    from cilium_tpu_torch.ingest.cursor import ReplayCursor, replay_chunks
    from cilium_tpu_torch.ingest.hubble import flow_to_dict
    from cilium_tpu_torch.monitor import (
        AggregationLevel,
        MonitorAgent,
        MonitorServer,
        event_to_dict,
        events_from_outputs,
        monitor_follow,
    )
    from cilium_tpu_torch.runtime.metrics import METRICS
    from cilium_tpu_torch.runtime.tracing import TRACER

    t_phase = time.perf_counter()
    noted, launches, rates, report = {}, {}, {}, {"card": card}
    # a replay traces every chunk, as the tracer's defaults do (phase
    # 16's service tool turns the process's tracer off)
    tracer0 = (TRACER.enabled, TRACER.sample_rate)
    TRACER.configure(enabled=True, sample_rate=1.0)
    # every engine this phase stages takes the gather arm, as phase 8's
    # loader engine did
    os.environ["CILIUM_TPU_DFA_IMPL"] = "gather"
    # a short directory: unix socket paths stay under 108 bytes
    tmp = tempfile.mkdtemp(prefix="cs17")
    try:
        paths, report["write_s"] = observe_captures(tmp, flows)
        log(f"[observe] {OBSERVE_RECORDS} records written as flowpb, JSONL "
            f"and binary v2 in " + ", ".join(
                f"{k} {v:.2f} s" for k, v in report["write_s"].items()))
        lines = accesslog_lines(flows)
        with kernel_launches_noted(noted):
            reset_counts()
            c0 = counts()
            # -- 17a: flowpb → cursor → the card → the fan-out, with every
            # consumer attached
            recorder = _SeqRecorder()
            observer = Observer(handlers=[
                FlowMetrics(), FlowExporter(os.path.join(tmp, "flows.jsonl")),
                recorder])
            monitor = MonitorAgent()
            hub = HubbleServer(observer, os.path.join(tmp, "hubble.sock"))
            mon = MonitorServer(monitor, os.path.join(tmp, "monitor.sock"))
            al = AccessLogServer(observer, os.path.join(tmp, "al.sock"))
            streams, threads, errors = {}, [], []
            follower = HubbleClient(hub.socket_path)
            followed = []
            try:
                hub.start()
                mon.start()
                al.start()

                def follow():
                    try:
                        for d in follower.get_flows(
                                follow=True, timeout=OBSERVE_CATCH_UP_S,
                                since_seq=0):
                            followed.append((follower.last_seq, d))
                    except (ConnectionError, OSError):
                        pass            # closed once it caught up
                    except Exception as e:  # noqa: BLE001
                        errors.append(repr(e))

                got_ev = {}
                for level in ("medium", "maximum"):
                    streams[level] = monitor_follow(mon.socket_path,
                                                    level=level)
                    got_ev[level] = []
                    threads.append(threading.Thread(
                        target=monitor_reader,
                        args=(streams[level], got_ev[level], errors)))
                threads.append(threading.Thread(target=follow))
                for t in threads:
                    t.start()
                _wait_until(lambda: mon.num_clients() == 2,
                            "the monitor subscribers")

                def feed_accesslog():
                    import socket as _socket

                    try:
                        with _socket.socket(_socket.AF_UNIX,
                                            _socket.SOCK_STREAM) as s:
                            s.connect(al.socket_path)
                            for lo in range(0, len(lines), 100):
                                s.sendall(("\n".join(lines[lo:lo + 100])
                                           + "\n").encode())
                                time.sleep(0.02)
                    except Exception as e:  # noqa: BLE001
                        errors.append(repr(e))

                al0 = METRICS.get("cilium_tpu_accesslog_records_total")
                feeder = threading.Thread(target=feed_accesslog)
                cursor = ReplayCursor(os.path.join(tmp, "cursor.json"),
                                      paths["flowpb"])
                stages = {}
                t0 = time.perf_counter()
                feeder.start()

                mix, _, kept = fan_out_pass(
                    engine, replay_chunks(paths["flowpb"], chunk_size=BATCH,
                                          cursor=cursor),
                    monitor, observer, stages, cursor)
                torch.cuda.synchronize()
                rates["flowpb"] = OBSERVE_RECORDS / (time.perf_counter() - t0)
                check(cursor.load() == OBSERVE_RECORDS,
                      f"[observe] the cursor stands at {cursor.load()}")
                feeder.join(timeout=OBSERVE_CATCH_UP_S)
                _wait_until(lambda: METRICS.get(
                    "cilium_tpu_accesslog_records_total") - al0
                    == OBSERVE_ACCESSLOG, "the access-log records")
                total = OBSERVE_RECORDS + OBSERVE_ACCESSLOG
                check(observer.seen == total,
                      f"[observe] the observer saw {observer.seen}, not "
                      f"{total}")
                _wait_until(lambda: follower.last_seq == total - 1,
                            "the Hubble follower")
                follower.close()
                # the monitor followers: what each read plus what its
                # queue dropped is every event at its level
                want_ev = {lv: [] for lv in got_ev}
                for chunk, out in kept:
                    for lv in want_ev:
                        want_ev[lv] += [
                            {k: v for k, v in event_to_dict(e).items()
                             if k != "ts"}
                            for e in events_from_outputs(
                                chunk, out, AggregationLevel[lv.upper()])]
                clients = {c.level: c for c in list(mon._clients)}
                subs = {}
                for lv in got_ev:
                    c = clients[int(AggregationLevel[lv.upper()])]
                    _wait_until(lambda: len(got_ev[lv]) + c.lost
                                == len(want_ev[lv]),
                                f"the {lv} monitor subscriber")
                    it = iter(want_ev[lv])
                    check(all(any({k: v for k, v in e.items() if k != "ts"}
                                  == w for w in it) for e in got_ev[lv]),
                          f"[observe] the {lv} subscriber's events are not "
                          f"events_from_outputs' at its level, in order")
                    subs[lv] = {"received": len(got_ev[lv]), "lost": c.lost,
                                "expected": len(want_ev[lv])}
                # filtered queries against the same filter on the ring
                q = HubbleClient(hub.socket_path)
                filtered = {}
                for name, flt in (
                        ("dropped", FlowFilter(verdict=Verdict.DROPPED)),
                        ("path", FlowFilter(http_path=OBSERVE_FILTER_PATH)),
                        ("both", FlowFilter(verdict=Verdict.DROPPED,
                                            http_path=OBSERVE_FILTER_PATH))):
                    got_q = list(q.get_flows(flt=filter_to_dict(flt)))
                    want_q = [flow_to_dict(f)
                              for f in observer.get_flows(flt=flt)]
                    check(got_q == want_q and len(got_q) > 0,
                          f"[observe] the {name} get_flows returned "
                          f"{len(got_q)} flows, the ring's filter "
                          f"{len(want_q)}")
                    filtered[name] = len(got_q)
                status = q.server_status()
            finally:
                follower.close()
                for s in streams.values():
                    s.close()
                al.stop()
                mon.stop()
                hub.stop()
                for h in observer.handlers:
                    if hasattr(h, "close"):
                        h.close()
                for t in threads:
                    t.join(timeout=10)
            check(not errors, f"[observe] consumer errors: {errors}")
            check(status["seen"] == total,
                  f"[observe] server_status seen {status['seen']}")
            lost = observer.lost_reported
            check(len(followed) + lost == total,
                  f"[observe] the follower got {len(followed)} flows and "
                  f"{lost} lost of {total}")
            check(all(flow_to_dict(recorder.flows[s]) == d
                      for s, d in followed),
                  "[observe] a followed flow differs from the card pass's "
                  "annotated flow at its seq")
            check(all(f.trace_id for c, _ in kept for f in c),
                  "[observe] an annotated flow without its trace id")
            # the server's serialization of one chunk (flow_to_dict and
            # the JSON line a get_flows stream sends)
            t1 = time.perf_counter()
            for s, f in enumerate(kept[0][0]):
                json.dumps({"flow": flow_to_dict(f), "seq": s})
            serialize_ms = (time.perf_counter() - t1) * 1e3
            launches["observe-flowpb"] = _count_delta(c0)
            report["flowpb"] = {
                "mix": mix.tolist(), "stage_ms_per_chunk": {
                    k: statistics.mean(v) for k, v in stages.items()},
                "serialize_ms_per_chunk": serialize_ms,
                "follower": {"received": len(followed), "lost": lost},
                "monitor_subscribers": subs,
                "filtered": filtered, "seen": status["seen"],
                "accesslog_records": OBSERVE_ACCESSLOG}
            log(f"[observe flowpb] {rates['flowpb']:.0f} records/s end to "
                f"end; host ms a chunk " + ", ".join(
                    f"{k} {v:.1f}" for k, v in
                    report["flowpb"]["stage_ms_per_chunk"].items())
                + f", server serialization {serialize_ms:.1f}; follower "
                f"{len(followed)} received + {lost} lost = {total}; "
                f"monitor {subs}; filtered {filtered}; mix {mix.tolist()}; "
                f"launches {launches['observe-flowpb']} on {card}")
            report["plain"] = observe_cpu_hold(engine, paths["flowpb"], tmp)

            # -- 17b: the same capture under nfa-bitset, verdicts only
            c1 = counts()
            nfa = TorchVerdictEngine(engine.policy, device=DEVICE,
                                     cfg=dataclasses.replace(
                                         engine.cfg, kernel_impl="nfa-bitset"))
            t0 = time.perf_counter()
            nfa_mix = sum(_mix(nfa.verdict_flows(
                c, authed_pairs=AUTH_UNENFORCED)) for _, c in replay_chunks(
                    paths["flowpb"], chunk_size=BATCH))
            torch.cuda.synchronize()
            rates["flowpb-nfa-bitset"] = OBSERVE_RECORDS / (
                time.perf_counter() - t0)
            launches["observe-nfa-bitset"] = _count_delta(c1)
            check(launches["observe-nfa-bitset"]["K1"] > 0,
                  "[observe nfa-bitset] K1 never launched")
            check(nfa_mix.tolist() == mix.tolist(),
                  f"[observe nfa-bitset] verdict counts {nfa_mix.tolist()} "
                  f"against auto's {mix.tolist()}")

            # -- 17c: JSONL through the same object path; binary v2
            # through replay_chunks(decode=False) into CaptureReplay
            # (no socket attached: its stage split is the fan-out's
            # without the consumers' threads)
            c2 = counts()
            jobs = Observer(handlers=[FlowMetrics()])
            jstages = {}
            t0 = time.perf_counter()
            jmix, _, _ = fan_out_pass(engine, replay_chunks(
                paths["jsonl"], chunk_size=BATCH), MonitorAgent(), jobs,
                jstages)
            torch.cuda.synchronize()
            rates["jsonl"] = OBSERVE_RECORDS / (time.perf_counter() - t0)
            launches["observe-jsonl"] = _count_delta(c2)
            report["jsonl"] = {"stage_ms_per_chunk": {
                k: statistics.mean(v) for k, v in jstages.items()}}
            log(f"[observe jsonl] {rates['jsonl']:.0f} records/s end to "
                f"end, no socket attached; host ms a chunk " + ", ".join(
                    f"{k} {v:.1f}" for k, v in
                    report["jsonl"]["stage_ms_per_chunk"].items())
                + f" on {card}")
            c3 = counts()
            t0 = time.perf_counter()
            session, bmix = None, np.zeros(8, dtype=np.int64)
            for _, raw in replay_chunks(paths["binary"], chunk_size=BATCH,
                                        decode=False):
                if session is None:
                    # as cmd_replay --fast builds it from the first chunk
                    session = CaptureReplay(engine, raw.l7_all, raw.offsets,
                                            raw.blob, engine.cfg,
                                            gen=raw.gen_all)
                    session.stage_rows(raw.records_all, raw.l7_all)
                    session.stage_unique(engine.cfg.stage_unique_drop_ratio)
                bmix += _mix(session.verdict_chunk(
                    raw.records, raw.l7, authed_pairs=AUTH_UNENFORCED,
                    start=raw.start))
            torch.cuda.synchronize()
            rates["binary"] = OBSERVE_RECORDS / (time.perf_counter() - t0)
            launches["observe-binary"] = _count_delta(c3)
            for fmt, m in (("jsonl", jmix), ("binary", bmix)):
                check(m.tolist() == mix.tolist(),
                      f"[observe {fmt}] verdict counts {m.tolist()} against "
                      f"flowpb's {mix.tolist()}")

            # -- 17d: killed after OBSERVE_KILL_AFTER committed chunks
            # with one more processed and not committed, then resumed
            c4 = counts()
            kcur = ReplayCursor(os.path.join(tmp, "kill.json"),
                                paths["flowpb"])
            done = np.zeros(8, dtype=np.int64)
            for n, (idx, chunk) in enumerate(replay_chunks(
                    paths["flowpb"], chunk_size=BATCH, cursor=kcur)):
                out = _mix(engine.verdict_flows(
                    chunk, authed_pairs=AUTH_UNENFORCED))
                if n == OBSERVE_KILL_AFTER:
                    break                   # killed before the commit
                done += out
                kcur.commit(idx)
            resumed_at = kcur.load()
            runs = 0
            for idx, chunk in replay_chunks(paths["flowpb"],
                                            chunk_size=BATCH, cursor=kcur):
                done += _mix(engine.verdict_flows(
                    chunk, authed_pairs=AUTH_UNENFORCED))
                kcur.commit(idx)
                runs += 1
            launches["observe-resume"] = _count_delta(c4)
            check(resumed_at == OBSERVE_KILL_AFTER * BATCH
                  and done.tolist() == mix.tolist()
                  and kcur.load() == OBSERVE_RECORDS,
                  f"[observe resume] resumed at {resumed_at}, counts "
                  f"{done.tolist()} against {mix.tolist()}")
            phase, variants = counts(), kd_variants()
    finally:
        import shutil

        TRACER.configure(enabled=tracer0[0], sample_rate=tracer0[1])
        shutil.rmtree(tmp, ignore_errors=True)
    for kid in ("KD", "K1"):
        check(phase[kid] > 0, f"[observe] {kid} never launched in phase 17")
    report.update({
        "records": OBSERVE_RECORDS, "chunk": BATCH,
        "records_per_s": rates, "mix": mix.tolist(),
        "launches": launches, "phase_launches": phase,
        "resume": {"resumed_at": resumed_at, "chunks_after": runs},
        "wall_s": time.perf_counter() - t_phase})
    log(f"[observe] records/s: " + ", ".join(
        f"{k} {v:.0f}" for k, v in rates.items()) + f"; verdict counts equal "
        f"across flowpb, JSONL, binary, nfa-bitset and the resumed replay "
        f"(resumed at {resumed_at}, {runs} chunks after); phase launches "
        f"{phase} on {card}")
    return report, phase, variants, noted


# ------------------------------------------------------------- phase 18
#: phase 18: the node-local agent at the http scenario (N_RULES x
#: N_FLOWS in batches of BATCH, uncut), driven as an operator drives it:
#: endpoints and policy in over REST, verdicts out of ``process_flows``.
#: Cut in iterations only: the label pairs the trace samples, each REST
#: op's timed repetitions (p50/p99; the auth put/delete cycles and the
#: re-PUTs of the auth policy among them), the gate's off/on round trips,
#: the timed ``process_flows`` passes over the scenario, the bystander
#: endpoints PUT beside the scenario's (samples of the PUT's latency),
#: the flows the CPU oracle verdicts while the gate is off (0.8 ms a flow
#: at 1000 rules on the card's host), the served chunk ``/v1/explain``
#: reads, and the profile windows
AGENT_TRACE_PAIRS, AGENT_REST_REPS, AGENT_PASSES = 32, 50, 10
AGENT_GATE_ROUNDS = 5
AGENT_BYSTANDERS, AGENT_ORACLE_SAMPLE, AGENT_EXPLAIN_FLOWS = 8, 64, 4
AGENT_PROFILE_S, AGENT_HOST_PROFILE_S = 1.0, 0.5
#: the CNI plugin's network configuration on its standard input
AGENT_NETCONF = json.dumps({"cniVersion": "1.0.0", "name": "cilium-tpu",
                            "type": "cilium-tpu-cni"})


def span_sums():
    """The loader's and the endpoint manager's span totals (s) and the
    regenerations counted so far."""
    from cilium_tpu_torch.runtime.metrics import METRICS

    out = {s: METRICS.histo_sum("cilium_tpu_span_seconds", {"span": s})
           for s in ("endpoint_regeneration", "policy_compile",
                     "policy_stage")}
    out["regenerations"] = METRICS.histo_count(
        "cilium_tpu_span_seconds", {"span": "endpoint_regeneration"})
    return out


def cni_exec(command, api_sock, container, cwd):
    """The CNI plugin as the container runtime execs it:
    ``python -m cilium_tpu_torch.cni`` with the ``CNI_*`` environment
    and the netconf on standard input → (rc, result, wall s)."""
    env = {k: v for k, v in os.environ.items()
           if k in ("PATH", "HOME", "TMPDIR", "LANG")}
    env.update({"CNI_COMMAND": command, "CNI_CONTAINERID": container,
                "CNI_IFNAME": "eth0", "CNI_NETNS": "/var/run/netns/cs18",
                "CNI_ARGS": "K8S_POD_NAMESPACE=default;K8S_POD_NAME=cs18-0",
                "CILIUM_TPU_API_SOCKET": api_sock})
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "cilium_tpu_torch.cni"],
                       input=AGENT_NETCONF, capture_output=True, text=True,
                       env=env, cwd=cwd, timeout=120)
    wall = time.perf_counter() - t0
    check(p.stdout.strip() != "", f"[agent cni] {command} printed nothing "
          f"(rc {p.returncode}): {p.stderr[-500:]}")
    return p.returncode, json.loads(p.stdout), wall


def agent_phase(card):
    """Phase 18 (see the module docstring) → (report, the phase's
    launches, KD's launches by variant, the launch shapes noted)."""
    import ipaddress
    import shutil
    import tempfile
    import threading

    import numpy as np

    from cilium_tpu_torch import cni
    from cilium_tpu_torch.agent import Agent
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.core.flow import (
        Flow,
        Protocol,
        TrafficDirection,
        Verdict,
    )
    from cilium_tpu_torch.core.labels import LabelSet
    from cilium_tpu_torch.endpoint import with_cluster_label
    from cilium_tpu_torch.engine.verdict import (
        OUTPUT_LANES,
        TorchVerdictEngine,
    )
    from cilium_tpu_torch.ingest import synth
    from cilium_tpu_torch.ingest.binary import (
        capture_from_bytes,
        capture_to_bytes,
    )
    from cilium_tpu_torch.ingest.hubble import flow_to_dict
    from cilium_tpu_torch.policy.api.cnp import CiliumNetworkPolicy
    from cilium_tpu_torch.policy.trace import trace
    from cilium_tpu_torch.runtime.api import APIClient
    from cilium_tpu_torch.runtime.explain import EXPLAIN, resolve_explain
    from cilium_tpu_torch.runtime.serveloop import ServeLoop
    from cilium_tpu_torch.runtime.service import VerdictClient
    from cilium_tpu_torch.runtime.tracing import TRACER

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    noted, rest, report = {}, {}, {"card": card, "rules": N_RULES,
                                   "flows": N_FLOWS, "batch": BATCH}

    def timed(op, fn, *a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        rest.setdefault(op, []).append(time.perf_counter() - t0)
        return r

    # the agent's engines take the gather arm, as phase 8's loader did;
    # its service traces every request, as the tracer's defaults do
    os.environ["CILIUM_TPU_DFA_IMPL"] = "gather"
    tracer0 = (TRACER.enabled, TRACER.sample_rate)
    TRACER.configure(enabled=True, sample_rate=1.0)
    # a short directory: unix socket paths stay under 108 bytes
    tmp = tempfile.mkdtemp(prefix="cs18")
    socks = {k: os.path.join(tmp, f"{k}.sock")
             for k in ("api", "svc", "mon", "hub")}
    sc = synth.synth_http_scenario(N_RULES, N_FLOWS)
    flows = sc.flows
    cfg = Config.from_env()
    cfg.configure_logging = False
    cfg.loader.cache_dir = os.path.join(tmp, "cache")
    agent = None
    try:
        with kernel_launches_noted(noted):
            reset_counts()
            c0 = counts()
            # -- 18a: the agent with its sockets
            t0 = time.perf_counter()
            agent = Agent(cfg, device=DEVICE, socket_path=socks["svc"],
                          api_socket_path=socks["api"],
                          monitor_socket_path=socks["mon"],
                          hubble_socket_path=socks["hub"]).start()
            report["start_ms"] = (time.perf_counter() - t0) * 1e3
            check(agent.device.type == DEVICE
                  and agent.loader.device.type == DEVICE
                  and agent.dns_proxy.device.type == DEVICE,
                  f"[agent] the agent, its loader and its DNS proxy must "
                  f"run on {DEVICE}")
            client = APIClient(socks["api"])
            pod_cidr = ipaddress.ip_network(cfg.pod_cidr)

            # -- 18b: endpoints over REST (IPs from IPAM), the 1000 rules
            # in process, the auth policy as YAML over REST
            ids, labels_of = {}, {}
            eps = [(name, dict(lbl)) for name, lbl in
                   sorted(sc.endpoints.items())]
            ns = {"io.kubernetes.pod.namespace": "default"}
            eps += [("checkout", dict(ns, app="checkout")),
                    ("payments", dict(ns, app="payments"))]
            eps += [(f"bystander{i}", {"app": f"bystander{i}"})
                    for i in range(AGENT_BYSTANDERS)]
            for i, (name, lbl) in enumerate(eps):
                code, ep = timed("PUT /v1/endpoint", client.endpoint_put,
                                 100 + i, lbl)
                check(code == 201 and ipaddress.ip_address(ep["ipv4"])
                      in pod_cidr, f"[agent] PUT /v1/endpoint {name}: "
                      f"{code} {ep}")
                ids[name], labels_of[name] = ep["identity"], ep["labels"]
            agent.endpoint_manager.regenerate_all(wait=True)
            s0 = span_sums()
            t0 = time.perf_counter()
            agent.policy_add(CiliumNetworkPolicy(
                name="synth-http", namespace="default",
                rules=tuple(sc.rules)))
            wall = time.perf_counter() - t0
            s1 = span_sums()
            d = {k: s1[k] - s0[k] for k in s1}
            report["regeneration"] = {
                "wall_ms": wall * 1e3,
                "regenerations": d["regenerations"],
                "regeneration_ms": d["endpoint_regeneration"] * 1e3,
                "compile_ms": d["policy_compile"] * 1e3,
                "stage_ms": d["policy_stage"] * 1e3,
                # the rest of the regeneration span: the resolve, the
                # proxy ports and the DNS proxy's allow-sets
                "resolve_ms": (d["endpoint_regeneration"]
                               - d["policy_compile"]
                               - d["policy_stage"]) * 1e3}
            with open(os.path.join(here, "examples", "policies", "l7",
                                   "auth-required.yaml")) as fp:
                auth_yaml = fp.read()
            code, body = timed("PUT /v1/policy", client.policy_put_yaml,
                               auth_yaml)
            check(code == 200 and body["count"] == 1,
                  f"[agent] PUT /v1/policy: {code} {body}")
            health = timed("GET /v1/healthz", client.healthz)
            check(health["status"] == "ok" and health["engine_revision"] > 0,
                  f"[agent] healthz {health}")
            engine = agent.loader.engine
            check(isinstance(engine, TorchVerdictEngine)
                  and engine.device.type == DEVICE,
                  f"[agent] the served engine is {type(engine).__name__}")
            report["path_stack"] = list(
                engine.policy.arrays["path_trans"].shape)
            log(f"[agent] {len(eps)} endpoints over REST, {N_RULES} rules "
                f"and auth-required.yaml: one regeneration "
                f"{report['regeneration']['regeneration_ms']:.1f} ms (compile "
                f"{report['regeneration']['compile_ms']:.1f}, stage "
                f"{report['regeneration']['stage_ms']:.1f}, resolve and the "
                f"rest {report['regeneration']['resolve_ms']:.1f}); engine "
                f"revision {health['engine_revision']}, path stack "
                f"{tuple(report['path_stack'])}")

            # -- 18c: process_flows, all ten lanes against a plain engine
            for f in flows:
                f.src_identity, f.dst_identity = ids["client"], ids["server"]
            batches = [flows[lo:lo + BATCH]
                       for lo in range(0, len(flows), BATCH)]
            plain = TorchVerdictEngine(engine.policy, device="cpu",
                                       cfg=engine.cfg)
            card_out = []
            for k, b in enumerate(batches):
                got = agent.process_flows(b)
                want = plain.verdict_flows(
                    b, authed_pairs=agent.auth.pairs_array())
                assert_lanes(f"[agent] process_flows batch {k}", got, want)
                card_out.append(got)
            mix = np.bincount(np.concatenate(
                [o["verdict"] for o in card_out]), minlength=6).tolist()
            check(mix[int(Verdict.DROPPED)] > 0
                  and mix[int(Verdict.REDIRECTED)] > 0,
                  f"[agent] implausible verdict mix {mix}")
            host = []
            for _ in range(AGENT_PASSES):
                for b in batches:
                    t0 = time.perf_counter()
                    agent.process_flows(b)
                    host.append(time.perf_counter() - t0)
            kern = profile_kernels(lambda: agent.process_flows(batches[0]),
                                   reps=1)
            report["process_flows"] = {
                "batches": len(batches), "mix": mix,
                "host_ms": quantiles_ms(host),
                "device_ms": sum(ms for _, ms in kern.values()) or None,
                "device_kernels": sum(n for n, _ in kern.values()),
                "kd_in_trace": any("dfa_dense_kernel" in k for k in kern)}
            log(f"[agent] process_flows: ten lanes equal to the plain "
                f"engine on {len(batches)} batches; mix {mix}; a batch of "
                f"{BATCH} host p50 "
                f"{report['process_flows']['host_ms']['p50_ms']:.2f} ms, "
                f"device {report['process_flows']['device_ms']} ms in "
                f"{report['process_flows']['device_kernels']} kernels")

            # -- 18d: mutual auth through the REST face
            pay = Flow(src_identity=ids["checkout"],
                       dst_identity=ids["payments"], dport=8443,
                       protocol=Protocol.TCP,
                       direction=TrafficDirection.INGRESS)
            states = []
            for step in ("before", "put", "delete"):
                if step == "put":
                    code, _ = timed("PUT /v1/auth", client.auth_put,
                                    ids["checkout"], ids["payments"])
                    check(code == 201, f"[agent] PUT /v1/auth: {code}")
                elif step == "delete":
                    code, body = timed("DELETE /v1/auth", client.auth_delete,
                                       ids["checkout"], ids["payments"])
                    check(code == 200 and body["deleted"],
                          f"[agent] DELETE /v1/auth: {code} {body}")
                got = agent.process_flows([pay])
                assert_lanes(f"[agent] auth {step}", got, plain.verdict_flows(
                    [pay], authed_pairs=agent.auth.pairs_array()))
                states.append((int(got["verdict"][0]),
                               bool(got["auth_required"][0])))
            check(states == [(2, True), (1, True), (2, True)],
                  f"[agent] checkout -> payments:8443 before / after PUT / "
                  f"after DELETE /v1/auth: {states}")
            report["auth"] = states
            for _ in range(AGENT_REST_REPS - 1):
                timed("PUT /v1/auth", client.auth_put, ids["checkout"],
                      ids["payments"])
                timed("DELETE /v1/auth", client.auth_delete,
                      ids["checkout"], ids["payments"])
            check(not agent.auth.is_authed(ids["checkout"],
                                           ids["payments"]),
                  "[agent] the auth cycles left the pair authed")

            # -- 18e: REST answers equal the in-process calls
            names = [n for n, _ in eps]
            pairs = [(a, b) for a in names for b in names if a != b]
            rng = np.random.default_rng(18)
            pick = rng.choice(len(pairs), size=min(AGENT_TRACE_PAIRS,
                                                   len(pairs)),
                              replace=False)
            verdicts = []
            for i, j in enumerate(pick):
                a, b = pairs[j]
                dport = (80, 8443)[i % 2]
                got = timed("PUT /v1/policy/trace", client.policy_trace,
                            labels_of[a], labels_of[b], dport=dport)
                want = trace(
                    agent.repo,
                    with_cluster_label(LabelSet.parse(labels_of[a]),
                                       cfg.cluster_name),
                    with_cluster_label(LabelSet.parse(labels_of[b]),
                                       cfg.cluster_name),
                    dport=dport, cluster_name=cfg.cluster_name)
                check(got == json.loads(json.dumps(want)),
                      f"[agent] trace {a} -> {b}:{dport} over REST {got} "
                      f"!= in process {want}")
                verdicts.append(got["verdict"])
            check({"ALLOWED", "DENIED"} <= set(verdicts),
                  f"[agent] the trace sample saw only {set(verdicts)}")
            tid = "18a9e1d7c0ffee18"
            EXPLAIN.clear()
            loop = ServeLoop(agent.loader, capacity=8, lease_ttl_s=60.0,
                             pack_interval_s=0.01)
            lease = loop.connect("cs18")
            with TRACER.trace("stream.chunk", trace_id=tid):
                ticket = loop.submit(lease, *capture_from_bytes(
                    capture_to_bytes(flows[:AGENT_EXPLAIN_FLOWS])))
            loop.step()
            check(ticket.done, "[agent] the traced chunk was not served")
            code, got = timed("GET /v1/explain", client.request, "GET",
                              f"/v1/explain?trace_id={tid}")
            want = json.loads(json.dumps(resolve_explain(agent.loader, tid),
                                         default=str))
            check(code == 200 and got == want and got["found"]
                  and got.get("served_equals_fresh") is not False,
                  f"[agent] GET /v1/explain {code}: REST and in-process "
                  f"answers differ or were not found")
            for _ in range(AGENT_REST_REPS):
                timed("GET /v1/healthz", client.healthz)
                timed("GET /v1/endpoint", client.endpoints)
                timed("GET /v1/policy", client.policy_get)
                timed("GET /v1/debuginfo", client.debuginfo)
                timed("GET /v1/explain", client.request, "GET",
                      f"/v1/explain?trace_id={tid}")
                a, b = pairs[pick[0]]
                timed("PUT /v1/policy/trace", client.policy_trace,
                      labels_of[a], labels_of[b], dport=80)
            # re-PUTs of the auth policy: an upsert and one regeneration
            # each, the served revision moving on
            rev0 = agent.loader.revision
            for _ in range(AGENT_REST_REPS - 1):
                code, _ = timed("PUT /v1/policy", client.policy_put_yaml,
                                auth_yaml)
                check(code == 200, f"[agent] re-PUT /v1/policy: {code}")
            check(agent.loader.revision > rev0
                  and len(agent.repo.rules()) == 2,
                  f"[agent] re-PUTs: revision {rev0} -> "
                  f"{agent.loader.revision}, "
                  f"{len(agent.repo.rules())} rules")
            # the gate off (the CPU oracle) and back on (the card)
            sample = flows[:AGENT_ORACLE_SAMPLE]
            code, _ = timed("PATCH /v1/config", client.patch_config,
                            enable_tpu_offload=False)
            check(code == 200 and not isinstance(agent.loader.engine,
                                                 TorchVerdictEngine)
                  and not agent.dns_proxy.use_tpu,
                  f"[agent] PATCH off: {code}, "
                  f"{type(agent.loader.engine).__name__}")
            t0 = time.perf_counter()
            oracle = agent.process_flows(sample)
            report["oracle_ms_a_flow"] = \
                (time.perf_counter() - t0) * 1e3 / len(sample)
            check(np.array_equal(oracle["verdict"],
                                 card_out[0]["verdict"][:len(sample)]),
                  "[agent] the oracle's verdicts differ from the card's")
            code, _ = timed("PATCH /v1/config", client.patch_config,
                            enable_tpu_offload=True)
            engine = agent.loader.engine
            check(code == 200 and isinstance(engine, TorchVerdictEngine)
                  and engine.device.type == DEVICE and agent.dns_proxy.use_tpu,
                  f"[agent] PATCH on: {code}, {type(engine).__name__}")
            kd0 = counts()["KD"]
            assert_lanes("[agent] after the gate's round trip",
                         agent.process_flows(batches[0]), card_out[0])
            check(counts()["KD"] > kd0 or DEVICE == "cpu",
                  "[agent] KD did not launch after PATCH back on")
            for _ in range(AGENT_GATE_ROUNDS - 1):
                for on in (False, True):
                    code, _ = timed("PATCH /v1/config", client.patch_config,
                                    enable_tpu_offload=on)
                    check(code == 200 and isinstance(
                        agent.loader.engine, TorchVerdictEngine) == on,
                        f"[agent] PATCH {on}: {code}")
            check(agent.loader.engine.device.type == DEVICE,
                  "[agent] the gate's round trips left the card")

            # -- 18f: the profiler over REST while process_flows runs
            stop = threading.Event()
            drove = []

            def drive():
                while not stop.is_set():
                    agent.process_flows(batches[0])
                    drove.append(1)

            prof = {}
            for mode, secs in (("device", AGENT_PROFILE_S),
                               ("host", AGENT_HOST_PROFILE_S)):
                if mode == "device" and DEVICE == "cpu":
                    continue  # a CPU rehearsal: device mode needs CUDA
                stop.clear()
                t = threading.Thread(target=drive)
                t.start()
                try:
                    time.sleep(0.2)  # the thread is inside process_flows
                    code, body = timed(
                        f"PUT /v1/profile {mode}", client.request, "PUT",
                        "/v1/profile",
                        {"mode": mode, "seconds": secs,
                         "out": os.path.join(tmp, f"prof-{mode}")})
                finally:
                    stop.set()
                    t.join(timeout=120)
                check(code == 200, f"[agent] PUT /v1/profile {mode}: "
                      f"{code} {body}")
                with open(body["path"]) as fp:
                    text = fp.read()
                if mode == "device":
                    names = {e.get("name", "") for e in
                             json.loads(text).get("traceEvents", [])}
                    hit = any("dfa_dense_kernel" in n for n in names)
                    check(hit or DEVICE == "cpu",
                          "[agent] the device profile names no KD kernel")
                    prof[mode] = {"events": len(names), "kd": hit,
                                  "kernels": [k for k in body.get(
                                      "device_events", ())
                                      if "dfa_" in k or "nfa_" in k]}
                else:
                    check("process_flows" in text,
                          "[agent] the host profile's stacks lack "
                          "process_flows")
                    prof[mode] = {"samples": body["samples"],
                                  "stacks": body["distinct_stacks"]}
            prof["batches_beside"] = len(drove)
            report["profile"] = prof

            # -- 18g: the service's agent ops, the CNI plugin, the drain
            svc = VerdictClient(socks["svc"])
            try:
                got = svc.call({"op": "policy_get"})
                check(len(got["rules"]) == len(agent.repo.rules()),
                      f"[agent] service policy_get: {str(got)[:200]}")
                got = svc.call({"op": "status"})
                check(got.get("engine_revision") == agent.loader.revision
                      and "banks" in got and "ipam" in got,
                      f"[agent] service status: {str(got)[:200]}")
                got = svc.call({"op": "profile", "mode": "host",
                                "seconds": 0.2,
                                "out": os.path.join(tmp, "prof-svc")})
                check(got.get("mode") == "host",
                      f"[agent] service profile: {got}")
                events = []
                agent.monitor.subscribe(events.append)
                bulk = flows[:256]
                got = svc.call({"op": "verdict",
                                "flows": [flow_to_dict(f) for f in bulk]})
                agent.monitor.unsubscribe(events.append)
                check(got["verdicts"] == card_out[0]["verdict"][:256]
                      .tolist() and len(events) > 0,
                      f"[agent] bulk verdict: {len(events)} monitor events")
                report["service"] = {"bulk_events": len(events)}
            finally:
                svc.close()
            container = "chip-smoke-cs18"
            cni_out = {}
            for command in ("ADD", "CHECK", "DEL"):
                rc, res, wall = cni_exec(command, socks["api"], container,
                                         here)
                check(rc == 0, f"[agent cni] {command}: rc {rc} {res}")
                cni_out[command] = {"wall_ms": wall * 1e3}
                if command == "ADD":
                    ip = res["ips"][0]["address"].split("/")[0]
                    ep = agent.endpoint_manager.get(
                        cni.endpoint_id_for(container))
                    check(ep is not None and ep.ipv4 == ip
                          and ipaddress.ip_address(ip) in pod_cidr,
                          f"[agent cni] ADD {res}")
            check(agent.endpoint_manager.get(
                cni.endpoint_id_for(container)) is None,
                "[agent cni] DEL left the endpoint")
            # the plugin's work apart from the interpreter's start
            import io

            env = {"CNI_COMMAND": "ADD", "CNI_CONTAINERID": container + "-b",
                   "CILIUM_TPU_API_SOCKET": socks["api"]}
            t0 = time.perf_counter()
            rc = cni.main(env=env, stdin=io.StringIO(AGENT_NETCONF),
                          stdout=io.StringIO())
            cni_out["ADD_in_process_ms"] = (time.perf_counter() - t0) * 1e3
            check(rc == 0, "[agent cni] in-process ADD")
            report["cni"] = cni_out
            code, body = timed("POST /v1/drain", client.drain)
            check(code == 200 and body["ok"],
                  f"[agent] POST /v1/drain: {code} {body}")
            launches = _count_delta(c0)
            variants = kd_variants()
    finally:
        if agent is not None:
            agent.stop()
        TRACER.configure(enabled=tracer0[0], sample_rate=tracer0[1])
        shutil.rmtree(tmp, ignore_errors=True)
    check(launches["KD"] > 0 or DEVICE == "cpu",
          "[agent] KD never launched in phase 18")
    report["rest"] = {op: quantiles_ms(s) for op, s in sorted(rest.items())}
    report["launches"] = launches
    report["kd_variants"] = variants
    report["wall_s"] = time.perf_counter() - t_phase
    log(f"[agent] REST p50/p99 ms: " + "; ".join(
        f"{op} {q['p50_ms']:.2f}/{q['p99_ms']:.2f}"
        for op, q in report["rest"].items()))
    log(f"[agent] CNI ADD {cni_out['ADD']['wall_ms']:.1f} ms as a process "
        f"({cni_out['ADD_in_process_ms']:.1f} ms in process); launches "
        f"{launches} on {card}")
    return report, launches, variants, noted


# ------------------------------------------------------------- phase 19
#: phase 19: the cluster control services at the http scenario (N_RULES x
#: N_FLOWS in batches of BATCH, ``Config.from_env()``, uncut in shape):
#: the kvstore, the apiserver, two operators and the live relay as OS
#: processes, two agents on the card in this process. Cut in iterations
#: only: the timed ``process_flows`` passes a node (5), and the
#: operators' election TTL (2 s, from the operator's 15 s default: the
#: standby's takeover waits out at most one TTL)
CLUSTER_PASSES, CLUSTER_ELECTION_TTL = 5, 2.0
CLUSTER_POOL = "10.240.0.0/16"
#: the flows each node verdicts for the relay's hold: one agent ring's
#: worth (an agent's Observer holds 4096 flows; the live relay's ring,
#: 8192, holds both nodes')
CLUSTER_RELAY_FLOWS = 4096
#: the control plane's processes, each by its module's ``main``
CLUSTER_PROCS = ("kv", "k8s", "op1", "op2", "relay")


def cuda_pids():
    """The pids ``nvidia-smi`` lists as holding a CUDA context."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi --query-compute-apps: "
          f"{r.stderr[-300:]}")
    return sorted(int(x) for x in r.stdout.split() if x.strip().isdigit())


def nvidia_fds(pid):
    """How many of a process's open files are NVIDIA device nodes
    (``/dev/nvidia*``); None when its fds cannot be read. Importing
    torch opens none of them; initialising CUDA
    (``torch.cuda.is_available()``, a context) opens them. In a
    container ``nvidia-smi`` may list process ids of another namespace,
    so this is the check that holds either way."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return None
    n = 0
    for fd in fds:
        try:
            n += os.readlink(f"/proc/{pid}/fd/{fd}").startswith(
                "/dev/nvidia")
        except OSError:
            pass
    return n


@contextlib.contextmanager
def regen_split(agents):
    """While open, each agent's regeneration spans by node: its
    ``endpoint_regeneration`` and, inside it on the same thread, the
    loader's ``policy_compile`` and ``policy_stage`` → {node: {span:
    [seconds, ...]}}. (The spans are process-wide; two agents in one
    process regenerate on their own endpoint managers' threads.)"""
    import threading

    from cilium_tpu_torch.runtime.metrics import METRICS

    local = threading.local()
    acc = {n: {} for n in agents}
    observe = METRICS.observe

    def noted(name, value, labels=None):
        node = getattr(local, "node", None)
        if node is not None and name == "cilium_tpu_span_seconds":
            acc[node].setdefault((labels or {}).get("span"), []).append(
                value)
        return observe(name, value, labels)

    def wrap(node, regen):
        def run(my_gen=0):
            local.node = node
            try:
                return regen(my_gen)
            finally:
                local.node = None
        return run

    for n, x in agents.items():
        x.endpoint_manager._regenerate = wrap(n, x.endpoint_manager._regenerate)
    METRICS.observe = noted
    try:
        yield acc
    finally:
        del METRICS.observe
        for x in agents.values():
            del x.endpoint_manager._regenerate


def cluster_phase(card):
    """Phase 19 (see the module docstring) → (report, the phase's
    launches, KD's launches by variant, the launch shapes noted)."""
    import dataclasses
    import ipaddress
    import shutil
    import signal
    import tempfile
    import threading

    import numpy as np

    from cilium_tpu_torch.agent import Agent
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.core.flow import Verdict
    from cilium_tpu_torch.core.labels import LabelSet
    from cilium_tpu_torch.endpoint import with_cluster_label
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
    from cilium_tpu_torch.hubble.server import HubbleClient
    from cilium_tpu_torch.ingest import synth
    from cilium_tpu_torch.ingest.hubble import flow_to_dict
    from cilium_tpu_torch.k8s.apiserver import K8sClient
    from cilium_tpu_torch.k8s.ces import CESBatcher
    from cilium_tpu_torch.kvstore_service import RemoteKVStore
    from cilium_tpu_torch.policy.api.cnp import parse_cnp
    from cilium_tpu_torch.runtime.leader import LEADER_PREFIX

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    noted, report = {}, {"card": card, "rules": N_RULES, "flows": N_FLOWS,
                         "batch": BATCH, "passes": CLUSTER_PASSES,
                         "election_ttl_s": CLUSTER_ELECTION_TTL}
    threads0 = set(threading.enumerate())
    # a short directory: unix socket paths stay under 108 bytes
    tmp = tempfile.mkdtemp(prefix="cs19")
    socks = {k: os.path.join(tmp, f"{k}.sock")
             for k in ("kv", "k8s", "relay", "hub-a", "hub-b")}
    procs, errs_of = {}, {}
    agents, batcher, kv = {}, None, None
    leader_key = LEADER_PREFIX + "cilium-operator"

    def spawn(name, *args):
        errs_of[name] = open(os.path.join(tmp, f"{name}.err"), "w+")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=here,
            stdout=subprocess.DEVNULL, stderr=errs_of[name])

    def proc_err(name):
        errs_of[name].seek(0)
        return errs_of[name].read()[-600:]

    def wait_for(cond, what, timeout=60.0, poll=0.002):
        deadline = time.perf_counter() + timeout
        while not cond():
            for name, p in procs.items():
                check(p.poll() is None, f"[cluster] {name} exited "
                      f"{p.returncode} while waiting for {what}: "
                      f"{proc_err(name)}")
            check(time.perf_counter() < deadline,
                  f"[cluster] {what} not within {timeout} s")
            time.sleep(poll)
        return time.perf_counter()

    def leader():
        return kv.get(leader_key)

    sc = synth.synth_http_scenario(N_RULES, N_FLOWS)
    try:
        # -- 19a: the control plane as OS processes
        t0 = time.perf_counter()
        spawn("kv", "cilium_tpu_torch.kvstore_service", socks["kv"])
        spawn("k8s", "cilium_tpu_torch.k8s.apiserver", socks["k8s"])
        wait_for(lambda: os.path.exists(socks["kv"])
                 and os.path.exists(socks["k8s"]), "the kvstore and the "
                 "apiserver sockets")
        for name in ("op1", "op2"):
            spawn(name, "cilium_tpu_torch.operator", "--kvstore",
                  socks["kv"], "--pool-cidr", CLUSTER_POOL,
                  "--leader-election", "--election-ttl",
                  str(CLUSTER_ELECTION_TTL), "--k8s-api-socket",
                  socks["k8s"])
        spawn("relay", "cilium_tpu_torch.hubble.relay", "--kvstore",
              socks["kv"], "--socket", socks["relay"], "--mode", "live")
        kv = RemoteKVStore(socks["kv"])
        wait_for(lambda: os.path.exists(socks["relay"])
                 and leader() is not None, "the relay socket and a leader")
        report["control_start_s"] = time.perf_counter() - t0
        op_pids = {procs[n].pid: n for n in ("op1", "op2")}
        lead0 = leader()
        check(lead0 in {f"operator-{pid}" for pid in op_pids},
              f"[cluster] the lock's holder {lead0} is no operator")
        log(f"[cluster] kvstore, apiserver, 2 operators and the live relay "
            f"up as processes in {report['control_start_s']:.1f} s; "
            f"leader {lead0}")

        with kernel_launches_noted(noted):
            reset_counts()
            c0 = counts()
            # -- 19b: two agents on the card
            t0 = time.perf_counter()
            for name, impl, hub in (("node-a", "auto", "hub-a"),
                                    ("node-b", "nfa-bitset", "hub-b")):
                cfg = Config.from_env()
                cfg.configure_logging = False
                cfg.node_name = name
                cfg.ipam_mode = "cluster-pool"
                cfg.identity_allocation_mode = "crd"
                cfg.k8s_api_socket = socks["k8s"]
                cfg.engine.kernel_impl = impl
                cfg.loader.cache_dir = os.path.join(tmp, f"cache-{name}")
                agents[name] = Agent(cfg, kvstore=RemoteKVStore(socks["kv"]),
                                     device=DEVICE,
                                     hubble_socket_path=socks[hub]).start()
            report["agents_start_s"] = time.perf_counter() - t0
            a, b = agents["node-a"], agents["node-b"]
            pool = ipaddress.ip_network(CLUSTER_POOL)
            cidrs = {n: str(x.ipam.cidr) for n, x in agents.items()}
            for n, x in agents.items():
                net = ipaddress.ip_network(cidrs[n])
                check(x.device.type == DEVICE
                      and x.loader.device.type == DEVICE
                      and net.prefixlen == 24 and net.subnet_of(pool),
                      f"[cluster] {n}: device {x.device}, CIDR {net}")
            check(len(set(cidrs.values())) == 2,
                  f"[cluster] the nodes share a CIDR: {cidrs}")
            report["cidrs"] = cidrs

            # -- 19c: endpoints, one identity through CiliumIdentity, the
            # rule in through the apiserver
            srv = a.endpoint_add(1, sc.endpoints["server"])
            cli = b.endpoint_add(2, sc.endpoints["client"])
            want = with_cluster_label(
                LabelSet.from_dict(sc.endpoints["server"]), "default")
            wait_for(lambda: b.allocator.lookup_by_labels(want)
                     == srv.identity, "node-b learning the server's "
                     "identity", timeout=30)
            srv_b = b.endpoint_add(3, sc.endpoints["server"])
            client = K8sClient(socks["k8s"])
            idents = client.list("ciliumidentities")["items"]
            check(srv_b.identity == srv.identity
                  and sum(o["metadata"]["name"] == str(int(srv.identity))
                          for o in idents) == 1,
                  f"[cluster] the server's labels on both nodes: "
                  f"{srv.identity} / {srv_b.identity}")
            report["identities"] = {"server": int(srv.identity),
                                    "client": int(cli.identity),
                                    "objects": len(idents)}
            doc = synth.http_rule_cnp(sc.rules[0], "synth-http")
            parsed = parse_cnp(doc)
            check(dataclasses.replace(parsed.rules[0],
                                      labels=sc.rules[0].labels)
                  == sc.rules[0], "[cluster] parse_cnp of the rendered "
                  "CNP is not the scenario's rule")
            flows_of = {n: [dataclasses.replace(
                f, src_identity=cli.identity, dst_identity=srv.identity)
                for f in sc.flows] for n in agents}
            probe = flows_of["node-a"][:64]
            for x in (a, b):  # settle the endpoints' regenerations
                x.endpoint_manager.regenerate_all(wait=True)

            def enforced(x, on):
                v = x.loader.engine.verdict_flows(probe)["verdict"]
                vs = set(np.asarray(v).tolist())
                return (int(Verdict.DROPPED) in vs) if on else vs == {
                    int(Verdict.FORWARDED)}

            check(all(enforced(x, False) for x in (a, b)),
                  "[cluster] a node drops before any policy")
            revs = {n: x.loader.revision for n, x in agents.items()}
            with regen_split(agents) as split:
                t0 = time.perf_counter()
                client.apply("ciliumnetworkpolicies", doc)
                applied = {}
                for n, x in agents.items():
                    applied[n] = wait_for(
                        lambda: x.loader.revision != revs[n]
                        and enforced(x, True),
                        f"{n} enforcing the CNP", timeout=300) - t0
                for x in (a, b):
                    x.endpoint_manager.regenerate_all(wait=True)
            report["apply_to_enforcement_s"] = applied
            report["regeneration"] = {}
            for n, spans in split.items():
                tot = {s: sum(v) for s, v in spans.items()}
                regen = tot.get("endpoint_regeneration", 0.0)
                comp = tot.get("policy_compile", 0.0)
                stage = tot.get("policy_stage", 0.0)
                report["regeneration"][n] = {
                    "regenerations": len(spans.get("endpoint_regeneration",
                                                   ())),
                    "regeneration_ms": regen * 1e3,
                    "compile_ms": comp * 1e3, "stage_ms": stage * 1e3,
                    "rest_ms": (regen - comp - stage) * 1e3}
            engines = {n: x.loader.engine for n, x in agents.items()}
            for n, e in engines.items():
                check(isinstance(e, TorchVerdictEngine)
                      and e.device.type == DEVICE,
                      f"[cluster] {n} serves {type(e).__name__}")
            report["path_stack"] = list(
                engines["node-a"].policy.arrays["path_trans"].shape)
            report["impl_plan"] = {n: dict(getattr(e, "impl_plan", {}))
                                   for n, e in engines.items()}
            log(f"[cluster] CNP applied through the apiserver: enforced on "
                f"node-a after {applied['node-a']:.2f} s, node-b after "
                f"{applied['node-b']:.2f} s; regeneration " + "; ".join(
                    f"{n} {r['regeneration_ms']:.0f} ms (compile "
                    f"{r['compile_ms']:.0f}, stage {r['stage_ms']:.0f}, "
                    f"rest {r['rest_ms']:.0f})"
                    for n, r in report["regeneration"].items()))

            # -- 19d: process_flows on both nodes, every lane held
            batches = {n: [fl[lo:lo + BATCH]
                           for lo in range(0, len(fl), BATCH)]
                       for n, fl in flows_of.items()}
            outs = {}
            for n, x in agents.items():
                plain = TorchVerdictEngine(engines[n].policy, device="cpu",
                                           cfg=engines[n].cfg)
                outs[n] = []
                for k, bt in enumerate(batches[n]):
                    got = x.process_flows(bt)
                    assert_lanes(f"[cluster] {n} batch {k}", got,
                                 plain.verdict_flows(bt))
                    outs[n].append(got)
            for k in range(len(batches["node-a"])):
                assert_lanes(f"[cluster] node-a vs node-b batch {k}",
                             outs["node-a"][k], outs["node-b"][k])
            mix = np.bincount(np.concatenate(
                [o["verdict"] for o in outs["node-a"]]),
                minlength=6).tolist()
            check(mix[int(Verdict.DROPPED)] > 0
                  and mix[int(Verdict.REDIRECTED)] > 0,
                  f"[cluster] implausible verdict mix {mix}")
            pf = {}
            for n, x in agents.items():
                host = []
                for _ in range(CLUSTER_PASSES):
                    for bt in batches[n]:
                        t0 = time.perf_counter()
                        x.process_flows(bt)
                        host.append(time.perf_counter() - t0)
                kern = profile_kernels(
                    lambda: x.process_flows(batches[n][0]), reps=1)
                pf[n] = {"host_ms": quantiles_ms(host),
                         "device_ms": sum(ms for _, ms in kern.values())
                         or None,
                         "device_kernels": sum(c for c, _ in kern.values()),
                         "kd_in_trace": any("dfa_dense" in k for k in kern),
                         "k1_in_trace": any("nfa_" in k for k in kern)}
            report["process_flows"] = dict(pf, mix=mix,
                                           batches=len(batches["node-a"]))
            log(f"[cluster] process_flows: ten lanes of both nodes equal to "
                f"the plain engine and to each other; mix {mix}; " +
                "; ".join(f"{n} host p50/p99 {r['host_ms']['p50_ms']:.2f}/"
                          f"{r['host_ms']['p99_ms']:.2f} ms, device "
                          f"{r['device_ms']} ms in {r['device_kernels']} "
                          f"kernels" for n, r in pf.items()))

            # -- 19e: status objects, slices and the relay
            batcher = CESBatcher(K8sClient(socks["k8s"])).start()
            ceps = client.list("ciliumendpoints")["items"]
            got_ceps = sorted((o["metadata"]["name"],
                               o["status"]["identity"]["id"],
                               o["status"]["networking"]["node"])
                              for o in ceps)
            check(got_ceps == [("node-a-ep-1", int(srv.identity), "node-a"),
                               ("node-b-ep-2", int(cli.identity), "node-b"),
                               ("node-b-ep-3", int(srv.identity), "node-b")],
                  f"[cluster] CiliumEndpoints {got_ceps}")
            nodes = {o["metadata"]["name"]: o["spec"]["ipam"]["podCIDRs"]
                     for o in client.list("ciliumnodes")["items"]}
            check(nodes == {n: [c] for n, c in cidrs.items()},
                  f"[cluster] CiliumNodes {nodes}")

            def sliced():
                names = sorted(e["name"] for s in client.list(
                    "ciliumendpointslices")["items"]
                    for e in s.get("endpoints", ()))
                return names == [c[0] for c in got_ceps]

            wait_for(sliced, "the CES batcher's slices", timeout=30)
            report["status"] = {"ceps": len(got_ceps),
                                "slices": len(client.list(
                                    "ciliumendpointslices")["items"])}
            relay = HubbleClient(socks["relay"])
            # the relay has followed all it will of 19d's passes: its
            # count holds still for a second
            last = [-1]

            def settled():
                seen = relay.server_status()["seen"]
                still, last[0] = seen == last[0], seen
                return still

            wait_for(settled, "the relay settling", timeout=120, poll=1.0)
            seen0 = last[0]
            t_r0 = time.perf_counter()
            t_base = time.time()
            fresh = {}
            for i, (n, x) in enumerate(agents.items()):
                fresh[n] = [dataclasses.replace(
                    f, time=t_base + i + k * 1e-6)
                    for k, f in enumerate(
                        flows_of[n][:CLUSTER_RELAY_FLOWS])]
                seen_n = seen0 + (i + 1) * CLUSTER_RELAY_FLOWS
                x.process_flows(fresh[n])
                t_relay = wait_for(
                    lambda: relay.server_status()["seen"] >= seen_n,
                    f"the relay following {n}'s flows", timeout=60,
                    poll=0.01)
            merged = list(relay.get_flows())

            def stampless(d):
                d = dict(d)
                d.pop("node_name", None)
                return json.dumps(d, sort_keys=True)

            union = sorted(stampless(flow_to_dict(f)) for x in (a, b)
                           for f in x.observer.get_flows())
            times = [d["time"] for d in merged]
            names = [d.get("node_name") for d in merged]
            check(len(merged) == len(union) == 2 * CLUSTER_RELAY_FLOWS
                  and sorted(stampless(d) for d in merged) == union
                  and times == sorted(times)
                  and names == ["node-a"] * CLUSTER_RELAY_FLOWS
                  + ["node-b"] * CLUSTER_RELAY_FLOWS,
                  f"[cluster] the relay's merged stream ({len(merged)} "
                  f"flows) differs from the nodes' rings ({len(union)})")
            report["relay"] = {
                "records": len(merged),
                "seen": relay.server_status()["seen"],
                "follow_s": t_relay - t_r0,
                "peers": relay.peers()["peers"]}
            check(report["relay"]["peers"] == ["node-a", "node-b"],
                  f"[cluster] relay peers {report['relay']['peers']}")
            apps = cuda_pids() if DEVICE == "cuda" else []
            ctl = {n: p.pid for n, p in procs.items()}
            report["cuda_pids"] = {
                "listed": apps, "script_listed": os.getpid() in apps,
                "control_plane_listed": sorted(
                    n for n, pid in ctl.items() if pid in apps),
                "nvidia_fds": {n: nvidia_fds(pid)
                               for n, pid in ctl.items()},
                "script_nvidia_fds": nvidia_fds(os.getpid())}
            check(not report["cuda_pids"]["control_plane_listed"]
                  and all(v == 0 for v in
                          report["cuda_pids"]["nvidia_fds"].values())
                  and (report["cuda_pids"]["script_nvidia_fds"] > 0
                       or DEVICE == "cpu"),
                  f"[cluster] a control-plane process touches the card, "
                  f"or the probe cannot see the script's own: "
                  f"{report['cuda_pids']}")
            log(f"[cluster] CEPs, CiliumNodes and {report['status']['slices']}"
                f" slice(s) read back; the relay's {len(merged)} flows equal "
                f"the union of both nodes' rings, time-ordered; CUDA pids "
                f"{report['cuda_pids']}")

            # -- 19f: failover, node-c, the CNP deleted
            name = op_pids[int(lead0.rsplit("-", 1)[1])]
            t0 = time.perf_counter()
            procs[name].send_signal(signal.SIGTERM)
            rc = procs.pop(name).wait(timeout=60)
            check(rc == 0, f"[cluster] {name} exited {rc} on SIGTERM: "
                  f"{proc_err(name)}")
            t_down = time.perf_counter()
            wait_for(lambda: leader() not in (None, lead0),
                     "the standby taking the lock",
                     timeout=3 * CLUSTER_ELECTION_TTL + 30)
            report["takeover_s"] = time.perf_counter() - t0
            report["takeover_after_exit_s"] = time.perf_counter() - t_down
            report["rcs"] = {name: rc}
            check(report["takeover_s"] < CLUSTER_ELECTION_TTL + 5.0,
                  f"[cluster] takeover {report['takeover_s']:.2f} s")
            cfg = Config.from_env()
            cfg.configure_logging = False
            cfg.node_name = "node-c"
            cfg.ipam_mode = "cluster-pool"
            cfg.identity_allocation_mode = "crd"
            cfg.k8s_api_socket = socks["k8s"]
            cfg.loader.cache_dir = os.path.join(tmp, "cache-node-c")
            t0 = time.perf_counter()
            agents["node-c"] = Agent(cfg, kvstore=RemoteKVStore(socks["kv"]),
                                     device=DEVICE).start()
            report["node_c"] = {
                "cidr": str(agents["node-c"].ipam.cidr),
                "start_s": time.perf_counter() - t0,
                "device": agents["node-c"].device.type}
            net_c = ipaddress.ip_network(report["node_c"]["cidr"])
            check(net_c.subnet_of(pool) and net_c.prefixlen == 24
                  and str(net_c) not in cidrs.values()
                  and report["node_c"]["device"] == DEVICE,
                  f"[cluster] node-c {report['node_c']}")
            log(f"[cluster] {name} ({lead0}) stopped: the standby took the "
                f"lock after {report['takeover_s']:.2f} s; node-c got "
                f"{net_c} from it")
            revs = {n: agents[n].loader.revision for n in ("node-a",
                                                             "node-b")}
            t0 = time.perf_counter()
            client.delete("ciliumnetworkpolicies", "synth-http")
            dropped = {}
            for n in ("node-a", "node-b"):
                x = agents[n]
                dropped[n] = wait_for(
                    lambda: x.loader.revision != revs[n]
                    and enforced(x, False), f"{n} dropping the CNP",
                    timeout=300) - t0
            report["delete_to_drop_s"] = dropped
            after = {}
            for n in ("node-a", "node-b"):
                x = agents[n]
                bt = flows_of[n][:BATCH]
                after[n] = x.process_flows(bt)
                e = x.loader.engine
                assert_lanes(f"[cluster] {n} after the delete", after[n],
                             TorchVerdictEngine(e.policy, device="cpu",
                                                cfg=e.cfg).verdict_flows(bt))
                check(set(np.asarray(after[n]["verdict"]).tolist())
                      == {int(Verdict.FORWARDED)},
                      f"[cluster] {n} still enforces after the delete")
            assert_lanes("[cluster] node-a vs node-b after the delete",
                         after["node-a"], after["node-b"])
            launches = _count_delta(c0)
            variants = kd_variants()
    finally:
        for x in reversed(list(agents.values())):
            x.stop()
        if batcher is not None:
            batcher.stop()
        if kv is not None:
            kv.close()
        rcs = {}
        for name in ("relay", "op1", "op2", "k8s", "kv"):
            p = procs.pop(name, None)
            if p is None:
                continue
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
            try:
                rcs[name] = p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                rcs[name] = p.wait()
        for f in errs_of.values():
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)
    report["rcs"].update(rcs)
    check(sorted(report["rcs"]) == sorted(CLUSTER_PROCS)
          and all(rc == 0 for rc in report["rcs"].values()),
          f"[cluster] control-plane exit codes {report['rcs']}")
    deadline = time.perf_counter() + 15
    while True:
        left = sorted(t.name for t in threading.enumerate()
                      if t not in threads0 and t.is_alive())
        if not left or time.perf_counter() > deadline:
            break
        time.sleep(0.05)
    check(not left, f"[cluster] threads left after the agents stopped: "
          f"{left}")
    check((launches["KD"] > 0 and launches["K1"] > 0) or DEVICE == "cpu",
          f"[cluster] KD and K1 must launch in phase 19: {launches}")
    report["launches"] = launches
    report["kd_variants"] = variants
    report["wall_s"] = time.perf_counter() - t_phase
    log(f"[cluster] every control-plane process exited 0 on SIGTERM; "
        f"launches {launches} on {card}")
    return report, launches, variants, noted


#: phase 21: the lint's wall budget (CTLINT.json's), the precommit
#: face's rules, and the records each hot root serves in its run
LINT_WALL_BUDGET_MS = 40000
LINT_PRECOMMIT = ("thread-safety", "implicit-sync", "hot-loop-h2d",
                  "readback-ordering", "missing-donation")
LINT_RECORDS = 4096
#: libcuda's attribute ids (cuda.h CUdevice_attribute)
CU_ATTR = {"max_threads_per_block": 1, "warp_size": 10,
           "max_shared_memory_per_block_optin": 97}

#: phase 20: timed calls a CLI command against the live daemon, the
#: capture stream's chunk, the cross-cluster leg's updates (the
#: reference's 50), the flows of the bulk verdict the observer and the
#: monitor must see, and the restart's held chunk
DAEMON_CLI_REPS, DAEMON_STREAM_CHUNK, DAEMON_XC_UPDATES = 5, 8192, 50
#: phase 20: the daemon's device profile window, s (several bulk calls)
DAEMON_PROFILE_S = 3
DAEMON_FANOUT_FLOWS = 64
#: the sections of the reference's bugtool bundle
BUGTOOL_FILES = ["config.json", "endpoints.json", "engine.json",
                 "environment.json", "identities.json", "metrics.txt",
                 "status.json"]


def cli_call(argv):
    """``cilium_tpu_torch.cli.main(argv)`` in this process, its standard
    output captured → (rc, stdout, seconds)."""
    import io

    from cilium_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    return rc, buf.getvalue(), time.perf_counter() - t0


def cli_json(argv, what, want_rc=0):
    rc, out, _ = cli_call(argv)
    check(rc == want_rc, f"[daemon] {what}: rc {rc}: {out[-600:]}")
    return json.loads(out)


def metric_value(text, name, labels=""):
    """One sample of a Prometheus exposition (0 when absent)."""
    import re

    m = re.search(rf"^{re.escape(name)}{re.escape(labels)} (\S+)$", text,
                  re.M)
    return float(m.group(1)) if m else 0.0


def span_totals(text):
    """{span: (count, seconds)} of ``cilium_tpu_span_seconds``."""
    import re

    out = {}
    for kind, span, v in re.findall(
            r'^cilium_tpu_span_seconds_(count|sum)\{span="([^"]+)"\} (\S+)$',
            text, re.M):
        c, s = out.get(span, (0.0, 0.0))
        out[span] = (float(v), s) if kind == "count" else (c, float(v))
    return out


def stream_capture(sock, rec, l7, offsets, blob, chunk, limit=None):
    """The capture's records through the daemon's verdict socket with
    the port's ``StreamClient`` → one verdict a record."""
    import numpy as np

    from cilium_tpu_torch.ingest.binary import (
        capture_field_widths,
        sections_to_bytes,
    )
    from cilium_tpu_torch.runtime.stream import StreamClient

    n = len(rec) if limit is None else min(limit, len(rec))
    client = StreamClient(sock, widths=capture_field_widths(l7, offsets))
    try:
        for i in range(0, n, chunk):
            j = min(n, i + chunk)
            client.send_image(sections_to_bytes(
                np.asarray(rec[i:j]), l7[i:j], offsets, blob))
        client.finish()
        parts = []
        for _, v in client.results():
            check(not isinstance(v, Exception), f"[daemon] stream: {v}")
            parts.append(np.asarray(v))
    finally:
        client.close()
    return np.concatenate(parts)


def daemon_phase(card, base_p99_ms):
    """Phase 20 (see the module docstring) → (report, the phase's
    launches in this process, KD's launches by variant, the launch
    shapes noted)."""
    import shutil
    import signal
    import tarfile
    import tempfile
    import threading

    import numpy as np

    from cilium_tpu_torch.agent import Agent
    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.core.flow import Verdict
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine
    from cilium_tpu_torch.ingest import binary, synth
    from cilium_tpu_torch.ingest.hubble import (flow_from_dict, flow_to_dict,
                                                write_jsonl)
    from cilium_tpu_torch.k8s.apiserver import APIServer, K8sClient, NotFound
    from cilium_tpu_torch.runtime import fleet
    from cilium_tpu_torch.runtime.service import VerdictClient
    from cilium_tpu_torch.runtime.tracing import TRACER
    from cilium_tpu_torch.tools import bench_protocols

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    noted, report = {}, {"card": card, "rules": N_RULES, "flows": N_FLOWS,
                         "bank_size": BANK_SIZE,
                         "cli_reps": DAEMON_CLI_REPS,
                         "stream_chunk": DAEMON_STREAM_CHUNK,
                         "xc_updates": DAEMON_XC_UPDATES}
    threads0 = set(threading.enumerate())
    tmp = tempfile.mkdtemp(prefix="cs20")  # socket paths < 108 bytes
    socks = {k: os.path.join(tmp, f"{k}.sock")
             for k in ("svc", "api", "hub", "mon", "k8s")}
    state = os.path.join(tmp, "state")
    paths = {k: os.path.join(tmp, k) for k in (
        "cap.bin", "export.jsonl", "conv.bin", "cnp.yaml", "daemon.toml",
        "trace.json", "bt", "prof")}
    daemon, errf, apiserver, plain_agent = None, None, None, None
    t_spawn, cli_proc = 0.0, None
    steps = report["steps_s"] = {}

    def step(name):
        steps[name] = time.perf_counter() - t_phase
    tracer0 = (TRACER.enabled, TRACER.sample_rate)
    env0 = {k: os.environ.get(k) for k in ("CILIUM_TPU_CACHE_DIR",)}
    sc = synth.synth_http_scenario(N_RULES, N_FLOWS)
    eps = list(sc.endpoints.items())  # the order the capture's ids follow
    label_arg = {n: ",".join(f"{k}={v}" for k, v in lbls.items())
                 for n, lbls in eps}

    def daemon_argv():
        return [sys.executable, "-m", "cilium_tpu_torch.daemon",
                "--config", paths["daemon.toml"], "--socket", socks["svc"],
                "--api-socket", socks["api"], "--hubble-socket",
                socks["hub"], "--monitor-socket", socks["mon"],
                "--state-dir", state] + (
                    [] if DEVICE == "cuda" else ["--device", DEVICE])

    def spawn_daemon(life):
        """Start the daemon; the caller works on while it imports torch
        and comes up, then waits with :func:`wait_daemon`."""
        nonlocal daemon, errf, t_spawn
        for s in ("svc", "api", "hub", "mon"):
            check(not os.path.exists(socks[s]),
                  f"[daemon] {s} socket left from the last process")
        errf = open(os.path.join(tmp, f"daemon-{life}.err"), "w+")
        t_spawn = time.perf_counter()
        daemon = subprocess.Popen(daemon_argv(), cwd=here,
                                  stdout=subprocess.DEVNULL, stderr=errf)

    def wait_daemon():
        """Seconds from the spawn to all four sockets up."""
        deadline = t_spawn + 120
        while not all(os.path.exists(socks[s])
                      for s in ("svc", "api", "hub", "mon")):
            check(daemon.poll() is None,
                  f"[daemon] exited {daemon.returncode} while starting: "
                  f"{daemon_err()}")
            check(time.perf_counter() < deadline,
                  "[daemon] sockets not up within 120 s")
            time.sleep(0.005)
        return time.perf_counter() - t_spawn

    def daemon_err():
        errf.seek(0)
        return errf.read()[-800:]

    def stop_daemon():
        nonlocal daemon
        t0 = time.perf_counter()
        daemon.send_signal(signal.SIGTERM)
        try:
            rc = daemon.wait(timeout=20)
        except subprocess.TimeoutExpired:
            daemon.kill()
            daemon.wait()
            check(False, f"[daemon] did not exit within 20 s of SIGTERM: "
                  f"{daemon_err()}")
        daemon = None
        check(rc == 0, f"[daemon] exited {rc} on SIGTERM: {daemon_err()}")
        errf.seek(0)
        check("service drained" in errf.read(),
              f"[daemon] no drain before the stop: {daemon_err()}")
        return rc, time.perf_counter() - t0

    def status():
        return cli_json(["status", "--socket", socks["svc"]], "status")

    def metrics_text():
        rc, out, _ = cli_call(["metrics", "--socket", socks["svc"]])
        check(rc == 0 and "cilium_tpu" in out, f"[daemon] metrics rc {rc}")
        return out

    def wait_revision(rev, what, timeout=300):
        t0 = time.perf_counter()
        while True:
            st = status()
            if st["engine_revision"] >= rev:
                return st, time.perf_counter() - t0
            check(time.perf_counter() - t0 < timeout,
                  f"[daemon] {what}: engine revision {st['engine_revision']}"
                  f" < {rev} after {timeout} s")
            time.sleep(0.002)

    try:
        # the daemon starts first: it imports torch and comes up while
        # 20a's files and the plain engine's policy are made here
        doc = synth.http_rule_cnp(sc.rules[0], "synth-http")
        with open(paths["cnp.yaml"], "w") as f:
            json.dump(doc, f)  # JSON is YAML: the port's reader takes it
        with open(paths["daemon.toml"], "w") as f:
            f.write('node_name = "cs20-node"\n[engine]\n'
                    'kernel_impl = "nfa-bitset"\n'
                    f'bank_size = {BANK_SIZE}\n[loader]\n'
                    'warm_restore = true\n'
                    f'cache_dir = "{tmp}/daemon-cache"\n')
        spawn_daemon("first")
        # -- 20a: files through the CLI, in this process
        t0 = time.perf_counter()
        info = cli_json(["capture", "synth", paths["cap.bin"], "--scenario",
                         "http", "--rules", N_RULES, "--flows", N_FLOWS],
                        "capture synth")
        check(info["records"] == N_FLOWS and info["version"] == 2,
              f"[daemon] capture synth {info}")
        cap_info = cli_json(["capture", "info", paths["cap.bin"]],
                            "capture info")
        check(cap_info["records"] == N_FLOWS and cap_info["strings"] > 1,
              f"[daemon] capture info {cap_info}")
        _, flows_sc = synth.realize_scenario(
            synth.scenario_by_name("http", N_RULES, N_FLOWS), resolve=False)
        write_jsonl(paths["export.jsonl"], flows_sc.flows)
        conv = cli_json(["capture", "convert", paths["export.jsonl"],
                         paths["conv.bin"]], "capture convert")
        check(conv["records"] == N_FLOWS and conv["version"] == 2,
              f"[daemon] capture convert {conv}")
        cfg_plain = Config.from_toml(paths["daemon.toml"])
        check(cfg_plain.enable_tpu_offload
              and cfg_plain.engine.kernel_impl == "nfa-bitset"
              and cfg_plain.engine.bank_size == BANK_SIZE
              and cfg_plain.loader.warm_restore,
              f"[daemon] the TOML read back wrong: {cfg_plain.engine}")
        report["files"] = {"synth": info, "info": cap_info, "convert": conv,
                           "s": time.perf_counter() - t0}
        # the plain engine of the same policy: an agent on the CPU with
        # the same configuration, endpoints and CNP
        cfg_plain.configure_logging = False
        cfg_plain.loader.cache_dir = os.path.join(tmp, "plain-cache")
        plain_agent = Agent(cfg_plain, device="cpu")
        for i, (name, lbls) in enumerate(eps, start=1):
            plain_agent.endpoint_add(i, lbls)
        plain_agent.policy_add_file(paths["cnp.yaml"])
        plain = plain_agent.loader.engine
        check(isinstance(plain, TorchVerdictEngine)
              and plain.device.type == "cpu",
              f"[daemon] the plain agent serves {type(plain).__name__}")
        rec = binary.map_capture(paths["cap.bin"])
        l7, offsets, blob = binary.read_l7_sidecar(paths["cap.bin"])

        def plain_bulk(dicts):
            # what the service's bulk op computes, on the plain engine
            return plain.verdict_flows([flow_from_dict(d) for d in dicts],
                                       outputs=("verdict",))["verdict"]

        def hold_bulk(r, want_v, what):
            check("verdicts" in r, f"[daemon] {what}: {r}")
            got_v = np.asarray(r["verdicts"])
            bad = (int((got_v != want_v).sum())
                   if got_v.shape == want_v.shape else len(want_v))
            check(bad == 0, f"[daemon] {what} differs from the plain "
                  f"engine in {bad} of {len(want_v)} flows")

        step("files_and_plain_policy")
        log(f"[daemon] capture synth/info/convert through the CLI: "
            f"{info['records']} records, {cap_info['strings']} strings, "
            f"{cap_info['blob_bytes']} blob bytes")

        with kernel_launches_noted(noted):
            reset_counts()
            c0 = counts()
            # -- 20b: the daemon as an OS process on the card
            report["start_s"] = wait_daemon()
            step("daemon_up")
            pid = daemon.pid
            report["daemon_nvidia_fds"] = nvidia_fds(pid)
            check(report["daemon_nvidia_fds"] > 0 or DEVICE == "cpu",
                  f"[daemon] the daemon (pid {pid}) holds no /dev/nvidia* "
                  f"file: it is not on the card")
            m0 = metrics_text()
            for i, (name, _) in enumerate(eps, start=1):
                ep = cli_json(["endpoint", "add", i, "--labels",
                               label_arg[name], "--api", socks["api"]],
                              f"endpoint add {name}")
                check(ep["identity"] == 255 + i,
                      f"[daemon] {name} got identity {ep['identity']}")
            t0 = time.perf_counter()
            imp = cli_json(["policy", "import", paths["cnp.yaml"], "--api",
                            socks["api"]], "policy import")
            st, _ = wait_revision(max(1, imp["revision"]), "the import")
            report["import_to_enforcement_s"] = time.perf_counter() - t0
            hz = cli_json(["healthz", "--api", socks["api"]], "healthz")
            check(hz["status"] == "ok" and hz["engine_revision"]
                  == st["engine_revision"] and st["rules"] == 1,
                  f"[daemon] healthz {hz} / status {st}")
            m1 = metrics_text()
            a, b = span_totals(m0), span_totals(m1)
            split = {s: {"count": b[s][0] - a.get(s, (0, 0))[0],
                         "ms": (b[s][1] - a.get(s, (0, 0))[1]) * 1e3}
                     for s in ("endpoint_regeneration", "policy_compile",
                               "policy_stage") if s in b}
            regen = split.get("endpoint_regeneration", {"ms": 0.0})["ms"]
            split["rest_ms"] = regen - sum(
                split.get(s, {"ms": 0.0})["ms"]
                for s in ("policy_compile", "policy_stage"))
            report["regeneration"] = split
            step("enforced")
            # one command as a CLI process (it imports torch): it holds
            # no /dev/nvidia* file; the plain verdicts are computed here
            # while it runs, and nothing timed overlaps it
            t_cli = time.perf_counter()
            cli_proc = subprocess.Popen(
                [sys.executable, "-m", "cilium_tpu_torch.cli", "status",
                 "--socket", socks["svc"]], cwd=here,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            fds, cli_done = [], threading.Event()

            def sample_fds():
                while cli_proc.poll() is None:
                    n = nvidia_fds(cli_proc.pid)
                    if n is not None:
                        fds.append(n)
                    time.sleep(0.005)
                cli_done.set()

            sampler = threading.Thread(target=sample_fds, daemon=True)
            sampler.start()
            want = plain.verdict_l7_records(np.asarray(rec), l7, offsets,
                                            blob)["verdict"]
            mix = np.bincount(want, minlength=6).tolist()
            check(mix[int(Verdict.DROPPED)] > 0
                  and mix[int(Verdict.REDIRECTED)] > 0,
                  f"[daemon] implausible verdict mix {mix}")
            out, err = cli_proc.communicate(timeout=120)
            sampler.join(timeout=10)
            report["cli_process"] = {"rc": cli_proc.returncode,
                                     "s": time.perf_counter() - t_cli,
                                     "fd_samples": len(fds),
                                     "max_nvidia_fds": max(fds, default=0)}
            check(cli_proc.returncode == 0 and json.loads(out)["rules"] == 1
                  and fds and max(fds) == 0,
                  f"[daemon] the CLI process: {report['cli_process']} "
                  f"{err[-400:]}")
            step("cli_process_and_plain_verdicts")
            log(f"[daemon] python -m cilium_tpu_torch.daemon up in "
                f"{report['start_s']:.2f} s (pid {pid}, "
                f"{report['daemon_nvidia_fds']} /dev/nvidia* fds); 2 "
                f"endpoints and the CNP through the CLI: import -> "
                f"enforcement {report['import_to_enforcement_s']:.2f} s; "
                f"regeneration {split}")

            # -- 20c: the CLI against the live daemon
            src, dst = label_arg["client"], label_arg["server"]
            cmds = {
                "status": ["status", "--socket", socks["svc"]],
                "policy_get": ["policy", "get", "--socket", socks["svc"]],
                "metrics": ["metrics", "--socket", socks["svc"]],
                "healthz": ["healthz", "--api", socks["api"]],
                "endpoint_list": ["endpoint", "list", "--api", socks["api"]],
                "identity_list": ["identity", "list", "--api", socks["api"]],
                "config_get": ["config", "get", "--api", socks["api"]],
                "policy_trace": ["policy", "trace", "--api", socks["api"],
                                 "--src", src, "--dst", dst, "--dport",
                                 "80"]}
            cli_ms = {}
            for name, argv in cmds.items():
                secs = []
                for _ in range(DAEMON_CLI_REPS):
                    rc, out, s = cli_call(argv)
                    check(rc == 0, f"[daemon] {name}: rc {rc}")
                    secs.append(s)
                cli_ms[name] = sorted(secs)[len(secs) // 2] * 1e3
            trace = json.loads(cli_call(cmds["policy_trace"])[1])
            check(trace["verdict"] == "ALLOWED",
                  f"[daemon] policy trace client -> server: {trace}")
            cfg_d = json.loads(cli_call(cmds["config_get"])[1])
            check(cfg_d["config"]["engine"]["kernel_impl"] == "nfa-bitset",
                  f"[daemon] config get: {cfg_d['config']['engine']}")
            report["cli_ms"] = cli_ms
            sinfo = cli_json(["capture", "stream", paths["cap.bin"],
                              "--socket", socks["svc"], "--chunk",
                              DAEMON_STREAM_CHUNK], "capture stream")
            check(sinfo["records"] == N_FLOWS and not sinfo["errors"]
                  and not sinfo["truncated"] and sinfo["verdicts"] == mix,
                  f"[daemon] capture stream {sinfo} vs plain {mix}")
            got = stream_capture(socks["svc"], rec, l7, offsets, blob,
                                 DAEMON_STREAM_CHUNK)
            check(np.array_equal(got, want),
                  f"[daemon] stream verdicts differ from the plain engine's "
                  f"in {int((got != want).sum())} records")
            report["stream"] = {"records_per_s": sinfo["records_per_sec"],
                                "seconds": sinfo["seconds"], "mix": mix,
                                "chunks": -(-N_FLOWS // DAEMON_STREAM_CHUNK)}
            # the observer and the monitor see a bulk verdict's flows (the
            # stream path does not fan out, in either package)
            fan = [dict(flow_to_dict(f)) for f in
                   flows_sc.flows[:DAEMON_FANOUT_FLOWS]]
            # the bulk op's verdicts are held against the plain engine on
            # the same flows, through the same dict round trip; a thread's
            # failure is kept and raised after its join
            want_fan = plain_bulk(fan)
            thread_errors = []

            def bulk_verdict():
                try:
                    time.sleep(1.0)  # the monitor below subscribes first
                    c = VerdictClient(socks["svc"])
                    try:
                        r = c.call({"op": "verdict", "flows": fan})
                    finally:
                        c.close()
                    hold_bulk(r, want_fan, "bulk verdict")
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    thread_errors.append(e)

            th = threading.Thread(target=bulk_verdict, daemon=True)
            th.start()
            rc, mon_out, _ = cli_call(["monitor", "--socket", socks["mon"],
                                       "--count", DAEMON_FANOUT_FLOWS])
            th.join(timeout=60)
            check(not th.is_alive(), "[daemon] the bulk verdict hung")
            if thread_errors:
                raise thread_errors[0]
            mon = [json.loads(ln) for ln in mon_out.splitlines() if ln]
            check(rc == 0 and len(mon) == DAEMON_FANOUT_FLOWS
                  and {e["type"] for e in mon} <= {"POLICY_VERDICT", "DROP"},
                  f"[daemon] monitor --count: rc {rc}, {len(mon)} events")
            rc, obs_out, _ = cli_call(["observe", "--hubble", socks["hub"]])
            seen = [json.loads(ln) for ln in obs_out.splitlines() if ln]
            check(rc == 0 and len(seen) == DAEMON_FANOUT_FLOWS,
                  f"[daemon] observe: rc {rc}, {len(seen)} flows")
            report["fan_out"] = {"monitor_events": len(mon),
                                 "observed": len(seen)}
            # the device profile while a stream runs, beside bulk
            # verdicts: the stream's session scans its string tables with
            # KD, the bulk op's fused step runs K1 under nfa-bitset. The
            # two run in threads of their own, so the bulk op's device
            # work (a burst at the end of each call, after its host-side
            # decode) recurs one bulk call apart; the window is several
            # calls long, so a burst falls in it whatever the phase of
            # the calls when it opens (paced one call after the other
            # behind the stream, a round could outlast a 1 s window)
            stop_stream = threading.Event()
            streamed = [0, 0]
            bulk_spans = []  # (start, end) of each bulk call, host clock
            bulk = [dict(flow_to_dict(f)) for f in flows_sc.flows[:BATCH]]
            want_bulk = plain_bulk(bulk)
            want_chunk = want[:DAEMON_STREAM_CHUNK]
            warm = [threading.Event(), threading.Event()]

            def keep_streaming():
                # a chunk at a time, paced: the trace's size (its export
                # is the profile's cost) stays bounded; each is held
                # against the plain engine. The profile starts after the
                # first chunk and bulk call, which are cold at these
                # shapes and could fill its window
                try:
                    while not stop_stream.is_set():
                        got = stream_capture(
                            socks["svc"], rec, l7, offsets, blob,
                            DAEMON_STREAM_CHUNK, limit=DAEMON_STREAM_CHUNK)
                        check(np.array_equal(got, want_chunk),
                              f"[daemon] profiled stream differs from "
                              f"the plain engine in "
                              f"{int((got != want_chunk).sum())} records")
                        streamed[0] += len(got)
                        warm[0].set()
                        stop_stream.wait(0.1)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    thread_errors.append(e)
                finally:
                    warm[0].set()

            def keep_bulk():
                try:
                    c = VerdictClient(socks["svc"])
                    try:
                        while not stop_stream.is_set():
                            t_bulk = time.perf_counter()
                            r = c.call({"op": "verdict", "flows": bulk})
                            bulk_spans.append((t_bulk, time.perf_counter()))
                            hold_bulk(r, want_bulk, "profiled bulk verdict")
                            streamed[1] += len(r["verdicts"])
                            warm[1].set()
                            stop_stream.wait(0.05)
                    finally:
                        c.close()
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    thread_errors.append(e)
                finally:
                    warm[1].set()

            step("cli_stream_fanout")
            ths = [threading.Thread(target=fn, daemon=True)
                   for fn in (keep_streaming, keep_bulk)]
            for th in ths:
                th.start()
            try:
                check(all(w.wait(timeout=120) for w in warm),
                      "[daemon] the stream's or the bulk op's first call "
                      "hung")
                if thread_errors:
                    raise thread_errors[0]
                t_warm = time.perf_counter() - t_phase
                before = list(streamed)
                t_prof = time.perf_counter()
                prof = cli_json(["profile", "--socket", socks["svc"],
                                 "--mode", "device" if DEVICE == "cuda"
                                 else "host", "--seconds",
                                 str(DAEMON_PROFILE_S), "--out",
                                 paths["prof"]], "profile")
                during = [a - b for a, b in zip(streamed, before)]
                t_prof = (t_prof, time.perf_counter())
            finally:
                stop_stream.set()
                for th in ths:
                    th.join(timeout=120)
            check(not any(th.is_alive() for th in ths),
                  "[daemon] the profiled stream or bulk op hung")
            if thread_errors:
                raise thread_errors[0]
            # the calls that ran whole inside the profile call (which
            # holds the daemon's window), and the longest stretch between
            # two of their ends (each end follows a device burst)
            inside = [(a, b) for a, b in bulk_spans
                      if t_prof[0] <= a and b <= t_prof[1]]
            gap = max((b2 - b1 for (_, b1), (_, b2) in
                       zip(inside, inside[1:])), default=None)
            check(inside and during[0] > 0,
                  f"[daemon] no bulk batch or stream chunk ran beside the "
                  f"profile: {streamed}, {during} during it")
            step("profile")
            if DEVICE == "cuda":
                with open(prof["path"]) as f:
                    ptrace = f.read()
                k1_named = ("nfa_scan" in ptrace and any(
                    "nfa_scan" in k for k in prof["device_events"]))
                check(k1_named, f"[daemon] the daemon's device profile names "
                      f"no K1 kernel: {prof['device_events']}; the profile "
                      f"call {[round(t - t_phase, 3) for t in t_prof]} s, "
                      f"the bulk calls "
                      f"{[(round(a - t_phase, 3), round(b - t_phase, 3)) for a, b in bulk_spans]}"
                      f" s into the phase; during it {during}; "
                      f"fallback verdicts: "
                      f"{[ln for ln in metrics_text().splitlines() if 'fallback' in ln and not ln.startswith('#')]}"
                      f"; the daemon's stderr: {daemon_err()}")
                report["profile"] = {"device_events": prof["device_events"],
                                     "k1_named": k1_named,
                                     "kd_named": any(
                                         "dfa_dense" in k for k in
                                         prof["device_events"]),
                                     "streamed_records": streamed[0],
                                     "bulk_flows": streamed[1],
                                     "during_profile": during,
                                     "bulk_calls_inside": len(inside),
                                     "bulk_end_gap_max_s": gap,
                                     "warm_at_s": t_warm}
            # bugtool
            rc, out, _ = cli_call(["bugtool", "--socket", socks["svc"],
                                   "--out", paths["bt"]])
            check(rc == 0, f"[daemon] bugtool rc {rc}")
            with tarfile.open(out.strip()) as tar:
                members = {os.path.basename(m.name): m
                           for m in tar.getmembers() if m.isfile()}
                manifest = json.load(tar.extractfile(members["MANIFEST.json"]))
                engine_s = json.load(tar.extractfile(members["engine.json"]))
                env_s = json.load(tar.extractfile(
                    members["environment.json"]))
            check(manifest["files"] == BUGTOOL_FILES,
                  f"[daemon] bugtool MANIFEST {manifest['files']}")
            dtypes = {t["dtype"] for t in engine_s["tensors"].values()}
            check(engine_s["staged"] and engine_s["hbm_bytes"] > 0
                  and not any(d.startswith("torch.") for d in dtypes),
                  f"[daemon] bugtool engine section {dtypes}")
            names = [d["name"] for d in env_s["torch"].get("devices", ())]
            check(DEVICE == "cpu" or names == [
                __import__("torch").cuda.get_device_name(0)],
                f"[daemon] bugtool environment names {names}")
            report["bugtool"] = {"files": manifest["files"],
                                 "tensors": len(engine_s["tensors"]),
                                 "hbm_bytes": engine_s["hbm_bytes"],
                                 "devices": names}
            step("bugtool")
            log(f"[daemon] CLI against the daemon (median of "
                f"{DAEMON_CLI_REPS}, ms): " + ", ".join(
                    f"{k} {v:.1f}" for k, v in cli_ms.items())
                + f"; capture stream {sinfo['records_per_sec']} records/s, "
                f"every verdict equal to the plain engine; device profile "
                f"names K1: {report.get('profile', {}).get('k1_named')}; "
                f"monitor {len(mon)} events, observe {len(seen)} flows; "
                f"bugtool {len(engine_s['tensors'])} tensors; the CLI "
                f"process {report['cli_process']}")

            # -- 20d: offline replay in this process, under auto (the
            # replay installs its JSONL log handler; this process's is
            # put back after it)
            TRACER.configure(enabled=True, sample_rate=1.0)
            log_root = logging.getLogger("cilium_tpu_torch")
            log0 = (list(log_root.handlers), log_root.level,
                    log_root.propagate)
            os.environ["CILIUM_TPU_CACHE_DIR"] = os.path.join(
                tmp, "replay-cache")
            base = ["--policy", paths["cnp.yaml"]] + (
                [] if DEVICE == "cuda" else ["--device", DEVICE])
            for name, _ in eps:
                base += ["--endpoint", label_arg[name]]
            routes = {"object": [paths["cap.bin"]],
                      "fast": [paths["cap.bin"], "--fast"],
                      "converted": [paths["conv.bin"]]}
            replays = {}
            for route, argv in routes.items():
                if route == "fast":
                    TRACER.clear()
                    argv = argv + ["--trace-out", paths["trace.json"]]
                rc, out, s = cli_call(["replay", *argv, *base])
                summary = json.loads(out)
                check(rc == 0 and summary["flows"] == N_FLOWS,
                      f"[daemon] replay {route}: rc {rc} {summary}")
                replays[route] = {"summary": summary, "s": s,
                                  "records_per_s": N_FLOWS / s}
            want_counts = {Verdict(v).name: c for v, c in enumerate(mix) if c}
            for route, r in replays.items():
                check(r["summary"]["verdicts"] == want_counts,
                      f"[daemon] replay {route} {r['summary']['verdicts']} "
                      f"vs the plain engine's {want_counts}")
            with open(paths["trace.json"]) as f:
                chunk_events = [e for e in json.load(f)["traceEvents"]
                                if e.get("name") == "replay.chunk"]
            chunks = -(-N_FLOWS // Config.from_env().engine.batch_size)
            check(len(chunk_events) == chunks
                  and len({e["args"]["chunk"] for e in chunk_events})
                  == chunks,
                  f"[daemon] --trace-out: {len(chunk_events)} chunk traces "
                  f"for {chunks} chunks")
            for h in list(log_root.handlers):
                log_root.removeHandler(h)
            for h in log0[0]:
                log_root.addHandler(h)
            log_root.setLevel(log0[1])
            log_root.propagate = log0[2]
            report["replay"] = {k: {"records_per_s": r["records_per_s"],
                                    "s": r["s"]} for k, r in replays.items()}
            report["replay"]["trace_chunks"] = len(chunk_events)
            log(f"[daemon] replay (object / --fast / converted JSONL): "
                + ", ".join(f"{k} {r['records_per_s']:.0f} records/s"
                            for k, r in replays.items())
                + f", verdicts {want_counts} in all three and the plain "
                f"engine; --trace-out {len(chunk_events)} chunk traces")

            step("replays")
            # -- 20f: drain and warm restart
            rc, report["drain_s"] = stop_daemon()
            spawn_daemon("restart")
            # -- 20e: k8s apply|get|delete against an apiserver here,
            # while the restarted daemon comes up
            apiserver = APIServer(socks["k8s"]).start()
            kc = K8sClient(socks["k8s"])
            applied = cli_json(["k8s", "apply", "--socket", socks["k8s"],
                                "-f", paths["cnp.yaml"]], "k8s apply")
            obj = kc.get("ciliumnetworkpolicies", "synth-http", "default")
            check(applied[0]["name"] == "synth-http"
                  and obj["spec"] == doc["spec"],
                  f"[daemon] k8s apply: {applied}")
            got_obj = cli_json(["k8s", "get", "--socket", socks["k8s"],
                                "ciliumnetworkpolicies", "synth-http", "-n",
                                "default"], "k8s get")
            check(got_obj == obj, "[daemon] k8s get differs from the store")
            cli_json(["k8s", "delete", "--socket", socks["k8s"],
                      "ciliumnetworkpolicies", "synth-http", "-n",
                      "default"], "k8s delete")
            try:
                kc.get("ciliumnetworkpolicies", "synth-http", "default")
                gone = False
            except NotFound:
                gone = True
            check(gone, "[daemon] k8s delete left the object")
            apiserver.stop()
            apiserver = None
            report["k8s"] = {"applied": len(applied), "deleted": gone}

            report["warm_restart_s"] = wait_daemon()
            mr = metrics_text()
            report["restart"] = {
                "warm_restores": metric_value(
                    mr, "cilium_tpu_warm_restores_total"),
                "compiles_submitted": metric_value(
                    mr, "cilium_tpu_compile_queue_submitted_total")}
            eps_back = cli_json(["endpoint", "list", "--api", socks["api"]],
                                "endpoint list")
            # the rules come back when their source re-delivers them: the
            # import's regeneration compiles nothing either
            regens = metric_value(mr, "cilium_tpu_endpoint_regenerations_total")
            cli_json(["policy", "import", paths["cnp.yaml"], "--api",
                      socks["api"]], "policy import again")
            t0, last = time.perf_counter(), None
            while True:  # the regenerations ran and then held still
                mr = metrics_text()
                n = metric_value(mr, "cilium_tpu_endpoint_regenerations_total")
                if n > regens and n == last:
                    break
                check(time.perf_counter() - t0 < 120,
                      "[daemon] no regeneration after the re-import")
                last = n
                time.sleep(0.3)
            st, _ = wait_revision(1, "the restart")
            check(st["rules"] == 1, f"[daemon] restart status {st}")
            report["restart"].update({
                "endpoints": len(eps_back),
                "engine_revision": st["engine_revision"],
                "compiles_after_import": metric_value(
                    mr, "cilium_tpu_compile_queue_submitted_total")})
            check(len(eps_back) == len(eps)
                  and report["restart"]["warm_restores"] == 1
                  and report["restart"]["compiles_submitted"] == 0
                  and report["restart"]["compiles_after_import"] == 0,
                  f"[daemon] the warm restart: {report['restart']}")
            got = stream_capture(socks["svc"], rec, l7, offsets, blob,
                                 DAEMON_STREAM_CHUNK,
                                 limit=DAEMON_STREAM_CHUNK)
            check(np.array_equal(got, want[:DAEMON_STREAM_CHUNK]),
                  "[daemon] the restarted daemon's chunk differs from the "
                  "plain engine's")
            rc, report["drain_again_s"] = stop_daemon()
            step("restart")
            log(f"[daemon] SIGTERM: drained and exited 0 in "
                f"{report['drain_s']:.2f} s; restarted in "
                f"{report['warm_restart_s']:.2f} s, warm "
                f"({report['restart']}); one chunk held; exited 0 again")

            # -- 20g: the cross-cluster churn leg, beta on the card
            try:
                xc = bench_protocols.run_crosscluster(
                    DAEMON_XC_UPDATES, log, gate_p99=True,
                    base_p99_ms=base_p99_ms, device=DEVICE)
                held = True
            except fleet.P99GateError as e:
                xc, held = e.result, False
            report["crosscluster"] = dict(xc, held=held)
            log(f"[daemon] cross-cluster leg: {xc['updates']} updates, p50 "
                f"{xc['p50_ms']:.1f} ms, p99 {xc['value']:.1f} ms beside the "
                f"bound {xc['p99_bound_ms']:.1f} ms (2 x the 27-bank lane's "
                f"{base_p99_ms:.1f} ms): " + ("held" if held else
                                              "did NOT hold (a finding, "
                                              "recorded in the daemon line)"))
            step("crosscluster")
            launches = _count_delta(c0)
            variants = kd_variants()
    finally:
        TRACER.configure(enabled=tracer0[0], sample_rate=tracer0[1])
        if cli_proc is not None and cli_proc.poll() is None:
            cli_proc.kill()
            cli_proc.wait()
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if daemon is not None and daemon.poll() is None:
            daemon.kill()
            daemon.wait()
        if errf is not None:
            errf.close()
        if apiserver is not None:
            apiserver.stop()
        if plain_agent is not None:
            plain_agent.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    deadline = time.perf_counter() + 15
    while True:
        left = sorted(t.name for t in threading.enumerate()
                      if t not in threads0 and t.is_alive())
        if not left or time.perf_counter() > deadline:
            break
        time.sleep(0.05)
    check(not left, f"[daemon] threads left after the phase: {left}")
    check(launches["KD"] > 0 or DEVICE == "cpu",
          f"[daemon] KD must launch in phase 20 (replay, beta): {launches}")
    report["launches"] = launches
    report["kd_variants"] = variants
    report["wall_s"] = time.perf_counter() - t_phase
    log(f"[daemon] launches in this process {launches} on {card}")
    return report, launches, variants, noted


def _count_delta(c0):
    return {k: v - c0[k] for k, v in counts().items()}


def kd_variants():
    """KD's launches by variant since the counts were last set to 0."""
    from cilium_tpu_torch.engine import _build

    return dict(_build.KERNELS["KD"].launches_by_variant)


def device_attributes():
    """The card's launch limits: torch's device properties where it has
    the field, else libcuda's ``cuDeviceGetAttribute``."""
    import ctypes

    import torch

    props = torch.cuda.get_device_properties(0)
    torch_names = {"max_threads_per_block": "max_threads_per_block",
                   "warp_size": "warp_size",
                   "max_shared_memory_per_block_optin":
                       "shared_memory_per_block_optin"}
    out, source = {}, {}
    cu = None
    for key, attr in CU_ATTR.items():
        v = getattr(props, torch_names[key], None)
        if v is not None:
            out[key], source[key] = int(v), "torch"
            continue
        if cu is None:
            cu = ctypes.CDLL("libcuda.so.1")
            check(cu.cuInit(0) == 0, "cuInit failed")
        dev, val = ctypes.c_int(), ctypes.c_int()
        check(cu.cuDeviceGet(ctypes.byref(dev), 0) == 0,
              "cuDeviceGet failed")
        check(cu.cuDeviceGetAttribute(ctypes.byref(val), attr, dev) == 0,
              f"cuDeviceGetAttribute({key}) failed")
        out[key], source[key] = val.value, "libcuda"
    return out, source


class SyncLog:
    """Synchronizing calls torch reports (``set_sync_debug_mode("warn")``)
    while wrapped methods run: each method's calls get the slice of the
    warnings recorded between its entry and its return (a method that
    calls another counts the callee's too)."""

    def __init__(self):
        self.caught = []
        self.calls = {}
        self._patched = []

    def wrap(self, owner, name, label):
        orig = getattr(owner, name)
        log_ = self

        def wrapped(*a, **kw):
            i = len(log_.caught)
            try:
                return orig(*a, **kw)
            finally:
                log_.calls.setdefault(label, []).append(log_.caught[i:])

        setattr(owner, name, wrapped)
        self._patched.append((owner, name, orig))

    @contextlib.contextmanager
    def recording(self):
        import torch

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            self.caught = caught
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield self
            finally:
                torch.cuda.set_sync_debug_mode(0)
                for owner, name, orig in reversed(self._patched):
                    setattr(owner, name, orig)

    def syncs(self, label):
        """(number of calls, the sync sites ``path:line`` of all of
        them, one per synchronizing call)."""
        here = os.path.dirname(os.path.abspath(__file__))
        calls = self.calls.get(label, [])
        sites = [f"{os.path.relpath(w.filename, here)}:{w.lineno}"
                 for ws in calls for w in ws
                 if "synchroniz" in str(w.message)]
        return len(calls), sites


def start_lint():
    """21a and 21b as processes (they use the host only)."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(here, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=here)
    full = subprocess.Popen(
        [sys.executable, "-m", "cilium_tpu_torch.analysis", "--format",
         "json", "--out", os.path.join(out, "ctlint_torch.json"),
         "--wall-budget-ms", str(LINT_WALL_BUDGET_MS)],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    pre = subprocess.Popen(
        [sys.executable, "-m", "cilium_tpu_torch.cli", "lint"]
        + [a for r in LINT_PRECOMMIT for a in ("--rule", r)],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return time.perf_counter(), full, pre


def seen_covers(seen, site):
    """Does a rule site ``path:first-last what`` hold ``path:line``?"""
    where = seen.split(" ")[0]
    path, _, span = where.rpartition(":")
    first, _, last = span.partition("-")
    spath, _, sline = site.rpartition(":")
    return spath == path and int(first) <= int(sline) <= int(last or first)


def lint_hot_roots(setup, caps, cfg, flows, card):
    """21d: each named hot root once, warm, under the sync debug mode."""
    import numpy as np
    import torch

    from cilium_tpu_torch.analysis import devicedataflow as dd
    from cilium_tpu_torch.analysis.core import ProjectIndex
    from cilium_tpu_torch.engine import attribution, replay, ring, session
    from cilium_tpu_torch.engine.replay import CaptureReplay
    from cilium_tpu_torch.fqdn import dnsproxy
    from cilium_tpu_torch.fqdn.dnsproxy import DNSProxy
    from cilium_tpu_torch.policy.api import load_cnp_dir
    from cilium_tpu_torch.runtime import serveloop

    here = os.path.dirname(os.path.abspath(__file__))
    index, _ = ProjectIndex.from_tree(here, ("cilium_tpu_torch",))
    rule = dd.named_root_syncs(index)
    engine = setup["engine"]
    batch = setup["batches"][0]
    rec, l7, offsets, blob = caps["low"]["sections"]
    n = LINT_RECORDS
    # the roots' inputs, staged before anything is recorded
    cap = CaptureReplay(engine, l7, offsets, blob, cfg)
    cap.stage_rows(rec, l7)
    cap.stage_unique(cfg.stage_unique_drop_ratio)
    cap.stage_unique_device()
    cap.stage_verdict_memo()
    chunks = [chunk_sections(flows[s:s + SERVE_CHUNK])
              for s in range(0, n, SERVE_CHUNK)]
    loop, leases = serve_loop(engine, provenance=True)
    rules = dns_rules_of([r for cnp in load_cnp_dir(corpus_dir())
                          for r in cnp.rules], {"app": "crawler"})
    proxy = DNSProxy(use_tpu=True, device=DEVICE)
    proxy.update_allowed(1, DNS_PORT, rules)
    qnames = [f"host{i}.example.com" for i in range(n)]

    def serve_pass():
        for k, sec in enumerate(chunks):
            loop.submit(leases[k % SERVE_STREAMS], *sec)
        while loop.step():
            pass

    passes = {
        "fused_verdict_step": lambda: engine.verdict_batch_arrays(batch),
        "ServeLoop.step": serve_pass,
        "CaptureReplay.verdict_chunk":
            lambda: cap.verdict_chunk(rec[:n], l7[:n], start=0),
        "DNSProxy.check_batch":
            lambda: proxy.check_batch(1, DNS_PORT, qnames),
    }
    for fn in passes.values():      # warm: every root once unrecorded
        fn()
    torch.cuda.synchronize()
    log_ = SyncLog()
    for owner, name, label in (
            (ring.VerdictRing, "pack", "VerdictRing.pack"),
            (session.IncrementalSession, "serve_ids",
             "IncrementalSession.serve_ids"),
            (attribution.ServedPack, "host", "ServedPack.host"),
            (serveloop.ServeLoop, "step", "ServeLoop.step"),
            (replay.CaptureReplay, "verdict_chunk",
             "CaptureReplay.verdict_chunk"),
            (dnsproxy.DNSProxy, "check_batch", "DNSProxy.check_batch")):
        log_.wrap(owner, name, label)
    log_.wrap(engine, "_step", "fused_verdict_step")
    with log_.recording():
        for fn in passes.values():
            fn()
        torch.cuda.synchronize()
    out = {}
    every_seen = [w for r in rule.values() for w in r["seen"]]
    for label_rule, r in sorted(rule.items()):
        label = label_rule.rsplit("::", 1)[1]
        calls, sites = log_.syncs(label)
        # a sync in a callee that is a root of its own (the pack's
        # serve_ids and ServedPack.host) is that root's walk's to see
        elsewhere = sorted({x for x in sites if not any(
            seen_covers(w, x) for w in r["seen"]) and any(
            seen_covers(w, x) for w in every_seen)})
        misses = sorted({x for x in sites if not any(
            seen_covers(w, x) for w in every_seen)})
        out[label] = {"calls": calls, "syncs": len(sites),
                      "sync_sites": sorted(set(sites)),
                      "rule_seen": r["seen"], "rule_findings": r["findings"],
                      "seen_by_another_root": elsewhere, "misses": misses}
        log(f"[lint sync] {label}: {len(sites)} synchronizing calls in "
            f"its {calls} call(s) on {card} at "
            f"{sorted(set(sites))}; the rule's walk sees {r['seen']}, its "
            f"findings {r['findings']}; seen by another root's walk "
            f"{elsewhere}; not seen by the rule: {misses}")
    check(all(v["calls"] > 0 for v in out.values()),
          f"[lint sync] a hot root never ran: "
          f"{ {k: v['calls'] for k, v in out.items()} }")
    return out


def lint_phase(started, setup, caps, cfg, flows, card):
    """Phase 21 (see the module docstring): the lint processes started by
    :func:`start_lint` run while 21c and 21d use the card."""
    import torch

    from cilium_tpu_torch.analysis import pallas_shapes
    from cilium_tpu_torch.engine import dfa_dense_cuda

    t0, full, pre = started
    report = {}
    # 21c: the Hopper launch limits against the card
    attrs, source = device_attributes()
    want = {"warp_size": pallas_shapes.WARP,
            "max_threads_per_block": pallas_shapes.MAX_THREADS,
            "max_shared_memory_per_block_optin": pallas_shapes.SMEM_OPTIN}
    report["device"] = {"card": attrs, "source": source, "rule": want,
                        "SMEM_MAX": dfa_dense_cuda.SMEM_MAX}
    log(f"[lint hopper] the card reports {attrs} ({source}); the rule's "
        f"limits {want}, KD's SMEM_MAX {dfa_dense_cuda.SMEM_MAX} on {card}")
    check(attrs == want and dfa_dense_cuda.SMEM_MAX ==
          attrs["max_shared_memory_per_block_optin"],
          f"[lint hopper] the rule's limits {want} / SMEM_MAX "
          f"{dfa_dense_cuda.SMEM_MAX} differ from the card's {attrs}")
    # 21d: the named hot roots under the sync debug mode
    report["syncs"] = lint_hot_roots(setup, caps, cfg, flows, card)
    torch.cuda.synchronize()
    # 21a, 21b: the processes
    out, err = full.communicate(timeout=600)
    check(full.returncode == 0,
          f"[lint] python -m cilium_tpu_torch.analysis rc "
          f"{full.returncode}: {out[-2000:]} {err[-2000:]}")
    body = json.loads(out)
    check(body["count"] == 0 and body["schema_version"] == 4,
          f"[lint] {body['count']} findings: {body['findings'][:5]}")
    full_s = time.perf_counter() - t0
    pout, perr = pre.communicate(timeout=600)
    check(pre.returncode == 0,
          f"[lint] the precommit face rc {pre.returncode}: "
          f"{pout[-2000:]} {perr[-2000:]}")
    report["lint"] = {"rc": full.returncode, "count": body["count"],
                      "suppressed": body["suppressed"],
                      "wall_ms": body["timings_ms"]["wall"],
                      "timings_ms": body["timings_ms"],
                      "process_s": full_s}
    report["precommit"] = {"rc": pre.returncode,
                           "summary": pout.strip().splitlines()[-1],
                           "process_s": time.perf_counter() - t0}
    log(f"[lint] python -m cilium_tpu_torch.analysis: rc 0, "
        f"{body['count']} findings, {body['suppressed']} allowlisted, wall "
        f"{body['timings_ms']['wall']:.0f} ms of the "
        f"{LINT_WALL_BUDGET_MS} ms budget ({full_s:.1f} s as a process, "
        f"beside 21c/21d); by family {body['timings_ms']}")
    log(f"[lint precommit] cli lint {' '.join(LINT_PRECOMMIT)}: rc 0, "
        f"{report['precommit']['summary']}")
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from cilium_tpu_torch.engine import _build  # fails alone

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    check(bool(smi), "nvidia-smi printed nothing")
    card = smi.splitlines()[0]
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    # the kernels build before the worker pool starts, so that nvcc has
    # the host's cores to itself
    log("phase 2: build")
    secs = _build.build()
    log(f"  built {len(_build.KERNELS)} kernels in {secs:.1f}s "
        f"(nvcc in parallel)")
    # phase 8's oracle samples, computed on the host's other cores while
    # phases 3-7 run (spawned processes: none of them touches the card)
    # and phase 13's service table (its Maglev tables, ~100 s on a core)
    pool = concurrent.futures.ProcessPoolExecutor(
        ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        oracle_jobs = start_oracle(pool)
        lb_job = pool.submit(lb_world)
        # phase 15's CPU replays, queued behind the oracle samples
        dst_jobs = start_dst_cpu(pool)
        return run_phases(torch, smi, card, oracle_jobs, lb_job, dst_jobs)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run_phases(torch, smi, card, oracle_jobs, lb_job, dst_jobs) -> int:
    """Phases 2 (its SASS checks) to 22 (see the module docstring)."""
    from cilium_tpu_torch.engine import _build

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

    kr_noted = {}
    kr_watch = contextlib.ExitStack()
    kr_watch.enter_context(kr_launches_noted(kr_noted))
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
    with fleet_phase(card) as fleet_done:
        log("phase 15: deterministic simulation testing — DSTWorld over "
            "the port's engine on the card, beside phase 10's soak and "
            "fleet")
        dst_report, dst_launches = dst_phase(errs, dst_jobs, card)
        log(f"phase 15 wall {dst_report['wall_s']:.1f} s")
        log("phase 14: the parallel layer (DP, EP, CP and TP lanes, the "
            "collective ledger, the pipeline) on one NCCL rank and on "
            "spawned gloo ranks sharing the card, beside phase 10's soak "
            "and fleet")
        par_report, par_launches, par_variants = parallel_phase(
            loader_engines["loader-path"], scenario.flows, card)
        par_report["beside"] = ["fleet soak", "fleet serve"]
        log(f"phase 14 wall {par_report['wall_s']:.1f} s")
        fleet_report, fleet_launches, fleet_variants, fleet_held = \
            fleet_done()
    churn = fleet_report["churn"]
    churn["phase8_enforce_ms"] = {
        "p50": loader_report["churn"]["enforce_ms_p50"],
        "p99": loader_report["churn"]["enforce_ms_p99"]}
    b27 = fleet_report["bank27"]
    log(f"[fleet churn] update to enforcement p50 / p99 {churn['p50_ms']} / "
        f"{churn['p99_ms']} ms at {CHURN_IDENTITIES} identities x "
        f"{CHURN_CNPS} CNPs (an update on average compile "
        f"{churn['update_split_mean']['compile_ms']:.1f} ms, stage "
        f"{churn['update_split_mean']['stage_ms']:.1f} ms), beside the "
        f"27-bank lane's {b27['p50_ms']} / {b27['p99_ms']} ms (compile "
        f"{b27['compile_ms_per_update']} ms, stage "
        f"{b27['stage_ms_per_update']} ms) and phase 8's "
        f"{churn['phase8_enforce_ms']['p50']:.3f} / "
        f"{churn['phase8_enforce_ms']['p99']:.3f} ms at http-1000; the p99 "
        f"gate ({churn['p99_gate']['factor']} x the lane's = "
        f"{churn['p99_gate']['bound_ms']} ms) "
        + ("held" if churn["p99_gate"]["held"] else
           "did NOT hold (a finding, recorded in the fleet line)"))
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
    log("phase 12: the BASELINE configs (fqdn, mixed, clustermesh) through "
        "the port's Loader, the DNS proxy and its server")
    baseline_report, baseline_launches, baseline_variants, baseline_held = \
        baseline_phase(card)
    log("phase 12: the kernels at the BASELINE stacks, against their plain "
        "versions")
    baseline_report["kernels"] = baseline_kernels(errs, rows, baseline_held,
                                                  card)
    log(f"phase 12 wall {baseline_report['wall_s']:.1f} s (kernel holds "
        f"apart)")
    log("phase 13: the long-payload SP scan, the load balancer and the "
        "phase probes")
    lbsp_report, lbsp_launches, lbsp_variants = lb_sp_probe_phase(
        lb_job, loader_engines["loader-path"], auto_engine, caps,
        scenario.flows, cfg, card)
    log(f"phase 13 wall {lbsp_report['wall_s']:.1f} s")
    t16 = time.perf_counter()
    log("phase 16: the bench plane — tools/bench.py and the other bench "
        "lanes, the canary lane and perf_report, on the card")
    bench_report, bench_launches, bench_variants, bench_noted = \
        bench_phase(card)
    log(f"phase 16: KD, K2 and K1 at the {len(bench_noted)} launch shapes "
        f"the tools staged and at the sweep banks, against their plain "
        f"versions")
    bench_report["held"] = bench_hold(errs, bench_noted, card)
    for kid, rs in bench_report["held"]["rows"].items():
        rows[kid].extend(rs)
    bench_report["wall_s_with_holds"] = time.perf_counter() - t16
    log(f"phase 16 wall {bench_report['wall_s']:.1f} s "
        f"({bench_report['wall_s_with_holds']:.1f} s with the holds)")
    t17 = time.perf_counter()
    log("phase 17: the observability and ingest plane — flowpb, JSONL and "
        "binary captures through the replay cursor, the fan-out into the "
        "monitor and the Hubble observer, their sockets, the exporter and "
        "the metrics")
    observe_report, observe_launches, observe_variants, observe_noted = \
        observe_phase(loader_engines["loader-path"], scenario.flows, card)
    log(f"phase 17: KD and K1 at the {len(observe_noted)} launch shapes "
        f"the phase staged, against their plain versions")
    observe_report["held"] = hold_noted(errs, observe_noted, "observe")
    observe_report["wall_s_with_holds"] = time.perf_counter() - t17
    log(f"phase 17 wall {observe_report['wall_s']:.1f} s "
        f"({observe_report['wall_s_with_holds']:.1f} s with the holds)")
    t18 = time.perf_counter()
    log("phase 18: the node-local agent — Agent on the card with its "
        "sockets, endpoints and policy over REST, process_flows, mutual "
        "auth, trace and explain, the gate's round trip, the profiler, "
        "the service's agent ops and the CNI plugin")
    agent_report, agent_launches, agent_variants, agent_noted = \
        agent_phase(card)
    log(f"phase 18: KD, K2 and K1 at the {len(agent_noted)} launch shapes "
        f"the phase staged, against their plain versions")
    agent_report["held"] = hold_noted(errs, agent_noted, "agent")
    agent_report["wall_s_with_holds"] = time.perf_counter() - t18
    log(f"phase 18 wall {agent_report['wall_s']:.1f} s "
        f"({agent_report['wall_s_with_holds']:.1f} s with the holds)")
    t19 = time.perf_counter()
    log("phase 19: the cluster control services — kvstore, apiserver, two "
        "operators under leader election and the live relay as processes, "
        "two agents on the card, a CNP through the apiserver, failover")
    cluster_report, cluster_launches, cluster_variants, cluster_noted = \
        cluster_phase(card)
    log(f"phase 19: KD, K2 and K1 at the {len(cluster_noted)} launch shapes "
        f"the phase staged, against their plain versions")
    cluster_report["held"] = hold_noted(errs, cluster_noted, "cluster")
    check(cluster_report["held"]["KD"] > 0
          and cluster_report["held"]["K1"] > 0,
          f"[cluster] no KD or K1 launch shape held: "
          f"{cluster_report['held']}")
    cluster_report["wall_s_with_holds"] = time.perf_counter() - t19
    log(f"phase 19 wall {cluster_report['wall_s']:.1f} s "
        f"({cluster_report['wall_s_with_holds']:.1f} s with the holds)")
    t20 = time.perf_counter()
    log("phase 20: the daemon and the CLI — python -m "
        "cilium_tpu_torch.daemon on the card from its TOML, the CLI over "
        "its sockets, offline replay, capture tooling, bugtool, k8s, the "
        "warm restart and the cross-cluster churn leg")
    daemon_report, daemon_launches, daemon_variants, daemon_noted = \
        daemon_phase(card, b27["p99_ms"])
    log(f"phase 20: KD, K2 and K1 at the {len(daemon_noted)} launch shapes "
        f"the phase staged in this process, against their plain versions")
    daemon_report["held"] = hold_noted(errs, daemon_noted, "daemon")
    check(daemon_report["held"]["KD"] > 0,
          f"[daemon] no KD launch shape held: {daemon_report['held']}")
    daemon_report["wall_s_with_holds"] = time.perf_counter() - t20
    log(f"phase 20 wall {daemon_report['wall_s']:.1f} s "
        f"({daemon_report['wall_s_with_holds']:.1f} s with the holds)")
    t21 = time.perf_counter()
    log("phase 21: ctlint — the port's lint and its precommit face as "
        "processes on the card's host, the Hopper launch limits against "
        "the card, the named hot roots under the sync debug mode")
    lint_report = lint_phase(start_lint(), setups["auto"], caps, cfg,
                             scenario.flows, card)
    lint_report["wall_s"] = time.perf_counter() - t21
    log(f"phase 21 wall {lint_report['wall_s']:.1f} s")
    kr_watch.close()
    log(f"phase 22: KR at the {len(kr_noted)} launch shapes phases 3-21 "
        f"staged, against its plain version")
    kr_report = kr_hold(errs, rows, kr_noted, card)
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
    phase_launches.update(baseline_launches)
    phase_launches.update(lbsp_launches)
    phase_launches["parallel"] = par_launches
    phase_launches.update(dst_launches)
    phase_launches.update(bench_launches)
    phase_launches["observe"] = observe_launches
    phase_launches["agent"] = agent_launches
    phase_launches["cluster"] = cluster_launches
    phase_launches["daemon"] = daemon_launches
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
    phase_variants.update(baseline_variants)
    phase_variants.update(lbsp_variants)
    phase_variants["parallel"] = par_variants
    phase_variants.update(bench_variants)
    phase_variants["observe"] = observe_variants
    phase_variants["agent"] = agent_variants
    phase_variants["cluster"] = cluster_variants
    phase_variants["daemon"] = daemon_variants
    # the JSON line reports each kernel at its largest main-path shape
    pick = {"KD": "path", "K1": "host", "K2": "host", "KR": "largest"}
    kernels = []
    for kid, k in _build.KERNELS.items():
        row = next(r for r in rows[kid] if r[0] == pick[kid])
        kernels.append({
            "name": f"{kid}:{k.name}", "route": "cuda",
            "source": f"cilium_tpu_torch/engine/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": sum(ln.get(kid, 0)
                            for ln in phase_launches.values()),
            "phases": {n: ln[kid] for n, ln in phase_launches.items()
                       if ln.get(kid)},
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
            # phase 12's stacks: each lane's fields, and the DNS
            # proxy's batch at L = 256
            "baseline_shapes": {
                n: r["rows"].get(kid, [])
                for n, r in baseline_report["kernels"].items()},
            # phase 15: the DST worlds' launch shapes held exactly
            "dst_shapes_held": dst_report["held_shapes"].get(kid, 0),
            # phase 16: the tools' launch shapes and the sweep banks held
            "bench_shapes_held": bench_report["held"]["noted"].get(kid, 0),
            "bench_sweep_banks": {n: v["nfa" if kid == "K1" else "dense"]
                                  for n, v in
                                  bench_report["held"]["sweep"].items()
                                  if kid != "KR"},
            # phase 17: the launch shapes of the observability plane
            "observe_shapes_held": observe_report["held"].get(kid, 0),
            # phase 18: the launch shapes of the agent plane
            "agent_shapes_held": agent_report["held"].get(kid, 0),
            # phase 19: the launch shapes of the two agents on the
            # cluster control services
            "cluster_shapes_held": cluster_report["held"].get(kid, 0),
            # phase 20: the launch shapes of the replays and the
            # cross-cluster leg in this process (the daemon's own
            # launches are in its process: its device profile names them)
            "daemon_shapes_held": daemon_report["held"].get(kid, 0),
            # phase 22: KR's launch shapes of phases 3-21
            **({"shapes_held": kr_report["held"],
                "largest_shape": kr_report["largest"]}
               if kid == "KR" else {}),
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
    log("baseline: " + json.dumps(baseline_report))
    log("lb_sp_probe: " + json.dumps(lbsp_report))
    log("parallel: " + json.dumps(par_report))
    log("dst: " + json.dumps(dst_report))
    log("bench: " + json.dumps(bench_report))
    log("observe: " + json.dumps(observe_report))
    log("agent: " + json.dumps(agent_report))
    log("cluster: " + json.dumps(cluster_report))
    log("daemon: " + json.dumps(daemon_report))
    log("lint: " + json.dumps(lint_report))
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
