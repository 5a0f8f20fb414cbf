"""The plain PyTorch versions of the port's kernels against the JAX
package's functions, on the CPU, exactly.

* KD (dense-gather DFA scan + accept reads) ≡ ``dfa_scan_banked``
  with ``impl="gather"``;
* K2 (data-oblivious DFA scan) ≡ ``pallas_dfa.dfa_finals_pallas`` in
  interpret mode, at the shapes of ``tests/test_pallas_dfa.py``;
* K1 (bitset-NFA scan) ≡ ``nfa_scan_banked(use_pallas=True,
  interpret=True)``, at the shapes of ``tests/test_megakernel.py``,
  plus a 0-position bank, a full 128-position bank and zero-length
  rows.

The CUDA kernels themselves are held against these same plain versions
on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``). Also
here: the int32-bit-pattern helpers of the resolve against the JAX
uint32 originals, bit 31 included.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilium_tpu.core.config import EngineConfig
from cilium_tpu.engine import nfa_kernel as jax_nfa
from cilium_tpu.engine import pallas_dfa, pallas_nfa
from cilium_tpu.engine import verdict as jax_verdict
from cilium_tpu.engine.dfa_kernel import dfa_finals_banked as \
    jax_dfa_scan_finals
from cilium_tpu.engine.dfa_kernel import dfa_scan_banked as jax_dfa_scan
from cilium_tpu.policy.compiler.dfa import compile_patterns

from cilium_tpu_torch.engine import (
    _build,
    dfa_kernel,
    nfa_cuda,
    nfa_kernel,
    resolve_cuda,
)
from cilium_tpu_torch.engine import verdict as tv
from cilium_tpu_torch.engine.dfa_dense_cuda import dense_scan_plain
from cilium_tpu_torch.engine.dfa_oblivious_cuda import (
    dfa_finals_oblivious_plain,
)
from cilium_tpu_torch.weights import stage_array
from resolve_cases import BLOCK_COLS, GROUPS, random_case, torch_args


def T(a):
    return stage_array(a, torch.device("cpu"))


def as_u32(t):
    return t.numpy().view(np.uint32)


def _random_banked(rng, nb, s, k, b, l, w=1):
    trans = rng.integers(0, s, (nb, s, k)).astype(np.int32)
    byteclass = rng.integers(0, k, (nb, 256)).astype(np.int32)
    start = rng.integers(0, s, (nb,)).astype(np.int32)
    accept = rng.integers(0, 2 ** 32, (nb, s, w), dtype=np.uint64) \
        .astype(np.uint32)
    data = rng.integers(0, 256, (b, l)).astype(np.uint8)
    lengths = rng.integers(0, l + 1, (b,)).astype(np.int32)
    return trans, byteclass, start, accept, data, lengths


DFA_SHAPES = [
    (1, 2, 1, 7, 4),          # degenerate empty-matcher shape
    (3, 17, 5, 50, 12),
    (2, 128, 31, 40, 9),      # full state budget
]


# ------------------------------------------------------------------- KD
@pytest.mark.parametrize("nb,s,k,b,l", DFA_SHAPES + [(4, 300, 20, 33, 32)])
def test_kd_plain_equals_gather(nb, s, k, b, l):
    rng = np.random.default_rng(nb * 1000 + s)
    trans, bc, start, accept, data, lengths = _random_banked(
        rng, nb, s, k, b, l, w=2)
    extra = accept[:, :, :1] ^ np.uint32(0x80000001)
    want, want_x = jax_dfa_scan(trans, bc, start, accept, data, lengths,
                                impl="gather", extra_accept=extra)
    got, got_x = dense_scan_plain(T(trans), T(bc), T(start), T(data),
                                  T(lengths), accept=T(accept),
                                  extra=T(extra))
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))
    np.testing.assert_array_equal(as_u32(got_x), np.asarray(want_x))


#: (NB, S, K, B, L): L on and off KD's 16-byte row loads and past one
KD_EDGES = [(2, 17, 5, 9, 1), (1, 40, 7, 12, 15), (3, 128, 31, 20, 16),
            (2, 300, 20, 11, 17), (1, 74, 16, 13, 33)]


@pytest.mark.parametrize("nb,s,k,b,l", KD_EDGES)
@pytest.mark.parametrize("lengths", ["over and negative", "blob column"])
def test_kd_plain_edges_equal_gather(nb, s, k, b, l, lengths):
    """Lengths past L and below 0 (the reference steps min(max(len, 0),
    L) bytes), and data that is a column slice of a wider u8 blob at an
    odd offset with its lengths a strided int32 column — the blob
    transport's layout, which KD reads in place."""
    rng = np.random.default_rng(nb * 7919 + s * 31 + l)
    trans, bc, start, accept, data, lens = _random_banked(
        rng, nb, s, k, b, l, w=3)
    lens = rng.integers(-4, l + 6, (b,)).astype(np.int32)
    lens[:2] = (-1, l + 1)
    extra = accept[:, :, :2] ^ np.uint32(0x80000001)
    want, want_x = jax_dfa_scan(trans, bc, start, accept, data, lens,
                                impl="gather", extra_accept=extra)
    if lengths == "blob column":
        blob = rng.integers(0, 256, (b, l + 9)).astype(np.uint8)
        blob[:, 3:3 + l] = data
        cols = np.stack([lens + 1, lens, lens - 1], axis=1)
        tdata, tlens = T(blob)[:, 3:3 + l], T(cols)[:, 1]
        assert tdata.stride() == (l + 9, 1) and tlens.stride() == (3,)
    else:
        tdata, tlens = T(data), T(lens)
    got, got_x = dense_scan_plain(T(trans), T(bc), T(start), tdata, tlens,
                                  accept=T(accept), extra=T(extra))
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))
    np.testing.assert_array_equal(as_u32(got_x), np.asarray(want_x))
    finals = dense_scan_plain(T(trans), T(bc), T(start), tdata, tlens)
    np.testing.assert_array_equal(
        finals.numpy(), np.asarray(jax_dfa_scan_finals(
            trans, bc, start, data, lens, impl="gather")))


def test_kd_plain_on_compiled_patterns():
    pats = [r"/api/v[0-9]+/users", r"/health", r"GET|POST",
            r"[a-z]+\.example\.com", r"/static/.*\.js"]
    arrs = compile_patterns(pats, bank_size=2, max_states=128).stacked()
    strings = [b"/api/v1/users", b"/health", b"GET", b"POST",
               b"foo.example.com", b"/static/app.js", b"/nope",
               b"x" * 40, b""]
    data = np.zeros((len(strings), 48), dtype=np.uint8)
    lengths = np.zeros(len(strings), dtype=np.int32)
    for i, s in enumerate(strings):
        data[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
        lengths[i] = len(s)
    want = jax_dfa_scan(arrs["trans"], arrs["byteclass"], arrs["start"],
                        arrs["accept"], data, lengths, impl="gather")
    got = dfa_kernel.dfa_scan_banked(
        T(arrs["trans"]), T(arrs["byteclass"]), T(arrs["start"]),
        T(arrs["accept"]), T(data), T(lengths), impl="gather")
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))


def test_single_bank_entry_points_equal_reference():
    """``dfa_scan`` and ``nfa_finals``: the reference's one-bank faces."""
    from cilium_tpu.engine.dfa_kernel import dfa_scan as jax_dfa_scan_one

    rng = np.random.default_rng(5)
    trans, bc, start, _, data, lengths = _random_banked(rng, 1, 40, 6, 30, 10)
    want = jax_dfa_scan_one(jnp.asarray(trans[0]), jnp.asarray(bc[0]),
                            start[0], jnp.asarray(data),
                            jnp.asarray(lengths))
    got = dfa_kernel.dfa_scan(T(trans[0]), T(bc[0]), int(start[0]),
                              T(data), T(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    st = _random_stack(rng, 1, 20, 6)
    want = jax_nfa.nfa_finals(
        *(jnp.asarray(st[k][0]) for k in ("nfa_follow", "nfa_acc_cls",
                                           "nfa_byteclass", "nfa_start")),
        jnp.asarray(data), jnp.asarray(lengths))
    got = nfa_kernel.nfa_finals(T(st["nfa_follow"][0]),
                                T(st["nfa_acc_cls"][0]),
                                T(st["nfa_byteclass"][0]),
                                T(st["nfa_start"][0]), T(data), T(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------- K2
@pytest.mark.parametrize("nb,s,k,b,l", DFA_SHAPES)
def test_k2_plain_equals_pallas_interpret(nb, s, k, b, l):
    rng = np.random.default_rng(nb * 1000 + s)
    trans, bc, start, accept, data, lengths = _random_banked(
        rng, nb, s, k, b, l)
    want = pallas_dfa.dfa_finals_pallas(trans, bc, start, data, lengths,
                                        interpret=True)
    got = dfa_finals_oblivious_plain(T(trans), T(bc), T(start), T(data),
                                     T(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the banked entry's oblivious arm gives the gather arm's words
    words = dfa_kernel.dfa_scan_banked(
        T(trans), T(bc), T(start), T(accept), T(data), T(lengths),
        impl="oblivious")
    want_w = jax_dfa_scan(trans, bc, start, accept, data, lengths,
                          impl="gather")
    np.testing.assert_array_equal(as_u32(words), np.asarray(want_w))


def test_k2_arm_over_budget_warns_and_gathers():
    rng = np.random.default_rng(7)
    trans, bc, start, accept, data, lengths = _random_banked(
        rng, 2, 129, 4, 16, 8)
    with pytest.warns(RuntimeWarning, match="constant-time guarantee"):
        got = dfa_kernel.dfa_scan_banked(
            T(trans), T(bc), T(start), T(accept), T(data), T(lengths),
            impl="oblivious")
    want = jax_dfa_scan(trans, bc, start, accept, data, lengths,
                        impl="gather")
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))


# ------------------------------------------------------------------- K1
PATTERNS = [
    "/api/v[0-9]+/users/.*", "GET|POST", "foo(bar)?baz", "a{2,4}b",
    "[a-c]+x", "(ab|cd)*", "x[^0-9]y", "h?ello+", "", ".*",
]


def _rand_payloads(n, L, seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(n, L)).astype(np.uint8)
    for i, s in enumerate(["/api/v1/users/42", "GET", "foobarbaz",
                           "aab", "abab", "xay", "hello", "", "cd",
                           "aaab"]):
        b = s.encode()[:L]
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        data[i, len(b):] = 0
    lens = rng.integers(0, L + 1, size=(n,)).astype(np.int32)
    lens[:10] = np.minimum([16, 3, 9, 3, 4, 3, 5, 0, 2, 4], L)
    return data, lens


def _random_stack(rng, nb, p, k, w=1):
    return {
        "nfa_follow": (rng.random((nb, p, p)) < 0.08).astype(np.float32),
        "nfa_acc_cls": (rng.random((nb, p, k)) < 0.6).astype(np.float32),
        "nfa_byteclass": rng.integers(0, k, (nb, 256)).astype(np.int32),
        "nfa_start": (rng.random((nb, p)) < 0.3).astype(np.float32),
        "nfa_accept": rng.integers(0, 2 ** 32, (nb, p, w),
                                   dtype=np.uint64).astype(np.uint32),
        "nfa_empty": rng.integers(0, 2 ** 32, (nb, w),
                                  dtype=np.uint64).astype(np.uint32),
    }


def _compiled_stack(case):
    if case == "patterns":
        banked = compile_patterns(PATTERNS, bank_size=4)
        banks = jax_nfa.banks_from_dfa(banked, EngineConfig())
    else:          # "empty": the 0-position dead bank, padded to Pm=1
        banks = [jax_nfa.compile_nfa_bank([])]
    return jax_nfa.stack_nfa_banks(banks)


@pytest.mark.parametrize("case,n,L", [
    ("patterns", 48, 16),      # tests/test_megakernel.py's shapes
    ("patterns", 300, 32),
    ("empty", 20, 8),          # P=0 bank
    ("random-p128", 70, 12),   # the full position budget
    ("random-p33", 1030, 5),   # B past one Pallas tile, odd P
])
def test_k1_plain_equals_pallas_interpret(case, n, L):
    rng = np.random.default_rng(len(case) * 100 + n)
    if case.startswith("random"):
        p = int(case.split("-p")[1])
        stacked = _random_stack(rng, 2, p, 7, w=2)
    else:
        stacked = _compiled_stack(case)
    data, lens = _rand_payloads(n, L, seed=n)
    lens[-3:] = 0                                   # zero-length rows
    jstacked = {k: jnp.asarray(v) for k, v in stacked.items()}
    want = jax_nfa.nfa_scan_banked(jstacked, jnp.asarray(data),
                                   jnp.asarray(lens), use_pallas=True,
                                   interpret=True)
    tstacked = {k: T(v) for k, v in stacked.items()}
    got = nfa_kernel.nfa_scan_banked(tstacked, T(data), T(lens))
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))
    # finals: equal wherever the flow is non-empty (zero-length rows
    # differ by convention and are overridden by the empty words)
    jf = np.asarray(pallas_nfa.nfa_finals_pallas(
        jstacked["nfa_follow"], jstacked["nfa_acc_cls"],
        jstacked["nfa_byteclass"], jstacked["nfa_start"],
        jnp.asarray(data), jnp.asarray(lens), interpret=True))
    tf = nfa_cuda.nfa_finals_plain(
        tstacked["nfa_follow"], tstacked["nfa_acc_cls"],
        tstacked["nfa_byteclass"], tstacked["nfa_start"],
        T(data), T(lens)).numpy()
    live = lens > 0
    np.testing.assert_array_equal(tf[:, live], jf[:, live])
    assert not tf[:, ~live].any()


def test_k1_group_plane_words():
    rng = np.random.default_rng(11)
    stacked = _random_stack(rng, 3, 40, 6)
    stacked["nfa_gaccept"] = rng.integers(
        0, 2 ** 32, (3, 40, 2), dtype=np.uint64).astype(np.uint32)
    data, lens = _rand_payloads(64, 10, seed=4)
    want_w, want_g = jax_nfa.nfa_scan_banked(
        {k: jnp.asarray(v) for k, v in stacked.items()},
        jnp.asarray(data), jnp.asarray(lens), extra_accept=True)
    got_w, got_g = nfa_kernel.nfa_scan_banked(
        {k: T(v) for k, v in stacked.items()}, T(data), T(lens),
        extra_accept=True)
    np.testing.assert_array_equal(as_u32(got_w), np.asarray(want_w))
    np.testing.assert_array_equal(as_u32(got_g), np.asarray(want_g))


# ------------------------------------------- the padding the kernels use
@pytest.mark.parametrize("s,k,p", [(1, 1, 1), (17, 13, 17), (78, 256, 108),
                                   (78, 13, 1), (1, 256, 17)])
def test_plain_versions_ignore_tile_padding(s, k, p):
    """The tensor-core kernels pad K2's table to SP = 16·⌈S/16⌉ states
    and KP = 8·⌈(K+1)/8⌉ columns, and K1's tables to PP = 16·⌈P/16⌉
    positions and KC = 16·⌈K/16⌉ classes, all with zeros. The plain
    versions on the padded tables give the unpadded answer: padded
    states are unreachable, padded classes never selected, padded
    positions never set."""
    rng = np.random.default_rng(s * 1000 + k + p)
    nb, b, l = 2, 40, 9
    data = T(rng.integers(0, 256, (b, l)).astype(np.uint8))
    lens = rng.integers(0, l + 1, (b,)).astype(np.int32)
    lens[:2] = 0
    lens[2:4] = l
    lens = T(lens)
    # K2: columns 0..K-1, the identity at K, zeros up to KP - 1
    sp, kp = -(-s // 16) * 16, -(-(k + 1) // 8) * 8
    trans = rng.integers(0, s, (nb, s, k)).astype(np.int32)
    bc = T(rng.integers(0, k, (nb, 256)).astype(np.int32))
    start = T(rng.integers(0, s, (nb,)).astype(np.int32))
    padded = np.zeros((nb, sp, kp - 1), np.int32)
    padded[:, :s, :k] = trans
    if k < kp - 1:
        padded[:, :s, k] = np.arange(s)
    want = dfa_finals_oblivious_plain(T(trans), bc, start, data, lens)
    got = dfa_finals_oblivious_plain(T(padded), bc, start, data, lens)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # K1: follow, acc and start zero-padded to PP (acc's classes to KC)
    pp, kc = -(-p // 16) * 16, -(-k // 16) * 16
    st = _random_stack(rng, nb, p, k)
    fol = np.zeros((nb, pp, pp), np.float32)
    fol[:, :p, :p] = st["nfa_follow"]
    acc = np.zeros((nb, pp, kc), np.float32)
    acc[:, :p, :k] = st["nfa_acc_cls"]
    sta = np.zeros((nb, pp), np.float32)
    sta[:, :p] = st["nfa_start"]
    nbc = T(st["nfa_byteclass"])
    want = nfa_cuda.nfa_finals_plain(T(st["nfa_follow"]),
                                     T(st["nfa_acc_cls"]), nbc,
                                     T(st["nfa_start"]), data, lens)
    got = nfa_cuda.nfa_finals_plain(T(fol), T(acc), nbc, T(sta), data, lens)
    np.testing.assert_array_equal(got[:, :, :p].numpy(), want.numpy())
    assert not got[:, :, p:].any()


# ------------------------------------------------------ int32 bit helpers
def _rand_words(rng, b, w, density):
    words = rng.integers(0, 2 ** 32, (b, w), dtype=np.uint64) \
        .astype(np.uint32)
    words[rng.random((b, w)) > density] = 0
    words[0, 0] = np.uint32(1 << 31)          # bit 31 alone
    return words


@pytest.mark.parametrize("w,density", [(1, 0.5), (3, 0.2), (5, 0.05)])
def test_first_lane_equals_reference(w, density):
    words = _rand_words(np.random.default_rng(w), 64, w, density)
    want = jax_verdict._first_lane(jnp.asarray(words))
    got = tv._first_lane(T(words))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("r,n_words", [(1, 1), (32, 1), (33, 2), (70, 3)])
def test_bools_to_words_equals_reference(r, n_words):
    bools = np.random.default_rng(r).random((40, r)) < 0.4
    bools[0, :] = True
    want = jax_verdict._bools_to_words(jnp.asarray(bools), n_words)
    got = tv._bools_to_words(torch.from_numpy(bools), n_words)
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))


def test_rule_bit_equals_reference():
    rng = np.random.default_rng(3)
    words = _rand_words(rng, 30, 3, 0.7)
    lanes = rng.integers(-1, 96, (17, 4)).astype(np.int32)
    for lane_set in (lanes[:, 0], lanes):
        if lane_set.ndim == 1:
            want = jax_verdict._rule_bit(jnp.asarray(words),
                                         jnp.asarray(lane_set))
        else:
            want = np.stack([np.asarray(jax_verdict._rule_bit(
                jnp.asarray(words), jnp.asarray(lane_set[:, j])))
                for j in range(lane_set.shape[1])], axis=2)
        got = tv._rule_bit(T(words), T(lane_set))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_or_reduce_equals_reference(n):
    x = np.random.default_rng(n).integers(
        0, 2 ** 32, (5, n, 3), dtype=np.uint64).astype(np.uint32)
    want = jax_nfa._or_reduce(jnp.asarray(x), 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = nfa_kernel._or_reduce(T(x), 1)
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))


# ------------------------------------------- kafka / generic resolve helpers
def _kafka_generic_inputs(rng, B=64, R=40, RS=5, G=6, F=4, Km=3):
    u32 = rng.integers(0, 2 ** 32, R, dtype=np.uint64).astype(np.uint32)
    u32[::4] = 0                                   # api-key unconstrained
    u32[1] = np.uint32(1 << 31)                    # only api key 31
    arrays = {
        "kafka_apikey_mask": u32,
        "kafka_version": rng.integers(-1, 3, R).astype(np.int32),
        "kafka_client": rng.integers(-1, 3, R).astype(np.int32),
        "kafka_topic": rng.integers(-1, 3, R).astype(np.int32),
        "rs_kafka_mask": rng.integers(0, 2 ** 32, (RS, 2),
                                      dtype=np.uint64).astype(np.uint32),
        "rp_k_rule_group": rng.integers(-1, 9, R).astype(np.int32),
        "rp_k_apikey_mask": u32[:G],
        "rp_k_version": rng.integers(-1, 3, G).astype(np.int32),
        "rp_k_client": rng.integers(-1, 3, G).astype(np.int32),
        "rp_k_topic": rng.integers(-1, 3, G).astype(np.int32),
        "rp_rs_kmask": rng.integers(0, 2 ** 32, (RS, 1),
                                    dtype=np.uint64).astype(np.uint32),
        "gen_rule_proto": rng.integers(-1, 3, R).astype(np.int32),
        "gen_rule_pairs": rng.integers(-1, 6, (R, Km)).astype(np.int32),
        "rs_gen_mask": rng.integers(0, 2 ** 32, (RS, 2),
                                    dtype=np.uint64).astype(np.uint32),
        "rp_gen_rule_group": rng.integers(-1, 9, R).astype(np.int32),
        "rp_gen_proto": rng.integers(-1, 3, G).astype(np.int32),
        "rp_gen_pairs": rng.integers(-1, 6, (G, Km)).astype(np.int32),
        "rp_rs_genmask": rng.integers(0, 2 ** 32, (RS, 1),
                                      dtype=np.uint64).astype(np.uint32),
    }
    ruleset = rng.integers(0, RS, B).astype(np.int32)
    kafka_cols = (rng.integers(-1, 32, B).astype(np.int32),
                  rng.integers(0, 3, B).astype(np.int32),
                  rng.integers(-2, 3, B).astype(np.int32),
                  rng.integers(-2, 3, B).astype(np.int32))
    kafka_cols[0][:4] = 31                           # bit-31 api key
    gen_cols = (rng.integers(-2, 3, B).astype(np.int32),
                rng.integers(-2, 6, (B, F)).astype(np.int32))
    l7t = rng.integers(0, 5, B).astype(np.int32)
    return arrays, ruleset, kafka_cols, gen_cols, l7t


@pytest.mark.parametrize("helper,with_groups", [
    ("_l7_kafka", True), ("_l7_kafka", False),
    ("_l7_generic", True), ("_l7_generic", False),
    ("_fused_l7_kafka", True), ("_fused_l7_generic", True)])
def test_kafka_generic_helpers_equal_reference(helper, with_groups):
    """``with_groups=False``: the per-rule winner in rule space (a plan
    without the rule→group maps)."""
    from cilium_tpu.engine import megakernel as jax_mk

    from cilium_tpu_torch.engine import megakernel as mk

    arrays, ruleset, kafka_cols, gen_cols, l7t = _kafka_generic_inputs(
        np.random.default_rng(len(helper)))
    if not with_groups:
        arrays = {k: v for k, v in arrays.items()
                  if k not in ("rp_k_rule_group", "rp_gen_rule_group")}
    cols = kafka_cols if "kafka" in helper else gen_cols
    jax_fn = getattr(jax_mk if helper.startswith("_fused") else jax_verdict,
                     helper)
    port_fn = getattr(mk if helper.startswith("_fused") else tv, helper)
    want_ok, want_win = jax_fn({k: jnp.asarray(v) for k, v in arrays.items()},
                               jnp.asarray(ruleset),
                               tuple(jnp.asarray(c) for c in cols),
                               jnp.asarray(l7t))
    got_ok, got_win = port_fn({k: T(v) for k, v in arrays.items()},
                              T(ruleset).long(), tuple(T(c) for c in cols),
                              T(l7t))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_win.numpy(), np.asarray(want_win))
    assert np.asarray(want_ok).any() or helper.endswith("generic")


# ------------------------------------------------ KR: the group-space resolve
@pytest.mark.parametrize("gen", [True, False])
@pytest.mark.parametrize("G", GROUPS)
def test_resolve_groups_plain_equals_reference(G, gen):
    """KR's plain version against the JAX package's ``fused_verdict_core``
    lanes: with ``allowed`` and ``redirect`` set on every row, its
    ``l7_log`` is the resolve's ``l7_log_http``."""
    from cilium_tpu.engine import megakernel as jax_mk

    arrays, inputs = random_case(G, G, 200, gen=gen)
    block, B = inputs["block"], 200
    ms = {"allowed": jnp.ones(B, bool), "redirect": jnp.ones(B, bool),
          "auth_required": jnp.zeros(B, bool),
          "match_spec": jnp.zeros(B, jnp.int32),
          "ruleset": jnp.asarray(inputs["ruleset"])}
    gen_cols = ((jnp.asarray(block[:, 5]), jnp.asarray(block[:, BLOCK_COLS:]))
                if gen else None)
    want = jax_mk.fused_verdict_core(
        {k: jnp.asarray(v) for k, v in arrays.items()}, ms,
        jnp.asarray(block[:, 0]), tuple(jnp.asarray(w) for w in inputs["words"]),
        jnp.asarray(inputs["gwords"]),
        tuple(jnp.asarray(block[:, c]) for c in range(1, 5)), None, {},
        gen_cols=gen_cols)
    got = resolve_cuda.resolve_groups_plain(
        *torch_args(arrays, inputs, torch.device("cpu")))
    for lane, g in zip(("l7_ok", "l7_log", "l7_match"), got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[lane]), lane)
    assert got[0].any() and (got[2] >= 0).any()


def test_resolve_groups_cuda_raises_on_cpu_tensors():
    args = torch_args(*random_case(0, 15, 8), torch.device("cpu"))
    with pytest.raises(_build.KernelArgumentError):
        resolve_cuda.resolve_groups_cuda(*args)


def test_fused_verdict_core_on_cpu_takes_the_plain_version(monkeypatch):
    from cilium_tpu_torch.engine import megakernel as mk

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached KR")

    monkeypatch.setattr(resolve_cuda, "resolve_groups_cuda", refuse)
    arrays, ruleset, l7t, words, gwords, kafka, gen = torch_args(
        *random_case(1, 15, 64), torch.device("cpu"))
    B = ruleset.shape[0]
    ms = {"allowed": torch.ones(B, dtype=torch.bool),
          "redirect": torch.ones(B, dtype=torch.bool),
          "auth_required": torch.zeros(B, dtype=torch.bool),
          "match_spec": torch.zeros(B, dtype=torch.int32), "ruleset": ruleset}
    _build.reset_launches()
    out = mk.fused_verdict_core(arrays, ms, l7t, words, gwords, kafka, None,
                                {}, gen_cols=gen)
    want = resolve_cuda.resolve_groups_plain(arrays, ruleset, l7t, words,
                                             gwords, kafka, gen_cols=gen)
    for lane, w in zip(("l7_ok", "l7_log", "l7_match"), want):
        assert torch.equal(out[lane], w), lane
    assert resolve_cuda.KERNEL.launches == 0
