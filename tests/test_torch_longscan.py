"""The port's sequence-parallel payload scan against the JAX package's,
exact, on the CPU.

* ``payload_scan_sp`` on ``tests/test_longscan.py``'s PATTERNS bank
  (L = 2048 with block 128, L = 1000 with block 256) against the
  reference's ``payload_scan_sp`` and its per-byte ``dfa_scan(impl=
  "gather")``, and against the port's KD path (``dfa_finals_banked``,
  its plain version on the CPU);
* hypothesis cases over S, K, L, block, the start state and lengths,
  negative and past-L lengths included (held against the reference's
  SP, whose ``pos < lengths`` mask decides them, not against KD's edge
  handling);
* ``block_transitions`` with and without ``valid``.

Integer functions: the tolerance is 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cilium_tpu.engine import longscan as jls
from cilium_tpu.engine.dfa_kernel import dfa_scan as jax_dfa_scan
from cilium_tpu.policy.compiler.dfa import compile_patterns

from cilium_tpu_torch.engine import longscan
from cilium_tpu_torch.engine.dfa_kernel import dfa_finals_banked, dfa_scan

PATTERNS = [".*attack-signature.*", ".*(GET|POST) /evil.*",
            ".*xx[0-9]{3}yy.*"]


def _setup(L, B=16, seed=0):
    """``tests/test_longscan.py``'s inputs: one bank, signatures planted
    in three rows, lengths in [L/2, L) and three full rows."""
    bank = compile_patterns(PATTERNS, bank_size=8).banks[0]
    rng = np.random.default_rng(seed)
    data = rng.integers(97, 123, size=(B, L), dtype=np.uint8)
    data[0, 100:116] = np.frombuffer(b"attack-signature", dtype=np.uint8)
    data[1, L - 30:L - 19] = np.frombuffer(b"POST /evil!", dtype=np.uint8)
    data[2, 5:12] = np.frombuffer(b"xx123yy", dtype=np.uint8)
    lengths = rng.integers(L // 2, L, size=(B,)).astype(np.int32)
    lengths[:3] = L
    return bank, data, lengths


def _port_sp(trans, bc, start, data, lengths, block):
    return longscan.payload_scan_sp(
        torch.from_numpy(trans), torch.from_numpy(bc), start,
        torch.from_numpy(data), torch.from_numpy(lengths), block=block
    ).numpy()


#: jitted once: a shape compiles once, and each case after it is quick
_REF_SP = jax.jit(jls.payload_scan_sp, static_argnames=("block",))


def _ref_sp(trans, bc, start, data, lengths, block):
    return np.asarray(_REF_SP(
        jnp.asarray(trans), jnp.asarray(bc), jnp.int32(start),
        jnp.asarray(data), jnp.asarray(lengths), block=block))


def test_sp_equals_reference_and_sequential_on_the_patterns_bank():
    for L, block in ((2048, 128), (1000, 256)):
        bank, data, lengths = _setup(L)
        trans = np.asarray(bank.trans, np.int32)
        bc = np.asarray(bank.byteclass, np.int32)
        got = _port_sp(trans, bc, int(bank.start), data, lengths, block)
        want = _ref_sp(trans, bc, int(bank.start), data, lengths, block)
        seq = np.asarray(jax_dfa_scan(
            jnp.asarray(trans), jnp.asarray(bc), jnp.int32(bank.start),
            jnp.asarray(data), jnp.asarray(lengths), impl="gather"))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, seq)
        # the port's own sequential scans: the plain per-byte loop and
        # the KD path (its plain version on a CPU tensor)
        tt = [torch.from_numpy(x) for x in (trans, bc, data, lengths)]
        start = torch.tensor(int(bank.start), dtype=torch.int32)
        np.testing.assert_array_equal(
            dfa_scan(tt[0], tt[1], start, tt[2], tt[3]).numpy(), got)
        np.testing.assert_array_equal(
            dfa_finals_banked(tt[0][None], tt[1][None], start.reshape(1),
                              tt[2], tt[3], impl="gather")[0].numpy(), got)
        # the planted signatures are found
        accept = np.asarray(bank.accept)[got]
        assert accept[0].any() and accept[1].any() and accept[2].any()


#: (S, K, L, block) of the hypothesis cases: a one-state table, L below,
#: on and off the block, one block of one byte, a ragged last block.
#: The shapes are few so that the reference's scan compiles once each;
#: hypothesis draws the tables, bytes, start state and lengths
SHAPES = [(1, 1, 5, 8), (5, 3, 37, 8), (16, 7, 64, 16), (9, 2, 70, 1),
          (20, 9, 33, 64)]
B = 6


@pytest.mark.parametrize("S,K,L,block", SHAPES)
@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_sp_equals_reference_on_random_tables(S, K, L, block, data):
    seed = data.draw(st.integers(0, 2 ** 16), "seed")
    rng = np.random.default_rng(seed)
    trans = rng.integers(0, S, (S, K)).astype(np.int32)
    bc = rng.integers(0, K, 256).astype(np.int32)
    payload = rng.integers(0, 256, (B, L)).astype(np.uint8)
    lengths = rng.integers(-3, L + block + 3, B).astype(np.int32)
    lengths[0] = data.draw(st.sampled_from([-1, 0, L, L + 1, 10 ** 6]),
                           "edge length")
    start = int(rng.integers(0, S))
    np.testing.assert_array_equal(
        _port_sp(trans, bc, start, payload, lengths, block),
        _ref_sp(trans, bc, start, payload, lengths, block))


def test_block_transitions_with_and_without_valid():
    rng = np.random.default_rng(5)
    for S, K, shape in ((7, 4, (3, 5, 16)), (1, 1, (2, 9)),
                        (33, 12, (4, 40))):
        trans = rng.integers(0, S, (S, K)).astype(np.int32)
        bc = rng.integers(0, K, 256).astype(np.int32)
        payload = rng.integers(0, 256, shape).astype(np.uint8)
        valid = rng.random(shape) < 0.6
        for v in (valid, None):
            want = np.asarray(jls.block_transitions(
                jnp.asarray(trans), jnp.asarray(bc), jnp.asarray(payload),
                None if v is None else jnp.asarray(v)))
            got = longscan.block_transitions(
                torch.from_numpy(trans), torch.from_numpy(bc),
                torch.from_numpy(payload),
                None if v is None else torch.from_numpy(v)).numpy()
            assert got.shape == want.shape == shape[:-1] + (S,)
            np.testing.assert_array_equal(got, want)
    # composition order: the earlier function is applied first
    f = torch.tensor([[1, 2, 0]], dtype=torch.int32)
    g = torch.tensor([[2, 2, 1]], dtype=torch.int32)
    np.testing.assert_array_equal(
        longscan._compose(f, g).numpy(),
        np.asarray(jls._compose(jnp.asarray(f.numpy()),
                                jnp.asarray(g.numpy()))))
    # a [1, S] function broadcast against a batch of them
    np.testing.assert_array_equal(
        longscan._compose(f, torch.cat([g, f])).numpy(),
        np.asarray(jls._compose(jnp.asarray(f.numpy()),
                                jnp.asarray(torch.cat([g, f]).numpy()))))
