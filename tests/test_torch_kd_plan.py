"""KD's launch plan (``dfa_dense_cuda.plan_launch``), on the CPU.

The wrapper picks the kernel's variant, grid, dynamic shared memory and
row load width from the shapes and the data's alignment
alone; these are the rules the CUDA side relies on (the kernel itself
runs only on the card: ``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import pytest

from cilium_tpu_torch.engine import _build
from cilium_tpu_torch.engine.dfa_dense_cuda import (
    FLOWS_PER_CTA,
    H100_SMS,
    SMEM_HEADER,
    SMEM_MAX,
    plan_launch,
    row_load_width,
    staged_bytes,
)

#: (NB, S, K, B, L): the http-1000 batch's path, method, host, header and
#: dns fields, the high-cardinality capture's path table, the L = 1024
#: batch, the tiny capture tables, and the compiler's largest bank
SHAPES = [
    (8, 768, 31, 8192, 256), (1, 15, 11, 8192, 16), (1, 78, 13, 8192, 128),
    (1, 74, 16, 8192, 256), (1, 2, 1, 8192, 256),
    (8, 768, 31, 262144, 32), (8, 768, 31, 4096, 1024),
    (1, 74, 16, 4096, 1024), (1, 15, 11, 4, 16), (1, 2, 1, 1, 32),
    (1, 8192, 256, 8193, 33), (2, 8192, 256, 1, 1),
]


@pytest.mark.parametrize("nb,s,k,b,l", SHAPES)
@pytest.mark.parametrize("w,wg", [(0, 0), (4, 1), (3, 0)])
def test_plan_invariants(nb, s, k, b, l, w, wg):
    p = plan_launch(nb, s, k, b, l, w, wg)
    per_bank, banks = p.grid
    assert banks == nb
    assert p.smem <= SMEM_MAX
    tiles = -(-b // FLOWS_PER_CTA)
    assert 1 <= per_bank <= tiles
    if p.variant == "smem":
        staged = s * k * 4 + (s * (w + wg) * 4 if p.words_smem else 0)
        assert p.smem >= SMEM_HEADER + staged
        assert p.words_smem == (w + wg > 0 and SMEM_HEADER
                                + staged_bytes(s * k * 4)
                                + sum(staged_bytes(s * x * 4)
                                      for x in (w, wg) if x) <= SMEM_MAX)
        # the grid fills the SMs once: the table is staged once per
        # CTA, whatever the batch
        assert per_bank == min(tiles, max(1, H100_SMS // nb))
    else:
        assert per_bank == tiles and not p.words_smem


@pytest.mark.parametrize("nb,s,k,b,l,variant", [
    (8, 768, 31, 8192, 256, "smem"),       # the http-1000 path bank
    (8, 768, 31, 262144, 32, "smem"),      # high-cardinality path table
    (1, 74, 16, 4096, 1024, "smem"),
    (1, 8192, 256, 8193, 33, "global"),    # 8 MB: over the budget
    (1, 227, 256, 64, 16, "global"),       # just over 232448 bytes
    (1, 226, 256, 64, 16, "smem"),         # just under
])
def test_variant_by_table_size(nb, s, k, b, l, variant):
    assert plan_launch(nb, s, k, b, l).variant == variant


def test_batch_path_plan():
    """The http-1000 batch path field: 16 tiles of 512 flows per bank,
    one CTA each, 128 CTAs on the 132 SMs; the table and both accept
    planes (W = 4 words, Wg = 1 group word) in shared memory."""
    p = plan_launch(8, 768, 31, 8192, 256, 4, 1)
    assert p.variant == "smem" and p.words_smem
    assert p.grid == (16, 8)
    assert p.smem == SMEM_HEADER + sum(
        staged_bytes(768 * x * 4) for x in (31, 4, 1))


def test_accept_planes_stay_global_when_they_do_not_fit():
    # the table fits (220 KB), the table and its accept plane do not
    p = plan_launch(1, 220, 256, 600, 32, 8, 0)
    assert p.variant == "smem" and not p.words_smem
    assert p.smem == SMEM_HEADER + staged_bytes(220 * 256 * 4)


def test_high_cardinality_plan_loops_over_tiles():
    p = plan_launch(8, 768, 31, 262144, 32)
    per_bank = p.grid[0]
    assert per_bank * FLOWS_PER_CTA < 262144     # CTAs loop over tiles
    assert per_bank * 8 <= H100_SMS


@pytest.mark.parametrize("nb,s,k,w,wg", [(30, 2816, 18, 16, 7),
                                          (2, 1536, 19, 1, 0)])
@pytest.mark.parametrize("b", [1, 5880, 8192])
def test_fleet_stacks_fit_the_table_and_take_either_variant(nb, s, k, w,
                                                            wg, b):
    """The churn storm's path and dns stacks at 10k identities x 5k
    CNPs: the table fits in shared memory (2816 states x 18 classes is
    202,752 bytes), the accept planes beside it do not. A measurement timing
    the variants names the global one and gets one CTA per tile."""
    tiles = -(-b // FLOWS_PER_CTA)
    p = plan_launch(nb, s, k, b, 32, w, wg)
    assert p.variant == "smem"
    assert p.words_smem == (SMEM_HEADER + staged_bytes(s * k * 4) + sum(
        staged_bytes(s * x * 4) for x in (w, wg) if x) <= SMEM_MAX)
    assert p.grid == (min(tiles, max(1, H100_SMS // nb)), nb)
    g = plan_launch(nb, s, k, b, 32, w, wg, _variant="global")
    assert g == ("global", (tiles, nb), SMEM_HEADER, False, p.vec)
    assert plan_launch(nb, s, k, b, 32, w, wg, _variant="smem") == p
    if nb == 30:
        assert not p.words_smem


def test_a_named_variant_must_exist_and_fit():
    with pytest.raises(_build.KernelArgumentError, match="over the"):
        plan_launch(1, 8192, 256, 64, 16, _variant="smem")
    with pytest.raises(ValueError, match="no variant"):
        plan_launch(1, 2, 1, 1, 1, _variant="registers")


@pytest.mark.parametrize("ptr,stride,rows,L,vec", [
    (0, 256, 8192, 256, 16), (0, 32, 5, 32, 16), (4096, 1024, 3, 1024, 16),
    (0, 700, 8192, 256, 4), (0, 33, 2, 33, 1), (0, 12, 7, 12, 4),
    (8, 16, 9, 16, 4), (3, 16, 9, 16, 1), (2, 300, 4, 300, 1),
    (0, 17, 1, 16, 16), (5, 17, 1, 16, 1), (0, 48, 2, 17, 1),
    (0, 32, 3, 20, 4), (0, 64, 3, 0, 16),
])
def test_row_load_width(ptr, stride, rows, L, vec):
    """16-byte loads only where every row start is 16-aligned (the data
    pointer and, with more than one row, the row stride) and 16 divides
    L; 4-byte loads on 4; else bytes."""
    assert row_load_width(ptr, stride, rows, L) == vec


def test_plan_takes_the_row_alignment():
    assert plan_launch(8, 768, 31, 8192, 256, 4, 1, 0, 256).vec == 16
    # a column slice of the blob at an odd offset, rows 700 bytes apart
    assert plan_launch(8, 768, 31, 8192, 256, 4, 1, 7, 700).vec == 1
    assert plan_launch(8, 768, 31, 8192, 256, 4, 1, 4, 700).vec == 4
    assert plan_launch(8, 768, 31, 8192, 256, 4, 1, 8, 704).vec == 4
    # L = 33 contiguous: rows 33 bytes apart
    assert plan_launch(1, 74, 16, 100, 33).vec == 1


def test_launch_counts_by_variant():
    k = _build.Kernel("probe", "dfa_dense.cu", "ct_dfa_dense", [], "x")
    k._fn = lambda *a: 0
    k.launch(1, variant="smem")
    k.launch(2, variant="global")
    k.launch(3, variant="smem")
    assert k.launches == 3
    assert k.launches_by_variant == {"smem": 2, "global": 1}


def test_reset_launches_clears_variants():
    kd = _build.KERNELS["KD"]
    kd.launches, kd.launches_by_variant = 4, {"smem": 4}
    _build.reset_launches()
    assert kd.launches == 0 and kd.launches_by_variant == {}
