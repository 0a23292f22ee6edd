"""Pass 1's select sweep (``csrc/topk_sweep.cu``, routes 1 and 2) on the CPU,
under the emulation of ``tests/cuda_emu`` (built as
``tests/test_torch_mips_emulated.py`` builds it).

The cases ``test_torch_mips_emulated.py`` leaves to this file: rows that
rise in score for every query, so that every part admits a run of rows
after each other and merges its queue over and over (both block layouts,
lists of several 32-key rounds); widths past ``PROMOTE_D``
(the 64-query layout's promoted sums); two query tiles of 128; lists that
never fill (kc past the rows a part sees). Each is held exactly against
the top kc of fp64 scores (integer-valued inputs: every score exact in
fp32) with ties to the smaller row, against ``topk_candidates_plain``'s
scores, and each part's list must hold its rows of the top kc, sorted.
``dst_topk_select`` refuses arguments out of range and the score tile's
shapes. Skips where no g++ is found.
"""
import numpy as np
import pytest
import torch

from dpr_scale_tpu_torch.ops import mips_kernels as mk

import torch_threads  # noqa: F401  (one intra-op thread a worker)
from test_torch_mips_emulated import (  # noqa: F401  (emulated: the module's fixture)
    _topk, _topk_inputs, _want_topk, assert_parts_hold_the_top, emulated, select_parts)


def _rising(B, N, D, seed):
    """Positive integer queries and one positive integer row scaled by 1 ..
    8 along the rows: every query's scores rise with the row, in runs of
    equal rows."""
    rng = np.random.default_rng(seed)
    q = rng.integers(1, 4, size=(B, D)).astype(np.float32)
    base = rng.integers(1, 4, size=(1, D)).astype(np.float32)
    c = base * (1 + np.arange(N) * 8 // N)[:, None].astype(np.float32)
    return torch.from_numpy(q).bfloat16(), torch.from_numpy(c).bfloat16()


# (B, N rows, D, n_valid, kc, kind): rising rows in the 64- and the
# 128-query layout, lists of two 32-key rounds; D = 1,600 (past
# PROMOTE_D: 64 queries a block at any B, each stage's sums promoted);
# ties in two 128-query tiles; kc past every part's rows (lists that never
# fill, empty slots merged)
SELECT_CASES = [
    (9, 4096, 32, 4096, 40, "rising"),
    (70, 1024, 32, 1000, 40, "rising"),
    (9, 1024, 1600, 1000, 5, "rand"),
    (130, 1024, 32, 1000, 33, "dup"),
    (3, 512, 16, 300, 200, "rand"),
]


@pytest.mark.parametrize("B,N,D,n_valid,kc,kind", SELECT_CASES,
                         ids=[f"B{c[0]}-N{c[1]}-D{c[2]}-v{c[3]}-kc{c[4]}-{c[5]}"
                              for c in SELECT_CASES])
def test_emulated_select_equals_the_exact_top(emulated, B, N, D, n_valid, kc, kind):
    """The exact top kc (fp64 scores, ties to the smaller row), plain's
    scores, one launch and no rerun, every part's list holding its rows of
    the top kc; rising rows make every part admit past its queue's slots."""
    if kind == "rising":
        q, c = _rising(B, N, D, B + N + kc)
        s = q.double() @ c.double().T
        assert (s.diff(dim=1) >= 0).all() and (s[:, -1] > s[:, 0]).all()
    else:
        q, c = _topk_inputs(B, N, D, n_valid, kind, B + N + D + kc)
    assert emulated.dst_topk_route(q.data_ptr(), c.data_ptr(), N, D, 0) == 1
    scores, rows, over, launches, keys = _topk(emulated, q, c, n_valid, kc)
    want_s, want_i = _want_topk(q, c, n_valid, kc)
    assert torch.equal(scores, want_s) and torch.equal(rows, want_i)
    assert torch.equal(scores, mk.topk_candidates_plain(q, c, n_valid, kc)[0])
    assert over == 0 and launches == [(B, select_parts(B, N, D, n_valid, kc)[1])]
    assert_parts_hold_the_top(keys, q, c, n_valid, kc)
    if kind == "rising":  # the trap is live: a part's rows outnumber its queue's slots
        parts, _width = select_parts(B, N, D, n_valid, kc)
        assert min(min(hi, n_valid) - lo for lo, hi, _half in parts) > 2 * (kc + 64)
    if kc > n_valid // len(select_parts(B, N, D, n_valid, kc)[0]):  # lists that never fill
        assert (keys == mk._KEY_EMPTY).any()


def test_emulated_select_refuses_bad_arguments(emulated):
    """dst_topk_select returns cudaErrorInvalidValue (1) on arguments out of
    range and writes nothing: B 0, n_valid 0 or past N, kc 0, and fp32
    rows or an odd D (the score tile's shapes)."""
    q, c = _topk_inputs(3, 512, 16, 512, "rand", 1)
    qf, cf = q.float(), c.float()
    q17, c17 = _topk_inputs(3, 512, 17, 512, "rand", 1)
    keys, pub = torch.zeros((3, 64), dtype=torch.int64), torch.zeros((3, 32), dtype=torch.int64)
    for (x, y), B, n_valid, D, kc, dtype in (
            ((q, c), 0, 512, 16, 8, 0), ((q, c), 3, 0, 16, 8, 0), ((q, c), 3, 513, 16, 8, 0),
            ((q, c), 3, 512, 16, 0, 0), ((qf, cf), 3, 512, 16, 8, 1),
            ((q17, c17), 3, 512, 17, 8, 0)):
        assert emulated.dst_topk_select(x.data_ptr(), y.data_ptr(), keys.data_ptr(),
                                        pub.data_ptr(), B, 512, n_valid, D, kc, dtype,
                                        None) == 1
    assert (keys == 0).all() and (pub == 0).all()
