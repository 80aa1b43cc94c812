"""The sweeps' dtype rule, ``kernels.sum_dtype``, as a table: the dtype each
kind of data sums in, and the blocking reads to the host it costs through
``kernels.acc_dtype`` (two, the range of 64-bit integer data on its device;
none for any other dtype). The rule is pure: it asks for ``|max|`` only of
64-bit integer data, and bool data (unit weights) of 2^31 cells or more sums
in int64. T3 and T4 widen float32 to the rule's float dtype."""

import pytest
import torch

from pyflwdir_torch import kernels, trace

_N = 4096
# kind: (data, sum dtype, host reads)
_TABLE = {
    "bool": (lambda: torch.arange(_N) % 3 == 0, torch.int32, 0),
    "uint8": (lambda: torch.full((_N,), 255, dtype=torch.uint8), torch.int32, 0),
    "int8": (lambda: torch.full((_N,), -128, dtype=torch.int8), torch.int32, 0),
    "int16": (lambda: torch.full((_N,), -(1 << 15), dtype=torch.int16), torch.int32, 0),
    # int32 sums wrap modulo 2^32: the dtype alone decides
    "int32": (lambda: torch.full((_N,), (1 << 31) - 1, dtype=torch.int32), torch.int32, 0),
    # |max| * n just below 2^31
    "int64_small": (lambda: torch.full((_N,), ((1 << 31) - 1) // _N, dtype=torch.int64),
                    torch.int32, 2),
    # |max| * n reaches 2^31, the largest magnitude negative
    "int64_wide": (lambda: torch.arange(_N, dtype=torch.int64) - (1 << 31) // _N,
                   torch.int64, 2),
    "float32": (lambda: torch.rand(_N, dtype=torch.float32), torch.float64, 0),
    "float64": (lambda: torch.rand(_N, dtype=torch.float64), torch.float64, 0),
}


@pytest.mark.parametrize("kind", list(_TABLE))
def test_the_rule_as_a_table(kind):
    make, want, reads = _TABLE[kind]
    data = make()
    before = trace.host_reads["acc_dtype"]
    assert kernels.acc_dtype(data) == want
    assert trace.host_reads["acc_dtype"] - before == reads
    asked = []

    def amax():
        asked.append(True)
        return int(data.abs().max())

    assert kernels.sum_dtype(data.dtype, data.numel(), amax) == want
    assert len(asked) == (data.dtype == torch.int64)


@pytest.mark.parametrize("dtype, n, want", [
    (torch.bool, (1 << 31) - 1, torch.int32),
    (torch.bool, 1 << 31, torch.int64),
    (torch.uint8, 1 << 40, torch.int32),
    (torch.int64, 0, torch.int32),  # no data: no |max| asked
])
def test_the_rule_by_cell_count(dtype, n, want):
    def amax():
        raise AssertionError("|max| asked")

    assert kernels.sum_dtype(dtype, n, amax) == want


def test_t3_t4_widen_to_the_rule():
    """T3 and T4 sum every dtype they read in a dtype of the rule: float32 in
    its float dtype, the rest as they come."""
    assert kernels._sum_dtype(torch.float32) == torch.float64
    for dtype in kernels._DOWN_DTYPES:
        acc = kernels._sum_dtype(dtype)
        assert acc in kernels._SUM_DTYPES
        if dtype.is_floating_point:
            assert acc == kernels.sum_dtype(dtype, 1, None)
        else:
            assert acc == dtype
