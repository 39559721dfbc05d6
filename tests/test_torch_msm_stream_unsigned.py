"""The port's lane-stream entry points with unsigned digits: the single MSM at
every (c, G, fused) and through the K6/K10 branch, and the in-kernel-digit
MSM at c = 4 and 8, against the native oracle and JAX msm_pippenger at the
same c and sign; the bucket rows against host sums; the batched tail per
lane. The checks are in tests/test_torch_msm_stream.py; this sign's three
XLA compiles run in this file's own process."""

import pytest
import torch
from test_torch_msm_stream import (
    ROUTE_IDS, ROUTES, check_batched_tail, check_bucket_rows, check_scalar_stream, check_single_fused,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("group,fused", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("c", [4, 6, 8], ids=lambda c: f"c{c}")
def test_msm_single_fused_unsigned(c, group, fused):
    check_single_fused(c, group, fused, False)


@pytest.mark.parametrize("c", [4, 8], ids=lambda c: f"c{c}")
def test_scalar_stream_unsigned(c):
    check_scalar_stream(c, False)


@pytest.mark.parametrize("c", [4], ids=lambda c: f"c{c}")
def test_bucket_rows_unsigned(c):
    check_bucket_rows(c, False)


def test_batched_bucket_tail_unsigned():
    check_batched_tail(False)
