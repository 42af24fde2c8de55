"""The check's control and fault at the one-card cell's own size, on the
card: the float8 control and the half-batch fault each fail one of the
cell's limits.  Skips without a CUDA card.

    python -m pytest -m cuda h100_bench/tests/test_h100bench_card.py
"""

import pytest

from h100bench_common import REPO

from h100_bench import cells, control


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["hrnet_w18_s1.b224"])
def test_control_and_fault_fail_at_the_cells_size(card, workload):
    limits = cells.load_cell(REPO, workload).limits
    for variant, gaps in control.readings(workload, 2 ** 31 + 99, card):
        held = {k: v for k, (v, _) in gaps.items()
                if limits[k]["limit"] is not None}
        assert any(v > limits[k]["limit"] for k, v in held.items()), \
            (variant, gaps)
