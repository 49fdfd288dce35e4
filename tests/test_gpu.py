"""Checks that need the card. Each takes the ``gpu`` fixture, so it skips
with a reason elsewhere. On the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def test_device_is_gpu(gpu):
    assert cs.check_device()["platform"] == "gpu"


def test_committed_checkpoints_reproduce_golden(gpu):
    cs._golden_parity()


@pytest.mark.parametrize("neighbor_k", [0, 32])
def test_full_width_forward_vs_f32_highest(gpu, neighbor_k):
    """bf16 and TF32 forwards at the flagship width on 64 atoms."""
    out = cs._forward_parity(cs.flagship(n_max=64, neighbor_k=neighbor_k),
                             seed=0)
    assert set(out) == {"tf32", "bfloat16"}
