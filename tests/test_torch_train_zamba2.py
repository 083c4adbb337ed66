"""zamba2-1.2b's train steps against JAX's at S = 64 (`test_torch_train_families.py`'s
case), in a file of its own: a parallel run gives a file one worker."""

import pytest

from test_torch_train_families import train_step_case
from torch_threads import one_thread  # noqa: F401


@pytest.mark.slow
@pytest.mark.parametrize("case", ["zamba2_1p2b"])
def test_train_step_matches_jax(case):
    train_step_case(case)
