"""zamba2-1.2b's train steps against JAX's at S = 320, past a Mamba2 chunk
(`test_torch_train_families.py`'s case and PARAM_NOTE), alone in its file: it is
one of the longest tests, and a parallel run gives a file one worker."""

import pytest

from test_torch_train_families import train_step_case
from torch_threads import one_thread  # noqa: F401


@pytest.mark.slow
@pytest.mark.parametrize("case", ["zamba2_1p2b-S320"])
def test_train_step_matches_jax(case):
    train_step_case(case)
