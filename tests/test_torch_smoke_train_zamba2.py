"""zamba2's rehearsal of `chip_smoke.py`'s train parity, alone in its file: it is the
longest test of the suite (a Mamba2 chunk of 320 tokens, three remat policies),
and a parallel run gives a file one worker."""

import pytest

from test_torch_smoke_train import train_parity_rehearsal
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("arch", ["zamba2_1p2b"])
def test_phase_train_parity_rehearsal(arch, monkeypatch):
    train_parity_rehearsal(arch, monkeypatch)
