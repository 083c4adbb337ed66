import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src"), str(Path(__file__).parent)]
torch.set_num_threads(2)
