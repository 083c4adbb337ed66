#!/usr/bin/env python3
"""The largest tensors alive at a dry-run cell's traced peak, and where each was made.

  PYTHONPATH=src python scripts/dryrun_peak.py ARCH SHAPE [--multi] [--top 12]

Traces one cell as `python -m repro_torch.launch.dryrun` does (a fake world of
256 ranks, 512 with `--multi`; the production mesh; fake tensors, nothing
allocated), with the tracer's storages labelled: at each new peak of live bytes
it keeps the `--top` largest live storages with their shape, dtype and the
innermost frames of the port that made them (outer > inner, the tracer's own
left out). Prints the peak and those storages, GiB a rank. A CPU trace: no
device number. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
import traceback
import weakref
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, rules_for  # noqa: E402

GIB = 2**30


class PeakTracer(dryrun.StepTracer):
    """`StepTracer` that also labels each live storage and keeps the largest ones
    alive at the peak."""

    top = 12
    last = None  # the tracer of the latest trace

    def __init__(self):
        super().__init__()
        self.labels: dict[int, tuple] = {}
        self.at_peak: list[tuple] = []
        PeakTracer.last = self

    def track(self, tree) -> None:
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            if not isinstance(t, torch.Tensor) or t.device.type == "meta":
                continue
            st = t.untyped_storage()
            # lint: disable-next=D104 -- identity map of the live storages, as StepTracer's
            key = id(st)
            if key in self._freed:
                continue
            n = st.nbytes()
            frames = [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                      for f in traceback.extract_stack() if "repro_torch" in f.filename
                      and f.name not in ("dispatch", "__torch_dispatch__", "track")]
            self.labels[key] = (n, tuple(t.shape), str(t.dtype), frames[-4:])
            self.live += n
            if self.live > self.peak:
                self.peak = self.live
                self.at_peak = sorted(self.labels.values(), key=lambda v: -v[0])[:self.top]
            self._freed[key] = weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, nbytes: int) -> None:
        self.labels.pop(key, None)
        super()._free(key, nbytes)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    PeakTracer.top = args.top
    dryrun.StepTracer = PeakTracer  # trace_cell makes its tracer from the module's name
    dryrun.init_fake_world(512 if args.multi else 256)
    mesh = make_production_mesh(multi_pod=args.multi, device_type="cpu")
    shape = SHAPES[args.shape]
    trace = dryrun.trace_cell(get_config(args.arch), shape, mesh, rules_for(mesh, shape),
                              over=dryrun.ARCH_TRAIN_OVERRIDES.get(args.arch, {}))
    tracer = PeakTracer.last
    print(f"{args.arch} {args.shape}: peak {trace['memory']['peak_bytes_per_device'] / GIB:.2f} "
          f"GiB a rank; the largest storages alive then:")
    for n, shp, dtype, frames in tracer.at_peak:
        print(f"  {n / GIB:8.3f} GiB {shp} {dtype} {' > '.join(frames)}")


if __name__ == "__main__":
    main()
