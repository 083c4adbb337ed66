"""repro_torch.core — the analytical performance model of `repro.core`, copied for
the port: hardware specifications, roofline operator timing, parallelism and
collective models, the memory model, step-time and latency predictions, and the
auto-parallelism planner. Plain Python over the port's `ModelConfig`; nothing
here touches a device.
"""

from repro_torch.core.hardware import HardwareSpec, get_hardware  # noqa: F401
