"""Per-stage timing (twin of ``aerial_mapper_tpu/utils/timing.py``'s
``StageTimer``).

What is measured differs from the JAX timer, which takes the host's
dispatch time of a block. On a CUDA device, ``stage`` records a CUDA event
on the current stream before and after the block and does not synchronize:
a stage's duration is the device window between the two events, from the
moment the stream reaches the first to the moment it reaches the second.
That window includes any time the device waits inside the block for the
host to enqueue work, so a stage whose host work outruns its kernels reads
as long as the host takes. The pending events are resolved with one
``torch.cuda.synchronize`` when ``durations`` or ``report`` is read. On the
CPU, ``stage`` takes the host clock around the block. Each resolved stage
logs ``STAGE_LOG`` (``dt(name): ... s``), as the JAX timer does when a
stage ends.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict

import torch

from aerial_mapper_tpu_torch.device import resolve_device

logger = logging.getLogger("aerial_mapper_tpu_torch")

# the log record of one resolved stage: args (name, seconds)
STAGE_LOG = "dt(%s): %.4f s"


class StageTimer:
    """Collects named stage durations.

    ``device=None`` means CUDA (raises without it), as every entry point of
    the port; ``device="cpu"`` times with the host clock.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._durations: Dict[str, float] = {}
        self._pending = []  # (name, start event, end event)

    def _add(self, name: str, dt: float) -> None:
        self._durations[name] = self._durations.get(name, 0.0) + dt
        logger.info(STAGE_LOG, name, dt)

    def _resolve(self) -> None:
        if not self._pending:
            return
        torch.cuda.synchronize(self.device)
        for name, a, b in self._pending:
            self._add(name, a.elapsed_time(b) / 1e3)
        self._pending = []

    @property
    def durations(self) -> Dict[str, float]:
        self._resolve()
        return self._durations

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            try:
                yield
            finally:
                b.record()
                self._pending.append((name, a, b))
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, time.perf_counter() - t0)

    def report(self) -> str:
        lines = ["stage timings:"]
        for name, dt in sorted(self.durations.items()):
            lines.append(f"  {name}: {dt:.4f} s")
        return "\n".join(lines)
