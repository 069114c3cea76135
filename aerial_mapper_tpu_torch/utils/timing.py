"""Per-stage timing and the config banner (twin of
``aerial_mapper_tpu/utils/timing.py``: ``StageTimer``, ``config_banner``,
``log_config``; JAX's ``block_until_ready_tree`` has no twin, since a
``torch.cuda.synchronize`` waits for every tensor of a device at once).

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
stage ends. ``time_fn`` times one call on the host clock between two
synchronizations of the device. A stage may carry a work count
(``work_items``); ``throughput`` is that count over the stage's time.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

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
        self.work: Dict[str, float] = {}
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
    def stage(self, name: str, work_items: Optional[float] = None):
        if work_items is not None:
            self.work[name] = self.work.get(name, 0.0) + work_items
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

    def time_fn(self, name: str, fn, *args, work_items=None, **kwargs):
        """Run ``fn(*args, **kwargs)``, add its time to stage ``name`` and
        return its result. The host clock around the call; on a CUDA
        device the timer's device is synchronized before and after it (the
        port's counterpart of JAX's ``block_until_ready_tree`` on the
        result), so the time covers the call's device work and no earlier
        work."""
        if work_items is not None:
            self.work[name] = self.work.get(name, 0.0) + work_items
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize(self.device)
        self._add(name, time.perf_counter() - t0)
        return out

    def throughput(self, name: str) -> Optional[float]:
        """items/s for a stage (e.g. Mcells/s when work is in Mcells)."""
        dt = self.durations.get(name, 0.0)
        if name in self.work and dt > 0:
            return self.work[name] / dt
        return None

    def report(self) -> str:
        lines = ["stage timings:"]
        for name, dt in sorted(self.durations.items()):
            tp = self.throughput(name)
            extra = f"  ({tp:.2f} items/s)" if tp else ""
            lines.append(f"  {name}: {dt:.4f} s{extra}")
        return "\n".join(lines)


def config_banner(name: str, cfg) -> str:
    """Render a config dataclass as the reference's parameter banner
    (utils::paramToString, utils-common.cc:12-38; printed by dsm.cc:203-214
    and ortho-backward-grid.cc:241-253)."""
    import dataclasses

    lines = ["*" * 50, f"{name} parameters:"]
    if dataclasses.is_dataclass(cfg):
        for f in dataclasses.fields(cfg):
            lines.append(f"  {f.name}: {getattr(cfg, f.name)}")
    else:
        lines.append(f"  {cfg}")
    lines.append("*" * 50)
    return "\n".join(lines)


def log_config(name: str, cfg) -> None:
    logger.info("%s", config_banner(name, cfg))
