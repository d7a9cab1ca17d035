"""Fault tolerance: heartbeats, straggler mitigation, checkpoint-restart.

The PyTorch counterpart of ``repro/runtime/fault_tolerance.py``, whose
threading parts import no JAX and are copied here: ``StragglerPolicy``,
``StepHungError``, ``HeartbeatMonitor`` and ``FaultTolerantLoop``. The
reference's ``jax_block`` becomes ``device_block``, a synchronise of the
devices that hold the metrics' tensors, and the loop restores onto a device
(``device=``) where the reference re-places onto shardings.

At 1000+-node scale the failure model is: slow step (straggler), hung step
(network/host fault), dead worker (restart required).  The driver reacts per
policy:

  * **straggler**: a step slower than ``straggler_factor`` × the trailing
    median is logged;
  * **hang**: steps run under a watchdog; timeout ⇒ raise for restart;
  * **crash/restart**: training resumes from the newest atomic checkpoint
    (``repro_torch.checkpoint``).

Pure-Python driver around any step function — exercised with fault
injection in tests.
"""
from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import Callable, Optional


@dataclasses.dataclass
class StragglerPolicy:
    factor: float = 2.0          # step > factor * median ⇒ straggler
    window: int = 20             # trailing steps for the median
    min_samples: int = 5


class StepHungError(RuntimeError):
    """The watchdog declared the monitored step hung: no ``beat()`` arrived
    within ``timeout_s``.  Raised INTO the driver loop (from ``beat()`` or
    the monitor's ``__exit__``) so the checkpoint-restart path runs — the
    module contract "timeout ⇒ raise for restart"."""


class HeartbeatMonitor:
    """Watchdog: if ``beat()`` isn't called within ``timeout_s``, the step is
    declared hung, ``on_timeout`` fires (default: records the event), and the
    hang is RAISED into the monitored loop as :class:`StepHungError` — a
    watchdog thread cannot interrupt a blocking jitted step directly, so the
    raise happens at the first control-flow point the loop reaches:
    the next ``beat()`` call, or the ``with`` block's exit.  Either way the
    driver's except path restores from the newest checkpoint instead of
    silently absorbing the hang into a slow step."""

    def __init__(self, timeout_s: float, on_timeout: Optional[Callable] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self.events: list[float] = []
        self.hung = False
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self):
        self._raise_if_hung()
        self._last = time.monotonic()

    def _raise_if_hung(self):
        if self.hung:
            raise StepHungError(
                f"step exceeded the {self.timeout_s:.1f}s heartbeat "
                f"timeout ({len(self.events)} watchdog firing(s))")

    def __enter__(self):
        def watch():
            while not self._stop.wait(self.timeout_s / 4):
                if time.monotonic() - self._last > self.timeout_s:
                    self.events.append(time.monotonic())
                    self.hung = True
                    if self.on_timeout:
                        self.on_timeout()
                    self._last = time.monotonic()

        self._thread = threading.Thread(target=watch, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, exc_type, *exc):
        self._stop.set()
        self._thread.join(1.0)
        # don't mask an exception already propagating out of the block
        if exc_type is None:
            self._raise_if_hung()


class FaultTolerantLoop:
    """Checkpoint-restart training driver.

    ``step_fn(state, batch) -> (state, metrics)`` may raise (fault injection /
    real device errors): the loop restores the newest checkpoint and replays
    the data stream deterministically (the pipeline is (seed, step)-pure).
    """

    def __init__(self, step_fn, ckpt_manager, dataset, *,
                 straggler: StragglerPolicy = StragglerPolicy(),
                 max_restarts: int = 3,
                 step_timeout_s: float = 3600.0):
        self.step_fn = step_fn
        self.ckpt = ckpt_manager
        self.dataset = dataset
        self.policy = straggler
        self.max_restarts = max_restarts
        self.step_timeout_s = step_timeout_s
        self.stragglers: list[int] = []
        self.restarts = 0
        self.durations: list[float] = []

    def _check_straggler(self, step: int, dt: float):
        window = self.durations[-self.policy.window:]
        if len(window) >= self.policy.min_samples:
            med = statistics.median(window)
            if dt > self.policy.factor * med:
                self.stragglers.append(step)

    def run(self, init_fn, like, n_steps: int, *, device=None,
            metrics_cb=None):
        state, start = self.ckpt.restore_or_init(
            lambda: init_fn(), like, device)
        step = start
        while step < n_steps:
            try:
                with HeartbeatMonitor(self.step_timeout_s) as hb:
                    batch = self.dataset.batch(step)
                    t0 = time.monotonic()
                    state, metrics = self.step_fn(state, batch)
                    device_block(metrics)
                    dt = time.monotonic() - t0
                    hb.beat()
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                ckpt_step = self.ckpt.restore_or_init(
                    lambda: init_fn(), like, device)
                state, step = ckpt_step
                continue
            self._check_straggler(step, dt)
            self.durations.append(dt)
            if metrics_cb:
                metrics_cb(step, metrics, dt)
            self.ckpt.maybe_save(step, state)
            step += 1
        return state, step


def device_block(tree):
    """Wait for the devices that hold ``tree``'s tensors (nested dicts, lists
    and tuples) to finish their queued work."""
    import torch

    def leaves(node):
        if isinstance(node, dict):
            node = list(node.values())
        if isinstance(node, (list, tuple)):
            return [x for v in node for x in leaves(v)]
        return [node]

    for dev in {x.device for x in leaves(tree) if isinstance(x, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
