"""Fault tolerance: restartable training runner and preemption handling,
the port of ``repro.train.fault_tolerance``.

* **Checkpoint/restart** — the runner always begins by probing the
  checkpoint directory; any crash (or the injected failure of the tests)
  resumes from the last committed step.  Saves are async and atomically
  committed.
* **Preemption** — SIGTERM triggers a final blocking save before exit.
* **Determinism** — batches are a pure function of (seed, step), never of
  host state (``data.pipeline``), so a restarted job replays identical
  data; with the flash backward free of float atomics a resumed run on
  the card equals an uninterrupted one bit for bit.
"""
from __future__ import annotations

import signal
from typing import Any, Callable, Dict, Optional

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train.checkpoint import Checkpointer


class TrainingRunner:
    def __init__(
        self,
        step_fn: Callable,            # (state, batch) -> (state, metrics)
        batch_fn: Callable,           # (step) -> batch (deterministic!)
        state: Any,
        ckpt: Checkpointer,
        *,
        ckpt_every: int = 50,
        device: DeviceLike = None,    # where a restored state goes
        log_fn: Optional[Callable[[int, Dict], None]] = None,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.state = state
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.device = resolve_device(device)
        self.log_fn = log_fn or (lambda s, m: None)
        self.start_step = 0
        self._preempted = False

    # ------------------------------------------------------------------ #
    def maybe_restore(self) -> int:
        step = self.ckpt.latest_step()
        if step is not None:
            _, self.state = self.ckpt.restore(
                step, device=self.device, example=self.state)
            self.start_step = step
        return self.start_step

    def _handle_preemption(self, signum, frame):
        self._preempted = True

    def run(
        self, total_steps: int, *,
        fail_at: Optional[int] = None,   # inject a crash (tests)
        install_signal_handler: bool = True,
    ) -> Dict:
        previous = None
        if install_signal_handler:
            try:
                previous = signal.signal(signal.SIGTERM,
                                         self._handle_preemption)
            except ValueError:
                pass   # non-main thread (tests)
        try:
            return self._run(total_steps, fail_at)
        finally:
            # the handler goes with the run: installed for good it would
            # keep this runner, and its state, alive
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _run(self, total_steps: int, fail_at: Optional[int]) -> Dict:
        step = self.maybe_restore()
        metrics: Dict = {}
        try:
            while step < total_steps:
                if fail_at is not None and step == fail_at:
                    raise RuntimeError(f"injected failure at step {step}")
                batch = self.batch_fn(step)
                self.state, metrics = self.step_fn(self.state, batch)
                step += 1
                self.log_fn(step, metrics)
                if step % self.ckpt_every == 0 or self._preempted:
                    self.ckpt.save(step, self.state)
                if self._preempted:
                    self.ckpt.wait()
                    break
        except BaseException:
            # Crash consistency: save() already snapshotted the state to host
            # memory, so let the in-flight disk write commit before the
            # process goes down — the restart resumes from it.
            self.ckpt.wait()
            raise
        self.ckpt.save(step, self.state, blocking=True)
        return metrics
