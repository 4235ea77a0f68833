"""Fault-tolerance supervisor: checkpoint/restart, straggler mitigation,
preemption handling (the port's own copy of the JAX package's
``ft/supervisor.py``: pure Python over the port's checkpoint manager).

On a real fleet every worker runs the same program under this supervisor;
coordination state (who is alive, who is slow) comes from the cluster
scheduler.  The control logic is hardware-independent and is what we test:

* **checkpoint/restart** — periodic async checkpoints; on any step failure
  the loop restores the last committed step (params + optimizer + data
  position) and replays.  Deterministic data indexing makes the replay
  bit-exact.
* **straggler mitigation** — per-step deadline = ``straggler_factor`` × a
  running p50 of step times.  A step exceeding it is treated as a failed
  worker: the step is re-dispatched (on a fleet: to a hot spare; here:
  re-executed).  Persistent stragglers trigger a restart-with-
  exclusion callback.
* **preemption** — SIGTERM-style preemption requests checkpoint-then-exit
  with a restartable state file.
* **restart** — a restore puts every leaf back on the device of the state
  it restores into.

``FaultInjector`` drives all of this in tests: it raises synthetic worker
failures / delays at configured steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from ..checkpoint import CheckpointManager


class WorkerFailure(RuntimeError):
    pass


class Preemption(RuntimeError):
    pass


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault plan for tests: {step: 'fail'|'slow'|'preempt'}.

    ``sleep`` is injectable (a fake clock's ``sleep`` in tests) so "slow"
    steps don't depend on host timing; the default is wall-clock."""

    plan: Dict[int, str] = dataclasses.field(default_factory=dict)
    slow_s: float = 0.3
    fired: List[int] = dataclasses.field(default_factory=list)
    sleep: Callable[[float], None] = time.sleep

    def check(self, step: int):
        kind = self.plan.get(step)
        if kind is None or step in self.fired:
            return
        self.fired.append(step)
        if kind == "fail":
            raise WorkerFailure(f"injected worker failure at step {step}")
        if kind == "slow":
            self.sleep(self.slow_s)
        if kind == "preempt":
            raise Preemption(f"injected preemption at step {step}")


@dataclasses.dataclass
class Supervisor:
    ckpt: CheckpointManager
    checkpoint_every: int = 50
    straggler_factor: float = 5.0
    max_retries_per_step: int = 3
    min_timing_samples: int = 5
    # in-process re-execution needs a step_fn that leaves its input state
    # intact; the trainer's step updates its state in place, so it can
    # only re-dispatch to a hot spare holding its own replica — there we
    # log the event and carry on with the (successfully computed) result.
    reexecute_stragglers: bool = True
    # injectable time source (a deterministic fake in tests, like
    # DSEService's clock=); the default is wall-clock
    clock: Callable[[], float] = time.perf_counter

    def run(self, *, state: Any, step_fn: Callable[[Any, int], Any],
            num_steps: int, start_step: int = 0,
            injector: Optional[FaultInjector] = None,
            on_metrics: Optional[Callable[[int, Any], None]] = None) -> Any:
        """Run ``state = step_fn(state, step)`` with full FT semantics.

        ``state`` must be a tree (params, opt state, data position, ...).
        Returns the final state.  Raises Preemption after a committed
        checkpoint when preempted.
        """
        times: List[float] = []
        step = start_step
        retries = 0
        events: List[str] = []
        self.events = events
        # (step, slow_dt, reexec_dt | None) per detected straggler
        stragglers: List[tuple] = []
        self.stragglers = stragglers

        while step < num_steps:
            t0 = self.clock()
            try:
                if injector is not None:
                    injector.check(step)
                new_state = step_fn(state, step)
                dt = self.clock() - t0

                # straggler detection (p50-based deadline); the slow
                # sample is NEVER appended to the p50 window — a burst of
                # stragglers must not inflate the deadline they are
                # measured against
                straggled = False
                if len(times) >= self.min_timing_samples:
                    med = sorted(times)[len(times) // 2]
                    if dt > self.straggler_factor * med:
                        straggled = True
                        dt2 = None
                        if self.reexecute_stragglers:
                            # re-dispatch once; deterministic step_fn makes
                            # the re-execution a hot-spare replay
                            t1 = self.clock()
                            new_state = step_fn(state, step)
                            dt2 = self.clock() - t1
                            times.append(dt2)
                        stragglers.append((step, dt, dt2))
                        events.append(
                            f"straggler@{step}:{dt:.3f}s"
                            + (f"->{dt2:.3f}s" if dt2 is not None else ""))
                if not straggled:
                    times.append(dt)
                state = new_state
                retries = 0

                if (step + 1) % self.checkpoint_every == 0:
                    self.ckpt.save(step + 1, state)
                    events.append(f"checkpoint@{step + 1}")
                step += 1

            except Preemption:
                self.ckpt.save(step, state, blocking=True)
                events.append(f"preempt-checkpoint@{step}")
                raise
            except WorkerFailure as e:
                retries += 1
                events.append(f"failure@{step}:{e}")
                if retries > self.max_retries_per_step:
                    raise
                # join in-flight async saves: a checkpoint written moments
                # before the failure must be visible to the restore
                self.ckpt.wait()
                restore_step = self.ckpt.latest_step()
                if restore_step is not None:
                    state, _ = self.ckpt.restore(state)
                    events.append(f"restore@{restore_step}")
                    step = restore_step
                # else: replay from current in-memory state (failure before
                # first checkpoint) — deterministic data makes this exact.
        self.ckpt.wait()
        return state
