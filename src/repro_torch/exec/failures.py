"""Fault injection & straggler simulation.

The paper's two engines differ exactly in their failure story: Warp:AdHoc
is "best effort" (always-on cluster, retries pushed to the client) while
Warp:Flume checkpoints and auto-recovers.  To *test* both behaviours on one
machine we inject failures at the shard-task boundary — the same boundary a
real deployment loses when a machine restarts.

``FaultPlan`` is threaded through both engines; tests use it to assert
(a) AdHoc degrades to partial coverage and reports it, (b) Flume re-executes
lost work and returns exact results, (c) speculative execution beats
stragglers.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Dict, Optional, Set, Tuple

__all__ = ["FaultPlan", "TaskFailure"]


class TaskFailure(RuntimeError):
    """Simulated machine failure while running a shard task."""


@dataclass
class FaultPlan:
    """Deterministic failure/straggler schedule.

    fail_once:   {(stage, shard)} — first attempt raises, retry succeeds
                 (transient machine restart).
    fail_always: {(stage, shard)} — every attempt raises (dead machine;
                 AdHoc must drop it, Flume must reroute to another worker —
                 which we model as succeeding after ``reroute_after``
                 attempts).
    straggle:    {(stage, shard): seconds} — sleep before computing.
    """

    fail_once: Set[Tuple[str, int]] = dc_field(default_factory=set)
    fail_always: Set[Tuple[str, int]] = dc_field(default_factory=set)
    straggle: Dict[Tuple[str, int], float] = dc_field(default_factory=dict)
    reroute_after: int = 3
    _attempts: Dict[Tuple[str, int], int] = dc_field(default_factory=dict)
    _lock: threading.Lock = dc_field(default_factory=threading.Lock)

    def check(self, stage: str, shard: int) -> None:
        """Called by workers at task start; raises to simulate failure."""
        key = (stage, shard)
        with self._lock:
            n = self._attempts.get(key, 0) + 1
            self._attempts[key] = n
        if key in self.straggle:
            time.sleep(self.straggle[key])
        if key in self.fail_once and n == 1:
            raise TaskFailure(f"injected transient failure: {key}")
        if key in self.fail_always and n < self.reroute_after:
            raise TaskFailure(f"injected persistent failure: {key}")

    def stages(self) -> Set[str]:
        """Stages named anywhere in the schedule — engines use this to
        tell a partition-axis-only plan (reroute before dispatch, waves
        stay batched) from per-shard faults (per-shard task scheduling)."""
        return ({s for s, _ in self.fail_once}
                | {s for s, _ in self.fail_always}
                | {s for s, _ in self.straggle})

    def attempts(self, stage: str, shard: int) -> int:
        with self._lock:
            return self._attempts.get((stage, shard), 0)


NO_FAULTS = FaultPlan()
