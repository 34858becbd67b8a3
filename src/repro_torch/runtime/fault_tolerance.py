"""Fault tolerance: heartbeats, straggler detection, restart policy —
the port's copy of the JAX package's ``runtime/fault_tolerance.py``.

On a real fleet these hooks bind to the coordination service; the decision
logic below is hardware-independent and is what the tests exercise.  A
training driver calls ``monitor.record_step`` each step and acts on the
returned ``Action``; the closed remapping loop
(``repro_torch.monitor.RemapMonitor.attach``) subscribes to its
``on_action`` stream.
"""

from __future__ import annotations

import enum
import time
from collections import deque
from dataclasses import dataclass, field


class Action(enum.Enum):
    CONTINUE = "continue"
    REBALANCE = "rebalance"          # shift data shards away from slow host
    EVICT_RESTART = "evict_restart"  # drop host, elastic restart from ckpt


@dataclass
class HostStats:
    history: deque = field(default_factory=lambda: deque(maxlen=64))
    missed_heartbeats: int = 0

    def push(self, dt: float):
        self.history.append(dt)
        self.missed_heartbeats = 0

    @property
    def median(self) -> float:
        if not self.history:
            return 0.0
        s = sorted(self.history)
        return s[len(s) // 2]


class StragglerMonitor:
    """Flags hosts whose step time exceeds fleet median by `threshold`×
    for `patience` consecutive steps; escalates to eviction after
    `evict_after` flags or `max_missed` heartbeats (dead host).

    Decisions are consumable two ways besides the return values:
    ``on_action(action, hosts)`` fires for every non-CONTINUE decision
    (``RemapMonitor.attach`` subscribes here to route REBALANCE through
    its replay gate), and the ``actions`` deque queues the same events
    for pull-style consumers (``drain_actions()`` empties it).
    """

    def __init__(self, n_hosts: int, threshold: float = 1.5,
                 patience: int = 3, evict_after: int = 10,
                 max_missed: int = 5, on_action=None,
                 queue_len: int = 256):
        self.hosts = {h: HostStats() for h in range(n_hosts)}
        self.threshold = threshold
        self.patience = patience
        self.evict_after = evict_after
        self.max_missed = max_missed
        self.on_action = on_action
        self.actions: deque = deque(maxlen=queue_len)
        self._flags = {h: 0 for h in range(n_hosts)}

    def _emit(self, action: Action, hosts: list[int]) -> None:
        if action == Action.CONTINUE:
            return
        self.actions.append((action, list(hosts)))
        if self.on_action is not None:
            self.on_action(action, list(hosts))

    def drain_actions(self) -> list[tuple[Action, list[int]]]:
        """Pop every queued non-CONTINUE decision (oldest first)."""
        out = list(self.actions)
        self.actions.clear()
        return out

    def heartbeat_missed(self, host: int) -> Action:
        self.hosts[host].missed_heartbeats += 1
        if self.hosts[host].missed_heartbeats >= self.max_missed:
            self._emit(Action.EVICT_RESTART, [host])
            return Action.EVICT_RESTART
        return Action.CONTINUE

    def record_step(self, step_times: dict[int, float]) -> tuple[Action,
                                                                 list[int]]:
        """step_times: host -> seconds for this step."""
        for h, dt in step_times.items():
            self.hosts[h].push(dt)
        medians = sorted(s.median for s in self.hosts.values() if s.history)
        if not medians:
            return Action.CONTINUE, []
        # lower median: with few hosts the upper median would sit on the
        # straggler itself and mask it
        fleet_median = medians[(len(medians) - 1) // 2]
        slow = []
        for h, s in self.hosts.items():
            if s.history and s.median > self.threshold * fleet_median:
                self._flags[h] += 1
                if self._flags[h] >= self.patience:
                    slow.append(h)
            else:
                self._flags[h] = max(0, self._flags[h] - 1)
        if not slow:
            return Action.CONTINUE, []
        worst = max(slow, key=lambda h: self._flags[h])
        action = Action.EVICT_RESTART \
            if self._flags[worst] >= self.evict_after else Action.REBALANCE
        self._emit(action, slow)
        return action, slow


@dataclass
class RestartPolicy:
    """Bounded exponential-backoff restart-from-checkpoint loop."""
    max_restarts: int = 20
    backoff_s: float = 5.0
    backoff_mult: float = 1.5
    max_backoff_s: float = 300.0
    restarts: int = 0

    def next_delay(self) -> float | None:
        if self.restarts >= self.max_restarts:
            return None
        d = min(self.backoff_s * self.backoff_mult ** self.restarts,
                self.max_backoff_s)
        self.restarts += 1
        return d


def run_with_restarts(train_fn, restore_fn, policy: RestartPolicy,
                      sleep=time.sleep):
    """Driver: run train_fn(state); on exception restore from checkpoint
    and retry with backoff.  train_fn returns normally when training is
    complete."""
    state = restore_fn()
    while True:
        try:
            return train_fn(state)
        except Exception:
            delay = policy.next_delay()
            if delay is None:
                raise
            sleep(delay)
            state = restore_fn()
