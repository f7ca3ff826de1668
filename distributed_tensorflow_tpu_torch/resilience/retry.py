"""Unified retry policy: exponential backoff + jitter + deadline — port
of ``distributed_tensorflow_tpu/resilience/retry.py``: the same policy,
and from the same seed the same backoff sequences (Python's ``random``).

One policy object replaces the hand-rolled retry loops that had grown in
``coordinator/cluster_coordinator.py`` (per-worker resource creation:
fixed 3 attempts, resubmit between attempts) and
``coordinator/remote_dispatch.py`` (fast-fail backoff pacing inside
``RemoteLane.wait``) — ≙ the reference's single
``WorkerPreemptionHandler.wait_on_failure`` path
(cluster_coordinator.py:879) being the only place retry timing lives.

The policy is deliberately dumb about *what* is retryable: callers pass
the exception classification (``WorkerPreemptionError``,
``CoordinationError``, ...) so this module needs no imports from the
layers it serves.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry configuration + execution.

    - ``max_attempts``: total attempts (first try included);
    - ``initial_backoff_s`` * ``backoff_multiplier``^(n-1), capped at
      ``max_backoff_s``, slept between attempts (0 = no sleep);
    - ``jitter``: fraction j in [0, 1] — each backoff is scaled by a
      uniform draw from [1-j, 1+j] (decorrelates retry storms);
    - ``decorrelated``: full decorrelated jitter (the AWS
      exponential-backoff-and-jitter scheme): each backoff is a fresh
      uniform draw from ``[initial_backoff_s, 3 * previous_backoff]``,
      capped at ``max_backoff_s``. Where multiplicative ``jitter``
      spreads N simultaneous retriers over a ±j band around the SAME
      schedule — after a coordinator blip they still arrive in loose
      waves — decorrelated draws spread them over the whole
      [initial, cap] range within a couple of attempts, which is what
      keeps an N-worker retry storm off the KV. Deterministic
      per retrier under ``seed`` (give each worker its own seed);
    - ``deadline_s``: overall budget from the first attempt; when
      exceeded the last exception is re-raised instead of retrying;
    - ``retryable``: default exception classes ``call`` retries on;
    - ``seed``: seeds the jitter stream (None = nondeterministic).
    """

    max_attempts: int = 3
    initial_backoff_s: float = 0.0
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 30.0
    jitter: float = 0.0
    decorrelated: bool = False
    deadline_s: float | None = None
    retryable: tuple = (Exception,)
    seed: int | None = None

    def is_retryable(self, exc: BaseException, retryable=None) -> bool:
        return isinstance(exc, tuple(retryable or self.retryable))

    def _needs_rng(self) -> bool:
        return bool(self.jitter) or self.decorrelated

    def backoff_s(self, attempt: int,
                  rng: random.Random | None = None,
                  prev_s: float = 0.0) -> float:
        """Backoff after the ``attempt``-th failure (1-based).
        ``prev_s`` is the previous backoff actually used — the state
        decorrelated jitter chains on (0.0 for the first)."""
        if self.initial_backoff_s <= 0:
            return 0.0
        if self.decorrelated and rng is not None:
            lo = self.initial_backoff_s
            hi = max(3.0 * (prev_s if prev_s > 0 else lo), lo)
            return min(rng.uniform(lo, hi), self.max_backoff_s)
        d = min(self.initial_backoff_s
                * self.backoff_multiplier ** (attempt - 1),
                self.max_backoff_s)
        if self.jitter and rng is not None:
            d *= 1.0 - self.jitter + 2.0 * self.jitter * rng.random()
        return min(d, self.max_backoff_s)

    def call(self, fn: Callable, *, retryable=None,
             on_retry: Callable[[BaseException, int], None] | None = None):
        """Run ``fn()`` under this policy.

        On a retryable exception with attempts (and deadline budget)
        remaining: call ``on_retry(exc, attempt_number)`` (e.g. to
        resubmit work), sleep the backoff, try again. Exhaustion
        re-raises the LAST exception unchanged — callers that want a
        summary error catch and wrap it.
        """
        retry_on = tuple(retryable or self.retryable)
        rng = random.Random(self.seed) if self._needs_rng() else None
        deadline = (time.monotonic() + self.deadline_s
                    if self.deadline_s is not None else None)
        attempt = 0
        prev_d = 0.0
        while True:
            attempt += 1
            try:
                return fn()
            except BaseException as e:
                if not isinstance(e, retry_on):
                    raise
                if attempt >= self.max_attempts:
                    raise
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                if on_retry is not None:
                    on_retry(e, attempt)
                d = self.backoff_s(attempt, rng, prev_s=prev_d)
                prev_d = d
                if deadline is not None:
                    d = min(d, max(deadline - time.monotonic(), 0.0))
                if d > 0:
                    time.sleep(d)


class Backoff:
    """Stateful backoff pacer for open-ended loops (poll/wait paths that
    are bounded by liveness or deadline rather than attempt count).

    ``sleep(max_s=...)`` sleeps the next backoff in the policy's
    schedule, clamped to ``max_s``; ``reset()`` restarts the schedule
    after a success.
    """

    def __init__(self, policy: RetryPolicy, seed: int | None = None):
        self.policy = policy
        self._rng = (random.Random(policy.seed if seed is None else seed)
                     if policy._needs_rng() else None)
        self._attempt = 0
        self._prev = 0.0

    def next_s(self) -> float:
        self._attempt += 1
        d = self.policy.backoff_s(self._attempt, self._rng,
                                  prev_s=self._prev)
        self._prev = d
        return d

    def sleep(self, max_s: float | None = None) -> float:
        d = self.next_s()
        if max_s is not None:
            d = min(d, max_s)
        if d > 0:
            time.sleep(d)
        return d

    def reset(self):
        self._attempt = 0
        self._prev = 0.0
