"""Coordinator watchdog: dump all-thread stacks on inactivity — port of
``distributed_tensorflow_tpu/coordinator/watchdog.py``.

≙ tensorflow/python/distribute/coordinator/watchdog.py:25 ``WatchDog``
(SURVEY.md §2.5, §5.2): if the coordinator makes no progress for
``timeout`` seconds, dump every thread's stack to aid hang debugging.
"""

from __future__ import annotations

import faulthandler
import sys
import threading
import time
from typing import Callable


class WatchDog:
    def __init__(self, timeout: float = 300.0,
                 on_triggered: Callable[[], None] | None = None,
                 output=sys.stderr):
        self._timeout = timeout
        self._on_triggered = on_triggered
        self._output = output
        self._last_activity = time.time()
        self._stop = threading.Event()
        self._triggered_count = 0
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="dtx-watchdog")
        self._thread.start()

    def report_activity(self):
        self._last_activity = time.time()

    def set_timeout(self, timeout: float):
        """Re-arm with a new inactivity budget (the telemetry stall
        detector tracks a multiple of the trailing median step time).
        Takes effect within the current 1s wait slice."""
        self._timeout = timeout

    @property
    def triggered_count(self) -> int:
        return self._triggered_count

    def _watch(self):
        while not self._stop.wait(min(self._timeout / 10, 1.0)):
            if time.time() - self._last_activity > self._timeout:
                self._triggered_count += 1
                self._last_activity = time.time()
                try:
                    print(f"[dtx WatchDog] no coordinator activity for "
                          f">{self._timeout}s; dumping stacks",
                          file=self._output, flush=True)
                    faulthandler.dump_traceback(file=self._output)
                except Exception:
                    pass
                if self._on_triggered is not None:
                    # a user callback that raises must not kill the
                    # watch loop — the watchdog outlives its hooks
                    try:
                        self._on_triggered()
                    except Exception:
                        try:
                            print("[dtx WatchDog] on_triggered raised "
                                  "(ignored)", file=self._output,
                                  flush=True)
                        except Exception:
                            pass

    def stop(self, timeout: float | None = 5.0):
        """Stop AND join the watch thread, so no trigger can fire after
        stop() returns (a dangling watch thread dumping stacks into a
        closed test capture was the previous failure mode)."""
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
