"""Passive preemption monitor — port of
``distributed_tensorflow_tpu/checkpoint/preemption_watcher.py``.

≙ tensorflow/python/distribute/failure_handling/preemption_watcher.py:45
``PreemptionWatcher`` (SURVEY.md §2.5): watches for a platform preemption
notice without wrapping the train loop; exposes ``preemption_message`` once
one arrives, so user code can poll between steps.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Callable


class PreemptionWatcher:
    """Watches SIGTERM (and an optional poll fn) in the background."""

    def __init__(self, watcher_fn: Callable[[], bool] | None = None,
                 poll_interval: float = 1.0):
        self._message: str | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._handler = None
        self._prev_handler = None
        self._install()
        self._thread = None
        if watcher_fn is not None:
            def loop():
                while not self._stop.is_set():
                    try:
                        if watcher_fn():
                            self._set("platform notice")
                            return
                    except Exception:
                        pass
                    time.sleep(poll_interval)

            self._thread = threading.Thread(target=loop, daemon=True)
            self._thread.start()

    def _install(self):
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def handler(signum, frame):
                self._set(f"signal {signum}")
                if callable(prev) and prev not in (signal.SIG_IGN,
                                                   signal.SIG_DFL):
                    prev(signum, frame)

            signal.signal(signal.SIGTERM, handler)
            # kept for stop(): stacked watchers must unwind LIFO without
            # leaking handlers across tests
            self._handler = handler
            self._prev_handler = prev
        except (ValueError, OSError):
            pass

    def _set(self, msg: str):
        with self._lock:
            self._message = msg

    @property
    def preemption_message(self) -> str | None:
        with self._lock:
            return self._message

    def block_until_worker_exit(self, timeout: float | None = None):
        """≙ PreemptionWatcher.block_until_worker_exit."""
        start = time.time()
        while self.preemption_message is None:
            if timeout is not None and time.time() - start > timeout:
                return
            time.sleep(0.05)

    def stop(self):
        """Stop the poll thread and restore the SIGTERM handler that was
        installed before this watcher (only if ours is still the current
        one — an out-of-order stop must not break a newer watcher's
        chain)."""
        self._stop.set()
        if (self._handler is not None
                and threading.current_thread() is threading.main_thread()):
            try:
                if signal.getsignal(signal.SIGTERM) is self._handler:
                    signal.signal(signal.SIGTERM, self._prev_handler)
                    self._handler = None
            except (ValueError, OSError):
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
