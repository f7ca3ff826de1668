"""Preemption-safe coordinated checkpointing — port of
``distributed_tensorflow_tpu/checkpoint/failure_handling.py``. The
signal, the step-count gather and the confirm rounds ride the
coordination KV (``cluster/coordination.py``: the process group's
store), never a collective of the data plane, so the agreement
completes while a rank is wedged in one.

TPU-native counterpart of tensorflow/python/distribute/failure_handling/
failure_handling.py (SURVEY.md §2.5, §3.5):

- ``TerminationConfig``            ≙ failure_handling.py:75-244 (platform
  matrix: Borg/GCE x CPU/GPU/TPU). Here the platform signal set collapses to
  SIGTERM plus the GCE/TPU-VM maintenance-event file hook.
- ``PreemptionCheckpointHandler``  ≙ failure_handling.py:337: wraps the
  train loop; on a preemption signal every process agrees on a "step to
  save at", checkpoints there, and exits (or counts down a grace period).

The cross-process agreement protocol in the reference rides the
coordination-service KV store plus a step-count gather
(_watch_step_to_save_key, failure_handling.py:1222). Here it rides the
same KV store through cluster/coordination.py: signal key -> background
gather of step counts -> run-to-max -> confirm rounds (see
``_agree_on_preemption``/``_confirm_stop_step``). Single-process
degenerates to a local flag.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Callable

from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
    CheckpointManager)
from distributed_tensorflow_tpu_torch.cluster import elastic
from distributed_tensorflow_tpu_torch.cluster.coordination import (
    coordination_service)
from distributed_tensorflow_tpu_torch.resilience import faults

#: Process exit code meaning "preempted after a clean checkpoint —
#: restart me" (≙ the reference's restart-the-job convention). The
#: recovery supervisor classifies this code as a preemption, not a crash.
EXIT_PREEMPTED = 42


class TrainingPreempted(RuntimeError):
    """Raised (instead of exiting the process from library code) by
    :class:`PreemptionCheckpointHandler` in ``restart`` exit mode, after
    the preemption checkpoint has committed. The owner of the training
    loop — an elastic worker shell or the recovery supervisor's spawned
    task — catches it and tears down for restart, typically exiting
    with :data:`EXIT_PREEMPTED`."""


@dataclasses.dataclass
class TerminationConfig:
    """≙ failure_handling.py:75 ``TerminationConfig``.

    ``exit_mode`` selects what happens once the preemption checkpoint is
    committed and no ``exit_fn`` is injected:

    - ``"exit"`` (default): raise ``SystemExit(EXIT_PREEMPTED)`` so the
      platform restarts the job — the reference's behavior;
    - ``"restart"``: raise :class:`TrainingPreempted` instead, keeping
      process teardown OUT of library code — the mode elastic/supervised
      jobs use (``for_platform`` picks it automatically when a recovery
      supervisor owns this process).
    """

    termination_watcher_fn: Callable[[], bool] | None = None
    exit_fn: Callable[[], None] | None = None
    grace_period: float = 0.0
    save_fn: Callable[[], None] | None = None
    exit_mode: str = "exit"

    def __post_init__(self):
        if self.exit_mode not in ("exit", "restart"):
            raise ValueError(f"exit_mode must be 'exit' or 'restart', "
                             f"got {self.exit_mode!r}")

    @classmethod
    def for_platform(cls) -> "TerminationConfig":
        """Platform sniffing (≙ failure_handling.py:245): on GCE/TPU-VM,
        watch the maintenance-event metadata; default is signal-only.
        Under a recovery supervisor the exit mode is ``restart``."""
        watcher = None
        event_file = os.environ.get("DTX_MAINTENANCE_EVENT_FILE")
        if event_file:
            def watcher() -> bool:  # noqa: F811
                try:
                    with open(event_file) as f:
                        return "TERMINATE" in f.read().upper()
                except OSError:
                    return False
        return cls(termination_watcher_fn=watcher,
                   exit_mode="restart" if elastic.under_supervisor()
                   else "exit")


class PreemptionCheckpointHandler:
    """Wraps a training loop with preemption-triggered checkpointing.

    Usage (≙ failure_handling.py:805 ``run``):

        handler = PreemptionCheckpointHandler(manager)
        for _ in range(steps):
            handler.run(train_step_fn)   # runs fn; checkpoints+exits on
                                         # preemption at a step boundary
    """

    def __init__(self, checkpoint_manager: CheckpointManager,
                 termination_config: TerminationConfig | None = None,
                 watch_interval: float = 1.0):
        self._manager = checkpoint_manager
        self._config = termination_config or TerminationConfig.for_platform()
        self._received = threading.Event()
        self._step = 0
        self._run_count_restored = 0
        self._exited = False
        self._save_at: int | None = None
        self._sync_thread: threading.Thread | None = None
        self._signal_poller: threading.Thread | None = None
        self._poller: threading.Thread | None = None
        # Job-scoped keys: shared by all processes of this job (same
        # checkpoint dir — hashed abspath, so two jobs whose directories
        # share a basename never cross-signal), distinct across jobs.
        import hashlib
        absdir = os.path.abspath(checkpoint_manager.directory)
        job = (os.path.basename(absdir) + "."
               + hashlib.sha1(absdir.encode()).hexdigest()[:12])
        self._SIGNAL_KEY = f"dtx_preemption/{job}/signal"
        self._STEPS_PREFIX = f"dtx_preemption/{job}/steps"
        self._GATHER_BARRIER = f"dtx_preemption/{job}/gather"
        self._CONFIRM_PREFIX = f"dtx_preemption/{job}/confirm"
        self._confirm_round = 0
        self._sync_error: BaseException | None = None
        self._grace_deadline: float | None = None
        self._finalizing = False
        self._sigterm_handler = None
        self._prev_sigterm = None

        # restore first (≙ failure_handling.py:647 restore-on-init)
        latest = self._manager.restore_or_initialize()
        if latest is not None:
            self._run_count_restored = self._manager.checkpoint.save_counter

        self._install_signal_handler()
        if self._config.termination_watcher_fn is not None:
            self._poller = threading.Thread(target=self._poll, daemon=True)
            self._poller.start()
        if coordination_service().is_distributed:
            self._start_signal_poller()

    # -- signal plumbing ---------------------------------------------------
    def _install_signal_handler(self):
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def handler(signum, frame):
                self._received.set()
                if callable(prev) and prev not in (signal.SIG_IGN,
                                                   signal.SIG_DFL):
                    prev(signum, frame)

            signal.signal(signal.SIGTERM, handler)
            # kept for _restore_signal_handler(): stacked handlers must
            # unwind LIFO without leaking across handler lifetimes (the
            # PreemptionWatcher.stop() discipline)
            self._sigterm_handler = handler
            self._prev_sigterm = prev
        except (ValueError, OSError):
            pass  # non-main thread / restricted env

    def _restore_signal_handler(self):
        """Put back the SIGTERM handler that was installed before this
        handler (only if ours is still the current one — an out-of-order
        teardown must not break a newer handler's chain)."""
        if (self._sigterm_handler is None
                or threading.current_thread()
                is not threading.main_thread()):
            return
        try:
            if signal.getsignal(signal.SIGTERM) is self._sigterm_handler:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
                self._sigterm_handler = None
        except (ValueError, OSError):
            pass

    def _poll(self):
        while not self._received.is_set():
            try:
                if self._config.termination_watcher_fn():
                    self._received.set()
                    return
            except Exception:
                pass
            time.sleep(1.0)

    # -- public API --------------------------------------------------------
    @property
    def total_run_calls(self) -> int:
        """≙ PreemptionCheckpointHandler.total_run_calls: steps run across
        all incarnations (restored + this process)."""
        return self._step

    def watch_preemption(self):
        """Manually mark a preemption notice (tests/fault injection)."""
        self._received.set()

    def finalize(self):
        """Call after the training loop (on every process): if a
        preemption was signalled but the agreed save step was never
        reached (the loop ran out first — e.g. the signal landed on the
        last step), checkpoint NOW so the progress isn't lost. No-op
        otherwise. Either way the SIGTERM handler installed at
        construction is restored (LIFO unwind, the way
        ``PreemptionWatcher.stop()`` already does) — the training loop
        is over, so this handler's watch is too."""
        try:
            self._finalize_impl()
        finally:
            self._restore_signal_handler()

    def _finalize_impl(self):
        if self._exited:
            return
        agent = coordination_service()
        # a peer may have signalled after our last in-loop poll
        if (not self._received.is_set() and agent.is_distributed
                and agent.key_value_try_get(self._SIGNAL_KEY) is not None):
            self._received.set()
        if not self._received.is_set():
            return
        # publish our signal/steps + start the sync thread if the signal
        # arrived after the last step's check, then wait it out so its
        # `_save_at = max + 2` cannot overwrite the override below
        self._agree_on_preemption()
        if self._sync_thread is not None and self._sync_thread.is_alive():
            self._sync_thread.join(timeout=600)
        self._save_at = self._step          # save at wherever we stopped
        # Finalize mode: this process CANNOT step further (its loop is
        # over). The confirm protocol must not send it back to "run to
        # the raised target" — it publishes its step as final and loops
        # confirm rounds until peers converge, then saves, so the
        # committed checkpoint always contains this host's shards.
        self._finalizing = True
        self._check_preemption_and_maybe_checkpoint()

    def run(self, distributed_train_fn: Callable, *args, **kwargs):
        """Run one step, then checkpoint-and-exit if preemption was
        signalled (≙ failure_handling.py:805/:1082)."""
        result = distributed_train_fn(*args, **kwargs)
        self._step += 1
        # Chaos site: a scheduled synthetic preemption notice, delivered
        # exactly as a platform SIGTERM would be (the active() guard
        # keeps the agent lookup off the disabled-path per-step cost).
        if faults.active() and faults.fire(
                "preemption.signal",
                tag=coordination_service().process_id) is not None:
            self._received.set()
        self._check_preemption_and_maybe_checkpoint()
        return result

    def _start_signal_poller(self):
        """Multi-process only: a daemon thread that notices a PEER's
        preemption signal via the coordination KV store (≙ the reference's
        _watch_step_to_save_key thread, failure_handling.py:1222) without
        any per-step RPC on the training path."""
        agent = coordination_service()

        def poll():
            while not self._received.is_set() and not self._exited:
                if agent.key_value_try_get(self._SIGNAL_KEY) is not None:
                    self._received.set()
                    return
                time.sleep(0.1)

        self._signal_poller = threading.Thread(target=poll, daemon=True)
        self._signal_poller.start()

    def _agree_on_preemption(self) -> int | None:
        """Cross-process agreement on the step to save at (≙ the
        reference's gather-run-counts-then-run-to-max protocol,
        failure_handling.py:1222):

        1. the signalled process sets a job-wide SIGNAL key; peers notice
           via their poller threads (no per-step RPC);
        2. every process publishes its current step and joins a barrier
           **on a background thread** — the main loop keeps stepping, so
           in-flight SPMD collectives keep completing and the agreement
           can never deadlock against the data plane;
        3. save_at = max(published steps) + margin; every process runs to
           exactly that step and checkpoints there.

        Returns the agreed step, or None while agreement is pending.
        Single-process degenerates to "save at the current step, now".
        """
        agent = coordination_service()
        if not self._received.is_set():
            return self._save_at
        if not agent.is_distributed:
            if self._save_at is None:
                self._save_at = self._step
            return self._save_at
        if self._sync_thread is None:
            try:
                agent.key_value_set(self._SIGNAL_KEY, "1",
                                    allow_overwrite=False)
            except Exception:
                pass                       # a peer signalled first — fine

            def sync():
                try:
                    agent.key_value_set(
                        f"{self._STEPS_PREFIX}/p{agent.process_id}",
                        str(self._step))
                    agent.barrier(self._GATHER_BARRIER, timeout_s=600)
                    # enumerated point reads, not a directory listing:
                    # every process published before the barrier, and
                    # point gets work on every client vintage (legacy
                    # TSL clients hang on remote GetKeyValueDir)
                    steps = [int(agent.key_value_get(
                        f"{self._STEPS_PREFIX}/p{i}", timeout_s=60))
                        for i in range(agent.num_processes)]
                    # margin covers steps taken while the barrier settled
                    self._save_at = max(steps) + 2
                except BaseException as e:
                    # A peer died mid-agreement (the very case preemption
                    # handling exists for): degrade to a best-effort local
                    # save at the next step instead of swallowing the
                    # signal forever.
                    self._sync_error = e
                    self._save_at = self._step + 1

            self._sync_thread = threading.Thread(target=sync, daemon=True)
            self._sync_thread.start()
        return self._save_at

    def _confirm_stop_step(self, save_at: int) -> bool:
        """Phase 2 of the agreement: every process publishes the step it
        actually stopped at and all confirm equality. A process that ran
        past ``save_at`` before noticing (RPC latency beat the +2 margin)
        raises the target to the max, everyone catches up, and the round
        repeats — so the committed checkpoint's shards all come from the
        SAME step. Runs on the main thread; a blocked process has already
        enqueued all its steps, so peers' in-flight collectives complete.

        A process in finalize mode (its loop is over — it cannot step)
        publishes its step with a ``!`` final marker. A round also
        converges when EVERY entry is final-marked: no host can advance,
        so all save now at a common checkpoint number (max of the
        published steps) — every host contributes shards rather than a
        laggard silently dropping out while peers block on the shard
        barrier.

        Returns True when this process should save now.
        """
        agent = coordination_service()
        if not agent.is_distributed or self._sync_error is not None:
            return True
        del save_at
        while True:
            r = self._confirm_round
            try:
                mark = "!" if self._finalizing else ""
                agent.key_value_set(
                    f"{self._CONFIRM_PREFIX}{r}/p{agent.process_id}",
                    f"{self._step}{mark}")
                agent.barrier(f"{self._CONFIRM_PREFIX}{r}/barrier",
                              timeout_s=600)
                # enumerated point reads (see sync() above)
                entries = [agent.key_value_get(
                    f"{self._CONFIRM_PREFIX}{r}/p{i}",
                    timeout_s=60).decode()
                    for i in range(agent.num_processes)]
                steps = [int(e.rstrip("!")) for e in entries]
                final = max(steps)
                # Convergence when no more catching-up is possible:
                # every process still BELOW the target has declared its
                # loop over. (Processes at the target never need to
                # advance, final-marked or not.)
                blocked = all(e.endswith("!") for e, s in
                              zip(entries, steps) if s < final)
            except Exception as e:
                self._sync_error = e
                return True                # degraded best-effort save
            self._confirm_round += 1       # every process, every round
            # EVERY process adopts the confirmed step — the save path
            # derives the checkpoint number (and thus the commit-barrier
            # token) from _save_at, which must be identical on all hosts.
            self._save_at = final
            if min(steps) == final:
                return True                # all stopped at the same step
            if blocked:
                # No below-target process can advance (their loops are
                # over — the signal landed on someone's last steps):
                # save what we have under a common number so no host's
                # shards are missing from the commit.
                import logging
                logging.getLogger(__name__).warning(
                    "preemption finalize: hosts stopped at unequal steps "
                    "%s; committing best-effort checkpoint at %d",
                    sorted(steps), final)
                return True
            if not self._finalizing and self._step < final:
                # laggard: run to the raised target, then confirm again
                return False
            # already at the target (or final, waiting for peers to
            # reach it / finish their loops): confirm again without
            # stepping — all our steps are enqueued, so peers' in-flight
            # collectives still complete

    def _check_preemption_and_maybe_checkpoint(self):
        if self._exited:
            return
        if self._grace_deadline is not None:
            # already checkpointed; training continues until the platform
            # grace window closes (≙ failure_handling.py:1204 — the
            # reference KEEPS RUNNING during the grace period, banking
            # extra steps, rather than sleeping it away)
            if time.time() >= self._grace_deadline:
                self._exit()
            return
        save_at = self._agree_on_preemption()
        if save_at is None or self._step < save_at:
            return
        if not self._confirm_stop_step(save_at):
            return
        if self._config.save_fn is not None:
            self._config.save_fn()
            # NOTE: no key retirement here — a custom save_fn has no
            # commit barrier, so a peer's sync thread may still be
            # reading the agreement keys.
        else:
            self._manager.save(checkpoint_number=self._save_at +
                               self._run_count_restored
                               if self._save_at is not None
                               else self._step + self._run_count_restored)
            self._manager.checkpoint.sync()
            # Every process has saved (save's commit protocol ends with a
            # cross-process barrier), so the agreement keys can be
            # retired — a later handler on this job must start clean.
            agent = coordination_service()
            try:
                agent.key_value_delete(self._SIGNAL_KEY)
                agent.key_value_delete(self._STEPS_PREFIX)
            except Exception:
                pass
        if self._config.grace_period:
            # checkpoint secured; bank extra training steps until the
            # platform window closes, then exit at a step boundary
            self._grace_deadline = time.time() + self._config.grace_period
            return
        self._exit()

    def _exit(self):
        """Leave the training loop after the preemption checkpoint
        committed. Injectable (``TerminationConfig.exit_fn``) and
        overridable; with no injection the behavior is mode-selected
        (see :class:`TerminationConfig`) but always *raises* — library
        code never hard-exits the process."""
        self._exited = True
        self._restore_signal_handler()
        from distributed_tensorflow_tpu_torch.telemetry import events as _events
        _events.event("preemption.exit", step=self._step,
                      save_at=self._save_at, mode=self._config.exit_mode)
        if self._config.exit_fn is not None:
            self._config.exit_fn()
        elif self._config.exit_mode == "restart":
            raise TrainingPreempted(
                f"preempted at step {self._step}; checkpoint saved at "
                f"step {self._save_at} — restart to resume")
        else:
            raise SystemExit(EXIT_PREEMPTED)  # platform restarts the job
