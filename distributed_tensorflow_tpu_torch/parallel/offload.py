"""Host offload of the 1F1B activation stash — port of
``distributed_tensorflow_tpu/parallel/offload.py``.

1F1B (:func:`~distributed_tensorflow_tpu_torch.parallel.pipeline.
run_schedule`) keeps each stage input from its forward to its backward,
at most min(M, 2S-1) of them a rank. With ``offload_activations=True``
that stash is an :class:`ActivationSpillStore`: each input is copied to
pinned host memory by a ``non_blocking`` copy on a side stream (it
overlaps the next units' compute), the device tensor is let go, and the
copy comes back to the card just before the backward that reads it, so
a rank holds O(1) stage inputs on the device. The last stage's backward
runs in the cycle of its own forward, so it keeps that input itself and
never touches the store (JAX ``:19``). With ``"device"`` the same loop
runs with the entries kept as device tensors; the two are bitwise equal
end to end, since a round trip through the host keeps every bit.

JAX's host loop (``Offloaded1F1B``) stores one entry a cycle holding
every rank's row; here each rank is its own process and stores its own
inputs, one entry a forward, under the forward's cycle.

Failure surface: every spill passes the ``offload.spill`` fault site
(:mod:`~distributed_tensorflow_tpu_torch.resilience.faults`, tag
``c<cycle>``). A failed spill is retried once; a double failure is
recorded and surfaces as :class:`OffloadSpillError` at the backward
that needs the lost input — a clean, attributable error on that rank,
never silently wrong activations.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.resilience import faults


class OffloadSpillError(RuntimeError):
    """An activation spill failed (twice) and its consumer needed it."""


class _FailedSpill:
    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class _Spilled:
    """A host copy of a device tensor, and the event that marks the end
    of the copy (None when nothing is pending: a CPU tensor's copy)."""
    __slots__ = ("host", "event", "device")

    def __init__(self, host, event, device):
        self.host, self.event, self.device = host, event, device


class ActivationSpillStore:
    """The stash of stage inputs by forward cycle (JAX ``:66``).

    ``put`` fires the ``offload.spill`` site and, with ``spill``, starts
    the device→host copy (pinned memory, side stream) and keeps the host
    copy; ``get`` brings it back to the card on the current stream,
    after the copy out has finished. ``drop_through`` frees entries up
    to a cycle, so host residency stays O(S). ``spill=False`` keeps the
    device tensors themselves (the ``"device"`` arm)."""

    def __init__(self, *, spill: bool = True):
        self.spill = bool(spill)
        self._entries: dict = {}
        self._stream = None
        self.puts = 0
        self.retries = 0
        self.failures = 0
        self.spilled_bytes = 0

    def _copy_out(self, value: torch.Tensor) -> _Spilled:
        if value.device.type != "cuda":
            return _Spilled(value.clone(), None, value.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=value.device)
        host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
        self._stream.wait_stream(torch.cuda.current_stream(value.device))
        with torch.cuda.stream(self._stream):
            host.copy_(value, non_blocking=True)
            # the card's copy may be freed once the copy out has read it
            value.record_stream(self._stream)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Spilled(host, event, value.device)

    def put(self, cycle: int, value: torch.Tensor) -> None:
        self.puts += 1
        err: BaseException | None = None
        for attempt in (0, 1):
            try:
                faults.fire("offload.spill", tag=f"c{cycle}")
                entry = self._copy_out(value) if self.spill else value
                if attempt:
                    self.retries += 1
                self._entries[cycle] = entry
                return
            except Exception as e:  # FaultInjected or a real copy failure
                err = e
        self.failures += 1
        self._entries[cycle] = _FailedSpill(err)

    def get(self, cycle: int) -> torch.Tensor:
        entry = self._entries.get(cycle)
        if isinstance(entry, _FailedSpill):
            raise OffloadSpillError(
                f"activation stash entry for cycle {cycle} was lost: "
                f"its spill failed twice") from entry.error
        if entry is None:
            raise OffloadSpillError(
                f"activation stash entry for cycle {cycle} is missing "
                f"(already dropped or never spilled)")
        if not self.spill:
            return entry
        self.spilled_bytes += entry.host.numel() * entry.host.element_size()
        if entry.event is None:
            return entry.host
        torch.cuda.current_stream(entry.device).wait_event(entry.event)
        return entry.host.to(entry.device, non_blocking=True)

    def pop(self, cycle: int) -> torch.Tensor:
        """``get``, then ``drop_through`` the same cycle: entries are read
        in the order they were put."""
        value = self.get(cycle)
        self.drop_through(cycle)
        return value

    def drop_through(self, cycle: int) -> None:
        """Free every entry with key <= cycle."""
        for key in [k for k in self._entries if k <= cycle]:
            del self._entries[key]

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self, cycles: int) -> dict:
        """The ``offload.step`` event's fields for a step of ``cycles``
        cycles."""
        return {"cycles": cycles, "puts": self.puts,
                "retries": self.retries, "failures": self.failures,
                "spilled_bytes": self.spilled_bytes,
                "resident_entries": len(self)}
