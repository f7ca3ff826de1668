"""Trace-derived metrics — the port holds only what the data-parallel
phase breakdown reads of ``distributed_tensorflow_tpu/telemetry/
trace.py``: :func:`overlap_efficiency`. The trace assembler and the
bottleneck classifier belong to a later slice."""

from __future__ import annotations


def overlap_efficiency(total_collective_s: float,
                       exposed_collective_s: float) -> float | None:
    """Fraction of collective time hidden behind compute (JAX ``:375``).

    ``total_collective_s`` is what the collectives cost run back to back
    (serial); ``exposed_collective_s`` how much of that extended the
    step. 1.0 = fully overlapped, 0.0 = nothing hidden; None when there
    was no collective at all."""
    if total_collective_s <= 0:
        return None
    eff = 1.0 - exposed_collective_s / total_collective_s
    return max(0.0, min(1.0, eff))
