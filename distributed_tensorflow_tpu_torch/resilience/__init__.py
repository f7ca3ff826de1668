"""Resilience: :mod:`faults`, the seed-driven fault-injection layer
(the ``serve.step`` site of the serving engine)."""
