"""MetricsRegistry: namespaced Counter / Gauge / Histogram.

The port's own copy of ``distributed_tensorflow_tpu/telemetry/
registry.py`` — the instruments the serving engine and scheduler
record into, with the same names, types and export dicts, and the
collectors (``register_collector``) through which the goodput ledger
exports its breakdown. Delta export belongs to the fleet-telemetry
slice.
"""

from __future__ import annotations

import threading


class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._value = 0
        self._lock = threading.Lock()

    def increment(self, n: int = 1):
        with self._lock:
            self._value += n


    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def export(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Latest-value cell (numbers, strings — anything JSON-ready)."""

    kind = "gauge"

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._value = None
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = value

    @property
    def value(self):
        with self._lock:
            return self._value

    def export(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Streaming distribution: exact count/sum/min/max plus percentiles
    over the most recent ``window`` samples."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 window: int = 512):
        self.name = name
        self.description = description
        self._window = window
        self._samples: list[float] = []
        self._next = 0                   # ring-buffer write cursor
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._lock = threading.Lock()

    def record(self, value: float):
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value
            if len(self._samples) < self._window:
                self._samples.append(value)
            else:
                self._samples[self._next] = value
                self._next = (self._next + 1) % self._window


    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def export(self) -> dict:
        with self._lock:
            s = sorted(self._samples)
            out = {"type": "histogram", "count": self._count,
                   "sum": round(self._sum, 9), "min": self._min,
                   "max": self._max}
        if s:
            def pct(q):
                return s[min(len(s) - 1,
                             max(0, int(round(q / 100 * (len(s) - 1)))))]
            out.update(p50=pct(50), p95=pct(95), p99=pct(99))
        return out


class MetricsRegistry:
    """Named, typed instrument store with snapshot export. Get-or-create
    is idempotent: the same name and type returns the same instrument;
    the same name with another type raises."""

    def __init__(self):
        self._instruments: dict[str, object] = {}
        self._collectors: dict[str, object] = {}
        self._lock = threading.Lock()

    def _instrument(self, cls, name: str, description: str = "", **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{inst.kind}, requested {cls.kind}")
                return inst
            inst = cls(name, description, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, description: str = "") -> Counter:
        return self._instrument(Counter, name, description)

    def gauge(self, name: str, description: str = "") -> Gauge:
        return self._instrument(Gauge, name, description)

    def histogram(self, name: str, description: str = "",
                  window: int = 512) -> Histogram:
        return self._instrument(Histogram, name, description,
                                window=window)

    def register_collector(self, prefix: str, fn):
        """``fn() -> {name: value}``; merged into every snapshot under
        ``<prefix>/<name>`` as gauge entries (for instrument sets that
        keep their own storage, e.g. the goodput ledger)."""
        with self._lock:
            self._collectors[prefix] = fn

    def unregister_collector(self, prefix: str):
        with self._lock:
            self._collectors.pop(prefix, None)

    def snapshot(self) -> dict:
        """All instruments as one JSON-ready dict {name: export-dict},
        plus every collector's values as gauges."""
        with self._lock:
            instruments = dict(self._instruments)
            collectors = dict(self._collectors)
        out = {name: inst.export() for name, inst in instruments.items()}
        for prefix, fn in collectors.items():
            try:
                collected = fn()
            except Exception:          # a broken collector must not
                continue               # take down metric export
            for name, value in collected.items():
                out[f"{prefix}/{name}"] = {"type": "gauge", "value": value}
        return out


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _default
