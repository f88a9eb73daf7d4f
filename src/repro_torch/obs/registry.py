"""Typed metrics registry: counters / gauges / histograms with labels
(counterpart of ``repro/obs/registry.py``; the same instrument names and
JSON-lines schema, so a snapshot line from either package parses with the
other's :func:`read_jsonl`).

``ServeMetrics`` folds one run into one summary dict at the END of
``serve()`` — useless for a long-lived engine.  The registry is the
live-publication side: the engine, scheduler, admission policy and trainer
publish into named instruments as they go, and the engine snapshots the
whole registry to JSON-lines at window boundaries (``ObsConfig
.metrics_path``), so a running service is observable mid-flight.

Instruments (Prometheus-flavoured, dependency-free):

* :class:`Counter`   — monotone ``inc``; e.g. ``serve_windows_total``.
* :class:`Gauge`     — ``set``/``inc``/``dec``; e.g. ``serve_queue_depth``.
* :class:`Histogram` — ``observe`` into cumulative buckets + sum/count;
  e.g. ``serve_boundary_lag_ticks``.

Every instrument takes a label-name tuple at registration and binds label
VALUES via ``.labels(action="bump")`` — children are cached per value
tuple, so hot-path publication is a dict hit plus a float add.
Re-registering a name returns the existing instrument (asserting the kind
matches), so independent publishers can share one series.

:data:`NULL_REGISTRY` is the zero-cost disabled twin (shared no-op
instrument, no storage) mirroring ``trace.NULL_TRACER``.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Sequence, Tuple

# serving latencies are tick-grained; these default buckets cover both
# tick counts and sub-second wall times
DEFAULT_BUCKETS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0)


class _Instrument:
    """Shared label plumbing: parent owns per-label-value children."""

    kind = "abstract"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(labels)
        self._children: Dict[Tuple[str, ...], "_Instrument"] = {}
        if not self.label_names:
            self._children[()] = self
        self._init_value()

    def _init_value(self) -> None:
        raise NotImplementedError

    def labels(self, **kv) -> "_Instrument":
        assert set(kv) == set(self.label_names), \
            f"{self.name}: got labels {sorted(kv)}, declared " \
            f"{sorted(self.label_names)}"
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = type(self).__new__(type(self))
            child.name, child.help = self.name, self.help
            child.label_names = self.label_names
            child._children = {}
            self._copy_config(child)
            child._init_value()
            self._children[key] = child
        return child

    def _copy_config(self, child: "_Instrument") -> None:
        """Hook for subclasses with extra per-instrument config."""

    def _series(self) -> List[Dict]:
        out = []
        for key, child in sorted(self._children.items()):
            rec = {"value": child._value_view()}
            if self.label_names:
                rec["labels"] = dict(zip(self.label_names, key))
            out.append(rec)
        return out

    def _value_view(self):
        raise NotImplementedError


class Counter(_Instrument):
    kind = "counter"

    def _init_value(self) -> None:
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        assert n >= 0, f"{self.name}: counters are monotone (inc {n})"
        self._value += n

    @property
    def value(self) -> float:
        return self._value

    def _value_view(self) -> float:
        return self._value


class Gauge(_Instrument):
    kind = "gauge"

    def _init_value(self) -> None:
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._value += n

    def dec(self, n: float = 1.0) -> None:
        self._value -= n

    @property
    def value(self) -> float:
        return self._value

    def _value_view(self) -> float:
        return self._value


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        assert self.buckets, "histogram needs >= 1 bucket bound"
        super().__init__(name, help, labels)

    def _copy_config(self, child: "_Instrument") -> None:
        child.buckets = self.buckets

    def _init_value(self) -> None:
        self._counts = [0] * (len(self.buckets) + 1)   # +inf tail
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self._sum += v
        self._count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self._counts[i] += 1
                return
        self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _value_view(self) -> Dict:
        return {"buckets": list(self.buckets),
                "counts": list(self._counts),
                "sum": self._sum, "count": self._count}


class _NullInstrument:
    """The one shared no-op instrument the disabled registry hands out."""

    def labels(self, **kv):
        return self

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    value = 0.0
    count = 0
    sum = 0.0


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """Zero-cost disabled registry (falsy; all instruments shared no-op)."""

    enabled = False

    def __bool__(self) -> bool:
        return False

    def counter(self, name, help="", labels=()):
        return _NULL_INSTRUMENT

    def gauge(self, name, help="", labels=()):
        return _NULL_INSTRUMENT

    def histogram(self, name, help="", labels=(), buckets=DEFAULT_BUCKETS):
        return _NULL_INSTRUMENT

    def snapshot(self) -> Dict:
        return {}

    def write_jsonl(self, path, **meta) -> None:
        pass


NULL_REGISTRY = NullRegistry()


class MetricsRegistry:
    """Name -> instrument map with get-or-create registration."""

    enabled = True

    def __init__(self):
        self._instruments: Dict[str, _Instrument] = {}

    def __bool__(self) -> bool:
        return True

    def _get(self, cls, name: str, help: str, labels, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, help, labels, **kw)
            self._instruments[name] = inst
            return inst
        assert inst.kind == cls.kind, \
            f"{name!r} already registered as {inst.kind}, not {cls.kind}"
        assert inst.label_names == tuple(labels), \
            f"{name!r} registered with labels {inst.label_names}, " \
            f"got {tuple(labels)}"
        return inst

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        """JSON-able view of every registered series — the registry
        schema: ``{name: {kind, help, series: [{labels?, value}]}}`` where
        ``value`` is a float (counter/gauge) or the histogram record
        ``{buckets, counts, sum, count}``."""
        return {name: {"kind": inst.kind, "help": inst.help,
                       "series": inst._series()}
                for name, inst in sorted(self._instruments.items())}

    def write_jsonl(self, path, **meta) -> None:
        """Append ONE snapshot line (``{"ts": ..., **meta, "metrics":
        snapshot}``) — the engine calls this at window boundaries so a
        long-lived serve is observable mid-run, not only at summary()."""
        line = {"ts": time.time(), **meta, "metrics": self.snapshot()}
        if hasattr(path, "write"):
            path.write(json.dumps(line) + "\n")
            path.flush()
        else:
            with open(path, "a") as f:
                f.write(json.dumps(line) + "\n")


def read_jsonl(path) -> List[Dict]:
    """Parse a metrics JSON-lines file back into snapshot dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
