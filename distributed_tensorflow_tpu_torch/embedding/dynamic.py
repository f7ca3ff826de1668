"""Dynamic embedding tables: id→row membership with frequency-capped
admission, LFU+TTL eviction and growth — port of
``distributed_tensorflow_tpu/embedding/dynamic.py``.

- **Host membership, as JAX's.** The id→row map, the count-min sketch,
  admission, eviction, TTL and growth are the same host numpy code, so
  row assignments are exact: the same ids give the same rows in both
  packages. Row 0 is the shared COLD row of sub-threshold ids.
- **Device rows.** The table and its optimizer slots are tensors on the
  table's ``device``; initialisation draws from ``np.random.
  default_rng([seed, start, n])`` (JAX ``:260-266``) and re-admission
  from ``[seed, 0xAD417, row, admission]``, so fresh tables are
  bitwise JAX's.
- **Row-sparse apply.** :meth:`DynamicTable.apply_row_grads` sums the
  per-example gradients of duplicate rows on the host (``np.add.at``,
  as JAX), gathers the touched rows and slots, applies the table's
  optimizer (``embedding/embedding.py``'s SGD/Adagrad/Adam/FTRL) and
  scatters them back; untouched rows and slots are bit-identical
  afterwards. JAX pads the unique-row buffer with an out-of-bounds row
  that XLA's scatter drops; here only the real rows are indexed.
- **State.** :meth:`DynamicTable.state_dict` is JAX's: ``rows`` and a
  pickled ``aux`` of numpy arrays and Python values (slots, membership,
  sketch, bookkeeping, counters), never tensors, so each package loads
  the other's state and delta chains (``checkpoint/delta.py``).
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.embedding.embedding import (
    SGD,
    Adagrad,
    _Optimizer,
)
from distributed_tensorflow_tpu_torch.models.transformer import (
    resolve_device)

#: Row 0: shared cold row (sub-threshold ids). Never mapped to an id.
COLD_ROW = 0
RESERVED_ROWS = 1


class CountMinSketch:
    """Fixed-memory frequency estimator (conservative overcount), JAX's
    hashing: the same ids land in the same cells."""

    def __init__(self, width: int = 2048, depth: int = 4, seed: int = 0):
        if width <= 0 or depth <= 0:
            raise ValueError(f"sketch width/depth must be positive, got "
                             f"{width}x{depth}")
        self.width = int(width)
        self.depth = int(depth)
        self.seed = int(seed)
        rng = np.random.default_rng([seed, 0xC0FFEE])
        self._mul = (rng.integers(1, 2**63, size=depth, dtype=np.uint64)
                     | np.uint64(1))
        self._add = rng.integers(0, 2**63, size=depth, dtype=np.uint64)
        self.counts = np.zeros((depth, self.width), dtype=np.uint32)
        self._dirty: set[int] = set()

    def _slots(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.uint64)
        out = np.empty((self.depth, len(ids)), dtype=np.int64)
        for d in range(self.depth):
            h = ids * self._mul[d] + self._add[d]       # mod 2^64
            out[d] = ((h >> np.uint64(31))
                      % np.uint64(self.width)).astype(np.int64)
        return out

    def add(self, ids: np.ndarray):
        slots = self._slots(ids)
        for d in range(self.depth):
            np.add.at(self.counts[d], slots[d], 1)
        flat = (np.arange(self.depth, dtype=np.int64)[:, None]
                * self.width + slots).ravel()
        self._dirty.update(np.unique(flat).tolist())

    def delta(self) -> "tuple[np.ndarray, np.ndarray]":
        """(flat indices, values) of every cell touched since
        :meth:`mark_clean`, sorted."""
        idx = np.asarray(sorted(self._dirty), dtype=np.int64)
        return idx, self.counts.reshape(-1)[idx].copy()

    def apply_delta(self, idx: np.ndarray, vals: np.ndarray):
        flat = self.counts.reshape(-1)
        flat[np.asarray(idx, dtype=np.int64)] = np.asarray(vals,
                                                           dtype=np.uint32)

    def mark_clean(self):
        self._dirty.clear()

    def estimate(self, ids: np.ndarray) -> np.ndarray:
        slots = self._slots(np.atleast_1d(ids))
        ests = np.stack([self.counts[d][slots[d]]
                         for d in range(self.depth)])
        return ests.min(axis=0).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class DynamicTableConfig:
    """One dynamic table, validated at construction (JAX's errors)."""

    dim: int
    initial_capacity: int = 256
    max_capacity: int | None = None          # default: 4x initial
    admission_threshold: int = 2
    ttl_steps: int = 512
    growth_load_factor: float = 0.85
    optimizer: _Optimizer | None = None      # default Adagrad(0.05)
    name: str = "table"
    seed: int = 0
    sketch_width: int = 2048
    sketch_depth: int = 4

    def __post_init__(self):
        if self.dim <= 0:
            raise ValueError(f"table {self.name!r}: dim must be "
                             f"positive, got {self.dim}")
        if self.initial_capacity <= RESERVED_ROWS:
            raise ValueError(
                f"table {self.name!r}: initial_capacity must exceed "
                f"the {RESERVED_ROWS} reserved rows, got "
                f"{self.initial_capacity}")
        cap = self.max_capacity
        if cap is not None and cap < self.initial_capacity:
            raise ValueError(
                f"table {self.name!r}: max_capacity {cap} < "
                f"initial_capacity {self.initial_capacity}")
        if self.admission_threshold < 1:
            raise ValueError(
                f"table {self.name!r}: admission_threshold must be "
                f">= 1, got {self.admission_threshold}")
        if self.ttl_steps < 1:
            raise ValueError(f"table {self.name!r}: ttl_steps must be "
                             f">= 1, got {self.ttl_steps}")
        if not 0.0 < self.growth_load_factor <= 1.0:
            raise ValueError(
                f"table {self.name!r}: growth_load_factor must be in "
                f"(0, 1], got {self.growth_load_factor}")

    @property
    def capacity_limit(self) -> int:
        return (self.max_capacity if self.max_capacity is not None
                else 4 * self.initial_capacity)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class DynamicTable:
    """Bounded-memory id→row embedding table (module docstring): host
    membership decides which row an id resolves to, the rows and slots
    on ``device`` train only the rows a batch touched."""

    def __init__(self, cfg: DynamicTableConfig, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.capacity = cfg.initial_capacity
        self._opt = cfg.optimizer or Adagrad(0.05)
        self.rows = self._init_rows(0, self.capacity)
        self.slots = self._opt.init_slots(self.rows)
        self.sketch = CountMinSketch(cfg.sketch_width, cfg.sketch_depth,
                                     seed=cfg.seed)
        self.id_to_row: dict[int, int] = {}
        self.row_id = np.full(self.capacity, -1, dtype=np.int64)
        self.row_freq = np.zeros(self.capacity, dtype=np.int64)
        self.row_last = np.zeros(self.capacity, dtype=np.int64)
        self._free = list(range(self.capacity - 1, RESERVED_ROWS - 1, -1))
        self.step = 0
        self.admissions = 0
        self.evictions = 0
        self.grows = 0
        self.declined = 0
        self._dirty: set[int] = set()
        self._clean_capacity = self.capacity

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=self.device)

    # -- init helpers -----------------------------------------------------
    def _init_rows(self, start: int, n: int) -> torch.Tensor:
        """Rows ``start..start+n-1``, seeded per row block (JAX's)."""
        rng = np.random.default_rng([self.cfg.seed, start, n])
        return self._tensor(rng.normal(
            0.0, 0.02, size=(n, self.cfg.dim)).astype(np.float32))

    @torch.no_grad()
    def _flush_reinits(self, pending: "list[tuple[int, int]]"):
        """Re-initialise the rows one translate admitted, and their
        slots (JAX's seeds)."""
        if not pending:
            return
        fresh = np.zeros((len(pending), self.cfg.dim), np.float32)
        for j, (row, adm) in enumerate(pending):
            fresh[j] = np.random.default_rng(
                [self.cfg.seed, 0xAD417, row, adm]).normal(
                0.0, 0.02, size=self.cfg.dim)
        idx = self._tensor(np.asarray([r for r, _ in pending], np.int64))
        fresh_t = self._tensor(fresh)
        self.rows[idx] = fresh_t
        for k, v in self._opt.init_slots(fresh_t).items():
            self.slots[k][idx] = v

    # -- membership -------------------------------------------------------
    @property
    def mapped(self) -> int:
        return len(self.id_to_row)

    @property
    def load_factor(self) -> float:
        return self.mapped / max(1, self.capacity - RESERVED_ROWS)

    def translate(self, ids: np.ndarray, *, train: bool = True) -> np.ndarray:
        """id → row for one batch; with ``train`` feeds the sketch,
        admits ids crossing the threshold (growing or evicting) and
        updates LFU/TTL bookkeeping. Unmapped ids resolve to COLD."""
        ids = np.asarray(ids, dtype=np.int64)
        if train:
            self.sketch.add(ids)
        uniq, counts = np.unique(ids, return_counts=True)
        row_of: dict[int, int] = {}
        ests = self.sketch.estimate(uniq) if train else None
        pending: list[tuple[int, int]] = []
        for j, uid in enumerate(uniq.tolist()):
            row = self.id_to_row.get(uid)
            if row is None and train \
                    and int(ests[j]) >= self.cfg.admission_threshold:
                row = self._admit(uid, int(ests[j]), pending)
            if row is None:
                row = COLD_ROW
            elif train:
                self.row_freq[row] += int(counts[j])
                self.row_last[row] = self.step
                self._dirty.add(row)
            row_of[uid] = row
        self._flush_reinits(pending)
        return np.asarray([row_of[int(i)] for i in ids], dtype=np.int32)

    def _admit(self, uid: int, est: int,
               pending: "list[tuple[int, int]]") -> int | None:
        if not self._free and self.load_factor \
                >= self.cfg.growth_load_factor:
            self._grow()
        if self._free:
            row = self._free.pop()
        else:
            row = self._evict_for(est)
            if row is None:
                self.declined += 1
                return None
        pending.append((row, self.admissions))
        self.id_to_row[uid] = row
        self.row_id[row] = uid
        self.row_freq[row] = est
        self.row_last[row] = self.step
        self.admissions += 1
        self._dirty.add(row)
        return row

    def _evict_for(self, candidate_est: int) -> int | None:
        mapped_rows = np.flatnonzero(self.row_id >= 0)
        if len(mapped_rows) == 0:
            return None
        expired = mapped_rows[
            self.row_last[mapped_rows] < self.step - self.cfg.ttl_steps]
        pool = expired if len(expired) else mapped_rows
        victim = int(pool[np.argmin(self.row_freq[pool])])
        if not len(expired) \
                and int(self.row_freq[victim]) >= candidate_est:
            return None          # LFU victim is hotter: decline, no thrash
        del self.id_to_row[int(self.row_id[victim])]
        self.row_id[victim] = -1
        self.row_freq[victim] = 0
        self.evictions += 1
        self._dirty.add(victim)
        return victim

    def _grow(self):
        new_cap = self.capacity * 2
        if new_cap > self.cfg.capacity_limit:
            return
        add = new_cap - self.capacity
        self.rows = torch.cat([self.rows, self._init_rows(self.capacity,
                                                          add)])
        grown = self._opt.init_slots(torch.zeros(
            (add, self.cfg.dim), dtype=torch.float32, device=self.device))
        self.slots = {k: torch.cat([v, grown[k]])
                      for k, v in self.slots.items()}
        self.row_id = np.concatenate(
            [self.row_id, np.full(add, -1, dtype=np.int64)])
        self.row_freq = np.concatenate(
            [self.row_freq, np.zeros(add, dtype=np.int64)])
        self.row_last = np.concatenate(
            [self.row_last, np.zeros(add, dtype=np.int64)])
        self._free = list(range(new_cap - 1, self.capacity - 1, -1)) \
            + self._free
        self.capacity = new_cap
        self.grows += 1

    # -- device math ------------------------------------------------------
    def gather(self, row_idx) -> torch.Tensor:
        return self.rows[self._tensor(np.asarray(row_idx, np.int64))]

    @torch.no_grad()
    def apply_row_grads(self, row_idx, grads, *, pad_to: int | None = None):
        """Row-sparse optimizer update: ``grads[i]`` is the per-example
        gradient of ``row_idx[i]``; duplicates are summed, the unique
        rows updated through the table's optimizer. ``pad_to`` bounds
        the unique rows (``ValueError`` above it), as JAX's buffer
        width."""
        row_idx = np.asarray(row_idx)
        uniq, inv = np.unique(row_idx, return_inverse=True)
        agg = np.zeros((len(uniq), self.cfg.dim), dtype=np.float32)
        np.add.at(agg, inv, np.asarray(
            _host(grads) if isinstance(grads, torch.Tensor) else grads,
            dtype=np.float32))
        width = pad_to or len(uniq)
        if len(uniq) > width:
            raise ValueError(f"pad_to={width} < {len(uniq)} unique rows")
        idx = self._tensor(uniq.astype(np.int64))
        rows = self.rows[idx]
        row_slots = {k: v[idx] for k, v in self.slots.items()}
        new_rows, new_slots = self._opt.apply(
            rows, self._tensor(agg), row_slots,
            torch.tensor(self.step, dtype=torch.int32, device=self.device))
        self.rows[idx] = new_rows
        for k in self.slots:
            self.slots[k][idx] = new_slots[k]
        self._dirty.update(int(r) for r in uniq)
        self.step += 1

    def end_step(self):
        """Advance the TTL clock without an update (eval batches)."""
        self.step += 1

    # -- checkpoint state (fixed leaf names) ------------------------------
    def state_dict(self) -> dict:
        """``rows`` and the packed ``aux`` (JAX's layout: numpy and
        Python values only)."""
        aux = {
            "slots": {k: _host(v) for k, v in self.slots.items()},
            "capacity": self.capacity,
            "id_to_row": self.id_to_row,
            "row_id": self.row_id,
            "row_freq": self.row_freq,
            "row_last": self.row_last,
            "free": list(self._free),
            "sketch_counts": self.sketch.counts,
            "step": self.step,
            "counters": (self.admissions, self.evictions, self.grows,
                         self.declined),
        }
        return {"rows": _host(self.rows),
                "aux": np.frombuffer(pickle.dumps(aux, protocol=4),
                                     dtype=np.uint8).copy()}

    def load_state_dict(self, state: dict):
        rows = np.asarray(state["rows"])
        aux = pickle.loads(np.asarray(state["aux"], dtype=np.uint8).tobytes())
        self.capacity = int(aux["capacity"])
        if rows.shape != (self.capacity, self.cfg.dim):
            raise ValueError(
                f"table {self.cfg.name!r}: restored rows "
                f"{rows.shape} != (capacity {self.capacity}, dim "
                f"{self.cfg.dim})")
        self.rows = self._tensor(rows)
        self.slots = {k: self._tensor(v) for k, v in aux["slots"].items()}
        self.id_to_row = {int(k): int(v) for k, v in aux["id_to_row"].items()}
        self.row_id = np.asarray(aux["row_id"], dtype=np.int64)
        self.row_freq = np.asarray(aux["row_freq"], dtype=np.int64)
        self.row_last = np.asarray(aux["row_last"], dtype=np.int64)
        self._free = [int(x) for x in aux["free"]]
        self.sketch.counts = np.asarray(aux["sketch_counts"],
                                        dtype=np.uint32)
        self.step = int(aux["step"])
        (self.admissions, self.evictions, self.grows,
         self.declined) = (int(x) for x in aux["counters"])
        self.mark_clean()

    # -- delta snapshots --------------------------------------------------
    @property
    def dirty_rows(self) -> int:
        return len(self._dirty)

    def mark_clean(self):
        """What is in the table now is what the last published snapshot
        holds."""
        self._dirty.clear()
        self.sketch.mark_clean()
        self._clean_capacity = self.capacity

    def state_delta(self) -> "dict | None":
        """Row-sparse state since :meth:`mark_clean` (JAX's record);
        None when the table grew since (only a full is honest then)."""
        if self.capacity != self._clean_capacity:
            return None
        idx = np.asarray(sorted(self._dirty), dtype=np.int64)
        sk_idx, sk_vals = self.sketch.delta()
        rows = _host(self.rows)
        return {
            "capacity": self.capacity,
            "idx": idx,
            "rows": rows[idx].copy(),
            "slots": {k: _host(v)[idx].copy()
                      for k, v in self.slots.items()},
            "row_id": self.row_id[idx].copy(),
            "row_freq": self.row_freq[idx].copy(),
            "row_last": self.row_last[idx].copy(),
            "free_len": len(self._free),
            "sketch_idx": sk_idx,
            "sketch_vals": sk_vals,
            "step": self.step,
            "counters": (self.admissions, self.evictions, self.grows,
                         self.declined),
        }

    @torch.no_grad()
    def apply_state_delta(self, delta: dict):
        """Scatter a :meth:`state_delta` onto this table (which holds the
        delta's parent state)."""
        if int(delta["capacity"]) != self.capacity:
            raise ValueError(
                f"table {self.cfg.name!r}: delta capacity "
                f"{delta['capacity']} != table capacity "
                f"{self.capacity} (chain broken — restore the full "
                f"base first)")
        idx = np.asarray(delta["idx"], dtype=np.int64)
        if len(idx):
            t_idx = self._tensor(idx)
            self.rows[t_idx] = self._tensor(delta["rows"])
            for k, v in delta["slots"].items():
                self.slots[k][t_idx] = self._tensor(v)
            self.row_id[idx] = np.asarray(delta["row_id"], dtype=np.int64)
            self.row_freq[idx] = np.asarray(delta["row_freq"],
                                            dtype=np.int64)
            self.row_last[idx] = np.asarray(delta["row_last"],
                                            dtype=np.int64)
        self._free = [int(x) for x in self._free[:int(delta["free_len"])]]
        self.sketch.apply_delta(delta["sketch_idx"], delta["sketch_vals"])
        mapped = np.flatnonzero(self.row_id >= 0)
        self.id_to_row = {int(self.row_id[r]): int(r) for r in mapped}
        self.step = int(delta["step"])
        (self.admissions, self.evictions, self.grows,
         self.declined) = (int(x) for x in delta["counters"])
        self.mark_clean()


class StaticHashTable:
    """The fixed hash-bucketed baseline (JAX's): no membership,
    admission, eviction or growth; :class:`DynamicTable`'s interface."""

    _MIX = np.uint64(0x9E3779B97F4A7C15)

    def __init__(self, dim: int, capacity: int, *,
                 optimizer: _Optimizer | None = None, seed: int = 0,
                 name: str = "static", device="cuda"):
        if dim <= 0 or capacity <= 0:
            raise ValueError(f"table {name!r}: dim and capacity must "
                             f"be positive, got {dim}/{capacity}")
        self.cfg = DynamicTableConfig(
            dim=dim, initial_capacity=max(capacity, RESERVED_ROWS + 1),
            name=name, seed=seed, optimizer=optimizer)
        self.device = resolve_device(device)
        self.capacity = capacity
        self._opt = optimizer or SGD(0.05)
        rng = np.random.default_rng([seed, capacity])
        self.rows = self._tensor(rng.normal(
            0.0, 0.02, size=(capacity, dim)).astype(np.float32))
        self.slots = self._opt.init_slots(self.rows)
        self.step = 0
        self.admissions = self.evictions = self.grows = 0
        self.mapped = capacity
        self._dirty: set[int] = set()

    _tensor = DynamicTable._tensor

    def translate(self, ids: np.ndarray, *, train: bool = True
                  ) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.uint64)
        return ((ids * self._MIX) >> np.uint64(33)).astype(np.int64) \
            % self.capacity

    gather = DynamicTable.gather
    apply_row_grads = DynamicTable.apply_row_grads
    end_step = DynamicTable.end_step

    def state_dict(self) -> dict:
        aux = {"slots": {k: _host(v) for k, v in self.slots.items()},
               "capacity": self.capacity, "step": self.step}
        return {"rows": _host(self.rows),
                "aux": np.frombuffer(pickle.dumps(aux, protocol=4),
                                     dtype=np.uint8).copy()}

    def load_state_dict(self, state: dict):
        aux = pickle.loads(np.asarray(state["aux"], dtype=np.uint8).tobytes())
        self.capacity = int(aux["capacity"])
        self.rows = self._tensor(state["rows"])
        self.slots = {k: self._tensor(v) for k, v in aux["slots"].items()}
        self.step = int(aux["step"])
