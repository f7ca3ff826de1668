"""Sharded embedding tables with decoupled per-table optimizers — port of
``distributed_tensorflow_tpu/embedding/embedding.py``.

- Optimizers :class:`SGD`, :class:`Adagrad`, :class:`Adam`, :class:`FTRL`
  with their slots (JAX ``:47-137``; the math and its rounding order
  are JAX's: the embedding Adagrad takes ``rsqrt(acc + 1e-12)``, Adam's
  ``t = step + 1`` is f32).
- :class:`TableConfig` / :class:`FeatureConfig` with JAX's validation
  errors. ``initializer`` is a torch callable ``(shape, generator) ->
  tensor``; the default is a normal of σ 0.02 cut at ±2σ (JAX's
  ``truncated_normal(0.02)``; the numbers differ for the same seed).
- Functional core: :func:`create_state` / :func:`lookup` /
  :func:`apply_gradients`, and :func:`state_from_jax`.
- :class:`TPUEmbedding` — the stateful object API.

A ``feature_config`` is a nest of dicts, lists and tuples with
:class:`FeatureConfig` leaves, flattened in JAX's order (dict keys
sorted). On a mesh with ``shard_axis`` every table and slot is cut by
rows: its rows are rounded up to a multiple of the axis' size
(:func:`~distributed_tensorflow_tpu_torch.parallel.tensor_parallel.
padded_rows`, JAX's ``_padded_vocab``) and this rank holds its
contiguous block, so the state's tables are ``(rows/n, D)``. A lookup
there takes the axis' :class:`~distributed_tensorflow_tpu_torch.parallel.
tensor_parallel.TensorParallel` handle: each rank gathers the ids it
owns, zeroes the rest, and one all-reduce sums the shards
(:func:`~distributed_tensorflow_tpu_torch.parallel.tensor_parallel.
vocab_parallel_embed`, what GSPMD derives for JAX's gather).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    TensorParallel, padded_rows, vocab_parallel_embed)


# ---------------------------------------------------------------------------
# Optimizers (JAX ``:47-137``)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Optimizer:
    learning_rate: float = 0.01

    def slot_names(self) -> tuple:
        return ()

    def init_slots(self, table: torch.Tensor) -> dict:
        return {}

    def apply(self, table, grad, slots, step):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SGD(_Optimizer):
    def apply(self, table, grad, slots, step):
        return table - self.learning_rate * grad, {}


@dataclasses.dataclass(frozen=True)
class Adagrad(_Optimizer):
    """``acc += g²``; ``table −= lr·g·rsqrt(acc + 1e-12)`` (not optax's
    eps)."""
    initial_accumulator_value: float = 0.1

    def slot_names(self) -> tuple:
        return ("accumulator",)

    def init_slots(self, table) -> dict:
        return {"accumulator": torch.full_like(
            table, self.initial_accumulator_value)}

    def apply(self, table, grad, slots, step):
        acc = slots["accumulator"] + grad.square()
        new = table - self.learning_rate * grad * torch.rsqrt(acc + 1e-12)
        return new, {"accumulator": acc}


@dataclasses.dataclass(frozen=True)
class Adam(_Optimizer):
    """Bias-corrected at ``t = step + 1`` in f32."""
    beta_1: float = 0.9
    beta_2: float = 0.999
    epsilon: float = 1e-7

    def slot_names(self) -> tuple:
        return ("momenta", "velocities")

    def init_slots(self, table) -> dict:
        return {"momenta": torch.zeros_like(table),
                "velocities": torch.zeros_like(table)}

    def apply(self, table, grad, slots, step):
        t = step.to(torch.float32) + 1.0
        m = self.beta_1 * slots["momenta"] + (1 - self.beta_1) * grad
        v = self.beta_2 * slots["velocities"] + \
            (1 - self.beta_2) * grad.square()
        f32 = dict(dtype=torch.float32, device=table.device)
        m_hat = m / (1 - torch.tensor(self.beta_1, **f32) ** t)
        v_hat = v / (1 - torch.tensor(self.beta_2, **f32) ** t)
        new = table - self.learning_rate * m_hat / \
            (torch.sqrt(v_hat) + self.epsilon)
        return new, {"momenta": m, "velocities": v}


@dataclasses.dataclass(frozen=True)
class FTRL(_Optimizer):
    learning_rate_power: float = -0.5
    initial_accumulator_value: float = 0.1
    l1_regularization_strength: float = 0.0
    l2_regularization_strength: float = 0.0

    def slot_names(self) -> tuple:
        return ("accumulators", "linears")

    def init_slots(self, table) -> dict:
        return {"accumulators": torch.full_like(
            table, self.initial_accumulator_value),
            "linears": torch.zeros_like(table)}

    def apply(self, table, grad, slots, step):
        acc, lin = slots["accumulators"], slots["linears"]
        acc_new = acc + grad.square()
        p = -self.learning_rate_power
        sigma = (acc_new ** p - acc ** p) / self.learning_rate
        lin_new = lin + grad - sigma * table
        quad = acc_new ** p / self.learning_rate \
            + 2 * self.l2_regularization_strength
        l1 = self.l1_regularization_strength
        pre = torch.clamp(lin_new, -l1, l1) - lin_new
        new = torch.where(lin_new.abs() > l1, pre / quad,
                          torch.zeros_like(table))
        return new, {"accumulators": acc_new, "linears": lin_new}


# ---------------------------------------------------------------------------
# Configs (JAX ``:143-198``)
# ---------------------------------------------------------------------------

def truncated_normal(stddev: float = 0.02) -> Callable:
    """``(shape, generator) -> tensor``: ``stddev`` times a standard
    normal cut at ±2 (JAX's ``truncated_normal(stddev)``)."""
    def init(shape, generator=None, device=None):
        t = torch.empty(shape, device=device)
        return torch.nn.init.trunc_normal_(t, 0.0, stddev, -2 * stddev,
                                           2 * stddev, generator=generator)
    return init


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """One logical embedding table.

    ``combiner`` reduces multivalent features: "sum" | "mean" | "sqrtn".
    ``optimizer`` overrides the TPUEmbedding-level optimizer per table.
    """
    vocabulary_size: int
    dim: int
    initializer: Callable | None = None
    optimizer: _Optimizer | None = None
    combiner: str = "mean"
    name: str | None = None

    def __post_init__(self):
        if not isinstance(self.vocabulary_size, (int, np.integer)) \
                or self.vocabulary_size <= 0:
            raise ValueError(
                f"table {self.name or '<unnamed>'}: vocabulary_size "
                f"must be a positive int, got {self.vocabulary_size!r}")
        if not isinstance(self.dim, (int, np.integer)) or self.dim <= 0:
            raise ValueError(
                f"table {self.name or '<unnamed>'}: dim must be a "
                f"positive int, got {self.dim!r}")
        if self.combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError(f"combiner {self.combiner!r} not in "
                             f"sum/mean/sqrtn")


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """One input feature looked up in a (possibly shared) table."""
    table: TableConfig
    max_sequence_length: int = 0       # 0 = combiner-reduced output
    name: str | None = None

    def __post_init__(self):
        if not isinstance(self.table, TableConfig):
            raise ValueError(
                f"feature {self.name or '<unnamed>'}: table must be a "
                f"TableConfig, got {type(self.table).__name__}")
        if not isinstance(self.max_sequence_length, (int, np.integer)) \
                or self.max_sequence_length < 0:
            raise ValueError(
                f"feature {self.name or '<unnamed>'}: "
                f"max_sequence_length must be a non-negative int, got "
                f"{self.max_sequence_length!r}")


# ---------------------------------------------------------------------------
# Nests: JAX's pytree order (dict keys sorted; None holds no leaf)
# ---------------------------------------------------------------------------

def _is_feature(x) -> bool:
    return isinstance(x, FeatureConfig)


def _flatten(tree, is_leaf=_is_feature) -> list:
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flatten(t, is_leaf)]
    return [] if tree is None else [tree]


def _unflatten(tree, leaves, is_leaf=_is_feature):
    """``leaves`` (an iterator) in ``tree``'s structure."""
    if is_leaf(tree):
        return next(leaves)
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves, is_leaf) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, leaves, is_leaf) for t in tree)
    return tree


def _table_name(table: TableConfig, idx: int) -> str:
    return table.name or f"table_{idx}"


def _unique_tables(feature_config) -> list[TableConfig]:
    """Tables in first-seen order; shared tables appear once."""
    seen: list[TableConfig] = []
    for fc in _flatten(feature_config):
        # identity, not equality: two distinct tables may share a config
        if not any(t is fc.table for t in seen):
            seen.append(fc.table)
    return seen


# ---------------------------------------------------------------------------
# Functional core (JAX ``:205-398``)
# ---------------------------------------------------------------------------

def _shard(mesh, shard_axis: str) -> TensorParallel | None:
    return TensorParallel.from_mesh(mesh, shard_axis)


def _local_block(t: torch.Tensor, shard: TensorParallel | None):
    """This rank's contiguous block of rows of a padded table."""
    if shard is None:
        return t
    n = t.shape[0] // shard.size
    return t[shard.rank * n:(shard.rank + 1) * n].clone()


def create_state(feature_config, optimizer: _Optimizer | None = None, *,
                 mesh=None, shard_axis: str = "tp",
                 generator: torch.Generator | None = None,
                 device="cuda") -> dict:
    """``{"tables", "slots", "step"}``: each table ``(vocab, dim)`` f32
    from its initializer in :func:`_unique_tables` order (one
    ``generator`` drawn in turn), its optimizer's slots, ``step`` an int32
    0. On a ``mesh`` with ``shard_axis`` the rows are padded to a
    multiple of the axis' size (the pad rows drawn like the others, as
    JAX's init draws its padded shape) and this rank keeps its block;
    every rank must pass the same seed."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        resolve_device)
    device = resolve_device(device)
    shard = _shard(mesh, shard_axis)
    tables: dict[str, torch.Tensor] = {}
    slots: dict[str, dict] = {}
    for i, tc in enumerate(_unique_tables(feature_config)):
        name = _table_name(tc, i)
        if name in tables:
            raise ValueError(f"duplicate table name {name!r}")
        init = tc.initializer or truncated_normal(0.02)
        rows = (tc.vocabulary_size if shard is None
                else padded_rows(tc.vocabulary_size, shard.size))
        tab = _local_block(init((rows, tc.dim), generator, device), shard)
        tables[name] = tab
        opt = tc.optimizer or optimizer or SGD()
        slots[name] = opt.init_slots(tab)
    return {"tables": tables, "slots": slots,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _pad_rows(t: torch.Tensor, shard, fill) -> torch.Tensor:
    """``t`` with rows appended up to a multiple of the shard count:
    zeros for a table (``fill`` None), copies of the last row for a
    slot. No id looks the pad rows up and no gradient reaches them."""
    if shard is None or t.shape[0] % shard.size == 0:
        return t
    n = padded_rows(t.shape[0], shard.size) - t.shape[0]
    pad = (t.new_zeros((n,) + tuple(t.shape[1:])) if fill is None
           else t[-1:].expand((n,) + tuple(t.shape[1:])))
    return torch.cat([t, pad])


def state_from_jax(state, *, mesh=None, shard_axis: str = "tp",
                   device="cuda") -> dict:
    """The port's state from JAX's ``create_state`` output (nested dicts
    of arrays): on a ``mesh`` with ``shard_axis`` this rank's block of
    every table and slot. JAX pads a state made on such a mesh itself;
    an unpadded one (made without the mesh) is padded here first."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        resolve_device)
    device = resolve_device(device)
    shard = _shard(mesh, shard_axis)

    def to_t(a, fill=None):
        t = torch.from_numpy(np.array(a, copy=True)).to(device)
        return _local_block(_pad_rows(t, shard, fill), shard)
    return {"tables": {k: to_t(v) for k, v in state["tables"].items()},
            "slots": {k: {s: to_t(a, "edge") for s, a in v.items()}
                      for k, v in state["slots"].items()},
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def _combine(rows, ids, weights, combiner: str):
    """Reduce multivalent lookups (B, L, D) -> (B, D) with a validity
    mask (ids < 0 are padding) and optional per-id weights."""
    valid = (ids >= 0).to(rows.dtype)
    w = valid if weights is None else weights.to(rows.dtype) * valid
    out = torch.einsum("bld,bl->bd", rows, w)
    if combiner == "sum":
        return out
    denom = torch.sum(w if combiner == "mean" else w.square(), dim=-1)
    if combiner == "sqrtn":
        denom = torch.sqrt(denom)
    return out / torch.clamp(denom, min=1e-12)[:, None]


def _gather(table, ids, shard: TensorParallel | None):
    """``full_table[ids]``: a local gather, or the vocab-parallel one."""
    if shard is None:
        return table[ids]
    return vocab_parallel_embed(table, ids, shard)


def _dedup_gather(table, ids, unique_size: int | None = None, shard=None):
    """Gather with duplicate-id elimination, JAX's ``jnp.unique(size=,
    fill_value=0, return_inverse=True)`` → one gather → inverse expand.
    The unique buffer holds the ``size`` smallest distinct ids (padded
    with 0); an id past the cap has an inverse index past the buffer,
    which JAX's gather clamps to the last slot, so it reads the row of
    the largest kept id (ids ``[5, 3, 5, 9, 7, 3, 1]`` with cap 3 read
    rows ``[5, 3, 5, 5, 5, 3, 1]``), while the gather's transpose, a
    scatter, drops those indices: such a read sends no gradient to the
    table. The port reproduces both."""
    shape = ids.shape
    flat = ids.reshape(-1)
    size = min(unique_size or flat.shape[0], flat.shape[0])
    vals, inv = torch.unique(flat, sorted=True, return_inverse=True)
    if vals.shape[0] >= size:
        vals = vals[:size]
    else:
        vals = torch.cat([vals, vals.new_zeros(size - vals.shape[0])])
    rows = _gather(table, vals, shard)
    out = rows[inv.clamp(max=size - 1)]
    past = (inv >= size)[:, None]
    if bool(past.any()):
        out = torch.where(past, out.detach(), out)
    return out.reshape(*shape, table.shape[-1])


def lookup(tables: Mapping[str, torch.Tensor], feature_config, features,
           weights=None, *, dedup: bool = False,
           unique_size: int | None = None,
           shard: TensorParallel | None = None):
    """Embedding activations for ``features`` (structure-matching
    ``feature_config``); differentiable w.r.t. ``tables``.

    - 1-D int ids (B,): one row per example -> (B, D).
    - 2-D ids (B, L): multivalent; ids < 0 are padding; reduced by the
      table's combiner -> (B, D) — unless the feature has
      ``max_sequence_length > 0``, which returns (B, L, D) with padded
      rows zeroed.
    - ``dedup``: gather unique ids once and expand (:func:`_dedup_gather`,
      ``unique_size`` its cap).
    - ``shard``: the tables are this rank's row blocks on that mesh axis
      (:func:`create_state` on a mesh); the gathers are vocab-parallel.
    """
    flat_fc = _flatten(feature_config)
    flat_feats = _flatten(features, lambda x: hasattr(x, "shape"))
    flat_w = (_flatten(weights, lambda x: x is None or hasattr(x, "shape"))
              if weights is not None else [None] * len(flat_fc))
    if len(flat_fc) != len(flat_feats):
        raise ValueError(
            f"{len(flat_feats)} features for {len(flat_fc)} FeatureConfigs")
    if len(flat_w) != len(flat_fc):
        raise ValueError(
            f"weights must mirror the features structure: got "
            f"{len(flat_w)} weight leaves for {len(flat_fc)} features")
    uniq = _unique_tables(feature_config)
    names = {id(tc): _table_name(tc, i) for i, tc in enumerate(uniq)}

    outs = []
    for fc, ids, w in zip(flat_fc, flat_feats, flat_w):
        table = tables[names[id(fc.table)]]
        ids = torch.as_tensor(ids).to(table.device).long()
        safe = torch.clamp(ids, min=0)
        if dedup:
            rows = _dedup_gather(table, safe, unique_size, shard)
        else:
            rows = _gather(table, safe, shard)
        if ids.ndim == 1:
            if w is not None:
                raise ValueError(
                    f"feature {fc.name!r}: weights are only valid for "
                    f"combiner-reduced (2-D) features, not dense 1-D ids "
                    f"(≙ the reference's enqueue validation)")
            outs.append(rows)
        elif fc.max_sequence_length > 0:
            if w is not None:
                raise ValueError(
                    f"feature {fc.name!r}: weights are not supported for "
                    f"sequence features (max_sequence_length > 0)")
            mask = (ids >= 0).to(rows.dtype)[..., None]
            outs.append(rows * mask)
        else:
            if w is not None:
                w = torch.as_tensor(w).to(table.device)
            outs.append(_combine(rows, ids, w, fc.table.combiner))
    return _unflatten(feature_config, iter(outs))


def apply_gradients(state: dict, grads: Mapping[str, torch.Tensor],
                    feature_config, optimizer: _Optimizer | None = None
                    ) -> dict:
    """Pure per-table update: ``grads`` maps table name -> dense gradient
    (``.grad`` of the tables after a backward through :func:`lookup`).
    A table absent from ``grads`` (or mapped to None) keeps its weights
    and slots bit for bit; the step counter still advances (JAX's
    no-op contract)."""
    uniq = _unique_tables(feature_config)
    tables, slots = dict(state["tables"]), dict(state["slots"])
    for i, tc in enumerate(uniq):
        name = _table_name(tc, i)
        if name not in grads or grads[name] is None:
            continue
        opt = tc.optimizer or optimizer or SGD()
        with torch.no_grad():
            new_table, new_slots = opt.apply(
                tables[name], grads[name], slots[name], state["step"])
        tables[name] = new_table
        slots[name] = new_slots
    return {"tables": tables, "slots": slots, "step": state["step"] + 1}


# ---------------------------------------------------------------------------
# Stateful wrapper (JAX ``:405-444``)
# ---------------------------------------------------------------------------

class TPUEmbedding:
    """The object API: ``emb = TPUEmbedding(feature_config,
    optimizer=Adagrad(0.1), mesh=mesh)``; ``emb(features)`` looks up
    (structure matching ``feature_config``); ``emb.apply_gradients(
    table_grads)`` updates. The instance owns ``{tables, slots, step}``;
    ``state``/``load_state`` expose them."""

    def __init__(self, feature_config, optimizer: _Optimizer | None = None,
                 *, mesh=None, shard_axis: str = "tp",
                 generator: torch.Generator | None = None, device="cuda"):
        self.feature_config = feature_config
        self.optimizer = optimizer
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.shard = _shard(mesh, shard_axis)
        self._state = create_state(feature_config, optimizer, mesh=mesh,
                                   shard_axis=shard_axis,
                                   generator=generator, device=device)

    @property
    def state(self) -> dict:
        return self._state

    def load_state(self, state: dict):
        self._state = state

    @property
    def embedding_tables(self) -> dict:
        """name -> table tensor (this rank's rows on a mesh)."""
        return self._state["tables"]

    def __call__(self, features, weights=None, *, dedup: bool = False):
        return lookup(self._state["tables"], self.feature_config, features,
                      weights, dedup=dedup, shard=self.shard)

    def lookup_fn(self):
        """The pure ``(tables, features, **kw) -> activations``."""
        fc, shard = self.feature_config, self.shard
        return lambda tables, features, **kw: lookup(
            tables, fc, features, shard=shard, **kw)

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]):
        self._state = apply_gradients(self._state, grads,
                                      self.feature_config, self.optimizer)
