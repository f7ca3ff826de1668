"""Wide&Deep / DLRM — port of ``distributed_tensorflow_tpu/models/
wide_deep.py`` (benchmark workload #4), without the coordinator-driven
asynchronous parameter-server driver (``train_dlrm_async_ps``,
``_ps_dataset``), which waits for the coordinator's port.

- :class:`WideDeepConfig` (``tiny``, ``dlrm_like``) and
  :data:`WIDE_DEEP_RULES`.
- :func:`_interact` — DLRM's pairwise dots over the ``triu_indices(k=1)``
  pairs in row-major order ("dot"), or concatenation ("concat").
- :class:`WideDeep` — the flax model's parameters under its names
  (``table_{i}`` normal(0.01), ``wide_{i}`` zeros, ``mlp_{j}`` /
  ``bias_{j}``, ``out``). With ``tp`` (a tensor-parallel handle) the
  tables and wide vectors are this rank's row blocks, their rows padded
  to a multiple of ``tp`` (:func:`~distributed_tensorflow_tpu_torch.
  parallel.tensor_parallel.padded_rows`), and the lookups are
  vocab-parallel: each rank gathers the ids it owns, zeroes the rest,
  and one all-reduce sums the shards.
- :class:`Adagrad` — ``optax.adagrad`` written out: accumulators from
  0.1, ``rsqrt(acc + 1e-7)`` and 0 where the sum is 0.
- :func:`make_train_step`, :func:`make_sharded_train_step` (tables
  row-sharded over ``tp``, the rest replicated, the batch over the data
  axes).
- The embedding-API path: :func:`build_feature_config`,
  :class:`WideDeepDense`, :func:`make_embedding_train_step`, and the pure
  parameter-server helpers :func:`ps_init_state`, :func:`ps_worker_grads`
  and :func:`ps_apply_grads`.
- :func:`synthetic_clicks` — JAX's numpy draw, bit for bit.
- :func:`params_from_jax` / :func:`flax_params` — flax trees in and out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_tpu_torch import embedding as emb_lib
from distributed_tensorflow_tpu_torch.models.layers import (
    Dense, flax_tree, lecun_normal_)
from distributed_tensorflow_tpu_torch.models.transformer import (
    resolve_device)
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    TensorParallel, padded_rows, vocab_parallel_embed)


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    vocab_sizes: tuple = (1000, 1000, 500, 100)   # one per categorical col
    embed_dim: int = 32
    num_dense_features: int = 13
    mlp_dims: tuple = (256, 128, 64)
    dtype: Any = torch.float32
    learning_rate: float = 1e-3
    # "dot" = DLRM pairwise feature interaction; "concat" = Wide&Deep
    interaction: str = "concat"

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_sizes=(64, 64, 32), embed_dim=8,
                        num_dense_features=4, mlp_dims=(32, 16))
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def dlrm_like(cls, **kw):
        defaults = dict(vocab_sizes=(int(1e5),) * 26, embed_dim=64,
                        num_dense_features=13, mlp_dims=(512, 256, 128),
                        interaction="dot")
        defaults.update(kw)
        return cls(**defaults)


#: logical axes: embedding rows over the model axis
WIDE_DEEP_RULES = (
    ("table_rows", "tp"),
    ("table_cols", None),
    ("hidden", None),
    ("features", None),
)


def _interact(cfg: WideDeepConfig, embs: Sequence, dense):
    """Feature interaction shared by both towers: DLRM pairwise dots
    ("dot", the ``triu_indices(T, k=1)`` pairs in row-major order) or
    plain concatenation ("concat")."""
    if cfg.interaction == "dot":
        stacked = torch.stack(list(embs), dim=1)        # (B, T, E)
        inter = torch.einsum("bte,bse->bts", stacked, stacked)
        iu = torch.triu_indices(len(embs), len(embs), offset=1,
                                device=stacked.device)
        feats = [inter[:, iu[0], iu[1]], dense.to(inter.dtype)]
    else:
        feats = list(embs) + [dense.to(embs[0].dtype)]
    return torch.cat(feats, dim=-1).to(cfg.dtype)


def _interact_width(cfg: WideDeepConfig) -> int:
    t = len(cfg.vocab_sizes)
    if cfg.interaction == "dot":
        return t * (t - 1) // 2 + cfg.num_dense_features
    return t * cfg.embed_dim + cfg.num_dense_features


def _dot(x, w):
    """``jnp.dot(x, w)``: both in their promoted dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _lookup(table, ids, tp: TensorParallel | None):
    """``full_table[ids]``; vocab-parallel over this rank's rows with
    ``tp``."""
    if tp is None:
        return table[ids]
    return vocab_parallel_embed(table, ids, tp)


class WideDeep(nn.Module):
    """``forward(dense (B, num_dense), categorical (B, n_tables)) ->
    logits (B,)`` f32. ``tp``: tables and wide vectors are this rank's
    row blocks (``(ceil(V/tp), E)`` and ``(ceil(V/tp),)``)."""

    def __init__(self, cfg: WideDeepConfig, *, device="cuda",
                 generator: torch.Generator | None = None,
                 tp: TensorParallel | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.tp = cfg, tp
        n = 1 if tp is None else tp.size
        for i, vocab in enumerate(cfg.vocab_sizes):
            rows = padded_rows(vocab, n) // n
            t = torch.empty(rows, cfg.embed_dim, device=device)
            self.register_parameter(f"table_{i}", nn.Parameter(
                t.normal_(0.0, 0.01, generator=generator)))
            self.register_parameter(f"wide_{i}", nn.Parameter(
                torch.zeros(rows, device=device)))
        width = _interact_width(cfg)
        for j, out in enumerate(cfg.mlp_dims):
            self.register_parameter(f"mlp_{j}", nn.Parameter(lecun_normal_(
                torch.empty(width, out, device=device), width, generator)))
            self.register_parameter(f"bias_{j}", nn.Parameter(
                torch.zeros(out, device=device)))
            width = out
        self.out = nn.Parameter(lecun_normal_(
            torch.empty(width, 1, device=device), width, generator))

    def forward(self, dense, categorical):
        cfg, tp = self.cfg, self.tp
        dt = cfg.dtype
        dev = self.out.device
        dense = torch.as_tensor(dense).to(dev)
        cat = torch.as_tensor(categorical).to(dev).long()
        embs, wide_logits = [], []
        for i in range(len(cfg.vocab_sizes)):
            embs.append(_lookup(getattr(self, f"table_{i}"), cat[:, i], tp))
            wide = getattr(self, f"wide_{i}")
            wide_logits.append(_lookup(wide[:, None], cat[:, i], tp)[:, 0])
        x = _interact(cfg, embs, dense)
        for j in range(len(cfg.mlp_dims)):
            # jnp.dot(x, w.astype(dtype)) + b: the f32 bias promotes
            x = torch.relu(_dot(x, getattr(self, f"mlp_{j}").to(dt))
                           + getattr(self, f"bias_{j}"))
        deep_logit = _dot(x, self.out.to(dt))[:, 0]
        return deep_logit.float() + sum(wide_logits)


def _table_param(name: str) -> bool:
    return name.startswith(("table_", "wide_"))


def params_from_jax(cfg: WideDeepConfig, tree, device="cuda",
                    tp: TensorParallel | None = None) -> WideDeep:
    """A :class:`WideDeep` holding the flax param tree ``tree`` (a flat
    dict of arrays, JAX's ``params``); with ``tp`` this rank's padded
    row blocks of the tables and wide vectors."""
    model = WideDeep(cfg, device=device, tp=tp)
    own = dict(model.named_parameters())
    if set(tree) != set(own):
        raise ValueError(f"flax params {sorted(tree)} are not "
                         f"{sorted(own)}")
    with torch.no_grad():
        for name, p in own.items():
            t = torch.from_numpy(np.array(tree[name], np.float32,
                                          copy=True))
            if tp is not None and _table_param(name):
                t = _row_block(t, tp)
            p.copy_(t.to(p.device))
    return model


def _row_block(t: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Rank ``tp.rank``'s block of ``t``'s rows, zero-padded to a
    multiple of ``tp.size``."""
    rows = padded_rows(t.shape[0], tp.size)
    if rows != t.shape[0]:
        t = torch.cat([t, t.new_zeros((rows - t.shape[0],)
                                      + tuple(t.shape[1:]))])
    n = rows // tp.size
    return t[tp.rank * n:(tp.rank + 1) * n].clone()


def flax_params(model: nn.Module, of=None) -> dict:
    """The model's parameters (or ``of(parameter)``) as flax's tree of
    numpy arrays: :class:`WideDeep`'s flat names, or
    :class:`WideDeepDense`'s ``{"mlp_j": {"kernel", "bias"}, "out"}``."""
    of = of or (lambda p: p)
    return flax_tree((n, of(p)) for n, p in model.named_parameters())


def gather_params(model: WideDeep, mesh) -> dict:
    """The full flax param tree on every rank of a tp-sharded model: each
    table's and wide vector's row blocks all-gathered over ``tp`` and cut
    back to ``vocab`` rows (JAX's shapes)."""
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        all_gather)
    cfg, tp = model.cfg, model.tp
    out = {}
    for name, p in model.named_parameters():
        t = p.detach()
        if tp is not None and _table_param(name):
            t = all_gather(t.contiguous(), mesh, "tp")
            t = t[:cfg.vocab_sizes[int(name.split("_")[1])]]
        out[name] = t.float().cpu().numpy().copy()
    return out


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr)`` (``scale_by_rss`` then ``-lr``), in place:

        s' = g² + s   (s from 0.1)
        p' = p + (−lr)·(where(s' > 0, rsqrt(s' + 1e-7), 0)·g)

    ``torch.optim.Adagrad`` starts its sum at 0, puts eps outside the
    root and has no zero guard. Plain tensor ops."""

    def __init__(self, params, *, lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      initial=initial_accumulator_value))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if "sum_of_squares" not in st:
                    st["sum_of_squares"] = torch.full_like(
                        p, group["initial"])
                s = p.grad.square() + st["sum_of_squares"]
                inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                                  torch.zeros_like(s))
                p.add_((inv * p.grad) * -group["lr"])
                st["sum_of_squares"] = s


def make_optimizer(cfg: WideDeepConfig, params) -> Adagrad:
    return Adagrad(params, lr=cfg.learning_rate)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``: ``−y·log σ(x) −
    (1−y)·log σ(−x)``, per example."""
    y = labels.to(logits.dtype)
    return (-y * nn.functional.logsigmoid(logits)
            - (1.0 - y) * nn.functional.logsigmoid(-logits))


def _batch(batch: dict, device, rows=slice(None)) -> dict:
    return {k: torch.as_tensor(v)[rows].to(device) for k, v in batch.items()}


def make_train_step(cfg: WideDeepConfig, model: WideDeep, tx):
    """``train_step(state, batch) -> (state, {"loss"})`` with ``state =
    {"model", "optimizer", "step"}`` and ``batch = {"dense",
    "categorical", "label"}``; the model updated in place."""
    device = model.out.device

    def train_step(state, batch):
        b = _batch(batch, device)
        tx.zero_grad(set_to_none=True)
        loss = sigmoid_bce(model(b["dense"], b["categorical"]),
                           b["label"]).mean()
        loss.backward()
        tx.step()
        return ({**state, "step": state["step"] + 1},
                {"loss": loss.detach()})

    return train_step


def _data_mean(mesh):
    """``(mean, mean_loss)``: ``mean(tensors)`` the list meaned over
    ``mesh``'s data axes in buckets (the gradients after the backward),
    ``mean_loss`` a scalar's; both the identity without a mesh or data
    axes."""
    from distributed_tensorflow_tpu_torch.cluster.topology import data_axes
    from distributed_tensorflow_tpu_torch.parallel.collectives import (
        GradientBucketer, ReduceOp, all_reduce)
    axes = data_axes(mesh) if mesh is not None else ()
    if not axes:
        return list, lambda loss: loss
    bucketer = GradientBucketer(mesh, axes)
    return (lambda tensors: bucketer.all_reduce(tensors, ReduceOp.MEAN),
            lambda loss: all_reduce(loss, mesh, axes, ReduceOp.MEAN))


def make_sharded_train_step(cfg: WideDeepConfig, mesh, global_batch: int,
                            seed: int = 0, *, params=None):
    """Tables and wide vectors row-sharded over ``tp`` (padded where
    ``tp`` does not divide a vocabulary), the dense tower replicated,
    the batch over the data axes (JAX ``:164-230``). Returns ``(state,
    step)``: ``state = {"model", "optimizer", "step"}``; ``step(state,
    batch)`` takes every rank's copy of the global batch, trains on this
    rank's rows and returns the loss meaned over the data axes. Every
    gradient is meaned over the data axes after the backward; the
    optimizer is elementwise, so each rank updates its shards.
    ``params`` (the flax tree) seeds every rank; without it rank 0
    initialises from ``seed`` and broadcasts the full parameters.
    :func:`gather_params` reads the full tree back."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.models.transformer import (
        _data_rows, _mesh_device)
    device = _mesh_device(mesh)
    tp = TensorParallel.from_mesh(mesh)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        full = WideDeep(cfg, device=device, generator=gen)
        with torch.no_grad():
            for p in full.parameters():
                dist.broadcast(p, src=0)
        params = {n: p.detach().cpu().numpy()
                  for n, p in full.named_parameters()}
        del full
    model = params_from_jax(cfg, params, device, tp=tp)
    tx = make_optimizer(cfg, model.parameters())
    rows = _data_rows(mesh, global_batch)
    mean, mean_loss = _data_mean(mesh)
    params = list(model.parameters())

    def step(state, batch):
        b = _batch(batch, device, rows)
        tx.zero_grad(set_to_none=True)
        loss = sigmoid_bce(model(b["dense"], b["categorical"]),
                           b["label"]).mean()
        loss.backward()
        for p, g in zip(params, mean([p.grad for p in params])):
            p.grad = g
        tx.step()
        return ({**state, "step": state["step"] + 1},
                {"loss": mean_loss(loss.detach())})

    return {"model": model, "optimizer": tx, "step": 0}, step


# ---------------------------------------------------------------------------
# Through the embedding API (JAX ``:233-386``)
# ---------------------------------------------------------------------------

def build_feature_config(cfg: WideDeepConfig):
    """A deep table (``embed_dim``) and a dim-1 wide table
    (``combiner="sum"``) per categorical column, each with its own
    embedding Adagrad."""
    deep_tables = [emb_lib.TableConfig(v, cfg.embed_dim, name=f"table_{i}",
                                       optimizer=emb_lib.Adagrad(
                                           cfg.learning_rate))
                   for i, v in enumerate(cfg.vocab_sizes)]
    wide_tables = [emb_lib.TableConfig(v, 1, name=f"wide_{i}",
                                       combiner="sum",
                                       optimizer=emb_lib.Adagrad(
                                           cfg.learning_rate))
                   for i, v in enumerate(cfg.vocab_sizes)]
    return {
        "deep": tuple(emb_lib.FeatureConfig(t, name=f"deep_{i}")
                      for i, t in enumerate(deep_tables)),
        "wide": tuple(emb_lib.FeatureConfig(t, name=f"wide_{i}")
                      for i, t in enumerate(wide_tables)),
    }


class WideDeepDense(nn.Module):
    """The dense tower alone, on looked-up embedding activations:
    :func:`_interact`, ``mlp_{j}`` Dense + relu, ``out`` Dense(1). flax's
    ``nn.Dense`` with no ``dtype`` promotes a bf16 input with its f32
    kernel, so the tower computes in f32."""

    def __init__(self, cfg: WideDeepConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        width = _interact_width(cfg)
        for j, out in enumerate(cfg.mlp_dims):
            self.add_module(f"mlp_{j}", Dense(width, out, device=device,
                                              generator=generator))
            width = out
        self.out = Dense(width, 1, device=device, generator=generator)

    def forward(self, emb_acts: Sequence, dense):
        x = _interact(self.cfg, emb_acts, dense)
        for j in range(len(self.cfg.mlp_dims)):
            x = torch.relu(getattr(self, f"mlp_{j}")(x))
        return self.out(x)[:, 0].float()


def dense_params_from_jax(cfg: WideDeepConfig, tree, device="cuda"
                          ) -> WideDeepDense:
    """A :class:`WideDeepDense` holding flax's tree ``{"mlp_j": {"kernel",
    "bias"}, "out": ...}``."""
    from distributed_tensorflow_tpu_torch.models.layers import load_flax
    model = WideDeepDense(cfg, device=device)
    load_flax(model, tree)
    return model


def _features(cfg: WideDeepConfig, categorical) -> dict:
    n = len(cfg.vocab_sizes)
    cols = tuple(categorical[:, i] for i in range(n))
    return {"deep": cols, "wide": cols}


def embedding_loss(cfg: WideDeepConfig, feature_config, model, tables,
                   batch, shard=None):
    """The W&D objective through the embedding API (JAX
    ``_embedding_loss_fn``): deep activations into the dense tower, the
    wide ones summed into the logit, sigmoid CE; ``shard``: the tables'
    tensor-parallel handle."""
    acts = emb_lib.lookup(tables, feature_config,
                          _features(cfg, batch["categorical"]), shard=shard)
    logits = model(list(acts["deep"]), batch["dense"])
    logits = logits + sum(w[:, 0] for w in acts["wide"])
    return sigmoid_bce(logits, batch["label"]).mean()


def make_embedding_train_step(cfg: WideDeepConfig, mesh=None,
                              global_batch: int = 0, seed: int = 0, *,
                              device="cuda", dense_params=None,
                              emb_state=None):
    """DLRM/W&D through the embedding API (JAX ``:282-386``): the
    tables in the embedding layer's own state, row-sharded over ``tp``
    on a mesh that has it (:func:`~distributed_tensorflow_tpu_torch.
    embedding.embedding.create_state`), trained by their per-table
    Adagrad, decoupled from the dense tower's optax Adagrad. ``mesh``
    None runs on ``device`` alone. Returns ``(state, step)`` with
    ``state = {"dense": {"model", "optimizer"}, "emb": ...}``; on a mesh
    ``step`` takes the global batch and trains on this rank's rows, all
    gradients meaned over the data axes. ``dense_params`` (flax's tree)
    and ``emb_state`` (JAX's ``create_state`` output, through
    :func:`~distributed_tensorflow_tpu_torch.embedding.embedding.
    state_from_jax`) seed the state; else both come from ``seed``."""
    from distributed_tensorflow_tpu_torch.models.transformer import (
        _data_rows, _mesh_device)
    feature_config = build_feature_config(cfg)
    device = _mesh_device(mesh) if mesh is not None else resolve_device(
        device)
    shard = TensorParallel.from_mesh(mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if emb_state is None:
        emb_state = emb_lib.create_state(feature_config, mesh=mesh,
                                         generator=gen, device=device)
    else:
        emb_state = emb_lib.state_from_jax(emb_state, mesh=mesh,
                                           device=device)
    model = (WideDeepDense(cfg, device=device, generator=gen)
             if dense_params is None
             else dense_params_from_jax(cfg, dense_params, device))
    tx = make_optimizer(cfg, model.parameters())
    rows = slice(None) if mesh is None else _data_rows(mesh, global_batch)
    mean, mean_loss = _data_mean(mesh)
    params = list(model.parameters())

    def step(state, batch):
        b = _batch(batch, device, rows)
        tables = {k: v.detach().requires_grad_(True)
                  for k, v in state["emb"]["tables"].items()}
        tx.zero_grad(set_to_none=True)
        loss = embedding_loss(cfg, feature_config, model, tables, b, shard)
        loss.backward()
        names = list(tables)
        grads = mean([p.grad for p in params]
                     + [tables[k].grad for k in names])
        for p, g in zip(params, grads):
            p.grad = g
        tx.step()
        emb = emb_lib.apply_gradients(
            state["emb"], dict(zip(names, grads[len(params):])),
            feature_config)
        return ({"dense": state["dense"], "emb": emb},
                {"loss": mean_loss(loss.detach())})

    return {"dense": {"model": model, "optimizer": tx},
            "emb": emb_state}, step


# ---------------------------------------------------------------------------
# The pure parameter-server helpers (JAX ``:401-457``)
# ---------------------------------------------------------------------------

def ps_init_state(cfg: WideDeepConfig, seed: int = 0, device="cuda") -> dict:
    """The coordinator's server copy of the full DLRM state: the
    embedding state, the dense tower's flax-style parameters and its
    Adagrad sums (host-side tensors in JAX's tree layout)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    emb_state = emb_lib.create_state(build_feature_config(cfg),
                                     generator=gen, device=device)
    model = WideDeepDense(cfg, device=device, generator=gen)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return {"dense": {"params": params,
                      "opt_state": {n: torch.full_like(p, 0.1)
                                    for n, p in params.items()}},
            "emb": emb_state}


def ps_worker_grads(cfg: WideDeepConfig, dense_params: dict, tables: dict,
                    it):
    """On a worker: the next batch of ``it`` and ``(loss, dense grads,
    table grads)`` as numpy arrays, at the given parameters."""
    batch = next(it)
    device = next(iter(tables.values())).device
    model = WideDeepDense(cfg, device=device)
    params = {n: p.detach().clone().requires_grad_(True)
              for n, p in dense_params.items()}
    tabs = {k: v.detach().clone().requires_grad_(True)
            for k, v in tables.items()}
    b = _batch(batch, device)
    loss = embedding_loss(
        cfg, build_feature_config(cfg),
        lambda acts, dense: torch.func.functional_call(
            model, params, (acts, dense)), tabs, b)
    loss.backward()
    host = lambda d: {k: v.grad.cpu().numpy() for k, v in d.items()}  # noqa: E731
    return float(loss.detach()), host(params), host(tabs)


def ps_apply_grads(cfg: WideDeepConfig, state: dict, dgrads: dict,
                   tgrads: dict) -> dict:
    """On the coordinator: the current server copy updated with a
    (possibly stale) worker gradient — the dense tower's optax Adagrad,
    the tables' embedding Adagrad."""
    lr, eps = cfg.learning_rate, 1e-7
    params, sums = {}, {}
    for n, p in state["dense"]["params"].items():
        g = torch.as_tensor(dgrads[n]).to(p.device)
        s = g.square() + state["dense"]["opt_state"][n]
        inv = torch.where(s > 0, torch.rsqrt(s + eps), torch.zeros_like(s))
        params[n] = p + (inv * g) * -lr
        sums[n] = s
    tables = state["emb"]["tables"]
    emb = emb_lib.apply_gradients(
        state["emb"], {k: torch.as_tensor(v).to(tables[k].device)
                       for k, v in tgrads.items()},
        build_feature_config(cfg))
    return {"dense": {"params": params, "opt_state": sums}, "emb": emb}


def synthetic_clicks(cfg: WideDeepConfig, n: int, seed: int = 0) -> dict:
    """Click-through data where the label depends on feature crosses:
    JAX's numpy draw, the same arrays bit for bit (numpy here)."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, cfg.num_dense_features)).astype("float32")
    cat = np.stack([rng.integers(0, v, size=n) for v in cfg.vocab_sizes],
                   axis=1).astype("int32")
    score = dense.mean(1) + 0.3 * np.cos(cat.sum(1))
    label = (score > np.median(score)).astype("int32")
    return {"dense": dense, "categorical": cat, "label": label}
