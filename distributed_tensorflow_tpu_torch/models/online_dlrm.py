"""Online recommender: streaming DLRM over dynamic embedding tables —
port of ``distributed_tensorflow_tpu/models/online_dlrm.py``.

An append-only click stream (``input/stream.py``) feeds a small
Wide&Deep-style model whose user and item tables are
:class:`~distributed_tensorflow_tpu_torch.embedding.dynamic.DynamicTable`
s, trained continuously with **exactly-once** event application: the
trainer's stream cursor (the next unapplied offset) is a leaf of the
same checkpoint the model and table membership commit through, and
every commit is synchronous (JAX ``:313-339``), so cursor and state
move together and a trainer killed between apply and commit replays
exactly the uncommitted records.

The checkpoint layout (:func:`checkpoint_template`) and the table state
are JAX's (numpy leaves only), so either package restores the other's
online checkpoints. Gradients are computed locally
(:func:`worker_grads`, torch autograd on the trainer's device); the
``ClusterCoordinator`` path of the JAX package belongs to a later slice,
and ``OnlineTrainer(coordinator=...)`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.embedding.dynamic import (
    DynamicTable,
    DynamicTableConfig,
    StaticHashTable,
)
from distributed_tensorflow_tpu_torch.embedding.embedding import Adagrad
from distributed_tensorflow_tpu_torch.input import stream as stream_lib
from distributed_tensorflow_tpu_torch.models.transformer import (
    resolve_device)
from distributed_tensorflow_tpu_torch.telemetry import events as tv_events


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """The online job's model, table and stream shape (JAX's)."""

    embed_dim: int = 8
    n_dense: int = 4
    hidden: tuple = (32, 16)
    dense_lr: float = 0.05
    table_lr: float = 0.05
    batch_size: int = 16
    initial_capacity: int = 256
    max_capacity: int = 1024
    admission_threshold: int = 2
    ttl_steps: int = 2048
    n_users: int = 50_000
    n_items: int = 10_000
    zipf_a: float = 1.2
    seed: int = 0

    def __post_init__(self):
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got "
                             f"{self.batch_size}")

    def table_config(self, name: str, seed: int) -> DynamicTableConfig:
        return DynamicTableConfig(
            dim=self.embed_dim,
            initial_capacity=self.initial_capacity,
            max_capacity=self.max_capacity,
            admission_threshold=self.admission_threshold,
            ttl_steps=self.ttl_steps,
            optimizer=Adagrad(self.table_lr),
            name=name, seed=seed)

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(embed_dim=4, hidden=(16,), initial_capacity=32,
                        max_capacity=64, n_users=500, n_items=200)
        defaults.update(kw)
        return cls(**defaults)


# ---------------------------------------------------------------------------
# Dense tower and the grad program
# ---------------------------------------------------------------------------

def init_dense(cfg: OnlineConfig, seed: int = 0) -> dict:
    """The dense tower's parameters as numpy arrays (JAX's draws)."""
    rng = np.random.default_rng([cfg.seed, seed, 0xDE45E])
    dims = (2 * cfg.embed_dim + cfg.n_dense,) + tuple(cfg.hidden) + (1,)
    params = {}
    for i in range(len(dims) - 1):
        scale = 1.0 / np.sqrt(dims[i])
        params[f"w{i}"] = rng.normal(
            0, scale, size=(dims[i], dims[i + 1])).astype(np.float32)
        params[f"b{i}"] = np.zeros(dims[i + 1], dtype=np.float32)
    return params


def _forward(cfg: OnlineConfig, params, user_rows, item_rows, dense):
    x = torch.cat([user_rows, item_rows, dense], dim=-1)
    n_layers = len(cfg.hidden) + 1
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x[:, 0]


def _bce(logits, labels):
    """Sigmoid binary cross entropy, JAX's formula."""
    labels = labels.to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def worker_grads(cfg: OnlineConfig, dense_params, user_rows, item_rows,
                 dense, labels):
    """``(loss, dense_grads, user_row_grads, item_row_grads)`` of one
    batch, w.r.t. the dense parameters and the gathered rows, on the
    rows' device."""
    device = torch.as_tensor(user_rows).device

    def leaf(a, dtype=None):
        t = torch.as_tensor(a).to(device)
        t = t.to(dtype) if dtype is not None else t
        return t.detach().clone().requires_grad_(True)

    params = {k: leaf(v) for k, v in dense_params.items()}
    urows, irows = leaf(user_rows), leaf(item_rows)
    with torch.enable_grad():
        loss = _bce(_forward(cfg, params, urows, irows,
                             torch.as_tensor(dense).to(device)),
                    torch.as_tensor(labels).to(device))
        keys = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in keys]
                                    + [urows, irows])
    return (loss.detach(), dict(zip(keys, grads[:len(keys)])),
            grads[-2], grads[-1])


@torch.no_grad()
def _dense_apply(lr: float, params: dict, grads: dict, accum: dict):
    """Adagrad on the dense tower (JAX's ``rsqrt(acc + 1e-12)``)."""
    new_acc = {k: accum[k] + grads[k].square() for k in params}
    new_p = {k: params[k] - lr * grads[k] * torch.rsqrt(new_acc[k] + 1e-12)
             for k in params}
    return new_p, new_acc


# ---------------------------------------------------------------------------
# Checkpoint layout (fixed leaf names)
# ---------------------------------------------------------------------------

def checkpoint_template(cfg: OnlineConfig) -> dict:
    """The leaf-name structure of an online checkpoint (JAX's; shapes
    are placeholders, a restore is name-driven)."""
    dense = init_dense(cfg)
    table = {"rows": np.zeros((1, cfg.embed_dim), np.float32),
             "aux": np.zeros(1, np.uint8)}
    return {
        "offset": np.zeros((), np.int64),
        "step": np.zeros((), np.int64),
        "commit_wall": np.zeros((), np.float64),
        "dense": {"params": dense,
                  "accum": {k: np.zeros_like(v) for k, v in dense.items()}},
        "user": dict(table),
        "item": {k: v.copy() for k, v in table.items()},
    }


def unpack_restored(flat: dict, prefix: str = "online") -> dict:
    """The nested online state from a flat restored mapping."""
    out: dict = {}
    pre = prefix + "/"
    for key, val in flat.items():
        if not key.startswith(pre):
            continue
        node = out
        parts = key[len(pre):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


# ---------------------------------------------------------------------------
# The trainer loop
# ---------------------------------------------------------------------------

class OnlineTrainer:
    """Continuous streaming trainer with exactly-once event application
    (JAX's, local path). One instance is one incarnation: construct,
    :meth:`restore`, then :meth:`run` until ``total_events`` are applied
    and committed. ``agent`` (a coordination agent) gets the committed
    offset as an advisory ``dtx_online/committed_offset`` key."""

    def __init__(self, cfg: OnlineConfig, stream_path: str,
                 ckpt_dir: str, *, commit_every: int = 5,
                 coordinator=None, max_in_flight: int = 2,
                 static_tables: bool = False,
                 local_dir: str | None = None,
                 manager_kwargs: dict | None = None,
                 agent=None, device="cuda"):
        from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
            Checkpoint, CheckpointManager)
        if coordinator is not None:
            raise NotImplementedError(
                "OnlineTrainer(coordinator=...) schedules gradients on a "
                "ClusterCoordinator, which the port does not have yet; "
                "leave coordinator=None for the local path")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.stream_path = stream_path
        self.commit_every = commit_every
        self.coordinator = None
        self.max_in_flight = max(1, max_in_flight)
        self.agent = agent
        if static_tables:
            self.user_table = StaticHashTable(
                cfg.embed_dim, cfg.max_capacity,
                optimizer=Adagrad(cfg.table_lr), seed=cfg.seed,
                name="user", device=self.device)
            self.item_table = StaticHashTable(
                cfg.embed_dim, cfg.max_capacity,
                optimizer=Adagrad(cfg.table_lr), seed=cfg.seed + 1,
                name="item", device=self.device)
        else:
            self.user_table = DynamicTable(
                cfg.table_config("user", cfg.seed), device=self.device)
            self.item_table = DynamicTable(
                cfg.table_config("item", cfg.seed + 1), device=self.device)
        self.dense_params = {k: self._tensor(v)
                             for k, v in init_dense(cfg).items()}
        self.dense_accum = {k: torch.zeros_like(v)
                            for k, v in self.dense_params.items()}
        self.offset = 0
        self.step = 0
        self.events_applied = 0
        self.commits = 0
        self._ckpt = Checkpoint(single_writer=True,
                                online=checkpoint_template(cfg))
        self._mgr = CheckpointManager(
            self._ckpt, ckpt_dir, checkpoint_name="online",
            local_dir=local_dir, **(manager_kwargs or {}))

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=self.device)

    # -- state <-> checkpoint ---------------------------------------------
    def _state_nested(self) -> dict:
        def host(d):
            return {k: v.detach().cpu().numpy() for k, v in d.items()}
        return {
            "offset": np.asarray(self.offset, np.int64),
            "step": np.asarray(self.step, np.int64),
            "commit_wall": np.asarray(time.time(), np.float64),
            "dense": {"params": host(self.dense_params),
                      "accum": host(self.dense_accum)},
            "user": self.user_table.state_dict(),
            "item": self.item_table.state_dict(),
        }

    def restore(self) -> int:
        """Restore cursor, model and membership from the freshest intact
        tier; returns the resume offset (0: cold start)."""
        res = self._mgr.restore_latest()
        if res is None:
            tv_events.event("stream.resume", offset=0, tier="none")
            return 0
        tier, number, restored = res
        self.load_state(unpack_restored(restored))
        self.commits = int(number)
        tv_events.event("stream.resume", offset=self.offset, tier=tier,
                        step=self.step)
        return self.offset

    def load_state(self, state: dict):
        self.offset = int(np.asarray(state["offset"]))
        self.step = int(np.asarray(state["step"]))
        self.dense_params = {k: self._tensor(v) for k, v in
                             state["dense"]["params"].items()}
        self.dense_accum = {k: self._tensor(v) for k, v in
                            state["dense"]["accum"].items()}
        self.user_table.load_state_dict(state["user"])
        self.item_table.load_state_dict(state["item"])

    def commit(self):
        """Commit model, membership and cursor in one synchronous
        checkpoint save (the index written last is the commit point),
        then advertise the offset on the agent's KV."""
        self._ckpt._objects["online"] = self._state_nested()
        self._mgr.save(checkpoint_number=self.commits + 1,
                       async_write=False)
        self.commits += 1
        if self.agent is not None:
            try:
                self.agent.key_value_set("dtx_online/committed_offset",
                                         str(self.offset),
                                         allow_overwrite=True)
            except Exception:
                pass             # advisory only
        tv_events.event("stream.commit", offset=self.offset,
                        step=self.step, commit=self.commits)

    # -- the loop ---------------------------------------------------------
    def _batches(self, total_events: int, idle_timeout_s: float):
        ds = stream_lib.StreamDataset(self.stream_path,
                                      start_offset=self.offset)
        buf: list = []
        lo = self.offset
        for off, ev in ds.events(end_offset=total_events,
                                 idle_timeout_s=idle_timeout_s):
            buf.append(ev)
            if len(buf) == self.cfg.batch_size:
                yield lo, off + 1, buf
                buf, lo = [], off + 1
        if buf:
            yield lo, lo + len(buf), buf

    @staticmethod
    def _stack(events: list) -> dict:
        return {"user": np.asarray([e["user"] for e in events], np.int64),
                "item": np.asarray([e["item"] for e in events], np.int64),
                "dense": np.stack([e["dense"] for e in events]),
                "label": np.asarray([e["label"] for e in events], np.int32)}

    def _pad(self, batch: dict) -> tuple[dict, int]:
        """A short tail batch repeats its last event (JAX's fixed-shape
        batches; the padded rows' grads are dropped in :meth:`_apply`)."""
        n = len(batch["label"])
        b = self.cfg.batch_size
        if n == b:
            return batch, n
        pad = {k: np.concatenate([v, np.repeat(v[-1:], b - n, axis=0)])
               for k, v in batch.items()}
        return pad, n

    def _compute_grads(self, urows_idx, irows_idx, batch):
        return worker_grads(self.cfg, self.dense_params,
                            self.user_table.gather(urows_idx),
                            self.item_table.gather(irows_idx),
                            batch["dense"], batch["label"])

    def _apply(self, urows_idx, irows_idx, n_real, result):
        loss, dgrads, ugrads, igrads = result
        if n_real < self.cfg.batch_size:
            scale = self.cfg.batch_size / n_real
            ugrads = ugrads[:n_real] * scale
            igrads = igrads[:n_real] * scale
            dgrads = {k: v * scale for k, v in dgrads.items()}
            urows_idx = urows_idx[:n_real]
            irows_idx = irows_idx[:n_real]
        self.user_table.apply_row_grads(urows_idx, ugrads,
                                        pad_to=self.cfg.batch_size)
        self.item_table.apply_row_grads(irows_idx, igrads,
                                        pad_to=self.cfg.batch_size)
        self.dense_params, self.dense_accum = _dense_apply(
            self.cfg.dense_lr, self.dense_params, dgrads, self.dense_accum)
        return float(loss)

    def run(self, total_events: int, *, idle_timeout_s: float = 60.0,
            heartbeat_fn=None, on_batch=None,
            crash_after_batches: int | None = None) -> dict:
        """Apply stream records ``[restore offset, total_events)``,
        committing every ``commit_every`` batches and once at the end.
        ``crash_after_batches`` raises after an apply, before the next
        commit. Returns summary counters (``events_per_sec`` included)."""
        losses: list = []
        batches_done = 0
        t_first = None
        for lo, hi, events in self._batches(total_events, idle_timeout_s):
            batch, n_real = self._pad(self._stack(events))
            uidx = self.user_table.translate(batch["user"])
            iidx = self.item_table.translate(batch["item"])
            t0 = time.perf_counter()
            loss = self._apply(uidx, iidx, n_real,
                               self._compute_grads(uidx, iidx, batch))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dur = time.perf_counter() - t0
            if t_first is None:
                t_first = time.perf_counter() - dur
            self.offset = hi
            self.events_applied += n_real
            self.step += 1
            batches_done += 1
            losses.append(loss)
            tv_events.event("train.step", step=self.step, loss=loss,
                            dur_s=round(dur, 6))
            tv_events.event("stream.batch_applied", lo=lo, hi=hi, n=n_real,
                            step=self.step, loss=round(loss, 5))
            if heartbeat_fn is not None:
                heartbeat_fn(batches_done)
            if on_batch is not None:
                on_batch(self)
            if crash_after_batches is not None \
                    and batches_done >= crash_after_batches:
                raise _InjectedCrash(
                    f"injected crash after {batches_done} applied "
                    f"batches (before commit)")
            if self.step % self.commit_every == 0:
                self.commit()
        if self.offset < total_events:
            raise TimeoutError(
                f"stream went idle at offset {self.offset} before "
                f"reaching {total_events} events")
        if self.step % self.commit_every != 0 or self.commits == 0:
            self.commit()
        wall = (time.perf_counter() - t_first) if t_first else 0.0
        return {
            "offset": self.offset,
            "steps": self.step,
            "events_applied": self.events_applied,
            "commits": self.commits,
            "loss_last": losses[-1] if losses else None,
            "events_per_sec": (self.events_applied / wall
                               if wall > 0 else None),
            "tables": {
                name: {"capacity": t.capacity, "mapped": t.mapped,
                       "admissions": t.admissions,
                       "evictions": t.evictions, "grows": t.grows}
                for name, t in (("user", self.user_table),
                                ("item", self.item_table))},
        }

    def sync(self):
        self._ckpt.sync()


class _InjectedCrash(RuntimeError):
    """Raised by ``crash_after_batches``."""


def table_stats_event(trainer: OnlineTrainer):
    """One ``embed.update`` event a table (capacity, membership and
    admission counters)."""
    for name, t in (("user", trainer.user_table),
                    ("item", trainer.item_table)):
        tv_events.event("embed.update", table=name,
                        capacity=t.capacity, mapped=t.mapped,
                        admissions=t.admissions, evictions=t.evictions,
                        grows=t.grows, step=trainer.step)


# ---------------------------------------------------------------------------
# Evaluator side
# ---------------------------------------------------------------------------

def eval_snapshot(cfg: OnlineConfig, state: dict, *, n_eval: int = 64,
                  eval_seed: int = 0xEA1, device="cuda") -> float:
    """Held-out loss of a restored snapshot: tables rebuilt (membership
    included) read-only, a seeded eval batch scored."""
    device = resolve_device(device)
    user = (DynamicTable(cfg.table_config("user", cfg.seed), device=device)
            if _is_dynamic(state["user"]) else StaticHashTable(
                cfg.embed_dim, cfg.max_capacity, seed=cfg.seed,
                device=device))
    item = (DynamicTable(cfg.table_config("item", cfg.seed + 1),
                         device=device)
            if _is_dynamic(state["item"]) else StaticHashTable(
                cfg.embed_dim, cfg.max_capacity, seed=cfg.seed + 1,
                device=device))
    user.load_state_dict(state["user"])
    item.load_state_dict(state["item"])
    batch = stream_lib.seeded_events(
        eval_seed, 0, n_eval, n_users=cfg.n_users, n_items=cfg.n_items,
        n_dense=cfg.n_dense, zipf_a=cfg.zipf_a)
    uidx = user.translate(batch["user"], train=False)
    iidx = item.translate(batch["item"], train=False)
    params = {k: torch.tensor(np.asarray(v), device=device)
              for k, v in state["dense"]["params"].items()}
    with torch.no_grad():
        logits = _forward(cfg, params, user.gather(uidx), item.gather(iidx),
                          torch.as_tensor(batch["dense"]).to(device))
        loss = _bce(logits, torch.as_tensor(batch["label"]).to(device))
    return float(loss)


def _is_dynamic(table_state: dict) -> bool:
    import pickle
    aux = pickle.loads(np.asarray(table_state["aux"],
                                  dtype=np.uint8).tobytes())
    return "id_to_row" in aux
