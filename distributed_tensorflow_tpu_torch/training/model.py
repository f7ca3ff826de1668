"""Model.compile / fit / evaluate / predict on a Strategy — port of
``distributed_tensorflow_tpu/training/model.py``.

JAX compiles one SPMD train step over the strategy's mesh. Here a
replica is a rank and the step runs eagerly on each:

- **The loss is the global sample-weighted mean.** Each rank computes
  its rows' weighted loss sum; the weight sums are all-reduced over the
  data dims, and ``local sum / global weight`` is differentiated, so the
  gradient summed over the replicas (the strategy's bucketed
  all-reduce, ``GradientBucketer.backward_sync``, launched from the
  backward) is ``Σ local grads / Σ weights`` — JAX's bucketed form
  (``:325-328``). A padded final batch gives the ranks different
  weights, which this keeps exact.
- **BatchNorm** statistics are the global batch's (all-reduced inside
  the layer, gradient included), and a padded final batch (``full ==
  0``) does not update the running averages (``:269-272``).
- **Metric state** is summed over the global batch: all-reduced over
  the data dims before ``result``, so every rank logs the same numbers.
- **Batching** follows ``_batches`` / ``_pad`` (``:391-444``): numpy
  ``default_rng(seed)`` shuffles, static batch shapes, a zero-padded
  final batch masked by the sample weights; rank r takes its rows of
  each global batch (``strategy.shard_batch``).
- **Variables** are a flax-shaped nested dict (:class:`Scope` names
  them), so ``get_weights`` / ``set_weights`` take and give JAX's tree,
  and ``save_weights`` / ``load_weights`` write the port's
  ``checkpoint.Checkpoint`` with JAX's leaf paths.
- **Optimizers** are optax's written out (``training/optimizers.py``).

With no strategy in scope a Model takes ``OneDeviceStrategy()`` (this
rank's card; it raises with no CUDA device).
"""

from __future__ import annotations

import os
import time
from typing import Any, Sequence

import numpy as np
import torch

from distributed_tensorflow_tpu_torch import telemetry
from distributed_tensorflow_tpu_torch.input.dataset import Dataset
from distributed_tensorflow_tpu_torch.parallel import collectives
from distributed_tensorflow_tpu_torch.parallel.collectives import ReduceOp
from distributed_tensorflow_tpu_torch.training import callbacks as callbacks_lib
from distributed_tensorflow_tpu_torch.training import losses as losses_lib
from distributed_tensorflow_tpu_torch.training import metrics as metrics_lib
from distributed_tensorflow_tpu_torch.training.optimizers import (
    OptimizerSpec, f32)
from distributed_tensorflow_tpu_torch.utils import tree


def _default_strategy():
    from distributed_tensorflow_tpu_torch.parallel.one_device import (
        OneDeviceStrategy)
    return OneDeviceStrategy()


# ---------------------------------------------------------------------------
# Variable scoping (flax's compact-module naming)
# ---------------------------------------------------------------------------

class Frame:
    """One forward's variables and context: ``params`` and ``state``
    (collections, e.g. ``batch_stats``) are nested dicts, created in
    ``init`` mode and read otherwise; ``updates`` collects the
    collections' new values, ``reg`` the weight penalties."""

    def __init__(self, params: dict, state: dict, *, device, train: bool,
                 init: bool = False, init_gen=None, dropout_seed=None,
                 stats_sync=None):
        self.params, self.state = params, state
        self.device, self.train, self.init = device, train, init
        self.init_gen = init_gen
        self.dropout_seed = dropout_seed
        self.stats_sync = stats_sync
        self.updates: list = []
        self.reg: dict = {}
        self._drops = 0

    def root(self) -> "Scope":
        return Scope(self, ())

    def reg_total(self) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for k in sorted(self.reg):
            total = total + self.reg[k]
        return total

    def dropout_keep(self, shape, rate: float, layer_seed) -> torch.Tensor:
        """A keep mask (``P(keep) = 1 − rate``) from a generator seeded
        by the step's seed, this call's ordinal and the layer's seed."""
        if self.init:           # building: the values do not matter
            return torch.ones(shape, dtype=torch.bool, device=self.device)
        if self.dropout_seed is None:
            raise RuntimeError("dropout outside a training step")
        self._drops += 1
        seed = hash((self.dropout_seed, self._drops, layer_seed)) % (2 ** 62)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return torch.rand(shape, generator=gen, device=self.device) >= rate


class Scope:
    """A flax scope: ``child(kind)`` names submodules ``kind_0``,
    ``kind_1``, ... in call order (per scope, per call), ``child(kind,
    name)`` takes ``name``; ``param`` / ``variable`` create (in init
    mode) or read a leaf at this scope's path."""

    def __init__(self, frame: Frame, path: tuple):
        self.frame, self.path = frame, path
        self._counts: dict = {}

    def child(self, kind, name=None) -> "Scope":
        if name is None:
            n = self._counts.get(kind, 0)
            self._counts[kind] = n + 1
            name = f"{kind}_{n}"
        return Scope(self.frame, self.path + (name,))

    def _node(self, root: dict) -> dict:
        node = root
        for k in self.path:
            if k not in node:
                if not self.frame.init:
                    raise KeyError(f"no variables at {'/'.join(self.path)}")
                node[k] = {}
            node = node[k]
        return node

    def _leaf(self, root: dict, name: str, shape, init):
        node = self._node(root)
        if name not in node:
            if not self.frame.init:
                raise KeyError(f"no variable {'/'.join(self.path)}/{name}")
            node[name] = init(tuple(shape), self.frame.init_gen).to(
                self.frame.device)
        return node[name]

    def param(self, name: str, shape, init) -> torch.Tensor:
        return self._leaf(self.frame.params, name, shape, init)

    def variable(self, collection: str, name: str, shape, init):
        coll = (self.frame.state.setdefault(collection, {})
                if self.frame.init else self.frame.state[collection])
        return self._leaf(coll, name, shape, init)

    def update(self, collection: str, name: str, value):
        self.frame.updates.append((collection, self.path, name, value))


def _torch_dtype(a) -> torch.dtype:
    if isinstance(a, torch.Tensor):
        return a.dtype
    return {np.dtype("float64"): torch.float32,
            np.dtype("int64"): torch.int32}.get(
        np.asarray(a).dtype, torch.from_numpy(np.zeros(
            1, np.asarray(a).dtype)).dtype)


def _unflatten_like(template, flat: dict, prefix: str = ""):
    """The inverse of ``checkpoint._flatten`` for nested dicts."""
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], flat,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k in template}
    return flat[prefix or "value"]


def _detached(t):
    return tree.tree_map(lambda x: x.detach(), t)


class Model:
    """A trainable model: a module (called as ``module(scope, x)``) +
    optimizer + loss + metrics (JAX ``:71``)."""

    def __init__(self, module, *, eval_module=None, seed: int = 0):
        self.module = module
        self.eval_module = eval_module or module
        self.seed = seed
        self.strategy = None
        self.stop_training = False
        # {"params", "step", "model_state"}
        self._state = None
        self._opt = None
        self._sync = None
        self._built = False
        self._compiled = False
        self._restored_initial_epoch = None

    # -- build / compile ---------------------------------------------------
    def _apply(self, params, model_state, x, *, train: bool, **frame_kw):
        frame = Frame(params, model_state, device=self.strategy.device,
                      train=train, **frame_kw)
        module = self.module if train else self.eval_module
        return module(frame.root(), x), frame

    def build(self, sample_input):
        """Create the variables (on this rank's device, every replica
        replica 0's) from a sample's shapes."""
        self._ensure_strategy()
        dev = self.strategy.device
        sample = tree.tree_map(
            lambda a: torch.zeros(tuple(np.shape(a)), dtype=_torch_dtype(a),
                                  device=dev), sample_input)
        gen = torch.Generator()
        gen.manual_seed(self.seed)
        params, state = {}, {}
        with torch.no_grad():
            self._apply(params, state, sample, train=True, init=True,
                        init_gen=gen)
        self._build_sample = sample
        self._state = {"step": 0}
        self._set_state_trees(params, state)
        self._built = True

    def _set_state_trees(self, params: dict, model_state: dict):
        """Install variable trees: leaves become this rank's tensors
        (parameters requiring grad), replica 0's on every replica; the
        optimizer and gradient sync are made anew."""
        leaves = tree.tree_leaves(params) + tree.tree_leaves(model_state)
        self.strategy._broadcast_tensors(leaves)
        for p in tree.tree_leaves(params):
            p.requires_grad_(True)
        self._state["params"] = params
        self._state["model_state"] = model_state
        self._param_list = tree.tree_leaves(params)
        if self._sync is not None:
            self._sync.remove()
            self._sync = None
        if self._compiled:
            self._opt = self._tx.create(self._param_list)

    def _ensure_strategy(self):
        if self.strategy is None:
            from distributed_tensorflow_tpu_torch.parallel.strategy import (
                get_strategy, has_strategy)
            self.strategy = (get_strategy() if has_strategy()
                             else _default_strategy())

    def compile(self, optimizer="adam", loss=None, metrics=(),
                learning_rate: float | None = None):
        """``optimizer``: one of {"sgd", "adam", "adamw", "rmsprop"} (at
        ``learning_rate``, default 1e-3) or a ``keras.optimizers``
        one."""
        self._ensure_strategy()
        self._lr_schedule_driven = callable(learning_rate)
        if isinstance(optimizer, str):
            key = optimizer.lower()
            if key not in OptimizerSpec.KINDS:
                raise ValueError(f"Unknown optimizer {optimizer!r}; "
                                 f"known: {sorted(OptimizerSpec.KINDS)}")
            lr = learning_rate if learning_rate is not None else 1e-3
            self._tx = OptimizerSpec(key, lr)
        elif isinstance(optimizer, OptimizerSpec):
            self._tx = optimizer
        else:
            raise TypeError(
                f"optimizer {optimizer!r}: pass a name or a "
                "keras.optimizers optimizer")
        if loss is None:
            raise ValueError("compile() requires a loss")
        self._loss = losses_lib.get(loss)
        self._metrics = [metrics_lib.get(m, loss=self._loss)
                         for m in (metrics or ())]
        names = [m.name for m in self._metrics]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate metric names: {names}")
        self._loss_metric = metrics_lib.Mean("loss")
        self._compiled = True
        if self._built:
            self._opt = self._tx.create(self._param_list)

    # -- learning rate -----------------------------------------------------
    @property
    def learning_rate(self) -> float:
        if self._opt is None:
            raise AttributeError(
                "optimizer has no mutable learning_rate before compile "
                "and build")
        return self._opt.learning_rate

    @learning_rate.setter
    def learning_rate(self, value: float):
        if getattr(self, "_lr_schedule_driven", False):
            raise AttributeError(
                "learning_rate was compiled as a schedule; it is "
                "re-evaluated every update, so writes (ReduceLROnPlateau, "
                "LearningRateScheduler) would be silently clobbered — "
                "compile with a float learning rate to drive it from "
                "callbacks")
        if self._opt is None:
            raise AttributeError(
                "optimizer has no mutable learning_rate before compile "
                "and build")
        self._opt.learning_rate = f32(value)

    # -- replicas ----------------------------------------------------------
    @property
    def _replicas(self) -> int:
        return self.strategy.num_replicas_in_sync

    def _psum(self, t: torch.Tensor) -> torch.Tensor:
        if self._replicas == 1:
            return t
        return collectives.all_reduce(t, self.strategy.mesh,
                                      self.strategy.data_axis_names)

    def _stats_sync(self):
        if self._replicas == 1:
            return None
        from distributed_tensorflow_tpu_torch.models.resnet import (
            _MeanOverData)
        mesh, axes = self.strategy.mesh, self.strategy.data_axis_names
        return lambda t: _MeanOverData.apply(t, mesh, axes)

    def _grad_sync(self):
        """The bucketed SUM of the gradients over the replicas, launched
        from the backward (None on one replica)."""
        if self._sync is None and self._replicas > 1:
            bucketer = self.strategy.gradient_bucketer()
            self._sync = bucketer.backward_sync(
                [[p] for p in self._param_list], ReduceOp.SUM)
        return self._sync

    # -- steps -------------------------------------------------------------
    def _metric_init(self):
        dev = self.strategy.device
        ms = {"loss": self._loss_metric.init(dev)}
        for m in self._metrics:
            ms[m.name] = m.init(dev)
        return ms

    def _metric_update(self, mstate, y, preds, per, sw):
        m2 = dict(mstate)
        m2["loss"] = self._loss_metric.update_values(mstate["loss"], per, sw)
        for m in self._metrics:
            m2[m.name] = m.update(mstate[m.name], y, preds, sw)
        return m2

    def _metric_results(self, mstate) -> dict:
        if self._replicas > 1:
            leaves, td = tree.tree_flatten(mstate)
            summed = self._psum(torch.stack(leaves)).unbind(0)
            mstate = tree.tree_unflatten(td, list(summed))
        out = {"loss": float(self._loss_metric.result(mstate["loss"]))}
        for m in self._metrics:
            out[m.name] = float(m.result(mstate[m.name]))
        return out

    def _train_step(self, mstate, batch, full: bool):
        x, y, sw = batch
        for p in self._param_list:
            p.grad = None
        sync = self._grad_sync()
        if sync is not None:
            sync.begin()
        step = self._state["step"]
        preds, frame = self._apply(
            self._state["params"], self._state["model_state"], x, train=True,
            dropout_seed=(self.seed ^ 0x5eed, step, self.strategy.replica_id),
            stats_sync=self._stats_sync())
        per = self._loss.call(y, preds).float() + frame.reg_total()
        w = sw.float()
        den = self._psum(w.sum()).clamp_min(1e-9)
        ((per * w).sum() / den).backward()
        if sync is not None:
            sync.finish()
        self._opt.step()
        if full:
            # forward-pass state over a zero-padded final batch would
            # corrupt the running averages: kept only for full batches
            for coll, path, name, value in frame.updates:
                node = self._state["model_state"][coll]
                for k in path:
                    node = node[k]
                node[name].copy_(value)
        self._state["step"] = step + 1
        return self._metric_update(mstate, y, preds.detach(), per.detach(),
                                   sw)

    @torch.no_grad()
    def _eval_step(self, mstate, batch):
        x, y, sw = batch
        preds, frame = self._apply(self._state["params"],
                                   self._state["model_state"], x,
                                   train=False)
        per = self._loss.call(y, preds).float() + frame.reg_total()
        return self._metric_update(mstate, y, preds, per, sw)

    @torch.no_grad()
    def _predict_step(self, x):
        preds, _ = self._apply(self._state["params"],
                               self._state["model_state"], x, train=False)
        if self._replicas > 1:
            preds = collectives.all_gather(
                preds.contiguous(), self.strategy.mesh,
                self.strategy.data_axis_names)
        return preds

    # -- data plumbing -----------------------------------------------------
    def _batches(self, x, y=None, sample_weight=None, *, batch_size,
                 shuffle=False, seed=0):
        """``((x, y, sw), full)`` global batches of a static size: the
        final partial batch zero-padded and masked through ``sw``, with
        ``full`` False."""
        if isinstance(x, Dataset) or (y is None and not isinstance(
                x, (np.ndarray, torch.Tensor))):
            ds = Dataset.from_iterable(x)
            static = [None]

            def gen():
                for el in ds:
                    if not isinstance(el, (tuple, list)) or len(el) < 2:
                        raise ValueError(
                            "dataset elements must be (x, y) or (x, y, sw)")
                    bx, by = el[0], el[1]
                    bw = el[2] if len(el) > 2 else None
                    n = np.shape(tree.tree_leaves(bx)[0])[0]
                    if static[0] is None:
                        static[0] = n
                    yield self._pad(bx, by, bw, n, static[0])
            return gen()

        x = np.asarray(x)
        y = np.asarray(y)
        n = len(x)

        def gen():
            idx = np.arange(n)
            if shuffle:
                np.random.default_rng(seed).shuffle(idx)
            for start in range(0, n, batch_size):
                sel = idx[start:start + batch_size]
                bw = (np.asarray(sample_weight)[sel]
                      if sample_weight is not None else None)
                yield self._pad(x[sel], y[sel], bw, len(sel), batch_size)
        return gen()

    @staticmethod
    def _pad(bx, by, bw, n, full):
        sw = np.ones(n, np.float32) if bw is None else \
            np.asarray(bw, np.float32)
        if n == full:
            return (bx, by, sw), True

        def pad(a):
            a = np.asarray(a)
            width = [(0, full - n)] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, width)
        return ((tree.tree_map(pad, bx), tree.tree_map(pad, by), pad(sw)),
                False)

    def _place(self, batch):
        return self.strategy.shard_batch(tree.tree_map(
            lambda a: np.asarray(a).astype(np.float32)
            if np.asarray(a).dtype == np.float64 else a, batch))

    # -- fit / evaluate / predict -----------------------------------------
    def fit(self, x, y=None, *, batch_size: int = 32, epochs: int = 1,
            verbose: int = 1, callbacks: Sequence | None = None,
            validation_data=None, validation_split: float = 0.0,
            shuffle: bool = True,
            initial_epoch: int = 0, steps_per_epoch: int | None = None,
            sample_weight=None, class_weight=None):
        """keras ``fit`` (JAX ``:450``): ``validation_split`` holds out
        the last fraction before shuffling; ``class_weight`` multiplies
        into the training batches' sample weights."""
        if not self._compiled:
            raise RuntimeError("compile() the model before fit()")
        if validation_split:
            if not 0.0 < validation_split < 1.0:
                raise ValueError(
                    f"validation_split must be in (0, 1), got "
                    f"{validation_split}")
            if validation_data is not None:
                raise ValueError(
                    "pass either validation_data or validation_split, "
                    "not both")
            if y is None:
                raise ValueError(
                    "validation_split requires array inputs (x, y)")
            x, y = np.asarray(x), np.asarray(y)
            split = int(len(x) * (1.0 - validation_split))
            if split == 0 or split == len(x):
                raise ValueError(
                    f"validation_split={validation_split} on "
                    f"{len(x)} samples leaves an empty training or "
                    f"validation set")
            if sample_weight is not None:
                sw = np.asarray(sample_weight)
                validation_data = (x[split:], y[split:], sw[split:])
                sample_weight = sw[:split]
            else:
                validation_data = (x[split:], y[split:])
            x, y = x[:split], y[:split]
        if class_weight:
            if y is None:
                raise ValueError(
                    "class_weight requires array labels (x, y)")
            y_arr = np.asarray(y)
            if y_arr.ndim > 1:
                y_arr = np.argmax(y_arr, axis=-1)
            cw = np.ones(int(y_arr.max()) + 1, np.float32)
            for cls, w in class_weight.items():
                if int(cls) >= len(cw):
                    cw = np.concatenate(
                        [cw, np.ones(int(cls) + 1 - len(cw), np.float32)])
                cw[int(cls)] = w
            per_sample = cw[y_arr.astype(np.int64)]
            sample_weight = (per_sample if sample_weight is None
                             else np.asarray(sample_weight, np.float32)
                             * per_sample)
        if not self._built:
            (first_x, _, _), _ = next(iter(self._batches(
                x, y, batch_size=batch_size, shuffle=False)))
            self.build(tree.tree_map(np.asarray, first_x))

        self.stop_training = False
        history = callbacks_lib.History()
        cbs = list(callbacks or [])
        if verbose:
            cbs.append(callbacks_lib.ProgbarLogger())
        cbs.append(history)
        cb_list = callbacks_lib.CallbackList(
            cbs, self, {"epochs": epochs, "batch_size": batch_size})
        log_intervals = [
            cb.batch_log_interval for cb in cb_list.callbacks
            if type(cb).on_train_batch_end
            is not callbacks_lib.Callback.on_train_batch_end]
        batch_log_every = min(log_intervals) if log_intervals else 0

        cb_list.on_train_begin()
        start_epoch = initial_epoch
        if self._restored_initial_epoch is not None:
            start_epoch = max(start_epoch, self._restored_initial_epoch)
            self._restored_initial_epoch = None

        from distributed_tensorflow_tpu_torch.training.loops import (
            StepTelemetry)
        step_telemetry = StepTelemetry()
        global_step = 0
        for epoch in range(start_epoch, epochs):
            cb_list.on_epoch_begin(epoch)
            mstate = self._metric_init()
            steps = 0
            for batch, full in self._batches(x, y, sample_weight,
                                             batch_size=batch_size,
                                             shuffle=shuffle,
                                             seed=self.seed + epoch):
                cb_t0 = time.perf_counter()
                cb_list.on_train_batch_begin(steps)
                cb_s = time.perf_counter() - cb_t0
                mstate = self._train_step(mstate, self._place(batch), full)
                cb_t0 = time.perf_counter()
                if batch_log_every and steps % batch_log_every == 0:
                    cb_list.on_train_batch_end(
                        steps, self._metric_results(mstate))
                else:
                    cb_list.on_train_batch_end(steps, None)
                cb_s += time.perf_counter() - cb_t0
                step_telemetry.step_completed(
                    global_step, phases={"host": cb_s})
                global_step += 1
                steps += 1
                if steps_per_epoch and steps >= steps_per_epoch:
                    break
                if self.stop_training:
                    break
            logs = self._metric_results(mstate)
            telemetry.event("train.epoch", epoch=epoch,
                            **{k: float(v) for k, v in logs.items()
                               if isinstance(v, (int, float))})
            if validation_data is not None:
                vx, vy = validation_data[0], validation_data[1]
                vsw = (validation_data[2]
                       if len(validation_data) > 2 else None)
                val = self.evaluate(vx, vy, sample_weight=vsw,
                                    batch_size=batch_size, verbose=0,
                                    return_dict=True)
                logs.update({f"val_{k}": v for k, v in val.items()})
            cb_list.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        cb_list.on_train_end()
        self.history = history
        return history

    def evaluate(self, x, y=None, *, batch_size: int = 32,
                 verbose: int = 0, steps: int | None = None,
                 sample_weight=None, return_dict: bool = False):
        """keras ``evaluate``: the loss alone with no metrics, ``[loss,
        metric...]`` otherwise, a dict with ``return_dict``; exact on a
        padded final batch."""
        if not self._compiled or not self._built:
            raise RuntimeError("build+compile the model before evaluate()")
        mstate = self._metric_init()
        count = 0
        for batch, _full in self._batches(x, y, sample_weight,
                                          batch_size=batch_size):
            mstate = self._eval_step(mstate, self._place(batch))
            count += 1
            if steps and count >= steps:
                break
        results = self._metric_results(mstate)
        if verbose:
            print("  ".join(f"{k}={v:.4f}" for k, v in results.items()),
                  flush=True)
        if return_dict:
            return results
        if len(results) == 1:
            return results["loss"]
        return [results["loss"]] + [results[m.name]
                                    for m in self._metrics]

    def predict(self, x, *, batch_size: int = 32) -> Any:
        """keras ``predict`` of an array or of a pre-batched dataset
        (elements bare inputs or ``(x, ...)``); every rank returns every
        row. Each batch is a ``predict.step`` event and a sample of
        ``inference/step_time``."""
        if not self._built:
            raise RuntimeError("build the model before predict()")
        from distributed_tensorflow_tpu_torch.training.loops import (
            StepTelemetry)
        step_telemetry = StepTelemetry(event_name="predict.step",
                                       metric_prefix="inference")
        if isinstance(x, Dataset) or not isinstance(
                x, (np.ndarray, torch.Tensor, list, tuple)):
            batches = (el[0] if isinstance(el, (tuple, list)) else el
                       for el in Dataset.from_iterable(x))
            static = None
        else:
            arr = np.asarray(x)
            batches = (arr[s:s + batch_size]
                       for s in range(0, len(arr), batch_size))
            static = batch_size
        outs = []
        for step, bx in enumerate(batches):
            bx = np.asarray(bx)
            n = len(bx)
            static = static or n
            if n < static:
                bx = np.pad(bx, [(0, static - n)] + [(0, 0)] * (bx.ndim - 1))
            preds = self._predict_step(self._place(bx))
            outs.append(preds.float().cpu().numpy()[:n])
            step_telemetry.step_completed(step, batch_size=n)
        return np.concatenate(outs, axis=0)

    @torch.no_grad()
    def __call__(self, x):
        dev = self.strategy.device
        x = tree.tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(dev)
                          if not isinstance(a, torch.Tensor) else a.to(dev),
                          x)
        return self._apply(self._state["params"],
                           self._state["model_state"], x, train=False)[0]

    # -- weights -----------------------------------------------------------
    @property
    def params(self):
        return self._state["params"]

    def get_weights(self):
        """The parameter tree as numpy (JAX's flax tree), copies."""
        return tree.tree_map(lambda t: t.detach().to("cpu", copy=True)
                             .numpy(), self._state["params"])

    def set_weights(self, weights):
        """Assign a parameter tree of JAX's structure."""
        _assign_tree(self._state["params"], weights, "params")

    def summary(self, print_fn=print):
        """Parameter counts per top-level group."""
        if not self._built:
            raise ValueError("build the model (or fit once) before "
                             "summary()")
        params = self._state["params"]
        rows = [(name, sum(t.numel() for t in tree.tree_leaves(sub)))
                for name, sub in params.items()]
        width = max([len(r[0]) for r in rows] + [10]) + 2
        print_fn(f"Model: {type(self).__name__}")
        print_fn("-" * (width + 14))
        for name, n in rows:
            print_fn(f"{name:<{width}}{n:>12,}")
        total = sum(n for _, n in rows)
        n_state = sum(t.numel() for t in
                      tree.tree_leaves(self._state.get("model_state", {})))
        print_fn("-" * (width + 14))
        print_fn(f"Total params: {total:,}")
        if n_state:
            print_fn(f"Non-trainable state: {n_state:,}")

    def save(self, filepath: str):
        """Architecture + weights to a directory (``keras.models.
        load_model`` reloads it)."""
        from distributed_tensorflow_tpu_torch.training.saving import (
            save_model)
        save_model(self, filepath)

    def _checkpoint_trees(self, **extra):
        from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
            Checkpoint)
        trees = {"params": _detached(self._state["params"])}
        if self._state.get("model_state"):
            trees["model_state"] = _detached(self._state["model_state"])
        return Checkpoint(**trees, **extra)

    def save_weights(self, path: str):
        """Params and non-param model state (BatchNorm's running
        statistics), at JAX's leaf paths."""
        self._checkpoint_trees().write(path)

    def load_weights(self, path: str):
        try:
            restored = self._checkpoint_trees().restore(path)
            has_state = bool(self._state.get("model_state"))
        except KeyError:
            from distributed_tensorflow_tpu_torch.checkpoint.checkpoint \
                import Checkpoint
            restored = Checkpoint(
                params=_detached(self._state["params"])).restore(path)
            has_state = False
        self.set_weights(_unflatten_like(self._state["params"], restored,
                                         "params"))
        if has_state:
            _assign_tree(self._state["model_state"],
                         _unflatten_like(self._state["model_state"],
                                         restored, "model_state"),
                         "model_state")

    # -- backup/restore (BackupAndRestore) ---------------------------------
    def _back_up(self, backup_dir: str, epoch: int):
        self._checkpoint_trees(
            opt_state=self._opt.state_tree(),
            epoch=np.asarray(epoch, np.int64),
        ).write(os.path.join(backup_dir, "backup"))

    def _maybe_restore_backup(self, backup_dir: str):
        path = os.path.join(backup_dir, "backup")
        if not os.path.exists(os.path.join(path, "checkpoint.index.json")):
            return
        template = self._opt.state_tree()
        restored = self._checkpoint_trees(
            opt_state=template, epoch=np.zeros((), np.int64)).restore(path)
        self.set_weights(_unflatten_like(self._state["params"], restored,
                                         "params"))
        if self._state.get("model_state"):
            _assign_tree(self._state["model_state"],
                         _unflatten_like(self._state["model_state"],
                                         restored, "model_state"),
                         "model_state")
        self._opt.load_state_tree(_unflatten_like(template, restored,
                                                  "opt_state"))
        self._restored_initial_epoch = int(restored["epoch"]) + 1


@torch.no_grad()
def _assign_tree(target: dict, values, what: str):
    """Copy ``values`` (a nest of arrays or tensors of ``target``'s
    structure) into ``target``'s tensors in place."""
    if not isinstance(values, dict) or set(values) != set(target):
        raise ValueError(
            f"{what}: keys {sorted(values) if isinstance(values, dict) else values!r} "
            f"!= the model's {sorted(target)}")
    for k, t in target.items():
        if isinstance(t, dict):
            _assign_tree(t, values[k], f"{what}/{k}")
        else:
            v = torch.as_tensor(np.asarray(values[k])) if not isinstance(
                values[k], torch.Tensor) else values[k]
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{what}/{k}: shape {tuple(v.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(v.to(t.dtype))
