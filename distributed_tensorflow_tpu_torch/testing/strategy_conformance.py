"""Reusable Strategy-API conformance suite — port of
``distributed_tensorflow_tpu/testing/strategy_conformance.py``.

≙ strategy_test_lib.py (reference: tensorflow/python/distribute/
strategy_test_lib.py, "effectively the Strategy API contract"). Any
Strategy of the port, including out-of-tree ones, validates itself:

    class TestMyStrategy(StrategyConformance):
        def make_strategy(self):
            return MyStrategy(...)

Each check is a ``check_*`` method, the same 26 names as JAX's. In the
port a replica is a RANK: under a process group the suite runs inside
every rank (each with its own strategy object, as ``multi_process_
runner`` spawns them), and every collective check needs every rank to
run it, in the same order. :meth:`StrategyConformance.run_checks`
returns which checks passed, which raised ``NotImplementedError`` (an
optional surface of that strategy kind: JAX's ``test_conformance``
swallows them, the port names them) and which failed; ``test_conformance``
asserts that none failed.

Where the rank model changes a check, the check says so: a distributed
dataset yields THIS rank's rows of each global batch (JAX's yields the
global batch, sharded), so the iteration checks gather the rows over the
replicas before comparing.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.parallel.collectives import ReduceOp
from distributed_tensorflow_tpu_torch.parallel.strategy import (
    get_replica_context, get_strategy, has_strategy)
from distributed_tensorflow_tpu_torch.parallel.values import (
    PerReplica,
    VariableAggregation,
    VariableSynchronization,
)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _values(out) -> list:
    return out.values if isinstance(out, PerReplica) else [out]


class StrategyConformance:
    """Subclass and implement ``make_strategy``; pytest collects
    ``test_conformance``."""

    def make_strategy(self):
        raise NotImplementedError

    def _rid(self) -> torch.Tensor:
        """This replica's id as a float scalar on the strategy's device."""
        ctx = get_replica_context()
        return torch.tensor(float(ctx.replica_id_in_sync_group),
                            device=get_strategy().device)

    # -- individual contract checks --------------------------------------

    def check_num_replicas_positive(self, s):
        assert s.num_replicas_in_sync >= 1

    def check_scope_registers_strategy(self, s):
        assert not has_strategy()
        with s.scope():
            assert has_strategy()
            assert get_strategy() is s
        assert not has_strategy()

    def check_variable_creation_in_scope(self, s):
        with s.scope():
            v = s.create_variable(torch.ones((2, 2)), name="w")
        assert tuple(v.shape) == (2, 2)
        np.testing.assert_allclose(_np(v.read_value()), np.ones((2, 2)))
        assert s.extended.variable_created_in_scope(v)

    def check_run_executes_per_replica(self, s):
        n = s.num_replicas_in_sync

        def fn():
            return get_replica_context().replica_id_in_sync_group

        ids = sorted(int(x) for x in _values(s.run(fn)))
        assert ids == list(range(n)), ids

    def check_all_reduce_sums_across_replicas(self, s):
        n = s.num_replicas_in_sync

        def fn():
            return get_replica_context().all_reduce(
                ReduceOp.SUM, torch.tensor(1.0, device=s.device))

        vals = _values(s.run(fn))
        for v in vals:
            assert float(_np(v).squeeze()) == float(n), vals

    def check_reduce_mean(self, s):
        out = s.run(lambda: self._rid() + 1.0)
        red = s.reduce(ReduceOp.MEAN, out, axis=None)
        n = s.num_replicas_in_sync
        np.testing.assert_allclose(float(_np(red)), (n + 1) / 2, rtol=1e-6)

    def check_variable_update_visible_after_run(self, s):
        with s.scope():
            v = s.create_variable(torch.zeros(()), name="counter")

        def fn():
            v.assign_add(1.0)

        s.run(fn)
        # on-write mirrored variables aggregate identical updates
        np.testing.assert_allclose(float(_np(v.read_value())), 1.0)

    def check_experimental_distribute_values(self, s):
        n = s.num_replicas_in_sync
        vals = s.experimental_distribute_values_from_function(
            lambda ctx: float(ctx.replica_id_in_sync_group))
        assert isinstance(vals, PerReplica)
        assert [float(x) for x in vals.values] == [float(i)
                                                   for i in range(n)]

    def check_gather(self, s):
        out = s.run(lambda: self._rid().reshape(1))
        gathered = s.gather(out, axis=0)
        assert gathered.shape[0] == s.num_replicas_in_sync

    # -- nested scope (≙ strategy_test_lib nested-scope contract) ---------

    def check_nested_scope_restores_outer(self, s):
        s2 = self.make_strategy()
        with s.scope():
            assert get_strategy() is s
            with s2.scope():
                assert get_strategy() is s2
            assert get_strategy() is s
        assert not has_strategy()

    def check_scope_reentrant(self, s):
        with s.scope():
            with s.scope():
                assert get_strategy() is s
            assert get_strategy() is s

    # -- VariableAggregation write matrix (≙ values.py OnWrite) -----------

    def check_on_write_aggregation_mean(self, s):
        n = s.num_replicas_in_sync
        with s.scope():
            v = s.create_variable(torch.zeros(()), name="m",
                                  aggregation=VariableAggregation.MEAN)
        s.run(lambda: v.assign(self._rid()))
        np.testing.assert_allclose(float(_np(v.read_value())),
                                   (n - 1) / 2, rtol=1e-6)

    def check_on_write_aggregation_sum(self, s):
        n = s.num_replicas_in_sync
        with s.scope():
            v = s.create_variable(torch.zeros(()), name="sm",
                                  aggregation=VariableAggregation.SUM)
        s.run(lambda: v.assign(self._rid() + 1.0))
        np.testing.assert_allclose(float(_np(v.read_value())),
                                   n * (n + 1) / 2, rtol=1e-6)

    def check_on_write_aggregation_only_first_replica(self, s):
        with s.scope():
            v = s.create_variable(
                torch.zeros(()), name="f",
                aggregation=VariableAggregation.ONLY_FIRST_REPLICA)
        s.run(lambda: v.assign(self._rid() + 7.0))
        # replica 0's write wins everywhere
        np.testing.assert_allclose(float(_np(v.read_value())), 7.0)

    def check_sync_on_read_sum(self, s):
        n = s.num_replicas_in_sync
        with s.scope():
            v = s.create_variable(
                torch.zeros(()), name="metric",
                synchronization=VariableSynchronization.ON_READ,
                aggregation=VariableAggregation.SUM)
        s.run(lambda: v.assign_add(torch.tensor(1.0, device=s.device)))
        # each replica accumulated locally; the global read sums
        np.testing.assert_allclose(float(_np(v.read_value())), float(n))

    def check_sync_on_read_accumulates_across_runs(self, s):
        n = s.num_replicas_in_sync
        with s.scope():
            v = s.create_variable(
                torch.zeros(()), name="metric2",
                synchronization=VariableSynchronization.ON_READ,
                aggregation=VariableAggregation.SUM)

        def fn():
            v.assign_add(torch.tensor(1.0, device=s.device))

        s.run(fn)
        s.run(fn)
        np.testing.assert_allclose(float(_np(v.read_value())), 2.0 * n)

    # -- input iteration through the strategy ------------------------------

    def check_distribute_dataset_iteration(self, s):
        """Each rank gets its rows of each global batch; gathered over
        the replicas they are the global batch (JAX's iterator yields
        the global batch itself)."""
        from distributed_tensorflow_tpu_torch.input.dataset import Dataset
        n = s.num_replicas_in_sync
        data = np.arange(4 * n * 2, dtype=np.float32).reshape(4 * n, 2)
        ds = Dataset.from_tensor_slices(data).batch(n)
        seen = []
        for batch in s.experimental_distribute_dataset(ds):
            assert tuple(batch.shape) == (1, 2), batch.shape
            seen.append(_np(s.gather(s.run(lambda b: b, args=(batch,)),
                                     axis=0)))
        np.testing.assert_allclose(np.concatenate(seen, axis=0), data)

    def check_distributed_batch_feeds_run(self, s):
        from distributed_tensorflow_tpu_torch.input.dataset import Dataset
        n = s.num_replicas_in_sync
        data = np.ones((2 * n, 3), np.float32)
        dist = s.experimental_distribute_dataset(
            Dataset.from_tensor_slices(data).batch(n))
        batch = next(iter(dist))

        def fn(b):
            return get_replica_context().all_reduce(ReduceOp.SUM, b.sum())

        vals = _values(s.run(fn, args=(batch,)))
        np.testing.assert_allclose(float(_np(vals[0])), 3.0 * n)

    def check_distribute_values_feed_run(self, s):
        n = s.num_replicas_in_sync
        vals = s.experimental_distribute_values_from_function(
            lambda ctx: np.asarray([float(ctx.replica_id_in_sync_group)],
                                   np.float32))
        out = s.run(lambda x: x * 2.0, args=(vals,))
        got = sorted(float(_np(v).ravel()[0]) for v in out.values)
        assert got == [2.0 * i for i in range(n)], got

    # -- merge_call / optimizer pattern -------------------------------------

    def check_merge_call_reduces(self, s):
        n = s.num_replicas_in_sync

        def fn():
            grad = self._rid() + 1.0

            def merge(strategy, g):
                return strategy.extended.reduce_to(ReduceOp.SUM, g)

            return get_replica_context().merge_call(merge, args=(grad,))

        for v in _values(s.run(fn)):
            np.testing.assert_allclose(float(_np(v)), n * (n + 1) / 2,
                                       rtol=1e-6)

    def check_merge_call_optimizer_apply(self, s):
        """The classic optimizer shape: per-replica grads -> merge_call
        reduces -> extended.update applies once to the variable."""
        n = s.num_replicas_in_sync
        with s.scope():
            v = s.create_variable(torch.tensor(10.0), name="w")

        def fn():
            grad = self._rid() + 1.0          # mean = (n+1)/2

            def merge(strategy, g):
                g = strategy.extended.reduce_to(ReduceOp.MEAN, g)
                strategy.extended.update(
                    v, lambda var, gg: var.assign_sub(gg), args=(g,))

            get_replica_context().merge_call(merge, args=(grad,))

        s.run(fn)
        np.testing.assert_allclose(float(_np(v.read_value())),
                                   10.0 - (n + 1) / 2, rtol=1e-6)

    # -- replica collectives beyond all_reduce ----------------------------

    def check_all_gather_in_replica_context(self, s):
        n = s.num_replicas_in_sync

        def fn():
            return get_replica_context().all_gather(self._rid().reshape(1),
                                                    axis=0)

        vals = _values(s.run(fn))
        np.testing.assert_allclose(np.sort(_np(vals[0]).ravel()),
                                   np.arange(n, dtype=np.float32))

    def check_gather_preserves_replica_order(self, s):
        n = s.num_replicas_in_sync
        out = s.run(lambda: self._rid().reshape(1))
        gathered = _np(s.gather(out, axis=0)).ravel()
        np.testing.assert_allclose(gathered, np.arange(n, dtype=np.float32))

    def check_reduce_with_axis(self, s):
        out = s.run(lambda: torch.tensor([1.0, 3.0], device=s.device))
        red = s.reduce(ReduceOp.MEAN, out, axis=0)
        np.testing.assert_allclose(float(_np(red)), 2.0, rtol=1e-6)

    def check_run_twice_consistent(self, s):
        """Repeated runs must not corrupt each other's writes."""
        with s.scope():
            v = s.create_variable(torch.zeros(()), name="c2")

        def fn():
            v.assign_add(1.0)

        s.run(fn)
        s.run(fn)
        np.testing.assert_allclose(float(_np(v.read_value())), 2.0)

    def check_value_context_fields(self, s):
        n = s.num_replicas_in_sync
        seen = []
        s.experimental_distribute_values_from_function(
            lambda ctx: seen.append((ctx.replica_id_in_sync_group,
                                     ctx.num_replicas_in_sync)))
        assert seen == [(i, n) for i in range(n)], seen

    # -- entry points -------------------------------------------------------

    @classmethod
    def contract_checks(cls) -> list:
        return sorted(m for m in dir(cls) if m.startswith("check_"))

    def run_checks(self) -> dict:
        """Every check on a fresh strategy each, in sorted order (every
        rank the same): ``{"passed": [...], "not_implemented": [...],
        "failures": ["check: error", ...]}``."""
        out = {"passed": [], "not_implemented": [], "failures": []}
        for name in self.contract_checks():
            s = self.make_strategy()
            try:
                getattr(self, name)(s)
            except NotImplementedError:
                out["not_implemented"].append(name)
            except AssertionError as e:
                out["failures"].append(f"{name}: {e}")
            except Exception as e:  # noqa: BLE001 - report, keep going
                out["failures"].append(f"{name}: {type(e).__name__}: {e}")
            else:
                out["passed"].append(name)
        return out

    def test_conformance(self):
        failures = self.run_checks()["failures"]
        assert not failures, ("strategy contract violations:\n  "
                              + "\n  ".join(failures))


#: the port's built-in strategies the suite runs over, by name
BUILTIN = ("OneDevice", "Mirrored", "MultiWorker", "CentralStorage",
           "ParameterServerV1", "ParameterServerV2")


def builtin_strategy(kind: str, device="cuda"):
    """A fresh built-in strategy of ``kind`` (:data:`BUILTIN`) on
    ``device`` ("cuda": this rank's card; "cpu"), over the initialised
    process group's ranks where the kind spans them."""
    from distributed_tensorflow_tpu_torch.parallel import (
        central_storage, mirrored, multi_worker, one_device,
        parameter_server)
    if kind == "OneDevice":
        return one_device.OneDeviceStrategy(
            device if device == "cpu" else None)
    if kind == "Mirrored":
        return mirrored.MirroredStrategy(
            devices=["cpu"] if device == "cpu" else None)
    kw = {"device": "cpu"} if device == "cpu" else {}
    if kind == "MultiWorker":
        return multi_worker.MultiWorkerMirroredStrategy(**kw)
    if kind == "CentralStorage":
        return central_storage.CentralStorageStrategy(**kw)
    if kind == "ParameterServerV1":
        return parameter_server.ParameterServerStrategyV1(**kw)
    if kind == "ParameterServerV2":
        return parameter_server.ParameterServerStrategy(**kw)
    raise ValueError(f"kind={kind!r}; expected one of {BUILTIN}")


def check_builtin(kinds=BUILTIN, device="cuda") -> dict:
    """:meth:`StrategyConformance.run_checks` of each built-in ``kind``
    in turn (under a process group every rank runs the same kinds):
    ``{kind: {"passed", "not_implemented", "failures"}}``."""
    out = {}
    for kind in kinds:
        class Suite(StrategyConformance):
            def make_strategy(self):
                return builtin_strategy(kind, device)
        out[kind] = Suite().run_checks()
    return out
