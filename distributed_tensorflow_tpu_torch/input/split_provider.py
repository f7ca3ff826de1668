"""FILE-granularity split source for the disaggregated data service.

The port's copy of ``distributed_tensorflow_tpu/input/split_provider.py``: the same
keys, records, decisions and seeded streams, held exactly to the
JAX package's by the CPU tests (``tests/test_torch_*``).

≙ the reference tf.data-service dispatcher's ``SplitProvider`` (SURVEY
L5b): the dispatcher does not ship *data*, it ships **splits** — units
of input work small enough to lease, re-issue and account exactly-once.
Here a split is one FILE of a file-rooted pipeline, the same granule
``Dataset.shard_files`` already shards statically; the provider owns

- the **split universe** of a job (the root file list, one split per
  file, indexed 0..N-1),
- the **deterministic epoch order** (a seed-keyed permutation per
  epoch, so every dispatcher incarnation — including one reformed
  mid-epoch under a new generation — derives the identical assignment
  stream), and
- the **per-split rebuild**: replaying the pipeline's recorded op
  chain (``Dataset.replay_spec``, the FILE auto-shard machinery) over
  a single-file source, so an input worker produces exactly the
  elements the in-process pipeline would have produced for that file.

Two construction paths:

- :meth:`from_dataset` — in-process (tests, the simulated fleet): the
  recorded op-chain closures are replayed directly.
- :meth:`from_factory` — cross-process: op-chain closures do not
  pickle, so remote input workers get a module-level factory
  ``fn(files) -> Dataset`` resolved by reference (the same
  pickle-by-reference contract the supervisor's spawn machinery uses
  for worker fns).
"""

from __future__ import annotations

import random
from typing import Callable, Sequence

from distributed_tensorflow_tpu_torch.input.dataset import Dataset


class SplitProvider:
    """The split universe + per-split pipeline rebuild of one job."""

    def __init__(self, files: Sequence[str],
                 builder: Callable[[Sequence[str]], Dataset], *,
                 seed: int = 0):
        files = list(files)
        if not files:
            raise ValueError("a data-service job needs >= 1 file "
                             "(one FILE split per file)")
        self.files = files
        self.builder = builder
        self.seed = int(seed)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dataset(cls, dataset: Dataset, *, seed: int = 0
                     ) -> "SplitProvider":
        """Derive splits from a file-rooted pipeline's recorded op
        chain — exactly what ``shard_files`` replays, but per FILE
        instead of per worker-index stride."""
        files, reader, chain = dataset.replay_spec()

        def builder(subset):
            ds = Dataset.from_files(list(subset), reader)
            for op in reversed(chain):
                ds = op(ds)
            return ds

        return cls(files, builder, seed=seed)

    @classmethod
    def from_factory(cls, files: Sequence[str],
                     factory: Callable[[Sequence[str]], Dataset], *,
                     seed: int = 0) -> "SplitProvider":
        """Cross-process form: ``factory`` must be module-level
        (picklable by reference) and build the full per-split pipeline
        over a file subset."""
        return cls(files, factory, seed=seed)

    # -- the split universe ------------------------------------------------
    @property
    def num_splits(self) -> int:
        return len(self.files)

    def epoch_order(self, epoch: int) -> "list[int]":
        """The deterministic split permutation of one epoch: a pure
        function of ``(seed, epoch)`` (the resilience/faults.py
        string-seeding discipline — stable across processes and runs),
        so a reformed dispatcher re-derives the identical order and a
        straggler's stale assignment can be recognized for what it is."""
        order = list(range(self.num_splits))
        random.Random(f"dtx-data:{self.seed}:{int(epoch)}").shuffle(order)
        return order

    def build(self, split: int) -> Dataset:
        """The per-split pipeline: the recorded chain over ONE file."""
        if not 0 <= split < self.num_splits:
            raise ValueError(
                f"split {split} out of range [0, {self.num_splits})")
        return self.builder([self.files[split]])

    def elements(self, split: int) -> list:
        """Materialize one split's elements (what an input worker
        publishes). Deterministic given the pipeline: the exactly-once
        contract's unit of delivery."""
        return list(self.build(split))
