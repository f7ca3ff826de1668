"""Embedding API: sharded tables, per-table optimizers, combiners — port
of ``distributed_tensorflow_tpu/embedding``: ``embedding.py``'s names,
and the dynamic tables of ``dynamic.py`` (``DynamicTable``,
``DynamicTableConfig``, ``StaticHashTable``, ``CountMinSketch``), which
load on first use."""

from distributed_tensorflow_tpu_torch.embedding.embedding import (  # noqa: F401
    Adagrad,
    Adam,
    FTRL,
    FeatureConfig,
    SGD,
    TableConfig,
    TPUEmbedding,
    apply_gradients,
    create_state,
    lookup,
    state_from_jax,
)

from distributed_tensorflow_tpu_torch import lazy_names as _lazy_names  # noqa: E402

_LAZY = {n: "distributed_tensorflow_tpu_torch.embedding.dynamic" for n in (
    "CountMinSketch", "DynamicTable", "DynamicTableConfig",
    "StaticHashTable")}
__getattr__, __dir__ = _lazy_names(globals(), _LAZY)
