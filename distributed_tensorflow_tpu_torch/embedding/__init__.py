"""Embedding API: sharded tables, per-table optimizers, combiners — port
of ``distributed_tensorflow_tpu/embedding`` (``embedding.py``'s names;
the dynamic tables of ``dynamic.py`` are not ported yet)."""

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
