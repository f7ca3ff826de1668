"""Utilities of the port: :mod:`tree` (nested-container helpers with
``jax.tree_util``'s leaf order), :mod:`summary` (TensorBoard event
files and monitoring gauges) and :mod:`profiler` (input-pipeline stage
counters). Import the submodule you use."""
