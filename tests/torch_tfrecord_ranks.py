"""Rank function of the TFRecord training tool's parity test. Torch only
(no jax): ``testing.multi_process_runner`` spawns a fresh interpreter
that imports this module by name and runs the tool's training loop on
the CPU (gloo)."""

import importlib.util
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_rank(files, params, global_batch: int, steps: int) -> list:
    spec = importlib.util.spec_from_file_location(
        "torch_train_from_tfrecords",
        os.path.join(ROOT, "tools", "torch_train_from_tfrecords.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    from distributed_tensorflow_tpu_torch.cluster import bootstrap
    try:
        return tool.train(tool.make_config("tiny"), files, global_batch,
                          steps, "cpu", params=params)["losses"]
    finally:
        bootstrap.shutdown()
