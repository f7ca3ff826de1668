"""Input pipelines of the port — port of ``distributed_tensorflow_tpu/
input``: :mod:`dataset` (the tf.data-style ``Dataset`` and its
distributed forms), :mod:`stream` (the append-only event log the online
trainer consumes), :mod:`split_provider` and :mod:`data_service` (the
disaggregated data service: a dispatcher and input workers feeding the
trainer over the coordination KV, each file split exactly once an
epoch), :mod:`native_loader` (the native C++ record and TFRecord
readers), :mod:`example_parser` (tf.Example parsing and encoding) and
:mod:`image_ops` (the JPEG codec and ResNet preprocessing). JAX's
package-level names load on first use."""

from distributed_tensorflow_tpu_torch import lazy_names as _lazy_names

_M = "distributed_tensorflow_tpu_torch.input."

#: package-level name -> the submodule that defines it
_LAZY = {
    **{n: _M + "dataset" for n in (
        "AUTOTUNE", "AutoShardPolicy", "Dataset",
        "DistributedDataset", "InputContext", "InputOptions")},
    **{n: _M + "data_service" for n in (
        "DataInputWorker", "DataServiceClient",
        "DataServiceConfig", "DataServiceDispatcher")},
    "SplitProvider": _M + "split_provider",
    **{n: _M + "stream" for n in (
        "StreamCorruptError", "StreamDataset", "StreamReader",
        "StreamWriter")},
    **{n: _M + "example_parser" for n in (
        "FixedLenFeature", "VarLenFeature", "encode_example",
        "example_reader", "parse_example", "parse_single_example")},
}
#: package-level module names
_LAZY_MODULES = {"image_ops": _M + "image_ops"}

__getattr__, __dir__ = _lazy_names(globals(), _LAZY, _LAZY_MODULES)
