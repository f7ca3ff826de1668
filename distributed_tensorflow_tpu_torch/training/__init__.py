"""Training-loop layer of the port: the Keras shim's ``Model``
(``compile`` / ``fit`` / ``evaluate`` / ``predict``), layers, the
functional API, losses, metrics, regularizers, schedules, optimizers,
callbacks, saving and the step loops — port of
``distributed_tensorflow_tpu/training/``. Import the submodule you
use (or ``distributed_tensorflow_tpu_torch.keras``)."""
