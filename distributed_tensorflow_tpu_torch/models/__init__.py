"""Models: :mod:`transformer` (and BERT on it, :mod:`bert`),
:mod:`resnet`, :mod:`mnist_cnn` and :mod:`wide_deep`."""
