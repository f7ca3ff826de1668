"""tf.keras.layers-shaped layers in torch — port of
``distributed_tensorflow_tpu/training/layers.py``.

Every layer keeps JAX's constructor signature (so ``get_config`` and a
saved model's JSON config are JAX's) and JAX's flax parameter layout
and names: a layer's ``apply(x, train=, scope=)`` creates or reads its
parameters through a :class:`~distributed_tensorflow_tpu_torch.
training.model.Scope`, which names submodules as flax's compact
modules do (``Dense_0``, ``Conv_1``, ``BatchNorm_0``; the MHA's
``query`` / ``key`` / ``value`` / ``attention_output``). So a model's
``get_weights()`` is the JAX model's tree — Dense ``(in, out)``, Conv
``(kh, kw, in, out)``, the MHA kernels ``(D, H, hd)`` / ``(H, hd, D)``,
the LSTM gates ``[i, f, c, o]`` — and ``set_weights`` takes it.

Activations are NHWC / ``(B, T, D)`` as JAX's, so ``Flatten`` flattens
in NHWC order. Convolutions and pools with flax's ``"SAME"`` pad
explicitly (asymmetric at stride 2, ``models/layers.py``); max pools pad
with −inf, average pools leave the pad out of the count (keras's
``count_include_pad=False``). ``BatchNormalization`` has flax's
semantics at Keras defaults (momentum 0.99, epsilon 1e-3; variance
``E[x²] − E[x]²``); on several replicas its statistics are the global
batch's (the mean and mean square all-reduced over the data dims,
gradient included). Dropout masks come from a ``torch.Generator``
seeded by the model seed, step, replica, call and the layer's own seed
(JAX draws from ``jax.random``; the masks differ). Initialisers are
flax's families (lecun normal, zeros, glorot uniform, orthogonal,
unit forget bias) drawn from the port's generator; parity with JAX goes
through ``set_weights``.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from distributed_tensorflow_tpu_torch.models.layers import (
    lecun_normal_, same_pads)
from distributed_tensorflow_tpu_torch.training import regularizers as reg_lib
from distributed_tensorflow_tpu_torch.training.model import Model


# ---------------------------------------------------------------------------
# Initialisers (flax's families): init(shape, generator) -> CPU tensor
# ---------------------------------------------------------------------------

def lecun_normal(in_dims: int = -1):
    """flax's ``lecun_normal``; the fan-in is the product of the
    shape's first ``in_dims`` dims (default all but the last: a Dense or
    Conv kernel; 1 and 2 for the MHA's input and output kernels, as
    flax's ``DenseGeneral`` flattens them)."""
    def init(shape, gen):
        fan_in = math.prod(shape[:in_dims])
        return lecun_normal_(torch.empty(shape), fan_in, gen)
    return init


def zeros(shape, gen):
    return torch.zeros(shape)


def ones(shape, gen):
    return torch.ones(shape)


def glorot_uniform(shape, gen):
    t = torch.empty(shape)
    torch.nn.init.xavier_uniform_(t.T, generator=gen)
    return t


def orthogonal(shape, gen):
    t = torch.empty(shape)
    torch.nn.init.orthogonal_(t, generator=gen)
    return t


def embed_normal(shape, gen):
    """flax's ``default_embed_init``: normal of variance 1/features."""
    return torch.randn(shape, generator=gen) / math.sqrt(shape[-1])


_ACTIVATIONS = {
    None: lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "silu": F.silu,
    "swish": F.silu,
    "elu": F.elu,
    # the activation's slope is 0.2; the LeakyReLU layer's default 0.3
    "leaky_relu": lambda x: F.leaky_relu(x, 0.2),
    "softplus": F.softplus,
    "exponential": torch.exp,
}


def _activation(identifier) -> Callable:
    if callable(identifier):
        return identifier
    try:
        return _ACTIVATIONS[identifier]
    except KeyError:
        raise ValueError(
            f"Unknown activation {identifier!r}; known: "
            f"{sorted(k for k in _ACTIVATIONS if k)}") from None


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _single(v):
    return (v,) if isinstance(v, int) else tuple(v)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _pad_same(x, kernel, stride, value=0.0):
    """``x`` (N, C, *spatial) padded as flax's ``"SAME"``."""
    pads = []
    for size, k, s in reversed(list(zip(x.shape[2:], kernel, stride))):
        pads += list(same_pads(size, k, s))
    return F.pad(x, pads, value=value) if any(pads) else x


def _conv(x, kernel, bias, strides, padding, groups=1):
    """flax ``nn.Conv`` on a channels-last ``x``; ``kernel`` in flax's
    layout ``(*window, in/groups, out)``."""
    nd = kernel.ndim - 2
    xc = x.movedim(-1, 1)
    w = kernel.permute(nd + 1, nd, *range(nd))
    if padding == "SAME":
        xc = _pad_same(xc, kernel.shape[:nd], strides)
    conv = F.conv2d if nd == 2 else F.conv1d
    y = conv(xc, w, None, strides, groups=groups).movedim(1, -1)
    return y + bias if bias is not None else y


def _pool(x, window, strides, padding, kind):
    nd = len(window)
    xc = x.movedim(-1, 1)
    if kind == "max":
        if padding == "SAME":
            xc = _pad_same(xc, window, strides, float("-inf"))
        pool = F.max_pool2d if nd == 2 else F.max_pool1d
        return pool(xc, window, strides).movedim(1, -1)
    pool = F.avg_pool2d if nd == 2 else F.avg_pool1d
    if padding != "SAME":
        return pool(xc, window, strides).movedim(1, -1)
    # the pad left out of each window's count (count_include_pad=False)
    ones_ = torch.ones_like(xc[:1, :1])
    total = pool(_pad_same(xc, window, strides), window, strides)
    count = pool(_pad_same(ones_, window, strides), window, strides)
    return (total / count).movedim(1, -1)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

class Layer:
    """Base layer: a configuration whose ``apply(x, train=, scope=)``
    computes the layer in ``scope`` (its parameters' home). Calling a
    layer on symbolic tensors (``keras.Input``) records a node of the
    functional graph."""

    has_train_behavior = False

    @property
    def symbolic_outputs(self) -> int:
        """Outputs of a symbolic call (RNNs with ``return_state``)."""
        return 1

    def apply(self, x, *, train: bool, scope=None):
        raise NotImplementedError

    def __call__(self, *args):
        from distributed_tensorflow_tpu_torch.training.functional import (
            is_symbolic, symbolic_call)
        call_args = args[0] if len(args) == 1 else tuple(args)
        if is_symbolic(call_args):
            return symbolic_call(self, call_args)
        raise TypeError(
            f"{type(self).__name__} called on concrete values; layers are "
            "callable only on symbolic tensors (keras.Input) to build "
            "functional models — for eager use put the layer in a "
            "Sequential/Model and call that")

    def compute_input_shape(self):
        return getattr(self, "input_shape", None)

    def get_config(self) -> dict:
        """Constructor kwargs from the signature (JAX's rule: every
        layer stores its args under the parameter name; ``activation``
        serializes its string identifier)."""
        cfg = {}
        params = inspect.signature(type(self).__init__).parameters
        for name, p in params.items():
            if name == "self" or p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
                continue
            key = "activation_id" if name == "activation" else name
            if not hasattr(self, key):
                raise ValueError(
                    f"{type(self).__name__} cannot serialize constructor "
                    f"param {name!r} (no matching attribute)")
            v = getattr(self, key)
            if isinstance(v, reg_lib.Regularizer):
                v = reg_lib.serialize(v)
            elif callable(v) and not isinstance(v, str):
                raise ValueError(
                    f"{type(self).__name__}.{name} is a Python callable; "
                    "only string-identified values are serializable")
            cfg[name] = list(v) if isinstance(v, tuple) else v
        return cfg

    def _reg(self, scope, kernel, bias=None):
        """Record this layer's weight penalties, once a weight however
        often the layer is called."""
        kr = getattr(self, "kernel_regularizer", None)
        br = getattr(self, "bias_regularizer", None)
        if kr is not None:
            scope.frame.reg[f"reg_{id(self)}_k"] = kr(kernel)
        if br is not None and bias is not None:
            scope.frame.reg[f"reg_{id(self)}_b"] = br(bias)

    @classmethod
    def from_config(cls, config: dict):
        return cls(**config)


class InputLayer(Layer):
    """Records the per-sample input shape so Sequential builds
    eagerly."""

    def __init__(self, input_shape=None, *, shape=None):
        shape = shape if shape is not None else input_shape
        if shape is None:
            raise ValueError("InputLayer requires a shape")
        self.input_shape = tuple(shape)

    def apply(self, x, *, train, scope=None):
        return x

    def get_config(self):
        return {"input_shape": list(self.input_shape)}


class Dense(Layer):
    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 kernel_regularizer=None, bias_regularizer=None,
                 input_shape=None, name: str | None = None):
        self.units = int(units)
        self.activation = _activation(activation)
        self.activation_id = activation
        self.use_bias = use_bias
        self.kernel_regularizer = reg_lib.get(kernel_regularizer)
        self.bias_regularizer = reg_lib.get(bias_regularizer)
        self.input_shape = tuple(input_shape) if input_shape else None
        self.name = name

    def apply(self, x, *, train, scope=None):
        s = scope.child("Dense", self.name)
        k = s.param("kernel", (x.shape[-1], self.units), lecun_normal())
        y = x.to(k.dtype) @ k
        b = None
        if self.use_bias:
            b = s.param("bias", (self.units,), zeros)
            y = y + b
        self._reg(scope, k, b)
        return self.activation(y)


class Conv2D(Layer):
    def __init__(self, filters: int, kernel_size, strides=1,
                 padding: str = "valid", activation=None,
                 use_bias: bool = True, kernel_regularizer=None,
                 bias_regularizer=None, input_shape=None,
                 name: str | None = None):
        self.filters = int(filters)
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding.upper()
        self.activation = _activation(activation)
        self.activation_id = activation
        self.use_bias = use_bias
        self.kernel_regularizer = reg_lib.get(kernel_regularizer)
        self.bias_regularizer = reg_lib.get(bias_regularizer)
        self.input_shape = tuple(input_shape) if input_shape else None
        self.name = name

    def apply(self, x, *, train, scope=None):
        s = scope.child("Conv", self.name)
        k = s.param("kernel", (*self.kernel_size, x.shape[-1], self.filters),
                    lecun_normal())
        b = s.param("bias", (self.filters,), zeros) if self.use_bias \
            else None
        y = _conv(x.to(k.dtype), k, b, self.strides, self.padding)
        self._reg(scope, k, b)
        return self.activation(y)


class Conv1D(Layer):
    def __init__(self, filters: int, kernel_size, strides=1,
                 padding: str = "valid", activation=None,
                 use_bias: bool = True, input_shape=None,
                 name: str | None = None):
        self.filters = int(filters)
        self.kernel_size = _single(kernel_size)
        self.strides = _single(strides)
        self.padding = padding.upper()
        self.activation = _activation(activation)
        self.activation_id = activation
        self.use_bias = use_bias
        self.input_shape = tuple(input_shape) if input_shape else None
        self.name = name

    def apply(self, x, *, train, scope=None):
        s = scope.child("Conv", self.name)
        k = s.param("kernel", (*self.kernel_size, x.shape[-1], self.filters),
                    lecun_normal())
        b = s.param("bias", (self.filters,), zeros) if self.use_bias \
            else None
        return self.activation(_conv(x.to(k.dtype), k, b, self.strides,
                                     self.padding))


class DepthwiseConv2D(Layer):
    """One filter per input channel; kernel in keras's layout
    ``(H, W, Cin, 1)`` (JAX's ``_DepthwiseModule``)."""

    def __init__(self, kernel_size, strides=1, padding: str = "valid",
                 activation=None, use_bias: bool = True,
                 name: str | None = None):
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding.upper()
        self.activation = _activation(activation)
        self.activation_id = activation
        self.use_bias = use_bias
        self.name = name

    def apply(self, x, *, train, scope=None):
        s = scope.child("_DepthwiseModule", self.name)
        cin = x.shape[-1]
        k = s.param("kernel", (*self.kernel_size, cin, 1), lecun_normal())
        b = s.param("bias", (cin,), zeros) if self.use_bias else None
        y = _conv(x.to(k.dtype), k.transpose(2, 3), b, self.strides,
                  self.padding, groups=cin)
        return self.activation(y)


class UpSampling2D(Layer):
    def __init__(self, size=2, interpolation: str = "nearest"):
        self.size = _pair(size)
        if interpolation != "nearest":
            raise NotImplementedError(
                "UpSampling2D supports interpolation='nearest'")
        self.interpolation = interpolation

    def apply(self, x, *, train, scope=None):
        sh, sw = self.size
        return x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2)


class Permute(Layer):
    """1-indexed dims over the non-batch axes."""

    def __init__(self, dims):
        self.dims = tuple(int(d) for d in dims)

    def apply(self, x, *, train, scope=None):
        return x.permute((0,) + self.dims)


class Lambda(Layer):
    """An arbitrary stateless function; not serializable."""

    def __init__(self, function):
        self.function = function

    def apply(self, x, *, train, scope=None):
        return self.function(x)

    def get_config(self):
        raise ValueError(
            "Lambda layers are not serializable; rebuild the model in "
            "code and use load_weights")


class MaxPooling2D(Layer):
    def __init__(self, pool_size=2, strides=None, padding: str = "valid"):
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None \
            else self.pool_size
        self.padding = padding.upper()

    def apply(self, x, *, train, scope=None):
        return _pool(x, self.pool_size, self.strides, self.padding, "max")


class MaxPooling1D(Layer):
    def __init__(self, pool_size=2, strides=None, padding: str = "valid"):
        self.pool_size = _single(pool_size)
        self.strides = _single(strides) if strides is not None \
            else self.pool_size
        self.padding = padding.upper()

    def apply(self, x, *, train, scope=None):
        return _pool(x, self.pool_size, self.strides, self.padding, "max")


class AveragePooling1D(MaxPooling1D):
    def apply(self, x, *, train, scope=None):
        return _pool(x, self.pool_size, self.strides, self.padding, "avg")


class AveragePooling2D(MaxPooling2D):
    def apply(self, x, *, train, scope=None):
        return _pool(x, self.pool_size, self.strides, self.padding, "avg")


class GlobalAveragePooling2D(Layer):
    def apply(self, x, *, train, scope=None):
        return x.mean(dim=(1, 2))


class GlobalAveragePooling1D(Layer):
    def apply(self, x, *, train, scope=None):
        return x.mean(dim=1)


class GlobalMaxPooling2D(Layer):
    def apply(self, x, *, train, scope=None):
        return x.amax(dim=(1, 2))


class GlobalMaxPooling1D(Layer):
    def apply(self, x, *, train, scope=None):
        return x.amax(dim=1)


class Flatten(Layer):
    def apply(self, x, *, train, scope=None):
        return x.reshape(x.shape[0], -1)


def _dropout(x, rate: float, scope, layer_seed):
    keep = scope.frame.dropout_keep(x.shape, rate, layer_seed)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dropout(Layer):
    has_train_behavior = True

    def __init__(self, rate: float, seed: int | None = None):
        self.rate = float(rate)
        self.seed = seed

    def apply(self, x, *, train, scope=None):
        if not train or self.rate == 0.0:
            return x
        return _dropout(x, self.rate, scope, self.seed)


class BatchNormalization(Layer):
    """flax ``nn.BatchNorm`` over the last axis; the running averages in
    the ``batch_stats`` collection (the Model's ``model_state``)."""
    has_train_behavior = True

    def __init__(self, momentum: float = 0.99, epsilon: float = 1e-3,
                 name: str | None = None):
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.name = name

    def apply(self, x, *, train, scope=None):
        s = scope.child("BatchNorm", self.name)
        c = x.shape[-1]
        ra_mean = s.variable("batch_stats", "mean", (c,), zeros)
        ra_var = s.variable("batch_stats", "var", (c,), ones)
        scale = s.param("scale", (c,), ones)
        bias = s.param("bias", (c,), zeros)
        if not train:
            mean, var = ra_mean, ra_var
        else:
            axes = tuple(range(x.ndim - 1))
            xf = x.float()
            stats = torch.stack([xf.mean(dim=axes),
                                 xf.square().mean(dim=axes)])
            if s.frame.stats_sync is not None:
                stats = s.frame.stats_sync(stats)
            mean = stats[0]
            var = (stats[1] - mean.square()).clamp_min(0.0)
            if not s.frame.init:
                m = self.momentum
                s.update("batch_stats", "mean",
                         m * ra_mean + (1 - m) * mean.detach())
                s.update("batch_stats", "var",
                         m * ra_var + (1 - m) * var.detach())
        y = (x - mean) * (torch.rsqrt(var + self.epsilon) * scale)
        return y + bias


class LayerNormalization(Layer):
    def __init__(self, epsilon: float = 1e-3, name: str | None = None):
        self.epsilon = float(epsilon)
        self.name = name

    def apply(self, x, *, train, scope=None):
        s = scope.child("LayerNorm", self.name)
        d = x.shape[-1]
        scale = s.param("scale", (d,), ones)
        bias = s.param("bias", (d,), zeros)
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x.square().mean(dim=-1, keepdim=True) - mean.square())
               .clamp_min(0.0))
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * scale) + bias


class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int, input_shape=None,
                 name: str | None = None):
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.input_shape = tuple(input_shape) if input_shape else None
        self.name = name

    def apply(self, x, *, train, scope=None):
        s = scope.child("Embed", self.name)
        table = s.param("embedding", (self.input_dim, self.output_dim),
                        embed_normal)
        return table[x.long()]


class ReLU(Layer):
    def apply(self, x, *, train, scope=None):
        return torch.relu(x)


class LeakyReLU(Layer):
    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)

    def apply(self, x, *, train, scope=None):
        return F.leaky_relu(x, self.alpha)


class ELU(Layer):
    def __init__(self, alpha: float = 1.0):
        self.alpha = float(alpha)

    def apply(self, x, *, train, scope=None):
        return F.elu(x, alpha=self.alpha)


class Softmax(Layer):
    def apply(self, x, *, train, scope=None):
        return torch.softmax(x, dim=-1)


class Activation(Layer):
    def __init__(self, activation):
        self.activation = _activation(activation)
        self.activation_id = activation

    def apply(self, x, *, train, scope=None):
        return self.activation(x)


class Add(Layer):
    def apply(self, x, *, train, scope=None):
        if not isinstance(x, (list, tuple)) or len(x) < 2:
            raise ValueError("Add expects a list of >= 2 tensors")
        out = x[0]
        for t in x[1:]:
            out = out + t
        return out


class Multiply(Layer):
    def apply(self, x, *, train, scope=None):
        if not isinstance(x, (list, tuple)) or len(x) < 2:
            raise ValueError("Multiply expects a list of >= 2 tensors")
        out = x[0]
        for t in x[1:]:
            out = out * t
        return out


class Concatenate(Layer):
    def __init__(self, axis: int = -1):
        self.axis = axis

    def apply(self, x, *, train, scope=None):
        if not isinstance(x, (list, tuple)) or len(x) < 2:
            raise ValueError("Concatenate expects a list of >= 2 tensors")
        return torch.cat(list(x), dim=self.axis)


class ZeroPadding2D(Layer):
    """NHWC zero padding."""

    def __init__(self, padding=1):
        if isinstance(padding, int):
            pads = ((padding, padding), (padding, padding))
        else:
            pads = tuple(_pair(p) for p in padding)
        self.padding = pads

    def apply(self, x, *, train, scope=None):
        (t, b), (l, r) = self.padding
        return F.pad(x, (0, 0, l, r, t, b))


class Reshape(Layer):
    def __init__(self, target_shape):
        self.target_shape = tuple(target_shape)

    def apply(self, x, *, train, scope=None):
        return x.reshape(x.shape[0], *self.target_shape)


class MultiHeadAttention(Layer):
    """keras MHA with keras's weight layout (query/key/value kernels
    ``(D_in, heads, key_dim)``, output kernel ``(heads, key_dim,
    D_out)``): an einsum, a softmax (dropout on the probabilities in
    training) and an einsum, as JAX's (no flash kernel). Call
    ``mha(query, value)`` or ``mha(query, value, key)``."""
    has_train_behavior = True

    def __init__(self, num_heads: int, key_dim: int, dropout: float = 0.0,
                 use_bias: bool = True, output_shape=None,
                 name: str | None = None):
        self.num_heads = int(num_heads)
        self.key_dim = int(key_dim)
        self.dropout = float(dropout)
        self.use_bias = use_bias
        self.output_shape = output_shape
        self.name = name

    def apply(self, x, *, train, scope=None):
        if isinstance(x, (list, tuple)):
            q, v = x[0], x[1]
            k = x[2] if len(x) > 2 else v
        else:
            q = v = k = x
        H, hd = self.num_heads, self.key_dim
        out_dim = self.output_shape or q.shape[-1]

        def heads_proj(name, t):
            s = scope.child("DenseGeneral", name)
            w = s.param("kernel", (t.shape[-1], H, hd), lecun_normal(1))
            y = torch.einsum("bsd,dhk->bshk", t, w)
            if self.use_bias:
                y = y + s.param("bias", (H, hd), zeros)
            return y

        qh = heads_proj("query", q)
        kh = heads_proj("key", k)
        vh = heads_proj("value", v)
        scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1)
        if train and self.dropout > 0.0:
            probs = _dropout(probs, self.dropout, scope, None)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
        s = scope.child("DenseGeneral", "attention_output")
        w = s.param("kernel", (H, hd, out_dim), lecun_normal(2))
        y = torch.einsum("bqhd,hdo->bqo", o, w)
        if self.use_bias:
            y = y + s.param("bias", (out_dim,), zeros)
        return y


def _lstm_bias(units: int, unit_forget_bias: bool):
    def init(shape, gen):
        b = torch.zeros(shape)
        if unit_forget_bias:
            b[units:2 * units] = 1.0
        return b
    return init


class LSTM(Layer):
    """keras LSTM, keras's layout: ``kernel`` (D, 4H),
    ``recurrent_kernel`` (H, 4H), ``bias`` (4H,), gates ``[i, f, c,
    o]``, forget bias starting at 1."""

    def __init__(self, units: int, return_sequences: bool = False,
                 return_state: bool = False, use_bias: bool = True,
                 unit_forget_bias: bool = True, name: str | None = None):
        self.units = int(units)
        self.return_sequences = return_sequences
        self.return_state = return_state
        self.use_bias = use_bias
        self.unit_forget_bias = unit_forget_bias
        self.name = name

    @property
    def symbolic_outputs(self):
        return 3 if self.return_state else 1

    def apply(self, x, *, train, scope=None):
        s = scope.child("_LSTMModule", self.name)
        B, T, D = x.shape
        H = self.units
        kernel = s.param("kernel", (D, 4 * H), glorot_uniform)
        rec = s.param("recurrent_kernel", (H, 4 * H), orthogonal)
        xz = torch.einsum("btd,dh->bth", x, kernel)
        if self.use_bias:
            xz = xz + s.param("bias", (4 * H,),
                              _lstm_bias(H, self.unit_forget_bias))
        h = c = xz.new_zeros((B, H))
        hs = []
        for t in range(T):
            z = xz[:, t] + h @ rec
            i, f, g, o = z.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        out = torch.stack(hs, 1) if self.return_sequences else h
        return [out, h, c] if self.return_state else out


class GRU(Layer):
    """keras GRU v2 (``reset_after=True``): ``kernel`` (D, 3H),
    ``recurrent_kernel`` (H, 3H), ``bias`` (2, 3H), gates ``[z, r,
    h]``."""

    def __init__(self, units: int, return_sequences: bool = False,
                 return_state: bool = False, use_bias: bool = True,
                 name: str | None = None):
        self.units = int(units)
        self.return_sequences = return_sequences
        self.return_state = return_state
        self.use_bias = use_bias
        self.name = name

    @property
    def symbolic_outputs(self):
        return 2 if self.return_state else 1

    def apply(self, x, *, train, scope=None):
        s = scope.child("_GRUModule", self.name)
        B, T, D = x.shape
        H = self.units
        kernel = s.param("kernel", (D, 3 * H), glorot_uniform)
        rec = s.param("recurrent_kernel", (H, 3 * H), orthogonal)
        if self.use_bias:
            bias = s.param("bias", (2, 3 * H), zeros)
            b_in, b_rec = bias[0], bias[1]
        else:
            b_in = b_rec = x.new_zeros((3 * H,))
        xz = torch.einsum("btd,dh->bth", x, kernel) + b_in
        h = xz.new_zeros((B, H))
        hs = []
        for t in range(T):
            hz = h @ rec + b_rec
            xz_z, xz_r, xz_h = xz[:, t].chunk(3, dim=-1)
            hz_z, hz_r, hz_h = hz.chunk(3, dim=-1)
            z = torch.sigmoid(xz_z + hz_z)
            r = torch.sigmoid(xz_r + hz_r)
            hh = torch.tanh(xz_h + r * hz_h)
            h = z * h + (1.0 - z) * hh
            hs.append(h)
        out = torch.stack(hs, 1) if self.return_sequences else h
        return [out, h] if self.return_state else out


class SimpleRNN(Layer):
    """keras SimpleRNN (tanh): ``kernel`` (D, H), ``recurrent_kernel``
    (H, H), ``bias`` (H,)."""

    def __init__(self, units: int, return_sequences: bool = False,
                 use_bias: bool = True, name: str | None = None):
        self.units = int(units)
        self.return_sequences = return_sequences
        self.use_bias = use_bias
        self.name = name

    def apply(self, x, *, train, scope=None):
        s = scope.child("_SimpleRNNModule", self.name)
        B, T, D = x.shape
        H = self.units
        kernel = s.param("kernel", (D, H), glorot_uniform)
        rec = s.param("recurrent_kernel", (H, H), orthogonal)
        xz = torch.einsum("btd,dh->bth", x, kernel)
        if self.use_bias:
            xz = xz + s.param("bias", (H,), zeros)
        h = xz.new_zeros((B, H))
        hs = []
        for t in range(T):
            h = torch.tanh(xz[:, t] + h @ rec)
            hs.append(h)
        return torch.stack(hs, 1) if self.return_sequences else h


class Bidirectional(Layer):
    """Concat-merge over an LSTM/GRU/SimpleRNN; the backward direction
    is a copy of the layer's config with its own weights."""

    def __init__(self, layer, merge_mode: str = "concat"):
        if not isinstance(layer, (LSTM, GRU, SimpleRNN)):
            raise TypeError("Bidirectional wraps an LSTM/GRU/SimpleRNN layer")
        if merge_mode != "concat":
            raise NotImplementedError(
                "Bidirectional supports merge_mode='concat'")
        self.layer = layer
        self.backward_layer = type(layer).from_config(layer.get_config())
        self.backward_layer.name = (layer.name + "_backward"
                                    if layer.name else None)
        self.merge_mode = merge_mode

    @property
    def symbolic_outputs(self):
        n = self.layer.symbolic_outputs
        return 1 if n == 1 else 1 + 2 * (n - 1)

    def apply(self, x, *, train, scope=None):
        fwd = self.layer.apply(x, train=train, scope=scope)
        bwd = self.backward_layer.apply(x.flip(1), train=train, scope=scope)
        if isinstance(fwd, list):
            out_b = bwd[0]
            if self.layer.return_sequences:
                out_b = out_b.flip(1)
            return [torch.cat([fwd[0], out_b], dim=-1), *fwd[1:], *bwd[1:]]
        if self.layer.return_sequences:
            bwd = bwd.flip(1)
        return torch.cat([fwd, bwd], dim=-1)

    def get_config(self):
        raise ValueError(
            "Bidirectional serialization is not supported; rebuild in "
            "code and use load_weights")


class _SequentialModule:
    """The layers applied in order in one scope (flax's compact module:
    submodule names count across the whole stack)."""

    def __init__(self, layer_stack: tuple, train: bool):
        self.layer_stack = layer_stack
        self.train = train

    def __call__(self, scope, x):
        for layer in self.layer_stack:
            x = layer.apply(x, train=self.train, scope=scope)
        return x


class Sequential(Model):
    """A Model built from a layer list; builds eagerly when a layer pins
    an input shape (``keras.Input`` / ``input_shape=``), else on the
    first fit/call."""

    @staticmethod
    def _as_layer(lyr):
        from distributed_tensorflow_tpu_torch.training.functional import (
            SymbolicTensor)
        if isinstance(lyr, SymbolicTensor):
            if lyr.layer is not None:
                raise TypeError(
                    "Sequential only accepts keras.Input symbolic "
                    "tensors, not intermediate graph tensors — use "
                    "keras.Model(inputs, outputs) for functional graphs")
            return InputLayer(lyr.shape)
        if not isinstance(lyr, Layer):
            raise TypeError(
                f"Sequential expects layers "
                f"(distributed_tensorflow_tpu_torch.keras.layers), got "
                f"{type(lyr).__name__}")
        if lyr.symbolic_outputs != 1:
            raise ValueError(
                f"{type(lyr).__name__} with return_state=True has "
                "multiple outputs; Sequential layers must have exactly "
                "one output (use the functional API)")
        return lyr

    def __init__(self, layers: Sequence[Layer] | None = None, *,
                 seed: int = 0):
        stack = tuple(self._as_layer(lyr) for lyr in (layers or ()))
        super().__init__(_SequentialModule(stack, train=True),
                         eval_module=_SequentialModule(stack, train=False),
                         seed=seed)
        self.layers = list(stack)
        shape = next((lyr.compute_input_shape() for lyr in stack
                      if lyr.compute_input_shape()), None)
        if shape is not None:
            self.build(torch.zeros((1, *shape)))

    def add(self, layer: Layer):
        """keras ``Sequential.add``: the existing layers keep their
        weights (auto-names are call-order stable); the optimizer state
        is made anew for the grown parameter set."""
        layer = self._as_layer(layer)
        old_params = old_model_state = rebuild_sample = None
        if self._built and self._state is not None:
            old_params = self._state["params"]
            old_model_state = self._state.get("model_state", {})
            rebuild_sample = getattr(self, "_build_sample", None)
        self.layers.append(layer)
        stack = tuple(self.layers)
        self.module = _SequentialModule(stack, train=True)
        self.eval_module = _SequentialModule(stack, train=False)
        self._built = False
        shape = next((lyr.compute_input_shape() for lyr in stack
                      if lyr.compute_input_shape()), None)
        if rebuild_sample is not None:
            self.build(rebuild_sample)
        elif shape is not None:
            self.build(torch.zeros((1, *shape)))
        if old_params is not None and self._built:
            merged = dict(self._state["params"])
            for k in old_params:
                if k in merged:
                    merged[k] = old_params[k]
            new_ms = dict(self._state.get("model_state", {}))
            for coll, sub in dict(old_model_state or {}).items():
                cur = dict(new_ms.get(coll, {}))
                for k in sub:
                    if k in cur:
                        cur[k] = sub[k]
                new_ms[coll] = cur
            self._set_state_trees(merged, new_ms)


from distributed_tensorflow_tpu_torch.training.functional import Input  # noqa: E402,F401
