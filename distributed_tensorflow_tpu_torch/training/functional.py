"""Keras functional API: symbolic tensors and DAG models — port of
``distributed_tensorflow_tpu/training/functional.py``.

``keras.Input`` returns a :class:`SymbolicTensor`; calling a layer on
symbolic tensors records a graph node; ``keras.Model(inputs, outputs)``
sorts the recorded DAG topologically and evaluates it in order. Each
layer instance gets one keras-style name in graph order ("dense",
"dense_1", ..., from its class name or its own ``name``), the scope its
parameters live in, so a reused layer shares its weights and the
parameter tree is JAX's (``{"dense": {"Dense_0": {...}}}``).
"""

from __future__ import annotations

import itertools
import re
from typing import Sequence

import torch

from distributed_tensorflow_tpu_torch.training.model import Model as _TrainModel
from distributed_tensorflow_tpu_torch.utils import tree


class SymbolicTensor:
    """A node of the functional graph. ``layer`` is None for graph
    inputs; ``call_args`` keeps the structure the layer was called with.
    A multi-output call yields alias tensors with ``source`` (the call
    node) and ``index``."""

    _ids = itertools.count()

    def __init__(self, *, shape=None, dtype="float32", layer=None,
                 call_args=None, name=None, source=None, index=0):
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.layer = layer
        self.call_args = call_args
        self.name = name
        self.source = source
        self.index = index
        self.uid = next(self._ids)

    def __repr__(self):
        if self.source is not None:
            return (f"<SymbolicTensor {self.uid} = output {self.index} "
                    f"of node {self.source.uid}>")
        src = "Input" if self.layer is None else type(self.layer).__name__
        return f"<SymbolicTensor {self.uid} from {src}>"


def Input(shape=None, *, dtype="float32", name=None, batch_size=None):
    """A symbolic tensor with per-sample ``shape``."""
    if shape is None:
        raise ValueError("Input() requires shape")
    return SymbolicTensor(shape=tuple(shape), dtype=dtype, name=name)


def _is_sym(x) -> bool:
    return isinstance(x, SymbolicTensor)


def _sym_leaves(args):
    return [x for x in tree.tree_leaves(args, is_leaf=_is_sym)
            if isinstance(x, SymbolicTensor)]


def is_symbolic(args) -> bool:
    return bool(_sym_leaves(args))


def symbolic_call(layer, args):
    """Record ``layer(args)``; a layer with ``symbolic_outputs > 1``
    returns a list of alias tensors."""
    node = SymbolicTensor(layer=layer, call_args=args)
    n = getattr(layer, "symbolic_outputs", 1)
    if n == 1:
        return node
    return [SymbolicTensor(source=node, index=i) for i in range(n)]


def _keras_auto_name(layer) -> str:
    """keras-style base name: the layer's own, else CamelCase ->
    snake_case of its class."""
    explicit = getattr(layer, "name", None)
    if explicit:
        return explicit
    return re.sub(r"(?<!^)(?=[A-Z])", "_", type(layer).__name__).lower()


class _FunctionalModule:
    """Evaluate the recorded DAG: ``nodes`` in topological order (inputs
    excluded); ``layer_names`` maps ``str(id(layer))`` to its scope
    name."""

    def __init__(self, input_nodes, nodes, output_nodes, layer_names,
                 train: bool):
        self.input_nodes = tuple(input_nodes)
        self.nodes = tuple(nodes)
        self.output_nodes = tuple(output_nodes)
        self.layer_names = layer_names
        self.train = train

    def __call__(self, scope, x):
        xs = x if isinstance(x, (list, tuple)) else (x,)
        if len(xs) != len(self.input_nodes):
            raise ValueError(
                f"model expects {len(self.input_nodes)} inputs, "
                f"got {len(xs)}")
        memo = {inp.uid: v for inp, v in zip(self.input_nodes, xs)}

        def resolve(s):
            if s.source is not None:
                return memo[s.source.uid][s.index]
            return memo[s.uid]

        for node in self.nodes:
            args = tree.tree_map(
                lambda s: resolve(s) if isinstance(s, SymbolicTensor)
                else s, node.call_args, is_leaf=_is_sym)
            name = self.layer_names[str(id(node.layer))]
            memo[node.uid] = node.layer.apply(
                args, train=self.train, scope=scope.child(None, name))
        outs = [resolve(o) for o in self.output_nodes]
        return outs[0] if len(self.output_nodes) == 1 else tuple(outs)


def _toposort(inputs: Sequence[SymbolicTensor],
              outputs: Sequence[SymbolicTensor]):
    """DFS topological order of the layer nodes from the outputs back to
    the declared inputs; an unlisted Input is a disconnected graph."""
    input_ids = {i.uid for i in inputs}
    order, seen, visiting = [], set(), set()

    def visit(node):
        if node.uid in seen:
            return
        if node.uid in input_ids:
            seen.add(node.uid)
            return
        if node.source is not None:
            seen.add(node.uid)
            visit(node.source)
            return
        if node.layer is None:
            raise ValueError(
                f"Graph disconnected: {node!r} is an Input not listed "
                f"in Model(inputs=...)")
        if node.uid in visiting:
            raise ValueError("Cycle in functional graph")
        visiting.add(node.uid)
        for dep in _sym_leaves(node.call_args):
            visit(dep)
        visiting.discard(node.uid)
        seen.add(node.uid)
        order.append(node)

    for out in outputs:
        visit(out)
    return tuple(order)


_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float32,
           "int32": torch.int32, "int64": torch.int32, "bool": torch.bool}


class Model(_TrainModel):
    """keras.Model: ``Model(inputs=sym, outputs=sym)`` builds a
    Functional model over the recorded DAG; any other construction is
    the module-based training Model."""

    def __init__(self, *args, inputs=None, outputs=None, **kwargs):
        if inputs is None and args and is_symbolic(args[0]):
            inputs, args = args[0], args[1:]
            if outputs is None and args:
                outputs, args = args[0], args[1:]
        if inputs is None:
            super().__init__(*args, **kwargs)
            return
        if outputs is None:
            raise ValueError("Model(inputs=...) requires outputs=")
        self._functional_init(inputs, outputs,
                              seed=kwargs.pop("seed", 0),
                              name=kwargs.pop("name", None))

    def _functional_init(self, inputs, outputs, *, seed=0, name=None):
        self.inputs = list(inputs) if isinstance(
            inputs, (list, tuple)) else [inputs]
        self.outputs = list(outputs) if isinstance(
            outputs, (list, tuple)) else [outputs]
        for i in self.inputs:
            if not (isinstance(i, SymbolicTensor) and i.layer is None):
                raise TypeError(
                    "Model(inputs=...) expects keras.Input tensors, got "
                    f"{i!r}")
        nodes = _toposort(self.inputs, self.outputs)
        counters, names = {}, {}
        for node in nodes:
            key = str(id(node.layer))
            if key in names:
                continue
            base = _keras_auto_name(node.layer)
            n = counters.get(base, 0)
            counters[base] = n + 1
            names[key] = base if n == 0 else f"{base}_{n}"
        self._graph_nodes = nodes
        self.layers = []
        seen_layers = set()
        for node in nodes:
            if id(node.layer) not in seen_layers:
                seen_layers.add(id(node.layer))
                self.layers.append(node.layer)

        def mk(train):
            return _FunctionalModule(self.inputs, nodes, self.outputs,
                                     names, train)
        super().__init__(mk(True), eval_module=mk(False), seed=seed)
        self.name = name
        if all(i.shape is not None for i in self.inputs):
            sample = [torch.zeros((1, *i.shape), dtype=_DTYPES[str(i.dtype)])
                      for i in self.inputs]
            self.build(sample[0] if len(sample) == 1 else tuple(sample))
