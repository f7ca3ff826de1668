"""Whole-model persistence: ``model.save`` / ``keras.models.load_model``
— port of ``distributed_tensorflow_tpu/training/saving.py``.

A saved model is a directory holding ``model_config.json`` (the
Sequential layer stack, or the Functional DAG with its node records, as
keras-style ``{class_name, config}`` records) and a
``checkpoint.Checkpoint`` of the weights (params and model_state). The
config is JAX's for the same model and the checkpoint is JAX's format
at JAX's leaf paths, so each package loads the other's saved models.
Compile state is not saved (call ``compile`` after loading).
"""

from __future__ import annotations

import json
import os

MODEL_CONFIG = "model_config.json"
WEIGHTS_SUBDIR = "weights"


def _encode_args(args, node_ids):
    """call_args structure -> JSON: symbolic tensors become
    {"__node__": id} markers; TUPLES (multi-positional layer calls,
    e.g. mha(q, v)) are tagged so decoding can distinguish them from
    plain list arguments (e.g. Add()([a, b]))."""
    from distributed_tensorflow_tpu_torch.training.functional import (
        SymbolicTensor)
    if isinstance(args, SymbolicTensor):
        if args.source is not None:     # output i of a multi-output call
            return {"__node_out__": [node_ids[args.source.uid],
                                     args.index]}
        return {"__node__": node_ids[args.uid]}
    if isinstance(args, tuple):
        return {"__tuple__": [_encode_args(a, node_ids) for a in args]}
    if isinstance(args, list):
        return [_encode_args(a, node_ids) for a in args]
    if isinstance(args, (int, float, str, bool, type(None))):
        return args
    raise ValueError(
        f"functional call argument {args!r} is not serializable")


def _decode_args(enc, nodes):
    if isinstance(enc, dict) and "__node__" in enc:
        return nodes[enc["__node__"]]
    if isinstance(enc, dict) and "__node_out__" in enc:
        i, idx = enc["__node_out__"]
        return nodes[i][idx]
    if isinstance(enc, dict) and "__tuple__" in enc:
        return tuple(_decode_args(a, nodes) for a in enc["__tuple__"])
    if isinstance(enc, list):
        return [_decode_args(a, nodes) for a in enc]
    return enc


def _functional_config(model) -> dict:
    """Serialize a Functional model's DAG (≙ TFK Functional.get_config:
    layers by index + node records with encoded call args)."""
    layer_index = {id(lyr): i for i, lyr in enumerate(model.layers)}
    node_ids = {}
    for i, inp in enumerate(model.inputs):
        node_ids[inp.uid] = i
    nodes = []
    for n, node in enumerate(model._graph_nodes):
        node_ids[node.uid] = len(model.inputs) + n
        nodes.append({
            "layer": layer_index[id(node.layer)],
            "args": _encode_args(node.call_args, node_ids),
        })
    return {
        "class_name": "Functional",
        "config": {
            "layers": [{"class_name": type(lyr).__name__,
                        "config": lyr.get_config()}
                       for lyr in model.layers],
            "inputs": [{"shape": list(i.shape), "dtype": str(i.dtype)}
                       for i in model.inputs],
            "nodes": nodes,
            "outputs": [_encode_args(o, node_ids)
                        for o in model.outputs],
        },
    }


def _rebuild_functional(config: dict):
    from distributed_tensorflow_tpu_torch import keras
    from distributed_tensorflow_tpu_torch.training import layers as layers_lib

    layers = [ _layer_from_record(rec, layers_lib)
               for rec in config["layers"] ]
    nodes = [keras.Input(shape=tuple(i["shape"]), dtype=i["dtype"])
             for i in config["inputs"]]
    inputs = list(nodes)
    for rec in config["nodes"]:
        layer = layers[rec["layer"]]
        args = _decode_args(rec["args"], nodes)
        # tuple = original multi-positional call (mha(q, v)); anything
        # else was a single argument (tensor or list of tensors)
        nodes.append(layer(*args) if isinstance(args, tuple)
                     else layer(args))
    outputs = [_decode_args(o, nodes) for o in config["outputs"]]
    return keras.Model(inputs=inputs if len(inputs) > 1 else inputs[0],
                       outputs=outputs if len(outputs) > 1 else outputs[0])


def _layer_from_record(rec: dict, layers_lib):
    cls = getattr(layers_lib, rec["class_name"], None)
    if cls is None or not (isinstance(cls, type)
                           and issubclass(cls, layers_lib.Layer)):
        raise ValueError(
            f"unknown layer class {rec['class_name']!r} in saved "
            f"model config")
    return cls.from_config(rec["config"])


def model_config(model) -> dict:
    """Architecture-only serialization (raises for unsupported model
    kinds or unserializable layers — used by ModelCheckpoint's
    fail-fast check as well as save_model)."""
    from distributed_tensorflow_tpu_torch.training import functional
    from distributed_tensorflow_tpu_torch.training import layers as layers_lib

    if isinstance(model, layers_lib.Sequential):
        return {
            "class_name": "Sequential",
            "config": {"layers": [
                {"class_name": type(lyr).__name__,
                 "config": lyr.get_config()}
                for lyr in model.layers]},
        }
    if isinstance(model, functional.Model) and hasattr(model,
                                                       "_graph_nodes"):
        return _functional_config(model)
    raise NotImplementedError(
        f"save_model supports shim Sequential and Functional "
        f"models; got {type(model).__name__}. For other models use "
        "save_weights/load_weights (weights only).")


def save_model(model, filepath: str) -> None:
    """Serialize a shim Sequential or Functional: architecture +
    weights."""
    config = model_config(model)
    if not model._built:
        raise ValueError("build the model (or fit once) before save()")
    os.makedirs(filepath, exist_ok=True)
    tmp = os.path.join(filepath, MODEL_CONFIG + ".tmp")
    with open(tmp, "w") as f:
        json.dump(config, f, indent=1)
    os.replace(tmp, os.path.join(filepath, MODEL_CONFIG))
    model.save_weights(os.path.join(filepath, WEIGHTS_SUBDIR))


def load_model(filepath: str):
    """Rebuild a saved Sequential and restore its weights (uncompiled —
    call ``compile`` before further training, like tf_keras
    ``load_model(compile=False)``)."""
    from distributed_tensorflow_tpu_torch.training import layers as layers_lib

    config_path = os.path.join(filepath, MODEL_CONFIG)
    if not os.path.exists(config_path):
        raise FileNotFoundError(
            f"no saved model at {filepath!r} ({MODEL_CONFIG} missing)")
    with open(config_path) as f:
        config = json.load(f)
    kind = config.get("class_name")
    if kind == "Functional":
        model = _rebuild_functional(config["config"])
    elif kind == "Sequential":
        stack = [_layer_from_record(rec, layers_lib)
                 for rec in config["config"]["layers"]]
        model = layers_lib.Sequential(stack)
    else:
        raise NotImplementedError(
            f"load_model supports Sequential/Functional; got {kind!r}")
    if not model._built:
        raise ValueError(
            "saved model has no shape-pinning layer (Input/input_shape=) "
            "— cannot rebuild parameters before loading weights")
    model.load_weights(os.path.join(filepath, WEIGHTS_SUBDIR))
    return model
