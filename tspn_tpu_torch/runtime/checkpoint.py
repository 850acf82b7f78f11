"""Checkpoints: weights carried across from the JAX package, and native
save / load (counterpart of tspn_tpu/runtime/checkpoint.py).

A JAX checkpoint is flax msgpack: a map {params, opt_state, meta} whose
array leaves are msgpack ext type 1 with payload ``(shape, dtype name,
bytes)``. It is decoded here with ``msgpack`` alone (imported lazily),
so serving a JAX-trained model needs neither jax nor flax. Native
checkpoints are ``torch.save`` zip files; both keep the
``<name>_weights_iter_<N>.pt`` naming.
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raise NotImplementedError("bfloat16 checkpoint leaves are not supported")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _check_unchunked(tree) -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise NotImplementedError(
                "chunked (> 1 GiB) array leaves are not supported"
            )
        for v in tree.values():
            _check_unchunked(v)


def load_jax_checkpoint(path: str) -> dict:
    """Template-free read of a flax msgpack checkpoint ->
    {params, opt_state, step, loss} with numpy leaves (the contract of
    tspn_tpu/runtime/checkpoint.py::load_checkpoint_raw)."""
    import msgpack

    with open(path, "rb") as f:
        restored = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    _check_unchunked(restored)
    meta = restored.get("meta", {})
    return {
        "params": restored.get("params", {}),
        "opt_state": restored.get("opt_state") or None,
        "step": int(meta.get("step", 0)),
        "loss": float(meta.get("loss", 0.0)),
    }


# the flax PPNHead's Dense layers, all directly under "ppn_head"
PPN_LAYERS = ("sub_fc1", "sub_fc2", "obj_fc1", "obj_fc2")


def _linear_from_dense(prefix: str, dense: dict) -> Dict[str, torch.Tensor]:
    """flax Dense keeps its kernel as (in, out); nn.Linear keeps (out, in)."""
    kernel = np.asarray(dense["kernel"], np.float32)
    return {
        f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(kernel.T)),
        f"{prefix}.bias": torch.from_numpy(np.array(dense["bias"], np.float32)),
    }


def state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """Map the JAX model's param tree (numpy leaves) to TSPNModel's state
    dict: the unfused Dense ``rel_predictor`` (kernel transposed), or the
    fused classifier's ``kernel`` (device_dim, R) and ``bias`` as they
    are, and the PPN head's four Dense layers when the tree has
    ``ppn_head``. Any other subtree raises."""
    unknown = set(params) - {"classifier", "ppn_head"}
    if unknown:
        raise NotImplementedError(
            f"param subtrees {sorted(unknown)} are not ported (span mode: "
            "ROADMAP queue 1)"
        )
    cls = params["classifier"]
    if "rel_predictor" in cls:
        out = _linear_from_dense("classifier.rel_predictor", cls["rel_predictor"])
    else:
        out = {
            "classifier.kernel": torch.from_numpy(
                np.array(cls["kernel"], np.float32)
            ),
            "classifier.bias": torch.from_numpy(np.array(cls["bias"], np.float32)),
        }
    if "ppn_head" in params:
        for name in PPN_LAYERS:
            out.update(_linear_from_dense(f"ppn_head.{name}",
                                          params["ppn_head"][name]))
    return out


def jax_params_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The inverse of ``state_dict_from_jax``: TSPNModel's state dict ->
    the JAX model's param tree with numpy leaves."""
    sd = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in state_dict.items()}

    def dense(prefix):
        return {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T),
                "bias": sd[f"{prefix}.bias"].copy()}

    if "classifier.rel_predictor.weight" in sd:
        params = {"classifier": {"rel_predictor": dense("classifier.rel_predictor")}}
    else:
        params = {"classifier": {"kernel": sd["classifier.kernel"].copy(),
                                 "bias": sd["classifier.bias"].copy()}}
    if "ppn_head.sub_fc1.weight" in sd:
        params["ppn_head"] = {name: dense(f"ppn_head.{name}") for name in PPN_LAYERS}
    return params


# the flax FasterRCNN's top-level subtrees
DETECTOR_SUBTREES = ("backbone", "rpn_head", "res5", "cls_score", "bbox_pred")


def detector_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """Map the flax FasterRCNN param tree (numpy leaves) to the port's
    FasterRCNN state dict. Module paths carry over by name; a conv
    ``kernel`` (HWIO) becomes ``weight`` (OIHW), a Dense ``kernel`` (in,
    out) becomes ``weight`` (out, in); biases and the FrozenAffine
    ``scale``/``bias`` stay as they are."""
    unknown = set(params) - set(DETECTOR_SUBTREES)
    if unknown:
        raise ValueError(f"not a FasterRCNN param tree: subtrees {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: dict, prefix: str):
        for name, v in tree.items():
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(v, dict):
                walk(v, key)
                continue
            v = np.asarray(v, np.float32)
            if name == "kernel":
                key = f"{prefix}.weight"
                v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            out[key] = torch.from_numpy(np.array(v, order="C"))  # a writable copy

    walk(params, "")
    return out


def jax_params_from_detector_state_dict(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The inverse of ``detector_state_dict_from_jax``: the port's
    FasterRCNN state dict -> the flax param tree with numpy leaves."""
    params: dict = {}
    for key, v in state_dict.items():
        v = v.detach().to("cpu", torch.float32).numpy()
        *path, leaf = key.split(".")
        if leaf == "weight":
            leaf = "kernel"
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
        node = params
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(v)
    return params


def load_detector_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A detector checkpoint -> the port's FasterRCNN state dict: the
    port's own (``detection.train.train_detector``'s, a torch.save zip
    file), or a JAX one (flax msgpack, as ``tools/run_pipeline.py`` loads
    it). ``load_checkpoint`` reads a native one's SGD momentum, LR schedule
    and step as well."""
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)["model"]
    return detector_state_dict_from_jax(load_jax_checkpoint(path)["params"])


def save_checkpoint(path: str, model, step: int = 0,
                    loss: float = 0.0, optimizer=None, scheduler=None,
                    plateau=None) -> str:
    """torch.save of the model (a module, or its state dict) and, for a
    training checkpoint, the optimizer, the LR scheduler and the plateau
    state (a ``ReduceOnPlateauState``), written atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = model if isinstance(model, dict) else model.state_dict()
    blob = {"model": state, "step": step, "loss": loss}
    if optimizer is not None:
        blob["optimizer"] = optimizer.state_dict()
    if scheduler is not None:
        blob["scheduler"] = scheduler.state_dict()
    if plateau is not None:
        blob["plateau"] = plateau._asdict()
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> dict:
    """Either format -> {state_dict, step, loss}: a torch.save zip file,
    or a JAX flax msgpack checkpoint carried across. A native training
    checkpoint also gives ``optimizer``, ``scheduler`` and ``plateau``
    (None where it has none)."""
    if zipfile.is_zipfile(path):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        return {"state_dict": blob["model"], "step": int(blob["step"]),
                "loss": float(blob["loss"]), "native": True,
                "optimizer": blob.get("optimizer"),
                "scheduler": blob.get("scheduler"),
                "plateau": blob.get("plateau")}
    raw = load_jax_checkpoint(path)
    return {"state_dict": state_dict_from_jax(raw["params"]),
            "step": raw["step"], "loss": raw["loss"], "native": False}


def load_training_checkpoint(path: str) -> dict:
    """``load_checkpoint`` for ``--resume``: only the port's own training
    checkpoints hold the optimizer state it continues from."""
    restored = load_checkpoint(path)
    if not restored["native"]:
        raise NotImplementedError(
            f"{path} is a JAX checkpoint: its optax state is not carried "
            "across, so --resume takes only the port's own checkpoints "
            "(ROADMAP queue 3)"
        )
    if restored["optimizer"] is None:
        raise ValueError(f"{path} holds no optimizer state to resume from")
    return restored


def latest_checkpoint(model_dir: str, model_name: str) -> Optional[str]:
    """Highest-iteration '<name>_weights_iter_<N>.pt' in model_dir."""
    if not os.path.isdir(model_dir):
        return None
    best, best_iter = None, -1
    prefix = f"{model_name}_weights_iter_"
    for fname in os.listdir(model_dir):
        if fname.startswith(prefix) and fname.endswith(".pt"):
            try:
                it = int(fname[len(prefix):-3])
            except ValueError:
                continue
            if it > best_iter:
                best, best_iter = os.path.join(model_dir, fname), it
    return best
