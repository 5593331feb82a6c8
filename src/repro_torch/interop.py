"""State carried across from ``repro``: its objects as plain fields, and
its model weights as numpy arrays.

The scheduler's state is the instance, the platform and the forecast. This
module turns an object of the reference package — given as its fields in
numpy, the dict :func:`dataclasses.asdict` or :func:`fields` returns — into
the port's own dataclass of the same name, so both packages can schedule the
identical instance. The LLM substrate's state is a model's parameter tree:
:func:`load_params` copies the reference's tree, given as nested dicts of
numpy arrays, into the port's model, leaf for leaf, and :func:`load_state`
turns a reference training state into the port's. The module imports
nothing of ``repro``: :func:`port` reads any dataclass by its name and
fields, and :func:`load_params` and :func:`load_state` read plain dicts.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import bf16_tensor
from repro_torch.cluster import Platform
from repro_torch.core.carbon import PowerProfile
from repro_torch.core.dag import FixedMapping, Instance
from repro_torch.train.optimizer import tree_map
from repro_torch.workflows.generators import Workflow

CLASSES = {cls.__name__: cls for cls in
           (Workflow, Platform, FixedMapping, Instance, PowerProfile)}


def _copy(x):
    return np.array(x, copy=True) if isinstance(x, np.ndarray) \
        else copy.deepcopy(x)


def fields(obj) -> dict:
    """The dataclass ``obj``'s fields as a dict of copies (numpy arrays
    stay numpy arrays), the shape :func:`from_fields` takes."""
    return {f.name: _copy(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def from_fields(kind: str, data: dict):
    """The port's ``kind`` object (``"Instance"``, ``"Platform"``, ...)
    built from ``data``; raises on unknown kinds and on missing or extra
    fields."""
    try:
        cls = CLASSES[kind]
    except KeyError:
        raise ValueError(
            f"unknown kind {kind!r}; one of {sorted(CLASSES)}") from None
    want = {f.name for f in dataclasses.fields(cls)}
    got = set(data)
    if want != got:
        raise ValueError(
            f"{kind} fields mismatch: missing {sorted(want - got)}, "
            f"extra {sorted(got - want)}")
    return cls(**{k: _copy(v) for k, v in data.items()})


def port(obj):
    """The port's counterpart of a reference dataclass object (matched by
    class name and fields)."""
    return from_fields(type(obj).__name__, fields(obj))


def flatten_params(tree, prefix: str = "") -> dict:
    """A nested parameter dict as ``{"attn.wq": leaf, ...}`` (the dotted
    names of the port's ``state_dict``)."""
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten_params(value, name + "."))
        else:
            flat[name] = value
    return flat


def check_params(model, flat: dict) -> None:
    """Raise unless ``flat`` (dotted name -> leaf with a ``.shape``) holds
    exactly the model's parameters, each of the model's shape."""
    want = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {missing}, "
                         f"extra {extra}")
    bad = {n: (tuple(np.shape(flat[n])), want[n]) for n in want
           if tuple(np.shape(flat[n])) != want[n]}
    if bad:
        raise ValueError(f"parameter shapes differ (given, model): {bad}")


def load_params(model, tree):
    """Copy the reference's parameter tree (nested dicts of numpy arrays)
    into ``model`` as f32, checked by :func:`check_params`; returns the
    model."""
    flat = flatten_params(tree)
    check_params(model, flat)
    with torch.no_grad():
        for name, p in model.state_dict().items():
            p.copy_(torch.from_numpy(np.array(flat[name], np.float32)))
    return model


def to_tensor(x, device=None) -> torch.Tensor:
    """A numpy leaf as a tensor of its dtype on ``device``; an extension
    ``bfloat16`` array (the reference's bf16) by its words."""
    x = np.asarray(x)
    t = bf16_tensor(x) if x.dtype.name == "bfloat16" \
        else torch.from_numpy(np.array(x, copy=True))
    return t.to(device)


def load_state(model, ref_state) -> dict:
    """The port's training state from a reference one (its
    ``init_state``/``train_step`` dict with numpy leaves: ``params``, and
    ``opt`` with ``m``, ``v``, ``step`` and under mixed precision
    ``master``), on the model's device, every leaf in its own dtype. The
    f32 parameters (the master under mixed precision) are also loaded into
    ``model`` by :func:`load_params`, which checks the tree; the live
    parameters and the moments are checked against the model's shapes."""
    opt = ref_state["opt"]
    load_params(model, opt.get("master", ref_state["params"]))
    for tree in (ref_state["params"], opt["m"], opt["v"]):
        check_params(model, flatten_params(tree))
    def conv(tree):
        return tree_map(lambda x: to_tensor(x, model.device), tree)

    state = {"params": conv(ref_state["params"]),
             "opt": {"m": conv(opt["m"]), "v": conv(opt["v"]),
                     "step": to_tensor(np.asarray(opt["step"], np.int32),
                                       model.device)}}
    if "master" in opt:
        state["opt"]["master"] = conv(opt["master"])
    return state
