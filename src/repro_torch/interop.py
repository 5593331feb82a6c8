"""State carried across from ``repro``: its objects, as plain fields.

The system has no weights; its state is the instance, the platform and
the forecast. This module turns an object of the reference package — given
as its fields in numpy, the dict :func:`dataclasses.asdict` or
:func:`fields` returns — into the port's own dataclass of the same name,
so both packages can schedule the identical instance. It imports nothing of
``repro``: :func:`port` reads any dataclass by its name and fields.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np

from repro_torch.cluster import Platform
from repro_torch.core.carbon import PowerProfile
from repro_torch.core.dag import FixedMapping, Instance
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
