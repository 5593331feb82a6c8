"""Dry run: count one step of every (arch x shape x mesh) cell on the meta
device, with no card and no memory.

The counterpart of ``repro.launch.dryrun``. The reference lowers and
compiles each cell with XLA and reads ``cost_analysis()`` and
``memory_analysis()``; the port builds the model on the meta device
(``build_model(cfg, device="meta")``, shapes only) and runs the step once
on meta tensors under :class:`StepCounter`, a dispatch mode that sees
every aten op of it, the backward and the optimizer included:

* compile -- under ``--mesh single|multi`` the spec trees of the
  production mesh (``tree_param_specs``, ``batch_specs``,
  ``cache_specs`` over :func:`production_mesh`, after ``configure``)
  must shard every dimension they name evenly, the counterpart of
  ``.lower().compile()`` succeeding; then the traced step's memory
  (arguments, outputs, and the peak of its temporaries: a device's under
  a mesh) and its counts;
* cost -- the whole step's FLOPs and bytes and its roofline terms. The
  port's layer loops are Python loops, so the count sees every layer at
  the true depth: none of the reference's depth calibration (unrolled
  depth points, the linear fits, ``COST_CHUNK``, the sLSTM correction)
  is needed. A train cell counts one microbatch's forward and backward
  ``mb`` times, plus the optimizer once (``mb * fb + opt``).

``--mesh none`` is the port's one card: ``chips = 1``, no specs, the
roofline on :data:`~repro_torch.roofline.analysis.H100` (or ``H100_F32``
for a config whose matrix products run in f32). ``single`` and ``multi``
keep the reference's TPU ``HW`` so their records compare with the
reference's, and trace the **sharded** step of train and prefill cells
(:func:`fake_mesh`): a ``fake``-backend process group of the mesh's size
(256 or 512) in this process, the production mesh over it, the state
placed by ``place_state``'s specs as DTensors of meta-device local
shards, and the step run as one rank of it. As in the reference, FLOPs,
bytes and memory are then one device's (its local shards' ops, ``hlo_flops``
that times the chips), and ``collective_bytes_per_chip`` is the sum of
the operand bytes of the functional collectives the step issues
(``StepCounter.collectives``, in ``roofline.analysis.collective_bytes``'s
layout: bytes and counts by kind), which the roofline's collective term
reads. A decode cell runs the sharded decode step: the parameters placed
as for prefill, the cache by ``cache_specs`` (``place_cache``: rows over
the batch axes, or with B below their size, as ``long_500k``'s B=1, the
sequence over "data" and the attention combined across it) and the tokens
by ``P(ba)`` or ``P()``, as the reference's ``lower_decode``. A train cell
whose microbatch's rows do not split evenly over the batch axes
(arctic-480b's 16 rows over ``multi``'s 32 batch devices) traces the
sharded step too, each microbatch placed as DTensor's uneven parts
(``place_batch``): the traced rank is rank 0, which holds rows (ceil of
them), so its memory and counts are those of a device that works, as
XLA's padded per-device program counts the padded split.

Attention is counted as the plain model path computes it off the card
(``layers.attention_plain_model``: dense scores per block of 512 queries,
the masked half included), as the reference's ``cost_analysis()`` counts
its chunked jnp attention. ``attention="kernel"`` counts the card's path
instead: each self-attention as the flash kernels' work (the pairs a query
sees, q, k, v read and the output written once; the backward's three
stages likewise), which is what :mod:`chip_smoke`'s ``[roofline]`` phase
bounds its timed steps with.

Usage: python -m repro_torch.launch.dryrun --arch qwen2.5-3b \
         --shape train_4k --mesh none --mode both \
         --out experiments/dryrun_torch

``--out`` defaults to ``experiments/dryrun_torch``, the port's own
directory: the reference's dry run writes the same file names into
``experiments/dryrun``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import sys
import time
import weakref

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.launch.mesh import batch_axes, data_size
from repro_torch.models import build_model, input_specs, model_flops
from repro_torch.models import layers as L
from repro_torch.roofline.analysis import (H100, H100_F32, HW,
                                           collective_bytes, roofline_terms)
from repro_torch.sharding import ctx
from repro_torch.sharding.place import (place_batch, place_cache,
                                       place_params, place_state,
                                       place_tokens)
from repro_torch.sharding.specs import (P, batch_specs, cache_specs,
                                        tree_param_specs)
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         cast_params, lr_schedule, tree_map)
from repro_torch.train.step import loss_and_grads

MICROBATCHES = {
    "arctic-480b": 16, "granite-34b": 8, "jamba-v0.1-52b": 8,
    "qwen2-vl-7b": 8, "qwen2.5-3b": 4, "whisper-large-v3": 4,
}

# host devices of the production meshes (the reference's
# --xla_force_host_platform_device_count)
HOST_DEVICES = 512
# the head plan's TP width: the production meshes' "model" axis, and the
# card's models (build_model's default)
TP = 16
# the functional collectives a sharded step issues, by the reference's kind
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")

aten = torch.ops.aten
# allocate without touching their memory: no bytes
_ALLOCATE = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
             aten.new_empty_strided}
# composites of several passes that carry neither tag: the pointwise and
# reduction passes they stand for, a count per element
_PASSES = {aten._softmax: 4, aten._softmax_backward_data: 4, aten._to_copy: 1,
           aten.cumsum: 1, aten.scatter_add: 1, aten.tril: 1}


# kernels that allocate a temporary the size of their first input while they
# run (logsumexp: ``(x - max).exp_()``, then its sum), which the meta kernel
# does not show
_TEMPORARY = {aten.logsumexp}


def _tensors(tree):
    """The tensors of nested dicts, lists and tuples; a DTensor's local
    shard for a DTensor."""
    if isinstance(tree, torch.Tensor):
        if ctx.is_dtensor(tree):
            with torch.no_grad():
                return [tree.to_local()]
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in _tensors(x)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts the aten ops run under it.

    * ``flops``: matrix products, convolutions and SDPA by
      ``torch.utils.flop_counter``'s formulas; 1 per output element of an
      op tagged ``torch.Tag.pointwise``, 1 per input element of one tagged
      ``torch.Tag.reduction`` (XLA's ``HloCostAnalysis`` convention), and
      :data:`_PASSES` for the untagged composites (softmax: its two
      reductions and two pointwise passes).
    * ``bytes``: the input plus output bytes of every op that is not a
      view: an op whose outputs alias its inputs without writing them (a
      view, a reshape, ``detach``) counts 0, and so does an allocation; an
      in-place op counts its inputs and the tensor it writes. This is what
      eager PyTorch moves, one kernel an op (less what a kernel moves
      inside it), so an upper bound on a fused program's bytes.
    * memory: ``argument_bytes``, the storages of ``arguments``; every
      other storage an op makes is live from then until it is freed, and
      ``peak_bytes`` is the most that was live at once (the temporaries
      beyond the arguments), with the temporary of a kernel in
      :data:`_TEMPORARY` counted while it runs.

    * ``collectives``: a functional collective's operand bytes and count
      by kind (:data:`_COLLECTIVE_KINDS`), the layout of
      ``roofline.analysis.collective_bytes``; its bytes are not added to
      ``bytes``. ``by_group``: the same bytes by process group name, then
      kind (the group is a mesh axis's: :func:`trace_step` names them).

    An op on DTensors is left to DTensor (``NotImplemented``), whose local
    ops on the local shards and collectives then come here: under a mesh
    the counts are one device's. The ops DTensor runs on fake tensors to
    propagate shapes count nothing, and so does an op with an input on the
    host or an output there (a copy to the device, such as the rotary
    frequencies' first use, which ``layers`` caches; DTensor's own index
    bookkeeping). ``aten.bincount`` has no meta kernel: on a meta input it
    is the counts' shape, ``[minlength]`` (the MoE's experts, every index
    below it), counted as a reduction. :meth:`add` counts work that ran outside
    aten (the flash kernels under ``attention="kernel"``).
    """

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak_bytes = 0
        self._stores: dict = {}      # id(storage) -> (weakref, live bytes)
        self._cache: dict = {}
        self.collectives = collective_bytes("")
        self.by_group: dict = {}
        self.argument_bytes = self._track(_tensors(arguments), live=False)

    def _free(self, ref) -> None:
        _, n = self._stores.pop(ref.key)
        self.live -= n

    def _track(self, tensors, live: bool = True) -> int:
        """Track the storages of ``tensors`` not seen yet; returns their
        bytes."""
        new = 0
        for t in tensors:
            st = t.untyped_storage()
            k = id(st)
            if k in self._stores:
                continue
            n = st.nbytes()
            ref = weakref.KeyedRef(st, self._free, k)
            self._stores[k] = (ref, n if live else 0)
            new += n
        if live:
            self.live += new
            self.peak_bytes = max(self.peak_bytes, self.live)
        return new

    def add(self, flops: float = 0.0, nbytes: float = 0.0) -> None:
        self.flops += flops
        self.bytes += nbytes

    def _collective(self, func, args, kwargs) -> None:
        kind = _COLLECTIVE_KINDS.get(func.overloadpacket.__name__)
        if kind is None:
            return
        n = sum(_nbytes(t) for t in _tensors(list(args[:1])))
        self.collectives[kind] += n
        self.collectives["total"] += n
        self.collectives["counts"][kind] += 1
        group = (kwargs or {}).get("group_name", args[-1])
        per = self.by_group.setdefault(str(group), {})
        per[kind] = per.get(kind, 0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        if torch._C._get_dispatch_mode(_FAKE) is not None:
            # DTensor's sharding propagation runs the op on fake tensors of
            # the global shapes to learn its output's: no work of the step
            return func(*args, **(kwargs or {}))
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self._collective(func, args, kwargs)
            out = func(*args, **(kwargs or {}))
            self._track(_tensors(out))
            return out
        ins = []
        key = _walk(args, ins)
        if kwargs:
            kw = _walk(tuple(kwargs.items()), ins)
            key = _NO if kw is _NO else (key, kw)
        else:
            kwargs = {}
        if not all(t.is_meta for t in ins):
            # a copy from the host: no work of the card
            return func(*args, **kwargs)
        key = None if key is _NO else (func, key)
        hit = self._cache.get(key) if key is not None else None
        if hit is _HOST:
            return func(*args, **kwargs)
        if hit is None:
            out = self._run(func, args, kwargs, ins)
            outs = _tensors(out)
            if not all(t.is_meta for t in outs):
                # made on the host (DTensor's own index bookkeeping)
                if key is not None:
                    self._cache[key] = _HOST
                return out
            flops, nbytes, work = self._work(func, args, kwargs, ins, outs,
                                             out)
            metas = None
            if _functional(func) and (isinstance(out, torch.Tensor) or (
                    isinstance(out, tuple) and len(outs) == len(out))) \
                    and not _shares(ins, outs):
                metas = [(t.shape, t.stride(), t.dtype) for t in outs]
            if key is not None:
                self._cache[key] = (isinstance(out, tuple), metas, flops,
                                    nbytes, work)
        else:
            many, metas, flops, nbytes, work = hit
            if metas is None:        # a view or an in-place op: run it
                out = self._run(func, args, kwargs, ins)
                outs = _tensors(out)
            else:                    # fresh outputs of known shapes
                outs = [torch.empty_strided(shape, stride, dtype=dt,
                                            device="meta")
                        for shape, stride, dt in metas]
                out = tuple(outs) if many else outs[0]
        self.flops += flops
        self.bytes += nbytes
        self._track(outs)
        if work:
            self.peak_bytes = max(self.peak_bytes, self.live + work)
        return out

    @staticmethod
    def _run(func, args, kwargs, ins):
        if func.overloadpacket is aten.bincount:
            n = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
            return torch.empty((n,), dtype=torch.int64, device="meta")
        return func(*args, **kwargs)

    @staticmethod
    def _work(func, args, kwargs, ins, outs, out) -> tuple:
        """(flops, bytes, the bytes of the op's own temporaries) of one
        op."""
        packet = func.overloadpacket
        flops = 0
        if packet in flop_counter.flop_registry:
            flops = flop_counter.flop_registry[packet](
                *args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags:
            flops = sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags or packet is aten.bincount:
            flops = ins[0].numel() if ins else 0
        elif packet in _PASSES:
            flops = _PASSES[packet] * sum(t.numel() for t in outs)
        nbytes = 0
        if packet not in _ALLOCATE and not _is_view(func, ins, outs):
            nbytes = sum(_nbytes(t) for t in ins + outs)
        work = _nbytes(ins[0]) if packet in _TEMPORARY else 0
        return float(flops), float(nbytes), work


_FAKE = torch._C._TorchDispatchModeKey.FAKE


def _is_dtensor_type(t) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and issubclass(t, mod.DTensor)


_NO = object()
_HOST = object()
_SIMPLE = {bool, float, str, type(None), torch.dtype, torch.device,
           torch.layout, torch.memory_format}


def _walk(x, tensors: list):
    """``x`` as a cache-key part (a tensor: its shape, strides and dtype;
    an int itself; another scalar with its type; a list as a tuple), or
    ``_NO`` for what cannot be one; appends ``x``'s tensors to
    ``tensors``. An op whose inputs have the same shapes, strides, dtypes
    and other arguments gives outputs of the same shapes and the same
    counts: a step repeats most of its ops (each layer, each recurrence
    step), and the meta kernels are Python."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return (x.shape, x.stride(), x.dtype)
    t = type(x)
    if t is int:
        return x
    if t in _SIMPLE:
        return (t, x)
    if isinstance(x, (list, tuple)):
        parts = []
        key = True
        for v in x:
            h = _walk(v, tensors)
            if h is _NO:
                key = False
            parts.append(h)
        return tuple(parts) if key else _NO
    return _NO


_FUNCTIONAL: dict = {}


def _functional(func) -> bool:
    """Neither an argument nor a result of ``func`` aliases another."""
    f = _FUNCTIONAL.get(func)
    if f is None:
        schema = func._schema
        f = _FUNCTIONAL[func] = not any(
            a.alias_info is not None
            for a in list(schema.arguments) + list(schema.returns))
    return f


def _shares(ins, outs) -> bool:
    """Some output lies in an input's storage."""
    stores = {id(t.untyped_storage()) for t in ins}
    return any(id(t.untyped_storage()) in stores for t in outs)


def _is_view(func, ins, outs) -> bool:
    """Outputs that all share an input's storage, from an op that writes
    none of its inputs."""
    if not outs or any(a.alias_info is not None and a.alias_info.is_write
                       for a in func._schema.arguments):
        return False
    stores = {id(t.untyped_storage()) for t in ins}
    return all(id(t.untyped_storage()) in stores for t in outs)


# ---------------------------------------------------------------------------
# the card's attention: the flash kernels' work
# ---------------------------------------------------------------------------

def _pairs(S: int, causal: bool) -> int:
    return S * (S + 1) // 2 if causal else S * S


class _FlashCount(torch.autograd.Function):
    """The flash forward kernel (with its LSE store when a gradient
    follows) and its backward on meta tensors: the outputs' shapes, and
    the kernels' work added to the counter."""

    @staticmethod
    def forward(ctx, q, k, v, causal, counter, want_lse):
        B, S, H, hd = q.shape
        lse = 4 * B * H * S if want_lse else 0
        counter.add(4 * B * H * hd * _pairs(S, causal),
                    4 * B * S * H * hd * q.element_size() + lse)
        ctx.causal, ctx.counter = causal, counter
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, do):
        B, S, H, hd = do.shape
        e = do.element_size()
        # flash_bwd_dot (D = rowsum(dO O)), then the dK/dV and dQ passes:
        # q, k, v, o, dO and the LSE read, dq, dk, dv written; the five
        # products over the pairs each query sees
        ctx.counter.add(2 * B * S * H * hd + 10 * B * H * hd
                        * _pairs(S, ctx.causal),
                        8 * B * S * H * hd * e + 2 * 4 * B * H * S)
        return (torch.empty_like(do), torch.empty_like(do),
                torch.empty_like(do), None, None, None)


@contextlib.contextmanager
def kernel_attention(counter: StepCounter):
    """Count every self-attention (``layers.self_attention``) as the card
    runs it, through the flash kernels (kv heads expanded, as there);
    attention of differing lengths and the decode step stay plain, as
    there."""
    real = L.self_attention

    def counted(q, k, v, causal=True, mode=None):
        k, v = L._expand_kv(k, v, q.shape[2])
        # the kernel stores the rows' LSE only where a gradient follows
        want_lse = torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v))
        return _FlashCount.apply(q, k, v, causal, counter, want_lse)

    L.self_attention = counted
    try:
        yield
    finally:
        L.self_attention = real


# ---------------------------------------------------------------------------
# traced steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """One traced step: the counts of one microbatch's forward and backward
    (``fb``; the whole step when it does not train) and of the optimizer
    (``opt``), the microbatches ``mb``, and the memory of the trace; of a
    sharded step, one rank's counts, whose collectives are
    ``fb_collectives`` and ``opt_collectives``."""
    fb_flops: float
    fb_bytes: float
    opt_flops: float
    opt_bytes: float
    mb: int
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    seconds: float
    arguments: dict
    outputs: object
    fb_collectives: dict = dataclasses.field(
        default_factory=lambda: collective_bytes(""))
    opt_collectives: dict = dataclasses.field(
        default_factory=lambda: collective_bytes(""))
    # as traced (one microbatch and the optimizer): bytes by mesh axis (its
    # process group's), then kind
    collectives_by_axis: dict = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> float:
        """The whole step's: ``mb * fb + opt``."""
        return self.mb * self.fb_flops + self.opt_flops

    @property
    def bytes(self) -> float:
        return self.mb * self.fb_bytes + self.opt_bytes

    @property
    def once_flops(self) -> float:
        """As traced: one microbatch, and the optimizer."""
        return self.fb_flops + self.opt_flops

    @property
    def once_bytes(self) -> float:
        return self.fb_bytes + self.opt_bytes


def _meta_state(model, mp: bool) -> dict:
    params = tree_map(torch.Tensor.detach, model.param_tree())
    opt = adamw_init(params, mixed_precision=mp)
    if mp:
        params = cast_params(params, torch.bfloat16)
    return {"params": params, "opt": opt}


def _microbatch(batch: dict, mb: int) -> dict:
    """The first of ``mb`` microbatches (views; axis 1 of ``positions``,
    as ``train.step._split``)."""
    def part(name, x):
        if name == "positions" and x.dim() == 3:
            return x[:, :x.shape[1] // mb]
        return x[:x.shape[0] // mb]
    return {k: part(k, v) for k, v in batch.items()}


def trace_step(cfg, shape, mb: int = 1, *, step: str | None = None,
               mp: bool = False, donate: bool = False,
               attention: str = "plain", mesh=None) -> Trace:
    """Run one step of ``cfg`` at ``shape`` on the meta device under a
    :class:`StepCounter`. ``step`` (default: ``shape.kind``):

    * ``"train"``: ``train.step.loss_and_grads`` on one of ``mb``
      microbatches, then ``lr_schedule`` and ``adamw_update`` (in place
      with ``donate``, as the train driver's step); the counts are ``mb``
      times the forward and backward plus the optimizer once, and with
      ``mb > 1`` the f32 gradient accumulators are added to the
      temporaries;
    * ``"prefill"``: ``apply`` and ``unembed`` of the last position (audio:
      ``encode`` and ``_cross_kv``), as the reference's ``lower_prefill``;
    * ``"decode"``: ``decode_step`` over ``init_cache(B, S)``;
    * ``"loss"``: the scoring forward ``model.loss(batch)``.

    ``attention``: ``"plain"`` (the model's path off the card) or
    ``"kernel"`` (:func:`kernel_attention`).

    ``mesh`` (a mesh over a process group, :func:`fake_mesh`): a train,
    prefill or decode step runs sharded, as one rank of it. The mesh is
    configured, the state (the parameters) placed by the reference's specs
    as DTensors of meta local shards and the batch by ``batch_specs`` (the
    train step cuts each microbatch from the whole batch and places it
    itself: its arguments count the placed batch, the reference's); a
    prefill runs the
    forward on the placed parameters, a decode ``decode_step`` on them
    with the cache placed by ``cache_specs`` (kv heads over "model" where
    ``hkv % tp == 0``) and the tokens by ``P(ba)`` or ``P()``. The counts
    are then this rank's."""
    step = step or shape.kind
    t0 = time.perf_counter()
    model = build_model(cfg, tp=TP, device="meta")
    train = step == "train"
    sharded = mesh is not None and step in ("train", "prefill", "decode")
    if sharded:
        ctx.configure(mesh)
    if train:
        state = _meta_state(model, mp)
        batch = input_specs(cfg, shape)
        args = {"state": state, "batch": batch}
        if sharded:
            # the step places each microbatch itself; the arguments count
            # the batch as the reference's in_shardings place it
            args = {"state": place_state(state, mesh, device="meta"),
                    "batch": place_batch(batch, cfg, shape, mesh,
                                         device="meta")}
    elif step == "decode":
        args = {"params": model.param_tree(),
                **input_specs(cfg, shape, model=model)}
        if sharded:
            args["params"] = place_params(args["params"], mesh,
                                          device="meta")
            args["cache"] = place_cache(
                args["cache"], cfg, shape.batch, mesh,
                model.hkv % mesh.shape["model"] == 0, device="meta")
            args["tokens"] = place_tokens(args["tokens"], mesh,
                                          device="meta")
    else:
        params = model.param_tree()
        batch = input_specs(cfg, dataclasses.replace(shape, kind="prefill"))
        if sharded:
            params = place_params(params, mesh, device="meta")
            batch = place_batch(batch, cfg, shape, mesh, device="meta")
        args = {"params": params, "batch": batch}
    counter = StepCounter(args)
    att = (kernel_attention(counter) if attention == "kernel"
           else contextlib.nullcontext())
    fb = fb_coll = None
    with counter, att:
        if train:
            state = args["state"]
            _, grads = loss_and_grads(model, state["params"],
                                      _microbatch(batch, mb))
            fb = (counter.flops, counter.bytes)
            fb_coll = copy.deepcopy(counter.collectives)
            lr = lr_schedule(state["opt"]["step"] + 1)
            new_p, new_opt, gnorm = adamw_update(
                state["params"], grads, state["opt"], lr, inplace=donate)
            del grads
            out = {"state": {"params": new_p, "opt": new_opt},
                   "metrics": {"gnorm": gnorm, "lr": lr}}
        elif step == "decode":
            out = model.decode_step(args["cache"], args["tokens"],
                                    params=args["params"] if sharded
                                    else None)
        elif step == "loss":
            out = model.loss(args["batch"])
        else:
            out = _prefill(model, args["params"], args["batch"])
    total = (counter.flops, counter.bytes)
    fb = fb or total
    temp = counter.peak_bytes
    if train and mb > 1:
        temp += sum(4 * p.numel() for p in _tensors(args["state"]["params"]))
    arg_ids = {id(t.untyped_storage()) for t in _tensors(args)}
    out_stores = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                  for t in _tensors(out)}
    output_bytes = sum(n for k, n in out_stores.items() if k not in arg_ids)
    axes = {} if not sharded else {
        str(mesh.device_mesh.get_group(a).group_name): a
        for a in mesh.axis_names}
    return Trace(fb_flops=float(fb[0]), fb_bytes=float(fb[1]),
                 opt_flops=float(total[0] - fb[0]),
                 opt_bytes=float(total[1] - fb[1]), mb=mb if train else 1,
                 argument_bytes=counter.argument_bytes,
                 output_bytes=output_bytes, temp_bytes=temp,
                 seconds=time.perf_counter() - t0, arguments=args,
                 outputs=out,
                 fb_collectives=fb_coll or counter.collectives,
                 opt_collectives=_mix(counter.collectives, fb_coll, y=-1)
                 if fb_coll else collective_bytes(""),
                 collectives_by_axis={axes.get(g, g): kinds for g, kinds
                                      in counter.by_group.items()})


def _prefill(model, params, batch):
    """The reference's ``lower_prefill``: the last position's logits (audio:
    the encoder's last frame and every layer's cross-attention K/V), of
    ``params`` (the module's own, or a placed tree)."""
    with torch.no_grad():
        if model.cfg.family == "audio":
            enc = model._encode(params, batch["enc_embeds"], remat=False)
            return (enc[:, -1],) + model._cross_kv(params, enc)
        h = model._hidden(params, batch, remat=False)
        return L.unembed(h[:, -1:], params["embed"])[:, 0]


def _mix(a: dict, b: dict, x: int = 1, y: int = 1) -> dict:
    """Collective counts ``x a + y b`` (``collective_bytes``'s layout)."""
    out = {k: x * a[k] + y * b[k] for k in a if k != "counts"}
    out["counts"] = {k: x * a["counts"][k] + y * b["counts"][k]
                     for k in a["counts"]}
    return out


def step_collectives(tr: "Trace") -> dict:
    """The whole step's collectives (``collective_bytes``'s layout):
    ``mb`` times one microbatch's forward and backward plus the
    optimizer's, as the reference's ``cost_cell`` combines them."""
    return _mix(tr.fb_collectives, tr.opt_collectives, tr.mb)


def roofline_hw(cfg):
    """The H100's rates for ``cfg``'s matrix products: bf16 on the tensor
    cores, f32 outside them (TF32 off)."""
    return H100 if cfg.dtype == "bfloat16" else H100_F32


# ---------------------------------------------------------------------------
# the production meshes' spec trees
# ---------------------------------------------------------------------------

def _arg_specs(cfg, shape, mesh, model, *, fsdp: bool = True,
               mp: bool = False) -> dict:
    """The step's argument specs over ``mesh``, as the reference's
    ``lower_*`` shard them; ``configure``s the mesh first, as there."""
    tp, dsize = mesh.shape["model"], data_size(mesh)
    ctx.configure(mesh)
    params = model.param_tree()
    p_specs = tree_param_specs(params, tp, dsize, fsdp=fsdp)
    if shape.kind == "train":
        o_specs = {"m": p_specs, "v": p_specs, "step": P()}
        if mp:
            o_specs["master"] = p_specs
        return {"state": {"params": p_specs, "opt": o_specs},
                "batch": batch_specs(batch_axes(mesh), cfg, shape)}
    if shape.kind == "prefill":
        return {"params": p_specs,
                "batch": batch_specs(batch_axes(mesh), cfg, shape)}
    ba = batch_axes(mesh) if shape.batch >= dsize else None
    return {"params": p_specs,
            "cache": cache_specs(batch_axes(mesh), cfg, shape.batch,
                                 model.hkv % tp == 0, dsize),
            "tokens": P(ba) if ba else P()}


def _pairs_of(specs, tree, path=""):
    """(path, spec, leaf) over a spec tree and the tree it describes."""
    if isinstance(specs, dict):
        for k, s in specs.items():
            yield from _pairs_of(s, tree[k], f"{path}/{k}" if path else k)
    elif isinstance(specs, (tuple, list)) and not isinstance(specs, P):
        for i, s in enumerate(specs):
            yield from _pairs_of(s, tree[i], f"{path}/{i}")
    else:
        yield path, specs, tree


def _shards(spec, mesh) -> list[int]:
    """Mesh devices over each dimension a spec names."""
    out = []
    for part in spec:
        names = () if part is None else (
            part if isinstance(part, tuple) else (part,))
        out.append(math.prod(mesh.shape[a] for a in names))
    return out


def check_specs(specs, tree, mesh) -> int:
    """Every dimension a spec shards divides evenly over its mesh axes
    (raises ``ValueError`` naming the leaf otherwise), as the reference's
    ``jax.jit`` refuses ``in_shardings`` that do not (an uneven split
    inside the step, a microbatch's rows, is padded there and traced
    here); returns the leaves checked."""
    n = 0
    for path, spec, leaf in _pairs_of(specs, tree):
        if not isinstance(leaf, torch.Tensor):
            continue                     # the cache's host-int length
        shards = _shards(spec, mesh)
        if len(shards) > leaf.dim():
            raise ValueError(f"{path}: spec {spec} names {len(shards)} "
                             f"dimensions of a {leaf.dim()}-d leaf")
        for d, k in enumerate(shards):
            if leaf.shape[d] % k:
                raise ValueError(f"{path}: dimension {d} of "
                                 f"{tuple(leaf.shape)} does not split over "
                                 f"{k} devices ({spec})")
        n += 1
    return n


def per_device_bytes(specs, tree, mesh) -> int:
    """Bytes of a tree's tensors on the device that holds the most: each
    leaf's largest shard, every dimension its spec shards over k devices
    cut to ceil(n / k) (XLA's padded split, ``torch.chunk``'s first part);
    a tree with no specs: whole."""
    if specs is None:
        return sum(_nbytes(t) for t in _tensors(tree))
    return sum(leaf.element_size() * math.prod(
                   -(-n // k) for n, k in zip(
                       leaf.shape, _shards(spec, mesh)
                       + [1] * (leaf.dim() - len(spec))))
               for _, spec, leaf in _pairs_of(specs, tree)
               if isinstance(leaf, torch.Tensor))


# ---------------------------------------------------------------------------
# cell driver
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_mesh(shape, axis_names):
    """A mesh of ``shape`` over a ``fake``-backend process group of its
    size in this process (this process its rank 0), carrying its
    ``DeviceMesh``: DTensors on it hold meta local shards, and the
    collectives they issue run no communication (their meta kernels give
    the outputs' shapes). The group is destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import init_mesh
    if dist.is_initialized():
        raise RuntimeError("the dry run's fake mesh needs a process with no "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_mesh(shape, axis_names, "cpu")
    finally:
        dist.destroy_process_group()


def production_mesh(mesh_kind: str):
    """The reference's production mesh of ``mesh_kind`` ("single": (data
    16, model 16), "multi": (pod 2, data 16, model 16)) over a fake
    process group (:func:`fake_mesh`); "none": no mesh."""
    if mesh_kind == "none":
        return contextlib.nullcontext()
    if mesh_kind == "multi":
        return fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return fake_mesh((16, 16), ("data", "model"))


def run_cell(arch: str, shape_name: str, mesh_kind: str, mode: str,
             out_dir: str, fsdp: bool = True, mp: bool = False,
             moe_dispatch: str = "global", tag: str = "",
             cfg=None) -> dict:
    """One cell's record, written to ``out_dir``; ``cfg`` replaces
    ``ARCHS[arch]`` (a cut of it; the record keeps ``arch``'s name)."""
    cfg = cfg or ARCHS[arch]
    if moe_dispatch != "global" and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=moe_dispatch))
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "mode": mode, "fsdp": fsdp, "mp": mp,
                 "moe_dispatch": moe_dispatch, "tag": tag}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec["skipped"] = reason
        _save(rec, out_dir)
        return rec

    prev_devices = ctx.set_host_device_count(HOST_DEVICES)
    prev_ctx = ctx._CTX
    try:
        with production_mesh(mesh_kind) as mesh:
            _cell(rec, cfg, shape, mesh, mode, fsdp, mp)
    finally:
        ctx.set_host_device_count(prev_devices)
        ctx._CTX = prev_ctx

    _save(rec, out_dir)
    return rec


def _cell(rec, cfg, shape, mesh, mode, fsdp, mp) -> None:
    """``run_cell``'s counts into ``rec``."""
    mesh_kind = rec["mesh"]
    chips = 1 if mesh is None else mesh.size
    mb = MICROBATCHES.get(rec["arch"], 1) if shape.kind == "train" else 1
    rec["chips"] = chips
    rec["microbatches"] = mb
    sharded = mesh is not None
    cost = mode in ("cost", "both") and mesh_kind != "multi"
    # one trace serves both modes
    trace = trace_step(cfg, shape, mb, mp=mp, mesh=mesh)
    model = build_model(cfg, tp=TP, device="meta")
    if sharded:
        coll = step_collectives(trace)
        once = _mix(trace.fb_collectives, trace.opt_collectives)
    else:
        coll = once = collective_bytes("")
    if mode in ("compile", "both"):
        rec["lower_s"] = round(trace.seconds, 1)
        t0 = time.time()
        if sharded:
            check_specs(_arg_specs(cfg, shape, mesh, model, fsdp=fsdp,
                                   mp=mp), _full(trace.arguments), mesh)
        rec["compile_s"] = round(time.time() - t0, 1)
        rec["memory"] = {"argument_size_in_bytes": trace.argument_bytes,
                         "output_size_in_bytes": trace.output_bytes,
                         "temp_size_in_bytes": trace.temp_bytes}
        rec["hlo_once"] = {"flops": trace.once_flops,
                           "bytes": trace.once_bytes, "collectives": once}
        if sharded:
            rec["hlo_once"]["collectives_by_axis"] = \
                trace.collectives_by_axis
    if cost:
        # a sharded trace counts one device: the whole step is chips times
        per = chips if sharded else 1
        flops, byts = trace.flops * per, trace.bytes * per
        rec["cost_s"] = round(trace.seconds, 1)
        mf = model_flops(cfg, model, shape)
        hw = HW if sharded else roofline_hw(cfg)
        rec["cost"] = {
            "hlo_flops": flops, "hlo_bytes": byts,
            "hlo_flops_per_chip": flops / chips,
            "collective_bytes_per_chip": float(coll["total"]),
            "model_flops": mf,
            "useful_ratio": mf / flops if flops else 0.0,
        }
        if sharded:
            rec["cost"]["collectives"] = coll
        rec["roofline"] = {**roofline_terms(
            flops, byts, float(coll["total"]), chips, hw), "hw": hw.name}


def _full(tree):
    """A tree whose DTensor leaves stand as their global shapes (meta
    tensors), for :func:`check_specs`."""
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    if ctx.is_dtensor(tree):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def _save(rec: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}"
    if not rec.get("fsdp", True):
        name += "_nofsdp"
    if rec.get("tag"):
        name += "_" + rec["tag"]
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["none", "single", "multi"])
    ap.add_argument("--mode", default="both",
                    choices=["compile", "cost", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--mp", action="store_true",
                    help="bf16 live params + f32 master (halves gathers)")
    ap.add_argument("--moe-dispatch", default="global",
                    choices=["global", "sharded", "shardmap"])
    ap.add_argument("--tag", default="", help="output filename suffix")
    args = ap.parse_args(argv)
    ctx.set_host_device_count(HOST_DEVICES)
    rec = run_cell(args.arch, args.shape, args.mesh, args.mode, args.out,
                   fsdp=not args.no_fsdp, mp=args.mp,
                   moe_dispatch=args.moe_dispatch, tag=args.tag)
    print(json.dumps(rec, indent=1, default=str))


if __name__ == "__main__":
    main()
