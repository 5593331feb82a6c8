"""Train step: microbatched gradient accumulation + AdamW (the port of
``repro.train.step``).

The state is the reference's dict, ``{"params", "opt": {"m", "v", "step"[,
"master"]}}``, of tensors on the model's device, so the port's
``CheckpointManager`` and ``runtime.fault.run_with_restarts`` take it as
they are. A state read back from a checkpoint (numpy leaves, bf16 leaves as
CPU tensors) is moved to the model's device by the step itself.

Under a mesh (:func:`repro_torch.sharding.ctx.configure`) the state is
placed by :func:`repro_torch.sharding.place.place_state` and the step is the
reference's sharded step: each (micro)batch is split from the global batch
and then placed by ``batch_specs`` (rows that do not split evenly over the
batch axes as DTensor's uneven parts, where the reference's ``jit`` pads
them), the gradients come back in their parameters' placements, and the
metrics are replicated 0-d DTensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.sharding import ctx
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         cast_params, compress_grads,
                                         lr_schedule, tree_leaves, tree_map,
                                         tree_unflatten)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any

    def tree(self):
        return {"params": self.params, "opt": self.opt}


def init_state(model, generator: torch.Generator,
               mixed_precision: bool = False) -> dict:
    """The model's parameters drawn from ``generator`` (``model.init``)
    in a fresh state with zero AdamW moments; with ``mixed_precision`` the
    live parameters are bf16 and the optimizer keeps an f32 master. The
    state's f32 parameters are the module's own tensors, not a copy (at
    full width a copy is one more parameter tree on the card): a step of
    ``make_train_step(donate=True)`` trains the module's parameters in
    place, a functional step leaves them as drawn."""
    model.init(generator)
    params = tree_map(torch.Tensor.detach, model.param_tree())
    opt = adamw_init(params, mixed_precision=mixed_precision)
    if mixed_precision:
        params = cast_params(params, torch.bfloat16)
    return {"params": params, "opt": opt}


def on_device(tree, device):
    """Every leaf of ``tree`` as a tensor on ``device`` (numpy arrays and
    scalars converted, tensors moved; a leaf already there, or a DTensor,
    is kept)."""
    return tree_map(lambda x: x if ctx.is_dtensor(x)
                    else torch.as_tensor(x, device=device), tree)


def _split(name: str, x, microbatches: int):
    """A batch leaf as ``microbatches`` equal parts along its batch axis:
    axis 1 of the VLM's M-RoPE ``positions`` [3, B, S], axis 0 of any
    other leaf. The reference's ``split_mb`` takes axis 1 of any [3, ., .]
    leaf, the same leaves in every family batch but one of 3 rows."""
    x = np.asarray(x)
    if name == "positions" and x.ndim == 3:
        return x.reshape((3, microbatches, x.shape[1] // microbatches)
                         + x.shape[2:]).swapaxes(0, 1)
    return x.reshape((microbatches, x.shape[0] // microbatches)
                     + x.shape[1:])


def loss_and_grads(model, params, batch, microbatches: int = 1):
    """The mean loss of ``batch`` and its gradients in ``params`` (per-layer
    remat). With ``microbatches`` > 1 the batch is split along its batch
    axis (:func:`_split`) into equal parts whose gradients are summed into
    f32 accumulators, and the sums divided, as the reference's scan
    does.

    DTensor ``params`` (a placed state): each microbatch is cut from the
    global batch first and then placed by ``batch_specs``
    (:func:`repro_torch.sharding.place.place_batch`), and each gradient is
    redistributed to its parameter's placements."""
    sharded = ctx.is_dtensor(tree_leaves(params)[0])

    def value_and_grad(mb):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        if sharded:
            from repro_torch.sharding.place import place_batch
            mb = place_batch(mb, model.cfg)
        with torch.enable_grad():
            loss = model.loss(mb, params=live, remat=True)
            grads = torch.autograd.grad(loss, leaves)
        if sharded:
            grads = [g if g.placements == p.placements
                     else g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, leaves)]
        return loss.detach(), tree_unflatten(live, grads)

    if microbatches == 1:
        return value_and_grad(batch)
    mbs = {k: _split(k, v, microbatches) for k, v in batch.items()}
    gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
    lsum = 0.0
    for i in range(microbatches):
        loss, g = value_and_grad({k: v[i] for k, v in mbs.items()})
        gsum = tree_map(torch.add, gsum, g)
        lsum = lsum + loss
    return lsum / microbatches, tree_map(lambda g: g / microbatches, gsum)


def make_train_step(model, *, microbatches: int = 1, peak_lr: float = 3e-4,
                    total_steps: int = 10_000, warmup: int = 200,
                    grad_compress: bool = False, donate: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss
    and its gradients (:func:`loss_and_grads`), then one AdamW step at the
    warmup+cosine learning rate. ``metrics`` holds the loss, the gradients'
    global norm and the learning rate, as 0-d tensors.

    ``donate``: the step writes the new parameters and moments into the
    state's own tensors (``adamw_update(inplace=True)``, the same bits) and
    returns them, so the caller must not use the old state again; without
    it the old state stays valid, at the cost of a second copy on the card
    during the update (at full width, Whisper's 27 GiB of f32 parameters
    and moments do not fit twice beside its gradients)."""

    def train_step(state, batch):
        state = on_device(state, model.device)
        params = state["params"]
        loss, grads = loss_and_grads(model, params, batch, microbatches)
        grads = compress_grads(grads, grad_compress)
        lr = lr_schedule(state["opt"]["step"] + 1, peak=peak_lr,
                         warmup=warmup, total=total_steps)
        new_params, new_opt, gnorm = adamw_update(
            params, grads, state["opt"], lr, inplace=donate)
        metrics = {"loss": loss, "gnorm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
