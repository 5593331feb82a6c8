"""Parameter / activation partition specs (the parallel plan).

The port of ``repro.sharding.specs``: the same rules, over the port's own
spec type (:class:`PartitionSpec`, a tuple of mesh-axis names, tuples of
them, or ``None``, one entry per tensor dimension from the front).

Baseline plan:
  * TP  ("model"): attention heads (padded per head_plan), FFN hidden,
    MoE experts, mamba d_inner, vocab rows;
  * FSDP ("data"): a second weight axis (ZeRO-3-style; optimizer states
    inherit it);
  * DP  ("pod","data"): the batch.

Rules are (regex over the param path, axis-from-end for "model"); axes only
shard when divisible: non-divisible cases fall back to replication, which
keeps every architecture placeable on the same mesh. :func:`placements`
turns a spec into the DTensor placements of a ``DeviceMesh`` (the port's
``NamedSharding``).
"""
from __future__ import annotations

import math
import re


class PartitionSpec(tuple):
    """A tuple of mesh-axis names (or tuples of them, or ``None``), one
    entry per leading tensor dimension; it compares as the tuple of its
    entries, element by element with ``jax.sharding.PartitionSpec``'s.
    As there, an entry that is a tuple of one name is that name, and an
    empty tuple is ``None``."""

    def __new__(cls, *parts):
        def norm(part):
            if isinstance(part, tuple) and len(part) <= 1:
                return part[0] if part else None
            return part
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def placements(spec, device_mesh) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh`` (anything with
    ``mesh_dim_names``): a mesh axis named in entry ``i`` shards tensor
    dimension ``i`` over that mesh dimension (``Shard(i)``); a tuple entry
    such as ``("pod", "data")`` shards it over each, the major axis first,
    as jax lays it out (DTensor's default order is the mesh's, and a spec's
    tuple names its axes in mesh order); a mesh axis no entry names is
    ``Replicate()``. A name the mesh lacks raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        for name in entry if isinstance(entry, tuple) else (entry,):
            if name is None:
                continue
            if name not in names:
                raise ValueError(f"spec {spec!r} names {name!r}, not an "
                                 f"axis of the mesh {names}")
            out[names.index(name)] = Shard(i)
    return tuple(out)

# (path regex, axis_from_end that takes the TP axis)
_TP_RULES: tuple[tuple[str, int], ...] = (
    (r"(^|/)embed$", -2),
    (r"(^|/)(enc_pos|dec_pos)$", -2),
    (r"moe/(w1|w3)$", -3),          # [L,E,d,ff]: experts
    (r"moe/w2$", -3),
    (r"(^|/)gate$", 99),            # replicate router
    (r"x?attn/wq$", -2),
    (r"x?attn/bq$", -2),
    (r"x?attn/(wk|wv)$", -2),
    (r"x?attn/(bk|bv)$", -2),
    (r"x?attn/wo$", -3),
    (r"(^|/)mlp/(w1|w3)$", -1),
    (r"(^|/)mlp/w2$", -2),
    (r"mamba/in_proj$", -1),
    (r"mamba/(conv_w|conv_b|dt_proj|dt_bias|D)$", -1),
    (r"mamba/(x_proj|A_log|out_proj)$", -2),
    (r"mlstm/wgate$", -1),
    (r"mlstm/(wq|wk|wv)$", -2),
    (r"mlstm/wo$", -3),
    (r"(ln\d?|final_norm|enc_final_norm|bf|wi|wf)$", 99),
)

_FSDP_MIN_SIZE = 1 << 20            # only shard weights >= 1M elements


def grid_batch_spec() -> P:
    """Spec for one row array of the scheduler's combined grid launch.

    Every row tensor of the greedy fan-out (dur, work, lp, budgets, masks,
    est, lst, orders; see ``core.greedy_torch.greedy_fanout_grid_torch``)
    stacks per-(instance, bucket) rows on its leading axis; under
    ``ctx.grid_mesh`` that axis splits over "data" and all trailing axes
    stay whole within a shard.
    """
    return P("data")


def _tp_axis(path: str) -> int | None:
    for pat, ax in _TP_RULES:
        if re.search(pat, path):
            return None if ax == 99 else ax
    return None


def param_spec(path: str, shape: tuple[int, ...], tp: int, dsize: int,
               fsdp: bool = True) -> P:
    spec: list = [None] * len(shape)
    ax = _tp_axis(path)
    if ax is not None and len(shape) >= abs(ax):
        i = len(shape) + ax
        if shape[i] % tp == 0 and shape[i] >= tp:
            spec[i] = "model"
    if fsdp and math.prod(shape) >= _FSDP_MIN_SIZE:
        # largest remaining axis divisible by the data size
        cands = [(shape[i], i) for i in range(len(shape))
                 if spec[i] is None and shape[i] % dsize == 0
                 and shape[i] >= dsize]
        if cands:
            _, i = max(cands)
            spec[i] = "data"
    return P(*spec)


def tree_param_specs(params_shape, tp: int, dsize: int, fsdp: bool = True):
    """Map a dict tree of arrays, tensors or shapes -> the same tree of
    :class:`PartitionSpec`."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in tree.items()}
        shape = tuple(int(s) for s in getattr(tree, "shape", tree))
        return param_spec(path, shape, tp, dsize, fsdp)
    return walk(params_shape, "")


def batch_specs(batch_axes: tuple[str, ...], cfg, shape_cfg):
    """Specs for the input batch of a train/prefill step."""
    ba = batch_axes
    if cfg.family == "vlm":
        return {"embeds": P(ba, None, None), "positions": P(None, ba, None),
                "labels": P(ba, None)}
    if cfg.family == "audio":
        return {"enc_embeds": P(ba, None, None), "dec_tokens": P(ba, None),
                "labels": P(ba, None)}
    return {"tokens": P(ba, None), "labels": P(ba, None)}


def cache_specs(batch_axes: tuple[str, ...], cfg, batch: int,
                kv_shardable: bool, data_size: int):
    """Specs for the serve_step cache tree.

    B >= data_size: shard batch; else (long-context B=1) shard the cache
    *sequence* axis over "data" (flash-decoding style partial softmax).
    """
    ba: tuple | None = batch_axes
    seq_ax = None
    if batch < data_size:
        ba = None
        seq_ax = "data"
    h_ax = "model" if kv_shardable else None

    def kv():
        # [L, B, S, H, hd]
        return P(None, ba, seq_ax, h_ax, None)

    specs = {"len": P()}
    if cfg.family in ("dense", "vlm", "moe", "audio"):
        specs["k"] = kv()
        specs["v"] = kv()
        if cfg.family == "audio":
            specs["xk"] = kv()
            specs["xv"] = kv()
    elif cfg.family == "hybrid":
        specs["k"] = kv()
        specs["v"] = kv()
        specs["conv"] = P(None, ba, None, "model")
        specs["ssm"] = P(None, ba, "model", None)
    elif cfg.family == "ssm":
        specs["C"] = P(None, ba, None, None, None)
        specs["n"] = P(None, ba, None, None)
        specs["c_s"] = P(None, ba, None, None)
        specs["h_s"] = P(None, ba, None, None)
    return specs
