"""Port parity, the decode step under the parallel plan: the port's
``decode_step(cache, tokens, params=)`` on a (data=2, model=2) mesh of 4
``gloo`` processes against the reference's ``decode_step`` jitted as its
``lower_decode`` shards it, and against the port's own unsharded step.

A job is one reduced f32 configuration (``reduced``, as the reference's
CPU tests cut it) at a batch of B rows: B=4 splits the rows over "data"
(the batch branch), B=1 splits the cache's sequence over "data" (the
sequence branch: each rank attends over its own positions and the parts
are combined across "data", flash-decoding). A B=4 job runs :data:`STEPS`
greedy decode steps from an empty cache of :data:`MAX_LEN` positions; a
B=1 job runs :data:`SEQ_STEPS` from an empty cache of :data:`SEQ_LEN`,
so its steps cross from the first data rank's half of the positions into
the second's (the write by the rank that holds the slot, the combine of
two ranks' parts) and then past the end (the write clamped to the last
slot, as the reference's ``dynamic_update_slice`` clamps it). Whisper's
cross-attention K/V are filled by the reference's ``prefill`` of as many
seed-made frames as the cache has positions, which the B=1 job splits
over "data" too. For each job:

* this process makes the parameters from a seed with the reference's
  ``model.init`` (jax, one device), the starting cache and the first
  tokens, and writes them to a file;
* the reference, in one subprocess with 4 host devices on a
  ``jax.sharding.Mesh`` of Auto axes built directly (never
  ``jax.make_mesh``), jits ``model.decode_step`` with ``in_shardings``
  and ``out_shardings`` as ``lower_decode`` builds them (parameters by
  ``tree_param_specs``, the cache by ``cache_specs``, the tokens by
  ``P(ba)`` or ``P()``, the logits by ``P(ba, v_ax)``) and runs the steps;
* the port, in 4 spawned ``gloo`` processes on a (2, 2) ``DeviceMesh``,
  reads the parameters with ``interop.load_params``, places them
  (``place.place_params``), the cache (``place.place_cache``) and runs
  the steps; rank 0 writes the gathered logits and the final cache;
* the port, unsharded, in this process meanwhile.

Tolerances: each step's logits within :data:`RTOL` of the largest
magnitude of the other side's (max |a - b| <= 1e-5 max |b|: the two sides
add the same f32 products in other orders, and the sequence branch
normalises its softmax once at the end where the reference normalises
the weights first), the greedy tokens identical, every leaf of the final
cache within the same bound. Measured on the CPU: the largest relative
differences 2.8e-6 (logits) and 2.1e-6 (cache), both xLSTM's; the file
~46-70 s in one process on 8 cores.

Where the reference's own lowering refuses a case, the port refuses it:
granite-moe's ``shardmap`` dispatch at B=1 (one token over two data
ranks: the reference's ``assert nt % ds == 0``), and a B=1 cache whose
positions do not divide over "data" (``jax.jit``'s ``in_shardings``
check; the port's ``place_cache``). A finding, not a gate:
``pytest -s -k beside`` prints the port's decode collectives (its step
traced on a fake (2, 2) mesh, ``launch.dryrun``) beside the reference's
(``collective_bytes`` of its compiled step).
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch.configs import ShapeConfig
from repro_torch.interop import load_params
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.sharding import ctx

from test_torch_mesh_moe import SRC, TIMEOUT, _join

RTOL = 1e-5
STEPS, MAX_LEN = 6, 16          # the batch branch (B=4)
SEQ_STEPS, SEQ_LEN = 10, 8      # the sequence branch (B=1): past the end
TP = 2


def job(name, arch, B, dispatch=None, max_len=None) -> dict:
    steps, length = (STEPS, MAX_LEN) if B >= 2 else (SEQ_STEPS, SEQ_LEN)
    return {"name": name, "arch": arch, "B": B, "dispatch": dispatch,
            "steps": steps, "max_len": max_len or length}


def job_cfg(j):
    cfg = TC.reduced(TC.ARCHS[j["arch"]])
    if j["dispatch"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=j["dispatch"]))
    return cfg


JOBS = [
    job("dense_b4", "smollm-360m", 4), job("dense_b1", "smollm-360m", 1),
    # one kv head (MQA): the kv heads replicated over "model", each rank
    # reading its q heads' group
    job("mqa_b4", "granite-34b", 4), job("mqa_b1", "granite-34b", 1),
    job("vlm_b4", "qwen2-vl-7b", 4), job("vlm_b1", "qwen2-vl-7b", 1),
    job("hybrid_b4", "jamba-v0.1-52b", 4),
    job("hybrid_b1", "jamba-v0.1-52b", 1),
    job("audio_b4", "whisper-large-v3", 4),
    job("audio_b1", "whisper-large-v3", 1),
    job("ssm_b4", "xlstm-125m", 4), job("ssm_b1", "xlstm-125m", 1),
    *(job(f"moe_{d}_b4", "granite-moe-1b-a400m", 4, d)
      for d in ("global", "sharded", "shardmap")),
]
# the reference's lowering refuses: one token over two data ranks; 15
# positions over two data ranks
REFUSED = [job("moe_shardmap_b1", "granite-moe-1b-a400m", 1, "shardmap"),
           job("dense_b1_uneven", "smollm-360m", 1, max_len=15)]
JOB = {j["name"]: j for j in JOBS + REFUSED}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _tree(flat: dict, prefix: str) -> dict:
    """The nested dict of ``flat``'s ``prefix/...`` entries."""
    tree: dict = {}
    for path, arr in flat.items():
        if not path.startswith(prefix + "/"):
            continue
        node = tree
        *head, last = path[len(prefix) + 1:].split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = arr
    return tree


def _start(j, tmp):
    """The job's parameters (the reference's ``init`` of seed 0), its
    starting cache (zeros; Whisper's cross K/V from the reference's
    ``prefill``) and first tokens, written to ``<name>_init.npz``."""
    import jax

    from repro.models import build_model as ref_build

    cfg = job_cfg(j)
    B, S = j["B"], j["max_len"]
    model = ref_build(cfg, tp=TP)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    if cfg.family == "audio":
        enc = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        cache = model.prefill(params, model.init_cache(B, S, S), enc)
    else:
        cache = model.init_cache(B, S)
    out = {f"params/{k}": np.asarray(v) for k, v in _flat(params).items()}
    out.update({f"cache/{k}": np.asarray(v) for k, v in cache.items()
                if k != "len"})
    out["tokens"] = rng.integers(1, cfg.vocab, B).astype(np.int32)
    np.savez(tmp / f"{j['name']}_init.npz", **out)


def _port_inputs(j, path, device="cpu"):
    """The port's model (the reference's parameters read by
    ``load_params``), cache (``"len"`` 0) and first tokens."""
    init = dict(np.load(path))
    model = build_model(job_cfg(j), tp=TP, device=device)
    load_params(model, _tree(init, "params"))
    cache = {k: torch.from_numpy(v) for k, v in _tree(init, "cache").items()}
    cache["len"] = 0
    return model, cache, torch.from_numpy(init["tokens"]).long()


def _decode(j, model, cache, tok, params=None):
    """The job's greedy steps: each step's full logits and tokens, and the
    final cache."""
    out = {}
    for s in range(j["steps"]):
        logits, cache = model.decode_step(cache, tok, params=params)
        if ctx.is_dtensor(logits):
            out["placements"] = str(logits.placements)
            logits = logits.full_tensor()
        tok = logits.argmax(-1)
        out[f"logits{s}"] = logits.numpy()
        out[f"tokens{s}"] = tok.numpy()
    return out, cache


# --- the ranks -----------------------------------------------------------


def _mesh_rank(rank, world, jobs, tmp, out_dir):
    """One rank of the (2, 2) mesh (spawned): every job's placed decode
    steps; rank 0 writes ``out_dir/<name>.npz`` (or ``<name>.json`` with
    the refusal's message)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.sharding import place

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = launch_mesh.init_mesh((2, 2), ("data", "model"), "cpu")
        for j in jobs:
            model, cache, tok = _port_inputs(
                j, os.path.join(tmp, j["name"] + "_init.npz"))
            ctx.configure(mesh)
            params = place.place_params(model.param_tree(), mesh)
            try:
                placed = place.place_cache(cache, model.cfg, j["B"], mesh,
                                           model.hkv % TP == 0)
                out, placed = _decode(j, model, placed, tok, params)
            except ValueError as e:
                if rank == 0:
                    with open(os.path.join(out_dir, j["name"] + ".json"),
                              "w") as f:
                        json.dump({"refused": str(e)}, f)
                ctx.reset()
                continue
            full = place.gather_state(placed)
            out.update({f"cache/{k}": v.numpy() for k, v in full.items()
                        if k != "len"})
            out["len"] = np.asarray(full["len"])
            if rank == 0:
                np.savez(os.path.join(out_dir, j["name"] + ".npz"), **out)
            ctx.reset()
        dist.barrier()
    finally:
        ctx.reset()
        dist.destroy_process_group()


# --- the reference's sharded decode, in a subprocess -----------------------

_REF = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r})
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, NamedSharding
from repro.configs import ARCHS, reduced
from repro.models import build_model
from repro.roofline.analysis import collective_bytes
from repro.sharding.ctx import configure
from repro.sharding.specs import P, cache_specs, tree_param_specs

mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
configure(mesh)


def ns(tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


def tree(flat, prefix):
    out = {{}}
    for path, arr in flat.items():
        if not path.startswith(prefix + "/"):
            continue
        node = out
        *head, last = path[len(prefix) + 1:].split("/")
        for p in head:
            node = node.setdefault(p, {{}})
        node[last] = arr
    return out


for job in json.loads({jobs!r}):
    cfg = reduced(ARCHS[job["arch"]])
    if job["dispatch"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=job["dispatch"]))
    B = job["B"]
    model = build_model(cfg, tp={tp})
    init = dict(np.load(os.path.join({tmp!r}, job["name"] + "_init.npz")))
    params = tree(init, "params")
    cache = tree(init, "cache")
    cache["len"] = jnp.zeros((), jnp.int32)
    tok = jnp.asarray(init["tokens"])
    # lower_decode's shardings
    ba = ("data",) if B >= 2 else None
    c_specs = cache_specs(("data",), cfg, B, model.hkv % {tp} == 0, 2)
    v_ax = "model" if cfg.vocab % {tp} == 0 else None
    fn = jax.jit(model.decode_step,
                 in_shardings=(ns(tree_param_specs(params, {tp}, 2)),
                               ns(c_specs), NamedSharding(mesh, P(ba)
                                                          if ba else P())),
                 out_shardings=(NamedSharding(mesh, P(ba, v_ax) if ba
                                              else P(None, v_ax)),
                                ns(c_specs)))
    out = {{}}
    try:
        step = fn.lower(params, cache, tok).compile()
    except Exception as e:
        out["refused"] = np.asarray(f"{{type(e).__name__}}: {{e}}")
        np.savez(os.path.join({tmp!r}, job["name"] + "_ref.npz"), **out)
        continue
    out["collectives"] = np.asarray(json.dumps(collective_bytes(
        step.as_text())))
    for s in range(job["steps"]):
        logits, cache = step(params, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out[f"logits{{s}}"] = np.asarray(logits)
        out[f"tokens{{s}}"] = np.asarray(tok)
    for k, v in cache.items():
        out["len" if k == "len" else "cache/" + k] = np.asarray(v)
    np.savez(os.path.join({tmp!r}, job["name"] + "_ref.npz"), **out)
print("REF_DECODE_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job once: the reference (one subprocess), the mesh (4 gloo
    ranks) and the port unsharded (here, meanwhile). ``{name: {"ref",
    "mesh", "plain"}}``."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh_decode")
    jobs = JOBS + REFUSED
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    plain = {}
    try:
        for j in jobs:
            _start(j, tmp)
        ref = subprocess.Popen(
            [sys.executable, "-c", _REF.format(
                src=SRC, jobs=json.dumps(jobs), tmp=str(tmp), tp=TP)],
            env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            out_dir = tmp / "mesh"
            out_dir.mkdir()
            procs = mp.start_processes(
                _mesh_rank, args=(4, jobs, str(tmp), str(out_dir)), nprocs=4,
                join=False, start_method="spawn")
            for j in JOBS:
                model, cache, tok = _port_inputs(
                    j, tmp / f"{j['name']}_init.npz")
                out, cache = _decode(j, model, cache, tok)
                out.update({f"cache/{k}": v.numpy()
                            for k, v in cache.items() if k != "len"})
                plain[j["name"]] = out
            _join(procs)
            stdout, stderr = ref.communicate(timeout=TIMEOUT)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    finally:
        torch.set_num_threads(threads)
    assert "REF_DECODE_OK" in stdout, stdout + stderr
    runs = {}
    for j in jobs:
        n = j["name"]
        mesh = tmp / "mesh" / f"{n}.json"
        runs[n] = {"ref": dict(np.load(tmp / f"{n}_ref.npz")),
                   "mesh": json.loads(mesh.read_text()) if mesh.exists()
                   else dict(np.load(tmp / "mesh" / f"{n}.npz")),
                   "plain": plain.get(n)}
    return runs


def _close(got, want, what):
    """max |got - want| <= RTOL max |want|; returns the ratio."""
    top = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert got.shape == want.shape and err <= RTOL * top, \
        f"{what}: max |d| {err} > {RTOL} x {top}"
    return err / top


def _check(got, want, what, steps):
    """Every step's logits and tokens, and the final cache."""
    for s in range(steps):
        _close(got[f"logits{s}"], want[f"logits{s}"], f"{what} logits {s}")
        assert np.array_equal(got[f"tokens{s}"], want[f"tokens{s}"]), \
            f"{what} tokens {s}"
    leaves = sorted(k for k in want if k.startswith("cache/"))
    assert leaves == sorted(k for k in got if k.startswith("cache/"))
    for k in leaves:
        _close(got[k], want[k], f"{what} {k}")


@pytest.mark.parametrize("name", [j["name"] for j in JOBS])
def test_mesh_decode_matches_reference(runs, name):
    """The placed decode steps against the reference's sharded steps; the
    logits placed as ``lower_decode``'s out_shardings place them (rows over
    "data" with B >= 2, the vocabulary over "model")."""
    r, steps = runs[name], JOB[name]["steps"]
    _check(r["mesh"], r["ref"], name, steps)
    assert int(r["mesh"]["len"]) == int(r["ref"]["len"]) == steps
    rows = "Shard(dim=0)" if int(name[-1]) >= 2 else "Replicate()"
    assert str(r["mesh"]["placements"]) == f"({rows}, Shard(dim=1))"


@pytest.mark.parametrize("name", [j["name"] for j in JOBS])
def test_mesh_decode_matches_unsharded(runs, name):
    r = runs[name]
    _check(r["mesh"], r["plain"], name, JOB[name]["steps"])


def test_refusal_is_the_reference_s(runs):
    """granite-moe's shard-map dispatch at B=1: the reference's lowering
    asserts that the tokens split over the batch axes; the port raises
    where that assert stands."""
    r = runs["moe_shardmap_b1"]
    assert str(r["ref"]["refused"]).startswith("AssertionError")
    assert "do not split over the 2 ranks" in r["mesh"]["refused"]


def test_uneven_sequence_refused_as_the_reference(runs):
    """A B=1 cache of 15 positions over two data ranks: the reference's
    ``jax.jit`` refuses the ``in_shardings`` (the dimension does not
    divide), and the port's ``place_cache`` raises before any step (DTensor
    would place it unevenly, and the sequence branch reads every rank's
    part as of one length)."""
    r = runs["dense_b1_uneven"]
    assert "divisible" in str(r["ref"]["refused"])
    assert "dimension 2 (15) does not divide by the 2 devices" in \
        r["mesh"]["refused"]


def test_decode_collectives_beside_the_reference(runs, capsys):
    """A finding, not a gate: per job, the port's decode collectives by
    kind (its step traced as rank 0 of a fake (2, 2) mesh) beside the
    reference's (``collective_bytes`` of its compiled step's HLO). Both
    move bytes; ``pytest -s`` prints the table (PERF.md)."""
    from repro_torch.launch import dryrun as D

    rows = []
    prev = ctx._CTX
    try:
        for j in JOBS:
            with D.fake_mesh((2, 2), ("data", "model")) as mesh:
                tr = D.trace_step(job_cfg(j), ShapeConfig(
                    "mesh", "decode", j["max_len"], j["B"]), mesh=mesh)
            want = json.loads(str(runs[j["name"]]["ref"]["collectives"]))
            rows.append((j["name"], tr.fb_collectives, want,
                         tr.collectives_by_axis))
    finally:
        ctx._CTX = prev
    with capsys.disabled():
        print("\ndecode step, reduced f32, (2, 2) mesh, bytes a device "
              "(port / reference):")
        for name, got, want, by_axis in rows:
            kinds = ", ".join(
                f"{k} {got[k]}/{want[k]}" for k in (
                    "all-gather", "all-reduce", "all-to-all",
                    "collective-permute") if got[k] or want[k])
            print(f"  {name:<16} total {got['total']:>7}/{want['total']:<7}"
                  f" {kinds}; port by axis {by_axis}")
    for name, got, want, _ in rows:
        assert got["total"] > 0 and want["total"] > 0, name


# --- the pieces ------------------------------------------------------------


@pytest.mark.parametrize("hq,hkv,tp", [(16, 8, 16), (32, 4, 16), (48, 1, 16),
                                       (12, 3, 2), (8, 2, 4), (6, 2, 2)])
def test_group_heads_is_the_expanded_slice(hq, hkv, tp):
    """A model rank's kv heads (``layers._group_heads``) expanded to its q
    heads are the rank's slice of every kv head expanded to all q heads,
    for aligned groups (a slice) and unaligned ones (12 q heads over 3 kv
    heads on 2 ranks: gathered)."""
    kv = torch.randn(2, 5, hkv, 3, generator=torch.Generator().manual_seed(0))
    full, _ = TL._expand_kv(kv, kv, hq)
    n = hq // tp
    for r in range(tp):
        mine = TL._group_heads(kv, r, n, hq)
        got, _ = TL._expand_kv(mine, mine, n)
        assert torch.equal(got, full[:, :, r * n:(r + 1) * n]), r


def test_decode_rules_bind_and_restore():
    """Under ``decode_rules(B)`` on a (2, 2) mesh: B >= 2 keeps the rows
    over "data" and the cache's sequence whole; B=1 makes the rows whole
    and the sequence "data"'s; the rules come back after. The cache pin
    puts the kv heads over "model" where they divide."""
    from repro_torch.launch import dryrun as D
    from repro_torch.sharding.specs import P

    prev = ctx._CTX
    try:
        with D.fake_mesh((2, 2), ("data", "model")) as mesh:
            ctx.configure(mesh)
            before = dict(ctx._CTX["rules"])
            with ctx.decode_rules(2):
                assert ctx.logical_spec(4, *TL.cache_pin(2)) == \
                    P("data", None, "model", None)
            with ctx.decode_rules(1):
                assert ctx.logical_spec(4, *TL.cache_pin(1)) == \
                    P(None, "data", None, None)
                assert ctx.axis_size("batch") == 1
                assert ctx.batch_shards() == 2
            assert ctx._CTX["rules"] == before
    finally:
        ctx._CTX = prev
