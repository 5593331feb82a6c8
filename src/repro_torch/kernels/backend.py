"""Backend resolution for the port: engine, longest-path form, kernel mode.

Counterpart of ``repro.kernels.backend``. Where the reference resolves the
Pallas ``interpret`` tri-state against the active JAX backend, the port
resolves each kernel call against the device of the tensors it is given:
a CPU tensor takes the kernel's plain PyTorch version, a CUDA tensor takes
the hand-written kernel. An explicit ``mode`` overrides the rule (the tests
and ``chip_smoke.py`` use it to run the plain version on the card); asking
for the kernel on a CPU tensor raises instead of falling back.
"""
from __future__ import annotations

import torch

MODES = ("plain", "kernel")


def resolve_mode(x: torch.Tensor, mode: str | None = None) -> str:
    """Kernel execution mode for a call on tensor ``x``.

    ``None`` (auto) gives ``"plain"`` on a CPU tensor and ``"kernel"`` on a
    CUDA tensor. ``"plain"`` forces the plain PyTorch version on any
    device; ``"kernel"`` forces the hand-written kernel and raises on a
    tensor that does not lie on a CUDA device.
    """
    if mode is None:
        return "kernel" if x.is_cuda else "plain"
    if mode not in MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; one of {MODES}")
    if mode == "kernel" and not x.is_cuda:
        raise ValueError(
            f"mode='kernel' needs CUDA tensors, got a tensor on {x.device}")
    return mode


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    ``None`` resolves to ``cuda`` and raises when no GPU is present, so an
    entry point never moves to the CPU on its own; callers that want the
    CPU (the tests) pass ``device="cpu"`` explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def resolve_solver(solver: str | None):
    """Resolve a ``PlanRequest.solver`` spelling to a registered
    :class:`repro_torch.core.solvers.Solver` (``None``/"auto" = the
    heuristic portfolio)."""
    from repro_torch.core.solvers import get_solver

    return get_solver("heuristic" if solver in (None, "auto") else solver)


def resolve_lp_form(num_tasks: int, budget_bytes: int | None = None) -> str:
    """Longest-path representation of the torch engine: ``"dense"`` when
    the O(N^2) int32 matrix fits ``budget_bytes`` (default
    :data:`repro_torch.core.greedy_torch.LP_MAX_BYTES`), else the streamed
    ``"blocked"`` form (:class:`repro_torch.core.greedy_torch.BlockedLP`)."""
    from repro_torch.core.greedy_torch import LP_MAX_BYTES, lp_matrix_bytes

    limit = LP_MAX_BYTES if budget_bytes is None else int(budget_bytes)
    return "dense" if lp_matrix_bytes(num_tasks) <= limit else "blocked"


def resolve_engine(engine: str | None, fanout: int = 1) -> str:
    """Resolve a scheduling-engine request to ``"numpy"`` or ``"torch"``.

    ``auto`` picks the device engine as soon as the request fans out
    (``fanout`` = number of (instance, profile) cells > 1) and the numpy
    engine for single-cell calls, the rule of the reference's
    ``resolve_engine`` with ``"torch"`` in place of ``"jax"``.
    """
    if engine in (None, "auto"):
        return "torch" if fanout > 1 else "numpy"
    if engine not in ("numpy", "torch"):
        raise ValueError(f"unknown engine {engine!r}")
    return engine


# the scheduler's CUDA kernels: every heuristic plan launches gain_scan,
# greedy_scan and commit_scan, and the cost oracle launches carbon_cost
SCHEDULER_KERNELS = ("gain_scan", "greedy_scan", "commit_scan",
                     "carbon_cost")


def enable_compilation_cache(device=None) -> str:
    """The kernel build directory, with the scheduler's kernels built into
    it when ``device`` is a CUDA device.

    The counterpart of the reference's ``enable_compilation_cache``, which
    turns on jax's persistent compilation cache. The port compiles nothing
    per shape; what persists across processes is its ``nvcc`` output,
    ``build/repro_torch/<name>-<hash>.so``
    (:mod:`repro_torch.kernels._build`), keyed by the source and the
    flags. On a CUDA device this builds (or finds built) and loads
    :data:`SCHEDULER_KERNELS`, so a service's first ticket pays no
    ``nvcc`` and a second process builds nothing; on the CPU it builds
    nothing. ``device=None`` means the card, as for every entry point.

    Unlike the reference, which returns None on any error, a failed build
    raises: swallowing it would hide a broken kernel until the fallback
    ladder turned every heuristic plan into a degraded ``asap`` plan.
    """
    from repro_torch.kernels import _build

    if resolve_device(device).type == "cuda":
        for name in SCHEDULER_KERNELS:
            _build.load(name)
    return str(_build.BUILD_DIR)
