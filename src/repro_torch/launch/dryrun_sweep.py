"""The dry run of every (arch x shape) cell at ``--mesh none``, as a table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_sweep \
        [--out experiments/dryrun_torch] [--mesh none]

Runs :func:`repro_torch.launch.dryrun.run_cell` (mode ``both``) for every
architecture and shape on the meta device (no card, no memory), writes
each record as the dry run does, and prints a Markdown table, a row an
architecture and a column a shape: FLOPs and bytes of the whole step, the
roofline bound and the initial of its dominant term (compute, memory,
collective), the step's arguments plus the peak of its temporaries, and
whether they fit one card's HBM. These are counts of the traced step, not
card times.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.dryrun import run_cell
from repro_torch.roofline.analysis import H100


def cell(rec: dict) -> str:
    """One table cell of a run_cell record: FLOPs / bytes / the bound and
    its dominant term's initial / arguments plus temporaries, and whether
    they fit one card."""
    if "skipped" in rec:
        return "skipped"
    c, r, m = rec["cost"], rec["roofline"], rec["memory"]
    need = m["argument_size_in_bytes"] + (m["temp_size_in_bytes"] or 0)
    fits = "fits" if need <= H100.hbm_bytes else "no"
    return (f"{c['hlo_flops']:.3g} / {c['hlo_bytes']:.3g} / "
            f"{r['bound_s']:.4g} s {r['dominant'][0]} / {need / 1e9:.4g} GB "
            f"{fits}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="none", choices=["none", "single"])
    args = ap.parse_args(argv)
    shapes = list(SHAPES)
    print("| arch | " + " | ".join(shapes) + " |")
    print("|---|" + "---|" * len(shapes))
    t0 = time.perf_counter()
    for arch in sorted(ARCHS):
        cells = [cell(run_cell(arch, shape, args.mesh, "both", args.out))
                 for shape in shapes]
        print(f"| {arch} | " + " | ".join(cells) + " |", flush=True)
    print(f"\n{time.perf_counter() - t0:.1f} s in all")


if __name__ == "__main__":
    main()
