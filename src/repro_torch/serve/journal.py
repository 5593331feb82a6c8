"""Write-ahead ticket journal: crash-recoverable admission for the service.

The port of ``repro.serve.journal``. Its entries are the reference's, array
for array and byte for byte in their json, so a journal written by either
package replays in the other.

:class:`~repro_torch.serve.service.PlanService` loses every in-flight ticket
on a process death — the admission queue is memory-only. This module gives
the service a durable twin of the queue built on the checkpoint
machinery's torn-write-proof format (:func:`repro_torch.checkpoint.ckpt
.save_checkpoint`: npz + fsynced json manifest behind an atomic rename):

* :meth:`TicketJournal.record` persists one admitted ticket's *resolved*
  planning state (instances, profile grid, variant names, solver knobs,
  budget) BEFORE the ticket enters the in-memory queue — the write-ahead
  contract: any ticket a worker can possibly pick up already has a
  journal entry.
* :meth:`TicketJournal.resolve` deletes the entry once the ticket's
  future is resolved (delivered, rejected, failed, or cancelled) — so
  the journal holds exactly the admitted-but-unfinished set.
* :meth:`TicketJournal.pending` replays that set after a restart; the
  service re-admits each entry under its original sequence number.

Semantics are **at-least-once**: a crash between delivery and
:meth:`resolve` replays an already-answered ticket (the old caller is
gone anyway — the replayed plan simply re-resolves and clears the
entry); a crash between :meth:`record` and enqueue replays a ticket
whose caller never saw an admission — same thing. What cannot happen is
a *lost* ticket: once admitted, the entry survives until some process
resolves it. Entries are self-contained (the full instance arrays
travel, not references), so a restarted service needs no caller state.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np

from repro_torch import obs
from repro_torch.core.carbon import PowerProfile
from repro_torch.core.dag import Instance
from repro_torch.workflows.generators import Workflow

# array-valued Instance fields; everything else rides the json meta leaf
_INSTANCE_ARRAYS = ("dur", "proc", "task_work", "pred_ptr", "pred_idx",
                    "succ_ptr", "succ_idx", "chain_proc_ids", "topo",
                    "level")
# array-valued Workflow fields (mapping-mode tickets journal raw DAGs)
_WORKFLOW_ARRAYS = ("node_w", "edges", "edge_w")


def _encode_json(obj) -> np.ndarray:
    """A json document as a uint8 leaf (the checkpoint format stores
    arrays only)."""
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8).copy()


def _decode_json(arr):
    return json.loads(bytes(np.asarray(arr, dtype=np.uint8)).decode())


def encode_ticket(instances, grid, names, solver: str, robust: bool,
                  options: dict | None, budget: float | None,
                  mapping: str = "fixed",
                  mapping_options: dict | None = None) -> dict:
    """The journal entry of one resolved ticket: a nested dict of arrays
    (what :func:`repro_torch.checkpoint.ckpt.save_checkpoint` accepts).

    Mapping-mode tickets (``mapping != "fixed"``) carry raw
    :class:`Workflow` DAGs in the instances slot; both shapes journal
    self-contained."""
    items = []
    for inst in instances:
        if isinstance(inst, Workflow):
            items.append({"kind": "workflow", "name": inst.name})
        else:
            items.append(
                {"name": inst.name, "num_tasks": int(inst.num_tasks),
                 "num_workflow_tasks": int(inst.num_workflow_tasks),
                 "proc_chains": [list(c) for c in inst.proc_chains],
                 "idle_total": int(inst.idle_total)})
    meta = {
        "solver": solver,
        "robust": bool(robust),
        "options": options,
        "names": list(names),
        "budget": budget,
        "mapping": mapping,
        "mapping_options": mapping_options,
        "instances": items,
        "scenarios": [[p.scenario for p in ps] for ps in grid],
    }
    state: dict = {"meta": {"json": _encode_json(meta)}}
    for i, inst in enumerate(instances):
        fields = _WORKFLOW_ARRAYS if isinstance(inst, Workflow) \
            else _INSTANCE_ARRAYS
        state[f"i{i}"] = {f: np.asarray(getattr(inst, f)) for f in fields}
        for p, prof in enumerate(grid[i]):
            state[f"i{i}p{p}"] = {"bounds": np.asarray(prof.bounds),
                                  "budget": np.asarray(prof.budget)}
    return state


class _DecodedTicket(tuple):
    """The 7-tuple decode contract plus the mapping axis as attributes
    (older callers keep unpacking seven values unchanged)."""

    mapping: str = "fixed"
    mapping_options: dict | None = None


def decode_ticket(state: dict):
    """Invert :func:`encode_ticket`.

    Returns ``(instances, grid, names, solver, robust, options, budget)``
    with fresh :class:`Instance`/:class:`PowerProfile`/:class:`Workflow`
    objects that compare array-equal to the originals; the tuple also
    carries ``.mapping`` / ``.mapping_options`` attributes (``"fixed"`` /
    ``None`` for pre-mapping journal entries).
    """
    meta = _decode_json(state["meta"]["json"])
    instances = []
    grid = []
    for i, im in enumerate(meta["instances"]):
        arrays = state[f"i{i}"]
        if im.get("kind") == "workflow":
            instances.append(Workflow(
                name=im["name"],
                **{f: np.asarray(arrays[f]) for f in _WORKFLOW_ARRAYS}))
        else:
            instances.append(Instance(
                name=im["name"], num_tasks=im["num_tasks"],
                num_workflow_tasks=im["num_workflow_tasks"],
                proc_chains=tuple(tuple(int(t) for t in c)
                                  for c in im["proc_chains"]),
                idle_total=im["idle_total"],
                **{f: np.asarray(arrays[f]) for f in _INSTANCE_ARRAYS}))
        grid.append([
            PowerProfile(bounds=np.asarray(state[f"i{i}p{p}"]["bounds"]),
                         budget=np.asarray(state[f"i{i}p{p}"]["budget"]),
                         scenario=meta["scenarios"][i][p])
            for p in range(len(meta["scenarios"][i]))])
    out = _DecodedTicket(
        (instances, grid, tuple(meta["names"]), meta["solver"],
         meta["robust"], meta["options"], meta["budget"]))
    out.mapping = meta.get("mapping", "fixed")
    out.mapping_options = meta.get("mapping_options")
    return out


class TicketJournal:
    """One directory of write-ahead ticket entries (see module doc).

    Entries are the checkpoint format's ``ckpt_{seq:08d}`` directories;
    ``seq`` is the service's admission sequence number, so replayed
    tickets keep their identity across restarts and :meth:`resolve` is
    naturally idempotent (removing a missing entry is a no-op).
    """

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, seq: int) -> str:
        return os.path.join(self.directory, f"ckpt_{seq:08d}")

    def _seqs(self) -> list[int]:
        return sorted(
            int(d[len("ckpt_"):]) for d in os.listdir(self.directory)
            if d.startswith("ckpt_") and not d.endswith(".tmp"))

    def next_seq(self) -> int:
        """The next unused sequence number (past every live entry)."""
        seqs = self._seqs()
        return (seqs[-1] + 1) if seqs else 0

    def record(self, seq: int, state: dict) -> str:
        """Persist one entry atomically (write-ahead: call before the
        ticket becomes claimable)."""
        from repro_torch.checkpoint.ckpt import save_checkpoint

        return save_checkpoint(state, seq, self.directory)

    def resolve(self, seq: int) -> None:
        """Drop entry ``seq`` (idempotent — the at-least-once replay of
        an already-resolved ticket resolves it again harmlessly)."""
        path = self._path(seq)
        if os.path.isdir(path):
            shutil.rmtree(path)

    def pending(self, limit: int | None = None
                ) -> list[tuple[int, dict]]:
        """Every admitted-but-unresolved entry as ``(seq, state)``, in
        admission order — what a restarted service replays. Torn or
        unreadable entries are dropped (the atomic-rename write makes
        them impossible short of manual tampering).

        ``limit`` caps the replay size: only the ``limit`` *oldest* live
        entries are loaded (admission order = fairness order); entries
        past the cap stay on disk untouched, so a later replay — or an
        operator — can still recover them.
        """
        from repro_torch.checkpoint.ckpt import load_checkpoint

        out = []
        seqs = self._seqs()
        if limit is not None:
            seqs = seqs[:max(int(limit), 0)]
        for seq in seqs:
            try:
                state, step = load_checkpoint(self._path(seq))
            except Exception:
                shutil.rmtree(self._path(seq), ignore_errors=True)
                continue
            out.append((int(step), state))
        return out

    def __len__(self) -> int:
        return len(self._seqs())

    def compact(self) -> dict[int, int]:
        """Renumber live entries to dense sequences ``0..k-1``.

        Long-running services only ever *grow* sequence numbers — resolve
        deletes entries but never reclaims the numbering, so a fleet
        restarting from a sparse journal keeps counting from the
        high-water mark forever. Compaction rewrites each surviving entry
        under its rank (oldest first) and removes the original, returning
        the ``{old_seq: new_seq}`` mapping so a replaying service can
        re-key its in-memory tickets.

        Crash safety: the new entry is written (atomic rename) BEFORE the
        old one is removed, and ranks never collide with still-unprocessed
        originals (``new <= old`` throughout), so a mid-compact crash
        leaves at worst a duplicate entry — an at-least-once replay, the
        journal's existing contract — never a lost ticket.
        """
        from repro_torch.checkpoint.ckpt import load_checkpoint, \
            save_checkpoint

        mapping: dict[int, int] = {}
        moved = 0
        with obs.span("journal_compact", directory=self.directory):
            for new, old in enumerate(self._seqs()):
                mapping[old] = new
                if new == old:
                    continue
                try:
                    state, _ = load_checkpoint(self._path(old))
                except Exception:
                    shutil.rmtree(self._path(old), ignore_errors=True)
                    del mapping[old]
                    continue
                save_checkpoint(state, new, self.directory)
                shutil.rmtree(self._path(old), ignore_errors=True)
                moved += 1
        if moved:
            obs.registry().counter(
                "journal_compacted_entries_total",
                "journal entries renumbered by compaction").inc(moved)
        return mapping
