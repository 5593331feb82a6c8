"""Checkpoint rotation + async save thread.

With a ``mesh`` (a :class:`repro_torch.sharding.ctx.Mesh` whose state is
placed on its ``DeviceMesh``) every rank calls :meth:`save` and
:meth:`restore_latest` at the same steps: a save gathers the full state
(a collective, :func:`repro_torch.sharding.place.gather_state`; an
asynchronous save takes the same host copy) and rank 0 writes it, the
same file an unsharded run writes; a restore reads on every rank the
checkpoint rank 0 names and places it again
(:func:`repro_torch.sharding.place.place_state`).
"""
from __future__ import annotations

import os
import shutil
import threading

from repro_torch.checkpoint.ckpt import latest_checkpoint, load_checkpoint, save_checkpoint


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, every: int = 50,
                 async_save: bool = False, mesh=None):
        self.directory = directory
        self.keep = keep
        self.every = every
        self.async_save = async_save
        self.mesh = mesh
        self._thread: threading.Thread | None = None

    def maybe_save(self, state, step: int) -> bool:
        if step % self.every != 0:
            return False
        self.save(state, step)
        return True

    def _rank(self) -> int:
        import torch.distributed as dist
        return dist.get_rank()

    def save(self, state, step: int) -> None:
        if self.mesh is not None or self.async_save:
            # a host copy, gathered under a mesh (every rank takes part):
            # the caller's next in-place step cannot reach the save thread's
            from repro_torch.sharding.place import gather_state
            state = gather_state(state)
            if self.mesh is not None and self._rank() != 0:
                return
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(state, step), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(state, step)

    def _save_and_gc(self, state, step: int) -> None:
        save_checkpoint(state, step, self.directory)
        cands = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("ckpt_") and not d.endswith(".tmp"))
        for d in cands[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, d))

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def restore_latest(self, like=None):
        self.wait()
        if self.mesh is None:
            path = latest_checkpoint(self.directory)
        else:
            import torch.distributed as dist
            dist.barrier()                    # rank 0's writes are done
            box = [latest_checkpoint(self.directory)
                   if self._rank() == 0 else None]
            dist.broadcast_object_list(box, src=0)
            path = box[0]
        if path is None:
            return None, -1
        state, step = load_checkpoint(path, like=like)
        if self.mesh is not None:
            from repro_torch.sharding.place import place_state
            state = place_state(state, self.mesh)
        return state, step
