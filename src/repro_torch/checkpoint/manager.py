"""Checkpoint rotation + async save thread."""
from __future__ import annotations

import os
import shutil
import threading

from repro_torch.checkpoint.ckpt import latest_checkpoint, load_checkpoint, save_checkpoint


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, every: int = 50,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.every = every
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    def maybe_save(self, state, step: int) -> bool:
        if step % self.every != 0:
            return False
        self.save(state, step)
        return True

    def save(self, state, step: int) -> None:
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
        path = latest_checkpoint(self.directory)
        if path is None:
            return None, -1
        return load_checkpoint(path, like=like)
