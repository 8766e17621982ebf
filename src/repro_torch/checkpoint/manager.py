"""CheckpointManager: retention, asynchronous writes, latest-valid
discovery.

The counterpart of ``repro.checkpoint.manager``.  DP-specific
requirement: the RDP accountant history and the DPQuant scheduler state
are part of every checkpoint — a restart that forgot spent epsilon would
silently break the privacy guarantee, and one that forgot the EMA scores
would restart the analysis from scratch (paying extra analysis budget).
Both are plain dicts and ride in the ``aux`` payload.

``save()`` takes host copies of the tree (and pickles the aux) before it
returns; only the file writing goes to the writer thread.  The JAX
package can hand its immutable arrays to the thread, but the port's
tensors are overwritten in place: under the scan executor the params and
optimizer state are the epoch runner's static buffers, which the next
graph replay rewrites.
"""
from __future__ import annotations

import pickle
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Tuple

from repro_torch.checkpoint import serialization


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # a writer killed mid-save leaves only a step_*.tmp staging dir
        # (the .ckpt destination appears atomically via os.replace); sweep
        # such orphans so they never accumulate across restarts
        for stale in self.dir.glob("step_*.tmp"):
            shutil.rmtree(stale, ignore_errors=True)

    # ------------------------------------------------------------------ #
    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}.ckpt"

    def steps(self):
        out = []
        for p in self.dir.glob("step_*.ckpt"):
            m = re.fullmatch(r"step_(\d+)\.ckpt", p.name)
            if m and (p / "meta.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def wait(self):
        """Wait for the pending write; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any, aux: Optional[dict] = None) -> None:
        self.wait()
        host = serialization.host_copy(tree)
        # pickle non-jsonable aux bits (e.g. numpy RandomState tuples)
        payload = {"pickled_aux": _pickle_hex(aux or {}), "step": step}

        def work():
            serialization.save(self._path(step), host, payload)
            self._gc()

        if not self.async_write:
            work()
            return

        def run():
            try:
                work()
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._pending = threading.Thread(target=run, daemon=True)
        self._pending.start()

    def _gc(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # ------------------------------------------------------------------ #
    def restore_latest(self, like: Any) -> Optional[Tuple[int, Any, dict]]:
        """Latest checkpoint that passes its CRC; corrupted ones are
        skipped."""
        self.wait()
        for step in reversed(self.steps()):
            try:
                tree, aux = serialization.restore(self._path(step), like)
                return step, tree, _unpickle_hex(aux.get("pickled_aux", ""))
            except Exception:  # noqa: BLE001 - corrupted checkpoint
                continue
        return None


def _pickle_hex(obj) -> str:
    return pickle.dumps(obj).hex()


def _unpickle_hex(s: str):
    if not s:
        return {}
    return pickle.loads(bytes.fromhex(s))
