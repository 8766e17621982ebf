"""Heartbeat-file failure detection.

The counterpart of ``repro.runtime.heartbeat``, copied whole (the
standard library only); the serving supervisor
(``repro_torch.runtime.supervisor``) drives it.

Each host process periodically touches ``<dir>/host_<id>.hb`` with its
current step; the (distributed, leaderless) detector marks hosts whose
heartbeat is older than ``deadline_s`` as dead.  On a real cluster the same
files live on shared storage (GCS/NFS); here they are local files so the
logic is unit-testable.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List


class Heartbeat:
    def __init__(self, directory: str, host_id: int):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id = host_id
        self.path = self.dir / f"host_{host_id}.hb"

    def beat(self, step: int, now: float = None) -> None:
        payload = {"step": step, "t": time.time() if now is None else now}
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload))
        tmp.replace(self.path)


class FailureDetector:
    def __init__(self, directory: str, deadline_s: float = 60.0):
        self.dir = Path(directory)
        self.deadline_s = deadline_s

    def snapshot(self, now: float = None) -> Dict[int, dict]:
        now = time.time() if now is None else now
        out = {}
        for p in self.dir.glob("host_*.hb"):
            try:
                data = json.loads(p.read_text())
                hid = int(p.stem.split("_", 1)[1])
            except (json.JSONDecodeError, OSError, ValueError, IndexError):
                # unreadable payloads and malformed filenames (non-numeric
                # host ids, stray files matching the glob) are skipped, not
                # fatal — a garbage file on shared storage must never take
                # down the detector
                continue
            data["age"] = now - data["t"]
            data["alive"] = data["age"] <= self.deadline_s
            out[hid] = data
        return out

    def dead_hosts(self, now: float = None) -> List[int]:
        return sorted(h for h, d in self.snapshot(now).items()
                      if not d["alive"])

    def alive_hosts(self, now: float = None) -> List[int]:
        return sorted(h for h, d in self.snapshot(now).items()
                      if d["alive"])
