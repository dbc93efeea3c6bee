"""Provenance tracking (paper §3.4–3.5): every pipeline operation is logged
with row counts so flowcharts and audits can be rebuilt from metadata alone —
the paper stores this as a JSON file next to the extracted Parquet, plus the
git commit hash of the producing code."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Any, Dict, List, Optional

__all__ = ["OperationLog", "git_hash"]


import functools


@functools.lru_cache(maxsize=1)
def git_hash() -> str:
    # memoized: OperationLog is constructed per study run and a subprocess
    # per construction costs more than the run itself on small tables
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=5
        )
        if out.returncode == 0:
            return out.stdout.strip()
    except Exception:
        pass
    return os.environ.get("REPRO_GIT_HASH", "no-git")


@dataclasses.dataclass
class OperationLog:
    """Append-only operation log; the SCALPEL-Analysis metadata file."""

    entries: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    commit: str = dataclasses.field(default_factory=git_hash)

    def record(self, op: str, inputs: Dict[str, Any], outputs: Dict[str, Any],
               params: Dict[str, Any]) -> None:
        def _count(v) -> Optional[int]:
            try:
                return int(v.count)
            except Exception:
                return None

        self.entries.append({
            "op": op,
            "inputs": {k: _count(v) for k, v in inputs.items()},
            "outputs": {k: _count(v) for k, v in outputs.items()},
            "params": {k: v for k, v in params.items()},
            "ts": time.time(),
        })

    def to_json(self, path: Optional[str] = None) -> str:
        blob = json.dumps({"commit": self.commit, "entries": self.entries}, indent=2)
        if path:
            with open(path, "w") as f:
                f.write(blob)
        return blob

    @classmethod
    def from_json(cls, blob: str) -> "OperationLog":
        d = json.loads(blob)
        log = cls(entries=d["entries"])
        log.commit = d.get("commit", "no-git")
        return log

    def flowchart(self) -> List[Dict[str, Any]]:
        """Rows-removed-per-stage table (the RECORD-guideline flowchart)."""
        rows = []
        for e in self.entries:
            n_in = sum(v for v in e["inputs"].values() if v is not None)
            n_out = sum(v for v in e["outputs"].values() if v is not None)
            rows.append({"stage": e["op"], "in": n_in, "out": n_out, "removed": n_in - n_out})
        return rows

    def render_flowchart(self) -> str:
        lines = [f"{'stage':40s} {'in':>12s} {'out':>12s} {'removed':>10s}"]
        for r in self.flowchart():
            lines.append(f"{r['stage']:40s} {r['in']:12d} {r['out']:12d} {r['removed']:10d}")
        return "\n".join(lines)
