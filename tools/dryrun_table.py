#!/usr/bin/env python3
"""Print the dry run's records as one Markdown table (no card, no torch).

    python3 tools/dryrun_table.py dryrun_out/single dryrun_out/multi

Reads every ``<arch>__<shape>__<mesh>.json`` that
``python -m repro_torch.launch.dryrun`` wrote under the given directories
and prints a row an arch, a column a (shape, mesh) cell: rank 0's argument
bytes / peak (arguments + ``temp_bytes``) in GiB, TFLOP a rank, and the
collectives by kind (all-reduce / all-gather / all-to-all counts; the
other two kinds are 0 in every record the port writes), then the cells
whose peak passes 80 GiB and each cell's traced seconds.  A failed cell
reads FAIL, a skipped one "skip".
"""
from __future__ import annotations

import glob
import json
import os
import sys

GIB = 2 ** 30
LIMIT_GIB = 80.0


def main() -> int:
    recs = {}
    for d in sys.argv[1:]:
        for path in sorted(glob.glob(os.path.join(d, "*.json"))):
            with open(path) as f:
                rec = json.load(f)
            recs[rec["arch"], rec["shape"], rec["mesh"]] = rec
    cols = sorted({(s, m) for _, s, m in recs},
                  key=lambda c: (c[1] != "16x16", c[1], c[0]))
    archs = sorted({a for a, _, _ in recs})
    print("| arch | " + " | ".join(f"{s} {m}" for s, m in cols) + " |")
    print("| --- |" + " --- |" * len(cols))
    over, seconds = [], []
    for a in archs:
        cells = []
        for s, m in cols:
            rec = recs.get((a, s, m))
            if rec is None:
                cells.append("")
            elif rec.get("skipped"):
                cells.append("skip")
            elif not rec.get("ok"):
                cells.append("FAIL")
            else:
                mem, c = rec["memory"], rec["collectives"]
                peak = (mem["argument_bytes"] + mem["temp_bytes"]) / GIB
                if peak > LIMIT_GIB:
                    over.append(f"{a} {s} {m} ({peak:.2f} GiB)")
                seconds.append(f"{a} {s} {m} {rec['total_s']}")
                cells.append(
                    f"{mem['argument_bytes'] / GIB:.2f} / {peak:.2f}, "
                    f"{rec['cost']['flops'] / 1e12:.1f}, "
                    f"{c['all-reduce']['count']}/{c['all-gather']['count']}"
                    f"/{c['all-to-all']['count']}")
        print(f"| {a} | " + " | ".join(cells) + " |")
    print()
    print(f"peak over {LIMIT_GIB:g} GiB a rank: "
          + (", ".join(over) if over else "none"))
    print("traced seconds: " + ", ".join(seconds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
