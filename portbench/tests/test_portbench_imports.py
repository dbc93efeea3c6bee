"""What the harness loads: no top-level ``jax``, ``jaxlib``, ``flax`` or
``repro`` module (compared by whole top-level names, since ``repro_torch``
begins with ``repro``), and no ``repro_torch`` in the references."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

HARNESS = r"""
import importlib, importlib.util, json, sys
from pathlib import Path
root = Path(sys.argv[1]); sys.path[:0] = [str(root), str(root / "src")]
import portbench.run, portbench.lib.cell as cell
for p in sorted((root / "portbench" / "shapes").glob("*.py")):
    importlib.import_module("portbench.shapes." + p.stem)
for p in sorted((root / "portbench" / "metrics").glob("*.py")):
    cell.metric_reader(p.stem)
for p in sorted((root / "portbench" / "reference").glob("*.py")):
    importlib.import_module("portbench.reference." + p.stem)
import repro_torch.study, repro_torch.core, repro_torch.kernels.build
q = {"shape": "quickstart", "drug_codes": [1], "act_codes": [2]}
cell.shape("quickstart").build(q, 10)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCES = r"""
import importlib, json, sys
from pathlib import Path
root = Path(sys.argv[1]); sys.path[:0] = [str(root)]
for p in sorted((root / "portbench" / "reference").glob("*.py")):
    importlib.import_module("portbench.reference." + p.stem)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_and_no_reference_package():
    mods = _top_level(HARNESS)
    assert "repro_torch" in mods and "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_references_load_nothing_of_the_program():
    mods = _top_level(REFERENCES)
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
