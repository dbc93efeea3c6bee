"""Package boundaries of the PyTorch port.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor the
  reference package ``repro`` (only ``repro_torch``): an AST scan.
* Entry points run on CUDA unless the caller asks for the CPU: without CUDA
  they raise instead of carrying on on the CPU.
* Every CUDA source names the TPU kernel it replaces, its bound and design.
"""
import ast
import os

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_scan_sees_the_whole_package():
    names = {os.path.relpath(p, PKG) for p in _port_files()}
    for mod in ("core/columnar.py", "kernels/predicate.py",
                "study/executor.py", "data/synthetic.py", "interop.py",
                "models/lm.py", "serving/batching.py", "launch/serve.py",
                "configs/archs.py", "kernels/hash_partition.py",
                "distributed/pipeline.py", "distributed/comm.py",
                "distributed/launch.py"):
        assert mod in names


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_generate_without_device_raises_when_cuda_absent(no_cuda):
    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_dcir(SyntheticConfig(n_patients=20))
    tables = generate_dcir(SyntheticConfig(n_patients=20), device="cpu")
    assert tables["ER_PRS"].device.type == "cpu"


def test_tables_and_study_default_to_cuda(no_cuda):
    from repro_torch.core import ColumnarTable, DCIR_SCHEMA
    from repro_torch.data.synthetic import SyntheticConfig, generate_dcir
    from repro_torch.interop import tables_from_numpy
    from repro_torch.study import Study

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ColumnarTable.from_columns({"a": [1, 2, 3]})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tables_from_numpy({})
    dcir = generate_dcir(SyntheticConfig(n_patients=20), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Study(n_patients=20).flatten(DCIR_SCHEMA).run(dict(dcir))


@pytest.mark.parametrize("name", ["predicate.cu", "filter_compact.cu",
                                  "bitset_ops.cu", "swa_attention.cu",
                                  "swa_prefill.cu", "swa_decode.cu",
                                  "hash_partition.cu"])
def test_cuda_sources_carry_their_note(name):
    text = open(os.path.join(PKG, "csrc", name)).read()
    assert "Replaces the Pallas TPU kernel repro/kernels/" in text
    assert "Bound:" in text and "Design" in text
    assert "extern \"C\" int repro_" in text


def test_serving_entry_points_default_to_cuda(no_cuda):
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.models import get_bundle

    b = get_bundle("h2o-danube-1.8b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        b.init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        b.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_params_from_numpy({}, b.cfg)
    assert b.init(0, device="cpu")["embed"].device.type == "cpu"


def test_engine_table_maps_reference_names():
    from repro_torch.kernels import ENGINE_NAMES

    assert ENGINE_NAMES == {"xla": "torch", "jnp": "torch", "pallas": "cuda",
                            "auto": "auto"}
    from repro_torch.kernels.predicate import resolve_engine

    assert resolve_engine("auto", "torch", "cpu") == "torch"
    assert resolve_engine("auto", "cuda", "cpu") == "cuda"
    assert resolve_engine("auto", "torch", "cuda") == "cuda"
    assert resolve_engine(None, "torch") == "torch"
    with pytest.raises(ValueError):
        resolve_engine("pallas", "torch")
