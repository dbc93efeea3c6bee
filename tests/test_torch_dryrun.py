"""The dry run (``repro_torch.launch.dryrun``): cells traced on meta tensors
as rank 0 of a fake world, against the reference's compiled cells and
against real gloo ranks.

* (a) One subprocess runs the reference's ``run_cell`` on a forced
  8-device CPU backend with its ``make_production_mesh`` patched to a
  (2, 2) mesh, its ``SHAPES`` to seq 64 and batch 8 and its ``get_bundle``
  to the reduced configs (patched in that process only): the port's
  ``argument_bytes`` must equal XLA's ``argument_size_in_bytes`` exactly
  for six cells (seamless's decode reads no encoder, and XLA drops what a
  step never reads: ROADMAP C21), and the records' keys must be the
  reference's less its HLO line count, plus the decode's ``pos``.  For
  every arch x shape cell ``skipped`` and ``microbatches`` equal the
  reference's (``supports`` and ``PERF_OVERRIDES``; no lowering).
* (b) A train step's matrix-product flops on a rank, times the ranks,
  equal one rank's exactly on (1, 4), (4, 1) and (2, 2).
* (c) The probe identity ``f(full) == f(l0) + (n - l0) * (f(l0 + 1) -
  f(l0))`` holds exactly for five families (reduced, deepened to several
  periods), for an MoE train cell from its second period on (ROADMAP
  C22).
* (d) One spawn of 4 gloo CPU ranks runs three calls on seeded blocks
  (``distributed.launch.dryrun_rank``): their collectives, kind by kind in count
  and bytes, and the bytes of rank 0's inputs each call reads equal the
  dry run's exactly.
* (e) The fake world leaves no default group and refuses to start inside
  one; (f) the production meshes build over 256 and 512 fake ranks and
  the command line writes a record for a production cell.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, ShapeCell
from repro_torch.distributed import launch
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import registry
from repro_torch.models.registry import ModelBundle, all_archs

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TIMEOUT = 300
SMALL = {"train_4k": ShapeCell("train_4k", 64, 8, "train"),
         "prefill_32k": ShapeCell("prefill_32k", 64, 8, "prefill"),
         "decode_32k": ShapeCell("decode_32k", 64, 8, "decode")}
XLA_CELLS = (("h2o-danube-1.8b", "train_4k"),
             ("h2o-danube-1.8b", "prefill_32k"),
             ("h2o-danube-1.8b", "decode_32k"),
             ("deepseek-moe-16b", "prefill_32k"),
             ("recurrentgemma-2b", "decode_32k"),
             ("seamless-m4t-medium", "decode_32k"))
# the reference's record keys that read XLA's text; the port's own
XLA_ONLY, PORT_ONLY = {"hlo_lines"}, {"pos"}
# (d): the calls run on real ranks and dry
REAL_CALLS = (
    D.Call("h2o-danube-1.8b", "train", (2, 2), 8, 64, reduced=True),
    D.Call("deepseek-moe-16b", "prefill", (1, 4), 2, 64, reduced=True),
    # batch 1: the global layer's cache split by sequence over every axis
    D.Call("gemma3-12b", "decode", (2, 2), 1, 64, reduced=True),
)

REFERENCE = textwrap.dedent("""
    import json, sys
    import jax
    jax.devices()          # the forced 8 devices, before dryrun sets 512
    from repro.configs.base import SHAPES, ShapeCell
    from repro.launch import dryrun as D
    from repro.models.registry import all_archs, get_bundle

    out = {"cells": {}, "matrix": {}}
    for arch in all_archs():
        for name, cell in SHAPES.items():
            rec = {"skipped": not get_bundle(arch).supports(cell),
                   "microbatches": D.PERF_OVERRIDES.get(
                       (arch, name), {}).get("microbatches", 1)
                   if cell.kind == "train" else 1}
            if rec["skipped"]:
                rec["record"] = D.run_cell(arch, name, False)
            out["matrix"][f"{arch}|{name}"] = rec
    D.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
        (2, 2), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    D.SHAPES = {"train_4k": ShapeCell("train_4k", 64, 8, "train"),
                "prefill_32k": ShapeCell("prefill_32k", 64, 8, "prefill"),
                "decode_32k": ShapeCell("decode_32k", 64, 8, "decode")}
    D.get_bundle = lambda arch: get_bundle(arch, reduced=True)
    for arch, name in json.loads(sys.argv[1]):
        rec = D.run_cell(arch, name, False)
        assert rec.get("ok"), rec.get("error")
        out["cells"][f"{arch}|{name}"] = {
            "keys": sorted(rec), "microbatches": rec["microbatches"],
            "argument_bytes": rec["memory"]["argument_bytes"],
            "nested": {k: sorted(rec[k]) for k in ("memory", "cost",
                                                   "collectives")}}
    print(json.dumps(out))
""")


def _small_mesh(multi_pod=False):
    return Mesh((2, 2), ("data", "model"))


@pytest.fixture(scope="module")
def runs():
    """The reference's subprocess and the 4 gloo ranks, run at once."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                            json.dumps(XLA_CELLS)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        real = launch.spawn(launch.dryrun_rank, 4, (REAL_CALLS,),
                            device="cpu", timeout=TIMEOUT)[0]
    finally:
        out, err = ref.communicate(timeout=TIMEOUT)
    assert ref.returncode == 0, err[-3000:]
    return {"reference": json.loads(out.strip().splitlines()[-1]),
            "real": real}


@pytest.fixture
def small(monkeypatch):
    """The module's production mesh, shapes and configs cut to a (2, 2)
    mesh, seq 64 and batch 8, and the reduced configs."""
    monkeypatch.setattr(D, "make_production_mesh", _small_mesh)
    monkeypatch.setattr(D, "SHAPES", dict(SMALL))
    monkeypatch.setattr(D, "get_bundle",
                        lambda arch: registry.get_bundle(arch, reduced=True))


@pytest.mark.parametrize("arch,shape", XLA_CELLS)
def test_argument_bytes_equal_xla(runs, small, arch, shape):
    want = runs["reference"]["cells"][f"{arch}|{shape}"]
    rec = D.run_cell(arch, shape, False, ranks=4)
    assert rec["ok"], rec.get("traceback")
    assert rec["memory"]["argument_bytes"] == want["argument_bytes"]
    assert rec["microbatches"] == want["microbatches"]
    assert set(rec) - PORT_ONLY == set(want["keys"]) - XLA_ONLY
    assert ("pos" in rec) == (SMALL[shape].kind == "decode")
    for k, keys in want["nested"].items():
        assert sorted(rec[k]) == keys, k
    assert not dist.is_initialized()


def test_skipped_and_microbatches_match_the_reference(runs):
    matrix = runs["reference"]["matrix"]
    assert sorted(matrix) == sorted(f"{a}|{s}" for a in all_archs()
                                    for s in SHAPES)
    for key, want in matrix.items():
        arch, name = key.split("|")
        cell = SHAPES[name]
        skipped = not registry.get_bundle(arch).supports(cell)
        assert skipped == want["skipped"], key
        mb = D.PERF_OVERRIDES.get((arch, name), {}).get("microbatches", 1) \
            if cell.kind == "train" else 1
        assert mb == want["microbatches"], key
        if skipped:
            assert D.run_cell(arch, name, False) == want["record"], key


def test_flops_scale_with_the_mesh():
    def flops(mesh):
        return D.trace_call(D.Call("h2o-danube-1.8b", "train", mesh, 8, 64,
                                   reduced=True))["cost"]["flops"]

    one = flops((1, 1))
    assert one > 0
    for mesh in ((1, 4), (4, 1), (2, 2)):
        assert flops(mesh) * 4 == one, mesh


# (c): each family deepened to several periods (the encoder-decoder's
# encoder as deep as its decoder), and the cell it is probed on
PROBES = {"h2o-danube-1.8b": (dict(n_layers=3), "train_4k"),
          "gemma3-12b": (dict(n_layers=12), "prefill_32k"),
          "recurrentgemma-2b": (dict(n_layers=8), "prefill_32k"),
          "deepseek-moe-16b": (dict(n_layers=4), "train_4k"),
          "seamless-m4t-medium": (dict(n_layers=3, n_encoder_layers=3),
                                  "prefill_32k")}


@pytest.mark.parametrize("arch", list(PROBES))
def test_probe_identity_holds_exactly(small, monkeypatch, arch):
    depth, shape = PROBES[arch]
    cfg = dataclasses.replace(registry.get_bundle(arch, reduced=True).cfg,
                              **depth)
    monkeypatch.setattr(D, "get_bundle", lambda a: ModelBundle(cfg))
    monkeypatch.setitem(D.SHAPES, shape, dataclasses.replace(
        SMALL[shape], seq_len=32))
    rec = D.run_cell_with_probes(arch, shape, ranks=4)
    assert rec["ok"], rec.get("traceback")
    l0 = rec["probe_levels"][0]
    n = rec["n_periods"]
    assert n >= 2
    f0 = rec["probes"][f"p{l0}"]["flops"]
    f1 = rec["probes"][f"p{l0 + 1}"]["flops"]
    assert f1 > f0
    full = rec["cost"]["flops"]
    if not cfg.n_experts:
        assert full == f0 + (n - l0) * (f1 - f0)
        return
    # ROADMAP C22: a train cell's load-balance loss reads the first MoE
    # layer's router only, so the first period costs more than the others
    # by that loss's products, and the identity holds from the second
    # period on
    with D.fake_world(4):
        traced, _ = D.lower_cell(arch, shape, False,
                                 bundle=D._probe_bundle(arch, l0 + 2))
        f2 = D.measure(traced)["cost"]["flops"]
    assert f1 - f0 > f2 - f1
    assert full == f1 + (n - l0 - 1) * (f2 - f1)


@pytest.mark.parametrize("i", range(len(REAL_CALLS)))
def test_collectives_and_argument_bytes_equal_real_ranks(runs, i):
    dry = D.trace_call(REAL_CALLS[i])
    real = runs["real"][i]
    assert dry["collectives"] == real["collectives"]
    assert sum(c["count"] for c in dry["collectives"].values()) > 0
    assert dry["memory"]["argument_bytes"] == real["argument_bytes"] \
        == real["held_bytes"]


def test_fake_world_cleans_up_and_refuses_a_world():
    with D.fake_world(4):
        mesh = Mesh((2, 2), ("data", "model"))
        assert mesh.coords == {"data": 0, "model": 0}
        with pytest.raises(RuntimeError, match="already"):
            with D.fake_world(4):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with D.fake_world(4):
            raise ValueError("inside")
    assert not dist.is_initialized()


def test_production_meshes_and_the_command_line(tmp_path, monkeypatch):
    for multi_pod, ranks in ((False, 256), (True, 512)):
        with D.fake_world(ranks):
            mesh = make_production_mesh(multi_pod=multi_pod)
            assert isinstance(mesh, Mesh) and mesh.size == ranks
            assert mesh.group_of("model") is not None
        assert not dist.is_initialized()
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "xlstm-125m", "--shape", "decode_32k",
        "--out", str(tmp_path)])
    assert D.main() == 0
    with open(tmp_path / "xlstm-125m__decode_32k__16x16.json") as f:
        rec = json.load(f)
    assert rec["ok"] and rec["chips"] == 256 and rec["pos"] == 32_767
    assert rec["memory"]["argument_bytes"] > 0
    assert not dist.is_initialized()
