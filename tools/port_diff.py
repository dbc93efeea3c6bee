#!/usr/bin/env python
"""port-diff — the reference's spec corpus through both packages.

Draws ``n`` specs from the reference's fuzzer with one seed, as its
``run_corpus`` does (``repro.study.fuzz.gen_valid_spec`` for the first
``n - n//2``, then ``mutate_spec`` over fresh draws for the rest), and
holds the PyTorch port (``repro_torch``) against the JAX reference
(``repro``) on the CPU:

  * a valid spec must validate clean in both, compile in both to the same
    raw plan, and run: the port's torch engine against the reference's jnp
    engine under ``results_equal``'s contract with ``layout=True`` (raw
    columns, uint32 validity words, cohort words, flow, features) plus
    FlatteningStats, the port's ``run_chunked`` against the reference on
    valid rows (``layout=False``; a plan the analyzer proves contradictory,
    SP003, must instead be refused by the port's chunked preflight), and
    the analyzer's codes on the executed plan must agree;
  * a mutated spec must give the same ``SpecIssue`` list (code, path,
    message, hint) in both, name its catalog code, and be refused by both
    ``compile_spec``\\ s.

Both packages read one numpy-seeded star (the reference's generator).  The
reference runs jit'd on the CPU; the card has no JAX, so this runs here
only.

Run:  PYTHONPATH=src python tools/port_diff.py --n 200 --seed 0
Exit: 0 when every spec agrees, 1 otherwise.
"""
from __future__ import annotations

import argparse
import random
import sys
import tempfile
import time

import numpy as np

from repro.data.synthetic import SyntheticConfig, generate_dcir
from repro.study import analyze as r_analyze
from repro.study.fuzz import gen_valid_spec, mutate_spec
from repro.study.spec import SpecValidationError as RSpecValidationError
from repro.study.spec import compile_spec as r_compile_spec
from repro.study.spec import validate_spec as r_validate_spec
from repro_torch.data import partition_star
from repro_torch.interop import tables_from_numpy
from repro_torch.study import (PlanValidationError, SpecValidationError,
                               analyze, compile_spec, validate_spec)
from repro_torch.study.fuzz import results_equal


def _plan_view(plan):
    return ([(n.op, n.inputs, n.params) for n in plan.nodes],
            tuple(plan.outputs))


def check_valid(spec, ref_tables, port_tables, store, n_patients):
    """None when the packages agree on a valid spec, else a delta."""
    issues, r_issues = validate_spec(spec), r_validate_spec(spec)
    if issues or r_issues:
        return f"valid spec rejected: port {issues[:1]}, ref {r_issues[:1]}"
    if _plan_view(compile_spec(spec).plan()) != \
            _plan_view(r_compile_spec(spec).plan()):
        return "compiled plans differ"
    want = r_compile_spec(spec).run(dict(ref_tables), predicate_engine="jnp")
    got = compile_spec(spec).run(dict(port_tables), predicate_engine="torch",
                                 device="cpu")
    d = results_equal(got, want, layout=True)
    if d:
        return f"port torch vs reference jnp: {d}"
    if got.flatten_stats != want.flatten_stats:
        return "FlatteningStats differ"
    codes = sorted(g.code for g in analyze(got.plan, tables=port_tables,
                                           n_patients=n_patients))
    r_codes = sorted(g.code for g in r_analyze(
        want.plan, tables=ref_tables, n_patients=n_patients))
    if codes != r_codes:
        return f"analyzer codes {codes} != {r_codes}"
    if "SP003" in codes:
        try:
            compile_spec(spec).run_chunked(store, device="cpu")
        except PlanValidationError:
            return None
        return "the port's chunked preflight ran an SP003 plan"
    chunked = compile_spec(spec).run_chunked(store, device="cpu")
    d = results_equal(chunked, want, layout=False)
    return f"port chunked vs reference: {d}" if d else None


def check_mutated(code, spec):
    """None when both packages reject a mutated spec alike, else a delta."""
    got = [i.as_dict() for i in validate_spec(spec)]
    want = [i.as_dict() for i in r_validate_spec(spec)]
    if got != want:
        return f"issues differ: {got[:2]} vs {want[:2]}"
    if not any(i["code"] == code for i in got):
        return f"expected {code}, got {sorted({i['code'] for i in got})}"
    for compile_fn, exc in ((compile_spec, SpecValidationError),
                            (r_compile_spec, RSpecValidationError)):
        try:
            compile_fn(spec)
        except exc:
            continue
        return f"{compile_fn.__module__}.compile_spec accepted it"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200,
                    help="corpus size (half valid, half mutated)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-patients", type=int, default=200)
    args = ap.parse_args(argv)

    t0 = time.time()
    ref = generate_dcir(SyntheticConfig(n_patients=args.n_patients,
                                        seed=args.seed))
    star = {name: {"columns": {k: np.asarray(v)
                               for k, v in t.columns.items()},
                   "valid": np.asarray(t.valid), "count": int(t.count),
                   "capacity": t.capacity} for name, t in ref.items()}
    port = tables_from_numpy(star, device="cpu")
    n_flows = int(port["ER_PRS"].count)
    cap = max(32, ((n_flows // 3) // 32 + 1) * 32)
    rng = random.Random(args.seed)
    n_mut = args.n // 2
    failures = []
    codes = {}
    with tempfile.TemporaryDirectory(prefix="port_diff_") as tmp:
        store = partition_star(port, f"{tmp}/store", source="ER_PRS",
                               chunk_capacity=cap)
        for i in range(args.n - n_mut):
            spec = gen_valid_spec(rng, n_patients=args.n_patients)
            try:
                d = check_valid(spec, ref, port, store, args.n_patients)
            except Exception as e:  # noqa: BLE001 — a crash is a finding
                d = f"crash: {type(e).__name__}: {e}"
            if d:
                failures.append((i, d))
        for j in range(n_mut):
            code, spec = mutate_spec(gen_valid_spec(
                rng, n_patients=args.n_patients), j, rng)
            codes[code] = codes.get(code, 0) + 1
            try:
                d = check_mutated(code, spec)
            except Exception as e:  # noqa: BLE001 — a crash is a finding
                d = f"crash: {type(e).__name__}: {e}"
            if d:
                failures.append((args.n - n_mut + j, d))
    print(f"port diff: {args.n} specs (seed={args.seed}, "
          f"{args.n_patients} patients): {args.n - n_mut} valid run in "
          f"both packages, {n_mut} mutated "
          f"({', '.join(f'{c}x{k}' for c, k in sorted(codes.items()))})")
    for i, d in failures[:20]:
        print(f"  FAIL spec #{i}: {d}")
    print(f"{'PASS' if not failures else f'FAIL ({len(failures)})'} "
          f"in {time.time() - t0:.1f} s")
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
