"""Each kernel module of the port, through its plain PyTorch path on the CPU,
against the reference's Pallas kernel in interpret mode (and its jnp path).

* B1 ``predicate_bitset``: the three-way Expr battery of
  ``tests/test_differential.py``, plus division and modulo by zero, NaN
  membership, promotion against Python literals and hoisted ``hlit``/
  ``hisin`` slots bound through ``bound_params``;
* B2 ``ops.filter_compact`` with a packed keep-mask (slots past the count
  are zero);
* B3 ``ops.bitset_op`` for all four ops at ragged word counts, and
  ``bitset_expr_plain`` (a whole program a launch) against a chain of the
  reference's ``ops.bitset_op``.

Every comparison is exact: nothing here computes in floating point beyond
IEEE elementwise operations and comparisons.
"""
import ctypes
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.columnar import ColumnarTable as RTable
from repro.kernels import ops as rops
from repro.kernels.predicate import predicate_bitset as r_predicate_bitset
from repro.study import col
from repro.study import expr as rexpr
from repro.study.expr import HoistedIsIn, HoistedLit, lit
from repro_torch.core import bitset as pbs
from repro_torch.core.columnar import NULL_INT, ColumnarTable
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ops as pops
from repro_torch.kernels import predicate as pk
from repro_torch.kernels.predicate import (binary_arith, binary_cmp,
                                           compilable, floordiv, remainder,
                                           predicate_bitset)
from repro_torch.study import expr as pexpr
from repro_torch.kernels.ref import bitset_expr_plain
from test_differential import CASES
from _bitset_programs import PROGRAM_SHAPES, random_program

BLOCK = 64


def _cols(rng, n: int) -> dict:
    """The columns of ``test_differential._rand_table`` plus two divisors."""
    a = rng.integers(-5, 15, n)
    a[rng.random(n) < 0.25] = NULL_INT
    x = rng.normal(size=n).astype(np.float32)
    x[rng.random(n) < 0.2] = np.nan
    y = rng.normal(size=n).astype(np.float32)
    y[rng.random(n) < 0.2] = 0.0
    return {"id": np.arange(n, dtype=np.int32), "a": a.astype(np.int32),
            "b": rng.integers(-5, 15, n).astype(np.int32), "x": x, "y": y,
            "z": rng.integers(-2, 3, n).astype(np.int32)}


def _tables(seed: int, n: int):
    rng = np.random.default_rng(seed)
    cols = _cols(rng, n)
    valid = rng.random(n) < 0.85
    return (RTable.from_columns(cols, valid=jnp.asarray(valid)),
            ColumnarTable.from_columns(cols, valid=torch.from_numpy(valid),
                                       device="cpu"))


def _assert_predicate_parity(rt, pt, e, params=None) -> None:
    """Reference Pallas (interpret) == port plain kernel path, and reference
    jnp mask == port torch mask, on the packed words and the count."""
    param = e.to_param()
    with rexpr.bound_params(*(params or ((), ()))):
        want_mask = np.asarray(e.mask(rt)).astype(bool)
    with pexpr.bound_params(*(params or ((), ()))):
        got_mask = pexpr.expr_from_param(param).mask(pt)
    assert got_mask.to(torch.bool).numpy().tolist() == want_mask.tolist()
    if not compilable(param):
        return
    words, cnt = r_predicate_bitset(rt.columns, rt.valid, expr_param=param,
                                    block=BLOCK, interpret=True,
                                    capacity=rt.capacity, params=params)
    before = dict(launch_counts)
    pw, pc = predicate_bitset(pt.columns, pt.valid, expr_param=param,
                              capacity=pt.capacity, params=params)
    assert launch_counts == before        # CPU tensors: the plain version
    np.testing.assert_array_equal(pw.numpy().view(np.uint32),
                                  np.asarray(words))
    assert int(pc) == int(cnt)


@pytest.mark.parametrize("name,n,mk", CASES, ids=[c[0] for c in CASES])
def test_predicate_battery(name, n, mk):
    rt, pt = _tables(zlib.crc32(name.encode()), n)
    from repro.study.expr import all_of

    _assert_predicate_parity(rt, pt, all_of(*mk()))


EXTRA = [
    ("int_floordiv_zero", lambda: col("a") // 0 == -2),
    ("int_floordiv_mixed", lambda: col("b") // col("z") <= 1),
    ("int_mod_zero", lambda: col("b") % col("z") == 0),
    ("int_mod_lit_zero", lambda: col("b") % 0 == 0),
    ("float_floordiv_zero", lambda: col("x") // 0.0 != col("x") // 0.0),
    ("float_mod_zero", lambda: col("x") % 0.0 != col("x") % 0.0),
    ("float_floordiv", lambda: col("x") // col("y") >= 1.0),
    ("float_mod", lambda: col("x") % col("y") < 0.5),
    ("promote_int_float_lit", lambda: col("b") == 2.5),
    ("promote_arith", lambda: col("a") - col("b") * 3 < col("x")),
    ("int_plus_float_lit", lambda: col("b") + 0.5 > 3),
    ("isin_padded_tail", lambda: col("b").isin([1, 2, 9])),
    ("isin_float_values", lambda: col("x").isin([0.5, -1.25, 2.0])),
    ("isin_int_probe_float_set", lambda: col("b").isin([1.0, 2.5])),
    ("isin_nan_probe", lambda: col("x").isin([float("nan"), 0.0])),
    ("const_root", lambda: (lit(1) < lit(2)) & (col("b") > 0)),
]


@pytest.mark.parametrize("name,mk", EXTRA, ids=[c[0] for c in EXTRA])
@pytest.mark.parametrize("n", [33, 1025])
def test_predicate_jnp_semantics(name, mk, n):
    rt, pt = _tables(n, n)
    _assert_predicate_parity(rt, pt, mk())


def test_predicate_hoisted_slots():
    rt, pt = _tables(5, 200)
    lits = (np.int32(4), np.float32(-0.5))
    vecs = (np.array([7, -3, 2, 2, 11], np.int32),
            np.array([0.25, np.nan, -1.0], np.float32))
    for e in (HoistedLit(0) < col("b"),
              col("x") >= HoistedLit(1),
              HoistedIsIn(col("b"), 0, 5, False),
              HoistedIsIn(col("x"), 1, 3, True) | (col("a") == HoistedLit(0)),
              HoistedIsIn(col("b"), 1, 3, True)):
        _assert_predicate_parity(rt, pt, e, params=(lits, vecs))
    with pytest.raises(RuntimeError):
        predicate_bitset(pt.columns, pt.valid,
                         expr_param=(HoistedLit(0) < col("b")).to_param())


def test_predicate_empty_table_and_bad_root():
    words, cnt = predicate_bitset({"a": torch.zeros((0,), dtype=torch.int32)},
                                  torch.zeros((0,), dtype=torch.bool),
                                  expr_param=(col("a") >= 0).to_param())
    assert words.shape == (0,) and int(cnt) == 0
    with pytest.raises(ValueError):
        predicate_bitset({"a": torch.zeros((4,), dtype=torch.int32)},
                         torch.ones((4,), dtype=torch.bool),
                         expr_param=(col("a") + 1).to_param())


_I32 = np.array([0, 1, -1, 2, -2, 5, -5, 7, -7, 2 ** 31 - 1, -2 ** 31,
                 -2 ** 31 + 1], np.int32)
# denormals of both signs and the least normals beside them: XLA flushes
# them (ROADMAP C4), so the port must too
_F32 = np.array([0.0, -0.0, 1.0, -1.0, 2.5, -2.5, 7.5, -7.5, 1e30, -1e30,
                 3e-30, np.inf, -np.inf, np.nan, 0.1, 3.0, 1e-45, -1e-45,
                 1e-39, -1e-40, 3e-39, 1.1754942e-38, -1.1754942e-38,
                 1.17549435e-38, 1.1754944e-38, -1.1754945e-38], np.float32)


@pytest.mark.parametrize("vals", [_I32, _F32], ids=["int32", "float32"])
def test_floordiv_remainder_match_jnp(vals):
    """jnp's // and % on every pair, by zero included (int32 5 // 0 == -2,
    5 % 0 == 0; float32 5.0 // 0.0 and 5.0 % 0.0 are NaN)."""
    x, y = np.meshgrid(vals, vals)
    x, y = x.ravel(), y.ravel()
    for ours, theirs in ((floordiv, jnp.floor_divide),
                         (remainder, jnp.remainder)):
        got = ours(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        want = np.asarray(theirs(jnp.asarray(x), jnp.asarray(y)))
        assert got.dtype == want.dtype
        if got.dtype == np.float32:
            both_nan = np.isnan(got) & np.isnan(want)
            np.testing.assert_array_equal(got.view(np.int32)[~both_nan],
                                          want.view(np.int32)[~both_nan])
            assert (np.isnan(got) == np.isnan(want)).all()
        else:
            np.testing.assert_array_equal(got, want)


def _denormal_tables(n: int = 67):
    """Float32 columns of denormals of both signs, zeros, least normals,
    NaN and ordinary values (the first rows are C4's example)."""
    rng = np.random.default_rng(19)
    head = np.array([1e-45, 1e-39, -1e-40, 1.0, 0.0, -0.0, -1e-45,
                     1.1754944e-38, np.nan, 3e-39], np.float32)
    pool = np.concatenate([head, [2.0, -2.5, 1e30]]).astype(np.float32)
    d = np.concatenate([head, rng.choice(pool, n - head.size)])
    e = rng.choice(pool, n).astype(np.float32)
    cols = {"d": d.astype(np.float32), "e": e,
            "i": rng.integers(-3, 4, n).astype(np.int32)}
    valid = rng.random(n) < 0.9
    valid[:head.size] = True
    return (RTable.from_columns(cols, valid=jnp.asarray(valid)),
            ColumnarTable.from_columns(cols, valid=torch.from_numpy(valid),
                                       device="cpu"))


DENORMAL = [
    ("gt_zero", lambda: col("d") > 0),
    ("eq_zero", lambda: col("d") == 0),
    ("times_1e30", lambda: col("d") * 1e30 > 0),
    ("lt_zero", lambda: col("d") < 0.0),
    ("lit_denormal", lambda: col("e") >= 1e-40),
    ("sum_cancels", lambda: col("d") - col("e") == 0),
    ("product_underflows", lambda: col("d") * col("e") != 0),
    ("floordiv_sign", lambda: col("d") // -1.0 < col("e")),
    ("mod_keeps_fmod", lambda: col("d") % col("e") >= 0),
    ("int_promoted", lambda: col("i") * 1e-44 == col("d")),
    ("isin_denormal_set", lambda: col("d").isin([1e-40, -2.5])),
    ("isin_zero_set", lambda: col("e").isin([0.0, 1e30])),
]


@pytest.mark.parametrize("name,mk", DENORMAL, ids=[c[0] for c in DENORMAL])
def test_predicate_denormals(name, mk):
    """C4: both port engines give the reference's words where float32
    denormals meet arithmetic, comparisons and whitelists (on C4's column
    ``col("d") > 0`` keeps only the 1.0: words ``[8]`` in its first 4
    rows)."""
    rt, pt = _denormal_tables()
    _assert_predicate_parity(rt, pt, mk())
    if name == "gt_zero":
        words, _ = predicate_bitset(pt.columns, pt.valid,
                                    expr_param=mk().to_param())
        assert int(words[0]) & 0xF == 8


def test_predicate_denormals_hoisted():
    """Hoisted denormal literals and whitelist entries flush as inline ones
    do, on both port engines."""
    rt, pt = _denormal_tables()
    lits = (np.float32(-1e-40), np.float32(3e-39))
    vecs = (np.array([1e-41, 2.0, -1e-45], np.float32),)
    for e in (col("d") > HoistedLit(0), col("e") == HoistedLit(1),
              HoistedIsIn(col("d"), 0, 3, True),
              HoistedIsIn(col("e"), 0, 3, True) & (col("d") <= HoistedLit(0))):
        _assert_predicate_parity(rt, pt, e, params=(lits, vecs))


def test_promotion_against_python_literals():
    i = np.array([1, 2, -3], np.int32)
    f = np.array([0.5, -1.5, 2.0], np.float32)
    for a, lit_ in ((i, 0.5), (i, 2), (f, 2), (f, 0.25)):
        for op in ("+", "-", "*", "//", "%"):
            got = binary_arith(op, torch.from_numpy(a), lit_)
            want = {"+": jnp.add, "-": jnp.subtract, "*": jnp.multiply,
                    "//": jnp.floor_divide, "%": jnp.remainder}[op](
                jnp.asarray(a), lit_)
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = binary_cmp("<", torch.from_numpy(a), lit_)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jnp.asarray(a) < lit_))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1025])
def test_filter_compact_packed_mask(n):
    rng = np.random.default_rng(n)
    cols = _cols(rng, n)
    keep = rng.random(n) < 0.4
    rwords = jnp.asarray(np.asarray(
        RTable.from_columns(cols, valid=jnp.asarray(keep)).valid))
    pwords = pbs.pack(torch.from_numpy(keep))
    got, cnt = pops.filter_compact_table(
        {k: torch.from_numpy(v) for k, v in cols.items()}, pwords)
    for k, v in cols.items():
        want, wcnt = rops.filter_compact(jnp.asarray(v), rwords,
                                         interpret=True)
        assert int(cnt) == int(wcnt)
        g, w = got[k].numpy(), np.asarray(want)
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=k)
    one, one_cnt = pops.filter_compact(torch.from_numpy(cols["a"]),
                                       pwords.view(torch.uint32))
    np.testing.assert_array_equal(one.numpy(), got["a"].numpy())


@pytest.mark.parametrize("n", [0, 1, 31, 1025])
@pytest.mark.parametrize("op", ["and", "or", "andnot", "xor"])
def test_bitset_op(n, op):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    want, wcnt = rops.bitset_op(jnp.asarray(a), jnp.asarray(b), op,
                                interpret=True)
    got, cnt = pops.bitset_op(torch.from_numpy(a.view(np.int32)),
                              torch.from_numpy(b.view(np.int32)), op)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    assert int(cnt) == int(wcnt)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 31, 33, 1000])
def test_bitset_expr_plain_matches_chained_reference(n):
    """Seeded programs of 1-8 ops over 1-8 leaves, every op: each op's
    words and count equal the reference's Pallas kernel (interpret mode)
    applied op by op."""
    rng = np.random.default_rng(1000 + n)
    for k, (n_leaves, n_ops) in enumerate(PROGRAM_SHAPES):
        prog = random_program(rng, n_leaves, n_ops, first_op=k)
        leaves = [rng.integers(0, 2 ** 32, n, dtype=np.uint64)
                  .astype(np.uint32) for _ in range(n_leaves)]
        words, counts = bitset_expr_plain(
            [torch.from_numpy(x.view(np.int32)) for x in leaves], prog)
        assert words.shape == (n_ops, n) and counts.dtype == torch.int32
        vals = [jnp.asarray(x) for x in leaves]
        for j, (op, a, b) in enumerate(prog):
            w, c = rops.bitset_op(vals[a], vals[b], op, interpret=True)
            vals.append(w)
            np.testing.assert_array_equal(words[j].numpy().view(np.uint32),
                                          np.asarray(w), err_msg=str(prog))
            assert int(counts[j]) == int(c), prog


def test_bitset_program_checks():
    """A program reads leaves and earlier ops only, 1-8 of each."""
    from repro_torch.kernels.bitset_ops import check_program

    assert check_program([("and", 0, 1), ("xor", 2, 0)], 2) == \
        (("and", 0, 1), ("xor", 2, 0))
    for prog, n_leaves in ((["and", 0, 2],), 2), ((("and", 0, 1),), 9), \
            ((), 2), ((("nand", 0, 1),), 2), ((("or", 0, 0),) * 9, 1):
        with pytest.raises(ValueError):
            check_program(prog, n_leaves)


def test_kernel_launchers_refuse_cpu_tensors():
    """No fallback: a kernel launcher given CPU tensors raises."""
    from repro_torch.kernels import bitset_ops, filter_compact

    w = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bitset_ops.bitset_op_popcount(w, w, "and")
    with pytest.raises(ValueError, match="CUDA"):
        filter_compact.filter_compact_bits([torch.zeros(128, dtype=torch.int32)],
                                           w)


def test_cuda_engine_refuses_bitwise_logic_on_numbers():
    """``&``/``|``/``~`` over int columns pass the reference's
    ``compilable`` (the root tag is boolean) but its kernel then packs
    integer values as bits; the port's program compiler refuses them."""
    e = col("a") & col("b")
    assert compilable(e.to_param())
    _, pt = _tables(1, 40)
    with pytest.raises(ValueError, match="boolean operands"):
        predicate_bitset(pt.columns, pt.valid, expr_param=e.to_param())


# ---------------------------------------------------------------------------
# B1's launch planning: the program as csrc/predicate.cu runs it
# ---------------------------------------------------------------------------
def _nested_sum(names: str):
    e = col(names[-1])
    for c in reversed(names[:-1]):
        e = col(c) + e
    return e


PLAN_EXPRS = [(name, lambda mk=mk: _all_of(mk())) for name, _, mk in CASES] \
    + list(EXTRA) + [
    ("hlit_left", lambda: HoistedLit(0) < col("b")),
    ("hlit_float", lambda: col("x") >= HoistedLit(1)),
    ("hisin_or_hlit", lambda: HoistedIsIn(col("x"), 1, 3, True)
     | (col("a") == HoistedLit(0))),
    ("lit_vs_hlit", lambda: lit(5) < HoistedLit(0)),
    ("not_not", lambda: ~~(col("a") > 2)),
    ("not_shared", lambda: (col("a") > 2) & ~(col("a") > 2)),
    ("nested_15_slots", lambda: _nested_sum("abzab" * 3 + "z") > 0),
    ("balanced", lambda: (((col("a") < 3) | (col("b") > 2))
                          & ((col("x") < 0.5) | (col("y") > -0.5)))
     & (((col("z") != 0) | (col("a") + col("b") < col("z") * 4))
        & ((col("x") * col("y") < 0.25) | col("a").is_null()))),
]
PLAN_PARAMS = ((np.int32(4), np.float32(-0.5)),
               (np.array([7, -3, 2, 2, 11], np.int32),
                np.array([0.25, np.nan, -1.0], np.float32)))


def _all_of(exprs):
    from repro.study.expr import all_of

    return all_of(*exprs)


_READS_F32 = ("ADD_F32", "SUB_F32", "MUL_F32", "FLOORDIV_F32", "MOD_F32",
              "ISNULL_F32", "ISIN_F32")


def _operand_view(op: str) -> str:
    if op.startswith("CMP_") and op.endswith("_F32") or op in _READS_F32:
        return "f"
    return "b" if op in ("AND", "OR", "NOT") else "i"


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bool:
        return t.to(torch.int32)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _one_op(prog, op, imm, operands, n, params):
    """One instruction over 32-bit patterns, through the plain version."""
    view = _operand_view(op)
    typed = [x != 0 if view == "b" else x.view(torch.float32)
             if view == "f" else x for x in operands]
    mini = pk.Program(("x", "y"), (("LOAD", 0, 0, 0, 0, view),
                                   ("LOAD", 1, 0, 0, 1, view),
                                   (op, 2, 0, 1, imm, "i")),
                      prog.tables, prog.lits, 2)
    return _bits(pk.run_program_plain(mini, {"x": typed[0], "y": typed[1]},
                                      n, params))


def _kernel_dataflow(prog, cols, n, params):
    """``schedule_program``'s output run as the kernel runs it: the previous
    instruction's result, register-file slots, uniform operands, loaded
    operands and negation, each instruction through the plain version."""
    ins, n_slots = pk.schedule_program(prog)
    slots = [None] * n_slots
    prev = torch.zeros(n, dtype=torch.int32)
    for op, dst, a, b, imm, flags, col_ in ins:
        operands = []
        for smem, uni, s in ((pk._A_SMEM, pk._A_UNI, a),
                             (pk._B_SMEM, pk._B_UNI, b)):
            if smem == pk._A_SMEM and flags & pk._A_LOAD:
                operands.append(_bits(cols[prog.columns[col_]]))
            elif flags & uni:
                if flags & pk._UNI_LIT:
                    slot, kind = prog.lits[imm]
                    u = pk._bits_of(pk._scalar(params[0][slot]), kind)
                else:
                    u = imm
                operands.append(torch.full((n,), u, dtype=torch.int32))
            else:
                operands.append(slots[s] if flags & smem else prev)
        if op == "LOAD":
            out = _bits(cols[prog.columns[imm]])
        elif op in ("CONST", "LIT"):
            out = _bits(pk.run_program_plain(
                pk.Program((), ((op, 0, 0, 0, imm, "i"),), (), prog.lits, 0),
                {}, n, params))
        else:
            out = _one_op(prog, op, imm, operands, n, params)
        if flags & pk._NEG:
            out = out ^ 1
        prev = out
        if flags & pk._STORE:
            slots[dst] = out
    return prev != 0


@pytest.mark.parametrize("name,mk", PLAN_EXPRS, ids=[e[0] for e in PLAN_EXPRS])
def test_scheduled_program_computes_the_program(name, mk):
    """Folding uniform operands and NOTs and moving values through
    register-file slots leaves the program's outcome bit for bit."""
    _, pt = _tables(zlib.crc32(name.encode()), 257)
    param = mk().to_param()
    kinds = pk._kinds(pt.columns, param, PLAN_PARAMS)
    prog = pk.compile_program(param, *kinds)
    want = pk.run_program_plain(prog, pt.columns, 257, PLAN_PARAMS)
    got = _kernel_dataflow(prog, pt.columns, 257, PLAN_PARAMS)
    assert torch.equal(got, want.to(torch.bool))
    ins, n_slots = pk.schedule_program(prog)
    assert len(ins) <= len(prog.instrs) and n_slots <= pk.N_REGS


def test_schedule_folds_uniform_operands_and_negation():
    def sched(e):
        prog = pk.compile_program(e.to_param(), (("a", "i"), ("b", "i")),
                                  ((0, "i"),))
        return pk.schedule_program(prog)

    ins, slots = sched(col("a").not_null())
    assert [i[0] for i in ins] == ["ISNULL_I32"] and slots == 0
    assert ins[0][5] == pk._NEG | pk._A_LOAD and ins[0][6] == 0
    ins, slots = sched((col("a") >= 3) & (col("b") < 10))
    assert [i[0] for i in ins] == ["CMP_GE_I32", "CMP_LT_I32", "AND"]
    assert ins[0][4] == 3 and ins[0][5] == pk._B_UNI | pk._A_LOAD | pk._STORE
    assert ins[1][4] == 10 and ins[1][6] == 1 and slots == 1
    assert ins[2][5] == pk._A_SMEM
    # a literal on the left: a uniform operand a, the LOAD stays (operand b)
    ins, _ = sched(HoistedLit(0) < col("b"))
    assert [i[0] for i in ins] == ["LOAD", "CMP_LT_I32"]
    assert ins[-1][5] == pk._A_UNI | pk._UNI_LIT


@pytest.mark.parametrize("n", [1, pk.PRED_TILE - 1, pk.PRED_TILE,
                               pk.PRED_TILE + 1, 48_000_000])
def test_launch_plan_grid_and_tiles(n):
    prog = pk.compile_program(col("a").not_null().to_param(), (("a", "i"),))
    plan = pk.plan_predicate_launch(prog, n, 132)
    assert plan.rows == pk.PRED_ROWS[0] and plan.tile == pk.PRED_TILE
    assert plan.n_slots == 0 and plan.smem_bytes == ctypes.sizeof(pk._PredArgs)
    tiles = -(-n // plan.tile)
    assert plan.grid == min(tiles, 132 * plan.blocks_per_sm)
    assert plan.blocks_per_sm == pk.THREADS_PER_SM // pk.PRED_THREADS
    # the card's own occupancy, when given, sets the persistent grid
    plan = pk.plan_predicate_launch(prog, n, 132,
                                    occupancy=lambda rows, smem: 3)
    assert plan.grid == min(tiles, 396)


@pytest.mark.parametrize("name,mk", PLAN_EXPRS, ids=[e[0] for e in PLAN_EXPRS])
def test_launch_plan_fits_shared_memory(name, mk):
    """Every program's register file, whitelists and argument fit in a
    block's shared memory on sm_90, at 16 rows a thread where they can."""
    _, pt = _tables(3, 40)
    param = mk().to_param()
    prog = pk.compile_program(param, *pk._kinds(pt.columns, param,
                                                PLAN_PARAMS))
    tables = pk._table_operands(prog, PLAN_PARAMS[1], "cpu")
    plan = pk.plan_predicate_launch(prog, 10 ** 8, 132,
                                    [t.shape[0] for t in tables])
    assert plan.smem_bytes <= pk.SMEM_PER_BLOCK and plan.blocks_per_sm >= 1
    assert plan.table_words == sum(
        t.shape[0] for t, o in zip(tables, plan.table_offsets) if o >= 0) \
        + pk.BITMAP_WORDS * sum(o >= 0 for o in plan.bitmap_offsets)
    wide = ctypes.sizeof(pk._PredArgs) + 16 * (-(-plan.table_words // 4)) \
        + 4 * plan.n_slots * pk.PRED_THREADS * pk.PRED_ROWS[0]
    assert plan.rows == (pk.PRED_ROWS[0] if wide <= pk.SMEM_PER_BLOCK
                         else pk.PRED_ROWS[1])
    assert plan.smem_bytes == wide - 4 * plan.n_slots * pk.PRED_THREADS * (
        pk.PRED_ROWS[0] - plan.rows)


def test_launch_plan_at_the_budgets():
    """The most the interpreter takes: 16 registers (15 slots: the 8-row
    tile) and eight whitelists of MAX_ISIN_VALUES (all in shared memory);
    a longer whitelist is searched in global memory."""
    e = _nested_sum("abzab" * 3 + "z") > 0
    for k, c in enumerate("abzabzab"):
        e = e | col(c).isin(list(range(3 * k, 3 * k + pk.MAX_ISIN_VALUES)))
    _, pt = _tables(4, 40)
    prog = pk.compile_program(e.to_param(),
                              *pk._kinds(pt.columns, e.to_param(), None))
    assert len(prog.tables) == pk.MAX_TABLES
    plan = pk.plan_predicate_launch(prog, 10 ** 8, 132)
    assert plan.n_slots == 15 and plan.rows == pk.PRED_ROWS[1]
    assert plan.table_offsets == tuple(range(0, 8 * 1024, 1024))
    assert plan.bitmap_offsets == tuple(range(8 * 1024, 16 * 1024,
                                              pk.BITMAP_WORDS))
    assert plan.smem_bytes <= pk.SMEM_PER_BLOCK
    wide = col("a").isin(list(range(pk.MAX_ISIN_VALUES + 1)))
    prog = pk.compile_program(wide.to_param(), (("a", "i"),))
    plan = pk.plan_predicate_launch(prog, 100, 132)
    assert plan.table_offsets == (-1,) and plan.table_words == 0
    assert plan.bitmap_offsets == (-1,)
    # a float whitelist is searched, never a bitmap
    prog = pk.compile_program(col("x").isin([0.5, 1.5]).to_param(),
                              (("x", "f"),))
    plan = pk.plan_predicate_launch(prog, 100, 132)
    assert plan.table_offsets == (0,) and plan.bitmap_offsets == (-1,)
    assert plan.table_words == 8
