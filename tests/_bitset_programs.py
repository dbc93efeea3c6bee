"""Seeded bitset programs for the tests of kernel B3 (the cohort-expression
program kernel), shared by its CPU tests (``test_torch_kernels.py``) and its
card tests (``test_torch_cuda.py``).  Imports neither jax nor a card-only
module.  Usage in test modules::

    from _bitset_programs import PROGRAM_SHAPES, random_program
"""
from repro_torch.kernels import bitset_ops


def random_program(rng, n_leaves, n_ops, first_op=0):
    """A seeded bitset program: op ``j`` is ``OPS[(first_op + j) % 4]``
    (so four or more ops cover every op), each operand a leaf or, half the
    time where there is one, an earlier op's result."""
    ops = list(bitset_ops.OPS)
    prog = []
    for j in range(n_ops):
        pick = [int(rng.integers(n_leaves, n_leaves + j)) if j and
                rng.random() < 0.5 else int(rng.integers(0, n_leaves))
                for _ in range(2)]
        prog.append((ops[(first_op + j) % 4], *pick))
    return tuple(prog)


# (leaves, ops): every count from 1 to 8 of both
PROGRAM_SHAPES = [(k + 1, 8 - k) for k in range(8)]
