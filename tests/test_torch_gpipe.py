"""GPipe (``repro_torch.distributed.pipeline.pipeline_transformer``) on 4
gloo ranks on the CPU against the reference's sequential run.

The reference test's shapes (``tests/test_pipeline.py``): 4 stages of 2
layers ``tanh(x @ W)``, 8 microbatches of 4 x 16.  The sequential result
and its gradients come from the reference, in process, with no mesh; the
port's pipeline runs in one spawn of 4 ranks (``launch.gpipe_rank``), its
output whole on every rank and the gradients gathered over "pipe".  The
reference's own bounds: 1e-5 forward, 1e-4 for gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.distributed import launch

P_STAGES, LPS, M, MB, D = 4, 2, 8, 4, 16


@pytest.fixture(scope="module")
def run():
    Ws = jax.random.normal(jax.random.key(0), (P_STAGES, LPS, D, D),
                           jnp.float32) * 0.1
    mbs = jax.random.normal(jax.random.key(1), (M, MB, D), jnp.float32)

    def sequential(Ws):
        y = mbs
        for s in range(P_STAGES):
            for l in range(LPS):
                y = jnp.tanh(y @ Ws[s, l])
        return y

    ref = np.asarray(sequential(Ws))
    grads = np.asarray(jax.grad(lambda w: sequential(w).sum())(Ws))
    got = launch.spawn(launch.gpipe_rank, P_STAGES,
                       (np.asarray(Ws), np.asarray(mbs)), device="cpu",
                       timeout=300)
    return ref, grads, got


def test_forward_matches_sequential(run):
    ref, _, got = run
    assert got[0]["out"].shape == ref.shape
    assert float(np.abs(got[0]["out"] - ref).max()) < 1e-5


def test_gradients_match_sequential(run):
    _, grads, got = run
    assert got[0]["grads"].shape == grads.shape
    assert float(np.abs(got[0]["grads"] - grads).max()) < 1e-4


def test_only_the_first_rank_reports(run):
    assert all(r is None for r in run[2][1:])
