"""Port parity: ``repro_torch.core.orchestrator`` against
``repro.core.orchestrator`` over many rounds.

The reference breaks ties with ``jax.random`` draws that torch cannot
reproduce, so the port is given the reference's own ``select_key(t)``
draws through its pluggable jitter source.  With that, selections must
be EQUAL at every iteration, and the float32 bandit state agrees to
1e-6 relative (the same f32 ops; only ``log`` and ``sqrt`` of XLA and
torch may round the last bit differently)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import orchestrator as jorch
from repro_torch.core import orchestrator as torch_orch


def reference_jitter(ref: jorch.Orchestrator):
    def draw(counter, n):
        return np.asarray(jax.random.uniform(ref.select_key(counter), (n,),
                                             jnp.float32, 0.0, 1.0))
    return draw


def _state_close(got, want):
    for k in ("l_disc", "s_disc", "last", "prev"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)
    assert int(got["t"]) == int(want["t"])


@pytest.mark.parametrize("n,eta,seed", [(8, 0.5, 0), (13, 0.3, 4),
                                        (5, 1.0, 2)])
def test_selections_equal_reference_over_many_rounds(n, eta, seed):
    ref = jorch.Orchestrator(n, eta, gamma=0.87, seed=seed)
    port = torch_orch.Orchestrator(n, eta, gamma=0.87, seed=seed,
                                   device="cpu",
                                   jitter=reference_jitter(ref))
    _state_close(port.state, ref.state)
    rng = np.random.default_rng(seed)
    for r in range(6):
        ref.new_round()
        port.new_round()
        _state_close(port.state, ref.state)
        for t in range(5):
            s_ref, s_port = ref.select(), port.select()
            np.testing.assert_array_equal(s_port, s_ref)
            losses = rng.uniform(0.5, 3.0, size=len(s_ref))
            if t % 2:                       # exact ties between clients
                losses[:] = losses[0]
            ref.update(s_ref, losses)
            port.update(s_port, losses)
            _state_close(port.state, ref.state)


def test_functional_api_matches_reference():
    n = 6
    sj = jorch.ucb_init(n, gamma=0.9)
    st = torch_orch.ucb_init(n, gamma=0.9, device="cpu")
    rng = np.random.default_rng(1)
    for step in range(4):
        np.testing.assert_allclose(torch_orch.ucb_advantage(st).numpy(),
                                   np.asarray(jorch.ucb_advantage(sj)),
                                   rtol=1e-6)
        sel = (rng.random(n) > 0.5).astype(np.float32)
        loss = rng.uniform(0, 2, n).astype(np.float32)
        sj = jorch.ucb_update(sj, jnp.asarray(sel), jnp.asarray(loss),
                              gamma=0.9)
        st = torch_orch.ucb_update(st, torch.from_numpy(sel),
                                   torch.from_numpy(loss), gamma=0.9)
        _state_close(st, sj)
    _state_close(torch_orch.ucb_new_round(st, gamma=0.9),
                 jorch.ucb_new_round(sj, gamma=0.9))
    a = rng.normal(size=n).astype(np.float32)
    jit = rng.random(n).astype(np.float32)
    np.testing.assert_array_equal(
        torch_orch.ucb_select_from_advantage(torch.from_numpy(a), 3,
                                             jit).numpy(),
        np.sort(np.argsort(-(a + jit * np.float32(2e-7)
                             * (1 + np.abs(a).max())))[:3]))


def test_default_jitter_is_seeded_and_counter_keyed():
    a = torch_orch.Orchestrator(7, 0.5, seed=3, device="cpu")
    b = torch_orch.Orchestrator(7, 0.5, seed=3, device="cpu")
    sa = [a.select() for _ in range(4)]
    sb = [b.select() for _ in range(4)]
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x, y)
    draw = torch_orch.generator_jitter(3)
    assert not torch.equal(draw(0, 7), draw(1, 7))
    assert torch.equal(draw(5, 7), draw(5, 7))
