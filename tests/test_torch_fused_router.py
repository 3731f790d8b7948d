"""The port's fused router (plain version, on the CPU) against the JAX
package's ``fused_router``, whose Pallas kernel runs in interpret mode here
as ``tests/test_moe_router.py`` runs it.

``expert_idx`` must be identical, including rows with planted exact ties
(duplicated logit columns: the lower expert index wins, as ``lax.top_k``
breaks them) and a ragged T that pads the kernel's last block. gate_vals,
lse and probs_mean to 1e-6 (fp32 softmax and sums of up to a few hundred
rows in another order: ~1e-7). The backward (the JAX ``_fused_router_bwd``
formula, written in torch) against ``jax.grad`` of a weighted sum of the
three differentiable outputs, to 1e-6 as well.

The kernel's reduction order for probs_mean is emulated in fp32 on the
plain version's probabilities: per block, each warp's rows by the shuffle
tree, the warps in order; the last block's merge in
``_router_schedule``'s parts (part q: blocks q, q + parts, ... in order),
then the parts in order, divided by T. It is held to the JAX probs_mean to 1e-6 at T 1, 129 and
1000 and E 6, 8 and 64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_distributed_training_example_tpu.ops import (
    fused_router as jax_router)
from pytorch_distributed_training_example_tpu_torch.ops import (
    fused_router as router_lib)

TOL = dict(rtol=1e-6, atol=1e-6)


def _logits(T, E, seed, ties):
    logits = (np.random.default_rng(seed).standard_normal((T, E)) * 3.0
              ).astype(np.float32)
    if ties:  # columns 3 and 5 repeat 0 and 1 on every other row
        logits[::2, 3] = logits[::2, 0]
        logits[::2, E - 1] = logits[::2, 1]
    return logits


@jax.jit
def _jax_router(logits, wg, wl, wp):
    """The JAX router's outputs and the grad of sum(wg g) + sum(wl lse) +
    sum(wp probs_mean) with respect to the logits."""
    def f(x):
        g, idx, lse, pm = jax_router.fused_router(x, 2)
        return jnp.sum(wg * g) + jnp.sum(wl * lse) + jnp.sum(wp * pm), (
            g, idx, lse, pm)
    grad, out = jax.grad(f, has_aux=True)(logits)
    return out, grad


@pytest.mark.parametrize("T,E,ties", [(64, 8, False), (37, 6, True),
                                      (515, 8, True)])
def test_fused_router_and_grad_match_jax(T, E, ties):
    logits = _logits(T, E, T, ties)
    rng = np.random.default_rng(1)
    wg = rng.standard_normal((T, 2)).astype(np.float32)
    wl = rng.standard_normal(T).astype(np.float32)
    wp = rng.standard_normal(E).astype(np.float32)
    (g, idx, lse, pm), grad = _jax_router(*map(jnp.asarray,
                                               (logits, wg, wl, wp)))

    x = torch.from_numpy(logits).requires_grad_()
    got = router_lib.fused_router(x, 2)
    assert got[1].dtype == torch.int32 and got[1].shape == (T, 2)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(idx))
    for name, a, b in (("gate_vals", got[0], g), ("lse", got[2], lse),
                       ("probs_mean", got[3], pm)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   err_msg=name, **TOL)
    loss = ((got[0] * torch.from_numpy(wg)).sum()
            + (got[2] * torch.from_numpy(wl)).sum()
            + (got[3] * torch.from_numpy(wp)).sum())
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), **TOL)
    if ties:  # a tie goes to the lower index
        assert (got[1][::2, 0] != 3).all() and (got[1][::2, 0] != E - 1).all()


def test_top_k_first_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.3, 0.3, 0.1, 0.3], [0.1, 0.2, 0.35, 0.35]])
    vals, idx = router_lib.top_k_first(probs, 3)
    assert idx.tolist() == [[0, 1, 3], [2, 3, 1]]
    torch.testing.assert_close(vals, probs.gather(1, idx))
    with pytest.raises(ValueError, match="top_k"):
        router_lib.fused_router_fwd(torch.zeros(4, 3), 4)


def _emulated_probs_mean(probs, E):
    """probs_mean as the kernel sums it: in each block, each warp's rows by
    the shuffle tree (lanes G apart: rows 2i and 2i + 1, then pairs of
    those, ...), the warps in order; then the last block's merge in the
    schedule's parts, the parts in order, over T."""
    T = probs.shape[0]
    blocks, rows, parts, workspace = router_lib._router_schedule(T, E)
    assert workspace == blocks * E
    warps = router_lib.BLOCK_THREADS // 32
    padded = torch.zeros(blocks * rows, E)
    padded[:T] = probs
    partial = []
    for b in range(blocks):
        v = padded[b * rows:(b + 1) * rows].reshape(warps, rows // warps, E)
        while v.shape[1] > 1:
            v = v[:, 0::2] + v[:, 1::2]
        s = torch.zeros(E)
        for w in range(warps):
            s = s + v[w, 0]
        partial.append(s)
    total = torch.zeros(E)
    for q in range(parts):
        acc = torch.zeros(E)
        for b in range(q, blocks, parts):
            acc = acc + partial[b]
        total = total + acc
    return total / T


@pytest.mark.parametrize("T,E", [(1, 8), (129, 64), (1000, 6), (515, 8)])
def test_emulated_probs_mean_order_matches_jax(T, E):
    logits = _logits(T, E, T + E, ties=False)
    pm = np.asarray(jax.jit(lambda x: jax_router.fused_router(x, 2)[3])(
        jnp.asarray(logits)))
    probs = router_lib._softmax_lse(torch.from_numpy(logits))[0]
    got = _emulated_probs_mean(probs, E)
    np.testing.assert_allclose(got.numpy(), pm, **TOL)
    # The partials' order moves the sum by a few ulp at most.
    np.testing.assert_allclose(got.numpy(), probs.mean(0).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_router_schedule():
    # 8 lanes a row at E <= 8: 32 rows a block; 16 lanes; 32 lanes above.
    assert router_lib._router_schedule(8192, 8) == (256, 32, 32, 2048)
    assert router_lib._router_schedule(1, 64) == (1, 8, 4, 64)
    assert router_lib._router_schedule(129, 6) == (5, 32, 42, 30)
    assert router_lib._router_schedule(100, 16) == (7, 16, 16, 112)
