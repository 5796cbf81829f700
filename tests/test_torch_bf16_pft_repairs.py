"""The two pieces of the port that holding bfloat16 PFT against the JAX
package repaired, each held bit for bit against JAX on the CPU (both fail
on the commit before the repair, which resized a bfloat16 disparity in
float32 and stepped bfloat16 leaves with ``torch.optim.Adam``):

* ``resize_bilinear`` on a bfloat16 disparity ('depth_pred'): JAX's
  ``jax.image.resize`` contracts one axis, rounds to bfloat16, contracts
  the other and rounds again, with weights cast to bfloat16; a float32
  resize rounded once differed on 9% (down) and 18% (up) of the elements
  by one bfloat16 ulp;
* ``OptaxBF16``, the optimizer of bfloat16 leaves ('depth_pred',
  'bottleneck'): optax's Adam in bfloat16, one rounding an operation;
  ``torch.optim.Adam`` differs from it on 0.06% (second step) and 0.15%
  (third) of the elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tcsfm_torch.config import Config, PFTOptions
from tcsfm_torch.solver import pft
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


RESIZE_SHAPES = [((6, 64, 96), (16, 24)), ((6, 16, 24), (64, 96)),
                 ((4, 192, 640), (48, 160)), ((4, 48, 160), (192, 640)),
                 ((2, 64, 64), (16, 16)), ((2, 30, 50), (7, 13)),
                 ((2, 64, 96), (64, 24))]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,size", RESIZE_SHAPES)
def test_resize_matches_jax(shape, size, dtype):
    """``resize_bilinear`` against ``jax.image.resize(..., "bilinear")``
    jitted: equal in bfloat16, bit for bit (down and up by 4 at 64x96 and
    192x640, a square's tie of contraction orders, odd sizes, one axis
    alone); within 4 float32 ulps in float32 (the sums' order)."""
    rng = np.random.RandomState(sum(shape) + sum(size))
    x = (0.02 + 0.3 * rng.rand(*shape, 1)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    ref = np.asarray(jax.jit(lambda a: jax.image.resize(
        a, (shape[0], *size, 1), "bilinear"))(jx).astype(jnp.float32))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    ours = pft.resize_bilinear(tx, *size)
    assert ours.dtype == tx.dtype and ours.shape == (shape[0], *size, 1)
    ours = ours.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=4.8e-7, atol=1e-9)


def _optax_steps(kind, p0, grads, lr):
    tx = getattr(optax, kind)(lr)

    @jax.jit
    def step(p, st, g):
        u, st = tx.update(g, st, p)
        return optax.apply_updates(p, u), st

    p, st, out = p0, tx.init(p0), []
    for g in grads:
        p, st = step(p, st, g)
        out.append(np.asarray(p.astype(jnp.float32)))
    return out


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_bf16_leaves_step_as_optax(kind):
    """The optimizer ``PFTOptimizer`` gives bfloat16 leaves (the
    'depth_pred' disparities, the 'bottleneck' skips) takes optax's steps
    bit for bit over three steps: values in [0.01, 0.31] (PFT's
    disparities), lr 2e-4, gradients from 1e-6 to 1e-2 (Adam) or 0.1 to
    10 (SGD), so that some updates round away and some do not. ``torch.optim.Adam`` differs on
    ~0.1% of the elements from the second step on (asserted: the check
    sees it)."""
    rng = np.random.RandomState(0)
    n, lr = 100000, 2e-4
    p0 = jnp.asarray((0.01 + 0.3 * rng.rand(n)).astype(np.float32)).astype(
        jnp.bfloat16)
    # Adam's step is ~lr whatever the gradient; SGD's is lr x g
    lo, hi = (-6, -2) if kind == "adam" else (-1, 1)
    grads = [jnp.asarray((rng.randn(n) * 10 ** rng.uniform(lo, hi, n))
                         .astype(np.float32)).astype(jnp.bfloat16)
             for _ in range(3)]
    ref = _optax_steps(kind, p0, grads, lr)

    def torch_steps(make):
        leaf = torch.from_numpy(np.asarray(p0.astype(jnp.float32))).to(
            torch.bfloat16).requires_grad_(True)
        tx, out = make([leaf]), []
        for g in grads:
            leaf.grad = torch.from_numpy(np.asarray(
                g.astype(jnp.float32))).to(torch.bfloat16)
            tx.step()
            out.append(leaf.detach().float().numpy().copy())
        return out

    opt = pft.PFTOptimizer(Config(), PFTOptions(lr=lr, optimizer=kind),
                           None, None)
    ours = torch_steps(opt._make_optimizer)
    moved = [float(np.mean(r != np.asarray(p0.astype(jnp.float32))))
             for r in ref]
    print(f"{kind}: share of elements moved after each step {moved}")
    assert 0.05 < min(moved) and max(moved) < 0.95
    for step, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"step {step}")
    if kind == "adam":
        plain = torch_steps(lambda ps: torch.optim.Adam(
            ps, lr=lr, betas=(0.9, 0.999), eps=1e-8))
        differ = [float(np.mean(a != b)) for a, b in zip(plain, ref)]
        print(f"torch.optim.Adam against optax: differ on {differ}")
        assert differ[0] == 0.0 and differ[2] > 1e-4
