"""The port's fused cross-entropy (plain chunked version, which CPU tensors
take, and the kernel wrappers on the CPU) against the JAX package's
``fused_cross_entropy`` and ``fused_cross_entropy_pallas`` in interpret mode,
on the cases of tests/test_cross_entropy_pallas.py and tests/test_ops.py.
f32: loss 1e-5 relative; gradients rtol 1e-4, atol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ssi_tpu.constants import CROSS_ENTROPY_IGNORE_IDX as JAX_IGNORE
from ssi_tpu.ops.cross_entropy import fused_cross_entropy as jax_ce
from ssi_tpu.ops.cross_entropy_pallas import _compute_lse, fused_cross_entropy_pallas
from ssi_tpu_torch.constants import CROSS_ENTROPY_IGNORE_IDX
from ssi_tpu_torch.ops.cross_entropy import (
    cross_entropy_de,
    cross_entropy_de_gemm,
    cross_entropy_dh,
    cross_entropy_dh_gemm,
    cross_entropy_dlogits,
    cross_entropy_lse,
    cross_entropy_lse_merge,
    cross_entropy_sum_and_count,
    fused_cross_entropy,
)
from ssi_tpu_torch.ops.cross_entropy_cuda import (
    cross_entropy_de_gemm_kernel,
    cross_entropy_de_kernel,
    cross_entropy_dh_gemm_kernel,
    cross_entropy_dh_kernel,
    cross_entropy_dlogits_kernel,
    cross_entropy_lse_kernel,
    fused_cross_entropy_kernel,
)

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

CASES = {
    # name: (n, v, d, seed, ignore every k-th label (0: none), all ignored, port chunk, jax chunk, pallas blocks)
    "pallas_fwd": (100, 300, 64, 0, 7, False, 32, 64, (32, 128)),
    "odd_vocab_257": (64, 257, 32, 1, 7, False, 16, 64, (32, 128)),
    "all_ignored": (32, 128, 32, 0, 0, True, 8, 32, (32, 128)),
    "ops_64x50": (64, 50, 8, 0, 5, False, 16, 16, None),
    "ops_100x37": (100, 37, 8, 0, 5, False, 32, 32, None),
    "ops_7x13": (7, 13, 8, 0, 5, False, 16, 16, None),
    "ops_grads_48x30": (48, 30, 8, 1, 7, False, 16, 16, None),
}


def make_inputs(n, v, d, seed, every, all_ignored):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    e = rng.standard_normal((v, d)).astype(np.float32)
    y = rng.integers(0, v, n).astype(np.int32)
    if every:
        y[::every] = JAX_IGNORE
    if all_ignored:
        y[:] = JAX_IGNORE
    return h, e, y


def torch_loss_and_grads(fn, h, e, y, *args):
    th = torch.from_numpy(h).requires_grad_()
    te = torch.from_numpy(e).requires_grad_()
    loss = fn(th, te, torch.from_numpy(y), *args)
    loss.backward()
    return float(loss.detach()), th.grad.numpy(), te.grad.numpy()


def jax_loss_and_grads(fn, h, e, y):
    loss, grads = jax.value_and_grad(lambda a, b: fn(a, b, jnp.asarray(y)), argnums=(0, 1))(jnp.asarray(h), jnp.asarray(e))
    return float(loss), np.asarray(grads[0]), np.asarray(grads[1])


def test_ignore_index_copy_matches_jax():
    assert CROSS_ENTROPY_IGNORE_IDX == JAX_IGNORE


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("port", ["plain", "kernel_wrapper"])
def test_cross_entropy_matches_jax(case, port):
    n, v, d, seed, every, all_ignored, chunk, jax_chunk, blocks = CASES[case]
    h, e, y = make_inputs(n, v, d, seed, every, all_ignored)
    fn = fused_cross_entropy if port == "plain" else fused_cross_entropy_kernel
    loss, dh, de = torch_loss_and_grads(fn, h, e, y, chunk)

    want = [jax_loss_and_grads(lambda a, b, c: jax_ce(a, b, c, jax_chunk), h, e, y)]
    if blocks is not None:
        with pltpu.force_tpu_interpret_mode():
            want.append(jax_loss_and_grads(lambda a, b, c: fused_cross_entropy_pallas(a, b, c, *blocks), h, e, y))
    for w_loss, w_dh, w_de in want:
        np.testing.assert_allclose(loss, w_loss, rtol=1e-5)
        np.testing.assert_allclose(dh, w_dh, **GRAD_TOL)
        np.testing.assert_allclose(de, w_de, **GRAD_TOL)
    if all_ignored:
        assert loss == 0.0
        np.testing.assert_array_equal(dh, 0.0)
        np.testing.assert_array_equal(de, 0.0)


@pytest.mark.parametrize("case", sorted(c for c in CASES if CASES[c][-1] is not None))
def test_dlogits_products_match_jax_pallas_grads(case):
    """The backward as the port computes it, one dlogits pass then two
    products: ``dlogits @ E`` and ``dlogits^T @ h`` against the gradients of
    the JAX ``fused_cross_entropy_pallas`` in interpret mode (g = 1), for the
    plain versions (``cross_entropy_dlogits``, ``cross_entropy_dh_gemm``,
    ``cross_entropy_de_gemm``) and for the kernel wrappers' CPU path.
    f32: rtol 1e-4, atol 1e-5."""
    n, v, d, seed, every, all_ignored, chunk, _, blocks = CASES[case]
    h, e, y = make_inputs(n, v, d, seed, every, all_ignored)
    with pltpu.force_tpu_interpret_mode():
        _, w_dh, w_de = jax_loss_and_grads(lambda a, b, c: fused_cross_entropy_pallas(a, b, c, *blocks), h, e, y)
    th, te, ty = map(torch.from_numpy, (h, e, y))
    g = torch.tensor(1.0)
    dl = cross_entropy_dlogits(th, te, ty, g, chunk)
    assert dl.shape == (n, v) and dl.dtype == te.dtype
    np.testing.assert_allclose(cross_entropy_dh_gemm(dl, te).numpy(), w_dh, **GRAD_TOL)
    np.testing.assert_allclose(cross_entropy_de_gemm(dl, th).numpy(), w_de, **GRAD_TOL)
    dl_k = cross_entropy_dlogits_kernel(th, te, ty, cross_entropy_lse(th, te, chunk), g, chunk)
    np.testing.assert_allclose(cross_entropy_dh_gemm_kernel(dl_k, te).numpy(), w_dh, **GRAD_TOL)
    np.testing.assert_allclose(cross_entropy_de_gemm_kernel(dl_k, th).numpy(), w_de, **GRAD_TOL)


LSE_TILE = 256  # vocab columns of one (max, sum) pair of the bf16 lse kernel (csrc/cross_entropy_hopper.cu)


@pytest.mark.parametrize("v", [1100, 513])  # 4 full tiles and a 76-column tail; 2 and a 1-column tail
def test_lse_by_vocab_tiles_and_merge_match_jax_pallas(v):
    """The arithmetic of the card's bf16 logsumexp: each 256-column vocab
    tile's logsumexp (here the plain version on the tile's rows), merged in
    tile order by the plain merge pass, against the JAX ``_compute_lse``
    Pallas kernel in interpret mode (streaming over 128-column blocks, the
    columns past V masked). Row 5's largest logit sits in the ragged last
    tile. f32: atol 1e-5, rtol 1e-6."""
    n, d, token_block, vocab_block = 64, 32, 32, 128
    h, e, _ = make_inputs(n, v, d, 5, 0, False)
    e[v - 1] = h[5]  # row 5's logit |h_5|^2 against a spread of ~sqrt(d)
    assert int(np.argmax(h[5] @ e.T)) == v - 1
    th, te = torch.from_numpy(h), torch.from_numpy(e)
    parts = torch.stack([cross_entropy_lse(th, te[v0:v0 + LSE_TILE], 16) for v0 in range(0, v, LSE_TILE)])
    got = cross_entropy_lse_merge(parts).numpy()
    v_pad = -(-v // vocab_block) * vocab_block
    e_pad = np.concatenate([e, np.zeros((v_pad - v, d), np.float32)])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_compute_lse(jnp.asarray(h), jnp.asarray(e_pad), v, token_block, vocab_block))[:, 0]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


def test_sum_and_count():
    h, e, y = make_inputs(64, 50, 8, 0, 5, False)
    loss, count = cross_entropy_sum_and_count(torch.from_numpy(h), torch.from_numpy(e), torch.from_numpy(y), 16)
    assert int(count) == int(np.sum(y != JAX_IGNORE))
    np.testing.assert_allclose(float(loss), float(jax_ce(jnp.asarray(h), jnp.asarray(e), jnp.asarray(y), 16)), rtol=1e-5)


def test_kernel_plain_versions_match_numpy():
    """The plain versions the kernels are held against on the card: lse,
    dlogits, dh and dE against a float64 numpy computation, with g = 0.7."""
    h, e, y = make_inputs(40, 257, 16, 3, 7, False)
    logits = h.astype(np.float64) @ e.astype(np.float64).T
    lse = np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1)) + logits.max(1)
    valid = y != JAX_IGNORE
    dl = np.exp(logits - lse[:, None])
    dl[np.arange(len(y))[valid], y[valid]] -= 1.0
    dl = np.where(valid[:, None], dl, 0.0) * 0.7
    th, te, ty = map(torch.from_numpy, (h, e, y))
    g = torch.tensor(0.7)
    np.testing.assert_allclose(cross_entropy_dlogits(th, te, ty, g, 16).numpy(), dl, **GRAD_TOL)
    for lse_fn, dh_fn, de_fn in ((cross_entropy_lse, cross_entropy_dh, cross_entropy_de),
                                 (cross_entropy_lse_kernel, None, None)):
        np.testing.assert_allclose(lse_fn(th, te, 16).numpy(), lse, rtol=1e-5)
        if dh_fn is not None:
            np.testing.assert_allclose(dh_fn(th, te, ty, g, 16).numpy(), dl @ e, **GRAD_TOL)
            np.testing.assert_allclose(de_fn(th, te, ty, g, 16).numpy(), dl.T @ h, **GRAD_TOL)
    lse_t = torch.from_numpy(lse.astype(np.float32))
    np.testing.assert_allclose(cross_entropy_dh_kernel(th, te, ty, lse_t, g, 16).numpy(), dl @ e, **GRAD_TOL)
    np.testing.assert_allclose(cross_entropy_de_kernel(th, te, ty, lse_t, g, 16).numpy(), dl.T @ h, **GRAD_TOL)


def test_bf16_within_bound_of_f32():
    """bf16 operands (f32 accumulation) stay within 2e-2 of the f32 loss per token."""
    h, e, y = make_inputs(64, 257, 32, 4, 7, False)
    l32 = fused_cross_entropy(torch.from_numpy(h), torch.from_numpy(e), torch.from_numpy(y), 16)
    hb, eb = torch.from_numpy(h).bfloat16(), torch.from_numpy(e).bfloat16()
    l16 = fused_cross_entropy(hb, eb, torch.from_numpy(y), 16)
    n = int(np.sum(y != JAX_IGNORE))
    assert abs(float(l16) - float(l32)) / n < 2e-2


def test_wrappers_reject_bad_shapes():
    h = torch.zeros((8, 16))
    with pytest.raises(ValueError, match="hidden"):
        fused_cross_entropy_kernel(h, torch.zeros((10, 12)), torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="labels"):
        fused_cross_entropy_kernel(h, torch.zeros((10, 16)), torch.zeros(7, dtype=torch.int32))
