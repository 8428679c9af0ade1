"""The port's flash_attention (the plain version the CPU takes) against the
JAX Pallas kernel in interpret mode and against ``xla_attention``, with the
cases of tests/test_flash_attention.py and head_dim-128 cases at the GQA
ratios of Llama 3.2 3B (3) and 3.1 8B (4); f32, 2e-5. The lse it returns is
checked against a numpy logsumexp."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ssi_tpu.ops.attention import xla_attention
from ssi_tpu.ops.flash_attention import flash_attention as jflash
from ssi_tpu_torch.ops.attention import reference_attention
from ssi_tpu_torch.ops.flash_attention import flash_attention, flash_attention_fwd

TOL = 2e-5


def make_qkv(b=2, s=256, hq=4, hkv=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))


def numpy_lse(q, k, causal, seg):
    """[B, Hq, S] logsumexp of the masked, scaled scores, in float64."""
    b, s, hq, d = q.shape
    k = np.repeat(k, hq // k.shape[2], axis=2)
    scores = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) / np.sqrt(d)
    mask = np.ones((b, 1, s, s), bool)
    if causal:
        mask &= np.tril(np.ones((s, s), bool))
    if seg is not None:
        mask &= (seg[:, :, None] == seg[:, None, :])[:, None]
    scores = np.where(mask, scores, -np.inf)
    m = scores.max(-1, keepdims=True)
    return (m + np.log(np.exp(scores - m).sum(-1, keepdims=True)))[..., 0]


CASES = {
    # name: (make_qkv kwargs, causal, segment ids, JAX block_q, JAX group_heads)
    "causal": (dict(), True, None, 128, False),
    "causal_grouped": (dict(), True, None, 128, True),
    "full": (dict(), False, None, 128, False),
    "full_grouped": (dict(), False, None, 128, True),
    "gqa": (dict(hq=8, hkv=2), True, None, 128, None),
    "mha": (dict(hq=4, hkv=4, seed=1), True, None, 128, None),
    "segments": (dict(b=1, s=128), True, "halves", 64, None),
    # head_dim 128: Llama 3.2 3B's 3 q heads per kv head, Llama 3.1 8B's 4
    "hd128_nrep3": (dict(hq=6, hkv=2, d=128), True, None, 128, None),
    "hd128_nrep3_grouped": (dict(hq=6, hkv=2, d=128, seed=2), True, None, 128, True),
    "hd128_nrep4": (dict(hq=8, hkv=2, d=128, seed=3), True, None, 128, None),
    "hd128_nrep4_full": (dict(hq=8, hkv=2, d=128, seed=4), False, None, 128, None),
    "hd128_nrep3_segments": (dict(b=1, s=128, hq=6, hkv=2, d=128, seed=5), True, "halves", 64, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_matches_pallas_interpret_and_xla(case):
    kw, causal, seg_kind, block_q, group_heads = CASES[case]
    q, k, v = make_qkv(**kw)
    seg = None
    if seg_kind == "halves":
        s = q.shape[1]
        seg = np.concatenate([np.ones((1, s // 2)), np.full((1, s - s // 2), 2)], axis=1).astype(np.int32)
    jseg = None if seg is None else jnp.asarray(seg)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                 segment_ids=jseg, block_q=block_q, group_heads=group_heads))
    ref = np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, segment_ids=jseg))

    tseg = None if seg is None else torch.from_numpy(seg)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = flash_attention_fwd(tq, tk, tv, causal=causal, segment_ids=tseg)
    np.testing.assert_allclose(o.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(o.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(flash_attention(tq, tk, tv, causal=causal, segment_ids=tseg).numpy(), o.numpy())
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1]) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), numpy_lse(q, k, causal, seg), rtol=TOL, atol=TOL)
    # the port's plain model attention agrees as well
    plain = reference_attention(tq, tk, tv, causal=causal, segment_ids=tseg).numpy()
    np.testing.assert_allclose(plain, ref, rtol=TOL, atol=TOL)


def test_flash_rejects_bad_shapes():
    q, k, v = map(torch.from_numpy, make_qkv(b=1, s=16, hq=6, hkv=4))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v)
    q, k, v = map(torch.from_numpy, make_qkv(b=1, s=16))
    with pytest.raises(ValueError, match="segment_ids"):
        flash_attention(q, k, v, segment_ids=torch.zeros((1, 8), dtype=torch.int32))


@pytest.mark.parametrize("d", [64, 128])
def test_flash_bf16_matches_the_jax_bf16_kernel(d):
    """bf16 operands at head_dim 64 and 128 (3B's n_rep 3) against the JAX
    bf16 Pallas kernel in interpret mode: within 1e-2 in relative norm (the
    bf16 limit of chip_smoke.py). The JAX wrapper rounds q/sqrt(d) to bf16
    before its kernel, exact at head_dim 64 (1/8), a rounding at 128; the
    port scales the f32 scores instead, and both stay within the bound of
    the f32 result."""
    q, k, v = make_qkv(b=1, s=128, hq=6, hkv=2, d=d, seed=11)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jflash(*(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)), block_q=64)).astype(
            np.float32)
    got = flash_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v))).float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-2
    o32 = flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, o32, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(want, o32, rtol=2e-2, atol=2e-2)


def test_flash_bf16_within_jax_bf16_bound():
    """bf16 operands (f32 math inside) stay within the JAX bf16 bound (2e-2)
    of the f32 result."""
    q, k, v = map(torch.from_numpy, make_qkv(b=1, s=128, hq=8, hkv=2, seed=5))
    o32 = flash_attention(q, k, v)
    o16 = flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert o16.dtype == torch.bfloat16
    np.testing.assert_allclose(o16.float().numpy(), o32.numpy(), rtol=2e-2, atol=2e-2)
