"""The port's flash-attention backward on the CPU — the autograd Function
(``flash_attention``) and the plain backward ``flash_attention_bwd_reference``
called directly — against ``jax.grad`` of the JAX Pallas kernel in interpret
mode (grouped and ungrouped schedules), and at an odd S, which the Pallas
kernel does not take, against ``jax.grad`` of ``xla_attention``. f32;
rtol 5e-4, atol 5e-5, as tests/test_flash_attention.py; the head_dim-128
cases (Llama 3.2 3B's and 3.1 8B's GQA ratios) rtol 2e-5 and atol 2e-5 of
each gradient's largest entry."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ssi_tpu.ops.attention import xla_attention
from ssi_tpu.ops.flash_attention import flash_attention as jflash
from ssi_tpu_torch.ops.attention import dispatch_attention, reference_attention
from ssi_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
)

TOL = dict(rtol=5e-4, atol=5e-5)


def make_qkv(b=1, s=128, hq=4, hkv=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))


def segments(b, s, cut):
    return np.concatenate([np.ones((b, cut)), np.full((b, s - cut), 2)], axis=1).astype(np.int32)


CASES = {
    # name: (make_qkv kwargs, causal, segment cut or None, JAX group_heads)
    "causal": (dict(), True, None, False),
    "causal_grouped": (dict(), True, None, True),
    "full": (dict(seed=1), False, None, False),
    "full_grouped": (dict(seed=1), False, None, True),
    "gqa_8_2": (dict(hq=8, hkv=2, seed=2), True, None, False),
    "gqa_8_2_grouped": (dict(hq=8, hkv=2, seed=2), True, None, True),
    "mha": (dict(hq=4, hkv=4, seed=4), True, None, False),
    "segments": (dict(seed=3), True, 96, False),
    "segments_grouped": (dict(seed=3), True, 96, True),
}
# head_dim 128 at the GQA ratios of Llama 3.2 3B (3) and Llama 3.1 8B (4)
HD128_CASES = {
    "nrep3": (dict(hq=6, hkv=2, d=128, seed=10), True, None, False),
    "nrep3_grouped": (dict(hq=6, hkv=2, d=128, seed=10), True, None, True),
    "nrep4": (dict(hq=8, hkv=2, d=128, seed=11), True, None, False),
    "nrep4_full": (dict(hq=8, hkv=2, d=128, seed=12), False, None, False),
    "nrep3_segments": (dict(hq=6, hkv=2, d=128, seed=13), True, 96, False),
}


def jax_grads(fn, q, k, v):
    def loss(q, k, v):
        return jnp.sum(jnp.square(fn(q, k, v)))

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def port_grads(attn, q, k, v):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    attn(tq, tk, tv).square().sum().backward()
    return [x.grad.numpy() for x in (tq, tk, tv)]


def reference_grads(q, k, v, causal, seg):
    """flash_attention_bwd_reference called directly, do = d(sum o^2)/do = 2 o."""
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = flash_attention_fwd(tq, tk, tv, causal=causal, segment_ids=seg)
    return [x.numpy() for x in flash_attention_bwd_reference(tq, tk, tv, o, lse, 2 * o, causal=causal, segment_ids=seg)]


def check_against_pallas(kw, causal, cut, group_heads, tol, atol_of_max=None):
    """The port's gradients (the autograd Function and the plain backward
    called directly) against ``jax.grad`` of the Pallas kernel in interpret
    mode, within ``tol``; with ``atol_of_max``, each gradient's atol is that
    fraction of its largest entry."""
    q, k, v = make_qkv(**kw)
    seg = None if cut is None else segments(q.shape[0], q.shape[1], cut)
    jseg = None if seg is None else jnp.asarray(seg)
    tseg = None if seg is None else torch.from_numpy(seg)
    with pltpu.force_tpu_interpret_mode():
        want = jax_grads(lambda a, b, c: jflash(a, b, c, causal=causal, segment_ids=jseg, block_q=64,
                                                group_heads=group_heads), q, k, v)
    got_fn = port_grads(lambda a, b, c: flash_attention(a, b, c, causal=causal, segment_ids=tseg), q, k, v)
    got_ref = reference_grads(q, k, v, causal, tseg)
    for name, w, a, b in zip("qkv", want, got_fn, got_ref):
        lim = dict(tol, atol=atol_of_max * float(np.abs(w).max())) if atol_of_max else tol
        np.testing.assert_allclose(a, w, err_msg=f"Function d{name}", **lim)
        np.testing.assert_allclose(b, w, err_msg=f"reference d{name}", **lim)


@pytest.mark.parametrize("case", sorted(HD128_CASES))
def test_flash_backward_hd128_matches_pallas_interpret(case):
    """2e-5 relative, and 2e-5 of each gradient's largest entry absolute
    (entries reach 10-50 here; in f32 each side sits 1e-5-3e-5 from a float64
    reference, and one full-suite run put dq 1.5e-4 off the JAX value at
    |dq| up to 10: a flat 2e-5 does not hold at this scale)."""
    check_against_pallas(*HD128_CASES[case], tol=dict(rtol=2e-5), atol_of_max=2e-5)


def float64_grads(q, k, v, causal, seg):
    """d(sum o^2)/d(q, k, v) of plain attention in float64 (torch autograd)."""
    tq, tk, tv = (torch.from_numpy(x).double().requires_grad_() for x in (q, k, v))
    s, d, n_rep = q.shape[1], q.shape[3], q.shape[2] // k.shape[2]
    scores = torch.einsum("bqhd,bkhd->bhqk", tq, tk.repeat_interleave(n_rep, dim=2)) / d**0.5
    mask = torch.ones(s, s, dtype=torch.bool)
    mask = (torch.tril(mask) if causal else mask)[None, None]
    if seg is not None:
        sg = torch.from_numpy(seg)
        mask = mask & (sg[:, :, None] == sg[:, None, :])[:, None]
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    torch.einsum("bhqk,bkhd->bqhd", probs, tv.repeat_interleave(n_rep, dim=2)).square().sum().backward()
    return [x.grad.numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("case", sorted(HD128_CASES))
def test_flash_backward_hd128_each_side_against_float64(case):
    """The head_dim-128 gradients of the JAX Pallas kernel (interpret mode)
    and of the port (the autograd Function) each against a float64 plain
    backward, to 5e-6 of each gradient's largest entry. Both sides measure
    about 1e-6 of it, and both reach 1.4e-5-4.5e-5 relative on entries above
    1% of it: f32 rounding, alike on both sides, is why the check against
    the JAX kernel above needs its absolute term."""
    kw, causal, cut, group_heads = HD128_CASES[case]
    q, k, v = make_qkv(**kw)
    seg = None if cut is None else segments(q.shape[0], q.shape[1], cut)
    with pltpu.force_tpu_interpret_mode():
        jax_side = jax_grads(lambda a, b, c: jflash(a, b, c, causal=causal, block_q=64, group_heads=group_heads,
                                                    segment_ids=None if seg is None else jnp.asarray(seg)), q, k, v)
    tseg = None if seg is None else torch.from_numpy(seg)
    port_side = port_grads(lambda a, b, c: flash_attention(a, b, c, causal=causal, segment_ids=tseg), q, k, v)
    for name, w, j, p in zip("qkv", float64_grads(q, k, v, causal, seg), jax_side, port_side):
        atol = 5e-6 * float(np.abs(w).max())
        np.testing.assert_allclose(j, w, rtol=0, atol=atol, err_msg=f"JAX Pallas d{name}")
        np.testing.assert_allclose(p, w, rtol=0, atol=atol, err_msg=f"port d{name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_backward_matches_pallas_interpret(case):
    check_against_pallas(*CASES[case], tol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_odd_length_backward_matches_xla(causal):
    q, k, v = make_qkv(b=2, s=77, hq=8, hkv=2, seed=5)
    seg = segments(2, 77, 30)
    want = jax_grads(lambda a, b, c: xla_attention(a, b, c, causal=causal, segment_ids=jnp.asarray(seg)), q, k, v)
    tseg = torch.from_numpy(seg)
    got_fn = port_grads(lambda a, b, c: flash_attention(a, b, c, causal=causal, segment_ids=tseg), q, k, v)
    got_ref = reference_grads(q, k, v, causal, tseg)
    # the training attention on the CPU is the plain attention under autograd
    got_dispatch = port_grads(lambda a, b, c: dispatch_attention(a, b, c, causal=causal, segment_ids=tseg), q, k, v)
    for name, w, a, b, c in zip("qkv", want, got_fn, got_ref, got_dispatch):
        np.testing.assert_allclose(a, w, err_msg=f"Function d{name}", **TOL)
        np.testing.assert_allclose(b, w, err_msg=f"reference d{name}", **TOL)
        np.testing.assert_allclose(c, w, err_msg=f"dispatch d{name}", **TOL)


def test_bwd_wrapper_takes_plain_version_on_cpu():
    q, k, v = map(torch.from_numpy, make_qkv(b=1, s=40, hq=4, hkv=1, seed=6))
    o, lse = flash_attention_fwd(q, k, v)
    do = torch.ones_like(o)
    for a, b in zip(flash_attention_bwd(q, k, v, o, lse, do), flash_attention_bwd_reference(q, k, v, o, lse, do)):
        assert torch.equal(a, b)


def test_dispatch_on_cpu_is_the_plain_attention():
    q, k, v = map(torch.from_numpy, make_qkv(b=1, s=24, seed=7))
    assert torch.equal(dispatch_attention(q, k, v), reference_attention(q, k, v))


def test_bf16_backward_within_bound_of_f32():
    q, k, v = make_qkv(b=1, s=64, hq=4, hkv=2, seed=8)
    g32 = port_grads(lambda a, b, c: flash_attention(a, b, c), q, k, v)
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v))
    flash_attention(tq, tk, tv).float().square().sum().backward()
    for a, b in zip((tq, tk, tv), g32):
        assert a.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(a.grad.float().numpy(), b, rtol=5e-2, atol=5e-2)


def test_backward_takes_a_non_contiguous_output_gradient():
    """``.sum()`` hands the backward an expanded (stride-0) do."""
    q, k, v = make_qkv(b=1, s=20, hq=4, hkv=2, seed=9)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    flash_attention(tq, tk, tv).sum().backward()
    want = jax.grad(lambda a, b, c: jnp.sum(xla_attention(a, b, c)), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, a, w in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), err_msg=f"d{name}", **TOL)
