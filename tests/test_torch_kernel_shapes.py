"""The shapes the JAX kernels take beyond the registry's (ROADMAP B1-B3), on
the CPU: head_dims other than 64 and 128 in the flash forward and backward
(#1-#4) and the paged core (#8/#9), up to 256 (Gemma's heads) and, in #8/#9,
head_dims that are not multiples of 8; any D in the fused cross-entropy
(#5-#7), and more than 64 query rows of a kv head in #8/#9. The port's plain
versions (what a CPU tensor takes) against the JAX package with the Pallas
kernels in interpret mode, inputs from numpy seeds; the wrappers' CPU-side
logic (instance choice, routes, the pad-to-8 copies, row groups, the
refusals above 256); and greedy tokens of the port's paged engine against
the JAX engine at tiny layouts with heads of 80, 256 and 36, each registered
in both registries for its module's runs. f32 2e-5 (the flash gradients at
tests/test_torch_flash_backward.py's tolerances), bf16 1e-2.
The kernels themselves at these shapes run on the card:
tests/test_torch_cuda_kernels.py and ``chip_smoke.py`` phase t."""

from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ssi_tpu.generate.engine import SamplingParams as JSamplingParams
from ssi_tpu.generate.paged_engine import PagedDecodeEngine as JPagedDecodeEngine
from ssi_tpu.generate.paged_pallas import WRITE_WIN, paged_attention_pallas, paged_attention_pallas_multi
from ssi_tpu.models import configs as jconfigs
from ssi_tpu.models.llama3 import init_params
from ssi_tpu.ops.cross_entropy_pallas import fused_cross_entropy_pallas
from ssi_tpu.ops.flash_attention import flash_attention as jflash
from ssi_tpu_torch.generate import paged_cuda
from ssi_tpu_torch.generate.engine import SamplingParams
from ssi_tpu_torch.generate.paged_cuda import paged_attention_fused, paged_attention_multi_fused
from ssi_tpu_torch.models import configs as tconfigs
from ssi_tpu_torch.models.llama3 import params_from_numpy
from ssi_tpu_torch.ops import cross_entropy_cuda
from ssi_tpu_torch.ops.cross_entropy import cross_entropy_lse, fused_cross_entropy
from ssi_tpu_torch.ops.cross_entropy_cuda import fused_cross_entropy_kernel
from ssi_tpu_torch.ops import flash_attention as flash_attention_module
from ssi_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_reference,
    pad_head_dim,
)
from tests import helpers
from tests.test_torch_paged_engine import make_engine, no_leaks

TOL = 2e-5
BF16_TOL = 1e-2
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_torch_flash_backward.py's
CE_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_cross_entropy.py's


# --- #1-#4: flash forward and backward at head_dims other than 64 and 128 ---------------------------------

# tiny_test's; one below 64; phi-2's; Phi-3-mini's; Gemma's; one in 129-255; one in 129-255 not a multiple of 8
HEAD_DIMS = [16, 40, 80, 96, 256, 200, 131]


def make_qkv(d, b=2, s=96, hq=4, hkv=2, seed=0):
    """q, k, v in f32 and segment ids of two segments a row (S 96: not a
    multiple of the kernels' 128-row tiles)."""
    rng = np.random.default_rng(seed + d)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    seg = np.ones((b, s), np.int32)
    seg[:, s // 3:] = 2
    seg[-1, 2 * s // 3:] = 3
    return q, k, v, seg


def jax_flash(q, k, v, seg, causal):
    """The Pallas kernel; the caller holds interpret mode (around ``jax.grad``
    too, so that the backward's kernels run in it)."""
    return jflash(q, k, v, causal=causal, segment_ids=None if seg is None else jnp.asarray(seg), block_q=32)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("mode", ["causal", "segments"])
def test_flash_forward_matches_pallas_interpret(d, mode):
    """The forward's plain version at head_dim ``d`` (causal, or causal with
    segment ids) against the Pallas kernel in interpret mode, f32: 2e-5."""
    q, k, v, seg = make_qkv(d)
    seg = seg if mode == "segments" else None
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg, True))
    o, lse = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=True,
                                 segment_ids=None if seg is None else torch.from_numpy(seg))
    assert o.shape == q.shape and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    np.testing.assert_allclose(o.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_forward_bf16_matches_pallas_interpret(d):
    """The same in bf16 with segment ids: within 1e-2 (the JAX wrapper folds
    1/sqrt(d) into q in bf16, the port keeps it in f32 on the scores)."""
    q, k, v, seg = make_qkv(d, seed=1)
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash(jq, jk, jv, seg, True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in (jq, jk, jv))
    o, _ = flash_attention_fwd(tq, tk, tv, causal=True, segment_ids=torch.from_numpy(seg))
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), want, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("mode", ["causal", "segments"])
def test_flash_gradients_match_pallas_interpret(d, mode):
    """dq, dk and dv of sum(o^2) through the port's autograd Function (the
    plain backward on the CPU) against ``jax.grad`` of the Pallas kernel in
    interpret mode."""
    q, k, v, seg = make_qkv(d, b=1, seed=2)
    seg = seg if mode == "segments" else None

    def jloss(a, b, c):
        return jnp.sum(jnp.square(jax_flash(a, b, c, seg, True)))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    flash_attention(tq, tk, tv, causal=True, segment_ids=None if seg is None else torch.from_numpy(seg)) \
        .square().sum().backward()
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), err_msg=f"d{name}", **GRAD_TOL)


# --- #5-#7: the fused cross-entropy at any D --------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 72, 100, 576])  # tiny_test's; a multiple of 8 only; of none; SmolLM-135M's
@pytest.mark.parametrize("port", ["plain", "kernel_wrapper"])
def test_cross_entropy_at_any_d_matches_pallas_interpret(d, port):
    """Loss and gradients of the port's cross-entropy (plain, and the kernel
    wrapper's CPU path) against the JAX ``fused_cross_entropy_pallas`` in
    interpret mode at D not a multiple of 128, every 7th label ignored:
    loss 1e-5 relative, gradients rtol 1e-4, atol 1e-5."""
    rng = np.random.default_rng(d)
    n, v = 96, 300
    h = rng.standard_normal((n, d)).astype(np.float32)
    e = (rng.standard_normal((v, d)) * d**-0.5).astype(np.float32)
    y = rng.integers(0, v, n).astype(np.int32)
    y[::7] = -100
    with pltpu.force_tpu_interpret_mode():
        w_loss, (w_dh, w_de) = jax.value_and_grad(
            lambda a, b: fused_cross_entropy_pallas(a, b, jnp.asarray(y), 32, 128), argnums=(0, 1))(
            jnp.asarray(h), jnp.asarray(e))
    th, te = torch.from_numpy(h).requires_grad_(), torch.from_numpy(e).requires_grad_()
    fn = fused_cross_entropy if port == "plain" else fused_cross_entropy_kernel
    loss = fn(th, te, torch.from_numpy(y), 32)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(w_loss), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(w_dh), **CE_GRAD_TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(w_de), **CE_GRAD_TOL)


# --- #8/#9: the paged core at head_dims other than 64 and 128, and past 64 query rows ----------------------

def paged_setup(hd, hq, hkv, t_q, seed):
    """Pools, page table and in-flight rows of 4 slots (pages of 8, 6 a
    slot): history 5, 8 (a page boundary), 13 (a span that crosses a page)
    and an inactive slot; q for ``t_q`` tokens (1: #8)."""
    rng = np.random.default_rng(seed)
    slots, ps, max_pages, n_pages = 4, 8, 6, 48
    kp, vp = (rng.standard_normal((2 * n_pages + 1, ps, hkv * hd)).astype(np.float32) for _ in range(2))
    shape = (slots,) if t_q == 1 else (slots, t_q)
    q = rng.standard_normal((*shape, hq, hd)).astype(np.float32)
    k_new, v_new = (rng.standard_normal((*shape, hkv, hd)).astype(np.float32) for _ in range(2))
    logical = rng.choice(n_pages, (slots, max_pages), replace=False).astype(np.int32)  # no page in two slots
    hist = np.asarray([5, ps, 2 * ps - 3, 3 * ps], np.int32)
    active = np.asarray([True, True, True, False])
    return kp, vp, q, k_new, v_new, logical, hist, active, n_pages


# head_dims 16, 80, 96; 256 at Gemma 2B's 8 q / 1 kv heads; 36 and 20 (not multiples of 8); n_rep 64
@pytest.mark.parametrize("hd,hq,hkv", [(16, 4, 2), (80, 8, 2), (96, 8, 2), (16, 128, 2), (256, 8, 1), (36, 4, 2),
                                       (20, 4, 2)])
def test_fused_write_attend_matches_pallas_interpret(hd, hq, hkv):
    """#8's plain version against the Pallas kernel in interpret mode at
    head_dim 16, 80, 96, 256 (Gemma 2B's heads), 36 and 20, and at n_rep 64
    (Hq 128 / Hkv 2: 64 query rows of a kv head at T 1): attention within
    2e-5, pools bitwise equal except the trash row."""
    kp, vp, q, k_new, v_new, logical, hist, active, n_pages = paged_setup(hd, hq, hkv, 1, seed=hd + hq)
    ps = kp.shape[1]
    phys = (n_pages + logical).astype(np.int32)
    lens = np.where(active, hist + 1, 0).astype(np.int32)
    rows = np.where(active, n_pages + np.take_along_axis(logical, (hist // ps)[:, None], 1)[:, 0],
                    kp.shape[0] - 1).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want, kp_want, vp_want = paged_attention_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(phys), jnp.asarray(lens),
            k_new=jnp.asarray(k_new), v_new=jnp.asarray(v_new), write_rows=jnp.asarray(rows), interpret=True)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = paged_attention_fused(torch.from_numpy(q), tkp, tvp, torch.from_numpy(phys), torch.from_numpy(lens),
                                k_new=torch.from_numpy(k_new), v_new=torch.from_numpy(v_new),
                                write_rows=torch.from_numpy(rows))
    assert got.shape == (4, hq, hd)
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tkp.numpy()[:-1], np.asarray(kp_want)[:-1])
    np.testing.assert_array_equal(tvp.numpy()[:-1], np.asarray(vp_want)[:-1])


# (head_dim, Hq, Hkv, T): head_dims 16, 80, 96 at T 4; Hq 32 / Hkv 2 at T 8 (128 query rows of a kv head);
# 256 at Gemma 2B's 8 q / 1 kv heads at T 4 and 8; 36 and 20 (not multiples of 8)
@pytest.mark.parametrize("hd,hq,hkv,t_q", [(16, 4, 2, 4), (80, 8, 2, 4), (96, 8, 2, 4), (64, 32, 2, 8),
                                           (16, 32, 2, 8), (256, 8, 1, 4), (256, 8, 1, 8), (36, 4, 2, 4),
                                           (20, 4, 2, 8)])
def test_multi_fused_matches_pallas_multi_interpret(hd, hq, hkv, t_q):
    """#9's plain version against the Pallas multi-token kernel in interpret
    mode: attention within 2e-5 and pools bitwise equal except the trash row
    (the port takes one write row per token, the TPU kernel two aligned
    8-row windows)."""
    kp, vp, q, k_new, v_new, logical, hist, active, n_pages = paged_setup(hd, hq, hkv, t_q, seed=hd + hq + t_q)
    ps, max_pages = kp.shape[1], logical.shape[1]
    base, trash = n_pages, kp.shape[0] - 1
    phys = (base + logical).astype(np.int32)
    g1 = (hist // WRITE_WIN) * WRITE_WIN
    g2 = g1 + WRITE_WIN
    l1 = np.take_along_axis(logical, np.clip(g1 // ps, 0, max_pages - 1)[:, None], 1)[:, 0]
    l2 = np.take_along_axis(logical, np.clip(g2 // ps, 0, max_pages - 1)[:, None], 1)[:, 0]
    row1 = np.where(active, base + l1, trash).astype(np.int32)
    row2 = np.where(active & (g2 <= hist + t_q - 1), base + l2, trash).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want, kp_want, vp_want = paged_attention_pallas_multi(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(phys), jnp.asarray(hist),
            k_new=jnp.asarray(k_new), v_new=jnp.asarray(v_new), row_w1=jnp.asarray(row1), row_w2=jnp.asarray(row2),
            interpret=True)
    pos = hist[:, None] + np.arange(t_q)[None, :]
    write_rows = np.where(active[:, None], base + np.take_along_axis(logical, pos // ps, 1), trash).astype(np.int32)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = paged_attention_multi_fused(
        torch.from_numpy(q), tkp, tvp, torch.from_numpy(phys), torch.from_numpy(hist),
        k_new=torch.from_numpy(k_new), v_new=torch.from_numpy(v_new), write_rows=torch.from_numpy(write_rows))
    assert got.shape == (4, t_q, hq, hd)
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tkp.numpy()[:-1], np.asarray(kp_want)[:-1])
    np.testing.assert_array_equal(tvp.numpy()[:-1], np.asarray(vp_want)[:-1])


# --- the wrappers' CPU-side logic ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,instance", [(8, 64), (16, 64), (40, 64), (64, 64), (72, 128), (80, 128), (96, 128),
                                         (120, 128), (128, 128), (136, 256), (200, 256), (248, 256), (256, 256),
                                         (20, 64), (36, 64), (100, 128), (131, 256), (255, 256)])
def test_paged_instance_choice_and_box(hd, instance):
    """The paged core runs head_dims up to 64 on its hd-64 instance (128-key
    tiles), up to 128 on its hd-128 one and up to 256 on its hd-256 one
    (64-key tiles): the wrapper's TMA box (keys) never exceeds the
    instance's tile. A head_dim that is not a multiple of 8 reads its pools
    with plain loads in either dtype (no tensor map describes them), one that
    is reads them by TMA in bf16; f32 always takes the plain loads."""
    assert paged_cuda.instance_head_dim(hd) == instance
    assert paged_cuda.box_keys(128, hd) == (128 if instance == 64 else 64)
    assert paged_cuda.box_keys(24, hd) == 8 and paged_cuda.box_keys(48, hd) == 16
    assert paged_cuda.uses_tensor_maps(hd, torch.bfloat16) == (hd % 8 == 0)
    assert not paged_cuda.uses_tensor_maps(hd, torch.float32)


@pytest.mark.parametrize("hd", [264, 300, 512])
def test_kernel_wrappers_refuse_head_dims_above_256(hd):
    """A head_dim above 256 is refused by the kernels' checks, naming ROADMAP
    B1 (the flash kernels) and B2 (the paged core): still to port. The
    checks are those the CUDA paths make before a launch; here they run on
    CPU tensors, which the public wrappers hand to the plain versions."""
    q = torch.zeros((1, 4, 2, hd))
    with pytest.raises(ValueError, match=rf"head_dim <= 256, got {hd} \(ROADMAP.md B1"):
        flash_attention_module._check_kernel_operands(q, q, q)
    pool = torch.zeros((3, 8, 2 * hd))
    new = torch.zeros((1, 2, hd))
    with pytest.raises(ValueError, match=rf"head_dim <= 256, got {hd} \(ROADMAP.md B2"):
        paged_cuda._check_common(torch.zeros((1, 4, hd)), pool, pool.clone(), new, new, 4, hd, (1,))
    assert flash_attention_module.MAX_HEAD_DIM == paged_cuda.MAX_HEAD_DIM == 256


def test_paged_row_groups_and_tensor_map_key():
    """Query rows past 64 of a kv head take more blocks (row groups of 64);
    the pool's tensor map is keyed by its kv heads and head_dim, so a pool
    read at head_dim 80 (two kv heads of 80) never shares a map with the same
    bytes read as another layout."""
    assert [paged_cuda.row_groups(r) for r in (1, 3, 64, 65, 72, 128, 129, 1024)] == [1, 1, 1, 2, 2, 2, 3, 16]
    pool = torch.zeros((3, 8, 160), dtype=torch.bfloat16)
    assert paged_cuda.pool_map_key(pool, 80, 8) == (pool.data_ptr(), 24, 2, 80, 8)
    assert paged_cuda.pool_map_key(pool, 80, 8) != paged_cuda.pool_map_key(pool, 16, 8)
    assert paged_cuda.pool_map_key(pool, 16, 8)[2:4] == (10, 16)


def test_flash_pad_route_keeps_the_attention_of_the_real_head_dim():
    """A head_dim that is not a multiple of 8 runs on copies zero-padded to
    one (the kernels' rows are 16-byte strided), with the scale of the real
    head_dim: attention of the padded operands at scale 1/sqrt(d), sliced
    back, equals attention at d (the zero columns add nothing to a score, and
    P.V's padded columns are dropped). A multiple of 8 is not copied."""
    rng = np.random.default_rng(0)
    for d in (20, 100, 3):
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, h, d)).astype(np.float32)) for h in (4, 2, 2))
        pq, pk, pv = (pad_head_dim(x) for x in (q, k, v))
        dp = pq.shape[-1]
        assert dp % 8 == 0 and dp - d < 8 and not pq[..., d:].any()
        want, lse = flash_attention_reference(q, k, v)
        got, got_lse = flash_attention_reference(pq * (dp / d) ** 0.5, pk, pv)  # its 1/sqrt(dp) x sqrt(dp/d)
        np.testing.assert_allclose(got[..., :d].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_lse.numpy(), lse.numpy(), rtol=1e-5, atol=1e-6)
    x = torch.zeros((1, 2, 3, 80))
    assert pad_head_dim(x) is x


def test_cross_entropy_pad_route_keeps_the_loss():
    """A D that is not a multiple of 8 runs on zero-padded copies of h and E:
    the logsumexp over the padded operands is the unpadded one, bitwise (the
    zero columns add exact zeros); a D that is one is not copied."""
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((50, 100)).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((77, 100)).astype(np.float32))
    ph, pe = cross_entropy_cuda._padded(h), cross_entropy_cuda._padded(e)
    assert ph.shape == (50, 104) and pe.shape == (77, 104) and not ph[:, 100:].any() and not pe[:, 100:].any()
    torch.testing.assert_close(cross_entropy_lse(ph, pe), cross_entropy_lse(h, e), rtol=0, atol=0)
    x = torch.zeros((4, 64))
    assert cross_entropy_cuda._padded(x) is x


# --- the paged engine at tiny layouts with heads of 80, 256 and 36, against the JAX engine ------------------

MODEL_CONFIG = "tiny_hd80_shape"  # registered in both packages for the module's runs


def registered_models(name: str, embed_dim: int, heads: int, kv_heads: int, head_dim: int, seed: int):
    """tiny_test with ``heads`` q / ``kv_heads`` kv heads of ``head_dim``
    (D ``embed_dim``), registered as ``name`` in both registries until the
    generator is closed; yields the JAX weights and the port's copy of them."""
    jcfg = helpers.tiny_config()
    jcfg.embed_dim, jcfg.num_heads, jcfg.num_kv_heads, jcfg.intermediate_dim = embed_dim, heads, kv_heads, 256
    assert jcfg.head_dim == head_dim
    tcfg = tconfigs.ConfigLlama3_2(**{f.name: getattr(jcfg, f.name) for f in fields(tconfigs.ConfigLlama3_2)})
    mp = pytest.MonkeyPatch()
    mp.setitem(jconfigs.MODEL_CONFIGS, name, jcfg)
    mp.setitem(tconfigs.MODEL_CONFIGS, name, tcfg)
    jparams = init_params(jcfg, jax.random.key(seed), dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    yield jparams, tparams
    mp.undo()


@pytest.fixture(scope="module")
def hd80_models():
    """tiny_test with 4 q / 2 kv heads of 80 (D 320), registered as
    ``tiny_hd80_shape`` in both registries for the module; the JAX weights
    and the port's copy of them."""
    yield from registered_models(MODEL_CONFIG, 320, 4, 2, 80, seed=80)


@pytest.fixture(scope="module")
def hd256_models():
    """tiny_test with 2 q / 1 kv heads of 256 (D 512; one kv head, as Gemma
    2B), registered as ``tiny_hd256_shape``."""
    yield from registered_models("tiny_hd256_shape", 512, 2, 1, 256, seed=256)


@pytest.fixture(scope="module")
def hd36_models():
    """tiny_test with 4 q / 2 kv heads of 36 (D 144: a head_dim that is not a
    multiple of 8), registered as ``tiny_hd36_shape``."""
    yield from registered_models("tiny_hd36_shape", 144, 4, 2, 36, seed=36)


def engine_tokens_equal_jax(name: str, jparams, tparams, k: int) -> None:
    """Greedy tokens of the port's paged engine (plain attention on the CPU)
    equal the JAX engine's (gather attention, both at harvest depth 1) at the
    registered layout ``name``, with the same verify steps under speculation
    ``k``, and no page leaks."""
    jcfg, tcfg = jconfigs.get_model_config(name), tconfigs.get_model_config(name)
    assert jcfg.head_dim == tcfg.head_dim
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, int(n)).tolist() for n in (5, 11, 17, 3, 9, 14)]
    engine = make_engine(tparams, tcfg, speculate_k=k, pipeline_depth=1)
    outs = engine.generate_batch(prompts, SamplingParams(temperature=0.0, max_tokens=10))
    jeng = JPagedDecodeEngine(jparams, jcfg, pad_id=0, n_slots=4, page_size=8, prompt_bucket=8, max_context=64,
                              chunk=4, attn_impl="gather", pipeline_depth=1, speculate_k=k)
    jouts = jeng.generate_batch(prompts, JSamplingParams(temperature=0.0, max_tokens=10))
    for i, (out, jout) in enumerate(zip(outs, jouts)):
        assert out["token_ids"] == jout["token_ids"], (k, i)
        assert len(out["token_ids"]) == 10
        assert out["cumulative_logprob"] == pytest.approx(jout["cumulative_logprob"], abs=1e-3)
    if k:
        assert engine.last_stats["verify_steps"] == jeng.last_stats["verify_steps"] > 0
    assert no_leaks(engine)


@pytest.mark.parametrize("k", [0, 2])
def test_engine_greedy_tokens_equal_jax_at_head_dim_80(hd80_models, k):
    """:func:`engine_tokens_equal_jax` at head_dim 80 (phi-2's)."""
    assert tconfigs.get_model_config(MODEL_CONFIG).head_dim == 80
    engine_tokens_equal_jax(MODEL_CONFIG, *hd80_models, k)


@pytest.mark.parametrize("k", [0, 2])
def test_engine_greedy_tokens_equal_jax_at_head_dim_256(hd256_models, k):
    """:func:`engine_tokens_equal_jax` at heads of 256 (Gemma's), one kv head."""
    assert tconfigs.get_model_config("tiny_hd256_shape").head_dim == 256
    engine_tokens_equal_jax("tiny_hd256_shape", *hd256_models, k)


@pytest.mark.parametrize("k", [0, 2])
def test_engine_greedy_tokens_equal_jax_at_head_dim_36(hd36_models, k):
    """:func:`engine_tokens_equal_jax` at heads of 36 (not a multiple of 8)."""
    assert tconfigs.get_model_config("tiny_hd36_shape").head_dim == 36
    engine_tokens_equal_jax("tiny_hd36_shape", *hd36_models, k)
