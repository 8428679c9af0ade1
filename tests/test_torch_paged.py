"""The port's paged-cache functions against the JAX package on the tiny
config, f32 on the CPU: the fused write+attend (the CPU takes its plain
version) against the Pallas kernel in interpret mode, the gather attention,
and whole decode / prefill passes against JAX's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ssi_tpu.generate import paged as jpaged
from ssi_tpu.generate.paged_pallas import paged_attention_pallas
from ssi_tpu.models.llama3 import init_params
from ssi_tpu_torch.generate import paged as tpaged
from ssi_tpu_torch.generate.paged_cuda import paged_attention_fused, paged_attention_fused_reference
from ssi_tpu_torch.models.llama3 import params_from_numpy
from tests import helpers

TOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    cfg = helpers.tiny_config()
    jparams = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    return cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _fused_inputs(cfg, seed=3):
    """The setup of tests/test_paged_decode.py::test_pallas_kernel_parity_interpret."""
    rng = np.random.default_rng(seed)
    slots, ps, max_pages, n_pages = 4, 8, 4, 32
    shape = (cfg.num_layers * n_pages + 1, ps, cfg.num_kv_heads * cfg.head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal((slots, cfg.num_heads, cfg.head_dim)).astype(np.float32)
    k_new = rng.standard_normal((slots, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    v_new = rng.standard_normal((slots, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    logical = rng.choice(n_pages, (slots, max_pages), replace=False).astype(np.int32)
    phys = (1 * n_pages + logical).astype(np.int32)
    attn_lens = np.asarray([1, ps, 2 * ps - 3, 0], np.int32)  # incl. new token; slot 3 inactive
    active = attn_lens > 0
    pre = np.maximum(attn_lens - 1, 0)
    logical_ids = np.take_along_axis(logical, (pre // ps)[:, None], axis=1)[:, 0]
    write_rows = np.where(active, n_pages + logical_ids, kp.shape[0] - 1).astype(np.int32)
    return kp, vp, q, k_new, v_new, phys, attn_lens, write_rows, active


def test_fused_write_attend_matches_pallas_interpret(setup):
    cfg, _, _ = setup
    kp, vp, q, k_new, v_new, phys, attn_lens, write_rows, active = _fused_inputs(cfg)
    with pltpu.force_tpu_interpret_mode():
        want, kp_want, vp_want = paged_attention_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(phys), jnp.asarray(attn_lens),
            k_new=jnp.asarray(k_new), v_new=jnp.asarray(v_new), write_rows=jnp.asarray(write_rows), interpret=True,
        )
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = paged_attention_fused(
        torch.from_numpy(q), tkp, tvp, torch.from_numpy(phys), torch.from_numpy(attn_lens),
        k_new=torch.from_numpy(k_new), v_new=torch.from_numpy(v_new), write_rows=torch.from_numpy(write_rows),
    )
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active], rtol=TOL, atol=TOL)
    # pools updated in place, bitwise equal to the kernel's except the trash row
    np.testing.assert_array_equal(tkp.numpy()[:-1], np.asarray(kp_want)[:-1])
    np.testing.assert_array_equal(tvp.numpy()[:-1], np.asarray(vp_want)[:-1])
    # floor modulo: the inactive slot (seq_len 0) wrote offset ps-1 of the trash row
    np.testing.assert_array_equal(tkp.numpy()[-1, -1], k_new[3].reshape(-1))


def test_gather_attention_and_token_write_match_jax(setup):
    cfg, _, _ = setup
    kp, vp, q, k_new, _, phys, attn_lens, write_rows, active = _fused_inputs(cfg, seed=5)
    n_pages = 32
    ids = write_rows - n_pages
    offs = (np.maximum(attn_lens - 1, 0) % kp.shape[1]).astype(np.int32)
    jk = jpaged.write_token_kv(jnp.asarray(kp), jnp.asarray(k_new), jnp.asarray(n_pages + ids),
                               jnp.asarray(offs), jnp.asarray(active))
    tk = torch.from_numpy(kp.copy())
    tpaged.write_token_kv(tk, torch.from_numpy(k_new), torch.from_numpy(n_pages + ids),
                          torch.from_numpy(offs), torch.from_numpy(active))
    np.testing.assert_array_equal(tk.numpy()[:-1], np.asarray(jk)[:-1])
    want = jpaged.paged_attention(jnp.asarray(q), jk, jnp.asarray(vp), jnp.asarray(phys), jnp.asarray(attn_lens))
    got = tpaged.paged_attention(torch.from_numpy(q), tk, torch.from_numpy(vp), torch.from_numpy(phys),
                                 torch.from_numpy(attn_lens))
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active], rtol=TOL, atol=TOL)


def test_fused_reference_is_write_then_gather(setup):
    cfg, _, _ = setup
    kp, vp, q, k_new, v_new, phys, attn_lens, write_rows, active = _fused_inputs(cfg, seed=9)
    args = [torch.from_numpy(x) for x in (q, phys, attn_lens)]
    kw = dict(k_new=torch.from_numpy(k_new), v_new=torch.from_numpy(v_new), write_rows=torch.from_numpy(write_rows))
    a_k, a_v = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    a = paged_attention_fused_reference(args[0], a_k, a_v, args[1], args[2], **kw)
    b_k, b_v = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    b = paged_attention_fused(args[0], b_k, b_v, args[1], args[2], **kw)  # CPU: the same plain path
    assert torch.equal(a, b) and torch.equal(a_k, b_k) and torch.equal(a_v, b_v)


@pytest.mark.parametrize("attn_impl", ["reference", "kernel"])
def test_prefill_then_decode_step_match_jax(setup, attn_impl):
    """prefill_prompts then decode_step_tokens over the flat pool equal the
    JAX gather passes: pools (except the trash row) and f32 logits. On the CPU
    attn_impl="kernel" runs the wrappers' plain versions."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(11)
    ps, n_pages, bucket, max_pages = 8, 16, 16, 4
    tokens = rng.integers(0, cfg.vocab_size, (2, bucket)).astype(np.int32)
    page_ids = np.asarray([[0, 1], [2, n_pages]], np.int32)  # row 1's second page -> trash
    jpools = jpaged.prefill_prompts(jparams, jnp.asarray(tokens), cfg,
                                    jpaged.init_pools(cfg, n_pages, ps, dtype=jnp.float32),
                                    jnp.asarray(page_ids), n_pages=n_pages, attn_impl="gather")
    tpools = tpaged.init_pools(cfg, n_pages, ps, dtype=torch.float32)
    tpaged.prefill_prompts(tparams, torch.from_numpy(tokens), cfg, tpools, torch.from_numpy(page_ids),
                           n_pages=n_pages, attn_impl=attn_impl)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpools[name].numpy()[:-1], np.asarray(jpools[name])[:-1], rtol=TOL, atol=TOL)

    table = np.asarray([[0, 1, 5, 6], [2, 7, 8, 9], [10, 11, 12, 13]], np.int32)
    seq_lens = np.asarray([13, 7, 0], np.int32)  # 3rd slot inactive
    active = np.asarray([True, True, False])
    step_tok = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
    jlogits, jpools = jpaged.decode_step_tokens(
        jparams, jnp.asarray(step_tok), cfg, jpools, jnp.asarray(table), jnp.asarray(seq_lens),
        jnp.asarray(active), n_pages=n_pages, attn_impl="gather",
    )
    tlogits = tpaged.decode_step_tokens(
        tparams, torch.from_numpy(step_tok), cfg, tpools, torch.from_numpy(table), torch.from_numpy(seq_lens),
        torch.from_numpy(active), n_pages=n_pages, attn_impl=attn_impl,
    )
    assert tlogits.dtype == torch.float32 and tlogits.shape == (3, cfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy()[:2], np.asarray(jlogits)[:2], rtol=0, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpools[name].numpy()[:-1], np.asarray(jpools[name])[:-1], rtol=TOL, atol=TOL)


def test_decode_step_clamps_full_context_page_index(setup):
    """A slot whose seq_len sits at full context would index one past the
    page table; JAX clamps that gather, the port clamps it explicitly."""
    cfg, _, tparams = setup
    ps, n_pages, max_pages = 8, 8, 2
    pools = tpaged.init_pools(cfg, n_pages, ps, dtype=torch.float32)
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    out = tpaged.decode_step_tokens(
        tparams, torch.tensor([5], dtype=torch.int32), cfg, pools, table,
        torch.tensor([max_pages * ps], dtype=torch.int32), torch.tensor([False]), n_pages=n_pages,
    )
    assert torch.isfinite(out).all()
