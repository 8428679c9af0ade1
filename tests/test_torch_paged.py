"""The port's paged-cache functions against the JAX package on the tiny
config, f32 on the CPU: the fused single- and multi-token write+attend (the
CPU takes their plain versions) against the Pallas kernels in interpret mode,
the gather attentions, and whole decode / verify / prefill / suffix passes
against JAX's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ssi_tpu.generate import paged as jpaged
from ssi_tpu.generate.paged_pallas import WRITE_WIN, paged_attention_pallas, paged_attention_pallas_multi
from ssi_tpu.models.llama3 import init_params
from ssi_tpu_torch.generate import paged as tpaged
from ssi_tpu_torch.generate import paged_cuda
from ssi_tpu_torch.generate.paged_cuda import (
    paged_attention_fused,
    paged_attention_fused_reference,
    paged_attention_multi_fused,
    paged_attention_multi_fused_reference,
    split_plan,
)
from ssi_tpu_torch.models.llama3 import params_from_numpy
from tests import helpers

TOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    cfg = helpers.tiny_config()
    jparams = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    return cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


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
    tpools = tpaged.init_pools(cfg, n_pages, ps, dtype=torch.float32, device="cpu")
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
    pools = tpaged.init_pools(cfg, n_pages, ps, dtype=torch.float32, device="cpu")
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    out = tpaged.decode_step_tokens(
        tparams, torch.tensor([5], dtype=torch.int32), cfg, pools, table,
        torch.tensor([max_pages * ps], dtype=torch.int32), torch.tensor([False]), n_pages=n_pages,
    )
    assert torch.isfinite(out).all()


def _multi_inputs(cfg, seed=8):
    """The setup of tests/test_paged_decode.py::test_pallas_multi_kernel_parity_interpret:
    drafts spanning two 8-row windows, an aligned start, a page-crossing span
    and an inactive slot."""
    rng = np.random.default_rng(seed)
    slots, ps, max_pages, n_pages, t_q = 4, 8, 6, 48, 4
    shape = (cfg.num_layers * n_pages + 1, ps, cfg.num_kv_heads * cfg.head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal((slots, t_q, cfg.num_heads, cfg.head_dim)).astype(np.float32)
    k_new = rng.standard_normal((slots, t_q, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    v_new = rng.standard_normal((slots, t_q, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    logical = np.stack([rng.choice(n_pages, max_pages, replace=False) for _ in range(slots)]).astype(np.int32)
    hist = np.asarray([5, ps, 2 * ps - 3, 3 * ps], np.int32)
    active = np.asarray([True, True, True, False])
    return kp, vp, q, k_new, v_new, logical, hist, active, n_pages


def test_multi_fused_matches_pallas_multi_interpret(setup):
    """The port's #9 (its plain version on the CPU) against the Pallas kernel
    in interpret mode: attention within 2e-5, pools bitwise equal except the
    trash row (the port takes one write row per token, trash = skip, where
    the TPU kernel takes two aligned 8-row windows)."""
    cfg, _, _ = setup
    kp, vp, q, k_new, v_new, logical, hist, active, n_pages = _multi_inputs(cfg)
    slots, t_q = q.shape[:2]
    ps, max_pages = kp.shape[1], logical.shape[1]
    base, trash = n_pages, kp.shape[0] - 1  # layer-1 rows
    phys = (base + logical).astype(np.int32)
    cap = max_pages * ps  # ample: every token persists
    g1 = (hist // WRITE_WIN) * WRITE_WIN
    g2 = g1 + WRITE_WIN
    l1 = np.take_along_axis(logical, np.clip(g1 // ps, 0, max_pages - 1)[:, None], 1)[:, 0]
    l2 = np.take_along_axis(logical, np.clip(g2 // ps, 0, max_pages - 1)[:, None], 1)[:, 0]
    row1 = np.where(active & (hist < cap), base + l1, trash).astype(np.int32)
    row2 = np.where(active & (g2 < cap) & (g2 <= hist + t_q - 1), base + l2, trash).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want, kp_want, vp_want = paged_attention_pallas_multi(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(phys), jnp.asarray(hist),
            k_new=jnp.asarray(k_new), v_new=jnp.asarray(v_new), row_w1=jnp.asarray(row1), row_w2=jnp.asarray(row2),
            interpret=True,
        )
    pos = hist[:, None] + np.arange(t_q)[None, :]
    write_rows = np.where(active[:, None], base + np.take_along_axis(logical, pos // ps, 1), trash).astype(np.int32)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = paged_attention_multi_fused(
        torch.from_numpy(q), tkp, tvp, torch.from_numpy(phys), torch.from_numpy(hist),
        k_new=torch.from_numpy(k_new), v_new=torch.from_numpy(v_new), write_rows=torch.from_numpy(write_rows),
    )
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tkp.numpy()[:-1], np.asarray(kp_want)[:-1])
    np.testing.assert_array_equal(tvp.numpy()[:-1], np.asarray(vp_want)[:-1])


def test_paged_attention_multi_matches_jax(setup):
    cfg, _, _ = setup
    kp, vp, q, _, _, logical, hist, active, n_pages = _multi_inputs(cfg, seed=12)
    phys = (n_pages + logical).astype(np.int32)
    want = jpaged.paged_attention_multi(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(phys),
                                        jnp.asarray(hist + 1))
    got = tpaged.paged_attention_multi(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
                                       torch.from_numpy(phys), torch.from_numpy(hist + 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_multi_fused_reference_is_write_then_gather(setup):
    """On the CPU the wrapper takes its plain version; a trash write row is
    written there (the kernel skips it), so the pools agree except the trash row."""
    cfg, _, _ = setup
    kp, vp, q, k_new, v_new, logical, hist, active, n_pages = _multi_inputs(cfg, seed=14)
    t_q, ps, trash = q.shape[1], kp.shape[1], kp.shape[0] - 1
    pos = hist[:, None] + np.arange(t_q)[None, :]
    rows = np.where(active[:, None] & (pos < 15), n_pages + np.take_along_axis(logical, pos // ps, 1), trash)
    args = [torch.from_numpy(x) for x in (q, (n_pages + logical).astype(np.int32), hist)]
    kw = dict(k_new=torch.from_numpy(k_new), v_new=torch.from_numpy(v_new),
              write_rows=torch.from_numpy(rows.astype(np.int32)))
    a_k, a_v = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    a = paged_attention_multi_fused_reference(args[0], a_k, a_v, args[1], args[2], **kw)
    b_k, b_v = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    b = paged_attention_multi_fused(args[0], b_k, b_v, args[1], args[2], **kw)
    assert torch.equal(a, b) and torch.equal(a_k, b_k) and torch.equal(a_v, b_v)
    # a cap at position 15 sends slot 2's tokens 2-3 to the trash row, as it does the inactive slot's
    assert torch.equal(a_k[trash, 15 % ps], torch.from_numpy(k_new[2, 2].reshape(-1)))
    assert torch.equal(a_k[trash, (24 + 3) % ps], torch.from_numpy(k_new[3, 3].reshape(-1)))


@pytest.mark.parametrize("attn_impl", ["reference", "kernel"])
def test_decode_step_spec_matches_jax(setup, attn_impl):
    """decode_step_tokens_spec against the JAX gather pass after a batched
    prefill: f32 logits [slots, T, V] and pools except the trash row, with a
    cap that cuts one slot's span and an inactive slot. On the CPU
    attn_impl="kernel" runs the wrapper's plain version."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(17)
    ps, n_pages, bucket, t_q = 8, 24, 16, 4
    tokens = rng.integers(0, cfg.vocab_size, (3, bucket)).astype(np.int32)
    page_ids = np.asarray([[0, 1], [2, 3], [4, 5]], np.int32)
    jpools = jpaged.prefill_prompts(jparams, jnp.asarray(tokens), cfg,
                                    jpaged.init_pools(cfg, n_pages, ps, dtype=jnp.float32),
                                    jnp.asarray(page_ids), n_pages=n_pages, attn_impl="gather")
    tpools = tpaged.init_pools(cfg, n_pages, ps, dtype=torch.float32, device="cpu")
    tpaged.prefill_prompts(tparams, torch.from_numpy(tokens), cfg, tpools, torch.from_numpy(page_ids),
                           n_pages=n_pages, attn_impl=attn_impl)
    table = np.asarray([[0, 1, 6, 7], [2, 3, 8, 9], [4, 5, 10, 11]], np.int32)
    seq_lens = np.asarray([14, 7, 9], np.int32)
    active = np.asarray([True, True, False])
    cap = np.asarray([32, 9, 32], np.int32)  # slot 1: positions 9 and 10 go to the trash row
    draft = rng.integers(0, cfg.vocab_size, (3, t_q)).astype(np.int32)
    jlogits, jpools = jpaged.decode_step_tokens_spec(
        jparams, jnp.asarray(draft), cfg, jpools, jnp.asarray(table), jnp.asarray(seq_lens), jnp.asarray(active),
        jnp.asarray(cap), n_pages=n_pages, attn_impl="gather",
    )
    tlogits = tpaged.decode_step_tokens_spec(
        tparams, torch.from_numpy(draft), cfg, tpools, torch.from_numpy(table), torch.from_numpy(seq_lens),
        torch.from_numpy(active), torch.from_numpy(cap), n_pages=n_pages, attn_impl=attn_impl,
    )
    assert tlogits.dtype == torch.float32 and tlogits.shape == (3, t_q, cfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy()[active], np.asarray(jlogits)[active], rtol=0, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpools[name].numpy()[:-1], np.asarray(jpools[name])[:-1], rtol=TOL, atol=TOL)


def test_prefill_suffix_and_history_match_jax(setup):
    """prefill_prompts with the n-gram history, then prefill_suffix over a
    cached prefix (the history gets the FULL prompt), against JAX's passes:
    pools except the trash row, and the history buffer exactly."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(19)
    ps, n_pages, n_slots, w = 8, 24, 3, 48
    prompt = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    jhist = jnp.zeros((n_slots + 1, w + 1), jnp.int32)
    thist = torch.zeros((n_slots + 1, w + 1), dtype=torch.int32)
    jpools, jhist = jpaged.prefill_prompts(
        jparams, jnp.asarray(prompt[None]), cfg, jpaged.init_pools(cfg, n_pages, ps, dtype=jnp.float32),
        jnp.asarray([[0, 1]], np.int32), n_pages=n_pages, attn_impl="gather", hist=jhist,
        slot_ids=jnp.asarray([0], np.int32),
    )
    tpools = tpaged.init_pools(cfg, n_pages, ps, dtype=torch.float32, device="cpu")
    tpaged.prefill_prompts(tparams, torch.from_numpy(prompt[None]), cfg, tpools, torch.tensor([[0, 1]], dtype=torch.int32),
                           n_pages=n_pages, hist=thist, slot_ids=torch.tensor([0], dtype=torch.int32))
    # two rows extend the cached first page; row 1 also reads row 0's fresh second page
    full = [np.concatenate([prompt[:8], rng.integers(0, cfg.vocab_size, 13)]),
            np.concatenate([prompt[:8], rng.integers(0, cfg.vocab_size, 6)])]
    s_bucket, trash = 16, n_pages
    tokens = np.zeros((2, s_bucket), np.int32)
    for r, f in enumerate(full):
        tokens[r, : len(f) - 8] = f[8:]
    start = np.asarray([8, 8], np.int32)
    table = np.asarray([[0, 5, 6, trash, trash, trash], [0, 7, 8, trash, trash, trash]], np.int32)
    new_ids = np.asarray([[5, 6], [7, 8]], np.int32)
    full_tokens = np.zeros((2, 24), np.int32)
    for r, f in enumerate(full):
        full_tokens[r, : len(f)] = f
    slot_ids = np.asarray([1, n_slots], np.int32)  # row 1 is a pad row: the trash history row
    jpools, jhist = jpaged.prefill_suffix(
        jparams, jnp.asarray(tokens), jnp.asarray(start), cfg, jpools, jnp.asarray(table), jnp.asarray(new_ids),
        n_pages=n_pages, hist=jhist, full_tokens=jnp.asarray(full_tokens), slot_ids=jnp.asarray(slot_ids),
    )
    tpaged.prefill_suffix(
        tparams, torch.from_numpy(tokens), torch.from_numpy(start), cfg, tpools, torch.from_numpy(table),
        torch.from_numpy(new_ids), n_pages=n_pages, hist=thist, full_tokens=torch.from_numpy(full_tokens),
        slot_ids=torch.from_numpy(slot_ids),
    )
    for name in ("k", "v"):
        np.testing.assert_allclose(tpools[name].numpy()[:-1], np.asarray(jpools[name])[:-1], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))


@pytest.mark.parametrize("ps", [8, 16, 48, 128])
def test_split_plan_covers_the_table_with_bounded_splits(ps):
    """The CUDA core's split plan (the kernels themselves run only on the
    card): the splits cover the page table exactly, each walks whole pages of
    at least SPLIT_KEYS keys, and there are never more than MAX_SPLITS, so the
    merge's scratch stays bounded however long the context."""
    for max_pages in range(1, 600):
        per_split, n_splits = split_plan(max_pages, ps)
        assert 1 <= n_splits <= paged_cuda.MAX_SPLITS
        assert (n_splits - 1) * per_split < max_pages <= n_splits * per_split
        assert per_split * ps >= paged_cuda.SPLIT_KEYS
    assert split_plan(10, 128) == (2, 5)  # the 1B serving shape: 5 splits of 256 keys
    assert split_plan(128, 128) == (8, 16)  # context 16,384: 16 splits of 1,024 keys
