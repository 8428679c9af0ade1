"""Block-paged KV cache and the model passes over it — port of
``ssi_tpu/generate/paged.py``: single-token decode, the speculative verify
step over T candidate tokens, batched prompt prefill, and the suffix prefill
behind the prefix cache and chunked prefill.

Layout kept from the JAX package: ONE flat pool per K and V,
``[L*n_pages + 1, ps, Hkv*hd]``; logical page ``p`` of layer ``l`` is physical
row ``l*n_pages + p``; the LAST row is the trash page that absorbs writes
which must happen shape-wise but carry no information (inactive slots,
prefill padding). The pools are updated IN PLACE (torch tensors are mutable;
the JAX code threads them through the scan carry and relies on donation).

Every index that JAX would clamp or drop out of range is clamped or pointed
at the trash row explicitly here: torch raises on the CPU and faults on CUDA.

Tensor parallelism (``tp``, a ``parallel.TensorParallel``): each pass runs on
a rank's slice of the weights and its pools hold the rank's kv heads; the
head counts come from the widths of the weights and pools, so the kernels
see the local heads (n_rep unchanged), and ``block``, ``embed_tokens`` and
``logits`` join the tp group's collectives. ``tp=None`` is the one-device path.
"""

from __future__ import annotations

from typing import Any

import torch

from ssi_tpu_torch.models.configs import ConfigLlama3_2
from ssi_tpu_torch.models.llama3 import block, embed_tokens, layer_params, logits, rms_norm, rope_for_positions
from ssi_tpu_torch.ops.attention import reference_attention

NEG_INF = -1.0e30


def init_pools(
    cfg: ConfigLlama3_2, n_pages: int, page_size: int, dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda", kv_heads: int | None = None,
) -> dict[str, torch.Tensor]:
    """Flat paged K/V pools ``[L*n_pages + 1, ps, Hkv*hd]`` (+1 = trash page);
    ``kv_heads`` (default ``cfg.num_kv_heads``) the heads a rank holds."""
    shape = (cfg.num_layers * n_pages + 1, page_size, (kv_heads or cfg.num_kv_heads) * cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def copy_pages(pools: dict[str, torch.Tensor], src: torch.Tensor, dst: torch.Tensor, *, n_pages: int) -> None:
    """Copy logical pages ``src[i]`` to ``dst[i]`` in every layer of both
    pools, in place: the n>1 boundary-page copy (port of the JAX engine's
    ``_copy_pages_fn``, an XLA gather and scatter). Ids >= ``n_pages`` are pad
    rows: both ends point at the trash row."""
    n_layers = (pools["k"].shape[0] - 1) // n_pages
    trash = n_layers * n_pages
    offs = torch.arange(n_layers, dtype=torch.int64, device=src.device)[:, None] * n_pages

    def rows(ids: torch.Tensor) -> torch.Tensor:
        ids = ids.to(torch.int64)[None, :]
        return torch.where(ids >= n_pages, torch.full_like(offs + ids, trash), offs + ids).reshape(-1)

    s, d = rows(src), rows(dst)
    for pool in pools.values():
        pool[d] = pool[s]


def write_token_kv(pool: torch.Tensor, kv: torch.Tensor, phys_ids: torch.Tensor,
                   offsets: torch.Tensor, active: torch.Tensor) -> None:
    """Write one new token's K or V per slot into its page, in place.

    kv ``[slots, Hkv, hd]``; phys_ids/offsets ``[slots]``; inactive slots are
    redirected to the trash page."""
    trash = pool.shape[0] - 1
    rows = torch.where(active, phys_ids, torch.full_like(phys_ids, trash)).long()
    pool[rows, offsets.long()] = kv.to(pool.dtype).reshape(kv.shape[0], -1)


def gather_pages(pool: torch.Tensor, phys_table: torch.Tensor, hkv: int) -> torch.Tensor:
    """Dense view of one layer's pages: ``[slots, max_pages*ps, Hkv, hd]``."""
    n_slots, max_pages = phys_table.shape
    g = pool[phys_table.long()]
    return g.reshape(n_slots, max_pages * pool.shape[1], hkv, pool.shape[2] // hkv)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    phys_table: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    """Single-token GQA over the flat pool by gathering pages (the plain path).

    q ``[slots, Hq, hd]`` (post-RoPE); phys_table ``[slots, max_pages]``
    PHYSICAL rows; seq_lens ``[slots]`` valid entries INCLUDING the current
    token (already written). Math in f32; returns ``[slots, Hq, hd]`` in the
    pool's dtype."""
    n_slots, hq, hd = q.shape
    hkv = k_pool.shape[2] // hd
    n_rep = hq // hkv
    k = gather_pages(k_pool, phys_table, hkv)
    v = gather_pages(v_pool, phys_table, hkv)
    m = k.shape[1]
    qg = q.float().view(n_slots, hkv, n_rep, hd)
    scores = torch.einsum("bkgd,bmkd->bkgm", qg, k.float()) * (1.0 / hd**0.5)
    valid = torch.arange(m, device=q.device)[None, :] < seq_lens[:, None]
    scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgm,bmkd->bkgd", probs, v.float())
    return out.reshape(n_slots, hq, hd).to(v_pool.dtype)


def paged_attention_multi(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                          phys_table: torch.Tensor, base_lens: torch.Tensor) -> torch.Tensor:
    """Multi-token GQA over the flat pool by gathering pages (the plain path of
    the speculative verify and the suffix prefill).

    q ``[slots, T, Hq, hd]`` (post-RoPE), token j at position
    ``base_lens - 1 + j``, all T already written; base_lens ``[slots]`` valid
    entries INCLUDING token 0, so token j attends ``base_lens + j`` entries.
    Math in f32; returns ``[slots, T, Hq, hd]`` in the pool's dtype."""
    n_slots, t_q, hq, hd = q.shape
    hkv = k_pool.shape[2] // hd
    n_rep = hq // hkv
    k = gather_pages(k_pool, phys_table, hkv)
    v = gather_pages(v_pool, phys_table, hkv)
    m = k.shape[1]
    qg = q.float().view(n_slots, t_q, hkv, n_rep, hd)
    scores = torch.einsum("btkgd,bmkd->bkgtm", qg, k.float()) * (1.0 / hd**0.5)
    lens = base_lens[:, None] + torch.arange(t_q, device=q.device)[None, :]  # [slots, T]
    valid = torch.arange(m, device=q.device)[None, None, :] < lens[:, :, None]
    scores = torch.where(valid[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgtm,bmkd->btkgd", probs, v.float())
    return out.reshape(n_slots, t_q, hq, hd).to(v_pool.dtype)


def _layer_scan(params, cfg: ConfigLlama3_2, h, cos, sin, attend, tp=None) -> torch.Tensor:
    """The per-layer scaffold every paged pass shares (the JAX ``lax.scan``
    becomes a loop over the layer index into the stacked weights).

    ``attend(q, k, v, l)`` writes layer ``l``'s K/V into the pools however
    the pass requires and returns ``[B, T, Hq, hd]``. Returns ``h`` (not
    final-normed)."""
    for l in range(cfg.num_layers):
        h = block(h, layer_params(params, l), cos, sin, cfg, lambda q, k, v, l=l: attend(q, k, v, l), tp=tp)
    return h


def decode_step_tokens(
    params: Any,
    tokens: torch.Tensor,
    cfg: ConfigLlama3_2,
    pools: dict[str, torch.Tensor],
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    active: torch.Tensor,
    *,
    n_pages: int,
    attn_impl: str = "reference",
    tp: Any = None,
) -> torch.Tensor:
    """Advance every active slot by ONE token over the flat paged cache.

    tokens ``[slots]``; seq_lens ``[slots]`` valid cache length BEFORE this
    token; page_table ``[slots, max_pages]`` LOGICAL page ids. Writes the new
    K/V at position ``seq_lens`` (pools updated in place), attends over
    ``seq_lens + 1`` entries, returns f32 logits ``[slots, V]``.

    ``attn_impl``: "kernel" (the fused write+attend wrapper: the CUDA kernel
    on a CUDA device) or "reference" (``write_token_kv`` + gather attention).
    """
    kp, vp = pools["k"], pools["v"]
    ps = kp.shape[1]
    max_pages = page_table.shape[1]
    trash = kp.shape[0] - 1
    cos, sin = rope_for_positions(seq_lens[:, None], cfg)  # [slots, 1, hd]

    # JAX clamps this gather; a slot at full context would index one past the table
    page_idx = torch.clamp(seq_lens // ps, max=max_pages - 1)
    logical_ids = torch.gather(page_table, 1, page_idx[:, None].long())[:, 0]
    offsets = torch.remainder(seq_lens, ps)
    # inactive slots attend over nothing (their outputs are discarded upstream)
    attn_lens = torch.where(active, seq_lens + 1, torch.zeros_like(seq_lens))
    h = embed_tokens(params, tokens, tp)[:, None, :]

    if attn_impl == "kernel":
        from ssi_tpu_torch.generate.paged_cuda import paged_attention_fused
    elif attn_impl != "reference":
        raise ValueError(f"Unknown attn_impl {attn_impl!r}; expected 'kernel' or 'reference'")

    def attend(q, k, v, l):
        base = l * n_pages
        phys_table = base + page_table
        q, k, v = q[:, 0], k[:, 0], v[:, 0]
        if attn_impl == "kernel":
            write_rows = torch.where(active, base + logical_ids, torch.full_like(logical_ids, trash))
            attn = paged_attention_fused(q, kp, vp, phys_table, attn_lens, k_new=k, v_new=v, write_rows=write_rows)
        else:
            write_token_kv(kp, k, base + logical_ids, offsets, active)
            write_token_kv(vp, v, base + logical_ids, offsets, active)
            attn = paged_attention(q, kp, vp, phys_table, attn_lens)
        return attn[:, None]

    h = _layer_scan(params, cfg, h, cos, sin, attend, tp)
    return logits(params, rms_norm(h[:, 0], params["final_norm"], cfg.norm_eps), tp)


def decode_step_tokens_spec(
    params: Any,
    tokens: torch.Tensor,
    cfg: ConfigLlama3_2,
    pools: dict[str, torch.Tensor],
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    active: torch.Tensor,
    cap_lens: torch.Tensor,
    *,
    n_pages: int,
    attn_impl: str = "reference",
    tp: Any = None,
) -> torch.Tensor:
    """Speculative verify step: advance every active slot by T candidate
    tokens in ONE forward (one weights read for T tokens).

    tokens ``[slots, T]`` (column 0 the slot's true next input, columns 1..
    T-1 draft candidates); seq_lens ``[slots]`` valid cache length BEFORE the
    step (token j sits at ``seq_lens + j``); cap_lens ``[slots]`` hard write
    bound: positions at or beyond it, and every position of an inactive slot,
    go to the trash row. K/V of all T tokens are written in place (rejected
    candidates leave entries the advancing seq_lens masks and later tokens
    overwrite). Returns f32 logits ``[slots, T, V]``.

    ``attn_impl``: "kernel" (the fused multi-token wrapper: the CUDA kernel
    #9 on a CUDA device) or "reference" (per-token scatter + gather
    attention, the JAX XLA path).
    """
    kp, vp = pools["k"], pools["v"]
    ps = kp.shape[1]
    n_slots, t_q = tokens.shape
    max_pages = page_table.shape[1]
    trash = kp.shape[0] - 1
    positions = seq_lens[:, None] + torch.arange(t_q, dtype=seq_lens.dtype, device=seq_lens.device)[None, :]
    cos, sin = rope_for_positions(positions, cfg)  # [slots, T, hd]
    page_idx = torch.clamp(positions // ps, 0, max_pages - 1)
    logical_ids = torch.gather(page_table, 1, page_idx.long())  # [slots, T]
    write_ok = active[:, None] & (positions < cap_lens[:, None])
    # inactive slots attend over their in-flight block only (outputs discarded)
    hist_lens = torch.where(active, seq_lens, torch.zeros_like(seq_lens))
    h = embed_tokens(params, tokens, tp)

    if attn_impl == "kernel":
        from ssi_tpu_torch.generate.paged_cuda import paged_attention_multi_fused as fused
    elif attn_impl == "reference":
        from ssi_tpu_torch.generate.paged_cuda import paged_attention_multi_fused_reference as fused
    else:
        raise ValueError(f"Unknown attn_impl {attn_impl!r}; expected 'kernel' or 'reference'")

    def attend(q, k, v, l):
        base = l * n_pages
        write_rows = torch.where(write_ok, base + logical_ids, torch.full_like(logical_ids, trash))
        return fused(q, kp, vp, base + page_table, hist_lens, k_new=k, v_new=v, write_rows=write_rows)

    h = _layer_scan(params, cfg, h, cos, sin, attend, tp)
    return logits(params, rms_norm(h, params["final_norm"], cfg.norm_eps), tp)


def prefill_prompts(
    params: Any,
    tokens: torch.Tensor,
    cfg: ConfigLlama3_2,
    pools: dict[str, torch.Tensor],
    page_ids: torch.Tensor,
    *,
    n_pages: int,
    attn_impl: str = "reference",
    hist: torch.Tensor | None = None,
    slot_ids: torch.Tensor | None = None,
    tp: Any = None,
) -> None:
    """Prefill a BATCH of right-padded prompts ``[B, P]`` into their pages
    (K/V write only, in place; no logits).

    page_ids ``[B, P // ps]`` LOGICAL pages receiving each prompt's K/V; ids
    ``>= n_pages`` (pad rows, pages beyond a row's own bucket) go to the trash
    row. The caller seeds decode at ``len - 1``, so the first decode step
    recomputes the last prompt position and samples the first output.

    With ``hist`` ``[n_slots+1, W+1]`` and ``slot_ids`` ``[B]`` (speculative
    decoding) each row's tokens are also recorded, in place, into the n-gram
    history row ``slot_ids[r]`` (pad rows name the trash row ``n_slots``).

    ``attn_impl``: "kernel" (the flash-attention wrapper: the CUDA kernel on
    a CUDA device) or "reference" (plain causal attention,
    ``ops/attention.py``, which stands in for the JAX ``prefill_attention``).
    """
    b, p = tokens.shape
    kp, vp = pools["k"], pools["v"]
    ps = kp.shape[1]
    if p % ps != 0:
        raise ValueError(f"prompt bucket {p} must be a multiple of page_size {ps}")
    kvd = kp.shape[2]
    trash = kp.shape[0] - 1
    positions = torch.arange(p, dtype=torch.int32, device=tokens.device)[None, :]
    cos, sin = rope_for_positions(positions, cfg)
    h = embed_tokens(params, tokens, tp)

    if attn_impl == "kernel":
        from ssi_tpu_torch.ops.flash_attention import flash_attention

        def attn_fn(q, k, v):
            return flash_attention(q, k, v, causal=True)
    elif attn_impl == "reference":

        def attn_fn(q, k, v):
            return reference_attention(q, k, v, causal=True)
    else:
        raise ValueError(f"Unknown attn_impl {attn_impl!r}; expected 'kernel' or 'reference'")

    def attend(q, k, v, l):
        # duplicate trash indices race on CUDA; only the trash row sees it
        phys = torch.where(page_ids >= n_pages, torch.full_like(page_ids, trash), l * n_pages + page_ids)
        phys = phys.reshape(-1).long()
        kp[phys] = k.to(kp.dtype).reshape(b * p // ps, ps, kvd)
        vp[phys] = v.to(vp.dtype).reshape(b * p // ps, ps, kvd)
        return attn_fn(q, k, v)

    _layer_scan(params, cfg, h, cos, sin, attend, tp)
    if hist is not None:
        hist[slot_ids.long(), :p] = tokens.to(hist.dtype)


def prefill_suffix(
    params: Any,
    tokens: torch.Tensor,
    start: torch.Tensor,
    cfg: ConfigLlama3_2,
    pools: dict[str, torch.Tensor],
    page_table: torch.Tensor,
    page_ids_new: torch.Tensor,
    *,
    n_pages: int,
    hist: torch.Tensor | None = None,
    full_tokens: torch.Tensor | None = None,
    slot_ids: torch.Tensor | None = None,
    tp: Any = None,
) -> None:
    """Prefill the UNCACHED TAIL of prompts whose prefix pages came from the
    prefix cache, or one piece of a chunked prefill (K/V write only, in place).

    tokens ``[B, S]`` at absolute positions ``start .. start+S-1``, right-padded
    (S a multiple of the page size); start ``[B]`` page-aligned; page_table
    ``[B, max_pages]`` LOGICAL pages covering the prefix and the row's own
    suffix pages (ids ``>= n_pages`` beyond them); page_ids_new ``[B, S // ps]``
    the pages receiving the suffix K/V. Per layer EVERY row's suffix K/V is
    written first, then each row attends over its gathered pages (cached
    history and in-suffix predecessors in one softmax), so a row may read
    prefix pages an earlier row of the same call writes. Plain PyTorch on
    every device: the JAX pass uses the XLA gather attention here too.

    With ``hist``/``full_tokens [B, F]``/``slot_ids`` the FULL prompt is
    recorded into the n-gram history rows (speculative decoding).
    """
    b, s_len = tokens.shape
    kp, vp = pools["k"], pools["v"]
    ps = kp.shape[1]
    if s_len % ps != 0:
        raise ValueError(f"suffix bucket {s_len} must be a multiple of page_size {ps}")
    kvd = kp.shape[2]
    trash = kp.shape[0] - 1
    positions = start[:, None] + torch.arange(s_len, dtype=start.dtype, device=start.device)[None, :]
    cos, sin = rope_for_positions(positions, cfg)
    h = embed_tokens(params, tokens, tp)
    base_lens = start + 1  # suffix token 0 attends the cached history and itself

    def attend(q, k, v, l):
        phys_new = torch.where(page_ids_new >= n_pages, torch.full_like(page_ids_new, trash), l * n_pages + page_ids_new)
        phys_new = phys_new.reshape(-1).long()
        kp[phys_new] = k.to(kp.dtype).reshape(b * s_len // ps, ps, kvd)
        vp[phys_new] = v.to(vp.dtype).reshape(b * s_len // ps, ps, kvd)
        phys_table = torch.where(page_table >= n_pages, torch.full_like(page_table, trash), l * n_pages + page_table)
        return paged_attention_multi(q, kp, vp, phys_table, base_lens)

    _layer_scan(params, cfg, h, cos, sin, attend, tp)
    if hist is not None:
        hist[slot_ids.long(), : full_tokens.shape[1]] = full_tokens.to(hist.dtype)
