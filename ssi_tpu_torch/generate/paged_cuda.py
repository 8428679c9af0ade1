"""Fused paged attention over the flat KV pool: the CUDA kernels and their
plain PyTorch versions. Both wrappers launch one split-context core
(``csrc/paged_attention.cu``):

- :func:`paged_attention_fused`: token write + single-token GQA, port of
  ``ssi_tpu/generate/paged_pallas.py`` ``paged_attention_pallas`` (#8);
- :func:`paged_attention_multi_fused`: the T-token write + verify GQA of
  speculative decoding, port of ``paged_attention_pallas_multi`` (#9). The
  TPU kernel persists the T tokens through two aligned 8-row
  read-modify-write windows (a TPU DMA alignment rule); this one takes one
  physical write row per token instead (the trash row = skip), as the JAX
  gather path resolves them.

The core splits each slot's context over blocks of :func:`split_plan`'s
pages and merges them in a second kernel, launched by the same C call; the
wrapper allocates the merge's scratch. No context length is refused: a
longer context gives each split more pages.

The pools are updated IN PLACE — torch tensors are mutable, so the TPU
kernels' input->output aliasing has no counterpart — and only the attention
output is returned.

Dispatch is by device, never by failure: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ssi_tpu_torch import _build
from ssi_tpu_torch.generate.paged import paged_attention, paged_attention_multi

KERNEL = "paged_attention_fused"
KERNEL_MULTI = "paged_attention_multi"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_KEYS = 256  # keys a split walks at least: two 128-token pages
MAX_SPLITS = 16   # splits per (slot, kv head) at most, which bounds the scratch


def split_plan(max_pages: int, page_size: int) -> tuple[int, int]:
    """(pages per split, splits per (slot, kv head)) for a page table of
    ``max_pages`` pages: splits of at least ``SPLIT_KEYS`` keys, at most
    ``MAX_SPLITS`` of them (a longer context gives each more pages)."""
    per_split = max(-(-SPLIT_KEYS // page_size), -(-max_pages // MAX_SPLITS))
    return per_split, -(-max_pages // per_split)


def _scratch(n_slots: int, hkv: int, n_rows: int, n_splits: int, device) -> torch.Tensor:
    """The merge's scratch: per (slot, kv head, split, query row) 64 floats of
    unnormalised output, then (max, sum) for each; empty with one split."""
    n = n_slots * hkv * n_splits * n_rows * (64 + 2) if n_splits > 1 else 0
    return torch.empty(n, dtype=torch.float32, device=device)


def paged_attention_fused_reference(q, k_pool, v_pool, page_table, seq_lens, *, k_new, v_new, write_rows):
    """Plain version: write the incoming token's K/V at (``write_rows``,
    ``(seq_lens - 1) % ps``) in place, then attend over ``seq_lens`` entries
    (``write_token_kv`` + ``paged_attention`` of the JAX package)."""
    n_slots = q.shape[0]
    offs = torch.remainder(seq_lens - 1, k_pool.shape[1]).long()
    rows = write_rows.long()
    k_pool[rows, offs] = k_new.to(k_pool.dtype).reshape(n_slots, -1)
    v_pool[rows, offs] = v_new.to(v_pool.dtype).reshape(n_slots, -1)
    return paged_attention(q, k_pool, v_pool, page_table, seq_lens)


def _check_int(name: str, x: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    return x.to(torch.int32).contiguous()


def _check_common(q, k_pool, v_pool, k_new, v_new, hq: int, hd: int, new_shape: tuple) -> int:
    """Argument checks both paged kernels share; returns Hkv."""
    kvd = k_pool.shape[2]
    hkv = kvd // hd
    dev = q.device
    if hd != 64:
        raise ValueError(f"the CUDA paged kernels are built for head_dim 64, got {hd}")
    if hkv * hd != kvd or hq % hkv != 0 or hq // hkv not in (1, 2, 4, 8):
        raise ValueError(f"unsupported heads: Hq={hq}, pool width {kvd} (Hkv*64), n_rep must be 1, 2, 4 or 8")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in (k_pool, v_pool, k_new, v_new)):
        raise TypeError("q, pools and new K/V must share one dtype, f32 or bf16")
    if v_pool.shape != k_pool.shape:
        raise ValueError("k_pool and v_pool shapes differ")
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        if pool.device != dev or not pool.is_contiguous() or pool.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor on {dev} (updated in place)")
    shape = (*new_shape, hkv, hd)
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name} must be {list(shape)} on {dev}")
    return hkv


def _paged_attention_cuda(q, k_pool, v_pool, page_table, seq_lens, k_new, v_new, write_rows):
    n_slots, hq, hd = q.shape
    ps = k_pool.shape[1]
    max_pages = page_table.shape[1]
    dev = q.device
    hkv = _check_common(q, k_pool, v_pool, k_new, v_new, hq, hd, (n_slots,))
    page_table = _check_int("page_table", page_table, (n_slots, max_pages), dev)
    seq_lens = _check_int("seq_lens", seq_lens, (n_slots,), dev)
    write_rows = _check_int("write_rows", write_rows, (n_slots,), dev)
    per_split, n_splits = split_plan(max_pages, ps)
    part = _scratch(n_slots, hkv, hq // hkv, n_splits, dev)
    q = q.contiguous()
    k_new = k_new.contiguous()
    v_new = v_new.contiguous()
    out = torch.empty_like(q)
    lib = _build.load_library()
    # the kernel writes at offset (seq_lens - 1) mod ps, floor modulo: an
    # inactive slot (seq_len 0) writes offset ps-1 of the trash row
    err = lib.ssi_paged_attention_fused(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        write_rows.data_ptr(), out.data_ptr(), part.data_ptr(),
        n_slots, hq, hkv, ps, max_pages, per_split, n_splits, hd**-0.5,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check_launch(KERNEL, err)
    return out


def paged_attention_fused(q, k_pool, v_pool, page_table, seq_lens, *, k_new, v_new, write_rows):
    """Fused write-token + single-token GQA over the flat paged pool.

    q ``[slots, Hq, hd]``; k_pool/v_pool ``[rows, ps, Hkv*hd]`` (all layers,
    trash row last), written in place; page_table ``[slots, max_pages]`` int32
    PHYSICAL rows; seq_lens ``[slots]`` valid lengths INCLUDING the incoming
    token (0 for an inactive slot); k_new/v_new ``[slots, Hkv, hd]``, written
    at row ``write_rows`` (the trash row for inactive slots), offset
    ``(seq_lens - 1) % ps``. Returns attn ``[slots, Hq, hd]``.
    """
    if q.is_cuda:
        return _paged_attention_cuda(q, k_pool, v_pool, page_table, seq_lens, k_new, v_new, write_rows)
    return paged_attention_fused_reference(
        q, k_pool, v_pool, page_table, seq_lens, k_new=k_new, v_new=v_new, write_rows=write_rows
    )


def paged_attention_multi_fused_reference(q, k_pool, v_pool, page_table, hist_lens, *, k_new, v_new, write_rows):
    """Plain version: write token t's K/V at (``write_rows[:, t]``,
    ``(hist_lens + t) % ps``) in place, trash row included, then attend with
    ``paged_attention_multi`` over ``hist_lens + 1`` entries (the JAX XLA
    path of ``decode_step_tokens_spec``)."""
    n_slots, t_q = q.shape[:2]
    ps = k_pool.shape[1]
    t_idx = torch.arange(t_q, dtype=hist_lens.dtype, device=hist_lens.device)
    offs = torch.remainder(hist_lens[:, None] + t_idx[None, :], ps).long()
    rows = write_rows.long()
    for t in range(t_q):
        k_pool[rows[:, t], offs[:, t]] = k_new[:, t].to(k_pool.dtype).reshape(n_slots, -1)
        v_pool[rows[:, t], offs[:, t]] = v_new[:, t].to(v_pool.dtype).reshape(n_slots, -1)
    return paged_attention_multi(q, k_pool, v_pool, page_table, hist_lens + 1)


def _paged_attention_multi_cuda(q, k_pool, v_pool, page_table, hist_lens, k_new, v_new, write_rows):
    n_slots, t_q, hq, hd = q.shape
    ps = k_pool.shape[1]
    max_pages = page_table.shape[1]
    dev = q.device
    if not 2 <= t_q <= 8:
        raise ValueError(f"T ({t_q}) must be in [2, 8] (use paged_attention_fused for T == 1)")
    if ps % 8 != 0:
        raise ValueError(f"page_size ({ps}) must be a multiple of 8")
    hkv = _check_common(q, k_pool, v_pool, k_new, v_new, hq, hd, (n_slots, t_q))
    page_table = _check_int("page_table", page_table, (n_slots, max_pages), dev)
    hist_lens = _check_int("hist_lens", hist_lens, (n_slots,), dev)
    write_rows = _check_int("write_rows", write_rows, (n_slots, t_q), dev)
    per_split, n_splits = split_plan(max_pages, ps)
    part = _scratch(n_slots, hkv, t_q * (hq // hkv), n_splits, dev)
    q = q.contiguous()
    k_new = k_new.contiguous()
    v_new = v_new.contiguous()
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.ssi_paged_attention_multi(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), hist_lens.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        write_rows.data_ptr(), out.data_ptr(), part.data_ptr(),
        n_slots, t_q, hq, hkv, ps, max_pages, k_pool.shape[0] - 1, per_split, n_splits, hd**-0.5,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check_launch(KERNEL_MULTI, err)
    return out


def paged_attention_multi_fused(q, k_pool, v_pool, page_table, hist_lens, *, k_new, v_new, write_rows):
    """Fused T-token write + verify GQA over the flat paged pool.

    q ``[slots, T, Hq, hd]`` (post-RoPE, unscaled), token t at position
    ``hist_lens + t``; k_pool/v_pool ``[rows, ps, Hkv*hd]`` (all layers, trash
    row last), written in place; page_table ``[slots, max_pages]`` int32
    PHYSICAL rows; hist_lens ``[slots]`` tokens resident in the pages BEFORE
    the step; k_new/v_new ``[slots, T, Hkv, hd]``; write_rows ``[slots, T]``
    the physical row receiving token t at offset ``(hist_lens + t) % ps`` (the
    trash row: the kernel skips the write). Token t attends the history and
    in-flight tokens 0..t. Returns attn ``[slots, T, Hq, hd]``.
    """
    if q.is_cuda:
        return _paged_attention_multi_cuda(q, k_pool, v_pool, page_table, hist_lens, k_new, v_new, write_rows)
    return paged_attention_multi_fused_reference(
        q, k_pool, v_pool, page_table, hist_lens, k_new=k_new, v_new=v_new, write_rows=write_rows
    )
