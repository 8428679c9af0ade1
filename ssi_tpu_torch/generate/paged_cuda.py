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

The core takes any head_dim up to 256 (an instance at 64, one at 128 and
one at 256, each running the head_dims up to it), page sizes that are
multiples of 8, and any GQA ratio n_rep: a block holds up to ``ROW_GROUP``
(64) of the ``T * n_rep`` query rows of a (slot, kv head), and more rows
take more row groups (:func:`row_groups`), each reading the pages again. A
head_dim that is not a multiple of 8 (the pool's head stride is not a
16-byte multiple, so no tensor map describes it, and a padded pool would
change the engine's state) runs in bf16 on the core's plain-load kernels,
as f32 always does (:func:`uses_tensor_maps`). A head_dim above 256 raises,
naming ROADMAP B2 (still to port).

The core splits each slot's context over blocks of :func:`split_plan`'s
pages (one split up to 1,280 keys). In bf16 one launch does the whole call:
the split that finishes last merges a slot's splits, told by an arrival
counter per (slot, kv head, row group) that this module keeps zeroed on
each device (:func:`_counters`), and it reads the pages by TMA through
tensor maps this module encodes once per pool (:func:`_pool_map`). The
plain-load kernels (the f32 parity path, and bf16 at a head_dim that is not
a multiple of 8) merge in a second kernel, launched by the same C call. The wrapper
allocates the merge's scratch. No context length is refused: a longer
context gives each split more pages.

The pools are updated IN PLACE — torch tensors are mutable, so the TPU
kernels' input->output aliasing has no counterpart — and only the attention
output is returned.

Dispatch is by device, never by failure: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ssi_tpu_torch import _build
from ssi_tpu_torch.generate.paged import paged_attention, paged_attention_multi

KERNEL = "paged_attention_fused"
KERNEL_MULTI = "paged_attention_multi"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# keys a split walks at least: ten 128-token pages. A bf16 block streams its
# pages no faster than its SM's TMA, so a longer split lengthens a call's
# slowest block, and shorter ones add blocks and merges (PERF.md section 6)
SPLIT_KEYS = 1280
MAX_SPLITS = 16   # splits per (slot, kv head) at most, which bounds the scratch
MAX_HEAD_DIM = 256  # the largest head_dim the kernels take (ROADMAP B2: above it, still to port)
ROW_GROUP = 64    # query rows a block holds at most (csrc/paged_attention.cu GROUP_ROWS)
_MAP_BYTES = 128  # a CUtensorMap
_MAX_MAPS = 64    # cached tensor maps; the cache is emptied past it
_maps: dict[tuple, ctypes.Array] = {}
_counter_buffers: dict[torch.device, torch.Tensor] = {}


def split_plan(max_pages: int, page_size: int) -> tuple[int, int]:
    """(pages per split, splits per (slot, kv head)) for a page table of
    ``max_pages`` pages: splits of at least ``SPLIT_KEYS`` keys, at most
    ``MAX_SPLITS`` of them (a longer context gives each more pages)."""
    per_split = max(-(-SPLIT_KEYS // page_size), -(-max_pages // MAX_SPLITS))
    return per_split, -(-max_pages // per_split)


def instance_head_dim(head_dim: int) -> int:
    """The kernel instance a head_dim runs on: 64 up to 64, 128 up to 128,
    else 256 (the C launcher's choice, ``csrc/paged_attention.cu``
    ``launch``)."""
    return 64 if head_dim <= 64 else 128 if head_dim <= 128 else 256


def uses_tensor_maps(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether a call reads the pools by TMA (the bf16 kernel, one launch):
    bf16 at a head_dim that is a multiple of 8. Otherwise the core's
    plain-load split kernel and its merge run (f32, or a pool whose head
    stride is not a 16-byte multiple)."""
    return dtype == torch.bfloat16 and head_dim % 8 == 0


def box_keys(page_size: int, head_dim: int) -> int:
    """Keys per TMA box of the bf16 kernel: the largest power of two that
    divides ``page_size`` (a multiple of 8), so no box crosses a page, up to
    the tile of the kernel's instance (128 keys at head_dim 64, 64 at 128 and
    256)."""
    tile = 128 if instance_head_dim(head_dim) == 64 else 64
    return next(b for b in (128, 64, 32, 16, 8) if b <= tile and page_size % b == 0)


def row_groups(n_rows: int) -> int:
    """Blocks a (split, slot, kv head) takes for its ``T * n_rep`` query
    rows: one per ``ROW_GROUP`` rows."""
    return -(-n_rows // ROW_GROUP)


def pool_map_key(pool: torch.Tensor, head_dim: int, box: int) -> tuple:
    """What a pool's tensor map is a function of: its address, its rows of
    keys, its kv heads, its head_dim and the box; the map cache's key."""
    return pool.data_ptr(), pool.shape[0] * pool.shape[1], pool.shape[2] // head_dim, head_dim, box


def _pool_map(lib, pool: torch.Tensor, head_dim: int, box: int) -> ctypes.Array:
    """The bf16 kernel's tensor map of ``pool`` (encoded on the host once
    per :func:`pool_map_key`: an engine's pools live as long as the engine)."""
    key = pool_map_key(pool, head_dim, box)
    m = _maps.get(key)
    if m is None:
        if len(_maps) >= _MAX_MAPS:
            _maps.clear()
        m = ctypes.create_string_buffer(_MAP_BYTES)
        err = lib.ssi_paged_pool_map(m, pool.data_ptr(), key[1], key[2], head_dim, box)
        if err != 0:
            raise RuntimeError(f"encoding the tensor map of a paged pool {tuple(pool.shape)} failed: cudaError_t {err}")
        _maps[key] = m
    return m


def _counters(n: int, device) -> torch.Tensor:
    """At least ``n`` int32 arrival counters on ``device``, zero between
    calls: each launch's merging blocks zero what they counted. Allocated
    (zeroed) at the first call on the device and grown outside any CUDA
    graph capture."""
    buf = _counter_buffers.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the paged kernels' arrival counters must be allocated before a CUDA graph capture: "
                               "call the kernel once at this shape first")
        buf = torch.zeros(max(n, 2 * buf.numel() if buf is not None else n), dtype=torch.int32, device=device)
        _counter_buffers[device] = buf
    return buf


def _scratch(n_slots: int, hkv: int, n_rows: int, n_splits: int, hd: int, device) -> torch.Tensor:
    """The merge's scratch: per (slot, kv head, split, query row) ``hd``
    floats of unnormalised output, then (max, sum) for each; empty with one
    split."""
    n = n_slots * hkv * n_splits * n_rows * (hd + 2) if n_splits > 1 else 0
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
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA paged kernels take head_dim <= {MAX_HEAD_DIM}, got {hd} (ROADMAP.md B2: a larger "
                         "head_dim is still to port)")
    if k_pool.shape[1] % 8 != 0:  # the bf16 kernel's TMA boxes are whole 8-row swizzle patterns
        raise ValueError(f"page_size ({k_pool.shape[1]}) must be a multiple of 8")
    if hkv == 0 or hkv * hd != kvd or hq % hkv != 0:
        raise ValueError(f"unsupported heads: Hq={hq}, pool width {kvd} (Hkv*{hd}); Hq must be a multiple of Hkv")
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


def _core_args(lib, q, k_pool, v_pool, n_slots: int, hkv: int, n_rows: int, max_pages: int, hd: int) -> tuple:
    """What both C entry points take beside the tensors: the split scratch
    (to be held until the launch), the pointers that follow ``out`` (the
    scratch, the arrival counters and the pools' tensor maps; None for the
    last three on the plain-load kernels) and the split plan with the box."""
    ps = k_pool.shape[1]
    per_split, n_splits = split_plan(max_pages, ps)
    part = _scratch(n_slots, hkv, n_rows, n_splits, hd, q.device)
    box = box_keys(ps, hd)
    ptrs = [part.data_ptr(), None, None, None]
    if uses_tensor_maps(hd, q.dtype):
        counters = _counters(n_slots * hkv * row_groups(n_rows), q.device)
        ptrs[1:] = counters.data_ptr(), _pool_map(lib, k_pool, hd, box), _pool_map(lib, v_pool, hd, box)
    return part, ptrs, (per_split, n_splits, box)


def _paged_attention_cuda(q, k_pool, v_pool, page_table, seq_lens, k_new, v_new, write_rows):
    n_slots, hq, hd = q.shape
    ps = k_pool.shape[1]
    max_pages = page_table.shape[1]
    dev = q.device
    hkv = _check_common(q, k_pool, v_pool, k_new, v_new, hq, hd, (n_slots,))
    page_table = _check_int("page_table", page_table, (n_slots, max_pages), dev)
    seq_lens = _check_int("seq_lens", seq_lens, (n_slots,), dev)
    write_rows = _check_int("write_rows", write_rows, (n_slots,), dev)
    q = q.contiguous()
    k_new = k_new.contiguous()
    v_new = v_new.contiguous()
    out = torch.empty_like(q)
    lib = _build.load_library()
    part, ptrs, plan = _core_args(lib, q, k_pool, v_pool, n_slots, hkv, hq // hkv, max_pages, hd)
    # the kernel writes at offset (seq_lens - 1) mod ps, floor modulo: an
    # inactive slot (seq_len 0) writes offset ps-1 of the trash row
    err = lib.ssi_paged_attention_fused(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        write_rows.data_ptr(), out.data_ptr(), *ptrs, n_slots, hq, hkv, hd, ps, max_pages, *plan, hd**-0.5,
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
    hkv = _check_common(q, k_pool, v_pool, k_new, v_new, hq, hd, (n_slots, t_q))
    page_table = _check_int("page_table", page_table, (n_slots, max_pages), dev)
    hist_lens = _check_int("hist_lens", hist_lens, (n_slots,), dev)
    write_rows = _check_int("write_rows", write_rows, (n_slots, t_q), dev)
    q = q.contiguous()
    k_new = k_new.contiguous()
    v_new = v_new.contiguous()
    out = torch.empty_like(q)
    lib = _build.load_library()
    part, ptrs, plan = _core_args(lib, q, k_pool, v_pool, n_slots, hkv, t_q * (hq // hkv), max_pages, hd)
    err = lib.ssi_paged_attention_multi(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), hist_lens.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        write_rows.data_ptr(), out.data_ptr(), *ptrs, n_slots, t_q, hq, hkv, hd, ps, max_pages, k_pool.shape[0] - 1,
        *plan, hd**-0.5,
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
