"""Fused paged decode (token write + single-token GQA): the CUDA kernel
``csrc/paged_attention.cu`` and its plain PyTorch version.

Port of ``ssi_tpu/generate/paged_pallas.py`` ``paged_attention_pallas`` (same
arguments and semantics). The pools are updated IN PLACE — torch tensors are
mutable, so the TPU kernel's input->output aliasing has no counterpart — and
only the attention output is returned.

Dispatch is by device, never by failure: a CPU tensor takes
:func:`paged_attention_fused_reference`; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from ssi_tpu_torch import _build
from ssi_tpu_torch.generate.paged import paged_attention

KERNEL = "paged_attention_fused"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024  # bytes of shared memory one H100 block may use


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


def _paged_attention_cuda(q, k_pool, v_pool, page_table, seq_lens, k_new, v_new, write_rows):
    n_slots, hq, hd = q.shape
    n_rows, ps, kvd = k_pool.shape
    hkv = kvd // hd
    max_pages = page_table.shape[1]
    dev = q.device
    if hd != 64:
        raise ValueError(f"the CUDA paged kernel is built for head_dim 64, got {hd}")
    if hkv * hd != kvd or hq % hkv != 0 or hq // hkv not in (1, 2, 4, 8):
        raise ValueError(f"unsupported heads: Hq={hq}, pool width {kvd} (Hkv*64), n_rep must be 1, 2, 4 or 8")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in (k_pool, v_pool, k_new, v_new)):
        raise TypeError("q, pools and new K/V must share one dtype, f32 or bf16")
    if v_pool.shape != k_pool.shape:
        raise ValueError("k_pool and v_pool shapes differ")
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        if pool.device != dev or not pool.is_contiguous() or pool.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor on {dev} (updated in place)")
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if tuple(x.shape) != (n_slots, hkv, hd) or x.device != dev:
            raise ValueError(f"{name} must be [{n_slots}, {hkv}, {hd}] on {dev}")
    smem = 4 * ((hq // hkv) * max_pages * ps + 16 * (hq // hkv) * hd)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"max_context {max_pages * ps} needs {smem} B of shared memory > {_SMEM_LIMIT}")
    page_table = _check_int("page_table", page_table, (n_slots, max_pages), dev)
    seq_lens = _check_int("seq_lens", seq_lens, (n_slots,), dev)
    write_rows = _check_int("write_rows", write_rows, (n_slots,), dev)
    # floor modulo: an inactive slot (seq_len 0) writes offset ps-1 of the trash row
    write_offs = torch.remainder(seq_lens - 1, ps).to(torch.int32)
    q = q.contiguous()
    k_new = k_new.contiguous()
    v_new = v_new.contiguous()
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.ssi_paged_attention_fused(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        write_rows.data_ptr(), write_offs.data_ptr(), out.data_ptr(),
        n_slots, hq, hkv, ps, max_pages, hd**-0.5, torch.cuda.current_stream(dev).cuda_stream,
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
