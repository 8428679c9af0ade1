"""Flash attention: the CUDA kernels ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``, their plain PyTorch versions, and the
autograd Function over them.

Port of ``ssi_tpu/ops/flash_attention.py``: the forward (TPU kernels
``_fwd_kernel`` / ``_fwd_kernel_grouped``) and the backward (``_bwd_kernel``
/ ``_bwd_kernel_grouped``, reached from ``_flash_bwd_rule``). Public layout is
the model's ``[B, S, H, D]``; the forward also produces the row logsumexp
``[B, Hq, S]`` (f32), which the backward takes with the output. Serving uses
the forward for the paged prefill; training differentiates
:func:`flash_attention`, whose backward recomputes the scores from q, k, v,
o and lse.

The kernels take unscaled q and apply ``1/sqrt(d)`` inside (the JAX wrapper
folds the scale into q before its kernels); the math is the same.

Dispatch is by device, never by failure: a CPU tensor takes
:func:`flash_attention_reference` / :func:`flash_attention_bwd_reference`; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ssi_tpu_torch import _build

KERNEL = "flash_attention_fwd"
BWD_KERNEL = "flash_attention_bwd"
_NEG_INF = -1.0e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, same semantics: q pre-scaled by 1/sqrt(d),
    masked scores -1e30, ``m_safe``/``l_safe`` clamps (a fully masked row gives
    0 and a finite lse). Math in f32. Returns (o ``[B, S, Hq, D]`` in q's dtype,
    lse ``[B, Hq, S]`` f32)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    qs = q.float() * (1.0 / d**0.5)
    qg = qs.view(b, s, hkv, n_rep, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())  # [B, Hkv, n_rep, S, S]
    mask = _mask(s, causal, segment_ids, q.device)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m_safe = scores.amax(dim=-1, keepdim=True).clamp_min(-0.5e30)
    p = torch.exp(scores - m_safe)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float()) / l_safe.permute(0, 3, 1, 2, 4)
    lse = (m_safe + torch.log(l_safe)).reshape(b, hq, s)
    return o.reshape(b, s, hq, d).to(q.dtype), lse


def _mask(s: int, causal: bool, segment_ids, device) -> torch.Tensor | None:
    """Allowed (query, key) pairs, broadcastable to ``[B, Hkv, n_rep, S, S]``."""
    mask = None
    if causal:
        pos = torch.arange(s, device=device)
        mask = pos[None, :] <= pos[:, None]
    if segment_ids is not None:
        seg_mask = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None, None]
        mask = seg_mask if mask is None else mask & seg_mask
    return mask


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: the explicit formulas in f32 from
    the forward's o and lse (``[B, Hq, S]``): S = q.k / sqrt(d), P = exp(S -
    lse) with masked pairs 0, delta = rowsum(o * do), dS = P * (dP - delta),
    dq = dS.k / sqrt(d), dk = dS^T.q / sqrt(d), dv = P^T.do, the n_rep q heads
    of a kv head summed into its dk, dv. Returns (dq, dk, dv) in q's, k's and
    v's dtypes."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    scale = 1.0 / d**0.5
    qg = q.float().reshape(b, s, hkv, n_rep, d)
    dog = do.float().reshape(b, s, hkv, n_rep, d)  # autograd may hand in a non-contiguous do
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale  # [B, Hkv, n_rep, S, S]
    p = torch.exp(scores - lse.float().reshape(b, hkv, n_rep, s, 1))
    mask = _mask(s, causal, segment_ids, q.device)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    delta = (o.float() * do.float()).sum(-1).reshape(b, s, hkv, n_rep).permute(0, 2, 3, 1)  # [B, Hkv, n_rep, S]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return dq.reshape(b, s, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operands(q, k, v, segment_ids) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [B, S, H, D] q/k/v")
    b, s, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if hq % k.shape[2] != 0:
        raise ValueError(f"Hq ({hq}) must be a multiple of Hkv ({k.shape[2]}) for GQA")
    if segment_ids is not None and tuple(segment_ids.shape) != (b, s):
        raise ValueError(f"segment_ids must be [B, S] = {(b, s)}, got {tuple(segment_ids.shape)}")


def _check_kernel_operands(*tensors: torch.Tensor) -> None:
    q = tensors[0]
    if q.shape[3] != 64:
        raise ValueError(f"the CUDA flash kernel is built for head_dim 64, got {q.shape[3]}")
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in tensors):
        raise TypeError(f"flash_attention kernel takes f32 or bf16 operands of one dtype, got "
                        f"{[x.dtype for x in tensors]}")
    if any(x.device != q.device for x in tensors):
        raise ValueError("flash_attention operands must be on one device")


def _flash_fwd_cuda(q, k, v, causal: bool, segment_ids) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    _check_kernel_operands(q, k, v)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim")
    if q.dtype == torch.bfloat16:  # the tensor-core kernel copies rows in 16-byte pieces
        q, k, v = (x if x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in x.stride()[:3])
                   else x.clone(memory_format=torch.contiguous_format)
                   for x in (q, k, v))
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    err = lib.ssi_flash_attention_fwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        seg.data_ptr() if seg is not None else None, o.data_ptr(), lse.data_ptr(),
        b, s, hq, hkv,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), 1.0 / d**0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check_launch(KERNEL, err)
    return o, lse


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(o ``[B, S, Hq, D]``, lse ``[B, Hq, S]``): the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    _check_operands(q, k, v, segment_ids)
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, causal, segment_ids)
    return flash_attention_reference(q, k, v, causal=causal, segment_ids=segment_ids)


def _flash_bwd_cuda(q, k, v, o, lse, do, causal: bool, segment_ids):
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    # the kernels read rows in 16-byte pieces: contiguous, 16-byte aligned operands
    q, k, v, o, do = (x.contiguous() for x in (q, k, v, o, do))
    q, k, v, o, do = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v, o, do))
    _check_kernel_operands(q, k, v, o, do)
    lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
    if tuple(lse.shape) != (b, hq, s):
        raise ValueError(f"lse must be [B, Hq, S] = {(b, hq, s)}, got {tuple(lse.shape)}")
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)  # rowsum(o * do), scratch
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _build.load_library().ssi_flash_attention_bwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), seg.data_ptr() if seg is not None else None, delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, hq, hkv, int(causal), 1.0 / d**0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check_launch(BWD_KERNEL, err)
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's o and lse ``[B, Hq, S]`` and the output
    gradient ``do``: the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    _check_operands(q, k, v, segment_ids)
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, o, lse, do, causal, segment_ids)
    return flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal, segment_ids=segment_ids)


class _FlashAttention(torch.autograd.Function):
    """Forward and backward through the wrappers above; saves o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, segment_ids):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal, segment_ids=segment_ids)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Flash attention in the model's ``[B, S, H, D]`` layout (GQA: ``Hq %
    Hkv == 0``; optional packed ``segment_ids [B, S]``), differentiable in q,
    k and v."""
    _check_operands(q, k, v, segment_ids)
    return _FlashAttention.apply(q, k, v, causal, segment_ids)
