"""Flash attention forward: the CUDA kernel ``csrc/flash_attention_fwd.cu``
and its plain PyTorch version.

Port of the forward half of ``ssi_tpu/ops/flash_attention.py`` (the TPU
kernels ``_fwd_kernel`` / ``_fwd_kernel_grouped``). Public layout is the
model's ``[B, S, H, D]``; the forward also produces the row logsumexp
``[B, Hq, S]`` (f32), as the TPU forward does, for the backward kernel that
a later port adds. Serving uses it for the paged prefill.

Dispatch is by device, never by failure: a CPU tensor takes
:func:`flash_attention_reference`; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from ssi_tpu_torch import _build

KERNEL = "flash_attention_fwd"
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
    mask = None
    if causal:
        pos = torch.arange(s, device=q.device)
        mask = pos[None, :] <= pos[:, None]
    if segment_ids is not None:
        seg_mask = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None, None]
        mask = seg_mask if mask is None else mask & seg_mask
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    m_safe = scores.amax(dim=-1, keepdim=True).clamp_min(-0.5e30)
    p = torch.exp(scores - m_safe)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float()) / l_safe.permute(0, 3, 1, 2, 4)
    lse = (m_safe + torch.log(l_safe)).reshape(b, hq, s)
    return o.reshape(b, s, hq, d).to(q.dtype), lse


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


def _flash_fwd_cuda(q, k, v, causal: bool, segment_ids) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if d != 64:
        raise ValueError(f"the CUDA flash kernel is built for head_dim 64, got {d}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes f32 or bf16 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (k.device == q.device == v.device):
        raise ValueError("q, k, v must be on one device")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim")
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


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Flash attention in the model's ``[B, S, H, D]`` layout (GQA: ``Hq %
    Hkv == 0``; optional packed ``segment_ids [B, S]``)."""
    return flash_attention_fwd(q, k, v, causal=causal, segment_ids=segment_ids)[0]
