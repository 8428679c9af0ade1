"""Plain causal GQA attention — port of ``ssi_tpu/ops/attention.py``
``xla_attention`` (f32 softmax, output in q's dtype). The CPU test path, and
the plain version the model forward uses; the CUDA flash kernel is in
``ops/flash_attention.py``."""

from __future__ import annotations

import torch

_NEG_INF = -2.0e38


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv * n_rep, D]."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """q ``[B, S, Hq, D]``, k/v ``[B, S, Hkv, D]`` -> ``[B, S, Hq, D]`` in q's dtype.

    ``segment_ids [B, S]`` restricts attention to equal segments (packed rows).
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    scale = 1.0 / (d**0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        pos = torch.arange(s, device=q.device)
        mask = (pos[None, :] <= pos[:, None])[None, None]
    if segment_ids is not None:
        seg_mask = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        mask = seg_mask if mask is None else mask & seg_mask
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)
