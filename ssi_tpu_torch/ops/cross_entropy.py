"""Fused, chunked cross-entropy over the output matrix: the plain version.

Port of ``ssi_tpu/ops/cross_entropy.py``. The loss is computed from hidden
states ``[N, D]`` and the output matrix ``[V, D]`` (tied embedding or
``lm_head``) in token chunks, so the full ``[N, V]`` f32 logits are never
held at once; the backward recomputes each chunk's logits. Semantics: the
``sum`` of token NLLs over labels != -100 (the caller divides by the token
count).

This module is the CPU path and the plain version of the CUDA kernels in
``ops/cross_entropy_cuda.py`` (TPU kernels #5-#7): :func:`cross_entropy_lse`
for the streaming logsumexp, :func:`cross_entropy_dh` and
:func:`cross_entropy_de` for the two gradients. Products take f32
accumulation for bf16 operands, as ``preferred_element_type=float32`` does.
"""

from __future__ import annotations

import torch

from ssi_tpu_torch.constants import CROSS_ENTROPY_IGNORE_IDX

DEFAULT_CHUNK = 1024


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as f32 with f32 accumulation (bf16 operands stay bf16 on CUDA)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunks(n: int, chunk_size: int):
    return ((i, min(n, i + chunk_size)) for i in range(0, n, chunk_size))


def _dlogits(h_c: torch.Tensor, embed: torch.Tensor, y_c: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(softmax - onehot) with ignored rows zeroed, times ``g``, in E's dtype."""
    probs = torch.softmax(_mm_f32(h_c, embed.t()), dim=-1)
    valid = y_c != CROSS_ENTROPY_IGNORE_IDX
    safe = torch.where(valid, y_c, 0).long()
    probs[torch.arange(probs.shape[0], device=probs.device), safe] -= 1.0
    return (torch.where(valid[:, None], probs, 0.0) * g).to(embed.dtype)


def cross_entropy_lse(hidden: torch.Tensor, embed: torch.Tensor, chunk_size: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Row logsumexp of ``hidden @ embed.T``, ``[N]`` f32 (plain version of #5)."""
    return torch.cat([torch.logsumexp(_mm_f32(hidden[a:b], embed.t()), dim=-1)
                      for a, b in _chunks(hidden.shape[0], chunk_size)])


def cross_entropy_dh(hidden, embed, labels, g, chunk_size: int = DEFAULT_CHUNK) -> torch.Tensor:
    """dh = dlogits @ E, ``[N, D]`` in h's dtype (plain version of #6)."""
    parts = [_mm_f32(_dlogits(hidden[a:b], embed, labels[a:b], g), embed)
             for a, b in _chunks(hidden.shape[0], chunk_size)]
    return torch.cat(parts).to(hidden.dtype)


def cross_entropy_de(hidden, embed, labels, g, chunk_size: int = DEFAULT_CHUNK) -> torch.Tensor:
    """dE = dlogits^T @ h, ``[V, D]`` in E's dtype, summed over chunks in f32
    (plain version of #7)."""
    acc = torch.zeros(embed.shape, dtype=torch.float32, device=embed.device)
    for a, b in _chunks(hidden.shape[0], chunk_size):
        acc += _mm_f32(_dlogits(hidden[a:b], embed, labels[a:b], g).t(), hidden[a:b].to(embed.dtype))
    return acc.to(embed.dtype)


class _FusedCrossEntropy(torch.autograd.Function):
    """Chunked forward; the backward recomputes each chunk's softmax, as the
    JAX custom VJP does (once for dh and once for dE here)."""

    @staticmethod
    def forward(ctx, hidden, embed, labels, chunk_size):
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for a, b in _chunks(hidden.shape[0], chunk_size):
            logits = _mm_f32(hidden[a:b], embed.t())
            valid = labels[a:b] != CROSS_ENTROPY_IGNORE_IDX
            safe = torch.where(valid, labels[a:b], 0).long()
            picked = torch.gather(logits, 1, safe[:, None])[:, 0]
            total = total + torch.where(valid, torch.logsumexp(logits, dim=-1) - picked, 0.0).sum()
        ctx.save_for_backward(hidden, embed, labels)
        ctx.chunk_size = chunk_size
        return total

    @staticmethod
    def backward(ctx, g):
        hidden, embed, labels = ctx.saved_tensors
        dh = cross_entropy_dh(hidden, embed, labels, g, ctx.chunk_size) if ctx.needs_input_grad[0] else None
        de = cross_entropy_de(hidden, embed, labels, g, ctx.chunk_size) if ctx.needs_input_grad[1] else None
        return dh, de, None, None


def fused_cross_entropy(
    hidden: torch.Tensor,
    embed: torch.Tensor,
    labels: torch.Tensor,
    chunk_size: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """Sum of NLL over labels != -100: hidden ``[N, D]``, embed ``[V, D]``,
    labels ``[N]`` ints. Returns a scalar f32."""
    return _FusedCrossEntropy.apply(hidden, embed, labels, chunk_size)


def cross_entropy_sum_and_count(
    hidden: torch.Tensor,
    embed: torch.Tensor,
    labels: torch.Tensor,
    chunk_size: int = DEFAULT_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum NLL, non-ignored token count)."""
    return fused_cross_entropy(hidden, embed, labels, chunk_size), (labels != CROSS_ENTROPY_IGNORE_IDX).sum()
