"""Fused, chunked cross-entropy over the output matrix: the plain version.

Port of ``ssi_tpu/ops/cross_entropy.py``. The loss is computed from hidden
states ``[N, D]`` and the output matrix ``[V, D]`` (tied embedding or
``lm_head``) in token chunks, so the full ``[N, V]`` f32 logits are never
held at once; the backward recomputes each chunk's logits and reads the
forward's row logsumexp. Semantics: the
``sum`` of token NLLs over labels != -100 (the caller divides by the token
count).

This module is the CPU path and the plain version of the CUDA kernels in
``ops/cross_entropy_cuda.py`` (TPU kernels #5-#7): :func:`cross_entropy_lse`
for the streaming logsumexp, :func:`cross_entropy_dlogits` for the
backward's dlogits pass, :func:`cross_entropy_dh_gemm` and
:func:`cross_entropy_de_gemm` for its two GEMMs, and :func:`cross_entropy_dh`
and :func:`cross_entropy_de` for the two gradients from h and E. Products
take f32 accumulation for bf16 operands, as ``preferred_element_type=float32``
does.

The vocabulary-parallel loss (tensor-parallel training: a rank holds the
rows ``E[v0:v0+V_r]``) is built from the same pieces: each rank's slice
logsumexp, merged over the ranks in rank order by :func:`cross_entropy_lse_merge`,
labels remapped to the slice by :func:`slice_labels` (a valid label outside
it becomes -1: the row keeps its softmax term and takes no one-hot), and the
picked logit from the rank that owns the label (:func:`slice_picked`). The
dlogits, dh and dE functions take the merged ``lse`` for that (``lse=None``:
each computes its softmax over the rows it is given).
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


def _dlogits(h_c: torch.Tensor, embed: torch.Tensor, y_c: torch.Tensor, g: torch.Tensor,
             lse_c: torch.Tensor | None = None) -> torch.Tensor:
    """(softmax - onehot) with ignored rows zeroed, times ``g``, in E's dtype.
    The softmax is ``exp(logits - lse_c)`` when the rows' ``lse_c`` is given;
    a valid label that names no row of ``embed`` (-1) adds no one-hot."""
    logits = _mm_f32(h_c, embed.t())
    probs = torch.softmax(logits, dim=-1) if lse_c is None else torch.exp(logits - lse_c[:, None])
    valid = y_c != CROSS_ENTROPY_IGNORE_IDX
    hot = valid & (y_c >= 0) & (y_c < embed.shape[0])
    safe = torch.where(hot, y_c, 0).long()
    probs[torch.arange(probs.shape[0], device=probs.device), safe] -= hot.to(probs.dtype)
    return (torch.where(valid[:, None], probs, 0.0) * g).to(embed.dtype)


def cross_entropy_lse(hidden: torch.Tensor, embed: torch.Tensor, chunk_size: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Row logsumexp of ``hidden @ embed.T``, ``[N]`` f32 (plain version of #5)."""
    return torch.cat([torch.logsumexp(_mm_f32(hidden[a:b], embed.t()), dim=-1)
                      for a, b in _chunks(hidden.shape[0], chunk_size)])


def _rows(lse: torch.Tensor | None, a: int, b: int) -> torch.Tensor | None:
    return None if lse is None else lse[a:b]


def cross_entropy_dlogits(hidden, embed, labels, g, chunk_size: int = DEFAULT_CHUNK, lse=None) -> torch.Tensor:
    """dlogits = (softmax - onehot) * valid * g, ``[N, V]`` in E's dtype
    (plain version of the kernels' dlogits pass)."""
    return torch.cat([_dlogits(hidden[a:b], embed, labels[a:b], g, _rows(lse, a, b))
                      for a, b in _chunks(hidden.shape[0], chunk_size)])


def cross_entropy_dh_gemm(dlogits: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """dh = dlogits @ E, ``[N, D]`` in E's dtype (plain version of the dh GEMM)."""
    return _mm_f32(dlogits, embed).to(embed.dtype)


def cross_entropy_de_gemm(dlogits: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    """dE = dlogits^T @ h, ``[V, D]`` in h's dtype (plain version of the dE GEMM)."""
    return _mm_f32(dlogits.t(), hidden).to(hidden.dtype)


def cross_entropy_dh(hidden, embed, labels, g, chunk_size: int = DEFAULT_CHUNK, lse=None) -> torch.Tensor:
    """dh = dlogits @ E, ``[N, D]`` in h's dtype (plain version of #6)."""
    parts = [_mm_f32(_dlogits(hidden[a:b], embed, labels[a:b], g, _rows(lse, a, b)), embed)
             for a, b in _chunks(hidden.shape[0], chunk_size)]
    return torch.cat(parts).to(hidden.dtype)


def cross_entropy_de(hidden, embed, labels, g, chunk_size: int = DEFAULT_CHUNK, lse=None) -> torch.Tensor:
    """dE = dlogits^T @ h, ``[V, D]`` in E's dtype, summed over chunks in f32
    (plain version of #7)."""
    acc = torch.zeros(embed.shape, dtype=torch.float32, device=embed.device)
    for a, b in _chunks(hidden.shape[0], chunk_size):
        acc += _mm_f32(_dlogits(hidden[a:b], embed, labels[a:b], g, _rows(lse, a, b)).t(),
                       hidden[a:b].to(embed.dtype))
    return acc.to(embed.dtype)


def cross_entropy_lse_merge(parts: torch.Tensor) -> torch.Tensor:
    """The logsumexp over the whole vocabulary from the slices' ``parts``
    ``[T, N]`` (f32): ``m + log(sum_r exp(parts[r] - m))``, ``m`` the rows'
    max, summed in slice order (plain version of the merge pass)."""
    m = parts.max(dim=0).values
    total = torch.zeros_like(m)
    for part in parts:
        total = total + torch.exp(part - m)
    return m + torch.log(total)


def slice_labels(labels: torch.Tensor, v0: int, rows: int) -> torch.Tensor:
    """``labels`` as the vocabulary slice ``[v0, v0 + rows)`` sees them: a
    label in it becomes its row ``label - v0``; a valid label outside it
    -1 (the row stays valid, with no one-hot); the ignore index stays."""
    inside = (labels >= v0) & (labels < v0 + rows)
    outside = torch.where(labels == CROSS_ENTROPY_IGNORE_IDX, CROSS_ENTROPY_IGNORE_IDX, -1).to(labels.dtype)
    return torch.where(inside, labels - v0, outside)


def slice_picked(hidden: torch.Tensor, embed: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """Each row's label logit where the slice ``embed`` holds its label
    (``local``: :func:`slice_labels`' rows), else 0; ``[N]`` f32, by an f32
    row gather (N x D reads)."""
    hot = local >= 0
    safe = torch.where(hot, local, 0).long()
    return torch.where(hot, (hidden.float() * embed[safe].float()).sum(dim=-1), 0.0)


class _FusedCrossEntropy(torch.autograd.Function):
    """The kernels' computation in plain PyTorch: the chunked logsumexp, the
    label's logit by an f32 row gather, and a backward that reads the
    forward's lse (the JAX custom VJP recomputes each chunk's softmax, the
    same values to rounding). A vocabulary-parallel loss whose one slice
    is the whole vocabulary gives these bits."""

    @staticmethod
    def forward(ctx, hidden, embed, labels, chunk_size):
        lse = cross_entropy_lse(hidden, embed, chunk_size)
        picked = slice_picked(hidden, embed, labels)
        ctx.save_for_backward(hidden, embed, labels, lse)
        ctx.chunk_size = chunk_size
        return torch.where(labels != CROSS_ENTROPY_IGNORE_IDX, lse - picked, 0.0).sum()

    @staticmethod
    def backward(ctx, g):
        hidden, embed, labels, lse = ctx.saved_tensors
        dh = cross_entropy_dh(hidden, embed, labels, g, ctx.chunk_size, lse=lse) if ctx.needs_input_grad[0] else None
        de = cross_entropy_de(hidden, embed, labels, g, ctx.chunk_size, lse=lse) if ctx.needs_input_grad[1] else None
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
