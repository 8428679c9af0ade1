"""Fused cross-entropy: the CUDA kernels ``csrc/cross_entropy.cu`` and the
autograd wrapper the training loss calls.

Port of ``ssi_tpu/ops/cross_entropy_pallas.py`` (TPU kernels ``_lse_kernel``,
``_dh_kernel``, ``_de_kernel``). The forward launches the logsumexp kernel and
takes the picked-label logit outside it, by an f32 row gather, as the TPU
``_forward`` does; the backward launches the dh and dE kernels, which
recompute the logits tile by tile so the ``[N, V]`` dlogits never reach
device memory. The outputs are lse ``[N]`` f32, dh ``[N, D]`` in h's dtype
and dE ``[V, D]`` in E's dtype (exactly V rows: padded vocab columns are
masked inside the kernels, not padded in memory).

Dispatch is by device, never by failure: CPU tensors take the plain version
(``ops/cross_entropy.py``); CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import torch

from ssi_tpu_torch import _build
from ssi_tpu_torch.constants import CROSS_ENTROPY_IGNORE_IDX
from ssi_tpu_torch.ops.cross_entropy import (
    DEFAULT_CHUNK,
    cross_entropy_de,
    cross_entropy_dh,
    cross_entropy_lse,
    fused_cross_entropy,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_D_CHUNK = 128  # the kernels stage D in chunks of 128 (csrc/cross_entropy.cu KC)


def _check(hidden: torch.Tensor, embed: torch.Tensor, labels: torch.Tensor | None = None) -> None:
    if hidden.dim() != 2 or embed.dim() != 2 or hidden.shape[1] != embed.shape[1]:
        raise ValueError(f"cross entropy takes hidden [N, D] and embed [V, D], got {tuple(hidden.shape)} "
                         f"and {tuple(embed.shape)}")
    if labels is not None and tuple(labels.shape) != (hidden.shape[0],):
        raise ValueError(f"labels must be [N] = {(hidden.shape[0],)}, got {tuple(labels.shape)}")


def _launch_args(hidden, embed):
    """Check what the kernels take; (dtype code, h, E, stream)."""
    if hidden.dtype not in _DTYPE_CODES or embed.dtype != hidden.dtype:
        raise TypeError(f"the cross-entropy kernels take f32 or bf16 hidden/embed of one dtype, got "
                        f"{hidden.dtype}/{embed.dtype}")
    d = hidden.shape[1]
    if d % _D_CHUNK != 0:
        raise ValueError(f"the cross-entropy kernels need D a multiple of {_D_CHUNK}, got {d}")
    if hidden.device != embed.device:
        raise ValueError("hidden and embed must be on one device")
    return (_DTYPE_CODES[hidden.dtype], hidden.contiguous(), embed.contiguous(),
            torch.cuda.current_stream(hidden.device).cuda_stream)


def cross_entropy_lse_kernel(hidden: torch.Tensor, embed: torch.Tensor,
                             chunk_size: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Row logsumexp of ``hidden @ embed.T``, ``[N]`` f32. ``chunk_size`` is
    the plain version's token chunk (CPU)."""
    _check(hidden, embed)
    if not hidden.is_cuda:
        return cross_entropy_lse(hidden, embed, chunk_size)
    n, d = hidden.shape
    v = embed.shape[0]
    code, h, e, stream = _launch_args(hidden, embed)
    # the vocab is split across blocks; the merge pass combines the splits in a fixed order
    lib = _build.load_library()
    n_split = lib.ssi_cross_entropy_lse_splits(n, v)
    m_part = torch.empty((n_split, n), dtype=torch.float32, device=h.device)
    l_part = torch.empty_like(m_part)
    lse = torch.empty((n,), dtype=torch.float32, device=h.device)
    err = lib.ssi_cross_entropy_lse(
        code, h.data_ptr(), e.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), lse.data_ptr(), n, v, d, n_split,
        stream)
    _build.check_launch("cross_entropy_lse", err)
    return lse


def _grad_kernel(name: str, rows_are_tokens: bool, hidden, embed, labels, lse, g) -> torch.Tensor:
    n, d = hidden.shape
    v = embed.shape[0]
    code, h, e, stream = _launch_args(hidden, embed)
    lab = labels.to(device=h.device, dtype=torch.int32).contiguous()
    lse = lse.to(device=h.device, dtype=torch.float32).contiguous()
    g = torch.as_tensor(g, dtype=torch.float32, device=h.device).reshape(1).contiguous()
    out = torch.empty((n if rows_are_tokens else v, d), dtype=h.dtype, device=h.device)
    err = _build.load_library().ssi_cross_entropy_grad(
        code, int(rows_are_tokens), h.data_ptr(), e.data_ptr(), lse.data_ptr(), lab.data_ptr(), g.data_ptr(),
        out.data_ptr(), n, v, d, stream)
    _build.check_launch(name, err)
    return out


def cross_entropy_dh_kernel(hidden, embed, labels, lse, g, chunk_size: int = DEFAULT_CHUNK) -> torch.Tensor:
    """dh = ((softmax - onehot) * valid * g) @ E, ``[N, D]`` in h's dtype,
    from the forward's ``lse``. The plain version (CPU) recomputes the softmax
    itself and takes no lse."""
    _check(hidden, embed, labels)
    if not hidden.is_cuda:
        return cross_entropy_dh(hidden, embed, labels, g, chunk_size)
    return _grad_kernel("cross_entropy_dh", True, hidden, embed, labels, lse, g)


def cross_entropy_de_kernel(hidden, embed, labels, lse, g, chunk_size: int = DEFAULT_CHUNK) -> torch.Tensor:
    """dE = ((softmax - onehot) * valid * g)^T @ h, ``[V, D]`` in E's dtype."""
    _check(hidden, embed, labels)
    if not hidden.is_cuda:
        return cross_entropy_de(hidden, embed, labels, g, chunk_size)
    return _grad_kernel("cross_entropy_de", False, hidden, embed, labels, lse, g)


class _CrossEntropyKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, embed, labels):
        lse = cross_entropy_lse_kernel(hidden, embed)
        valid = labels != CROSS_ENTROPY_IGNORE_IDX
        safe = torch.where(valid, labels, 0).long()
        # picked logit by a row gather: N x D reads, f32 products and sum
        picked = (hidden.float() * embed[safe].float()).sum(dim=-1)
        ctx.save_for_backward(hidden, embed, labels, lse)
        return torch.where(valid, lse - picked, 0.0).sum()

    @staticmethod
    def backward(ctx, g):
        hidden, embed, labels, lse = ctx.saved_tensors
        dh = cross_entropy_dh_kernel(hidden, embed, labels, lse, g) if ctx.needs_input_grad[0] else None
        de = cross_entropy_de_kernel(hidden, embed, labels, lse, g) if ctx.needs_input_grad[1] else None
        return dh, de, None


def fused_cross_entropy_kernel(
    hidden: torch.Tensor,
    embed: torch.Tensor,
    labels: torch.Tensor,
    chunk_size: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """Sum of NLL over labels != -100 (scalar f32), differentiable in hidden
    and embed: the kernels on CUDA tensors, the plain chunked version (token
    chunk ``chunk_size``) on CPU tensors."""
    _check(hidden, embed, labels)
    if hidden.is_cuda:
        return _CrossEntropyKernel.apply(hidden, embed, labels)
    return fused_cross_entropy(hidden, embed, labels, chunk_size)
