"""Rotary position embeddings with Llama-3 frequency scaling (rotate-half).

Port of ``ssi_tpu/models/rope.py``: same NTK-by-parts frequency table, same
rotate-half convention (HF-layout q/k weights need no permutation), f32 math.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _scaled_inv_freq(
    head_dim: int,
    rope_base: float,
    scale_factor: float,
    low_freq_factor: float,
    high_freq_factor: float,
    original_max_seq_len: int,
) -> tuple[float, ...]:
    """Llama-3 RoPE frequency scaling (NTK-by-parts)."""
    inv_freq = 1.0 / (rope_base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if not scale_factor or scale_factor == 1:
        return tuple(inv_freq.tolist())
    low_freq_wavelen = original_max_seq_len / low_freq_factor
    high_freq_wavelen = original_max_seq_len / high_freq_factor
    scaled = []
    for f in inv_freq:
        wavelen = 2 * math.pi / f
        if wavelen < high_freq_wavelen:
            scaled.append(f)
        elif wavelen > low_freq_wavelen:
            scaled.append(f / scale_factor)
        else:
            smooth = (original_max_seq_len / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
            scaled.append((1 - smooth) * f / scale_factor + smooth * f)
    return tuple(scaled)


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    rope_base: float = 500_000.0,
    scale_factor: float = 32.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_seq_len: int = 8192,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[..., head_dim]`` for integer ``positions [...]``
    (half-frequencies duplicated across the two halves)."""
    inv_freq = torch.tensor(
        _scaled_inv_freq(
            head_dim, float(rope_base), float(scale_factor), low_freq_factor, high_freq_factor, original_max_seq_len
        ),
        dtype=torch.float32,
        device=positions.device,
    )
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. x: ``[..., S, n_heads, head_dim]``; cos/sin: ``[..., S, head_dim]``."""
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.to(torch.float32) * cos + rotated.to(torch.float32) * sin).to(x.dtype)
