"""Train and eval steps — the device side of training: port of
``ssi_tpu/train/step.py``.

One call of the train step consumes a whole accumulation window
``[accum, batch, seq]``: each micro-batch runs forward and backward (flash
attention and the fused cross-entropy kernels on CUDA, their plain versions
on the CPU), then the window's gradients are scaled by 1/num_tokens,
optionally clipped by global norm, and applied by AdamW at ``schedule(step)``.
Semantics kept from the JAX step:

- per-micro-batch loss = sum of NLL over non-ignored (shifted) labels;
- one micro-batch keeps its gradients in the parameter dtype; a longer window
  accumulates them in ``grad_accum_dtype`` (f32 by default); the scaling by
  1/num_tokens, the global norm, the clip and AdamW then run in f32 whatever
  that dtype;
- a window with zero non-ignored tokens applies no update and does not advance
  ``step`` (checked on the host here; the JAX step uses ``lax.cond``);
- token-type accounting over vocab ranges runs on the device.

There is no ``jit`` and no donation: PyTorch runs eagerly, and the state
``{"params", "opt_state", "step"}`` is updated in place.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import numpy as np
import torch

from ssi_tpu_torch.constants import CROSS_ENTROPY_IGNORE_IDX
from ssi_tpu_torch.models.configs import ConfigLlama3_2
from ssi_tpu_torch.models.llama3 import forward
from ssi_tpu_torch.ops.cross_entropy_cuda import fused_cross_entropy_kernel
from ssi_tpu_torch.train.optimizer import (
    AdamWConfig,
    adamw_update,
    clip_factor,
    global_norm,
    tree_leaves,
    tree_unflatten,
)

LOGGER = logging.getLogger(__name__)

TrainState = dict[str, Any]  # {"params": tree, "opt_state": tree, "step": int}


def shift_labels(labels: torch.Tensor) -> torch.Tensor:
    """Next-token shift: label[i] := label[i+1]; the final position is ignored."""
    pad_col = torch.full((labels.shape[0], 1), CROSS_ENTROPY_IGNORE_IDX, dtype=labels.dtype, device=labels.device)
    return torch.cat([labels[:, 1:], pad_col], dim=1)


def shift_labels_packed(labels: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
    """Next-token shift that never crosses a pack boundary: positions whose
    successor belongs to another segment get the ignore index."""
    next_seg = torch.cat([segment_ids[:, 1:], torch.zeros_like(segment_ids[:, :1])], dim=1)
    return torch.where(next_seg == segment_ids, shift_labels(labels), CROSS_ENTROPY_IGNORE_IDX)


def make_loss_fn(
    model_cfg: ConfigLlama3_2,
    *,
    remat: bool | str = True,
    chunk_size: int = 1024,
) -> Callable:
    """(params, tokens [B,S], labels [B,S], segment_ids?, positions?) ->
    (loss_sum f32, num_tokens i32).

    The hidden states go through the output matrix (the tied ``embed`` or
    ``lm_head``) into the fused cross-entropy: the kernels on CUDA, the plain
    chunked version (token chunk ``chunk_size``) on the CPU. With
    ``segment_ids``/``positions`` (packed rows) attention stays within
    segments and the label shift stops at pack boundaries.
    """

    def loss_fn(params, tokens, labels, segment_ids=None, positions=None):
        hidden = forward(params, tokens, model_cfg, positions=positions, segment_ids=segment_ids,
                         remat=remat)
        y = (shift_labels(labels) if segment_ids is None else shift_labels_packed(labels, segment_ids)).reshape(-1)
        h = hidden.reshape(-1, hidden.shape[-1])
        loss_sum = fused_cross_entropy_kernel(h, params.get("lm_head", params["embed"]), y, chunk_size)
        num_tokens = (y != CROSS_ENTROPY_IGNORE_IDX).sum().to(torch.int32)
        return loss_sum, num_tokens

    return loss_fn


def count_token_types_device(
    tokens: torch.Tensor,
    ranges: dict[str, tuple[int, int]],
    pad_id: int,
) -> dict[str, torch.Tensor]:
    """Token counts per inclusive vocab range, padding (``tokens == pad_id``)
    excluded from every range; ``total`` counts the non-pad tokens."""
    real = tokens != pad_id
    counts = {name: ((tokens >= start) & (tokens <= end) & real).sum().to(torch.int32)
              for name, (start, end) in ranges.items()}
    counts["total"] = real.sum().to(torch.int32)
    return counts


def _value_and_grad(loss_fn: Callable, params, *batch):
    """(loss_sum, num_tokens, grads in sorted-leaf order, each in its leaf's dtype)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss_sum, num_tokens = loss_fn(tree_unflatten(params, leaves), *batch)
    return loss_sum.detach(), num_tokens, list(torch.autograd.grad(loss_sum, leaves))


def make_train_step(
    model_cfg: ConfigLlama3_2,
    opt_cfg: AdamWConfig,
    lr_schedule: Callable[[int], float],
    *,
    clip_grad_norm: float | None = None,
    token_type_ranges: dict[str, tuple[int, int]] | None = None,
    pad_id: int = 0,
    remat: bool | str = True,
    chunk_size: int = 1024,
    grad_accum_dtype: torch.dtype = torch.float32,
) -> Callable[..., tuple[TrainState, dict[str, Any]]]:
    """Build the optimizer-step function ``(state, tokens [A,B,S], labels
    [A,B,S], segment_ids?, positions?) -> (state, metrics)``, A being the
    accumulation window. ``state`` is updated in place and returned.

    Metrics: ``loss_sum`` (f32), ``num_tokens`` (i32), ``grad_norm`` (f32; NaN
    without clipping), ``lr`` (f32), ``applied`` (bool), and ``token_counts``
    when ``token_type_ranges`` is given.
    """
    loss_fn = make_loss_fn(model_cfg, remat=remat, chunk_size=chunk_size)

    def train_step(state: TrainState, tokens, labels, segment_ids=None, positions=None):
        params = state["params"]

        def micro(i):
            return _value_and_grad(loss_fn, params, tokens[i], labels[i],
                                   None if segment_ids is None else segment_ids[i],
                                   None if positions is None else positions[i])

        if tokens.shape[0] == 1:
            # no accumulation: the grads stay in the parameter dtype
            loss_sum, num_tokens, grads = micro(0)
        else:
            grads = [torch.zeros(p.shape, dtype=grad_accum_dtype, device=p.device) for p in tree_leaves(params)]
            loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
            num_tokens = torch.zeros((), dtype=torch.int32, device=tokens.device)
            for i in range(tokens.shape[0]):
                l_i, n_i, g_i = micro(i)
                for acc, g in zip(grads, g_i):
                    acc += g.to(grad_accum_dtype)
                del g_i
                loss_sum = loss_sum + l_i
                num_tokens = num_tokens + n_i

        with torch.no_grad():
            n_tokens = int(num_tokens)  # host sync: the update below depends on it
            # The JAX step's f32 arithmetic after accumulation: g / denom promotes a
            # bf16 leaf to f32, and the norm, the clip and AdamW read those f32 values.
            # Each reads them leaf by leaf (window_grad); the sums stay as accumulated.
            denom = float(max(n_tokens, 1))
            grads = tree_unflatten(params, grads)
            if clip_grad_norm is not None:
                grad_norm = global_norm(grads, denom)
                clip = clip_factor(grad_norm, float(clip_grad_norm))
            else:
                grad_norm = torch.tensor(float("nan"), dtype=torch.float32, device=tokens.device)
                clip = 1.0
            lr = lr_schedule(state["step"])
            applied = n_tokens > 0  # zero-token window: no update, no step advance
            if applied:
                adamw_update(grads, state["opt_state"], params, lr, opt_cfg, denom=denom, clip=clip)
                state["step"] += 1

        metrics = {
            "loss_sum": loss_sum,
            "num_tokens": num_tokens,
            "grad_norm": grad_norm,
            "lr": torch.tensor(lr, dtype=torch.float32),
            "applied": torch.tensor(applied),
        }
        if token_type_ranges is not None:
            metrics["token_counts"] = count_token_types_device(tokens, token_type_ranges, pad_id)
        return state, metrics

    return train_step


def make_eval_step(
    model_cfg: ConfigLlama3_2,
    *,
    chunk_size: int = 1024,
) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """Dev-loss step ``(params, tokens [B,S], labels [B,S], segment_ids?,
    positions?) -> (loss_sum, n_tokens)``: no remat, no gradient, no state."""
    loss_fn = make_loss_fn(model_cfg, remat=False, chunk_size=chunk_size)

    @torch.no_grad()
    def eval_step(params, tokens, labels, segment_ids=None, positions=None):
        return loss_fn(params, tokens, labels, segment_ids, positions)

    return eval_step


def compute_dataset_loss(
    eval_step: Callable,
    params: Any,
    loader: Any,
    *,
    put_batch: Callable[[dict[str, Any]], tuple[torch.Tensor, ...]] | None = None,
    log_every: int = 0,
) -> float:
    """Token-weighted mean dev loss over a loader of dict batches (numpy or
    tensors); NaN when the loader holds no label token."""
    device = params["embed"].device
    loss_running = 0.0
    num_tokens = 0
    n_batches = len(loader)
    for i, batch in enumerate(loader):
        if put_batch is not None:
            arrays = put_batch(batch)
        else:
            has_seg, has_pos = "segment_ids" in batch, "positions" in batch
            if has_seg != has_pos:
                raise ValueError("Packed batches must carry BOTH segment_ids and positions (got one without the other)")
            keys = ["tokens", "labels"] + (["segment_ids", "positions"] if has_seg else [])
            arrays = tuple(torch.as_tensor(np.asarray(batch[k])).to(device) for k in keys)
        loss_sum, ntok = eval_step(params, *arrays)
        loss_running += float(loss_sum)
        num_tokens += int(ntok)
        if log_every and (i % log_every == 0):
            LOGGER.info(f"Dev batch {i}/{n_batches} | batch loss sum {float(loss_sum):.4f}")
    if num_tokens == 0:
        return float("nan")
    return loss_running / num_tokens
