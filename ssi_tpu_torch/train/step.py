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

Across ranks (``layout``: a ``parallel.StateLayout`` over a dp x tp mesh;
the JAX step's ``state_shardings`` and its global arrays) each dp column
runs its own rows, and its tp ranks run the same rows on their slices:

- the forward and backward take the tensor-parallel collectives
  (``layout.tensor_parallel()``: ``copy_to_tp`` / ``reduce_from_tp`` around
  the split sub-layers, the masked embedding lookup, and the vocab-parallel
  cross-entropy where the output matrix is split), so the loss, the token
  counts and every gradient of a leaf that is whole over tp are the same on
  each tp rank of a column;
- the window's loss sum, token count and token-type counts are summed over
  the rank's dp column by one all-reduce before anything divides by the
  count, so every rank scales, skips a zero-token window and logs alike;
- gradients are all-reduced over the dp column for plain DP; a leaf whose
  moments are dp-sharded (ZeRO-1) has its gradient reduce-scattered into
  this rank's slice, and a dp-sharded resident parameter (FSDP) gets its
  slice from the forward's gathers in the backward;
- the global norm sums each leaf's squares over the ranks that hold
  distinct pieces of it (over tp, then over dp; a leaf whole on every rank
  counts once), then adds the leaves in order; clip and AdamW run on the
  slices, each keyed by its place in the whole leaf, and ZeRO-1 all-gathers
  the fresh parameters over the dp column.

At one rank no leaf is sharded and every collective is the identity, so
the step is the single-device one, bit for bit.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ssi_tpu_torch.constants import CROSS_ENTROPY_IGNORE_IDX
from ssi_tpu_torch.models.configs import ConfigLlama3_2
from ssi_tpu_torch.models.llama3 import forward, gather_leaf
from ssi_tpu_torch.ops.cross_entropy_cuda import fused_cross_entropy_kernel, vocab_parallel_cross_entropy
from ssi_tpu_torch.parallel import Mesh, StateLayout, gather, reduce_scatter
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
    shards: dict[str, Any] | None = None,
    tp: Any = None,
) -> Callable:
    """(params, tokens [B,S], labels [B,S], segment_ids?, positions?) ->
    (loss_sum f32, num_tokens i32), this rank's rows only.

    The hidden states go through the output matrix (the tied ``embed`` or
    ``lm_head``) into the fused cross-entropy: the kernels on CUDA, the plain
    chunked version (token chunk ``chunk_size``) on the CPU. With
    ``segment_ids``/``positions`` (packed rows) attention stays within
    segments and the label shift stops at pack boundaries. ``shards``
    (FSDP, ``StateLayout.fsdp_shards``): ``params`` holds this rank's dp
    shards, and each leaf is gathered whole where it is consumed. ``tp``
    (``StateLayout.tensor_parallel``): ``params`` holds this rank's tp
    slices; where the output matrix is a vocabulary slice the loss is the
    vocab-parallel cross-entropy, and the loss is the whole one on every tp
    rank.
    """

    def loss_fn(params, tokens, labels, segment_ids=None, positions=None):
        if shards is not None:
            params = {**params, **{k: gather_leaf(v, shards[k]) for k, v in params.items() if k != "layers"}}
        hidden = forward(params, tokens, model_cfg, positions=positions, segment_ids=segment_ids,
                         remat=remat, shards=None if shards is None else shards["layers"], tp=tp)
        y = (shift_labels(labels) if segment_ids is None else shift_labels_packed(labels, segment_ids)).reshape(-1)
        h = hidden.reshape(-1, hidden.shape[-1])
        out = params.get("lm_head", params["embed"])
        if tp is not None and tp.head:
            loss_sum = vocab_parallel_cross_entropy(tp.enter(h), out, y, tp.mesh, chunk_size)
        else:
            loss_sum = fused_cross_entropy_kernel(h, out, y, chunk_size)
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


def _all_reduce_counts(values: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Sum 0-d values over the rank's dp column in one all-reduce, each back
    in its dtype (the tp ranks of a column hold the same values). They cross
    as f64: exact for the int32 counts, and for two ranks an f32 sum rounded
    once, as an f32 add rounds it."""
    v = torch.stack([x.to(torch.float64) for x in values])
    dist.all_reduce(v, group=mesh.dp_group)
    return [r.to(x.dtype) for r, x in zip(v.unbind(), values)]


def _leaf_sums_reducer(layout: StateLayout, m_dims: list, tp_dims: list) -> Callable[[list], list]:
    """The global norm's per-leaf sums of squares, each a whole leaf's: a
    leaf's pieces are summed over exactly the ranks that hold distinct ones
    (one all-reduce of the vector over the tp block, then one over the dp
    column), a piece that several ranks hold alike counted on the first of
    them alone."""
    mesh = layout.mesh
    if all(m is None and t is None for m, t in zip(m_dims, tp_dims)):
        return lambda sums: sums
    mask = [(t is not None or mesh.tp_rank == 0) and (m is not None or mesh.dp_rank == 0)
            for m, t in zip(m_dims, tp_dims)]

    def reduce(sums: list[torch.Tensor]) -> list[torch.Tensor]:
        v = torch.stack(sums)
        if not all(mask):
            v = v * torch.tensor(mask, dtype=v.dtype, device=v.device)
        if mesh.tp_group is not None and any(t is not None for t in tp_dims):
            dist.all_reduce(v, group=mesh.tp_group)
        dist.all_reduce(v, group=mesh.dp_group)
        return list(v.unbind())

    return reduce


def sync_grads(grads: list[torch.Tensor], layout: StateLayout) -> list[torch.Tensor]:
    """A window's gradients (sorted-leaf order) summed over the rank's dp
    column, each leaf in its moments' layout: all-reduced, or (ZeRO-1)
    reduce-scattered into this rank's slice; a dp-sharded parameter's
    (FSDP) was reduced by the backward."""
    out = []
    for g, pd, md in zip(grads, tree_leaves(layout.params), tree_leaves(layout.moments)):
        if pd is None and md is not None:
            g = reduce_scatter(g, md, layout.mesh)
        elif pd is None:
            dist.all_reduce(g, group=layout.mesh.dp_group)
        out.append(g)
    return out


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
    layout: StateLayout | None = None,
) -> Callable[..., tuple[TrainState, dict[str, Any]]]:
    """Build the optimizer-step function ``(state, tokens [A,B,S], labels
    [A,B,S], segment_ids?, positions?) -> (state, metrics)``, A being the
    accumulation window. ``state`` is updated in place and returned.

    Metrics: ``loss_sum`` (f32), ``num_tokens`` (i32), ``grad_norm`` (f32; NaN
    without clipping), ``lr`` (f32), ``applied`` (bool), and ``token_counts``
    when ``token_type_ranges`` is given; with ``layout`` (a process group is
    up) each is the sum over the dp column (the whole batch), as the JAX
    step's global arrays are, and the same on every rank.
    """
    tp = None if layout is None else layout.tensor_parallel()
    loss_fn = make_loss_fn(model_cfg, remat=remat, chunk_size=chunk_size,
                           shards=None if layout is None else layout.fsdp_shards(), tp=tp)
    if layout is not None:
        norm_reduce = _leaf_sums_reducer(layout, tree_leaves(layout.moments), tree_leaves(layout.tp))

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
        counts = None if token_type_ranges is None else count_token_types_device(tokens, token_type_ranges, pad_id)

        with torch.no_grad():
            if layout is not None:
                names = [] if counts is None else sorted(counts)
                loss_sum, num_tokens, *summed = _all_reduce_counts([loss_sum, num_tokens, *(counts[k] for k in names)],
                                                                   layout.mesh)
                counts = dict(zip(names, summed)) if counts is not None else None
                grads = sync_grads(grads, layout)
            n_tokens = int(num_tokens)  # host sync: the update below depends on it
            # The JAX step's f32 arithmetic after accumulation: g / denom promotes a
            # bf16 leaf to f32, and the norm, the clip and AdamW read those f32 values.
            # Each reads them leaf by leaf (window_grad); the sums stay as accumulated.
            denom = float(max(n_tokens, 1))
            grads = tree_unflatten(params, grads)
            if clip_grad_norm is not None:
                grad_norm = global_norm(grads, denom, reduce=None if layout is None else norm_reduce)
                clip = clip_factor(grad_norm, float(clip_grad_norm))
            else:
                grad_norm = torch.tensor(float("nan"), dtype=torch.float32, device=tokens.device)
                clip = 1.0
            lr = lr_schedule(state["step"])
            applied = n_tokens > 0  # zero-token window: no update, no step advance
            if applied:
                if layout is None:
                    adamw_update(grads, state["opt_state"], params, lr, opt_cfg, denom=denom, clip=clip)
                else:
                    _sharded_update(grads, state["opt_state"], params, lr, opt_cfg, denom, clip, layout)
                state["step"] += 1

        metrics = {
            "loss_sum": loss_sum,
            "num_tokens": num_tokens,
            "grad_norm": grad_norm,
            "lr": torch.tensor(lr, dtype=torch.float32),
            "applied": torch.tensor(applied),
        }
        if counts is not None:
            metrics["token_counts"] = counts
        return state, metrics

    return train_step


def _sharded_update(grads, opt_state, params, lr, opt_cfg, denom, clip, layout) -> None:
    """AdamW on each rank's slices: a ZeRO-1 leaf updates the slice of its
    (dp-whole) parameter that its moments cover, then gathers the fresh
    parameter over the dp column; an FSDP leaf updates its resident slice; a
    leaf whole over dp updates whole, alike on every rank of the column.
    Each piece passes where it lies in the whole leaf (its tp and dp
    offsets), so that stochastic rounding rounds it as the whole leaf."""
    mesh = layout.mesh
    p_dims, m_dims = tree_leaves(layout.params), tree_leaves(layout.moments)
    where = [None if o is None else (tuple(shape), o)
             for o, shape in zip(tree_leaves(layout.offsets(layout.moments)), tree_leaves(layout.shapes))]
    views = []
    for p, pd, md in zip(tree_leaves(params), p_dims, m_dims):
        n = None if md is None else p.shape[md] // mesh.dp
        views.append(p.narrow(md, mesh.dp_rank * n, n) if pd is None and md is not None else p)
    adamw_update(grads, opt_state, tree_unflatten(params, views), lr, opt_cfg, denom=denom, clip=clip, where=where)
    for p, view, pd, md in zip(tree_leaves(params), views, p_dims, m_dims):
        if pd is None and md is not None:
            p.copy_(gather(view, md, mesh))


def make_eval_step(
    model_cfg: ConfigLlama3_2,
    *,
    chunk_size: int = 1024,
    layout: StateLayout | None = None,
) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """Dev-loss step ``(params, tokens [B,S], labels [B,S], segment_ids?,
    positions?) -> (loss_sum, n_tokens)``: no remat, no gradient, no state.
    With ``layout`` both are summed over the dp column (each column its
    rows, its tp ranks the same ones)."""
    loss_fn = make_loss_fn(model_cfg, remat=False, chunk_size=chunk_size,
                           shards=None if layout is None else layout.fsdp_shards(),
                           tp=None if layout is None else layout.tensor_parallel())

    @torch.no_grad()
    def eval_step(params, tokens, labels, segment_ids=None, positions=None):
        loss_sum, n_tokens = loss_fn(params, tokens, labels, segment_ids, positions)
        if layout is None:
            return loss_sum, n_tokens
        return tuple(_all_reduce_counts([loss_sum, n_tokens], layout.mesh))

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
