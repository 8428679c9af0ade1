"""First-party AdamW with explicit per-buffer dtypes: port of
``ssi_tpu/train/optimizer.py``.

Plain torch ops over a parameter tree (nested dicts of tensors), not
``torch.optim.AdamW``: the moment dtypes are explicit (first moment bf16 by
default, second moment f32), the update math is always f32, and the state is
a plain tree for the checkpoint. Semantics match torch.optim.AdamW (decoupled
weight decay, bias correction, eps added after the bias-corrected sqrt).

Unlike the JAX version, which returns new trees, :func:`adamw_update` and
:func:`clip_by_global_norm` update their tensors IN PLACE: a 1B-scale tree
and its moments are gigabytes, and nothing keeps the old values. Leaves are
visited in sorted-key order, as ``jax.tree.flatten`` visits dicts, so leaf
indices agree with the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 2e-4  # base lr; the schedule overrides per step
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    mu_dtype: torch.dtype = torch.bfloat16
    nu_dtype: torch.dtype = torch.float32
    # Stochastic rounding when storing moments in bf16: round-to-nearest drops
    # moment updates below ~0.4% of the stored value; rounding up or down with
    # probability proportional to the remainder keeps the expected value.
    # Deterministic given the step counter (resume-safe).
    stochastic_rounding: bool = False

    @classmethod
    def from_cfg(cls, cfg_optimizer: Any) -> "AdamWConfig":
        """From the ``optimizer`` config node (``conf/training.yaml``)."""
        betas = cfg_optimizer.get("betas", [0.9, 0.999])
        dtype_map = {"bf16": torch.bfloat16, "fp32": torch.float32}
        return cls(
            lr=float(cfg_optimizer.lr),
            b1=float(betas[0]),
            b2=float(betas[1]),
            eps=float(cfg_optimizer.get("eps", 1e-8)),
            weight_decay=float(cfg_optimizer.get("weight_decay", 0.01)),
            mu_dtype=dtype_map[cfg_optimizer.get("mu_dtype", "bf16")],
            nu_dtype=dtype_map[cfg_optimizer.get("nu_dtype", "fp32")],
            stochastic_rounding=bool(cfg_optimizer.get("stochastic_rounding", False)),
        )


def tree_leaves(tree: Params) -> list[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (``jax.tree.flatten``'s)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable, tree: Params) -> Params:
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    return fn(tree)


def tree_unflatten(like: Params, leaves: list) -> Params:
    """A tree shaped like ``like`` holding ``leaves`` (in sorted-key order)."""
    return _build(like, iter(leaves))


def _build(node: Params, it) -> Params:
    # a module function, not a recursive closure: a closure that calls itself
    # is a reference cycle, and it kept the leaves (a step's gradients) alive
    # until the garbage collector ran
    if isinstance(node, dict):
        return {key: _build(node[key], it) for key in sorted(node)}
    return next(it)


_M32 = 0xFFFFFFFF
_NOISE_CHUNK = 1 << 22  # elements a noise draw covers at once: bounds its int64 temporaries


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``x`` in [0, 2**32) in int64, without overflow."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (lowbias32) of int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _round_key(count: int, leaf: int, moment: int) -> tuple[int, int]:
    """The rounding noise's key, from (step count, leaf index, moment)."""
    seed = ((0x5AD * 1_000_003 + count) * 1_000_003 + leaf) * 2 + moment
    return seed & _M32, (seed >> 32) & _M32


def _element_index(shape: tuple[int, ...], where: tuple | None, rows: slice, device) -> torch.Tensor:
    """The flat index in the whole leaf of rows ``rows`` (of dim 0) of a piece
    of shape ``shape``: the whole leaf when ``where`` is None, else the piece
    ``where = (full shape, start per dimension)`` of it."""
    full, starts = where if where is not None else (shape, (0,) * len(shape))
    stride = 1
    index = torch.zeros((), dtype=torch.int64, device=device)
    for d in reversed(range(len(full))):
        lo, n = (rows.start, rows.stop - rows.start) if d == 0 else (0, shape[d])
        axis = (torch.arange(n, dtype=torch.int64, device=device) + lo + starts[d]) * stride
        index = index + axis.view(n, *([1] * (len(full) - 1 - d)))
        stride *= full[d]
    return index


def _stochastic_round_bf16(buf: torch.Tensor, x32: torch.Tensor, key: tuple[int, int], where: tuple | None) -> None:
    """``buf`` (bf16) := ``x32`` stochastically rounded: add uniform low 16
    bits, truncate. The noise of each element is a hash of its index in the
    whole leaf and ``key``, so a shard of the leaf (``where``) rounds as the
    whole leaf rounds that slice, whatever the number of shards."""
    n0 = x32.shape[0]
    per_row = max(1, x32[0].numel())
    step = max(1, _NOISE_CHUNK // per_row)
    for r in range(0, n0, step):
        rows = slice(r, min(n0, r + step))
        index = _element_index(tuple(x32.shape), where, rows, x32.device)
        noise = _mix32(_mix32((index & _M32) ^ key[0]) ^ ((index >> 32) ^ key[1]))
        bits = (x32[rows].contiguous().view(torch.int32).to(torch.int64) & _M32) + (noise & 0xFFFF)
        bits = bits & 0xFFFF0000  # the f32's pattern, unsigned, low 16 bits cleared
        rounded = (bits - ((bits >> 31) << 32)).to(torch.int32)  # the same bits as a signed int32
        buf[rows].copy_(rounded.view(torch.float32).to(torch.bfloat16))


def init_opt_state(params: Params, cfg: AdamWConfig) -> dict[str, Any]:
    return {
        "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.mu_dtype, device=p.device), params),
        "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.nu_dtype, device=p.device), params),
        "count": 0,
    }


def window_grad(g: torch.Tensor, denom: float = 1.0, clip: float = 1.0) -> torch.Tensor:
    """One leaf of a window's gradient as the norm and AdamW read it:
    ``g / denom``, then times ``clip``, in f32 whatever ``g``'s dtype. The JAX
    step divides by an f32 ``denom``, which promotes a bf16 leaf to f32, and
    clips those f32 values; a new tensor, ``g`` is left as it is."""
    g32 = g.float() / denom
    return g32 if clip == 1.0 else g32 * clip


@torch.no_grad()
def adamw_update(grads: Params, opt_state: dict[str, Any], params: Params, lr: float, cfg: AdamWConfig, *,
                 denom: float = 1.0, clip: float = 1.0, where: list | None = None) -> None:
    """One AdamW step, in place on ``params`` and ``opt_state`` (``count``
    advances by one). Each gradient leaf is read as ``window_grad(g, denom,
    clip)``: the train step passes the window's token count and clip factor,
    so the f32 gradient exists one leaf at a time, never as a copy of the
    tree. Math in f32; the moments are stored in the configured dtypes, the
    parameters in their own.

    The leaves may be pieces of the whole ones (tp and dp slices; ``where``,
    per leaf in sorted-leaf order: None for a whole leaf, else ``(full
    shape, start per dimension)`` of the piece): the update is elementwise,
    and the stochastic rounding's noise is drawn per element of the whole
    leaf, so the pieces of a leaf update, bit for bit, as the whole leaf
    does, however it is cut."""
    count = opt_state["count"] + 1
    c = torch.tensor(float(count), dtype=torch.float32)
    bias_c1 = float(1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** c)  # f32, as the JAX update computes it
    bias_c2 = float(1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** c)
    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"]))
    for i, (p, g, mu, nu) in enumerate(leaves):
        g32 = window_grad(g, denom, clip)
        mu32 = cfg.b1 * mu.float() + (1.0 - cfg.b1) * g32
        nu32 = cfg.b2 * nu.float() + (1.0 - cfg.b2) * (g32 * g32)
        rms = torch.sqrt(nu32 / bias_c2) + cfg.eps
        p32 = p.float()
        p.copy_(p32 - lr * (mu32 / bias_c1 / rms + cfg.weight_decay * p32))
        for m, (buf, x32, dtype) in enumerate(((mu, mu32, cfg.mu_dtype), (nu, nu32, cfg.nu_dtype))):
            if cfg.stochastic_rounding and dtype == torch.bfloat16:
                _stochastic_round_bf16(buf, x32, _round_key(count, i, m), where[i] if where is not None else None)
            else:
                buf.copy_(x32)
    opt_state["count"] = count


def global_norm(tree: Params, denom: float = 1.0, reduce: Callable[[list], list] | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf divided by ``denom``
    (``window_grad``), f32, one leaf at a time. ``reduce`` maps the per-leaf
    sums to the whole leaves' (the dp step sums a sharded leaf's over its
    shards) before they are added in leaf order."""
    sums = [torch.sum(torch.square(window_grad(x, denom))) for x in tree_leaves(tree)]
    return torch.sqrt(sum(sums if reduce is None else reduce(sums)))


def clip_factor(norm: torch.Tensor, max_norm: float) -> float:
    """``min(1, max_norm / (norm + 1e-6))`` in f32, as a Python number: a 0-d
    f32 tensor would be rounded to a bf16 leaf's dtype before a multiply."""
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0).item()


@torch.no_grad()
def clip_by_global_norm(tree: Params, max_norm: float) -> torch.Tensor:
    """torch.nn.utils.clip_grad_norm_ semantics, in place: every leaf times
    ``clip_factor``, in its own dtype. Returns the norm before clipping."""
    norm = global_norm(tree)
    scale = clip_factor(norm, max_norm)
    for x in tree_leaves(tree):
        x.mul_(scale)
    return norm
