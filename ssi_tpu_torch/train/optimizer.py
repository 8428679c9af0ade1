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


def _stochastic_round_bf16(x32: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """f32 -> bf16 with stochastic rounding: add uniform low 16 bits, truncate."""
    noise = torch.randint(0, 1 << 16, x32.shape, generator=gen, dtype=torch.int32, device=x32.device)
    rounded = (x32.contiguous().view(torch.int32) + noise) & -65536  # 0xFFFF0000
    return rounded.view(torch.float32).to(torch.bfloat16)


def _round_generator(device: torch.device, count: int, leaf: int, moment: int) -> torch.Generator:
    """The rounding noise's generator, seeded from (step count, leaf index, moment)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((0x5AD * 1_000_003 + count) * 1_000_003 + leaf) * 2 + moment)
    return gen


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
                 denom: float = 1.0, clip: float = 1.0) -> None:
    """One AdamW step, in place on ``params`` and ``opt_state`` (``count``
    advances by one). Each gradient leaf is read as ``window_grad(g, denom,
    clip)``: the train step passes the window's token count and clip factor,
    so the f32 gradient exists one leaf at a time, never as a copy of the
    tree. Math in f32; the moments are stored in the configured dtypes, the
    parameters in their own."""
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
                buf.copy_(_stochastic_round_bf16(x32, _round_generator(p.device, count, i, m)))
            else:
                buf.copy_(x32)
    opt_state["count"] = count


def global_norm(tree: Params, denom: float = 1.0) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf divided by ``denom``
    (``window_grad``), f32, one leaf at a time."""
    return torch.sqrt(sum(torch.sum(torch.square(window_grad(x, denom))) for x in tree_leaves(tree)))


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
