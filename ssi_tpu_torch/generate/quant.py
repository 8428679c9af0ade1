"""Weight-only int8 for the decode path — port of ``ssi_tpu/generate/quant.py``.

Per-output-channel symmetric int8 storage of the stacked layer products
(wq/wk/wv/wo/w_gate/w_up/w_down). The tied embedding stays in its dtype — it
feeds both the token gather and the final logits product, where per-vocab-row
scales would add a [V] multiply on the logits path — and the norms are tiny
and stay as they are.

``quantize_layer_weights_int8`` gives ``q`` and ``scale`` bitwise equal to the
JAX package's: the same f32 amax, round half to even and clip, and only then
the cast of the stored scale to bf16. One detail is the compiler's: XLA folds
the JAX source's ``amax / 127.0`` into a product with the f32 reciprocal of
127, so that is the arithmetic copied here (true division differs in the
last bit for about one channel in twenty, and a value at a half-step then
rounds the other way).

``matmul`` is plain torch ops, ``(x @ q.to(x.dtype)) * scale.to(x.dtype)``,
as the JAX package computes it outside any Pallas kernel. Here the cast is
its own kernel, which writes a copy of the weight in ``x.dtype`` before the
product, so on the card the int8 path reads more bytes per step than bf16
weights do; the int8 leaves themselves stay int8 on the device.

Quality: greedy outputs are NOT bitwise vs bf16 (quantization error flips
argmax near ties). Opt-in via ``quantize_weights: int8`` in the generation
config or ``PagedDecodeEngine(quantize="int8")``.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["quantize_layer_weights_int8", "matmul"]

_LAYER_MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# XLA rewrites the division by the constant 127 as a product with this f32 reciprocal
_INV_127 = 1.0 / 127.0


def _quantize_one(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer ``[in, out]`` -> (int8 ``[in, out]``, bf16 scale ``[1, out]``)."""
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=0, keepdim=True)
    scale = torch.where(amax > 0, amax * torch.tensor(_INV_127, dtype=torch.float32, device=w.device),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _quantize(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """``w [L, in, out]`` -> ``{"q": int8 [L, in, out], "scale": bf16 [L, 1, out]}``,
    one layer at a time, so the f32 transients stay at one layer's size (the
    JAX ``lax.map``)."""
    n_layers, _, d_out = w.shape
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((n_layers, 1, d_out), dtype=torch.bfloat16, device=w.device)
    for l in range(n_layers):
        q[l], scale[l] = _quantize_one(w[l])
    return {"q": q, "scale": scale}


def quantize_layer_weights_int8(params: Any) -> Any:
    """Return a parameter dictionary with the stacked layer products in int8 form.

    The quantized leaves become ``{"q": int8 [L, in, out], "scale": bf16
    [L, 1, out]}`` on the device of the weights they replace; everything else
    (embed, norms) is the same tensor. ``matmul`` dispatches on the leaf type.
    """
    out = dict(params)
    layers = dict(params["layers"])
    for name in _LAYER_MATMULS:
        layers[name] = _quantize(params["layers"][name])
    out["layers"] = layers
    return out


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for either a plain tensor or an int8 ``{"q", "scale"}`` leaf:
    ``(x @ q.to(x.dtype)) * scale.to(x.dtype)``."""
    if isinstance(w, dict):
        return (x @ w["q"].to(x.dtype)) * w["scale"].to(x.dtype)
    return x @ w
