"""Llama 3.2 decoder (tied embeddings, optional untied ``lm_head``) in PyTorch.

Port of ``ssi_tpu/models/llama3.py``. The parameter dictionary keeps the JAX
package's keys and layouts — layer-stacked weights ``[L, in, out]`` used as
``x @ w``, ``embed [V, D]`` — so ``params_from_numpy`` carries a JAX tree
across unchanged and the parity tests compare like with like. ``forward`` is
the full-sequence pass that training differentiates (flash attention on
CUDA, optional per-layer rematerialization); the paged serving passes live in
``generate/paged.py``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ssi_tpu_torch.models.configs import ConfigLlama3_2
from ssi_tpu_torch.models.rope import apply_rope, rope_cos_sin
from ssi_tpu_torch.ops.attention import dispatch_attention

Params = dict[str, Any]

# The JAX package's remat specs. "full" and "none" are ported; the selective
# save_* policies (named residuals kept through the backward) are not yet.
REMAT_POLICIES = ("full", "none", "save_qkv", "save_mlp", "save_qkv_mlp", "save_qkv_mlp_attn")


def _remat_layers(remat: bool | str) -> bool:
    """Whether ``forward`` checkpoints each layer (``ssi_tpu`` ``_remat_policy``)."""
    if isinstance(remat, bool):
        return remat
    if remat in ("full", "none"):
        return remat == "full"
    if remat in REMAT_POLICIES:
        raise NotImplementedError(f"remat policy {remat!r} is not ported yet (ROADMAP A7: the selective "
                                  "save_* remat policies); use 'full' or 'none'")
    raise ValueError(f"Unknown remat policy {remat!r}; expected one of {REMAT_POLICIES} or bool")


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    normed = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (normed * weight.to(torch.float32)).to(x.dtype)


def rope_for_positions(positions: torch.Tensor, cfg: ConfigLlama3_2) -> tuple[torch.Tensor, torch.Tensor]:
    return rope_cos_sin(
        positions,
        cfg.head_dim,
        rope_base=cfg.rope_base,
        scale_factor=cfg.scale_factor,
        low_freq_factor=cfg.rope_low_freq_factor,
        high_freq_factor=cfg.rope_high_freq_factor,
        original_max_seq_len=cfg.rope_original_max_seq_len,
    )


def block(h, layer, cos, sin, cfg: ConfigLlama3_2, attend) -> torch.Tensor:
    """One decoder layer over ``h [B, T, D]``; ``attend(q, k, v)`` returns
    ``[B, T, Hq, hd]`` (and may write K/V elsewhere as a side effect)."""
    b, t, _ = h.shape
    hd = cfg.head_dim
    x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
    q = apply_rope((x @ layer["wq"]).view(b, t, cfg.num_heads, hd), cos, sin)
    k = apply_rope((x @ layer["wk"]).view(b, t, cfg.num_kv_heads, hd), cos, sin)
    v = (x @ layer["wv"]).view(b, t, cfg.num_kv_heads, hd)
    attn = attend(q, k, v)
    h = h + attn.reshape(b, t, cfg.num_heads * hd).to(h.dtype) @ layer["wo"]
    x = rms_norm(h, layer["mlp_norm"], cfg.norm_eps)
    return h + (F.silu(x @ layer["w_gate"]) * (x @ layer["w_up"])) @ layer["w_down"]


def layer_params(params: Params, l: int) -> Params:
    """Layer ``l``'s weights: views into the stacked ``[L, ...]`` tensors."""
    return {name: w[l] for name, w in params["layers"].items()}


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: ConfigLlama3_2,
    *,
    positions: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    remat: bool | str = True,
) -> torch.Tensor:
    """Run the decoder; returns final-normed hidden states ``[B, S, D]``.

    ``remat``: True or "full" runs each layer under
    ``torch.utils.checkpoint`` (non-reentrant: the backward recomputes the
    layer from its input); False or "none" keeps every activation; the
    selective ``save_*`` policies raise ``NotImplementedError``. The
    attention is :func:`dispatch_attention`: the flash kernels on CUDA, the
    plain attention on the CPU.
    """
    checkpointed = _remat_layers(remat)
    b, s = tokens.shape
    h = params["embed"][tokens]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :].expand(b, s)
    cos, sin = rope_for_positions(positions, cfg)

    def attend(q, k, v):
        return dispatch_attention(q, k, v, causal=True, segment_ids=segment_ids)

    # one unbind per stacked weight: its backward stacks the layers' grads in
    # one pass, where per-layer indexing would sum L full-size zero-padded grads
    names = list(params["layers"])
    for weights in zip(*(params["layers"][n].unbind(0) for n in names)):
        layer = dict(zip(names, weights))
        if checkpointed:
            h = checkpoint(block, h, layer, cos, sin, cfg, attend, use_reentrant=False)
        else:
            h = block(h, layer, cos, sin, cfg, attend)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def unembed(params: Params) -> torch.Tensor:
    """The output projection ``[V, D]``: the tied embedding or the untied ``lm_head``."""
    return params.get("lm_head", params["embed"])


def logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Output projection with f32 logits (f32 accumulation for bf16 weights)."""
    w = unembed(params)
    h2 = hidden.reshape(-1, hidden.shape[-1])
    if w.dtype == torch.float32:
        out = h2.to(torch.float32) @ w.t()
    elif h2.is_cuda:
        # bf16 operands, f32 result without materializing an f32 copy of the
        # 133k x D matrix per step (JAX: preferred_element_type=float32)
        out = torch.mm(h2.to(w.dtype), w.t(), out_dtype=torch.float32)
    else:
        out = h2.to(torch.float32) @ w.to(torch.float32).t()
    return out.view(*hidden.shape[:-1], w.shape[0])


def init_params(
    cfg: ConfigLlama3_2,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cuda",
) -> Params:
    """Random small-normal initialization from ``seed``, drawn with a
    ``torch.Generator`` on ``device`` (the card unless the caller names the
    CPU; a 1B tree initializes on the card in well under a second). Not
    bitwise equal to the JAX ``init_params``: tests carry JAX parameters
    across with :func:`params_from_numpy` instead."""
    d, f, hd = cfg.embed_dim, cfg.intermediate_dim, cfg.head_dim
    hq, hkv, nl, v = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers, cfg.vocab_size
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def norm_init(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * fan_in**-0.5).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params: Params = {
        "embed": norm_init((v, d), d),
        "layers": {
            "attn_norm": ones((nl, d)),
            "wq": norm_init((nl, d, hq * hd), d),
            "wk": norm_init((nl, d, hkv * hd), d),
            "wv": norm_init((nl, d, hkv * hd), d),
            "wo": norm_init((nl, hq * hd, d), d),
            "mlp_norm": ones((nl, d)),
            "w_gate": norm_init((nl, d, f), d),
            "w_up": norm_init((nl, d, f), d),
            "w_down": norm_init((nl, f, d), f),
        },
        "final_norm": ones((d,)),
    }
    if not cfg.tied_embeddings:
        params["lm_head"] = norm_init((v, d), d)
    return params


def params_from_numpy(tree: Any, device: torch.device | str = "cuda", dtype: torch.dtype | None = None) -> Any:
    """A JAX parameter tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``) -> the port's tensors on ``device`` (the card unless the caller
    names the CPU), same keys and layouts. ml_dtypes bf16 arrays cross
    through a uint16 view; ``dtype`` optionally casts."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


class Llama3(torch.nn.Module):
    """Thin serving module over the functional model: holds the parameter
    dictionary (layer-stacked, JAX layout) as frozen parameters; ``forward``
    -> f32 logits. Training differentiates the functional :func:`forward`
    over a plain dictionary instead (``train/step.py``)."""

    def __init__(self, params: Params, cfg: ConfigLlama3_2):
        super().__init__()
        self.cfg = cfg

        def frozen(t: torch.Tensor) -> torch.nn.Parameter:
            return torch.nn.Parameter(t, requires_grad=False)

        self.top = torch.nn.ParameterDict({k: frozen(v) for k, v in params.items() if k != "layers"})
        self.layers = torch.nn.ParameterDict({k: frozen(v) for k, v in params["layers"].items()})

    @property
    def params(self) -> Params:
        return {**self.top, "layers": dict(self.layers)}

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        params = self.params
        return logits(params, forward(params, tokens, self.cfg, remat=False))
