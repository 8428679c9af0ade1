"""Llama 3.2 decoder (tied embeddings, optional untied ``lm_head``) in PyTorch.

Port of ``ssi_tpu/models/llama3.py``. The parameter dictionary keeps the JAX
package's keys and layouts — layer-stacked weights ``[L, in, out]`` used as
``x @ w``, ``embed [V, D]`` — so ``params_from_numpy`` carries a JAX tree
across unchanged and the parity tests compare like with like. ``forward`` is
the full-sequence pass that training differentiates (flash attention on
CUDA, optional per-layer rematerialization); ``forward_slots`` is the dense
KV-cache pass of the dense engine (``generate/engine.py``); the paged
serving passes live in ``generate/paged.py``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ssi_tpu_torch.generate.quant import matmul as _mm
from ssi_tpu_torch.models.configs import ConfigLlama3_2
from ssi_tpu_torch.models.rope import apply_rope, rope_cos_sin
from ssi_tpu_torch.ops.attention import dispatch_attention
from ssi_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_given

Params = dict[str, Any]

# The JAX package's remat specs (``ssi_tpu`` ``_remat_policy``). "full"
# recomputes each layer from its input in the backward; the save_* policies
# keep named products resident so the backward skips recomputing them:
# "qkv" the q/k/v projections, "mlp" the pre-activation gate and up products,
# "attn" the flash forward's o and lse (CUDA only; the CPU's plain attention
# has no such residuals, as the JAX package's XLA attention has none).
REMAT_POLICIES = ("full", "none", "save_qkv", "save_mlp", "save_qkv_mlp", "save_qkv_mlp_attn")
_QKV = ("wq", "wk", "wv")
_MLP = ("w_gate", "w_up")
_KEPT = {
    "full": ((), False),
    "save_qkv": (_QKV, False),
    "save_mlp": (_MLP, False),
    "save_qkv_mlp": (_QKV + _MLP, False),
    "save_qkv_mlp_attn": (_QKV + _MLP, True),
}


def _remat_policy(remat: bool | str) -> tuple[tuple[str, ...], bool] | None:
    """(weights whose products a rematerialized layer keeps, keep the flash
    forward's o and lse), or None for no remat; bool is legacy full/none."""
    if isinstance(remat, bool):
        remat = "full" if remat else "none"
    if remat == "none":
        return None
    if remat not in _KEPT:
        raise ValueError(f"Unknown remat policy {remat!r}; expected one of {REMAT_POLICIES} or bool")
    return _KEPT[remat]


class _KeptProduct(torch.autograd.Function):
    """``x @ w`` in a rematerialized layer's recompute, with its output handed
    in (``kept``: the product kept from the layer's forward, or any tensor of
    its shape where the backward needs no value of it). The backward gives dx
    and dW by the two ``mm`` calls of ``x @ w``'s own backward, so a kept
    product changes no gradient bit."""

    @staticmethod
    def forward(ctx, x, w, kept):
        ctx.save_for_backward(x, w)
        return kept.detach()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        return g2.mm(w.t()).view(x.shape), x.reshape(-1, x.shape[-1]).t().mm(g2), None


def _on_flash(q: torch.Tensor) -> bool:
    """Whether the model's attention is the flash Function here (CUDA), so a
    rematerialized layer can keep its o and lse."""
    return q.is_cuda


class _RematLayer(torch.autograd.Function):
    """One decoder layer whose backward recomputes it from its input: the
    forward (no autograd) keeps the input and the products the policy names
    (and, with its ``attn`` flag on the flash path, the attention's o and
    lse); the backward runs the layer again under autograd, each kept product
    and ``w_down`` (whose output no gradient reads) as a ``_KeptProduct``, the
    kept attention through ``flash_attention_given``, and differentiates it.

    Under FSDP (``shard``: the layer's ``LayerShard`` per weight and the layer
    index) the weights passed are this rank's pieces: each pass gathers the
    whole layer where it runs and keeps no whole copy between them, and the
    backward sends each weight's gradient back to its piece. Under tensor
    parallelism (``tp``) both passes run the layer's tp collectives: the
    recompute replays the forward's all-reduces, and its backward adds the
    gradient all-reduces, in one order on every rank whatever the policy."""

    @staticmethod
    def forward(ctx, h, names, policy, cos, sin, cfg, segment_ids, shard, tp, *weights):
        keep, keep_attn = policy
        kept: dict[str, Any] = {}

        def prod(name, x, w):
            out = x @ w
            if name in keep:
                kept[name] = out
            return out

        def attend(q, k, v):
            if keep_attn and _on_flash(q):
                kept["attn"] = flash_attention_fwd(q, k, v, causal=True, segment_ids=segment_ids)
                return kept["attn"][0]
            return dispatch_attention(q, k, v, causal=True, segment_ids=segment_ids)

        out = block(h, dict(zip(names, _whole(shard, weights))), cos, sin, cfg, attend, prod, tp)
        ctx.save_for_backward(h, cos, sin, segment_ids, *weights)
        ctx.names, ctx.kept, ctx.cfg, ctx.shard, ctx.tp = names, kept, cfg, shard, tp
        return out

    @staticmethod
    def backward(ctx, g):
        h, cos, sin, segment_ids, *weights = ctx.saved_tensors
        h = h.detach().requires_grad_()
        weights = [w.detach().requires_grad_() for w in _whole(ctx.shard, weights)]
        kept = ctx.kept
        unread = g.new_zeros(()).expand(g.shape)

        def prod(name, x, w):
            if name in kept:
                return _KeptProduct.apply(x, w, kept[name])
            if name == "w_down":
                return _KeptProduct.apply(x, w, unread)
            return x @ w

        def attend(q, k, v):
            if "attn" in kept:
                return flash_attention_given(q, k, v, *kept["attn"], causal=True, segment_ids=segment_ids)
            return dispatch_attention(q, k, v, causal=True, segment_ids=segment_ids)

        with torch.enable_grad():
            out = block(h, dict(zip(ctx.names, weights)), cos, sin, ctx.cfg, attend, prod, ctx.tp)
        grads = torch.autograd.grad(out, [h, *weights], g)
        if ctx.shard is not None:
            shards, l = ctx.shard
            grads = [grads[0], *(s.reduce(w, l) for s, w in zip(shards, grads[1:]))]
        return (grads[0], None, None, None, None, None, None, None, None, *grads[1:])


def _whole(shard, pieces) -> list:
    """A layer's whole weights: the pieces themselves, or (under FSDP,
    ``shard = (LayerShard per weight, layer)``) gathered from them."""
    if shard is None:
        return list(pieces)
    shards, l = shard
    return [s.full(p, l) for s, p in zip(shards, pieces)]


class _Gather(torch.autograd.Function):
    """A top-level leaf made whole from this rank's slice where it is
    consumed (FSDP); the backward reduce-scatters its gradient to the slice."""

    @staticmethod
    def forward(ctx, local, leaf_shard):
        ctx.leaf_shard = leaf_shard
        return leaf_shard.full(local)

    @staticmethod
    def backward(ctx, g):
        return ctx.leaf_shard.reduce(g), None


class _GatheredLayer(torch.autograd.Function):
    """A layer's whole weights from this rank's pieces (FSDP, no remat), and
    ``h`` passed through: ``h`` ties the node into every rank's backward, so
    that each rank joins the reductions of the layer's gradients, also a rank
    that holds no piece of it."""

    @staticmethod
    def forward(ctx, h, shard, *pieces):
        ctx.shard = shard
        whole = _whole(shard, pieces)
        return (h.view_as(h), *(w.view_as(w) if w is p else w for w, p in zip(whole, pieces)))

    @staticmethod
    def backward(ctx, gh, *gw):
        shards, l = ctx.shard
        return (gh, None, *(s.reduce(w, l) for s, w in zip(shards, gw)))


def gather_leaf(local: torch.Tensor, leaf_shard: Any) -> torch.Tensor:
    """A top-level leaf made whole (FSDP): through ``_Gather`` when its
    gradient is wanted, else by the gather alone."""
    if torch.is_grad_enabled() and local.requires_grad:
        return _Gather.apply(local, leaf_shard)
    return leaf_shard.full(local)


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


def _product(name: str, x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for a plain weight or an int8 ``{"q", "scale"}`` leaf (``generate/quant.py``)."""
    return _mm(x, w)


def block(h, layer, cos, sin, cfg: ConfigLlama3_2, attend, prod: Callable = _product, tp: Any = None) -> torch.Tensor:
    """One decoder layer over ``h [B, T, D]``; ``attend(q, k, v)`` returns
    ``[B, T, Hq, hd]`` (and may write K/V elsewhere as a side effect);
    ``prod(name, x, w)`` forms each product ``x @ layer[name]``. The head
    counts come from the weights' widths, so a tensor-parallel rank's slice
    runs its own heads; ``tp`` (``parallel.TensorParallel``) then sums the
    ranks' ``wo`` and ``w_down`` products over the tp group, and, training,
    all-reduces the gradient of the normed input of each split sub-layer."""
    b, t, _ = h.shape
    hd = cfg.head_dim
    attn_split = tp is not None and tp.attn
    mlp_split = tp is not None and tp.mlp
    x = rms_norm(h, layer["attn_norm"], cfg.norm_eps)
    x = tp.enter(x) if attn_split else x
    q = apply_rope(prod("wq", x, layer["wq"]).view(b, t, -1, hd), cos, sin)
    k = apply_rope(prod("wk", x, layer["wk"]).view(b, t, -1, hd), cos, sin)
    v = prod("wv", x, layer["wv"]).view(b, t, -1, hd)
    attn = attend(q, k, v)
    o = prod("wo", attn.reshape(b, t, -1).to(h.dtype), layer["wo"])
    h = h + (tp.reduce(o) if attn_split else o)
    x = rms_norm(h, layer["mlp_norm"], cfg.norm_eps)
    x = tp.enter(x) if mlp_split else x
    d = prod("w_down", F.silu(prod("w_gate", x, layer["w_gate"])) * prod("w_up", x, layer["w_up"]), layer["w_down"])
    return h + (tp.reduce(d) if mlp_split else d)


def embed_tokens(params: Params, tokens: torch.Tensor, tp: Any = None) -> torch.Tensor:
    """The embedding rows of ``tokens`` on the serving passes: ids clamped
    into the (whole) vocabulary as the JAX gather clamps them, then
    :func:`embed_lookup` (under a vocabulary-sharded ``tp`` each rank looks
    up the ids in its slice and the rows are summed over the tp group: one
    rank contributes each row, so the sum is that row's bits)."""
    rows = params["embed"].shape[0] * (tp.mesh.tp if tp is not None and tp.embed else 1)
    return embed_lookup(params["embed"], tokens.clamp(0, rows - 1), tp)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, tp: Any = None) -> torch.Tensor:
    """The embedding rows of ``tokens``.

    F.embedding, not ``table[tokens]``: the indexing's backward on the CPU
    (index_put_ with accumulate) sums repeated tokens' rows in a varying
    order, so two runs of one step could differ in the embedding's gradient.
    Under a vocabulary-sharded ``tp`` a rank looks up the ids in its slice
    of the rows (the others read row 0 and are zeroed), and ``tp.reduce``
    sums the ranks' rows (training: ``reduce_from_tp``, whose backward
    scatters into the rank's own rows only)."""
    if tp is None or not tp.embed:
        return F.embedding(tokens, table)
    rows = table.shape[0]
    local = tokens - tp.mesh.tp_rank * rows
    inside = (local >= 0) & (local < rows)
    h = F.embedding(torch.where(inside, local, 0), table)
    return tp.reduce(torch.where(inside[..., None], h, 0.0))


def layer_params(params: Params, l: int) -> Params:
    """Layer ``l``'s weights: views into the stacked ``[L, ...]`` tensors (an
    int8 leaf ``{"q", "scale"}`` gives ``{"q": q[l], "scale": scale[l]}``)."""
    return {name: {k: t[l] for k, t in w.items()} if isinstance(w, dict) else w[l]
            for name, w in params["layers"].items()}


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: ConfigLlama3_2,
    *,
    positions: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    remat: bool | str = True,
    shards: dict[str, Any] | None = None,
    tp: Any = None,
) -> torch.Tensor:
    """Run the decoder; returns final-normed hidden states ``[B, S, D]``.

    ``remat`` (a ``REMAT_POLICIES`` name, or bool for full/none): "none"
    keeps every activation; "full" keeps only each layer's input, and the
    backward recomputes the layer from it; a ``save_*`` policy also keeps
    the layer's named products (and, with ``_attn``, the flash forward's o
    and lse), so the backward recomputes only the rest. Every policy gives
    the same loss and gradients, bit for bit: a kept tensor is the one a
    recompute would give, and a kept product's backward makes the same
    calls. The attention is :func:`dispatch_attention`: the flash kernels on
    CUDA, the plain attention on the CPU.

    ``shards`` (FSDP; ``parallel.StateLayout.fsdp_shards()["layers"]``): the
    stacked weights in ``params`` are this rank's dp shards, and each layer
    gathers its whole weights where it runs (the top-level leaves come in
    whole: ``gather_leaf``). The gathers copy bytes, so the loss is the
    unsharded model's, bit for bit.

    ``tp`` (tensor-parallel training, a ``parallel.TensorParallel`` with
    ``train``): ``params`` holds this rank's tp slices (over the dp column
    too under FSDP), the embedding is looked up by ``embed_lookup`` and each
    layer runs its split sub-layers between ``copy_to_tp`` and
    ``reduce_from_tp``; the hidden states come out whole on every rank.
    """
    policy = _remat_policy(remat)
    b, s = tokens.shape
    h = embed_lookup(params["embed"], tokens, tp)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :].expand(b, s)
    cos, sin = rope_for_positions(positions, cfg)

    def attend(q, k, v):
        return dispatch_attention(q, k, v, causal=True, segment_ids=segment_ids)

    # one unbind per stacked weight: its backward stacks the layers' grads in
    # one pass, where per-layer indexing would sum L full-size zero-padded grads
    names = list(params["layers"])
    if shards is None:
        layers = zip(*(params["layers"][n].unbind(0) for n in names))
    else:
        layer_shards = [shards[n] for n in names]
        layers = zip(*(s.pieces(params["layers"][n]) for s, n in zip(layer_shards, names)))
    for l, weights in enumerate(layers):
        shard = None if shards is None else (layer_shards, l)
        if policy is None or not torch.is_grad_enabled():
            if shard is not None:
                if torch.is_grad_enabled():
                    h, *weights = _GatheredLayer.apply(h, shard, *weights)
                else:
                    weights = _whole(shard, weights)
            h = block(h, dict(zip(names, weights)), cos, sin, cfg, attend, tp=tp)
        else:
            h = _RematLayer.apply(h, names, policy, cos, sin, cfg, segment_ids, shard, tp, *weights)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def unembed(params: Params) -> torch.Tensor:
    """The output projection ``[V, D]``: the tied embedding or the untied ``lm_head``."""
    return params.get("lm_head", params["embed"])


def logits(params: Params, hidden: torch.Tensor, tp: Any = None) -> torch.Tensor:
    """Output projection with f32 logits (f32 accumulation for bf16
    weights). Under a ``tp`` whose output projection is a vocabulary slice
    the ranks' logits are all-gathered, so every rank holds the whole row."""
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
    if tp is not None and tp.head:
        out = tp.gather(out)
    return out.view(*hidden.shape[:-1], out.shape[-1])


# ----------------------------------------------------------------------------------
# Dense KV-cache decode path (the dense engine): ``ssi_tpu/models/llama3.py:173-259``
# ----------------------------------------------------------------------------------


DECODE_NEG_INF = -1.0e30


def init_kv_cache(cfg: ConfigLlama3_2, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = "cuda") -> Params:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_block(layer: Params, h: torch.Tensor, cos, sin, cache_k: torch.Tensor, cache_v: torch.Tensor,
                 slot_start: int, attn_mask: torch.Tensor, cfg: ConfigLlama3_2) -> torch.Tensor:
    """One decoder layer over T new tokens ``h [B, T, D]``, writing their K/V
    into slots ``[slot_start, slot_start + T)`` of this layer's cache
    ``cache_k / cache_v [B, M, Hkv, hd]`` in place. ``attn_mask [B, T, M]``
    (True = attend). The attention is the JAX package's grouped einsum: q
    heads grouped per kv head (the cache is read once, not repeated), f32
    scores of the cache-dtype operands, ``DECODE_NEG_INF`` where masked, the
    f32 softmax cast to the cache dtype before the value product."""
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    n_rep = cfg.num_heads // hkv

    def attend(q, k, v):
        b, t = q.shape[:2]
        cache_k[:, slot_start:slot_start + t] = k.to(cache_k.dtype)
        cache_v[:, slot_start:slot_start + t] = v.to(cache_v.dtype)
        qg = q.reshape(b, t, hkv, n_rep, hd)
        scores = torch.einsum("btkgd,bmkd->bkgtm", qg.float(), cache_k.to(q.dtype).float()) * (1.0 / hd**0.5)
        scores = scores.masked_fill_(~attn_mask[:, None, None], DECODE_NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        del scores  # [B, Hkv, n_rep, T, M] f32: the prefill's largest transient
        return torch.einsum("bkgtm,bmkd->btkgd", probs.to(cache_v.dtype), cache_v).reshape(b, t, hkv * n_rep, hd)

    return block(h, layer, cos, sin, cfg, attend)


def forward_slots(params: Params, tokens: torch.Tensor, cfg: ConfigLlama3_2, cache: Params, slot_start: int,
                  pad_offsets: torch.Tensor) -> torch.Tensor:
    """Decoder forward (no autograd) for ``tokens [B, T]`` occupying cache
    slots ``[slot_start, slot_start + T)``; writes their K/V into ``cache``
    (``init_kv_cache``) in place and returns the final-normed hidden
    ``[B, T, D]``. ``pad_offsets [B]``: left-pad slots per row, masked out
    of attention and subtracted from the RoPE positions (clamped at 0 for pad
    slots, masked anyway)."""
    b, t = tokens.shape
    m = cache["k"].shape[2]
    dev = tokens.device
    slot_ids = slot_start + torch.arange(t, dtype=torch.int32, device=dev)  # [T]
    positions = torch.clamp(slot_ids[None, :] - pad_offsets[:, None], min=0)  # [B, T]
    cos, sin = rope_for_positions(positions, cfg)
    kv_slots = torch.arange(m, dtype=torch.int32, device=dev)
    causal = kv_slots[None, None, :] <= slot_ids[None, :, None]  # [1, T, M]
    valid = kv_slots[None, None, :] >= pad_offsets[:, None, None]  # [B, 1, M]
    attn_mask = causal & valid  # [B, T, M]
    with torch.no_grad():
        h = params["embed"][tokens.long()]
        for l in range(cfg.num_layers):
            h = decode_block(layer_params(params, l), h, cos, sin, cache["k"][l], cache["v"][l], slot_start,
                             attn_mask, cfg)
        return rms_norm(h, params["final_norm"], cfg.norm_eps)


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
    d, f = cfg.embed_dim, cfg.intermediate_dim
    shapes = param_shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def norm_init(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * fan_in**-0.5).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    # drawn leaf by leaf in param_shapes' order (the norms draw nothing)
    params: Params = {
        "embed": norm_init(shapes["embed"], d),
        "layers": {name: ones(shape) if name.endswith("_norm") else norm_init(shape, f if name == "w_down" else d)
                   for name, shape in shapes["layers"].items()},
        "final_norm": ones(shapes["final_norm"]),
    }
    if "lm_head" in shapes:
        params["lm_head"] = norm_init(shapes["lm_head"], d)
    return params


def param_shapes(cfg: ConfigLlama3_2) -> Params:
    """The shape of every leaf :func:`init_params` makes for ``cfg``."""
    d, f, hd = cfg.embed_dim, cfg.intermediate_dim, cfg.head_dim
    hq, hkv, nl, v = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers, cfg.vocab_size
    shapes: Params = {
        "embed": (v, d),
        "layers": {"attn_norm": (nl, d), "wq": (nl, d, hq * hd), "wk": (nl, d, hkv * hd), "wv": (nl, d, hkv * hd),
                   "wo": (nl, hq * hd, d), "mlp_norm": (nl, d), "w_gate": (nl, d, f), "w_up": (nl, d, f),
                   "w_down": (nl, f, d)},
        "final_norm": (d,),
    }
    if not cfg.tied_embeddings:
        shapes["lm_head"] = (v, d)
    return shapes


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
