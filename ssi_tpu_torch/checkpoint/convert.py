"""HF <-> internal parameter layout conversion on torch tensors — the port's
copy of ``ssi_tpu/checkpoint/convert.py``, with torch's own ``stack`` and
``t()`` in place of the ``xp=`` array namespace.

Renaming, transposition to ``[in, out]``, and stacking per-layer weights
(the layout of ``ssi_tpu_torch/models/llama3.py``); the model uses the HF
rotate-half RoPE convention, so no q/k head permutation is needed.
"""

from __future__ import annotations

from typing import Any

import torch

from ssi_tpu_torch.models.configs import ConfigLlama3_2

# (internal stacked key, HF key template, transpose?)
_LAYER_MAP = [
    ("attn_norm", "model.layers.{i}.input_layernorm.weight", False),
    ("wq", "model.layers.{i}.self_attn.q_proj.weight", True),
    ("wk", "model.layers.{i}.self_attn.k_proj.weight", True),
    ("wv", "model.layers.{i}.self_attn.v_proj.weight", True),
    ("wo", "model.layers.{i}.self_attn.o_proj.weight", True),
    ("mlp_norm", "model.layers.{i}.post_attention_layernorm.weight", False),
    ("w_gate", "model.layers.{i}.mlp.gate_proj.weight", True),
    ("w_up", "model.layers.{i}.mlp.up_proj.weight", True),
    ("w_down", "model.layers.{i}.mlp.down_proj.weight", True),
]


def hf_to_internal(state_dict: dict[str, Any], cfg: ConfigLlama3_2) -> dict[str, Any]:
    """Convert a flat HF state dict (tensors) to the stacked internal tree."""
    nl = cfg.num_layers
    layers: dict[str, Any] = {}
    for internal_key, hf_tmpl, transpose in _LAYER_MAP:
        per_layer = []
        for i in range(nl):
            w = state_dict[hf_tmpl.format(i=i)]
            per_layer.append(w.t() if transpose else w)
        layers[internal_key] = torch.stack(per_layer, dim=0)
    params = {
        "embed": state_dict["model.embed_tokens.weight"],
        "layers": layers,
        "final_norm": state_dict["model.norm.weight"],
    }
    if cfg.tied_embeddings:
        # Tied models (Llama 3.2 1B/3B) carry no lm_head; if one is present in the
        # file it is intentionally ignored — the architecture is tied by construction.
        return params
    if "lm_head.weight" not in state_dict:
        raise KeyError(
            f"{cfg.checkpoint_expectations.model_name} is untied (tied_embeddings=False) "
            "but the checkpoint has no lm_head.weight"
        )
    params["lm_head"] = state_dict["lm_head.weight"]
    return params


def internal_to_hf(params: dict[str, Any], cfg: ConfigLlama3_2) -> dict[str, Any]:
    """Convert the stacked internal tree back to a flat HF state dict."""
    out: dict[str, Any] = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_norm"],
    }
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"]
    for internal_key, hf_tmpl, transpose in _LAYER_MAP:
        stacked = params["layers"][internal_key]
        for i in range(cfg.num_layers):
            w = stacked[i]
            out[hf_tmpl.format(i=i)] = w.t() if transpose else w
    return out


def expected_hf_keys(cfg: ConfigLlama3_2) -> set[str]:
    keys = {"model.embed_tokens.weight", "model.norm.weight"}
    if not cfg.tied_embeddings:
        keys.add("lm_head.weight")
    for _, hf_tmpl, _ in _LAYER_MAP:
        for i in range(cfg.num_layers):
            keys.add(hf_tmpl.format(i=i))
    return keys
