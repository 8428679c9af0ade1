"""The dense decode engine — port of ``ssi_tpu/generate/engine.py``
(``SamplingParams``, ``_sample``, ``DecodeEngine``).

Prompts are left-padded to a multiple of ``prompt_bucket``, so every row's
last prompt token sits at slot P-1 and decode writes to uniform slots P+t.
Per-row pad offsets shift the RoPE positions and mask the pad slots out of
attention (``models/llama3.py`` ``forward_slots``: the JAX package's
grouped einsum over a dense cache, plain torch, as the JAX attention there
is XLA and not a Pallas kernel). Greedy argmax at temperature 0, else
temperature / top-k / top-p sampling; presence, frequency and repetition
penalties with vLLM's scoping.

Where the JAX engine runs prefill and decode as one ``lax.while_loop`` that
exits when every row has stopped, the port runs a host loop on the device's
queue and reads whether every row has stopped once every
``exit_check_every`` steps, from a copy taken that many steps before (a
pinned copy behind an event on the card), so the read never waits for the
steps queued since. Once every row has stopped a step changes nothing
(``out``, ``lens`` and the cumulative logprob are frozen), so the interval
changes no result. ``tests/test_torch_dense_engine.py`` holds greedy tokens
equal to the JAX engine's and to a full-recompute oracle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ssi_tpu_torch.utils import round_up as _round_up

_NEG_INF = -1.0e30


@dataclass(frozen=True)
class SamplingParams:
    """vLLM-compatible sampling surface (ref: conf/generate.yaml:21-31)."""

    n: int = 1
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = -1
    max_tokens: int = 256
    stop_token_ids: tuple[int, ...] = field(default_factory=tuple)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0

    @classmethod
    def from_cfg(cls, node: Any, stop_token_ids: list[int]) -> "SamplingParams":
        return cls(
            n=int(node.get("n", 1)),
            temperature=float(node.get("temperature", 0.0)),
            top_p=float(node.get("top_p", 1.0)),
            top_k=int(node.get("top_k", -1)),
            max_tokens=int(node.get("max_tokens", 256)),
            stop_token_ids=tuple(stop_token_ids),
            presence_penalty=float(node.get("presence_penalty", 0.0)),
            frequency_penalty=float(node.get("frequency_penalty", 0.0)),
            repetition_penalty=float(node.get("repetition_penalty", 1.0)),
        )

    @property
    def uses_penalties(self) -> bool:
        return self.presence_penalty != 0.0 or self.frequency_penalty != 0.0 or self.repetition_penalty != 1.0


# the largest f32 below 1: a uniform draw clamped to it keeps every Gumbel
# noise finite, so a masked token (logit -1e30) is never drawn
_U_MAX = 1.0 - 2.0**-24


def _sample(logits: torch.Tensor, sp: SamplingParams, gen: torch.Generator | None, out_counts: torch.Tensor,
            prompt_counts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Next token ``[B]`` (int64) and its logprob ``[B]`` from ``[B, V]`` f32 logits.

    Penalty scoping follows vLLM: repetition_penalty sees prompt+output tokens;
    presence/frequency penalties see output tokens only. The returned logprob is
    computed from the processed distribution (post-penalties, post-temperature,
    pre-top-k/p truncation — vLLM's logprob point). The draw is Gumbel-max
    over the truncated logits with uniforms from ``gen``.
    """
    if sp.uses_penalties:
        if sp.repetition_penalty != 1.0:
            appeared_any = (out_counts + prompt_counts) > 0
            logits = torch.where(
                appeared_any,
                torch.where(logits > 0, logits / sp.repetition_penalty, logits * sp.repetition_penalty),
                logits,
            )
        appeared_out = out_counts > 0
        logits = logits - sp.frequency_penalty * out_counts - sp.presence_penalty * appeared_out.to(logits.dtype)

    if sp.temperature != 0.0:
        logits = logits / sp.temperature

    def logprob_of(lp_logits, tok):
        return lp_logits.gather(-1, tok[:, None])[:, 0] - torch.logsumexp(lp_logits, dim=-1)

    if sp.temperature == 0.0:
        tok = torch.argmax(logits, dim=-1)
        return tok, logprob_of(logits, tok)

    lp_logits = logits  # logprob point: before top-k/p truncation
    if 0 < sp.top_k < logits.shape[-1]:
        # top_k >= vocab is "disabled" (vLLM semantics), not an index error
        kth = torch.topk(logits, sp.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, _NEG_INF, logits)
    if sp.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p
        cutoff_idx = torch.sum(cum < sp.top_p, dim=-1).clamp_(max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, _NEG_INF, logits)
    u = torch.rand(logits.shape, generator=gen, device=logits.device).clamp_(torch.finfo(torch.float32).tiny, _U_MAX)
    tok = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    return tok, logprob_of(lp_logits, tok)


class _DoneSnapshot:
    """Whether every row has stopped, as of the step it was taken: a pinned
    copy behind an event on the card (reading it waits for that step only)."""

    def __init__(self, done: torch.Tensor):
        flag = done.all()
        if flag.is_cuda:
            self.value = torch.empty((), dtype=torch.bool, pin_memory=True)
            self.value.copy_(flag, non_blocking=True)
            self.ready = torch.cuda.Event()
            self.ready.record()
        else:
            self.value, self.ready = flag, None

    def read(self) -> bool:
        if self.ready is not None:
            self.ready.synchronize()
        return bool(self.value)


class DecodeEngine:
    """Batched generation over a fixed parameter dictionary.

    Args:
        params: the model's parameters (``models/llama3.py``), on the device
            the engine runs on (bf16 recommended; f32 for parity checks).
        cfg: architecture config (extended vocab).
        pad_id: token used to left-pad prompts (masked out of attention anyway).
        prompt_bucket: prompts pad up to a multiple of this.
    """

    # decode steps between two host reads of whether every row has stopped
    # (see the module docstring; no result depends on it)
    exit_check_every = 4

    def __init__(self, params: Any, cfg: Any, pad_id: int, prompt_bucket: int = 128):
        self.params = params
        self.cfg = cfg
        self.pad_id = pad_id
        self.prompt_bucket = prompt_bucket
        self.device = params["embed"].device
        self.last_steps = 0  # decode steps the last batch ran (the first token's prefill not counted)

    def generate_batch(self, prompts: list[list[int]], sp: SamplingParams, seed: int = 0) -> list[dict[str, Any]]:
        """Generate for a batch of ragged prompts; returns vLLM-shaped dicts.
        ``seed`` seeds the draws of a sampled run (greedy ignores it)."""
        if sp.n != 1:
            raise ValueError(
                "DecodeEngine decodes one sequence per prompt; use PagedDecodeEngine for sampling_params.n > 1"
            )
        b = len(prompts)
        p = _round_up(max(len(t) for t in prompts), self.prompt_bucket)
        tokens = np.full((b, p), self.pad_id, np.int64)
        offsets = np.zeros((b,), np.int32)
        for i, t in enumerate(prompts):
            tokens[i, p - len(t):] = t
            offsets[i] = p - len(t)
        with torch.inference_mode():
            out, lens, done, clp = self._generate(torch.from_numpy(tokens).to(self.device),
                                                  torch.from_numpy(offsets).to(self.device), p, sp, seed)
        out, lens, done, clp = out.cpu().numpy(), lens.cpu().numpy(), done.cpu().numpy(), clp.cpu().numpy()

        results = []
        stop_set = set(sp.stop_token_ids)
        for i in range(b):
            token_ids = out[i, : lens[i]].tolist()
            stopped = bool(done[i]) and token_ids and token_ids[-1] in stop_set
            results.append(
                {
                    "token_ids": token_ids,
                    "finish_reason": "stop" if stopped else "length",
                    "stop_reason": token_ids[-1] if stopped else None,
                    "cumulative_logprob": float(clp[i]),
                }
            )
        return results

    def _generate(self, tokens: torch.Tensor, offsets: torch.Tensor, p: int, sp: SamplingParams, seed: int):
        from ssi_tpu_torch.models.llama3 import forward_slots, init_kv_cache, logits as unembed_logits

        cfg, params, dev = self.cfg, self.params, self.device
        b, max_t = tokens.shape[0], sp.max_tokens
        stop_ids = torch.tensor(sp.stop_token_ids, dtype=torch.int64, device=dev)
        gen = None
        if sp.temperature != 0.0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))

        def is_stop(tok):
            return torch.isin(tok, stop_ids) if len(sp.stop_token_ids) else torch.zeros_like(tok, dtype=torch.bool)

        # one cache for the whole batch, prompt bucket plus every decode slot
        cache = init_kv_cache(cfg, b, p + max_t, dtype=params["embed"].dtype, device=dev)
        hidden = forward_slots(params, tokens, cfg, cache, 0, offsets)
        last_logits = unembed_logits(params, hidden[:, -1, :])  # [B, V] f32
        del hidden

        if sp.uses_penalties:
            out_counts = torch.zeros((b, cfg.vocab_size), dtype=torch.float32, device=dev)
            # prompt counts feed only repetition_penalty (vLLM scoping); masked by
            # slot validity so left-padding never counts, even if pad_id is a
            # token that genuinely appears in the prompt
            slot_valid = (torch.arange(p, device=dev)[None, :] >= offsets[:, None]).to(torch.float32)
            prompt_counts = torch.zeros((b, cfg.vocab_size), dtype=torch.float32, device=dev)
            prompt_counts.scatter_add_(1, tokens, slot_valid)
        else:
            out_counts = prompt_counts = torch.zeros((1, 1), dtype=torch.float32, device=dev)

        tok, clp = _sample(last_logits, sp, gen, out_counts, prompt_counts)
        out = torch.full((b, max_t), self.pad_id, dtype=torch.int64, device=dev)
        out[:, 0] = tok
        done = is_stop(tok)
        lens = torch.ones((b,), dtype=torch.int32, device=dev)
        rows = torch.arange(b, device=dev)

        snapshot = None
        t = 1
        while t < max_t:
            if (t - 1) % self.exit_check_every == 0:
                if snapshot is not None and snapshot.read():
                    break
                snapshot = _DoneSnapshot(done)
            # step t consumes the token produced for slot p-1+t and emits out[:, t]
            hidden = forward_slots(params, tok[:, None], cfg, cache, p - 1 + t, offsets)
            step_logits = unembed_logits(params, hidden[:, 0, :])
            if sp.uses_penalties:
                out_counts[rows, tok] += (~done).to(torch.float32)
            next_tok, lp = _sample(step_logits, sp, gen, out_counts, prompt_counts)
            clp = clp + torch.where(done, 0.0, lp)
            next_tok = torch.where(done, self.pad_id, next_tok)
            out[:, t] = next_tok  # a stopped row's slot keeps pad_id
            lens = lens + (~done).to(torch.int32)
            done = done | is_stop(next_tok)
            tok = next_tok
            t += 1
        self.last_steps = t - 1
        return out, lens, done, clp
