"""Continuous-batching decode engine over the block-paged KV cache — port of
``ssi_tpu/generate/paged_engine.py`` ``PagedDecodeEngine``.

The host scheduler is the JAX engine's: a fixed pool of ``n_slots`` decode
slots advances in lockstep; pages are allocated lazily (prompt pages at
admission, decode pages chunk by chunk) with reference counts and returned
when a request finishes; queued prompts are admitted into freed slots between
chunks (FIFO, shortest- or longest-job-first); when the pool runs dry the
youngest running request is preempted and re-queued for a fresh prefill.
Admissions prefill batched in groups of ``PREFILL_GROUPS``; decode runs
``chunk`` steps per dispatch with all slot state on the device, and the
host reads the chunk's packed results once (harvested synchronously: the
JAX engine's ``pipeline_depth=1`` behaviour).

Prefix caching (on by default, as in the JAX engine): full prompt pages are
keyed by a chained hash of their token blocks; an admission whose prompt
extends a cached chain references those pages and prefills only the tail
(``prefill_suffix``); unreferenced cached pages park in an LRU that
allocation drains before it reports the pool dry. Chunked prefill
(``prefill_chunk``) splits a long prompt's prefill into pieces, one per
scheduler step, while the other slots keep decoding. Speculative decoding
(``speculate_k``) drafts k tokens per slot from the most recent bigram match
in the slot's own token history and verifies all k+1 in one forward
(``decode_step_tokens_spec``, the CUDA kernel #9 on the card); greedy only,
and lossless: the emitted tokens equal the non-speculative stream's.

Sampling draws Gumbel noise from a counter-based hash of (stream seed,
request seed, position, vocab index), so a preempted and recomputed request
redraws identical tokens, independent of batch composition. It cannot equal
``jax.random``'s bits: greedy decoding is the cross-framework parity bar.

Not ported yet; each raises ``NotImplementedError`` naming its ROADMAP item:
``quantize``, ``mesh``, and ``n > 1`` sampling.
"""

from __future__ import annotations

import hashlib
import logging
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ssi_tpu_torch.models.configs import ConfigLlama3_2
from ssi_tpu_torch.generate.engine import _NEG_INF, SamplingParams
from ssi_tpu_torch.generate.paged import (
    decode_step_tokens,
    decode_step_tokens_spec,
    init_pools,
    prefill_prompts,
    prefill_suffix,
)
from ssi_tpu_torch.utils import round_up

LOGGER = logging.getLogger(__name__)

# Sampling branches a stream carries (the JAX engine compiles them per
# stream; here they decide which per-step work runs). A request whose
# params need a branch its stream did not open is rejected at add_request.
SAMPLING_FEATURES = frozenset({"sample", "topk", "topp", "pen"})

# host-owned scalar columns at the head of the packed int32 control array:
# [active, admit, admit_seq, admit_tok, admit_budget, prompt_len,
#  temp(f32), top_p(f32), top_k, presence(f32), frequency(f32),
#  repetition(f32), rng_seed] — f32 columns travel bitcast to int32
_N_CTRL_COLS = 13
_M32 = 0xFFFFFFFF


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported to ssi_tpu_torch yet (ROADMAP.md queue A, item {item})"
    )


def _derive_features(sp: SamplingParams) -> frozenset:
    """Minimum feature set a SamplingParams needs (top-k/top-p are irrelevant
    under greedy decoding: argmax is truncation-invariant)."""
    feats = set()
    if sp.temperature != 0.0:
        feats.add("sample")
        if sp.top_k > 0:
            feats.add("topk")
        if sp.top_p < 1.0:
            feats.add("topp")
    if sp.uses_penalties:
        feats.add("pen")
    return frozenset(feats)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors holding values < 2**32 (both
    multipliers are < 2**31, so no product leaves int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def _gumbel_noise(stream_seed: int, row_seeds: torch.Tensor, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel(0, 1) noise ``[B, vocab]``, a pure function of (stream seed,
    row seed, position, vocab index)."""
    key = _mix32(torch.full_like(row_seeds, stream_seed & _M32, dtype=torch.int64))
    key = _mix32(key ^ (row_seeds.to(torch.int64) & _M32))
    key = _mix32(key ^ (positions.to(torch.int64) & _M32))
    idx = torch.arange(vocab, dtype=torch.int64, device=row_seeds.device)
    bits = _mix32(_mix32(key[:, None] ^ idx[None, :]))
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


def _sample_rows(logits, feats, any_samp, temp, top_p, top_k, pres, freq, rep, noise, out_counts, prompt_counts):
    """Next token + logprob from ``[B, V]`` f32 logits with PER-ROW params.

    Penalty scoping and the logprob point follow vLLM (repetition sees
    prompt+output counts, presence/frequency output counts; the logprob is
    taken post-penalty, post-temperature, pre-truncation). Rows with
    ``temp == 0`` take the argmax. ``any_samp`` (host-known) skips the sort
    and noise work on steps where no row samples; ``noise()`` returns the
    Gumbel noise for the step.
    """
    if "pen" in feats:
        appeared_any = (out_counts + prompt_counts) > 0
        rp = rep[:, None]
        bent = torch.where(logits > 0, logits / rp, logits * rp)
        logits = torch.where(appeared_any, bent, logits)
        logits = logits - freq[:, None] * out_counts - pres[:, None] * (out_counts > 0).to(logits.dtype)
    greedy = torch.argmax(logits, dim=-1)
    lse_raw = torch.logsumexp(logits, dim=-1)
    greedy_lp = torch.gather(logits, 1, greedy[:, None])[:, 0] - lse_raw
    if "sample" not in feats or not any_samp:
        return greedy.to(torch.int32), greedy_lp

    is_samp = temp > 0.0
    lt = logits / torch.where(is_samp, temp, torch.ones_like(temp))[:, None]
    trunc = lt
    vocab = lt.shape[-1]
    if "topk" in feats or "topp" in feats:
        sorted_desc = torch.sort(lt, dim=-1, descending=True).values
        if "topk" in feats:
            idx = torch.clamp(top_k, 1, vocab).long() - 1
            kth = torch.gather(sorted_desc, 1, idx[:, None])
            kth = torch.where((top_k > 0)[:, None], kth, torch.full_like(kth, -float("inf")))
            trunc = torch.where(lt < kth, torch.full_like(trunc, _NEG_INF), trunc)
        if "topp" in feats:
            probs = torch.softmax(sorted_desc, dim=-1)
            # JAX clamps this index; a cumsum that never reaches top_p would overrun
            cutoff_idx = (torch.cumsum(probs, dim=-1) < top_p[:, None]).sum(-1).clamp(max=vocab - 1)
            cutoff = torch.gather(sorted_desc, 1, cutoff_idx[:, None])
            cutoff = torch.where((top_p < 1.0)[:, None], cutoff, torch.full_like(cutoff, -float("inf")))
            trunc = torch.where(lt < cutoff, torch.full_like(trunc, _NEG_INF), trunc)
    draw = torch.argmax(trunc + noise(), dim=-1)
    tok = torch.where(is_samp, draw, greedy)
    lp = torch.gather(lt, 1, tok[:, None])[:, 0] - torch.logsumexp(lt, dim=-1)
    return tok.to(torch.int32), torch.where(is_samp, lp, greedy_lp)


@dataclass
class _Request:
    idx: int                      # request id (position in generate_batch's prompt list)
    prompt: list[int]
    out: list[int] = field(default_factory=list)
    lps: list[float] = field(default_factory=list)  # per-token logprobs (empty in spec mode)
    clp: float = 0.0
    max_tokens: int | None = None  # per-request budget (<= stream sp.max_tokens)
    sampling: SamplingParams | None = None  # per-request override (None = stream sp)
    rng_seed: int = 0             # per-request sampling seed (rides the control array)
    requeued: bool = False        # preempted work parked at the queue front; sorted
    # admission orders (sjf/ljf) never insert ahead of it


@dataclass
class _Slot:
    req: _Request | None = None
    pages: list[int] = field(default_factory=list)
    seq_len: int = 0              # valid cache tokens (prompt + consumed outputs)
    n_out: int = 0                # tokens emitted so far
    done: bool = False            # hit a stop token / budget; awaiting collection
    cached_len: int = 0           # prompt tokens satisfied by the prefix cache
    prefilling: bool = False      # chunked prefill in progress (decode gated)
    prefilled: int = 0            # prompt positions with K/V written so far
    hashes: list = field(default_factory=list)  # chain hashes, registered piece by piece


@dataclass
class _Stream:
    """Per-stream scheduler state (one active stream per engine)."""

    sp: SamplingParams
    seed: int
    use_pen: bool
    stop_set: set
    stop_ids: torch.Tensor
    features: frozenset
    queue: list[_Request] = field(default_factory=list)
    results: dict[int, dict] = field(default_factory=dict)
    completed: deque = field(default_factory=deque)  # ids ready to return
    next_idx: int = 0
    suspend_admission: bool = False  # set on self-preemption
    # device-resident slot state
    seq_lens: Any = None
    tok: Any = None
    done: Any = None
    budget: Any = None
    out_counts: Any = None
    # host control columns
    active: Any = None
    admit: Any = None
    admit_seq: Any = None
    admit_tok: Any = None
    admit_budget: Any = None
    prompt_lens: Any = None
    prompt_counts: Any = None
    slot_temp: Any = None
    slot_top_p: Any = None
    slot_top_k: Any = None
    slot_pres: Any = None
    slot_freq: Any = None
    slot_rep: Any = None
    slot_seed: Any = None
    hist: Any = None              # [n_slots+1, W+1] n-gram token history (speculate_k > 0)
    stats: dict = field(default_factory=dict)
    t_start: float = 0.0


class PagedDecodeEngine:
    """Continuous-batching generation over a paged KV cache.

    Args:
        params: parameter dictionary (``models/llama3.py`` layout) on the
            device the engine runs on; the KV pools take its dtype.
        cfg: architecture config.
        pad_id: filler token for inactive slots' inputs.
        n_slots: decode slots advanced per step (the batch).
        page_size: tokens per KV page.
        n_pages: pool size in pages per layer; default sizes for ``n_slots``
            full contexts (lazy allocation touches far fewer).
        max_context: per-sequence token capacity (rounded up to pages and
            prompt buckets).
        prompt_bucket: prompts pad up to a multiple of this for prefill.
        chunk: decode steps per dispatch (one host read of results each).
        attn_impl: "kernel" (the CUDA flash-prefill, fused paged-decode and
            multi-token verify kernels; CUDA devices only), "reference"
            (plain PyTorch), or "auto" ("kernel" on a CUDA device,
            "reference" on the CPU).
        admission_order: "fifo", "sjf" (shortest prompt+budget first) or
            "ljf" (longest first) for NEW requests; preempted work always
            re-queues at the front.
        prefix_caching: reuse prompt pages across requests (see the module
            docstring); exact, since cached K/V is what a fresh prefill writes.
        prefill_chunk: cap in tokens (a multiple of ``prompt_bucket``) on the
            prompt span one prefill dispatch covers; None = whole prompts.
        speculate_k: draft length of n-gram speculative decoding, 0-7 (0 =
            off); greedy streams only.
        quantize, mesh: options of the JAX engine not ported yet; any
            non-default value raises ``NotImplementedError``.
    """

    # Admissions prefill in groups: G prompts cost one weights read instead of G.
    PREFILL_GROUPS = (8, 4, 2, 1)

    def __init__(
        self,
        params: Any,
        cfg: ConfigLlama3_2,
        pad_id: int,
        *,
        n_slots: int = 32,
        page_size: int = 128,
        n_pages: int | None = None,
        max_context: int = 1280,
        prompt_bucket: int = 128,
        chunk: int = 16,
        attn_impl: str = "auto",
        admission_order: str = "fifo",
        prefix_caching: bool = True,
        prefill_chunk: int | None = None,
        speculate_k: int = 0,
        quantize: str | None = None,
        mesh: Any = None,
    ):
        if quantize is not None:
            raise _not_ported(f"quantize={quantize!r}", "5 (int8 weights)")
        if mesh is not None:
            raise _not_ported("mesh (tensor-parallel serving)", "9 (parallel)")
        if page_size <= 0 or page_size % 8 != 0:
            # kept from the JAX engine, whose fused verify kernel writes through 8-row windows
            raise ValueError(f"page_size ({page_size}) must be a positive multiple of 8")
        if prompt_bucket % page_size != 0:
            raise ValueError(f"prompt_bucket ({prompt_bucket}) must be a multiple of page_size ({page_size})")
        if prefill_chunk is not None and (prefill_chunk <= 0 or prefill_chunk % prompt_bucket != 0):
            # pieces must start page-aligned (the suffix pass writes whole pages)
            raise ValueError(f"prefill_chunk ({prefill_chunk}) must be a positive multiple of "
                             f"prompt_bucket ({prompt_bucket})")
        if not 0 <= speculate_k <= 7:
            raise ValueError(f"speculate_k ({speculate_k}) must be in [0, 7]")
        if admission_order not in ("fifo", "sjf", "ljf"):
            raise ValueError(f"Unknown admission_order {admission_order!r}; expected 'fifo', 'sjf', or 'ljf'")
        self.device = params["embed"].device
        if attn_impl == "auto":
            attn_impl = "kernel" if self.device.type == "cuda" else "reference"
        if attn_impl not in ("kernel", "reference"):
            raise ValueError(f"Unknown attn_impl {attn_impl!r}; expected 'kernel', 'reference' or 'auto'")
        if attn_impl == "kernel" and self.device.type != "cuda":
            raise ValueError(f"attn_impl='kernel' runs the CUDA kernels; the parameters are on {self.device}")
        self.attn_impl = attn_impl
        self.params = params
        self.cfg = cfg
        self.pad_id = pad_id
        self.n_slots = n_slots
        self.page_size = page_size
        self.admission_order = admission_order
        self.prefix_caching = bool(prefix_caching)
        self.prefill_chunk = prefill_chunk
        self.speculate_k = int(speculate_k)
        self.max_context = round_up(round_up(max_context, page_size), prompt_bucket)
        self.max_pages_per_seq = self.max_context // page_size
        self.prompt_bucket = prompt_bucket
        self.chunk = chunk
        self.n_pages = n_pages if n_pages is not None else n_slots * self.max_pages_per_seq
        self.pools = init_pools(cfg, self.n_pages, page_size, dtype=params["embed"].dtype, device=self.device)
        self._free_pages: list[int] = list(range(self.n_pages))
        self._page_refs = np.zeros(self.n_pages, np.int32)
        # prefix cache: chain hash <-> logical page (1:1); a cached page whose
        # last reference drops parks in the LRU, which _alloc_pages drains
        self._prefix_map: dict[bytes, int] = {}
        self._page_hash: dict[int, bytes] = {}
        self._cache_lru: OrderedDict[int, None] = OrderedDict()
        self._slots = [_Slot() for _ in range(n_slots)]
        self._page_table = np.zeros((n_slots, self.max_pages_per_seq), np.int32)
        self._st: _Stream | None = None
        # per-stream scheduler counters, refreshed by every stream
        self.last_stats: dict[str, Any] = {}

    # --- host-side page scheduling -----------------------------------------------

    def _alloc_pages(self, n: int) -> list[int] | None:
        # unreferenced cached pages are reclaimable capacity, oldest first
        while len(self._free_pages) < n and self._cache_lru:
            pg, _ = self._cache_lru.popitem(last=False)
            self._prefix_map.pop(self._page_hash.pop(pg), None)
            self._free_pages.append(pg)
        if len(self._free_pages) < n:
            return None
        pages = [self._free_pages.pop() for _ in range(n)]
        for p in pages:
            self._page_refs[p] = 1
        return pages

    def _release_pages(self, pages: list[int]) -> None:
        for p in pages:
            self._page_refs[p] -= 1
            if self._page_refs[p] == 0:
                if p in self._page_hash:  # keep cached content around, evictable
                    self._cache_lru[p] = None
                    self._cache_lru.move_to_end(p)
                else:
                    self._free_pages.append(p)

    def _free_slot(self, slot: _Slot) -> None:
        self._release_pages(slot.pages)
        slot.pages = []
        slot.req = None
        slot.seq_len = 0
        slot.n_out = 0
        slot.done = False
        slot.cached_len = 0
        slot.prefilling = False
        slot.prefilled = 0
        slot.hashes = []

    def _pages_needed(self, length: int) -> int:
        return -(-length // self.page_size)

    def _match_prefix(self, prompt: list[int]) -> tuple[list[int], list[bytes]]:
        """Longest cached page chain ``prompt`` extends: (matched logical
        pages, chain hashes of ALL its cacheable pages). Only pages holding
        positions <= len(prompt)-2 are cacheable: the first decode step
        rewrites the page holding position p-1."""
        ps = self.page_size
        shared_n = (len(prompt) - 1) // ps
        hashes: list[bytes] = []
        h = b""
        arr = np.asarray(prompt[: shared_n * ps], np.int32)
        for i in range(shared_n):
            h = hashlib.sha1(h + arr[i * ps : (i + 1) * ps].tobytes()).digest()
            hashes.append(h)
        matched: list[int] = []
        for h in hashes:
            pg = self._prefix_map.get(h)
            if pg is None:
                break
            matched.append(pg)
        return matched, hashes

    def _clear_prefix_cache(self) -> None:
        """Invalidate the whole prefix cache (teardown after an error: a slot
        admitted this step may have registered pages its prefill never
        wrote). Unreferenced cached pages rejoin the free list; referenced
        ones follow when their holder releases them."""
        self._prefix_map.clear()
        self._page_hash.clear()
        self._free_pages.extend(self._cache_lru)
        self._cache_lru.clear()

    def _ensure_capacity(self, slot_id: int, target_len: int) -> bool:
        """Lazily extend a slot's page list to cover ``target_len`` tokens."""
        slot = self._slots[slot_id]
        need = self._pages_needed(target_len)
        if need > self.max_pages_per_seq:
            raise ValueError(f"Sequence needs {target_len} tokens > max_context {self.max_context}; raise max_context")
        while len(slot.pages) < need:
            got = self._alloc_pages(1)
            if got is None:
                return False
            slot.pages.extend(got)
            self._page_table[slot_id, len(slot.pages) - 1] = got[0]
        return True

    def _preempt_youngest(self, queue: list[_Request]) -> int | None:
        """Free the running slot with the fewest outputs, re-queueing its
        request at the front (recompute-style). Returns the victim slot id
        (the caller clears its ``active`` flag), or None if nothing runs."""
        candidates = [(s.n_out, i) for i, s in enumerate(self._slots) if s.req is not None and not s.done]
        if not candidates:
            return None
        _, victim = min(candidates)
        slot = self._slots[victim]
        LOGGER.warning(
            f"KV pool exhausted: preempting slot {victim} (request {slot.req.idx}, "
            f"{slot.n_out} tokens generated) for recompute-style retry"
        )
        slot.req.out = []
        slot.req.lps = []
        slot.req.clp = 0.0
        slot.req.requeued = True
        queue.insert(0, slot.req)
        self._free_slot(slot)
        return victim

    # --- streaming API -----------------------------------------------------------

    def begin_stream(self, sp: SamplingParams, seed: int = 0, features: Any = None) -> None:
        """Open a request stream under one default SamplingParams (one stream
        per engine: the KV pool and slots are engine-level). ``features``
        (names from SAMPLING_FEATURES) opens sampling branches per-request
        params may use beyond what ``sp`` itself needs; ``seed`` keys the
        stream's sampling noise."""
        if self._st is not None:
            raise RuntimeError("A stream is already active on this engine; call end_stream() first")
        if any(s.req is not None for s in self._slots):
            raise RuntimeError("Engine slots are not free; a previous stream did not clean up")
        if sp.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if sp.n != 1:
            raise _not_ported("sampling_params.n > 1", "3 (n>1 sampling, pipelined harvest)")
        feats = frozenset(features) if features is not None else frozenset()
        unknown = feats - SAMPLING_FEATURES
        if unknown:
            raise ValueError(f"Unknown sampling features {sorted(unknown)}; valid: {sorted(SAMPLING_FEATURES)}")
        feats |= _derive_features(sp)
        if self.speculate_k > 0:
            # lossless speculation is defined by argmax equality: greedy only
            if sp.temperature != 0.0:
                raise ValueError("speculate_k > 0 requires greedy decoding (temperature=0)")
            if sp.uses_penalties:
                raise ValueError("speculate_k > 0 does not compose with repetition/presence/frequency penalties")
            if feats:
                raise ValueError("speculate_k > 0 streams are greedy-only; no sampling features")
        dev = self.device
        n, v = self.n_slots, self.cfg.vocab_size
        st = _Stream(
            sp=sp,
            seed=int(seed),
            use_pen="pen" in feats,
            stop_set=set(sp.stop_token_ids),
            stop_ids=torch.tensor(sp.stop_token_ids, dtype=torch.int32, device=dev),
            features=feats,
        )
        # Device-resident slot state. Admission seeds a slot at seq_len = p - 1
        # with tok = prompt[-1]: the first decode step recomputes the last
        # prompt position's K/V in place and samples the first output.
        st.seq_lens = torch.zeros(n, dtype=torch.int32, device=dev)
        st.tok = torch.full((n,), self.pad_id, dtype=torch.int32, device=dev)
        st.done = torch.zeros(n, dtype=torch.bool, device=dev)
        st.budget = torch.zeros(n, dtype=torch.int32, device=dev)
        st.out_counts = torch.zeros((n, v), dtype=torch.float32, device=dev) if st.use_pen else None
        st.active = np.zeros(n, bool)
        st.admit = np.zeros(n, np.int32)
        st.admit_seq = np.zeros(n, np.int32)
        st.admit_tok = np.zeros(n, np.int32)
        st.admit_budget = np.zeros(n, np.int32)
        st.prompt_lens = np.zeros(n, np.int32)
        st.prompt_counts = np.zeros((n, v), np.float32) if st.use_pen else None
        st.slot_temp = np.zeros(n, np.float32)
        st.slot_top_p = np.ones(n, np.float32)
        st.slot_top_k = np.full(n, -1, np.int32)
        st.slot_pres = np.zeros(n, np.float32)
        st.slot_freq = np.zeros(n, np.float32)
        st.slot_rep = np.ones(n, np.float32)
        st.slot_seed = np.zeros(n, np.int32)
        if self.speculate_k > 0:
            # row n_slots = trash (pad prefill rows), column max_context = trash (masked emits)
            st.hist = torch.zeros((n + 1, self.max_context + 1), dtype=torch.int32, device=dev)
        st.stats = self.last_stats = {
            "chunk_dispatches": 0,
            "slot_chunks": 0,          # sum over dispatches of runnable slots
            "prefill_dispatches": 0,
            "prefill_rows": 0,
            "prefill_pieces": 0,       # chunked-prefill piece rows dispatched
            "prefill_token_area": 0,   # sum of group * bucket (padded work)
            "prompt_tokens": 0,
            "cached_prompt_tokens": 0,  # prompt tokens served from the prefix cache
            "tokens_out": 0,
            "preemptions": 0,
            "verify_steps": 0,         # spec mode: advancing verify forwards, summed over slots
            "wall_s": 0.0,
        }
        st.t_start = time.perf_counter()
        self._st = st

    def add_request(
        self,
        prompt: list[int],
        max_tokens: int | None = None,
        sampling: SamplingParams | None = None,
        seed: int | None = None,
    ) -> int:
        """Enqueue one prompt on the active stream; returns its request id.

        ``max_tokens`` caps this request below the stream's; ``sampling``
        overrides the stream's params for this request (its features must
        be open on the stream; its stop ids are ignored — stop tokens are
        stream-level); ``seed`` makes its sampling reproducible: outputs are
        a pure function of (stream seed, seed, position)."""
        st = self._require_stream()
        sp = st.sp
        if sampling is not None:
            missing = _derive_features(sampling) - st.features
            if missing:
                raise ValueError(
                    f"Per-request sampling needs features {sorted(missing)} not opened on this "
                    f"stream (features={sorted(st.features)}); pass them to begin_stream(features=...)"
                )
            if sampling.n != 1:
                raise _not_ported("sampling.n > 1", "3 (n>1 sampling, pipelined harvest)")
            if self.speculate_k > 0 and (sampling.temperature != 0.0 or sampling.uses_penalties):
                raise ValueError("speculate_k > 0 streams are greedy-only; per-request sampling unavailable")
            if max_tokens is None and sampling.max_tokens != sp.max_tokens:
                max_tokens = sampling.max_tokens
        if max_tokens is not None and not 1 <= max_tokens <= sp.max_tokens:
            raise ValueError(f"Per-request max_tokens ({max_tokens}) must be in [1, stream max_tokens = {sp.max_tokens}]")
        mt = max_tokens if max_tokens is not None else sp.max_tokens
        if len(prompt) == 0:
            raise ValueError("Prompt is empty")
        if len(prompt) + mt > self.max_context:
            raise ValueError(
                f"Prompt ({len(prompt)} tokens) + max_tokens ({mt}) exceeds max_context ({self.max_context})"
            )
        # an admission/preemption cycle can never free more than the whole pool
        need = self._pages_needed(max(round_up(len(prompt), self.prompt_bucket), len(prompt) + mt))
        if need > self.n_pages:
            raise RuntimeError(
                f"KV page pool too small for this prompt: needs {need} pages "
                f"(prompt {len(prompt)} + max_tokens {mt}), pool has {self.n_pages}"
            )
        idx = st.next_idx
        st.next_idx += 1
        base_seed = seed if seed is not None else (42831 + idx)
        req = _Request(
            idx=idx, prompt=list(prompt), max_tokens=max_tokens, sampling=sampling,
            rng_seed=(base_seed * 1000003) & 0x7FFFFFFF,
        )
        self._queue_insert(st, req)
        st.stats["prompt_tokens"] += len(prompt)
        return idx

    def _job_estimate(self, req: _Request, sp: SamplingParams) -> int:
        return len(req.prompt) + (req.max_tokens if req.max_tokens is not None else sp.max_tokens)

    def _queue_insert(self, st: _Stream, req: _Request) -> None:
        """fifo appends; sjf/ljf insert sorted by job size (stable), never
        ahead of requeued (preempted) work at the front."""
        if self.admission_order == "fifo":
            st.queue.append(req)
            return
        sign = 1 if self.admission_order == "sjf" else -1
        key = sign * self._job_estimate(req, st.sp)
        i = 0
        while i < len(st.queue) and (
            st.queue[i].requeued or sign * self._job_estimate(st.queue[i], st.sp) <= key
        ):
            i += 1
        st.queue.insert(i, req)

    def cancel_request(self, request_id: int, *, keep_tokens: int | None = None, finish_reason: str = "abort") -> bool:
        """Finalize ``request_id`` (queued or running) now with
        ``finish_reason``, its output cut to ``keep_tokens``, its slot and
        pages freed; the record surfaces from the next ``step()``. Returns
        False if no live request matched."""
        st = self._require_stream()
        found = False
        for req in [r for r in st.queue if r.idx == request_id]:
            found = True
            st.queue.remove(req)
            st.results[req.idx] = {
                "token_ids": [], "finish_reason": finish_reason,
                "stop_reason": None, "cumulative_logprob": 0.0, "logprobs": None,
            }
            st.completed.append(req.idx)
        for sid, s in enumerate(self._slots):
            if s.req is not None and s.req.idx == request_id and not s.done:
                found = True
                st.active[sid] = False
                st.admit[sid] = 0
                s.done = True
                self._collect(sid, keep_tokens=keep_tokens, finish_reason=finish_reason)
        return found

    @property
    def stream_idle(self) -> bool:
        """True when the active stream has no queued or running requests."""
        st = self._require_stream()
        return not st.queue and all(s.req is None for s in self._slots)

    def end_stream(self) -> None:
        """Close the stream: finalize stats; release every slot and page of
        requests still queued or running (abort semantics)."""
        st = self._st
        if st is None:
            return
        st.stats["wall_s"] = time.perf_counter() - st.t_start
        cap = st.stats["chunk_dispatches"] * self.n_slots * self.chunk * (self.speculate_k + 1)
        st.stats["slot_occupancy"] = st.stats["tokens_out"] / cap if cap else 0.0
        if self.speculate_k > 0:
            # mean tokens emitted per verify forward (1.0 = nothing accepted; at most k+1)
            vs = st.stats["verify_steps"]
            st.stats["tokens_per_verify"] = st.stats["tokens_out"] / vs if vs else 0.0
        for slot in self._slots:
            if slot.req is not None:
                self._free_slot(slot)
        self._st = None

    def _require_stream(self) -> _Stream:
        if self._st is None:
            raise RuntimeError("No active stream; call begin_stream(sp) first")
        return self._st

    # --- per-stream scheduler mechanics --------------------------------------------

    def _admit_slot(self, slot_id: int, req: _Request) -> tuple[int, int] | None:
        """Claim prompt pages + host slot state; returns (slot_id, bucket) for
        the batched prefill, or None when the pool is tight. The admission
        override rides the next chunk's control array; a chunk-prefilled
        slot gets it when its last piece is written (``_advance_prefills``)."""
        st = self._st
        p = len(req.prompt)
        p_bucket = round_up(p, self.prompt_bucket)
        slot = self._slots[slot_id]
        esp = req.sampling if req.sampling is not None else st.sp
        st.slot_temp[slot_id] = esp.temperature
        st.slot_top_p[slot_id] = esp.top_p
        st.slot_top_k[slot_id] = esp.top_k
        st.slot_pres[slot_id] = esp.presence_penalty
        st.slot_freq[slot_id] = esp.frequency_penalty
        st.slot_rep[slot_id] = esp.repetition_penalty
        st.slot_seed[slot_id] = req.rng_seed
        hashes: list[bytes] = []
        if self.prefix_caching:
            # reference the longest cached page chain the prompt extends
            matched, hashes = self._match_prefix(req.prompt)
            for pg in matched:
                self._page_refs[pg] += 1
                if self._page_refs[pg] == 1:
                    self._cache_lru.pop(pg, None)  # back in active use
            slot.pages = list(matched)
            self._page_table[slot_id, : len(matched)] = matched
            slot.cached_len = len(matched) * self.page_size
            st.stats["cached_prompt_tokens"] += slot.cached_len
        target = p_bucket
        if 0 < slot.cached_len < p - 1:
            # the suffix pass spans [cached_len, cached_len + suffix bucket),
            # which may overhang p_bucket by less than one bucket
            s_bucket = round_up(p - slot.cached_len, self.prompt_bucket)
            target = min(max(p_bucket, slot.cached_len + s_bucket), self.max_context)
        if not self._ensure_capacity(slot_id, target):
            self._free_slot(slot)  # release the partial allocation (and the matched references)
            return None
        chunked = self.prefill_chunk is not None and (p - 1) - slot.cached_len > self.prefill_chunk
        if hashes and not chunked:
            # register the prompt's remaining full pages: their content is
            # written by this round's prefill, which _prefill_admitted orders
            # before any same-round reader
            for i in range(slot.cached_len // self.page_size, len(hashes)):
                self._prefix_map[hashes[i]] = slot.pages[i]
                self._page_hash[slot.pages[i]] = hashes[i]
        slot.req = req
        slot.seq_len = p - 1
        slot.n_out = 0
        slot.done = False
        if chunked:
            # decode waits until every position < p-1 has K/V; pages register
            # into the cache as the pieces that fill them dispatch
            slot.prefilling = True
            slot.prefilled = slot.cached_len
            slot.hashes = hashes
            return slot_id, p_bucket
        self._open_decode(slot_id)
        return slot_id, p_bucket

    def _open_decode(self, slot_id: int) -> None:
        """Set the admission override that seeds the slot's decode at
        ``p - 1`` with ``prompt[-1]`` (rides the next chunk's control array)."""
        st = self._st
        req = self._slots[slot_id].req
        p = len(req.prompt)
        if st.use_pen:
            st.prompt_counts[slot_id] = np.bincount(req.prompt, minlength=self.cfg.vocab_size).astype(np.float32)
        st.active[slot_id] = True
        st.admit[slot_id] = 1
        st.admit_seq[slot_id] = p - 1
        st.admit_tok[slot_id] = req.prompt[-1]
        st.admit_budget[slot_id] = req.max_tokens if req.max_tokens is not None else st.sp.max_tokens
        st.prompt_lens[slot_id] = p

    def _prefill_admitted(self, admitted: list[tuple[int, int]]) -> None:
        """Batched prefills: one pass per (group bucket, group size); pad rows
        and pages beyond a row's own bucket point at the trash page id.

        Rows whose prefix the cache served run the suffix pass instead, or
        nothing on a full hit (speculation still records their prompt into
        the n-gram history). Full prefills go first and suffix rows keep
        admission order, because a row may read prefix pages that an earlier
        row of the same round writes (the device runs work in the order it is queued)."""
        st = self._st
        full = [t for t in admitted if self._slots[t[0]].cached_len == 0]
        suffix: list[tuple[int, int, int]] = []
        hist_only: list[int] = []
        for slot_id, _ in admitted:
            s = self._slots[slot_id]
            if s.cached_len == 0:
                continue
            if s.cached_len >= len(s.req.prompt) - 1:
                hist_only.append(slot_id)  # decode's first step does the rest
            else:
                suffix.append((slot_id, s.cached_len, len(s.req.prompt)))
        todo = sorted(full, key=lambda t: t[1])  # by bucket
        trash = self.n_pages  # logical sentinel -> trash row in prefill_prompts
        spec = self.speculate_k > 0
        while todo:
            g = next(s for s in self.PREFILL_GROUPS if s <= len(todo))
            batch, todo = todo[:g], todo[g:]
            bucket = max(b for _, b in batch)
            tokens = np.full((g, bucket), self.pad_id, np.int32)
            page_ids = np.full((g, bucket // self.page_size), trash, np.int32)
            slot_ids = np.full(g, self.n_slots, np.int32)  # pad rows -> trash history row
            for r, (slot_id, own_bucket) in enumerate(batch):
                prompt = self._slots[slot_id].req.prompt
                tokens[r, : len(prompt)] = prompt
                own_n = own_bucket // self.page_size
                page_ids[r, :own_n] = self._page_table[slot_id, :own_n]
                slot_ids[r] = slot_id
            prefill_prompts(
                self.params, torch.from_numpy(tokens).to(self.device), self.cfg, self.pools,
                torch.from_numpy(page_ids).to(self.device), n_pages=self.n_pages, attn_impl=self.attn_impl,
                hist=st.hist if spec else None, slot_ids=torch.from_numpy(slot_ids).to(self.device) if spec else None,
            )
            st.stats["prefill_dispatches"] += 1
            st.stats["prefill_rows"] += len(batch)
            st.stats["prefill_token_area"] += g * bucket

        # suffix passes: merge contiguous runs of one suffix bucket only, so
        # the dispatch order keeps admission order (writer before reader)
        idx = 0
        while idx < len(suffix):
            sb = self._suffix_span(suffix[idx])
            j = idx + 1
            while j < len(suffix) and j - idx < self.PREFILL_GROUPS[0] and self._suffix_span(suffix[j]) == sb:
                j += 1
            g = next(s for s in self.PREFILL_GROUPS if s <= j - idx)
            self._dispatch_suffix(suffix[idx : idx + g], sb, with_hist=True)
            idx += g
        if hist_only and spec:
            self._fill_hist(hist_only)

    def _full_prompts(self, slot_ids: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """The slots' whole prompts right-padded to the group's prompt bucket,
        and their history rows: what speculation records for each admission."""
        f_bucket = max(round_up(len(self._slots[sid].req.prompt), self.prompt_bucket) for sid in slot_ids)
        tokens = np.full((len(slot_ids), f_bucket), self.pad_id, np.int32)
        for r, sid in enumerate(slot_ids):
            prompt = self._slots[sid].req.prompt
            tokens[r, : len(prompt)] = prompt
        return tokens, np.asarray(slot_ids, np.int32)

    def _fill_hist(self, slot_ids: list[int]) -> None:
        """Seed the n-gram history rows of slots whose prompt K/V needs no
        (further) prefill. Grouped as prefill groups them, so the pad written
        past each prompt is the JAX engine's: drafts may read past a slot's
        length, and equal drafts keep the verify steps equal to JAX's."""
        st = self._st
        todo = slot_ids
        while todo:
            g = next(s for s in self.PREFILL_GROUPS if s <= len(todo))
            batch, todo = todo[:g], todo[g:]
            tokens, rows = self._full_prompts(batch)
            st.hist[torch.from_numpy(rows).to(self.device).long(), : tokens.shape[1]] = (
                torch.from_numpy(tokens).to(self.device))

    def _suffix_span(self, row: tuple[int, int, int]) -> int:
        """Padded token span of a suffix or piece row ``(slot_id, start, end)``."""
        _, start, end = row
        return round_up(end - start, self.prompt_bucket)

    def _dispatch_suffix(self, batch: list[tuple[int, int, int]], s_bucket: int, *, with_hist: bool) -> None:
        """One suffix-prefill pass over rows ``(slot_id, start, end)`` sharing
        a suffix bucket; pages beyond each row's own go to the trash id.
        ``with_hist`` records the FULL prompt into the n-gram history
        (speculation; chunked pieces leave that to ``_fill_hist`` when the
        last piece is written)."""
        st = self._st
        trash = self.n_pages
        g = len(batch)
        n_new = s_bucket // self.page_size
        tokens = np.full((g, s_bucket), self.pad_id, np.int32)
        start = np.zeros(g, np.int32)
        table = np.full((g, self.max_pages_per_seq), trash, np.int32)
        new_ids = np.full((g, n_new), trash, np.int32)
        for r, (slot_id, c, end) in enumerate(batch):
            s = self._slots[slot_id]
            suf = s.req.prompt[c:end]
            tokens[r, : len(suf)] = suf
            start[r] = c
            n_owned = len(s.pages)
            table[r, :n_owned] = self._page_table[slot_id, :n_owned]
            cn = c // self.page_size
            upto = min(n_new, n_owned - cn)
            new_ids[r, :upto] = self._page_table[slot_id, cn : cn + upto]
        dev = self.device
        hist_kw = {}
        if self.speculate_k > 0 and with_hist:
            full_tokens, slot_ids = self._full_prompts([sid for sid, _, _ in batch])
            hist_kw = dict(hist=st.hist, full_tokens=torch.from_numpy(full_tokens).to(dev),
                           slot_ids=torch.from_numpy(slot_ids).to(dev))
        prefill_suffix(
            self.params, torch.from_numpy(tokens).to(dev), torch.from_numpy(start).to(dev), self.cfg, self.pools,
            torch.from_numpy(table).to(dev), torch.from_numpy(new_ids).to(dev), n_pages=self.n_pages, **hist_kw,
        )
        st.stats["prefill_dispatches"] += 1
        st.stats["prefill_rows"] += g
        st.stats["prefill_token_area"] += g * s_bucket

    def _advance_prefills(self) -> None:
        """Dispatch ONE piece per chunk-prefilling slot (batched by piece
        bucket), register the pages each piece fills into the prefix cache,
        and open decode for slots whose prompt K/V is now complete."""
        st = self._st
        pieces = [
            (sid, s.prefilled, min(s.prefilled + self.prefill_chunk, len(s.req.prompt)))
            for sid, s in enumerate(self._slots) if s.req is not None and s.prefilling
        ]
        by_bucket: dict[int, list[tuple[int, int, int]]] = {}
        for row in pieces:
            by_bucket.setdefault(self._suffix_span(row), []).append(row)
        for sb, rows in sorted(by_bucket.items()):
            while rows:
                g = next(x for x in self.PREFILL_GROUPS if x <= len(rows))
                batch, rows = rows[:g], rows[g:]
                self._dispatch_suffix(batch, sb, with_hist=False)
                st.stats["prefill_pieces"] += g
        completed: list[int] = []
        for sid, c, end in pieces:
            s = self._slots[sid]
            # register the pages this piece filled (their content is now written)
            for i in range(max(c, s.cached_len) // self.page_size, min(end // self.page_size, len(s.hashes))):
                h = s.hashes[i]
                if h not in self._prefix_map:
                    self._prefix_map[h] = s.pages[i]
                    self._page_hash[s.pages[i]] = h
            s.prefilled = end
            if end >= len(s.req.prompt) - 1:
                s.prefilling = False
                completed.append(sid)
                self._open_decode(sid)
        if completed and self.speculate_k > 0:
            self._fill_hist(completed)

    def _collect(self, slot_id: int, *, keep_tokens: int | None = None, finish_reason: str | None = None) -> None:
        st = self._st
        slot = self._slots[slot_id]
        req = slot.req
        token_ids = req.out[: req.max_tokens if req.max_tokens is not None else st.sp.max_tokens]
        if keep_tokens is not None:  # cancel_request's stop-string cut
            token_ids = token_ids[:keep_tokens]
        stopped = bool(token_ids) and token_ids[-1] in st.stop_set and finish_reason is None
        st.results[req.idx] = {
            "token_ids": token_ids,
            "finish_reason": finish_reason if finish_reason is not None else ("stop" if stopped else "length"),
            "stop_reason": token_ids[-1] if stopped else None,
            "cumulative_logprob": req.clp if keep_tokens is None or not req.lps
            else float(sum(req.lps[: len(token_ids)])),
            # per-token logprobs of the emitted tokens; None in spec mode (as in JAX)
            "logprobs": req.lps[: len(token_ids)] if self.speculate_k == 0 else None,
        }
        self._free_slot(slot)
        st.active[slot_id] = False
        st.completed.append(req.idx)

    def _control(self, st: _Stream) -> np.ndarray:
        """The packed int32 control array: host scalar columns + page table."""
        cols = np.stack(
            [st.active.astype(np.int32), st.admit, st.admit_seq, st.admit_tok, st.admit_budget, st.prompt_lens,
             st.slot_temp.view(np.int32), st.slot_top_p.view(np.int32), st.slot_top_k,
             st.slot_pres.view(np.int32), st.slot_freq.view(np.int32), st.slot_rep.view(np.int32),
             st.slot_seed],
            axis=1,
        )
        return np.concatenate([cols, self._page_table], axis=1)

    def _run_chunk(self, st: _Stream, control_np: np.ndarray, any_samp: bool) -> np.ndarray:
        """``chunk`` decode steps for every slot on the device; returns the
        packed host view ``[slots, 2*chunk + 3]`` int32: [emitted tokens |
        per-token logprobs (f32 bits) | done | seq_len | clp (f32 bits)]."""
        cfg, feats = self.cfg, st.features
        control = torch.from_numpy(control_np).to(self.device)

        def f32(col: int) -> torch.Tensor:  # an f32 column sent as its int32 bits
            return control[:, col].contiguous().view(torch.float32)

        active = control[:, 0] != 0
        admit = control[:, 1] != 0
        seq_lens = torch.where(admit, control[:, 2], st.seq_lens)
        tok = torch.where(admit, control[:, 3], st.tok)
        budget = torch.where(admit, control[:, 4], st.budget)
        prompt_lens = control[:, 5]
        done = st.done & ~admit
        temp, top_p, top_k = f32(6), f32(7), control[:, 8]
        pres, freq, rep = f32(9), f32(10), f32(11)
        seed_col = control[:, 12]
        page_table = control[:, _N_CTRL_COLS:]
        out_counts = prompt_counts = None
        if st.use_pen:
            out_counts = torch.where(admit[:, None], torch.zeros_like(st.out_counts), st.out_counts)
            prompt_counts = torch.from_numpy(st.prompt_counts).to(self.device)
        rows = torch.arange(self.n_slots, device=self.device)
        clp = torch.zeros(self.n_slots, dtype=torch.float32, device=self.device)
        emitted, lps = [], []
        for _ in range(self.chunk):
            advance = active & ~done
            logits = decode_step_tokens(
                self.params, tok, cfg, self.pools, page_table, seq_lens, advance,
                n_pages=self.n_pages, attn_impl=self.attn_impl,
            )
            if st.use_pen:
                # the consumed token is an OUTPUT only once the cache has grown
                # past the prompt (the first consumed token is prompt[-1])
                counted = (advance & (seq_lens >= prompt_lens)).to(torch.float32)
                out_counts.index_put_((rows, tok.long()), counted, accumulate=True)
            positions = seq_lens
            next_tok, lp = _sample_rows(
                logits, feats, any_samp, temp, top_p, top_k, pres, freq, rep,
                lambda: _gumbel_noise(st.seed, seed_col, positions, logits.shape[-1]),
                out_counts, prompt_counts,
            )
            clp = clp + torch.where(advance, lp, torch.zeros_like(lp))
            step = advance.to(torch.int32)
            seq_lens = seq_lens + step
            budget = budget - step
            is_stop = torch.isin(next_tok, st.stop_ids) if st.stop_ids.numel() else torch.zeros_like(done)
            done = done | (advance & (is_stop | (budget <= 0)))
            emitted.append(torch.where(advance, next_tok, torch.full_like(next_tok, self.pad_id)))
            lps.append(torch.where(advance, lp, torch.zeros_like(lp)))
            tok = torch.where(advance, next_tok, tok)
        st.seq_lens, st.tok, st.done, st.budget = seq_lens, tok, done, budget
        if st.use_pen:
            st.out_counts = out_counts
        packed = torch.cat(
            [
                torch.stack(emitted, dim=1),
                torch.stack(lps, dim=1).view(torch.int32),
                done.to(torch.int32)[:, None],
                seq_lens[:, None],
                clp.view(torch.int32)[:, None],
            ],
            dim=1,
        )
        return packed.cpu().numpy()

    def _run_chunk_spec(self, st: _Stream, control_np: np.ndarray) -> np.ndarray:
        """``chunk`` speculative steps for every slot on the device: each
        drafts k tokens per slot from its history (most recent bigram match),
        verifies all k+1 in one forward, and emits the longest argmax-matching
        prefix plus one token, cut at a stop token or the budget. Returns the
        packed host view ``[slots, chunk*(k+1) + 4]`` int32: [emitted tokens,
        compacted at each slot's cursor | done | seq_len | clp (f32 bits) |
        verify steps]."""
        dev, pad = self.device, self.pad_id
        control = torch.from_numpy(control_np).to(dev)
        active = control[:, 0] != 0
        admit = control[:, 1] != 0
        seq_lens = torch.where(admit, control[:, 2], st.seq_lens)
        tok = torch.where(admit, control[:, 3], st.tok)
        budget = torch.where(admit, control[:, 4], st.budget)
        prompt_lens = control[:, 5]
        done = st.done & ~admit
        page_table = control[:, _N_CTRL_COLS:]  # greedy only: sampling columns unused
        t_q, w, bucket = self.speculate_k + 1, self.max_context, self.prompt_bucket
        # Per-slot write cap, the host's provisioning cap max(round_up(p,
        # bucket), p + the REQUEST's budget): seq_lens + budget + 1 equals
        # p + max_tokens at every step. A stream-level cap would let drafts
        # write through stale page-table entries into other requests' pages.
        cap = torch.clamp(torch.maximum((prompt_lens + bucket - 1) // bucket * bucket, seq_lens + budget + 1), max=w)
        n = self.n_slots
        rows = torch.arange(n, device=dev)
        iota_t = torch.arange(t_q, dtype=torch.int32, device=dev)
        posj = torch.arange(w - 1, dtype=torch.int32, device=dev)
        buf_w = self.chunk * t_q + 1  # +1 trash column for masked emits
        out_buf = torch.full((n, buf_w), pad, dtype=torch.int32, device=dev)
        cursor = torch.zeros(n, dtype=torch.int32, device=dev)
        clp = torch.zeros(n, dtype=torch.float32, device=dev)
        nstep = torch.zeros(n, dtype=torch.int32, device=dev)
        hist = st.hist  # updated in place
        histw = hist[:n, :w]  # without the trash row and column
        stop_ids = st.stop_ids
        for _ in range(self.chunk):
            advance = active & ~done
            nstep += advance.to(torch.int32)
            length = seq_lens  # position of the input token
            # ---- draft: the continuation of the most recent (prev, tok) bigram in the history
            b0 = histw[rows, torch.clamp(length - 1, 0, w - 1).long()]
            can = ((histw[:, :-1] == b0[:, None]) & (histw[:, 1:] == tok[:, None])
                   & ((posj + 1)[None, :] < length[:, None]) & (length[:, None] >= 2))
            jbest = torch.where(can, posj[None, :], torch.full_like(posj, -1)[None, :]).amax(dim=1)
            found = jbest >= 0
            gidx = torch.clamp(jbest[:, None] + 1 + iota_t[None, :], 0, w - 1)
            cont = torch.gather(histw, 1, gidx.long())
            draft = torch.cat([tok[:, None], torch.where(found[:, None], cont[:, 1:], pad)], dim=1)
            # ---- verify all T candidates in one forward
            logits = decode_step_tokens_spec(
                self.params, draft, self.cfg, self.pools, page_table, seq_lens, advance, cap,
                n_pages=self.n_pages, attn_impl=self.attn_impl,
            )
            out = torch.argmax(logits, dim=-1).to(torch.int32)  # [slots, T]
            lp = torch.gather(logits, 2, out[..., None].long())[..., 0] - torch.logsumexp(logits, dim=-1)
            # ---- accept the longest matching prefix and the token after it
            match = draft[:, 1:] == out[:, :-1]
            accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1, dtype=torch.int32)
            n_full = torch.minimum(1 + accepted, budget)
            is_stop = torch.isin(out, stop_ids) if stop_ids.numel() else torch.zeros_like(out, dtype=torch.bool)
            cand = is_stop & (iota_t[None, :] < n_full[:, None])
            stop_j = torch.where(cand, iota_t[None, :], t_q).amin(dim=1)
            stopped = stop_j < t_q
            n_emit = torch.where(stopped, stop_j + 1, n_full)
            n_emit = torch.where(advance, n_emit, 0).to(torch.int32)
            newly_done = advance & (stopped | (budget - n_emit <= 0))
            emit = iota_t[None, :] < n_emit[:, None]
            # compact the emitted tokens at each slot's cursor; emitted token j
            # becomes history position length + 1 + j
            bidx = torch.where(emit, cursor[:, None] + iota_t[None, :], buf_w - 1)
            out_buf[rows[:, None], bidx.long()] = torch.where(emit, out, pad)
            hidx = torch.where(emit, torch.clamp(length[:, None] + 1 + iota_t[None, :], 0, w), w)
            hist[rows[:, None], hidx.long()] = torch.where(emit, out, 0)
            cursor = cursor + n_emit
            clp = clp + torch.where(emit & advance[:, None], lp, 0.0).sum(dim=1)
            seq_lens = seq_lens + n_emit
            budget = budget - n_emit
            last = torch.clamp(n_emit - 1, 0, t_q - 1)
            tok = torch.where(advance & (n_emit > 0), torch.gather(out, 1, last[:, None].long())[:, 0], tok)
            done = done | newly_done
        st.seq_lens, st.tok, st.done, st.budget = seq_lens, tok, done, budget
        packed = torch.cat(
            [out_buf[:, : self.chunk * t_q], done.to(torch.int32)[:, None], seq_lens[:, None],
             clp.view(torch.int32)[:, None], nstep[:, None]],
            dim=1,
        )
        return packed.cpu().numpy()

    def _harvest(self, packed: np.ndarray, runnable: list[int]) -> None:
        st = self._st
        if self.speculate_k > 0:  # [tokens | done | seq_len | clp | verify steps]
            chunk = packed.shape[1] - 4
            lps_h = None
            tail = packed[:, chunk:]
            st.stats["verify_steps"] += int(tail[:, 3].sum())
        else:  # [tokens | per-token logprobs (f32 bits) | done | seq_len | clp]
            chunk = (packed.shape[1] - 3) // 2
            lps_h = packed[:, chunk : 2 * chunk].view(np.float32)
            tail = packed[:, 2 * chunk :]
        clp_h = tail[:, 2].view(np.float32)
        for slot_id in runnable:
            s = self._slots[slot_id]
            n_new = int(tail[slot_id, 1]) - s.seq_len
            s.seq_len = int(tail[slot_id, 1])
            if n_new > 0:
                s.req.out.extend(int(t) for t in packed[slot_id, :n_new])
                if lps_h is not None:
                    s.req.lps.extend(float(x) for x in lps_h[slot_id, :n_new])
                s.req.clp += float(clp_h[slot_id])
                s.n_out += n_new
                st.stats["tokens_out"] += n_new
            if tail[slot_id, 0] != 0:
                s.done = True
                self._collect(slot_id)

    def step(self) -> list[dict[str, Any]]:
        """ONE scheduler iteration on the active stream: admit queued requests
        into free slots (batched prefill), provision pages (preempting when
        the pool runs dry), run one decode chunk and harvest it.

        Returns the requests that completed, each as ``{"request_id": int,
        "outputs": [result dict]}``. On an exception the stream is ended
        (every slot and page released) and the exception re-raised."""
        st = self._require_stream()
        try:
            self._step_inner(st)
        except BaseException:
            # a slot admitted this step may have registered prefix-cache pages
            # its prefill never wrote: drop the cache before releasing pages
            self._clear_prefix_cache()
            self.end_stream()
            raise
        out = []
        while st.completed:
            idx = st.completed.popleft()
            out.append({"request_id": idx, "outputs": [st.results.pop(idx)]})
        return out

    def _step_inner(self, st: _Stream) -> None:
        sp = st.sp
        # 1) admit queued requests into free slots, then prefill them batched
        admitted: list[tuple[int, int]] = []
        free_ids = [i for i, s in enumerate(self._slots) if s.req is None]
        while st.queue and not st.suspend_admission and free_ids:
            claim = self._admit_slot(free_ids[0], st.queue[0])
            if claim is None:
                break  # pool tight: let running slots finish
            st.queue.pop(0)
            if not self._slots[claim[0]].prefilling:
                admitted.append(claim)  # chunk-prefilling slots piece through _advance_prefills
            free_ids = free_ids[1:]
        if admitted:
            self._prefill_admitted(admitted)
        if self.prefill_chunk is not None:
            self._advance_prefills()

        # a chunk-prefilling slot is not runnable: it is inactive in the control
        # array and its device done flag still holds the previous occupant's
        runnable = self._runnable()
        if not runnable:
            if any(s.req is not None and s.prefilling for s in self._slots):
                return  # the pieces progress; decode has nothing to run yet
            if st.suspend_admission:
                st.suspend_admission = False  # nothing else can progress; retry admission
                return
            if st.queue and not admitted:
                # nothing runs, every page is free, and a prompt still does not fit
                raise RuntimeError("KV page pool too small to admit any prompt; raise n_pages")
            return

        # 2) pages for the next chunk of every running slot; a speculative step
        # advances up to k+1 tokens and writes k draft positions past its last
        # advance, so provision for both
        t_mult = self.speculate_k + 1
        lookahead = self.chunk * t_mult + t_mult - 1
        for slot_id in runnable:
            s = self._slots[slot_id]
            if s.req is None or s.done:
                continue  # preempted while provisioning others
            mt = s.req.max_tokens if s.req.max_tokens is not None else sp.max_tokens
            cap = max(round_up(len(s.req.prompt), self.prompt_bucket), len(s.req.prompt) + mt)
            target = min(s.seq_len + lookahead + 1, self.max_context, cap)
            while not self._ensure_capacity(slot_id, target):
                victim = self._preempt_youngest(st.queue)
                if victim is None:
                    raise RuntimeError("KV page pool exhausted and nothing to preempt")
                st.stats["preemptions"] += 1
                st.active[victim] = False
                st.admit[victim] = 0
                if self._slots[slot_id].req is None:  # we preempted ourselves
                    # let the surviving slots progress before re-admitting it
                    st.suspend_admission = True
                    return

        # 3) one decode chunk for every running slot, harvested at once
        runnable = self._runnable()
        if not runnable:
            return
        if self.speculate_k > 0:
            packed = self._run_chunk_spec(st, self._control(st))
        else:
            any_samp = bool(np.any(st.slot_temp[runnable] > 0.0))
            packed = self._run_chunk(st, self._control(st), any_samp)
        st.admit[:] = 0  # consumed by this dispatch
        st.stats["chunk_dispatches"] += 1
        st.stats["slot_chunks"] += len(runnable)
        st.suspend_admission = False  # a chunk ran: progress is real
        self._harvest(packed, runnable)

    def _runnable(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s.req is not None and not s.done and not s.prefilling]

    # --- batch driver ------------------------------------------------------------

    def generate_batch(self, prompts: list[list[int]], sp: SamplingParams, seed: int = 0) -> list[dict[str, Any]]:
        """Generate for ragged prompts with continuous batching; returns
        vLLM-shaped dicts in prompt order. A thin driver over the streaming
        API: begin_stream -> add_request xN -> step until idle -> end_stream."""
        self.begin_stream(sp, seed)
        try:
            ids = [self.add_request(t) for t in prompts]
            by_id: dict[int, dict[str, Any]] = {}
            while not self.stream_idle:
                for rec in self.step():
                    by_id[rec["request_id"]] = rec["outputs"][0]
        finally:
            self.end_stream()
        return [by_id[i] for i in ids]
