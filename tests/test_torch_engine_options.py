"""The port's PagedDecodeEngine with the serving options of the JAX engine:
speculative decoding (``speculate_k``), the prefix cache (on by default) and
chunked prefill (``prefill_chunk``), on the CPU (plain attention) against the
JAX engine and the naive full-recompute greedy oracle, plus the contracts of
tests/test_paged_decode.py for each option and their compositions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssi_tpu.generate.engine import SamplingParams as JSamplingParams
from ssi_tpu.generate.paged_engine import PagedDecodeEngine as JPagedDecodeEngine
from ssi_tpu.models.llama3 import init_params
from ssi_tpu_torch.generate.engine import SamplingParams
from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
from ssi_tpu_torch.models.llama3 import params_from_numpy
from tests import helpers
from tests.test_torch_paged_engine import make_engine, no_leaks, run_stream
from tests.test_torch_pipeline import slow_jax, slow_port


@pytest.fixture(scope="module")
def setup():
    cfg = helpers.tiny_config()
    jparams = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    return cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


_naive_cache: dict = {}


def naive(jparams, cfg, prompt, n):
    key = (tuple(prompt), n)
    if key not in _naive_cache:
        _naive_cache[key] = helpers.naive_greedy(jparams, cfg, prompt, n)
    return _naive_cache[key]


def greedy(max_tokens, **kw):
    return SamplingParams(temperature=0.0, max_tokens=max_tokens, **kw)


# --- speculative decoding ----------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_spec_matches_jax_engine_and_naive(setup, k):
    """speculate_k is lossless: tokens equal the JAX engine's (gather
    attention, both at harvest depth 1) and the naive stream, with the
    same verify steps and tokens out, and real acceptance (tokens_per_verify
    > 1: tiny-model greedy streams cycle, feeding the bigram drafter)."""
    spec_parity(setup, k, depth=1)


@pytest.mark.parametrize("k", [1, 3])
def test_spec_matches_jax_engine_at_depth_2(setup, k):
    """The same at the default depth 2, both engines' chunks unfinished until
    harvested (so both run one schedule: the drafter reads history past a
    slot's length, and verify steps match only on the same schedule)."""
    spec_parity(setup, k, depth=2)


def spec_parity(setup, k, depth):
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 11, 17, 3, 9, 14]]
    engine = slow_port(make_engine(tparams, cfg, speculate_k=k, pipeline_depth=depth))
    outs = engine.generate_batch(prompts, greedy(12))
    jeng = slow_jax(JPagedDecodeEngine(jparams, cfg, pad_id=0, n_slots=4, page_size=8, prompt_bucket=8,
                                       max_context=64, chunk=4, attn_impl="gather", pipeline_depth=depth,
                                       speculate_k=k))
    jouts = jeng.generate_batch(prompts, JSamplingParams(temperature=0.0, max_tokens=12))
    for i, (prompt, out, jout) in enumerate(zip(prompts, outs, jouts)):
        assert out["token_ids"] == jout["token_ids"] == naive(jparams, cfg, prompt, 12), (k, i)
        assert out["finish_reason"] == "length" and out["logprobs"] is None
        assert out["cumulative_logprob"] == pytest.approx(jout["cumulative_logprob"], abs=1e-3)
    st, jst = engine.last_stats, jeng.last_stats
    assert st["verify_steps"] == jst["verify_steps"] > 0
    assert st["tokens_out"] == jst["tokens_out"] == 6 * 12
    assert st["tokens_per_verify"] > 1.0
    assert no_leaks(engine)


def test_spec_stop_and_budget(setup):
    """Stop tokens fire at the exact sequential position inside an acceptance
    window; budgets are exact; clp equals the non-speculative engine's."""
    cfg, jparams, tparams = setup
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, 9).tolist()
    seq = naive(jparams, cfg, prompt, 8)
    engine = make_engine(tparams, cfg, speculate_k=3)
    out = engine.generate_batch([prompt], greedy(8, stop_token_ids=(seq[0],)))[0]
    assert out["token_ids"] == [seq[0]] and out["finish_reason"] == "stop" and out["stop_reason"] == seq[0]
    stop_at = next((i for i in range(1, 8) if seq[i] not in seq[:i]), None)
    if stop_at is not None:
        out = engine.generate_batch([prompt], greedy(8, stop_token_ids=(seq[stop_at],)))[0]
        assert out["token_ids"] == seq[: stop_at + 1] and out["finish_reason"] == "stop"
    out = engine.generate_batch([prompt], greedy(3))[0]
    assert out["token_ids"] == seq[:3]
    base = make_engine(tparams, cfg).generate_batch([prompt], greedy(3))[0]
    assert out["cumulative_logprob"] == pytest.approx(base["cumulative_logprob"], abs=1e-3)
    assert no_leaks(engine)


def test_spec_guards(setup):
    """Lossless speculation is greedy-only; k outside [0, 7] is refused."""
    cfg, _, tparams = setup
    for k in (-1, 8):
        with pytest.raises(ValueError, match="speculate_k"):
            make_engine(tparams, cfg, speculate_k=k)
    engine = make_engine(tparams, cfg, speculate_k=2)
    with pytest.raises(ValueError, match="greedy"):
        engine.generate_batch([[1, 2]], SamplingParams(temperature=0.7, max_tokens=2))
    with pytest.raises(ValueError, match="penalt"):
        engine.generate_batch([[1, 2]], greedy(2, repetition_penalty=1.2))
    with pytest.raises(ValueError, match="greedy-only"):
        engine.begin_stream(greedy(2), features={"sample"})
    engine.begin_stream(greedy(2))
    with pytest.raises(ValueError, match="features|greedy-only"):
        engine.add_request([1, 2], sampling=SamplingParams(temperature=0.5, max_tokens=2))
    engine.end_stream()
    assert no_leaks(engine)


def test_spec_streaming_refills(setup):
    """Slot reuse under speculation: a freed slot's history row is reseeded
    by the next admission (its stale tail is never matched)."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20))).tolist() for _ in range(9)]
    engine = make_engine(tparams, cfg, n_slots=3, speculate_k=2)
    outs = engine.generate_batch(prompts, greedy(6))
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive(jparams, cfg, prompt, 6)
    assert no_leaks(engine)


def test_spec_per_request_budget_no_cross_corruption(setup):
    """The device-side draft-write cap uses the PER-REQUEST budget: short-
    budget requests whose slots hold stale page-table tails share the stream
    with full-budget neighbours, and every output is the sequential one."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(23)
    engine = make_engine(tparams, cfg, n_slots=2, speculate_k=3, n_pages=18)
    engine.begin_stream(greedy(40))
    long_prompts = [rng.integers(0, cfg.vocab_size, 17).tolist() for _ in range(2)]
    short_prompts = [rng.integers(0, cfg.vocab_size, 9).tolist() for _ in range(2)]
    victims = [rng.integers(0, cfg.vocab_size, 11).tolist() for _ in range(2)]
    ids = [engine.add_request(p) for p in long_prompts]
    ids += [engine.add_request(short_prompts[0], max_tokens=3), engine.add_request(victims[0]),
            engine.add_request(short_prompts[1], max_tokens=2), engine.add_request(victims[1])]
    done = {}
    for _ in range(400):
        for rec in engine.step():
            done[rec["request_id"]] = rec["outputs"][0]
        if len(done) == len(ids):
            break
    engine.end_stream()
    want = [(long_prompts[0], 40), (long_prompts[1], 40), (short_prompts[0], 3), (victims[0], 40),
            (short_prompts[1], 2), (victims[1], 40)]
    for rid, (prompt, mt) in zip(ids, want):
        assert done[rid]["token_ids"] == naive(jparams, cfg, prompt, mt), rid
    assert no_leaks(engine)


def test_spec_stale_page_table_tail_never_written(setup):
    """Draft K/V stops at the per-request cap: with max_tokens=1 the first
    verify step (T=8 from position 14) would reach page index 2, a stale
    entry pointing at a page owned elsewhere (sentinel-filled here)."""
    cfg, jparams, tparams = setup
    engine = make_engine(tparams, cfg, n_slots=1, speculate_k=7, n_pages=10)
    victim = 7
    engine._free_pages.remove(victim)
    rows = torch.tensor([layer * engine.n_pages + victim for layer in range(cfg.num_layers)])
    for key in ("k", "v"):
        engine.pools[key][rows] = 7.0
    engine._page_table[0, 2:] = victim
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, 15).tolist()
    engine.begin_stream(greedy(40))
    rid = engine.add_request(prompt, max_tokens=1)  # cap = max(16, 15 + 1) = 16
    done = {}
    for _ in range(50):
        for rec in engine.step():
            done[rec["request_id"]] = rec["outputs"][0]
        if done:
            break
    engine.end_stream()
    assert done[rid]["token_ids"] == naive(jparams, cfg, prompt, 1)
    for key in ("k", "v"):
        assert bool((engine.pools[key][rows] == 7.0).all()), f"{key} pool: a page past the request cap was written"


# --- prefix caching ------------------------------------------------------------------


def test_prefix_cache_cross_request_lossless(setup):
    """A later stream whose prompts extend a cached prefix reuses its pages,
    prefills only the tail, and emits the uncached greedy stream."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(31)
    base = rng.integers(0, cfg.vocab_size, 21).tolist()  # two full ps=8 pages cacheable
    engine = make_engine(tparams, cfg)
    outs1 = engine.generate_batch([base], greedy(6))
    assert engine.last_stats["cached_prompt_tokens"] == 0
    area1 = engine.last_stats["prefill_token_area"]
    assert no_leaks(engine) and len(engine._cache_lru) == 2
    outs2 = engine.generate_batch([base], greedy(6))  # (21-1)//8 pages hit; a suffix pass for 16..20
    assert engine.last_stats["cached_prompt_tokens"] == 16 and engine.last_stats["prefill_token_area"] == 8
    assert outs2[0]["token_ids"] == outs1[0]["token_ids"] == naive(jparams, cfg, base, 6)
    ext = base[:16] + rng.integers(0, cfg.vocab_size, 9).tolist()
    outs3 = engine.generate_batch([ext], greedy(6))
    assert engine.last_stats["cached_prompt_tokens"] == 16
    assert engine.last_stats["prefill_token_area"] < area1
    assert outs3[0]["token_ids"] == naive(jparams, cfg, ext, 6)
    div = base[:8] + rng.integers(0, cfg.vocab_size, 12).tolist()
    outs4 = engine.generate_batch([div], greedy(6))
    assert engine.last_stats["cached_prompt_tokens"] == 8
    assert outs4[0]["token_ids"] == naive(jparams, cfg, div, 6)
    assert no_leaks(engine)


def test_prefix_cache_same_wave(setup):
    """Prompts sharing a prefix inside one batch: later admissions of the
    round reference the pages the first one registers (writer before reader)."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(37)
    shared = rng.integers(0, cfg.vocab_size, 16).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 3, 7]]
    engine = make_engine(tparams, cfg)
    outs = engine.generate_batch(prompts, greedy(5))
    assert engine.last_stats["cached_prompt_tokens"] == 2 * 16
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive(jparams, cfg, prompt, 5)
    assert no_leaks(engine)


def test_prefix_cache_eviction_under_pressure(setup):
    """A 12-page pool forces LRU eviction of parked pages: allocation
    reclaims them before reporting the pool dry; outputs stay lossless."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(41)
    engine = make_engine(tparams, cfg, n_slots=2, n_pages=12)
    for _ in range(3):
        batch = [rng.integers(0, cfg.vocab_size, 17).tolist() for _ in range(2)]
        outs = engine.generate_batch(batch, greedy(4))
        for prompt, out in zip(batch, outs):
            assert out["token_ids"] == naive(jparams, cfg, prompt, 4)
        assert no_leaks(engine)
    assert len(engine._cache_lru) <= 12


def test_prefix_cache_off(setup):
    cfg, jparams, tparams = setup
    prompt = np.random.default_rng(43).integers(0, cfg.vocab_size, 20).tolist()
    engine = make_engine(tparams, cfg, prefix_caching=False)
    outs1 = engine.generate_batch([prompt], greedy(4))
    outs2 = engine.generate_batch([prompt], greedy(4))
    assert engine.last_stats["cached_prompt_tokens"] == 0 and not engine._prefix_map
    assert len(engine._free_pages) == engine.n_pages
    assert outs1[0]["token_ids"] == outs2[0]["token_ids"] == naive(jparams, cfg, prompt, 4)


def test_prefix_cache_is_the_default(setup):
    cfg, _, tparams = setup
    assert make_engine(tparams, cfg).prefix_caching is True


def test_prefix_cache_with_spec_decode(setup):
    """A full hit skips prefill but still seeds the n-gram history; an
    extension's suffix pass records the FULL prompt; both lossless."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(47)
    seq = rng.integers(0, cfg.vocab_size, 17).tolist()
    engine = make_engine(tparams, cfg, speculate_k=3)
    outs1 = engine.generate_batch([seq], greedy(8))
    outs2 = engine.generate_batch([seq], greedy(8))
    assert engine.last_stats["cached_prompt_tokens"] == 16
    assert outs1[0]["token_ids"] == outs2[0]["token_ids"] == naive(jparams, cfg, seq, 8)
    ext = seq[:16] + rng.integers(0, cfg.vocab_size, 6).tolist()
    outs3 = engine.generate_batch([ext], greedy(8))
    assert engine.last_stats["cached_prompt_tokens"] == 16
    assert outs3[0]["token_ids"] == naive(jparams, cfg, ext, 8)
    assert no_leaks(engine)


def test_prefix_cache_survives_preemption(setup):
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(59)
    engine = make_engine(tparams, cfg, n_slots=3, n_pages=9)  # 17 + 12 tokens need 4 pages apiece
    prompts = [rng.integers(0, cfg.vocab_size, 17).tolist() for _ in range(3)]
    outs = engine.generate_batch(prompts, greedy(12))
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive(jparams, cfg, prompt, 12)
    assert engine.last_stats["preemptions"] > 0
    assert no_leaks(engine)


def test_prefix_cache_cleared_when_a_step_raises(setup, monkeypatch):
    """An error inside step() ends the stream and drops the whole cache
    (pages registered by an admission whose prefill never ran)."""
    cfg, _, tparams = setup
    engine = make_engine(tparams, cfg)
    prompt = list(range(1, 21))
    engine.generate_batch([prompt], greedy(2))
    assert engine._prefix_map

    def boom(*args, **kwargs):
        raise RuntimeError("prefill failed")

    monkeypatch.setattr("ssi_tpu_torch.generate.paged_engine.prefill_prompts", boom)
    with pytest.raises(RuntimeError, match="prefill failed"):
        engine.generate_batch([list(range(30, 50))], greedy(2))
    assert not engine._prefix_map and not engine._page_hash
    assert no_leaks(engine) and len(engine._free_pages) == engine.n_pages


# --- chunked prefill -------------------------------------------------------------------


def test_chunked_prefill_lossless(setup):
    """Long prompts piece through prefill; short ones are unaffected."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(71)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [40, 5, 23, 9]]
    engine = make_engine(tparams, cfg, prefill_chunk=8)
    outs = engine.generate_batch(prompts, greedy(6))
    assert engine.last_stats["prefill_pieces"] == 5 + 3  # 40 -> 5 pieces, 23 -> 3; 9 needs 8 positions
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive(jparams, cfg, prompt, 6)
    assert no_leaks(engine)


def test_chunked_prefill_interleaves_decode(setup):
    """While a long arrival pieces through prefill, the running slot keeps decoding."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(73)
    engine = make_engine(tparams, cfg, n_slots=2, prefill_chunk=8)
    short = rng.integers(0, cfg.vocab_size, 4).tolist()
    long = rng.integers(0, cfg.vocab_size, 40).tolist()
    engine.begin_stream(greedy(10))
    engine.add_request(short)
    done = {rec["request_id"]: rec for rec in engine.step()}
    engine.add_request(long)
    during = 0
    while not engine.stream_idle:
        was_prefilling = any(s.req is not None and s.prefilling for s in engine._slots)
        before = engine._st.stats["chunk_dispatches"]
        for rec in engine.step():
            done[rec["request_id"]] = rec
        if was_prefilling and engine._st.stats["chunk_dispatches"] > before:
            during += 1
    engine.end_stream()
    assert during > 0
    assert done[0]["outputs"][0]["token_ids"] == naive(jparams, cfg, short, 10)
    assert done[1]["outputs"][0]["token_ids"] == naive(jparams, cfg, long, 10)


def test_chunked_prefill_with_prefix_cache(setup):
    """Pieces register pages as they dispatch: a second stream over the same
    long prompt starts at the cached length and skips those pieces."""
    cfg, jparams, tparams = setup
    long = np.random.default_rng(79).integers(0, cfg.vocab_size, 40).tolist()
    engine = make_engine(tparams, cfg, prefill_chunk=8)
    outs1 = engine.generate_batch([long], greedy(5))
    pieces1 = engine.last_stats["prefill_pieces"]
    outs2 = engine.generate_batch([long], greedy(5))
    assert engine.last_stats["cached_prompt_tokens"] == 32
    assert engine.last_stats["prefill_pieces"] < pieces1
    assert outs1[0]["token_ids"] == outs2[0]["token_ids"] == naive(jparams, cfg, long, 5)
    assert no_leaks(engine)


def test_chunked_prefill_preemption_mid_prefill(setup):
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(83)
    engine = make_engine(tparams, cfg, n_slots=2, n_pages=8, prefill_chunk=8)
    prompts = [rng.integers(0, cfg.vocab_size, 30).tolist(), rng.integers(0, cfg.vocab_size, 8).tolist()]
    outs = engine.generate_batch(prompts, greedy(8))
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == naive(jparams, cfg, prompt, 8)
    assert no_leaks(engine)


def test_chunked_prefill_with_spec_decode(setup):
    """Pieces leave the history fill to the last piece; speculation stays lossless."""
    cfg, jparams, tparams = setup
    long = np.random.default_rng(89).integers(0, cfg.vocab_size, 33).tolist()
    engine = make_engine(tparams, cfg, prefill_chunk=8, speculate_k=2)
    outs = engine.generate_batch([long], greedy(8))
    assert engine.last_stats["prefill_pieces"] >= 4
    assert outs[0]["token_ids"] == naive(jparams, cfg, long, 8)
    assert no_leaks(engine)


def test_chunked_prefill_invalid_chunk(setup):
    cfg, _, tparams = setup
    for bad in (12, 0, -8):
        with pytest.raises(ValueError, match="prefill_chunk"):
            make_engine(tparams, cfg, prefill_chunk=bad)
    with pytest.raises(ValueError, match="page_size"):
        make_engine(tparams, cfg, page_size=12, prompt_bucket=12)


# --- the options together ----------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_all_options_match_jax_engine(setup, k):
    """Speculation, the prefix cache and chunked prefill together, over
    prompts that share stems, against the JAX engine with the same options:
    identical tokens, verify steps, tokens out and cached prompt tokens."""
    all_options_parity(setup, k, depth=1)


@pytest.mark.parametrize("k", [1, 3])
def test_all_options_match_jax_engine_at_depth_2(setup, k):
    """The same with both engines at depth 2, their chunks unfinished until harvested."""
    all_options_parity(setup, k, depth=2)


def all_options_parity(setup, k, depth):
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(97)
    stem = rng.integers(0, cfg.vocab_size, 24).tolist()
    prompts = [stem + rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [3, 17, 9]]
    prompts += [rng.integers(0, cfg.vocab_size, 30).tolist(), stem[:20]]
    kw = dict(n_slots=3, page_size=8, prompt_bucket=8, max_context=64, chunk=4, prefill_chunk=16, speculate_k=k)
    engine = slow_port(PagedDecodeEngine(tparams, cfg, pad_id=0, pipeline_depth=depth, **kw))
    outs = engine.generate_batch(prompts, greedy(10))
    jeng = slow_jax(JPagedDecodeEngine(jparams, cfg, pad_id=0, attn_impl="gather", pipeline_depth=depth, **kw))
    jouts = jeng.generate_batch(prompts, JSamplingParams(temperature=0.0, max_tokens=10))
    for i, (prompt, out, jout) in enumerate(zip(prompts, outs, jouts)):
        assert out["token_ids"] == jout["token_ids"] == naive(jparams, cfg, prompt, 10), (k, i)
    st, jst = engine.last_stats, jeng.last_stats
    for name in ("verify_steps", "tokens_out", "cached_prompt_tokens", "prefill_pieces", "chunk_dispatches"):
        assert st[name] == jst[name], name
    assert st["cached_prompt_tokens"] > 0 and st["prefill_pieces"] > 0
    assert no_leaks(engine)


@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_fuzz_ported_options(setup, seed):
    """Several streams over one engine with prompts cut from shared stems (a
    tight pool forces prefix hits, partial matches, LRU eviction and
    preemption), random prefill_chunk, chunk and speculate_k; without
    speculation, per-request sampling variants that are argmax-equivalent by
    construction. Every output equals the naive stream; pages balance after
    every stream."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(100 + seed)
    stems = [rng.integers(1, cfg.vocab_size - 1, int(n)).tolist() for n in rng.integers(9, 33, 3)]
    max_tokens = int(rng.integers(2, 7))
    spec = int(rng.choice([0, 2, 3]))
    engine = make_engine(
        tparams, cfg, n_slots=int(rng.integers(2, 5)), n_pages=int(rng.integers(10, 18)),
        chunk=int(rng.integers(2, 6)), prefill_chunk=8 if rng.random() < 0.5 else None, speculate_k=spec,
    )
    variants = [None]
    if not spec:
        variants += [SamplingParams(temperature=0.9, top_k=1, max_tokens=max_tokens),
                     SamplingParams(temperature=1.4, top_p=1e-9, max_tokens=max_tokens)]
    for stream in range(3):
        prompts = []
        for _ in range(int(rng.integers(2, 7))):
            stem = stems[int(rng.integers(0, len(stems)))]
            cut = int(rng.integers(1, len(stem) + 1))
            prompts.append(stem[:cut] + rng.integers(1, cfg.vocab_size - 1, int(rng.integers(0, 9))).tolist())
        reqs = [{"prompt": p, "sampling": variants[int(rng.integers(0, len(variants)))]} for p in prompts]
        outs = run_stream(engine, greedy(max_tokens), reqs, features=None if spec else {"sample", "topk", "topp"})
        for prompt, out in zip(prompts, outs):
            assert out["token_ids"] == naive(jparams, cfg, prompt, max_tokens), (seed, stream, len(prompt))
        assert no_leaks(engine)
