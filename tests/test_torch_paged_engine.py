"""The port's PagedDecodeEngine on the CPU (plain attention) against the JAX
paged engine and the naive full-recompute greedy oracle, plus the scheduler
contract of tests/test_paged_decode.py: refill, stop tokens and budgets,
preemption, pool and context errors, sampling, cancel, and the options not
ported yet. The prefix cache is on (the default) throughout."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ssi_tpu.generate.engine import SamplingParams as JSamplingParams
from ssi_tpu.generate.paged_engine import PagedDecodeEngine as JPagedDecodeEngine
from ssi_tpu.models.llama3 import init_params
from ssi_tpu_torch.generate.engine import SamplingParams
from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
from ssi_tpu_torch.models.llama3 import params_from_numpy
from tests import helpers


@pytest.fixture(scope="module")
def setup():
    cfg = helpers.tiny_config()
    jparams = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    return cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def make_engine(params, cfg, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("prompt_bucket", 8)
    kw.setdefault("max_context", 64)
    kw.setdefault("chunk", 4)
    return PagedDecodeEngine(params, cfg, pad_id=0, **kw)


def no_leaks(engine) -> bool:
    """Idle-engine page accounting: every page is free or parked in the prefix
    cache's LRU (unreferenced), the hash maps are 1:1, and no slot is held."""
    return (
        len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages
        and set(engine._page_hash) == set(engine._prefix_map.values())
        and all(engine._page_refs[pg] == 0 for pg in engine._cache_lru)
        and all(s.req is None for s in engine._slots)
    )


def run_stream(engine, sp, reqs, seed=0, features=None):
    engine.begin_stream(sp, seed=seed, features=features)
    got = {}
    try:
        ids = [engine.add_request(r["prompt"], sampling=r.get("sampling"), seed=r.get("seed")) for r in reqs]
        while not engine.stream_idle:
            for rec in engine.step():
                got[rec["request_id"]] = rec["outputs"][0]
    finally:
        engine.end_stream()
    return [got[i] for i in ids]


def test_greedy_matches_jax_engine_and_naive(setup):
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 11, 17, 3, 9, 14]]
    outs = make_engine(tparams, cfg).generate_batch(prompts, SamplingParams(temperature=0.0, max_tokens=6))
    jeng = JPagedDecodeEngine(jparams, cfg, pad_id=0, n_slots=4, page_size=8, prompt_bucket=8, max_context=64,
                              chunk=4, attn_impl="gather", prefix_caching=False)
    jouts = jeng.generate_batch(prompts, JSamplingParams(temperature=0.0, max_tokens=6))
    for i, (prompt, out, jout) in enumerate(zip(prompts, outs, jouts)):
        assert out["token_ids"] == jout["token_ids"] == helpers.naive_greedy(jparams, cfg, prompt, 6), i
        assert out["finish_reason"] == jout["finish_reason"] == "length"
        assert out["cumulative_logprob"] == pytest.approx(jout["cumulative_logprob"], abs=1e-3)
        assert sum(out["logprobs"]) == pytest.approx(out["cumulative_logprob"], abs=1e-4)
        assert all(lp <= 0.0 for lp in out["logprobs"])


def test_auto_impl_is_reference_on_cpu_and_kernel_raises(setup):
    cfg, _, tparams = setup
    assert make_engine(tparams, cfg).attn_impl == "reference"
    with pytest.raises(ValueError, match="CUDA"):
        make_engine(tparams, cfg, attn_impl="kernel")
    with pytest.raises(ValueError, match="attn_impl"):
        make_engine(tparams, cfg, attn_impl="gather")


@pytest.mark.parametrize("order", ["fifo", "sjf", "ljf"])
def test_continuous_batching_refills_slots(setup, order):
    """11 prompts on 3 slots: finished slots admit queued prompts, outputs come
    back in request order, and every page returns to the pool."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 20))).tolist() for _ in range(11)]
    engine = make_engine(tparams, cfg, n_slots=3, admission_order=order)
    outs = engine.generate_batch(prompts, SamplingParams(temperature=0.0, max_tokens=5))
    assert len(outs) == len(prompts)
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == helpers.naive_greedy(jparams, cfg, prompt, 5)
    assert no_leaks(engine)
    assert engine.last_stats["tokens_out"] == 55 and engine.last_stats["prefill_rows"] == 11


def test_stop_tokens_and_budget(setup):
    cfg, jparams, tparams = setup
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, 9).tolist()
    seq = helpers.naive_greedy(jparams, cfg, prompt, 8)
    engine = make_engine(tparams, cfg)
    out = engine.generate_batch([prompt], SamplingParams(max_tokens=8, stop_token_ids=(seq[0],)))[0]
    assert out["token_ids"] == [seq[0]] and out["finish_reason"] == "stop" and out["stop_reason"] == seq[0]
    stop_at = next((i for i in range(1, 8) if seq[i] not in seq[:i]), None)
    if stop_at is not None:  # a later stop fires inside a chunk
        out = engine.generate_batch([prompt], SamplingParams(max_tokens=8, stop_token_ids=(seq[stop_at],)))[0]
        assert out["token_ids"] == seq[: stop_at + 1] and out["finish_reason"] == "stop"
    out = engine.generate_batch([prompt], SamplingParams(max_tokens=3))[0]
    assert out["token_ids"] == seq[:3] and out["finish_reason"] == "length"
    # a per-request budget below the stream's
    engine.begin_stream(SamplingParams(max_tokens=8))
    rid = engine.add_request(prompt, max_tokens=2)
    recs = []
    while not engine.stream_idle:
        recs += engine.step()
    engine.end_stream()
    assert recs[0]["request_id"] == rid and recs[0]["outputs"][0]["token_ids"] == seq[:2]
    assert no_leaks(engine)


def test_preemption_on_tiny_pool(setup):
    """8-token prompts with 12 outputs each need 3 pages apiece; a 7-page
    pool cannot hold three at once, so the youngest is preempted, recomputed,
    and every output is still exact."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, 8).tolist() for _ in range(4)]
    engine = make_engine(tparams, cfg, n_slots=3, n_pages=7)
    outs = engine.generate_batch(prompts, SamplingParams(max_tokens=12))
    for prompt, out in zip(prompts, outs):
        assert out["token_ids"] == helpers.naive_greedy(jparams, cfg, prompt, 12)
    assert engine.last_stats["preemptions"] > 0
    assert no_leaks(engine)


def test_pool_too_small_raises(setup):
    cfg, _, tparams = setup
    engine = make_engine(tparams, cfg, n_slots=1, n_pages=1)
    with pytest.raises(RuntimeError, match="pool too small"):
        engine.generate_batch([list(range(10))], SamplingParams(max_tokens=4))
    assert no_leaks(engine)


def test_context_overflow_rejected(setup):
    cfg, _, tparams = setup
    engine = make_engine(tparams, cfg, max_context=32)
    with pytest.raises(ValueError, match="exceeds"):
        engine.generate_batch([list(range(20))], SamplingParams(max_tokens=20))


def test_sampled_contract(setup):
    """Same (stream seed, request seed, prompt) -> same tokens whatever else is
    in the batch; another seed diverges; top_k=1 and a tiny top_p equal
    greedy; penalties run and emit the budget."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(24)
    prompt = rng.integers(0, cfg.vocab_size, 8).tolist()
    other = rng.integers(0, cfg.vocab_size, 11).tolist()
    samp = SamplingParams(temperature=1.0, max_tokens=10)
    sp = SamplingParams(temperature=0.0, max_tokens=10)
    engine = make_engine(tparams, cfg)
    solo = run_stream(engine, sp, [{"prompt": prompt, "sampling": samp, "seed": 7}], seed=3, features={"sample"})
    crowded = run_stream(
        engine, sp,
        [{"prompt": other}, {"prompt": prompt, "sampling": samp, "seed": 7},
         {"prompt": prompt, "sampling": samp, "seed": 8}],
        seed=3, features={"sample"},
    )
    assert crowded[1]["token_ids"] == solo[0]["token_ids"]
    assert crowded[2]["token_ids"] != solo[0]["token_ids"]
    assert crowded[0]["token_ids"] == helpers.naive_greedy(jparams, cfg, other, 10)

    want = helpers.naive_greedy(jparams, cfg, prompt, 6)
    outs = run_stream(
        engine, SamplingParams(max_tokens=6),
        [{"prompt": prompt, "sampling": SamplingParams(temperature=0.9, top_k=1, max_tokens=6)},
         {"prompt": prompt, "sampling": SamplingParams(temperature=1.3, top_p=1e-9, max_tokens=6)}],
        features={"sample", "topk", "topp"},
    )
    assert outs[0]["token_ids"] == want and outs[1]["token_ids"] == want

    pen = SamplingParams(temperature=0.8, top_k=20, top_p=0.9, max_tokens=6, presence_penalty=0.5,
                         frequency_penalty=0.2, repetition_penalty=1.1)
    for out in engine.generate_batch([prompt, other], pen, seed=11):
        assert len(out["token_ids"]) == 6 and np.isfinite(out["cumulative_logprob"])
    with pytest.raises(ValueError, match="features"):
        engine.begin_stream(sp)
        try:
            engine.add_request(prompt, sampling=samp)
        finally:
            engine.end_stream()
    assert no_leaks(engine)


def test_sampling_survives_preemption(setup):
    """Preemption + recompute redraws the identical sampled continuation (the
    noise is keyed by stream seed, request seed and position)."""
    cfg, _, tparams = setup
    rng = np.random.default_rng(25)
    prompts = [rng.integers(0, cfg.vocab_size, 17).tolist() for _ in range(3)]
    samp = SamplingParams(temperature=1.0, max_tokens=10)
    sp = SamplingParams(max_tokens=10)
    reqs = [{"prompt": p, "sampling": samp, "seed": 100 + i} for i, p in enumerate(prompts)]
    roomy = run_stream(make_engine(tparams, cfg, n_slots=3), sp, reqs, features={"sample"})
    tight_engine = make_engine(tparams, cfg, n_slots=3, n_pages=9)
    tight = run_stream(tight_engine, sp, reqs, features={"sample"})
    assert tight_engine.last_stats["preemptions"] > 0
    assert [o["token_ids"] for o in tight] == [o["token_ids"] for o in roomy]


def test_cancel_request_mid_run(setup):
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(33)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 9, 7]]
    engine = make_engine(tparams, cfg)
    engine.begin_stream(SamplingParams(max_tokens=12))
    rids = [engine.add_request(p) for p in prompts]
    outs, cancelled = {}, False
    for _ in range(200):
        for rec in engine.step():
            outs[rec["request_id"]] = rec["outputs"][0]
        live = [s for s in engine._slots if s.req is not None and s.req.idx == rids[1]]
        if not cancelled and live and len(live[0].req.out) >= 3 and not live[0].done:
            assert engine.cancel_request(rids[1], keep_tokens=3, finish_reason="stop")
            cancelled = True
        if len(outs) == 3:
            break
    assert cancelled and len(outs) == 3
    assert outs[rids[1]]["finish_reason"] == "stop"
    assert outs[rids[1]]["token_ids"] == helpers.naive_greedy(jparams, cfg, prompts[1], 3)
    for i in (0, 2):
        assert outs[rids[i]]["token_ids"] == helpers.naive_greedy(jparams, cfg, prompts[i], 12)
    assert not engine.cancel_request(999)
    engine.end_stream()
    assert no_leaks(engine)


@pytest.mark.parametrize(
    "kw",
    [dict(quantize="int8"), dict(mesh=object())],
    ids=["quantize", "mesh"],
)
def test_unported_engine_options_raise(setup, kw):
    cfg, _, tparams = setup
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_engine(tparams, cfg, **kw)


def test_unported_n_gt_1_raises(setup):
    cfg, _, tparams = setup
    engine = make_engine(tparams, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.generate_batch([[1, 2, 3]], SamplingParams(n=2, temperature=1.0, max_tokens=2))
    engine.begin_stream(SamplingParams(max_tokens=2), features={"sample"})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.add_request([1, 2, 3], sampling=SamplingParams(n=2, temperature=1.0, max_tokens=2))
    engine.end_stream()
    assert no_leaks(engine)
