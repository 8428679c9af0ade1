"""``n > 1`` parallel sampling in the port's PagedDecodeEngine on the CPU
(plain attention) against the JAX engine (gather attention): gangs that share
the prompt's read-only pages, one boundary-page copy per sibling, the split of
a gang the pool cannot hold, gangs over the prefix cache, cancellation, the
per-sequence seeds and the sampled siblings' contract, and twins of the JAX
scheduler fuzz tests (tests/test_paged_decode.py) that also draw ``n`` and
the pipeline depth."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssi_tpu.generate.engine import SamplingParams as JSamplingParams
from ssi_tpu.models.llama3 import init_params
from ssi_tpu_torch.generate.engine import SamplingParams
from ssi_tpu_torch.models.llama3 import params_from_numpy
from tests import helpers
from tests.test_torch_paged_engine import make_engine, no_leaks
from tests.test_torch_pipeline import assert_same_schedule, jax_engine, slow_jax, slow_port


@pytest.fixture(scope="module")
def setup():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = helpers.tiny_config()
    jparams = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    yield cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    torch.set_num_threads(n)


_naive: dict = {}


def naive(jparams, cfg, prompt, n):
    key = (tuple(prompt), n)
    if key not in _naive:
        _naive[key] = helpers.naive_greedy(jparams, cfg, prompt, n)
    return _naive[key]


def shared_pages(prompts, n, page_size=8):
    """Pages a gang's siblings reference instead of owning: the leader's
    pages holding only positions <= p-2, once per extra sequence."""
    return sum((n - 1) * ((len(p) - 1) // page_size) for p in prompts)


def run_stream(engine, sp, reqs, seed=0, features=None):
    """One stream over ``reqs`` (add_request kwargs); each request's outputs."""
    engine.begin_stream(sp, seed, features=features)
    got = {}
    try:
        ids = [engine.add_request(**r) for r in reqs]
        while not engine.stream_idle:
            for rec in engine.step():
                got[rec["request_id"]] = rec["outputs"]
    finally:
        engine.end_stream()
    return [got[i] for i in ids]


def run_jax_stream(jeng, sp, reqs, features=None):
    jeng.begin_stream(sp, features=features)
    got = {}
    try:
        ids = [jeng.add_request(**r) for r in reqs]
        while not jeng.stream_idle:
            for rec in jeng.step():
                got[rec["request_id"]] = rec["outputs"]
    finally:
        jeng.end_stream()
    return [got[i] for i in ids]


@pytest.mark.parametrize("depth", [1, 2])
def test_n_greedy_matches_jax_generate_batch(setup, depth):
    """n=3 greedy: prompt-major / sequence-minor outputs equal the JAX
    engine's ``generate_batch`` and the naive stream (the shared prefix pages
    and the copied boundary page rebuild the leader's K/V exactly), the same
    schedule and ``pages_shared``; every reference is returned."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 17, 11, 25, 9]]
    engine = slow_port(make_engine(tparams, cfg, n_slots=8, pipeline_depth=depth))
    outs = engine.generate_batch(prompts, SamplingParams(n=3, temperature=0.0, max_tokens=6))
    jeng = slow_jax(jax_engine(jparams, cfg, n_slots=8, pipeline_depth=depth))
    jouts = jeng.generate_batch(prompts, JSamplingParams(n=3, temperature=0.0, max_tokens=6))
    assert len(outs) == len(jouts) == 3 * len(prompts)
    for k, (out, jout) in enumerate(zip(outs, jouts)):
        assert out["token_ids"] == jout["token_ids"] == naive(jparams, cfg, prompts[k // 3], 6), k
        assert out["cumulative_logprob"] == pytest.approx(jout["cumulative_logprob"], abs=1e-3)
    assert engine.last_stats["pages_shared"] == shared_pages(prompts, 3) > 0
    assert_same_schedule(engine, jeng)
    assert no_leaks(engine) and (engine._page_refs == 0).all()


def test_n_gang_splits_when_pool_tight(setup):
    """A gang that can never sit together in the pool splits into solo
    sequences, each still exact (twin of the JAX engine's test)."""
    cfg, jparams, tparams = setup
    prompt = [3] * 20  # 3 pages of prompt (page 8), bucket 24
    engine = make_engine(tparams, cfg, n_pages=7, max_context=48)
    outs = engine.generate_batch([prompt], SamplingParams(n=3, temperature=0.0, max_tokens=4))
    jeng = jax_engine(jparams, cfg, n_pages=7, max_context=48)
    jouts = jeng.generate_batch([prompt], JSamplingParams(n=3, temperature=0.0, max_tokens=4))
    assert len(outs) == 3
    for out, jout in zip(outs, jouts):
        assert out["token_ids"] == jout["token_ids"] == naive(jparams, cfg, prompt, 4)
    # the gang's attempt before the split counted its first sibling's pages, as in JAX
    assert engine.last_stats["pages_shared"] == jeng.last_stats["pages_shared"]
    assert no_leaks(engine)


def test_prefix_cache_with_parallel_sampling(setup):
    """The leader's prompt pages may come from the prefix cache; its siblings
    reference them on top (twin of the JAX engine's test)."""
    cfg, jparams, tparams = setup
    prompt = np.random.default_rng(53).integers(0, cfg.vocab_size, 19).tolist()
    sp = SamplingParams(n=2, temperature=0.0, max_tokens=4)
    engine = make_engine(tparams, cfg)
    outs1 = engine.generate_batch([prompt], sp)
    outs2 = engine.generate_batch([prompt], sp)
    assert engine.last_stats["cached_prompt_tokens"] == 16 and engine.last_stats["pages_shared"] == 2
    for out in outs1 + outs2:
        assert out["token_ids"] == naive(jparams, cfg, prompt, 4)
    assert no_leaks(engine)


def test_per_request_n_and_cancel_every_sequence(setup):
    """A per-request ``sampling.n`` queues a gang on an n=1 stream, whose
    greedy siblings equal the solo stream; cancelling a running gang and a
    queued one finalizes every sequence of each."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(27)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in (9, 12, 6)]
    sp = SamplingParams(temperature=0.0, max_tokens=8)
    outs = run_stream(make_engine(tparams, cfg), sp,
                      [{"prompt": prompts[0], "sampling": SamplingParams(n=3, max_tokens=8)}])
    assert [o["token_ids"] for o in outs[0]] == [naive(jparams, cfg, prompts[0], 8)] * 3

    engine = slow_port(make_engine(tparams, cfg, pipeline_depth=2))
    engine.begin_stream(sp)
    rids = [engine.add_request(p, sampling=SamplingParams(n=2, max_tokens=8)) for p in prompts]
    got: dict = {}
    while not any(s.req is not None and s.req.out for s in engine._slots):
        for rec in engine.step():
            got[rec["request_id"]] = rec["outputs"]
    assert {s.req.idx for s in engine._slots} == {rids[0], rids[1]} and len(engine._st.queue) == 1
    for rid in (rids[0], rids[2]):  # a running gang, then the queued one
        assert engine.cancel_request(rid, finish_reason="abort")
    while not engine.stream_idle or len(got) < 3:
        for rec in engine.step():
            got[rec["request_id"]] = rec["outputs"]
    assert not engine.cancel_request(rids[0])  # already final
    engine.end_stream()
    assert sorted(got) == rids and all(len(v) == 2 for v in got.values())
    for rid in (rids[0], rids[2]):
        assert [o["finish_reason"] for o in got[rid]] == ["abort", "abort"]
    assert [o["token_ids"] for o in got[rids[2]]] == [[], []]  # it never ran
    assert [o["token_ids"] for o in got[rids[1]]] == [naive(jparams, cfg, prompts[1], 8)] * 2
    assert no_leaks(engine)


def test_sampled_siblings_seeded_contract(setup):
    """Per-sequence seeds equal the JAX engine's bitwise; a seeded n=4
    sampled request reproduces itself (also at another depth, and beside
    other traffic); its siblings differ; top-k 1 equals greedy."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(28)
    prompt, other = (rng.integers(0, cfg.vocab_size, n).tolist() for n in (9, 13))
    greedy = SamplingParams(temperature=0.0, max_tokens=8)
    samp = SamplingParams(n=4, temperature=1.0, max_tokens=8)

    engine = make_engine(tparams, cfg)
    jeng = jax_engine(jparams, cfg)
    engine.begin_stream(greedy, features={"sample"})
    jeng.begin_stream(JSamplingParams(temperature=0.0, max_tokens=8), features={"sample"})
    for kw in ({"seed": 5}, {}, {"seed": 2**31 + 17}):
        engine.add_request(prompt, sampling=samp, **kw)
        jeng.add_request(prompt, sampling=JSamplingParams(n=4, temperature=1.0, max_tokens=8), **kw)
    seeds = [[r.rng_seed for r in g] for g in engine._st.queue]
    assert seeds == [[r.rng_seed for r in g] for g in jeng._st.queue]
    assert all(len(set(s)) == 4 for s in seeds)
    engine.end_stream()
    jeng.end_stream()

    req = {"prompt": prompt, "sampling": samp, "seed": 5}
    a = run_stream(engine, greedy, [req], seed=3, features={"sample"})[0]
    b = run_stream(engine, greedy, [{"prompt": other}, req], seed=3, features={"sample"})[1]
    c = run_stream(slow_port(make_engine(tparams, cfg, pipeline_depth=3)), greedy, [req], seed=3,
                   features={"sample"})[0]
    seqs = [o["token_ids"] for o in a]
    assert seqs == [o["token_ids"] for o in b] == [o["token_ids"] for o in c]
    assert len(set(map(tuple, seqs))) > 1 and all(len(s) == 8 for s in seqs)
    assert all(np.isfinite(o["cumulative_logprob"]) for o in a)
    top1 = run_stream(engine, greedy, [{"prompt": prompt, "sampling": SamplingParams(
        n=3, temperature=0.9, top_k=1, max_tokens=8), "seed": 5}], seed=3, features={"sample", "topk"})[0]
    assert [o["token_ids"] for o in top1] == [naive(jparams, cfg, prompt, 8)] * 3
    assert no_leaks(engine)


def fuzz_prompts(rng, stems, vocab, lo, hi):
    prompts = []
    for _ in range(int(rng.integers(lo, hi))):
        stem = stems[int(rng.integers(0, len(stems)))]
        cut = int(rng.integers(1, len(stem) + 1))
        prompts.append(stem[:cut] + rng.integers(1, vocab - 1, int(rng.integers(0, 9))).tolist())
    return prompts


def fuzz_engines(rng, cfg, tparams, jparams):
    """One port engine and one JAX engine at one draw of geometry: a tight
    pool (prefix hits, LRU eviction, preemption, gang splits), chunk, depth
    and chunked prefill. The port's chunks finish at random (``RandomReady``)."""
    kw = dict(n_slots=int(rng.integers(2, 5)), n_pages=int(rng.integers(10, 18)), max_context=64,
              chunk=int(rng.integers(2, 6)), pipeline_depth=int(rng.integers(1, 4)),
              prefill_chunk=8 if rng.random() < 0.5 else None)
    return (slow_port(make_engine(tparams, cfg, **kw), rng=np.random.default_rng(int(rng.integers(2**31)))),
            jax_engine(jparams, cfg, **kw), kw["n_slots"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_fuzz_feature_compositions(setup, seed):
    """Twin of the JAX fuzz test of the same name that also draws ``n`` per
    request and the pipeline depth: several streams over one engine, prompts
    cut from shared stems, per-request sampling variants that are
    argmax-equivalent by construction. Every output equals the JAX engine's
    at the same draw; pages balance after every stream."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(500 + seed)
    stems = [rng.integers(1, cfg.vocab_size - 1, int(n)).tolist() for n in rng.integers(9, 33, 3)]
    max_tokens = int(rng.integers(2, 7))
    engine, jeng, n_slots = fuzz_engines(rng, cfg, tparams, jparams)
    variants = [(None, None), (SamplingParams(temperature=0.9, top_k=1, max_tokens=max_tokens),
                               JSamplingParams(temperature=0.9, top_k=1, max_tokens=max_tokens))]
    for stream in range(3):
        reqs, jreqs = [], []
        for p in fuzz_prompts(rng, stems, cfg.vocab_size, 2, 6):
            n = int(rng.integers(1, min(3, n_slots) + 1))
            v, jv = variants[int(rng.integers(0, 2))]
            reqs.append({"prompt": p, "sampling": SamplingParams(n=n, max_tokens=max_tokens) if v is None
                         else SamplingParams(**{**v.__dict__, "n": n})})
            jreqs.append({"prompt": p, "sampling": JSamplingParams(n=n, max_tokens=max_tokens) if jv is None
                          else JSamplingParams(**{**jv.__dict__, "n": n})})
        outs = run_stream(engine, SamplingParams(max_tokens=max_tokens), reqs, features={"sample", "topk"})
        jouts = run_jax_stream(jeng, JSamplingParams(max_tokens=max_tokens), jreqs, features={"sample", "topk"})
        for r, out, jout in zip(reqs, outs, jouts):
            assert len(out) == len(jout) == r["sampling"].n
            assert [o["token_ids"] for o in out] == [o["token_ids"] for o in jout], (seed, stream, len(r["prompt"]))
        assert no_leaks(engine)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_fuzz_with_cancels(setup, seed):
    """Twin of the JAX fuzz test of the same name that also draws ``n`` and
    the pipeline depth: random requests are cancelled at random times. Every
    cancelled sequence keeps a prefix of the JAX engine's output for the same
    request (cut to ``keep_tokens``), every other one equals it; pages
    balance after every stream."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(700 + seed)
    stems = [rng.integers(1, cfg.vocab_size - 1, int(n)).tolist() for n in rng.integers(9, 33, 3)]
    max_tokens = int(rng.integers(4, 9))
    engine, jeng, n_slots = fuzz_engines(rng, cfg, tparams, jparams)
    for stream in range(3):
        prompts = fuzz_prompts(rng, stems, cfg.vocab_size, 3, 8)
        ns = [int(rng.integers(1, min(3, n_slots) + 1)) for _ in prompts]
        jouts = run_jax_stream(jeng, JSamplingParams(max_tokens=max_tokens), [
            {"prompt": p, "sampling": JSamplingParams(n=n, max_tokens=max_tokens)} for p, n in zip(prompts, ns)])
        engine.begin_stream(SamplingParams(max_tokens=max_tokens))
        ids = [engine.add_request(p, sampling=SamplingParams(n=n, max_tokens=max_tokens)) for p, n in zip(prompts, ns)]
        to_cancel = {rid for rid in ids if rng.random() < 0.4}
        keep = {rid: int(rng.integers(1, max_tokens + 1)) if rng.random() < 0.5 else None for rid in to_cancel}
        got: dict = {}
        try:
            for _ in range(500):
                for rec in engine.step():
                    got[rec["request_id"]] = rec["outputs"]
                for rid in sorted(to_cancel):
                    if rid not in got and rng.random() < 0.3:
                        engine.cancel_request(rid, keep_tokens=keep[rid], finish_reason="abort")
                        to_cancel.discard(rid)
                if len(got) == len(ids) and engine.stream_idle:
                    break
        finally:
            engine.end_stream()
        assert len(got) == len(ids), (seed, stream)
        for rid, jout in zip(ids, jouts):
            assert len(got[rid]) == len(jout)
            for out, want in zip(got[rid], jout):
                want = want["token_ids"]
                if out["finish_reason"] == "abort":
                    cut = want[: keep.get(rid)] if keep.get(rid) is not None else want
                    assert out["token_ids"] == cut[: len(out["token_ids"])], (seed, stream, rid)
                else:  # finished before (or without) the cancel
                    assert out["token_ids"] == want, (seed, stream, rid)
        assert no_leaks(engine)
