"""Pipelined harvest in the port's PagedDecodeEngine (``pipeline_depth``, the
JAX engine's default 2) on the CPU, against the JAX engine at the same depth.

On the CPU a chunk's results are on the host at once, so the port harvests
each chunk at the start of the next step. To drive the pipeline as a busy card
does, ``slow_port`` makes every chunk look unfinished until the engine waits
for it, and ``slow_jax`` does the same to the JAX engine's in-flight chunks:
both then run the same schedule, so tokens AND scheduler counters are held
equal at depths 1, 2 and 3. Also here: the boundary-page copy against the JAX
engine's ``_copy_pages_fn``, preemption and cancellation with chunks in
flight, and what the harvest timer counts."""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssi_tpu.generate.engine import SamplingParams as JSamplingParams
from ssi_tpu.generate.paged_engine import PagedDecodeEngine as JPagedDecodeEngine
from ssi_tpu.models.llama3 import init_params
from ssi_tpu_torch.generate.engine import SamplingParams
from ssi_tpu_torch.generate.paged import copy_pages, init_pools
from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
from ssi_tpu_torch.models.llama3 import params_from_numpy
from tests import helpers
from tests.test_torch_paged_engine import make_engine, no_leaks

# scheduler counters that must agree when both engines run one schedule
SCHEDULE_STATS = ("chunk_dispatches", "slot_chunks", "prefill_dispatches", "prefill_rows", "prefill_pieces",
                  "prefill_token_area", "prompt_tokens", "tokens_out", "preemptions", "pages_shared",
                  "cached_prompt_tokens", "verify_steps", "kv_bytes")


@pytest.fixture(scope="module")
def setup():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = helpers.tiny_config()
    jparams = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    yield cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    torch.set_num_threads(n)


class NeverReady:
    """A chunk's ready event that completes only when waited for."""

    def query(self) -> bool:
        return False

    def synchronize(self) -> None:
        pass


class RandomReady:
    """A ready event that completes at a random later query, as a card's does."""

    def __init__(self, rng):
        self.rng, self.done = rng, False

    def query(self) -> bool:
        self.done = self.done or bool(self.rng.random() < 0.5)
        return self.done

    def synchronize(self) -> None:
        self.done = True


def slow_port(engine, rng=None):
    """Make the port's in-flight chunks look unfinished until harvested (or,
    given ``rng``, finish at random)."""
    engine._to_host = lambda packed: (packed, NeverReady() if rng is None else RandomReady(rng))
    return engine


class _NotReady:
    """A JAX chunk result that the opportunistic harvest never finds ready;
    ``jax.device_get`` reads it through ``__array__``."""

    def __init__(self, a):
        self.a = a

    def is_ready(self) -> bool:
        return False

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.a)


def slow_jax(jeng):
    """The JAX engine with every in-flight chunk unfinished until harvested."""
    step = jeng.step

    def slow_step():
        out = step()
        st = getattr(jeng, "_st", None)
        for entry in st.pending if st is not None else ():
            if not isinstance(entry["packed"], _NotReady):
                entry["packed"] = _NotReady(entry["packed"])
        return out

    jeng.step = slow_step
    return jeng


def jax_engine(jparams, cfg, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("prompt_bucket", 8)
    kw.setdefault("max_context", 64)
    kw.setdefault("chunk", 4)
    return JPagedDecodeEngine(jparams, cfg, pad_id=0, attn_impl="gather", **kw)


def assert_same_schedule(engine, jeng):
    for name in SCHEDULE_STATS:
        assert engine.last_stats[name] == jeng.last_stats[name], name


def test_default_depth_is_the_jax_engines(setup):
    cfg, _, tparams = setup
    assert PagedDecodeEngine.__init__.__kwdefaults__["pipeline_depth"] == 2
    assert JPagedDecodeEngine.__init__.__kwdefaults__["pipeline_depth"] == 2
    assert make_engine(tparams, cfg).pipeline_depth == 2
    assert make_engine(tparams, cfg, pipeline_depth=0).pipeline_depth == 1  # clamped, as in JAX


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_matches_jax_engine(setup, depth):
    """Greedy tokens equal the JAX engine's and the naive stream at the same
    depth, and so does every scheduler counter, the roofline bytes (which
    count the chunks in flight) included."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 11, 17, 3, 9, 14, 21, 7]]
    sp = SamplingParams(temperature=0.0, max_tokens=9)
    engine = slow_port(make_engine(tparams, cfg, n_slots=3, pipeline_depth=depth))
    outs = engine.generate_batch(prompts, sp)
    jeng = slow_jax(jax_engine(jparams, cfg, n_slots=3, pipeline_depth=depth))
    jouts = jeng.generate_batch(prompts, JSamplingParams(temperature=0.0, max_tokens=9))
    for i, (prompt, out, jout) in enumerate(zip(prompts, outs, jouts)):
        assert out["token_ids"] == jout["token_ids"] == helpers.naive_greedy(jparams, cfg, prompt, 9), (depth, i)
        assert out["cumulative_logprob"] == pytest.approx(jout["cumulative_logprob"], abs=1e-3)
    assert_same_schedule(engine, jeng)
    assert no_leaks(engine)


def test_cpu_chunks_are_ready_at_once(setup):
    """Without the fake, a CPU chunk is harvested at the start of the next
    step: depth 2 runs depth 1's schedule, and never waits."""
    cfg, _, tparams = setup
    rng = np.random.default_rng(43)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 11, 17, 3, 9, 14]]
    sp = SamplingParams(temperature=0.0, max_tokens=7)
    engines = {d: make_engine(tparams, cfg, pipeline_depth=d) for d in (1, 2)}
    outs = {d: e.generate_batch(prompts, sp) for d, e in engines.items()}
    assert [o["token_ids"] for o in outs[1]] == [o["token_ids"] for o in outs[2]]
    for name in SCHEDULE_STATS:
        assert engines[1].last_stats[name] == engines[2].last_stats[name], name
    assert engines[2].last_stats["harvest_block_s"] == 0.0
    packed, ready = engines[2]._to_host(torch.arange(6, dtype=torch.int32).reshape(2, 3))
    assert ready is None and isinstance(packed, np.ndarray)


def test_harvest_timer_counts_the_waits(setup):
    """``harvest_block_s`` is the time spent waiting for chunk results: every
    wait is timed, and a chunk whose results are on the host costs none."""
    cfg, _, tparams = setup
    waits = []

    class SlowEvent(NeverReady):
        def synchronize(self) -> None:
            waits.append(1)
            time.sleep(0.02)

    engine = make_engine(tparams, cfg, pipeline_depth=2)
    engine._to_host = lambda packed: (packed, SlowEvent())
    engine.generate_batch([[1, 2, 3], [4, 5, 6, 7]], SamplingParams(max_tokens=9))
    st = engine.last_stats
    # a finished slot is dispatched once more before the chunk that finished
    # it is harvested, and end_stream drops that last chunk unread
    assert len(waits) == st["chunk_dispatches"] - 1 >= 3
    assert 0.02 * len(waits) <= st["harvest_block_s"] < 0.02 * len(waits) + 0.5


@pytest.mark.parametrize("depth", [2, 3])
def test_preemption_drains_the_pipeline(setup, depth):
    """A pool too small for three requests at once: the chunks in flight are
    harvested before anything is preempted, the outputs stay exact, and the
    schedule (preemptions included) is the JAX engine's."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, 8).tolist() for _ in range(4)]
    engine = slow_port(make_engine(tparams, cfg, n_slots=3, n_pages=7, pipeline_depth=depth))
    outs = engine.generate_batch(prompts, SamplingParams(max_tokens=12))
    jeng = slow_jax(jax_engine(jparams, cfg, n_slots=3, n_pages=7, pipeline_depth=depth))
    jouts = jeng.generate_batch(prompts, JSamplingParams(temperature=0.0, max_tokens=12))
    for prompt, out, jout in zip(prompts, outs, jouts):
        assert out["token_ids"] == jout["token_ids"] == helpers.naive_greedy(jparams, cfg, prompt, 12)
    assert engine.last_stats["preemptions"] > 0
    assert_same_schedule(engine, jeng)
    assert no_leaks(engine)


def test_cancel_and_end_stream_with_chunks_in_flight(setup):
    """A request cancelled while chunks that advance it are in flight keeps a
    prefix of its greedy stream (their harvests skip its freed slot); the
    others stay exact; ``end_stream`` drops the chunks still in flight."""
    cfg, jparams, tparams = setup
    rng = np.random.default_rng(33)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in [5, 9, 7]]
    engine = slow_port(make_engine(tparams, cfg, pipeline_depth=3))
    engine.begin_stream(SamplingParams(max_tokens=12))
    rids = [engine.add_request(p) for p in prompts]
    outs, cancelled = {}, False
    for _ in range(200):
        for rec in engine.step():
            outs[rec["request_id"]] = rec["outputs"][0]
        live = [s for s in engine._slots if s.req is not None and s.req.idx == rids[1]]
        if not cancelled and live and live[0].req.out and engine._st.pending:
            assert engine.cancel_request(rids[1], finish_reason="abort")
            cancelled = True
        if len(outs) == 3:
            break
    assert cancelled and len(outs) == 3
    got = outs[rids[1]]["token_ids"]
    assert outs[rids[1]]["finish_reason"] == "abort" and 0 < len(got) < 12
    assert got == helpers.naive_greedy(jparams, cfg, prompts[1], 12)[: len(got)]
    for i in (0, 2):
        assert outs[rids[i]]["token_ids"] == helpers.naive_greedy(jparams, cfg, prompts[i], 12)
    engine.end_stream()
    assert no_leaks(engine)

    engine.begin_stream(SamplingParams(max_tokens=12))
    engine.add_request(prompts[0])
    engine.step()
    engine.step()
    assert engine._st.pending
    engine.end_stream()
    assert engine._st is None and no_leaks(engine)
    out = engine.generate_batch([prompts[2]], SamplingParams(max_tokens=12))[0]
    assert out["token_ids"] == helpers.naive_greedy(jparams, cfg, prompts[2], 12)


def test_copy_pages_matches_jax(setup):
    """The boundary-page copy equals the JAX engine's ``_copy_pages_fn``
    across every layer, pad rows (id >= n_pages) landing on the trash row."""
    cfg, jparams, _ = setup
    n_pages, ps = 12, 8
    rng = np.random.default_rng(3)
    pools = init_pools(cfg, n_pages, ps, dtype=torch.float32, device="cpu")
    for pool in pools.values():
        pool.copy_(torch.from_numpy(rng.standard_normal(pool.shape).astype(np.float32)))
    src = np.array([3, 7, 0, n_pages], np.int32)
    dst = np.array([5, 1, 11, n_pages], np.int32)  # the last row is padding
    jeng = jax_engine(jparams, cfg, n_pages=n_pages, page_size=ps, prompt_bucket=ps)
    want = jeng._copy_pages_fn(len(src))({k: jnp.asarray(v.numpy()) for k, v in pools.items()},
                                         jnp.asarray(src), jnp.asarray(dst))
    before = {k: v.clone() for k, v in pools.items()}
    copy_pages(pools, torch.from_numpy(src), torch.from_numpy(dst), n_pages=n_pages)
    for name in ("k", "v"):
        np.testing.assert_array_equal(pools[name].numpy(), np.asarray(want[name]))
        got = pools[name].view(cfg.num_layers * n_pages + 1, -1)
        for layer in range(cfg.num_layers):
            for s, d in zip(src[:3], dst[:3]):
                assert torch.equal(got[layer * n_pages + d], before[name].view_as(got)[layer * n_pages + s])
