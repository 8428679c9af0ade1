"""The port's dense engine (``ssi_tpu_torch/generate/engine.py`` ``DecodeEngine``,
``_sample``; ``models/llama3.py`` ``forward_slots``) and ``engine=dense``
through ``run_generation`` against the JAX package's, on the CPU at the tiny
config in f32, the same weights carried across with ``params_from_numpy``.

Held: ``forward_slots`` hidden and cache within 2e-5 of JAX; greedy tokens
equal to the JAX engine's and to ``tests/helpers.py`` ``naive_greedy``
(ragged prompts, bucket 8, stop tokens, batch isolation, top-k at or above
the vocab), ``cumulative_logprob`` within 1e-5 relative, greedy penalties
equal to JAX's; the sampling contracts (seed reproducibility, top-k 1 equal
to greedy, no token drawn from outside the top-k / top-p set, even at the
largest uniform); results independent of the exit-check interval; the JAX
CLI's ``generations.jsonl`` line for line with ``engine=dense``, the padded
last batch included.
"""

import json
import logging

import numpy as np
import pytest
import torch

from tests import helpers
from tests.test_torch_generate import assert_generations_equal, jax_generate, port_cfg, read_records

import jax
import jax.numpy as jnp

from ssi_tpu.generate.engine import DecodeEngine as JaxEngine
from ssi_tpu.generate.engine import SamplingParams as JaxSP
from ssi_tpu.models import llama3 as jllama
from ssi_tpu_torch.generate import engine as engine_module
from ssi_tpu_torch.generate.engine import DecodeEngine, SamplingParams, _sample
from ssi_tpu_torch.models import llama3 as pllama
from ssi_tpu_torch.models.configs import get_model_config

N_ROWS = 6  # as tests/test_torch_generate.py: batch_size 4 leaves a last batch of 2 real rows


@pytest.fixture(scope="module", autouse=True)
def few_threads_and_logging():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    yield
    torch.set_num_threads(n)
    for handler in root.handlers:
        if handler not in handlers:
            handler.close()
    root.handlers = handlers
    root.setLevel(level)


@pytest.fixture(scope="module")
def setup():
    cfg = helpers.tiny_config()
    jparams = jllama.init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    params = pllama.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    pcfg = get_model_config("tiny_test")
    pcfg.n_dsus, pcfg.modality_tokens = cfg.n_dsus, cfg.modality_tokens
    assert pcfg.vocab_size == cfg.vocab_size
    return cfg, jparams, pcfg, params


def prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n)).tolist() for n in lengths]


def sp_pair(**kw):
    return SamplingParams(**kw), JaxSP(**kw)


def test_forward_slots_hidden_and_cache_match_jax(setup):
    """A left-padded prefill over a bucket of 16 (pad offsets 0, 7 and 13),
    then two single-token steps: hidden and every written cache slot within
    2e-5 of JAX's."""
    cfg, jparams, pcfg, params = setup
    b, p, m = 3, 16, 20
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)
    offsets = np.array([0, 7, 13], np.int32)
    jcache = jllama.init_kv_cache(cfg, b, m, dtype=jnp.float32)
    pcache = pllama.init_kv_cache(pcfg, b, m, dtype=torch.float32, device="cpu")
    steps = [(tokens, 0, p), (tokens[:, -1:], p, 1), (tokens[:, :1], p + 1, 1)]
    for toks, start, t_len in steps:
        jh, jcache = jllama.forward_slots(jparams, jnp.asarray(toks), cfg, jcache, jnp.int32(start),
                                          jnp.asarray(offsets), t_len)
        ph = pllama.forward_slots(params, torch.from_numpy(toks), pcfg, pcache, start, torch.from_numpy(offsets))
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=2e-5, atol=2e-5)
    for key in ("k", "v"):
        np.testing.assert_allclose(pcache[key].numpy(), np.asarray(jcache[key]), rtol=2e-5, atol=2e-5)


def run_both(setup, batch, bucket=8, seed=0, **kw):
    cfg, jparams, pcfg, params = setup
    sp, jsp = sp_pair(**kw)
    port = DecodeEngine(params, pcfg, pad_id=0, prompt_bucket=bucket).generate_batch(batch, sp, seed=seed)
    ref = JaxEngine(jparams, cfg, pad_id=0, prompt_bucket=bucket).generate_batch(batch, jsp)
    return port, ref


def assert_outputs_equal(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a["token_ids"] == b["token_ids"]
        assert (a["finish_reason"], a["stop_reason"]) == (b["finish_reason"], b["stop_reason"])
        assert abs(a["cumulative_logprob"] - b["cumulative_logprob"]) <= 1e-5 * abs(b["cumulative_logprob"])


@pytest.mark.parametrize("lengths,bucket,max_tokens", [([5, 11, 17], 8, 6), ([3, 30, 9, 1], 8, 9), ([12], 128, 4)])
def test_greedy_equals_jax_and_the_naive_oracle(setup, lengths, bucket, max_tokens):
    cfg, jparams, _, _ = setup
    batch = prompts(3, lengths, cfg.vocab_size)
    port, ref = run_both(setup, batch, bucket=bucket, max_tokens=max_tokens)
    assert_outputs_equal(port, ref)
    for prompt, out in zip(batch, port):
        assert out["token_ids"] == helpers.naive_greedy(jparams, cfg, prompt, max_tokens)
        assert (out["finish_reason"], out["stop_reason"]) == ("length", None)


def test_stop_tokens_end_rows_as_in_jax(setup):
    """Each row's third greedy token is a stop token for some row: rows stop
    at different steps, the rest keep going, and a stopped row's tail is not
    reported."""
    cfg, jparams, _, _ = setup
    batch = prompts(4, [9, 4, 14, 7], cfg.vocab_size)
    stops = tuple(helpers.naive_greedy(jparams, cfg, batch[i], 3)[2] for i in (0, 2))
    port, ref = run_both(setup, batch, max_tokens=8, stop_token_ids=stops)
    assert_outputs_equal(port, ref)
    assert {o["finish_reason"] for o in port} == {"stop", "length"}
    assert all(len(o["token_ids"]) <= 3 for o, _ in zip(port, batch) if o["finish_reason"] == "stop")


def test_batch_isolation(setup):
    cfg, _, pcfg, params = setup
    p1, p2 = prompts(5, [7, 13], cfg.vocab_size)
    sp = SamplingParams(max_tokens=5)
    eng = DecodeEngine(params, pcfg, pad_id=0, prompt_bucket=8)
    assert eng.generate_batch([p1, p2], sp)[1]["token_ids"] == eng.generate_batch([p2, p2], sp)[0]["token_ids"]


@pytest.mark.parametrize("penalties", [dict(repetition_penalty=1.3), dict(presence_penalty=0.7),
                                       dict(frequency_penalty=0.4), dict(repetition_penalty=0.8,
                                                                        presence_penalty=-0.3,
                                                                        frequency_penalty=0.2)])
def test_greedy_penalties_equal_jax(setup, penalties):
    """Repetition sees prompt and output (pad slots masked, pad_id 0 also in
    the prompts), presence and frequency output only."""
    cfg = setup[0]
    batch = prompts(6, [6, 15, 10], cfg.vocab_size)
    batch[1][3] = 0
    port, ref = run_both(setup, batch, max_tokens=10, **penalties)
    assert_outputs_equal(port, ref)


def test_top_k_at_or_above_the_vocab_is_off(setup):
    cfg, _, pcfg, params = setup
    eng = DecodeEngine(params, pcfg, pad_id=0, prompt_bucket=8)
    batch = prompts(7, [8, 5], cfg.vocab_size)
    for top_k in (cfg.vocab_size, cfg.vocab_size + 5):
        a = eng.generate_batch(batch, SamplingParams(temperature=0.8, top_k=top_k, max_tokens=6), seed=3)
        b = eng.generate_batch(batch, SamplingParams(temperature=0.8, top_k=-1, max_tokens=6), seed=3)
        assert [o["token_ids"] for o in a] == [o["token_ids"] for o in b]
    port, ref = run_both(setup, batch, max_tokens=6, top_k=cfg.vocab_size + 5)  # greedy: ignored
    assert_outputs_equal(port, ref)


def test_sampling_is_seeded_and_top_k_1_is_greedy(setup):
    cfg, _, pcfg, params = setup
    eng = DecodeEngine(params, pcfg, pad_id=0, prompt_bucket=8)
    batch = prompts(8, [10, 3, 6], cfg.vocab_size)
    sp = SamplingParams(temperature=0.8, top_k=10, top_p=0.95, max_tokens=8)
    a, b, c = (eng.generate_batch(batch, sp, seed=s) for s in (1, 1, 2))
    assert [o["token_ids"] for o in a] == [o["token_ids"] for o in b]
    assert [o["token_ids"] for o in a] != [o["token_ids"] for o in c]
    assert all(0 <= t < cfg.vocab_size for o in a for t in o["token_ids"])
    greedy = eng.generate_batch(batch, SamplingParams(max_tokens=8))
    for seed in range(3):
        for sp1 in (SamplingParams(temperature=1.3, top_k=1, max_tokens=8),
                    SamplingParams(temperature=1.3, top_p=1e-6, max_tokens=8)):
            assert [o["token_ids"] for o in eng.generate_batch(batch, sp1, seed=seed)] == \
                [o["token_ids"] for o in greedy]


def allowed(logits: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """The tokens a draw may pick, [B, V] bool, computed apart from ``_sample``:
    the top_k largest (ties at the k-th kept), then the smallest prefix of the
    rest, by probability, whose mass reaches top_p (ties at the cutoff kept)."""
    x = logits.double() / sp.temperature
    keep = torch.ones_like(x, dtype=torch.bool)
    if 0 < sp.top_k < x.shape[-1]:
        keep &= x >= torch.sort(x, dim=-1, descending=True).values[:, sp.top_k - 1:sp.top_k]
    if sp.top_p < 1.0:
        y = torch.where(keep, x, -torch.inf)
        s = torch.sort(y, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(s, dim=-1), dim=-1)
        idx = torch.clamp((cum < sp.top_p).sum(-1), max=x.shape[-1] - 1)
        keep &= y >= s.gather(-1, idx[:, None])
    return keep


@pytest.mark.parametrize("u", [None, 0.0, 1.0])
def test_no_token_is_drawn_from_outside_top_k_or_top_p(monkeypatch, u):
    """Thousands of draws over logits with ties and a wide spread, with the
    uniforms as drawn and pinned at 0 and at 1 (the largest values a
    uniform's mapping could give): every token is inside its row's top-k /
    top-p set, and top-k 1 is the argmax."""
    if u is not None:
        monkeypatch.setattr(engine_module.torch, "rand", lambda shape, **kw: torch.full(shape, u))
    gen = torch.Generator().manual_seed(0)
    v = 3000
    base = torch.randn((64, v), generator=gen) * 4
    base[:, :40] = base[:, :1]  # ties at the top
    zeros = torch.zeros((1, 1))
    for sp in (SamplingParams(temperature=0.9, top_k=5), SamplingParams(temperature=1.7, top_p=0.3),
               SamplingParams(temperature=0.6, top_k=50, top_p=0.8), SamplingParams(temperature=2.0, top_k=1)):
        keep = allowed(base, sp)
        for _ in range(20):
            tok, lp = _sample(base, sp, gen, zeros, zeros)
            assert bool(keep.gather(-1, tok[:, None]).all())
            assert torch.isfinite(lp).all() and (lp <= 0).all()
        if sp.top_k == 1:
            assert torch.equal(tok, torch.argmax(base, dim=-1))


def test_results_do_not_depend_on_the_exit_check_interval(setup):
    """Greedy with stop tokens and a sampled run: equal results for every
    interval, though the loop runs a different number of steps."""
    cfg, jparams, pcfg, params = setup
    batch = prompts(9, [9, 4, 14, 7], cfg.vocab_size)
    stops = tuple(helpers.naive_greedy(jparams, cfg, p, 2)[1] for p in batch)  # every row stops at its 2nd token
    runs, steps = [], []
    for every in (1, 2, 3, 5, 1000):
        eng = DecodeEngine(params, pcfg, pad_id=0, prompt_bucket=8)
        eng.exit_check_every = every
        greedy = eng.generate_batch(batch, SamplingParams(max_tokens=12, stop_token_ids=stops))
        steps.append(eng.last_steps)
        runs.append([greedy, eng.generate_batch(batch, SamplingParams(temperature=0.9, top_k=20, max_tokens=12,
                                                                      stop_token_ids=stops[:2]), seed=4)])
    assert all(r == runs[0] for r in runs)
    assert all(o["finish_reason"] == "stop" for o in runs[0][0])
    assert len(set(steps)) > 1 and max(steps) == 11 and min(steps) < 4  # the interval-1000 loop ran to the end


def test_n_other_than_1_raises_the_jax_text(setup):
    _, _, pcfg, params = setup
    eng = DecodeEngine(params, pcfg, pad_id=0, prompt_bucket=8)
    with pytest.raises(ValueError, match=r"^DecodeEngine decodes one sequence per prompt; use PagedDecodeEngine "
                                         r"for sampling_params.n > 1$"):
        eng.generate_batch([[1, 2, 3]], SamplingParams(n=2))


# --- engine=dense through the generation entry point --------------------------------------------


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen_dense")
    model_dir = helpers.make_tiny_hf_checkpoint(root / "experiments" / "run" / "checkpoints" / "step_0")
    rows = helpers.synthetic_sft_rows(N_ROWS)
    split = root / "test.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return root, model_dir, split, rows


def test_dense_generations_equal_jax_line_for_line(assets, tmp_path):
    """``engine=dense batch_size=4`` over 6 rows: two batches, the second
    padded with copies of its first prompt; the records equal the JAX
    CLI's line for line."""
    from ssi_tpu_torch.generate import run_generation

    _, model_dir, split, _ = assets
    jax_dir = jax_generate(assets, tmp_path / "jax", "engine=dense")
    port_dir = run_generation(port_cfg(model_dir, split, tmp_path / "port", "engine=dense"))
    assert_generations_equal(jax_dir, port_dir)
    assert (port_dir / "generation_config.yaml").read_text().replace(str(tmp_path / "port"), "<out>") == \
        (jax_dir / "generation_config.yaml").read_text().replace(str(tmp_path / "jax"), "<out>")


def test_dense_records_carry_metrics_under_observability(assets, tmp_path):
    from ssi_tpu_torch.generate import last_run_stats, run_generation

    _, model_dir, split, _ = assets
    out = run_generation(port_cfg(model_dir, split, tmp_path, "engine=dense", "observability=true"))
    records = read_records(out)
    assert len(records) == N_ROWS
    # two batches: the 4 records of each share their batch's metrics
    metrics = [r["metrics"] for r in records]
    assert metrics[0] == metrics[3] != metrics[4] == metrics[5]
    assert all(m["batch_generated_tokens"] > 0 and m["batch_tokens_per_second"] > 0 for m in metrics)
    assert "warmup_s" not in last_run_stats  # the warm-up is the paged engine's alone, as in JAX


def test_dense_with_tensor_parallel_raises_the_jax_text(assets, tmp_path):
    from ssi_tpu_torch.generate import run_generation

    _, model_dir, split, _ = assets
    with pytest.raises(ValueError, match=r"^tensor_parallel > 1 requires engine=paged \(the dense engine runs "
                                         r"single-device; silently ignoring the mesh would under-use the slice\)$"):
        run_generation(port_cfg(model_dir, split, tmp_path, "engine=dense", "tensor_parallel=2"))
    assert not any(tmp_path.iterdir())
