"""Tensor-parallel serving in the port across real processes: gloo ranks on
the CPU, each a process running the paged engine with its slice of the
weights (``PagedDecodeEngine(mesh=make_mesh(dp=1, tp=N))``), spawned as
``tests/test_torch_multiprocess.py`` spawns its ranks, against the JAX engine
with a tp mesh on the virtual CPU devices (``tests/test_paged_tp.py``).

The model is the tiny f32 one from ``jax.random.key(7)`` (4 q and 2 kv
heads, vocabulary 530), carried across by ``params_from_numpy``. Held:

- tp 2: greedy streams equal the JAX engine's tp 2 run and ``naive_greedy``
  token for token (``tests/test_paged_tp.py``'s prompts, 6 tokens); the first
  decode step's logits within rel 2e-5 of the JAX engine's (relative norm
  over the rows that step advances); the same streams at ``speculate_k=3``,
  across a shared-prefix cache hit, with ``prefill_chunk``, for ``n=2`` gangs
  and at pipeline depth 1 and 2; a cancel mid-stream, after which both ranks
  finish and exit; each rank's slices: half of every split leaf, ``embed``
  rows 265 of 530, pools at 1 kv head;
- tp 4: ``embed`` replicated (530 % 4 != 0, as the JAX ``_divisible_spec``
  does), attention whole (2 kv heads do not split 4 ways: the port keeps
  whole heads where the JAX pools split the feature axis), the MLP split; the
  greedy streams equal the JAX tp 4 run's, the first-step logits within 2e-5.

Rank 0 drives each engine; the other ranks build the same engine and run
``follow()`` until rank 0 closes it.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ssi_tpu.generate.paged_engine as jax_paged_engine
from ssi_tpu.generate.engine import SamplingParams as JaxSamplingParams
from ssi_tpu.models.llama3 import init_params
from ssi_tpu.parallel import make_mesh as jax_make_mesh
from tests import helpers
from tests.test_paged_decode import make_engine as make_jax_engine

REPO = Path(__file__).resolve().parent.parent
ENGINE = dict(n_slots=4, page_size=8, prompt_bucket=8, max_context=64, chunk=4)

# One rank: argv = rank, world, port, params .npz, output dir. Each scenario
# builds the same engine on every rank; rank 0 runs it and closes it, the
# others follow. Rank 0 writes the results, every rank its layout.
_WORKER = """
import json, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist

rank, world, port, npz, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], Path(sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
import ssi_tpu_torch.generate.paged_engine as pe
from ssi_tpu_torch.generate.engine import SamplingParams
from ssi_tpu_torch.models.configs import get_model_config
from ssi_tpu_torch.models.llama3 import params_from_numpy
from ssi_tpu_torch.parallel import make_mesh

cfg = get_model_config("tiny_test")
cfg.n_dsus, cfg.modality_tokens = 16, True
flat = np.load(npz)
tree = {}
for key in flat.files:
    *path, leaf = key.split("/")
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = flat[key]
params = params_from_numpy(tree, device="cpu")
mesh = make_mesh(dp=1, tp=world)
spec = json.loads(Path(out / "scenarios.json").read_text())

first = []  # the first decode step's logits over the rows it advances
orig = pe.decode_step_tokens
def recorded(params, tok, cfg, pools, page_table, seq_lens, active, **kw):
    logits = orig(params, tok, cfg, pools, page_table, seq_lens, active, **kw)
    if not first:
        first.append(logits[active].tolist())
    return logits
pe.decode_step_tokens = recorded

results, engines = {}, []
for name, sc in spec.items():
    eng = pe.PagedDecodeEngine(params, cfg, pad_id=0, mesh=mesh, **sc["engine"])
    engines.append(eng)
    if not eng.is_driver:
        eng.follow()
        continue
    first.clear()
    sp = SamplingParams(temperature=0.0, max_tokens=sc["max_tokens"], stop_token_ids=(), n=sc.get("n", 1))
    rec = {"tokens": [], "stats": []}
    if "cancel_after" in sc:
        eng.begin_stream(sp)
        rids = [eng.add_request(p) for p in sc["prompts"][0]]
        outs, cancelled = {}, False
        for _ in range(500):
            for r in eng.step():
                outs[r["request_id"]] = r["outputs"][0]
            live = [s for s in eng._slots if s.req is not None and s.req.idx == rids[1]]
            if not cancelled and live and len(live[0].req.out) >= sc["cancel_after"] and not live[0].done:
                cancelled = eng.cancel_request(rids[1], keep_tokens=sc["cancel_after"], finish_reason="stop")
            if len(outs) == len(rids):
                break
        eng.end_stream()
        rec["cancelled"] = cancelled
        rec["outputs"] = [outs[r] for r in rids]
        rec["free_pages"] = len(eng._free_pages) + len(eng._cache_lru) == eng.n_pages
    else:
        for prompts in sc["prompts"]:
            outs = eng.generate_batch(prompts, sp)
            rec["tokens"].append([o["token_ids"] for o in outs])
            rec["stats"].append(dict(eng.last_stats))
    rec["first_logits"] = first[0] if first else None
    results[name] = rec
    eng.close()

layout = {k: list(v.shape) for k, v in engines[0].params["layers"].items()}
layout.update(embed=list(engines[0].params["embed"].shape), pools=list(engines[0].pools["k"].shape))
(out / f"layout{rank}.json").write_text(json.dumps(layout))
if rank == 0:
    (out / "results.json").write_text(json.dumps(results))
dist.destroy_process_group()
(out / f"done{rank}").write_text("ok")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _prompts(seed: int, lengths, vocab: int, prefix: list[int] | None = None) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [(prefix or []) + rng.integers(0, vocab, int(n)).tolist() for n in lengths]


@pytest.fixture(scope="module")
def setup():
    cfg = helpers.tiny_config()
    params = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    return cfg, params


def scenarios(cfg) -> dict:
    """Each scenario: the engine's options and the prompt lists of its streams."""
    v = cfg.vocab_size
    base = _prompts(61, [5, 11, 17, 3], v)  # tests/test_paged_tp.py's prompts
    shared = _prompts(67, [16], v)[0]
    prefixed = _prompts(68, [4, 6, 9, 2, 7], v, prefix=shared)
    long = _prompts(69, [20, 27, 9, 14], v)
    return {
        "greedy": {"engine": ENGINE, "prompts": [base], "max_tokens": 6},
        "spec": {"engine": {**ENGINE, "speculate_k": 3}, "prompts": [base], "max_tokens": 6},
        "prefix": {"engine": {**ENGINE, "n_slots": 3}, "prompts": [prefixed, prefixed[:2]], "max_tokens": 5},
        "chunked": {"engine": {**ENGINE, "prefill_chunk": 8}, "prompts": [long], "max_tokens": 6},
        "gang": {"engine": ENGINE, "prompts": [base[:2]], "max_tokens": 6, "n": 2},
        "depth1": {"engine": {**ENGINE, "pipeline_depth": 1}, "prompts": [base], "max_tokens": 6},
        "depth2": {"engine": {**ENGINE, "pipeline_depth": 2}, "prompts": [base], "max_tokens": 6},
        "cancel": {"engine": ENGINE, "prompts": [_prompts(71, [7, 12, 5], v)], "max_tokens": 12, "cancel_after": 3},
    }


def run_ranks(setup, tmp_path_factory, world: int, names) -> dict:
    """``world`` gloo ranks running ``names`` of the scenarios; returns rank
    0's results, every rank's layout and whether every rank finished."""
    cfg, params = setup
    out = tmp_path_factory.mktemp(f"tp{world}")
    flat = {}
    for k, leaf in params.items():
        for name, x in (leaf.items() if isinstance(leaf, dict) else [(None, leaf)]):
            flat[f"{k}/{name}" if name else k] = np.asarray(x)
    np.savez(out / "params.npz", **flat)
    (out / "scenarios.json").write_text(json.dumps({n: s for n, s in scenarios(cfg).items() if n in names}))
    env = {k: v for k, v in os.environ.items() if k != "SSI_TPU_COMPILE_CACHE"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(port), str(out / "params.npz"),
                               str(out)], cwd=out, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    return {"results": json.loads((out / "results.json").read_text()),
            "layouts": [json.loads((out / f"layout{r}.json").read_text()) for r in range(world)],
            "done": all((out / f"done{r}").is_file() for r in range(world))}


@pytest.fixture(scope="module")
def tp2(setup, tmp_path_factory):
    return run_ranks(setup, tmp_path_factory, 2, scenarios(setup[0]))


@pytest.fixture(scope="module")
def tp4(setup, tmp_path_factory):
    return run_ranks(setup, tmp_path_factory, 4, ["greedy"])


def jax_run(setup, tp: int, prompts, **kw) -> tuple[list[list[int]], np.ndarray]:
    """The JAX engine on a tp mesh of the virtual CPU devices: token streams
    and the first decode step's logits over the rows it advances."""
    cfg, params = setup
    seen = []
    orig = jax_paged_engine.decode_step_tokens

    def recorded(params, tok, cfg, pools, page_table, seq_lens, advance, **kw):
        logits, pools = orig(params, tok, cfg, pools, page_table, seq_lens, advance, **kw)
        jax.debug.callback(lambda l, a, s: seen.append((np.asarray(l)[np.asarray(a)], np.asarray(s)[np.asarray(a)])),
                           logits, advance, seq_lens)
        return logits, pools

    jax_paged_engine.decode_step_tokens = recorded
    try:
        mesh = jax_make_mesh(dp=1, tp=tp, devices=jax.devices()[:tp])
        engine = make_jax_engine(params, cfg, mesh=mesh, **kw)
        outs = engine.generate_batch(prompts, JaxSamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=()))
    finally:
        jax_paged_engine.decode_step_tokens = orig
    # the first step: every prompt's slot advances from position p - 1
    # (speculation's verify steps run another pass: no decode step to read)
    want = sorted(len(p) - 1 for p in prompts)
    first = next((l for l, s in seen if sorted(s.tolist()) == want), None)
    return [o["token_ids"] for o in outs], first


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("tp", [2, 4])
def test_greedy_streams_and_first_step_logits_equal_jax(setup, tp2, tp4, tp):
    """Greedy streams equal the JAX engine's run at the same tp and
    ``naive_greedy``; the first decode step's logits within rel 2e-5."""
    cfg, params = setup
    prompts = scenarios(cfg)["greedy"]["prompts"][0]
    got = (tp2 if tp == 2 else tp4)["results"]["greedy"]
    want, jax_first = jax_run(setup, tp, prompts)
    assert got["tokens"][0] == want
    for prompt, toks in zip(prompts, got["tokens"][0]):
        assert toks == helpers.naive_greedy(params, cfg, prompt, 6)
    assert np.asarray(got["first_logits"]).shape == (len(prompts), cfg.vocab_size)
    assert rel_norm(got["first_logits"], jax_first) < 2e-5


def test_speculation_equals_jax_tp2(setup, tp2):
    """``speculate_k=3`` at tp 2: the JAX engine's tp 2 streams, verify steps taken."""
    prompts = scenarios(setup[0])["spec"]["prompts"][0]
    got = tp2["results"]["spec"]
    assert got["tokens"][0] == jax_run(setup, 2, prompts, speculate_k=3)[0]
    assert got["stats"][0]["verify_steps"] > 0


@pytest.mark.parametrize("name", ["prefix", "chunked", "gang", "depth1", "depth2"])
def test_options_compose_with_tp2(setup, tp2, name):
    """The prefix cache (a hit within a stream and across streams), chunked
    prefill, n=2 gangs and pipeline depth 1 and 2 at tp 2: every stream is
    ``naive_greedy``'s, and each option did its work."""
    cfg, params = setup
    sc = scenarios(cfg)[name]
    got = tp2["results"][name]
    n = sc.get("n", 1)
    for prompts, toks, stats in zip(sc["prompts"], got["tokens"], got["stats"]):
        want = [helpers.naive_greedy(params, cfg, p, sc["max_tokens"]) for p in prompts for _ in range(n)]
        assert toks == want
    s = got["stats"]
    if name == "prefix":
        assert s[0]["cached_prompt_tokens"] > 0 and s[1]["cached_prompt_tokens"] >= 16
    elif name == "chunked":
        assert s[0]["prefill_pieces"] > 0
    elif name == "gang":
        assert s[0]["pages_shared"] > 0


def test_cancel_mid_stream_keeps_the_ranks_in_step(setup, tp2):
    """A request cancelled after 3 tokens (the server's stop-string cut and
    client-disconnect path, host-only on rank 0) keeps its 3 greedy tokens;
    the others run to their budget; the pages all return, and both ranks
    finish every later engine and exit."""
    cfg, params = setup
    sc = scenarios(cfg)["cancel"]
    got = tp2["results"]["cancel"]
    prompts = sc["prompts"][0]
    assert got["cancelled"] and got["free_pages"]
    assert got["outputs"][1]["finish_reason"] == "stop"
    assert got["outputs"][1]["token_ids"] == helpers.naive_greedy(params, cfg, prompts[1], 3)
    for i in (0, 2):
        assert got["outputs"][i]["token_ids"] == helpers.naive_greedy(params, cfg, prompts[i], 12)
    assert tp2["done"]


def test_tp2_layout(setup, tp2):
    """Each rank holds half of every split leaf, ``embed`` rows 265 of 530,
    and pools at 1 kv head (head_dim 16)."""
    cfg = setup[0]
    hd = cfg.head_dim
    for layout in tp2["layouts"]:
        assert layout["wq"] == [2, 64, 2 * hd] and layout["wk"] == layout["wv"] == [2, 64, hd]
        assert layout["wo"] == [2, 2 * hd, 64]
        assert layout["w_gate"] == layout["w_up"] == [2, 64, 64] and layout["w_down"] == [2, 64, 64]
        assert layout["embed"] == [265, 64] and cfg.vocab_size == 530
        assert layout["pools"][2] == hd
        assert layout["attn_norm"] == layout["mlp_norm"] == [2, 64]


def test_tp4_layout(setup, tp4):
    """At tp 4 the vocabulary (530) does not divide: ``embed`` is whole on
    every rank, as the JAX ``_divisible_spec`` replicates it; 2 kv heads do
    not split 4 ways, so attention is whole (pools at 2 kv heads); the MLP
    splits 128 -> 32."""
    cfg = setup[0]
    hd = cfg.head_dim
    for layout in tp4["layouts"]:
        assert layout["embed"] == [530, 64]
        assert layout["wq"] == [2, 64, 4 * hd] and layout["wk"] == [2, 64, 2 * hd] and layout["wo"] == [2, 4 * hd, 64]
        assert layout["pools"][2] == 2 * hd
        assert layout["w_gate"] == layout["w_up"] == [2, 64, 32] and layout["w_down"] == [2, 32, 64]
    assert tp4["done"]
