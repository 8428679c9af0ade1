"""The port's HTTP server (``ssi_tpu_torch/serve.py``) on the CPU: the 19
contracts of ``tests/test_serve.py`` against the port's ``Server`` over the
port's engine (plain attention), and parity with the JAX server on the same
weights and requests, both served over HTTP in this process.

The JAX server runs on its gather engine through ``tests/test_paged_decode.py``
``make_engine``; both engines pipeline two chunks (depth 2), but when a chunk
counts as finished is timing, so streamed deltas may be cut at other places;
their concatenation and every final record are equal, ``n > 1`` choices
included (greedy), and so are the 400s for ``n > 1`` with ``stream`` or
``stop``.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ssi_tpu.generate.engine import SamplingParams as JSamplingParams
from ssi_tpu.models.llama3 import init_params
from ssi_tpu.serve import Server as JServer
from ssi_tpu.serve import run_http_server as jrun_http_server
from ssi_tpu_torch.generate.engine import SamplingParams
from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
from ssi_tpu_torch.models.llama3 import params_from_numpy
from ssi_tpu_torch.serve import Server, _chat_prompt_tokens, _IncrementalDecoder, run_http_server
from tests import helpers
from tests.test_paged_decode import make_engine as make_jax_engine
from tests.test_torch_pipeline import slow_jax, slow_port

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    cfg = helpers.tiny_config()
    jparams = init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    return cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def make_engine(params, cfg, **kw):
    """The port's engine at ``tests/test_paged_decode.py`` ``make_engine``'s shapes."""
    kw.setdefault("n_slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("prompt_bucket", 8)
    kw.setdefault("max_context", 64)
    kw.setdefault("chunk", 4)
    return PagedDecodeEngine(params, cfg, pad_id=0, **kw)


def naive_greedy(setup, prompt, n):
    cfg, jparams, _ = setup
    return helpers.naive_greedy(jparams, cfg, prompt, n)


def serve_http(srv):
    """Start ``srv`` and an HTTP front end on an ephemeral port; returns (url, stop)."""
    srv.start()
    httpd = (jrun_http_server if isinstance(srv, JServer) else run_http_server)(srv, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()

    def stop():
        httpd.shutdown()
        srv.stop()

    return f"http://127.0.0.1:{httpd.server_address[1]}", stop


@pytest.fixture()
def server(setup):
    cfg, _, tparams = setup
    engine = make_engine(tparams, cfg, n_slots=3, max_context=64)
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=())
    srv = Server(engine, sp, model_id="tiny-test")
    url, stop = serve_http(srv)
    yield srv, url
    stop()


def _post(url, path, body):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return r.status, json.loads(r.read())


def _stream(url, path, body):
    """POST with ``stream: true``; returns (content type, the decoded SSE events up to [DONE])."""
    req = urllib.request.Request(
        url + path, data=json.dumps({**body, "stream": True}).encode(), headers={"Content-Type": "application/json"}
    )
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        ctype = r.headers["Content-Type"]
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                break
            events.append(json.loads(payload))
    return ctype, events


# --- the contracts of tests/test_serve.py --------------------------------------------------


def test_health_models_metrics(server):
    _srv, url = server
    code, body = _get(url, "/health")
    assert code == 200 and body["status"] == "ok"
    code, body = _get(url, "/v1/models")
    assert code == 200 and body["data"][0]["id"] == "tiny-test"
    code, body = _get(url, "/metrics")
    assert code == 200 and "n_pages" in body


def test_completions_greedy_matches_naive(setup, server):
    cfg = setup[0]
    _srv, url = server
    rng = np.random.default_rng(91)
    prompt = rng.integers(1, cfg.vocab_size - 1, 12).tolist()
    code, body = _post(url, "/v1/completions", {"prompt": prompt})
    assert code == 200
    assert body["object"] == "text_completion"
    choice = body["choices"][0]
    assert choice["token_ids"] == naive_greedy(setup, prompt, 8)
    assert choice["finish_reason"] == "length"
    assert body["usage"]["prompt_tokens"] == 12
    assert body["usage"]["completion_tokens"] == 8


def test_completions_concurrent(setup, server):
    """Parallel posts ride ONE continuous-batching stream; every response is
    the request's own greedy stream."""
    cfg = setup[0]
    _srv, url = server
    rng = np.random.default_rng(97)
    prompts = [rng.integers(1, cfg.vocab_size - 1, int(n)).tolist() for n in [5, 9, 14, 7, 11, 3]]
    results = [None] * len(prompts)

    def go(i):
        results[i] = _post(url, "/v1/completions", {"prompt": prompts[i]})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, prompt in enumerate(prompts):
        code, body = results[i]
        assert code == 200, (i, body)
        assert body["choices"][0]["token_ids"] == naive_greedy(setup, prompt, 8), i


def test_per_request_max_tokens(setup, server):
    cfg = setup[0]
    _srv, url = server
    rng = np.random.default_rng(101)
    prompt = rng.integers(1, cfg.vocab_size - 1, 10).tolist()
    code, body = _post(url, "/v1/completions", {"prompt": prompt, "max_tokens": 3})
    assert code == 200
    assert body["choices"][0]["token_ids"] == naive_greedy(setup, prompt, 3)
    # above the stream budget -> clean 400, server keeps serving
    code, body = _post(url, "/v1/completions", {"prompt": prompt, "max_tokens": 99})
    assert code == 400 and "max_tokens" in body["error"]["message"]
    code, body = _post(url, "/v1/completions", {"prompt": prompt})
    assert code == 200


@pytest.mark.parametrize(
    "path, body, code, match",
    [("/v1/completions", {"prompt": "text needs a tokenizer"}, 400, "tokenizer"),
     ("/v1/completions", {"prompt": {"bad": 1}}, 400, "prompt"),
     ("/v1/completions", {"prompt": []}, 400, "empty"),
     ("/nope", {}, 404, "unknown path")],
    ids=["string-without-tokenizer", "bad-prompt", "empty-prompt", "unknown-path"],
)
def test_invalid_requests(server, path, body, code, match):
    _srv, url = server
    got, resp = _post(url, path, body)
    assert got == code and match in resp["error"]["message"]


def test_streaming_completion(setup, server):
    """stream=true: SSE events deliver token deltas incrementally; their
    concatenation equals the naive greedy stream and the final record carries
    finish_reason + usage."""
    cfg = setup[0]
    _srv, url = server
    rng = np.random.default_rng(103)
    prompt = rng.integers(1, cfg.vocab_size - 1, 9).tolist()
    ctype, events = _stream(url, "/v1/completions", {"prompt": prompt})
    assert ctype == "text/event-stream"
    assert len(events) >= 2  # at least one delta + the final record
    final = events[-1]
    assert final["choices"][0]["finish_reason"] == "length"
    got = [t for e in events[:-1] for t in e["choices"][0]["token_ids"]]
    assert got == naive_greedy(setup, prompt, 8)
    assert final["usage"]["completion_tokens"] == 8


def test_server_survives_engine_error(setup, server):
    """An engine-step failure fails the in-flight requests with a clean error
    and restarts the stream — later requests are served normally."""
    cfg = setup[0]
    srv, url = server
    real_step = srv.engine.step
    state = {"armed": True}

    def flaky_step():
        if state["armed"]:
            state["armed"] = False
            srv.engine.end_stream()  # mimic step()'s release-everything-on-raise
            raise RuntimeError("injected fault")
        return real_step()

    srv.engine.step = flaky_step
    rng = np.random.default_rng(107)
    prompt = rng.integers(1, cfg.vocab_size - 1, 7).tolist()
    code, body = _post(url, "/v1/completions", {"prompt": prompt})
    assert code == 400 and "engine error" in body["error"]["message"]
    code, body = _post(url, "/v1/completions", {"prompt": prompt})
    assert code == 200
    assert body["choices"][0]["token_ids"] == naive_greedy(setup, prompt, 8)


def test_per_request_sampling_http(setup, server):
    """OpenAI per-request sampling fields: top_k=1 sampling equals greedy,
    seeded sampling is reproducible; greedy n: 2 answers two choices, each
    the greedy stream (the JAX server's tokens: see the twins tests)."""
    cfg = setup[0]
    _srv, url = server
    rng = np.random.default_rng(113)
    prompt = rng.integers(1, cfg.vocab_size - 1, 9).tolist()
    want = naive_greedy(setup, prompt, 8)

    code, body = _post(url, "/v1/completions",
                       {"prompt": prompt, "temperature": 0.9, "top_k": 1})
    assert code == 200
    assert body["choices"][0]["token_ids"] == want

    a = _post(url, "/v1/completions", {"prompt": prompt, "temperature": 1.0, "seed": 5})
    b = _post(url, "/v1/completions", {"prompt": prompt, "temperature": 1.0, "seed": 5})
    c = _post(url, "/v1/completions", {"prompt": prompt, "temperature": 1.0, "seed": 6})
    assert a[0] == b[0] == c[0] == 200
    assert a[1]["choices"][0]["token_ids"] == b[1]["choices"][0]["token_ids"]
    assert c[1]["choices"][0]["token_ids"] != a[1]["choices"][0]["token_ids"]

    code, body = _post(url, "/v1/completions", {"prompt": prompt, "n": 2})
    assert code == 200
    assert [c["index"] for c in body["choices"]] == [0, 1]
    assert [c["token_ids"] for c in body["choices"]] == [want, want]
    assert body["usage"]["completion_tokens"] == 2 * len(want)
    code, body = _post(url, "/v1/completions", {"prompt": prompt})
    assert code == 200 and body["choices"][0]["token_ids"] == want


def test_per_request_feature_rejected_http(setup, server):
    """Penalty params need the opt-in "pen" branch; the default server
    rejects them with a 400."""
    cfg = setup[0]
    _srv, url = server
    rng = np.random.default_rng(117)
    prompt = rng.integers(1, cfg.vocab_size - 1, 6).tolist()
    code, body = _post(url, "/v1/completions",
                       {"prompt": prompt, "repetition_penalty": 1.3})
    assert code == 400
    assert "features" in body["error"]["message"]
    # the stream survives the rejection
    code, _body = _post(url, "/v1/completions", {"prompt": prompt})
    assert code == 200


class _LetterTokenizer:
    """Deterministic 1-token -> 1-ASCII-letter decode for exact stop-string
    assertions."""

    def decode(self, ids):
        return "".join(chr(97 + (t % 26)) for t in ids)


@pytest.fixture()
def stop_server(setup):
    cfg, _, tparams = setup
    engine = make_engine(tparams, cfg, n_slots=3, max_context=64)
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=())
    srv = Server(engine, sp, tokenizer=_LetterTokenizer(), model_id="tiny-stop")
    url, stop = serve_http(srv)
    yield srv, url
    stop()


def test_stop_strings(setup, stop_server):
    """OpenAI `stop`: generation ends at the first match, the match itself is
    excluded from the text, token_ids are the shortest prefix containing it."""
    cfg = setup[0]
    _srv, url = stop_server
    rng = np.random.default_rng(131)
    prompt = rng.integers(1, cfg.vocab_size - 1, 10).tolist()
    full = naive_greedy(setup, prompt, 8)
    full_text = _LetterTokenizer().decode(full)
    stop = full_text[3:5]
    idx = full_text.index(stop)

    code, body = _post(url, "/v1/completions", {"prompt": prompt, "stop": stop})
    assert code == 200
    choice = body["choices"][0]
    assert choice["finish_reason"] == "stop"
    assert choice["text"] == full_text[:idx]
    assert stop not in choice["text"]
    assert choice["token_ids"] == full[: idx + len(stop)]

    # a list of stops: the earliest match wins
    code, body = _post(url, "/v1/completions",
                       {"prompt": prompt, "stop": ["zzzz", stop]})
    assert code == 200 and body["choices"][0]["text"] == full_text[:idx]

    # a never-matching stop runs to the budget
    code, body = _post(url, "/v1/completions", {"prompt": prompt, "stop": "ZZZ"})
    assert code == 200
    assert body["choices"][0]["finish_reason"] == "length"
    assert body["choices"][0]["token_ids"] == full

    # invalid shapes reject cleanly
    code, body = _post(url, "/v1/completions", {"prompt": prompt, "stop": [1]})
    assert code == 400
    code, body = _post(url, "/v1/completions", {"prompt": prompt, "stop": "x", "n": 2})
    assert code == 400


def test_stop_strings_stream(setup, stop_server):
    """Streamed stop: held-back deltas never leak the stop string; the
    concatenated text ends char-exactly at the match."""
    cfg = setup[0]
    _srv, url = stop_server
    rng = np.random.default_rng(137)
    prompt = rng.integers(1, cfg.vocab_size - 1, 11).tolist()
    full_text = _LetterTokenizer().decode(naive_greedy(setup, prompt, 8))
    stop = full_text[4:6]
    idx = full_text.index(stop)

    _ctype, events = _stream(url, "/v1/completions", {"prompt": prompt, "stop": stop})
    assert events[-1]["choices"][0]["finish_reason"] == "stop"
    text = "".join(e["choices"][0].get("text", "") for e in events[:-1])
    assert text == full_text[:idx]
    assert stop not in text


def test_logprobs_openai_shape(setup, stop_server):
    """`logprobs` in the request returns the OpenAI logprobs object: one
    chosen-token logprob per emitted token, tokens + text offsets aligned."""
    cfg = setup[0]
    _srv, url = stop_server
    rng = np.random.default_rng(149)
    prompt = rng.integers(1, cfg.vocab_size - 1, 8).tolist()
    code, body = _post(url, "/v1/completions", {"prompt": prompt, "logprobs": 1})
    assert code == 200
    choice = body["choices"][0]
    lp = choice["logprobs"]
    n = len(choice["token_ids"])
    assert len(lp["token_logprobs"]) == n == len(lp["tokens"]) == len(lp["text_offset"])
    assert all(x <= 0.0 for x in lp["token_logprobs"])
    assert sum(lp["token_logprobs"]) == pytest.approx(choice["cumulative_logprob"], abs=1e-4)
    assert "".join(lp["tokens"]) == choice["text"]
    assert lp["text_offset"] == [len("".join(lp["tokens"][:i])) for i in range(n)]
    # absent from the response when not requested
    code, body = _post(url, "/v1/completions", {"prompt": prompt})
    assert code == 200 and "logprobs" not in body["choices"][0]


def test_stream_disconnect_aborts(setup):
    """server.cancel (the disconnect path) frees the slot and finalizes the
    request with finish_reason=abort; the server keeps serving."""
    cfg, _, tparams = setup
    engine = make_engine(tparams, cfg, n_slots=2, max_context=64)
    sp = SamplingParams(temperature=0.0, max_tokens=48, stop_token_ids=())
    srv = Server(engine, sp, tokenizer=_LetterTokenizer(), model_id="tiny-abort")
    srv.start()
    try:
        rng = np.random.default_rng(139)
        prompt = rng.integers(1, cfg.vocab_size - 1, 9).tolist()
        pend = srv.submit_stream(prompt, None)
        first = pend.deltas.get(timeout=60)  # at least one delta arrived
        assert isinstance(first, list) and first
        srv.cancel(pend)
        assert pend.event.wait(timeout=60)
        assert pend.outputs is not None
        assert pend.outputs[0]["finish_reason"] == "abort"
        # drain the sentinel; then the engine is fully reusable
        while pend.deltas.get(timeout=10) is not None:
            pass
        done = srv.submit(prompt, 5)
        assert done.error is None
        assert done.outputs[0]["token_ids"] == naive_greedy(setup, prompt, 5)
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def tokenizers(setup, tmp_path_factory):
    """Both packages' tokenizers over one tiny DSU-extended tokenizer.model."""
    from ssi_tpu.extend import extend_tiktoken
    from ssi_tpu.tokenizer import setup_llama3_tokenizer as jsetup
    from ssi_tpu_torch.tokenizer import setup_llama3_tokenizer

    cfg = setup[0]
    tok_path = tmp_path_factory.mktemp("tok") / "tokenizer.model"
    helpers.write_tiny_tokenizer(tok_path)
    extend_tiktoken(cfg.n_dsus, cfg.modality_tokens, tok_path, tok_path)
    return setup_llama3_tokenizer(tok_path, verbose=False)[0], jsetup(tok_path, verbose=False)[0]


@pytest.fixture()
def chat_server(setup, tokenizers):
    """Server with a real (tiny, DSU-extended) tokenizer for chat endpoints."""
    cfg, _, tparams = setup
    tokenizer = tokenizers[0]
    engine = make_engine(tparams, cfg, n_slots=3, max_context=64)
    sp = SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=tuple(tokenizer.stop_tokens))
    srv = Server(engine, sp, tokenizer=tokenizer, model_id="tiny-chat")
    url, stop = serve_http(srv)
    yield srv, tokenizer, url
    stop()


def _cut_at_stop(tokens, stops):
    k = next((i for i, t in enumerate(tokens) if t in stops), None)
    return tokens if k is None else tokens[: k + 1]


def test_chat_completions(setup, chat_server):
    """/v1/chat/completions renders the Llama-3 chat format and returns an
    OpenAI chat.completion; token_ids equal the naive greedy stream over the
    rendered prompt."""
    _srv, tokenizer, url = chat_server
    messages = [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi"},
    ]
    code, body = _post(url, "/v1/chat/completions", {"messages": messages})
    assert code == 200
    assert body["object"] == "chat.completion"
    choice = body["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert isinstance(choice["message"]["content"], str)
    rendered = _chat_prompt_tokens(tokenizer, messages)
    want = _cut_at_stop(naive_greedy(setup, rendered, 8), set(tokenizer.stop_tokens))
    assert choice["token_ids"] == want
    assert body["usage"]["prompt_tokens"] == len(rendered)


def test_chat_completions_stream(chat_server):
    """stream=true emits chat.completion.chunk deltas: role first, content
    deltas, a finish_reason chunk with usage, then [DONE]."""
    _srv, _tokenizer, url = chat_server
    ctype, events = _stream(url, "/v1/chat/completions",
                            {"messages": [{"role": "user", "content": "go"}], "max_tokens": 4})
    assert ctype.startswith("text/event-stream")
    assert events[0]["object"] == "chat.completion.chunk"
    assert events[0]["choices"][0]["delta"] == {"role": "assistant"}
    final = events[-1]
    assert final["choices"][0]["finish_reason"] in ("stop", "length")
    assert final["usage"]["completion_tokens"] >= 1
    got = [t for e in events[1:-1] for t in e["choices"][0]["token_ids"]]
    assert len(got) == final["usage"]["completion_tokens"]


@pytest.mark.parametrize(
    "body",
    [{"messages": []}, {"messages": [{"role": "assistant", "content": "x"}]},
     {"messages": [{"role": "tool", "content": "x"}]}, {"messages": [{"role": "user", "content": 3}]}],
    ids=["empty", "assistant-last", "unknown-role", "non-string-content"],
)
def test_chat_completions_validation(server, chat_server, body):
    """Bad chat requests 400 cleanly: no tokenizer, empty messages, assistant
    last, unknown role, non-string content."""
    _srv, url = server  # tokenizer-less server
    code, resp = _post(url, "/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}]})
    assert code == 400 and "tokenizer" in resp["error"]["message"]
    _srv2, _tok, churl = chat_server
    code, _resp = _post(churl, "/v1/chat/completions", body)
    assert code == 400, body


def test_start_surfaces_begin_stream_error(setup):
    """A scheduler thread that dies in begin_stream must raise from start(),
    not leave it waiting on the started-event forever."""
    cfg, _, tparams = setup
    engine = make_engine(tparams, cfg, speculate_k=2)  # greedy-only mode
    sp = SamplingParams(temperature=0.7, max_tokens=4, stop_token_ids=())
    srv = Server(engine, sp, model_id="bad")
    with pytest.raises(ValueError, match="greedy"):
        srv.start()


def test_incremental_decoder_repairs_split_utf8():
    """A multi-byte character split across two deltas streams as the real
    character once complete, never as U+FFFD mojibake."""

    class ByteTok:
        def decode(self, ids):
            return bytes(ids).decode("utf-8", errors="replace")

    dec = _IncrementalDecoder(ByteTok())
    payload = "héllo 🦜!".encode()
    # worst case: one byte per delta
    text = "".join(dec.push([b]) for b in payload)
    assert text == "héllo 🦜!"
    # split exactly at the emoji's 4-byte boundary, two bytes per delta
    dec2 = _IncrementalDecoder(ByteTok())
    chunks = [list(payload[i : i + 2]) for i in range(0, len(payload), 2)]
    text2 = "".join(dec2.push(c) for c in chunks)
    assert text2 == "héllo 🦜!"
    # genuinely invalid trailing byte stays held back (OpenAI convention)
    dec3 = _IncrementalDecoder(ByteTok())
    assert dec3.push(list("ab".encode()) + [0xFF]) == "ab"


def test_submit_timeout_cancels_request(setup):
    """A timed-out submit frees the engine slot instead of decoding the full
    budget for a dead client."""
    cfg, _, tparams = setup
    engine = make_engine(tparams, cfg, n_slots=2, max_context=64)
    sp = SamplingParams(temperature=0.0, max_tokens=40, stop_token_ids=())
    srv = Server(engine, sp, model_id="t")
    srv.start()
    try:
        pend = srv.submit([1, 2, 3], None, timeout_s=0.0)  # expires immediately
        assert pend.error == "timed out"
        # the scheduler must cancel it and return the slot + pages
        for _ in range(100):
            if all(s.req is None for s in engine._slots) and not srv._q.qsize():
                break
            time.sleep(0.05)
        assert all(s.req is None for s in engine._slots)
        assert len(engine._free_pages) + len(engine._cache_lru) == engine.n_pages
    finally:
        srv.stop()


# --- the port's own hazards ------------------------------------------------------------------


def test_scheduler_thread_records_no_autograd_graph(setup):
    """Grad mode is per thread: the scheduler thread runs the engine under
    ``no_grad``, so even parameters that require grad leave the KV pools and
    the stream state free of any graph, and every step sees grad mode off."""
    cfg, _, tparams = setup
    params = {k: ({n: w.clone().requires_grad_(True) for n, w in v.items()} if k == "layers"
                  else v.clone().requires_grad_(True)) for k, v in tparams.items()}
    engine = make_engine(params, cfg, n_slots=2, max_context=64)
    grad_modes = []
    real_step = engine.step

    def step():
        grad_modes.append(torch.is_grad_enabled())
        return real_step()

    engine.step = step
    srv = Server(engine, SamplingParams(temperature=0.0, max_tokens=6, stop_token_ids=()), model_id="t")
    srv.start()
    try:
        prompt = np.random.default_rng(151).integers(1, cfg.vocab_size - 1, 9).tolist()
        done = srv.submit(prompt, None)
        assert done.error is None
        assert done.outputs[0]["token_ids"] == naive_greedy(setup, prompt, 6)
        assert grad_modes and not any(grad_modes)
        for pool in engine.pools.values():
            assert pool.grad_fn is None and not pool.requires_grad
        assert engine._st.tok.grad_fn is None and engine._st.seq_lens.grad_fn is None
    finally:
        srv.stop()


def test_concurrent_string_prompts_tokenize_beside_the_decode(setup, chat_server):
    """Handler threads encode string prompts through the native BPE core while
    the scheduler thread decodes: every concurrent response is the request's
    own greedy stream over its own encoding."""
    _srv, tokenizer, url = chat_server
    texts = ["hello world", "héllo wörld 🦜", "the quick brown fox", "a", "speech units",
             "ümlaut ß straße", "0123456789", "mixed CASE words here"]
    results = [None] * len(texts)

    def go(i):
        results[i] = _post(url, "/v1/completions", {"prompt": texts[i], "max_tokens": 6})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    stops = set(tokenizer.stop_tokens)
    for i, text in enumerate(texts):
        code, body = results[i]
        assert code == 200, (i, body)
        ids = tokenizer.encode(text, add_bos=True, add_eos=False)
        assert body["usage"]["prompt_tokens"] == len(ids), i
        assert body["choices"][0]["token_ids"] == _cut_at_stop(naive_greedy(setup, ids, 6), stops), i
        assert body["choices"][0]["text"] == tokenizer.decode(body["choices"][0]["token_ids"]), i


def test_request_count_loses_no_update_under_thread_switches(setup):
    """``/metrics``' ``requests`` is counted by the handler threads; with
    many more submitting threads than cores and a very short switch
    interval, no increment is lost."""
    import sys

    cfg, _, tparams = setup
    srv = Server(make_engine(tparams, cfg, n_slots=4, max_context=64),
                 SamplingParams(temperature=0.0, max_tokens=1, stop_token_ids=()), model_id="t")
    srv.start()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        errors = []

        def go(i):
            for j in range(4):
                pend = srv.submit([1 + (i + j) % 7, 2, 3], None, timeout_s=120)
                if pend.error is not None:
                    errors.append(pend.error)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
        srv.stop()
    assert errors == []
    assert srv.metrics()["requests"] == 128


# --- parity with the JAX server ---------------------------------------------------------------


@pytest.fixture(scope="module")
def twins(setup, tokenizers):
    """The JAX server (gather engine, pipelined harvest) and the port's, on the
    same weights, each with its own package's tokenizer over one file."""
    cfg, jparams, tparams = setup
    ptok, jtok = tokenizers
    stops = tuple(ptok.stop_tokens)
    assert stops == tuple(jtok.stop_tokens)
    jsrv = JServer(make_jax_engine(jparams, cfg, n_slots=3, max_context=64),
                   JSamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=stops),
                   tokenizer=jtok, model_id="tiny-twin")
    psrv = Server(make_engine(tparams, cfg, n_slots=3, max_context=64),
                  SamplingParams(temperature=0.0, max_tokens=8, stop_token_ids=stops),
                  tokenizer=ptok, model_id="tiny-twin")
    jurl, jstop = serve_http(jsrv)
    purl, pstop = serve_http(psrv)
    yield jurl, purl, ptok
    jstop()
    pstop()


def _prompt(seed, vocab, n=10):
    return np.random.default_rng(seed).integers(1, vocab - 1, n).tolist()


def _assert_choices_equal(jbody, pbody):
    assert set(pbody) == set(jbody)
    assert pbody["object"] == jbody["object"] and pbody["model"] == jbody["model"]
    assert pbody["usage"] == jbody["usage"]
    assert len(pbody["choices"]) == len(jbody["choices"])
    for jc, pc in zip(jbody["choices"], pbody["choices"]):
        assert set(pc) == set(jc)
        assert pc["token_ids"] == jc["token_ids"]
        assert pc["finish_reason"] == jc["finish_reason"]
        assert pc.get("text") == jc.get("text") and pc.get("message") == jc.get("message")
        assert pc["cumulative_logprob"] == pytest.approx(jc["cumulative_logprob"], abs=1e-4)
        if "logprobs" in jc:
            jl, pl = jc["logprobs"], pc["logprobs"]
            assert pl["tokens"] == jl["tokens"] and pl["text_offset"] == jl["text_offset"]
            assert pl["top_logprobs"] is jl["top_logprobs"] is None
            np.testing.assert_allclose(pl["token_logprobs"], jl["token_logprobs"], atol=1e-4, rtol=0)


_REQUESTS = {
    "token-ids": ("/v1/completions", lambda v: {"prompt": _prompt(201, v)}),
    "token-ids-max-tokens": ("/v1/completions", lambda v: {"prompt": _prompt(202, v), "max_tokens": 3}),
    "string": ("/v1/completions", lambda v: {"prompt": "héllo speech wörld"}),
    "logprobs": ("/v1/completions", lambda v: {"prompt": _prompt(203, v), "logprobs": 1}),
    "top-k-1": ("/v1/completions", lambda v: {"prompt": _prompt(204, v), "temperature": 0.8, "top_k": 1}),
    "stop-string": ("/v1/completions", lambda v: {"prompt": "abc", "stop": ["zz", "%W"]}),  # 'WWW%WWWW'
    "stop-token-ids": ("/v1/completions", lambda v: {"prompt": _prompt(214, v), "stop": "gg", "logprobs": 1}),
    "chat": ("/v1/chat/completions", lambda v: {"messages": [{"role": "system", "content": "be brief"},
                                                             {"role": "user", "content": "hi 🦜"}]}),
    "chat-logprobs": ("/v1/chat/completions", lambda v: {"messages": [{"role": "user", "content": "go"}],
                                                         "logprobs": True, "max_tokens": 5}),
    "bad-max-tokens": ("/v1/completions", lambda v: {"prompt": _prompt(206, v), "max_tokens": 99}),
    "bad-stop": ("/v1/completions", lambda v: {"prompt": _prompt(206, v), "stop": [1]}),
    "bad-penalty": ("/v1/completions", lambda v: {"prompt": _prompt(206, v), "repetition_penalty": 1.2}),
    "bad-chat": ("/v1/chat/completions", lambda v: {"messages": [{"role": "tool", "content": "x"}]}),
    "n-2": ("/v1/completions", lambda v: {"prompt": _prompt(215, v, 19), "n": 2, "logprobs": 1}),
    "n-3-chat": ("/v1/chat/completions", lambda v: {"messages": [{"role": "user", "content": "go"}], "n": 3}),
    "n-2-stream": ("/v1/completions", lambda v: {"prompt": _prompt(216, v), "n": 2, "stream": True}),
    "n-2-stop": ("/v1/completions", lambda v: {"prompt": _prompt(216, v), "n": 2, "stop": "gg"}),
    "n-9": ("/v1/completions", lambda v: {"prompt": _prompt(216, v), "n": 9}),
}


@pytest.mark.parametrize("name", list(_REQUESTS))
def test_responses_match_the_jax_server(setup, twins, name):
    """The same request to both servers: token ids, finish reasons, usage and
    texts equal; logprobs within 1e-4; a 400's message equal."""
    jurl, purl, _ = twins
    path, make = _REQUESTS[name]
    body = make(setup[0].vocab_size)
    jcode, jbody = _post(jurl, path, body)
    pcode, pbody = _post(purl, path, body)
    assert pcode == jcode, (jbody, pbody)
    if jcode != 200:
        assert pbody == jbody
        return
    _assert_choices_equal(jbody, pbody)
    if "stop" in name:  # the stop string is met mid-output
        assert pbody["choices"][0]["finish_reason"] == "stop" and pbody["choices"][0]["text"]


def test_n_gt_1_is_the_one_difference(setup, twins):
    """``n: 2`` is no longer a difference: greedy, both servers answer the
    same two choices; sampled (temperature 0.7, seeded), both answer two
    choices of the budget's length, and the port's reproduce themselves
    (sampled tokens cannot equal ``jax.random``'s bits)."""
    jurl, purl, _ = twins
    prompt = _prompt(207, setup[0].vocab_size)
    jcode, jbody = _post(jurl, "/v1/completions", {"prompt": prompt, "n": 2})
    pcode, pbody = _post(purl, "/v1/completions", {"prompt": prompt, "n": 2})
    assert jcode == pcode == 200
    _assert_choices_equal(jbody, pbody)
    assert pbody["choices"][0]["token_ids"] == pbody["choices"][1]["token_ids"]
    body = {"prompt": prompt, "n": 2, "temperature": 0.7, "seed": 3, "max_tokens": 6}
    code, jbody = _post(jurl, "/v1/completions", body)
    assert code == 200 and len(jbody["choices"]) == 2
    runs = [_post(purl, "/v1/completions", body) for _ in range(2)]
    assert all(code == 200 for code, _ in runs) and runs[0][1]["choices"] == runs[1][1]["choices"]
    assert [c["index"] for c in runs[0][1]["choices"]] == [0, 1]
    assert all(len(c["token_ids"]) == 6 or c["finish_reason"] == "stop" for c in runs[0][1]["choices"])


_STREAMS = {
    "completions": ("/v1/completions", lambda v: {"prompt": _prompt(211, v)}),
    "completions-string-stop": ("/v1/completions", lambda v: {"prompt": "abc", "stop": "%"}),
    "completions-stop": ("/v1/completions", lambda v: {"prompt": _prompt(214, v), "stop": ["gg"]}),  # 'qqqqqqgg'
    "chat": ("/v1/chat/completions", lambda v: {"messages": [{"role": "user", "content": "go 🦜"}]}),
}


@pytest.mark.parametrize("name", list(_STREAMS))
def test_streams_match_the_jax_server(setup, twins, name):
    """Streamed deltas may be cut at other places (when a chunk counts as
    finished is timing in both engines), but the concatenated token ids and
    text, the first chat chunk and the final chunk are equal."""
    jurl, purl, _ = twins
    path, make = _STREAMS[name]
    body = make(setup[0].vocab_size)
    (jtype, jev), (ptype, pev) = _stream(jurl, path, body), _stream(purl, path, body)
    assert ptype == jtype
    chat = path.endswith("chat/completions")

    def joined(events):
        body_events = events[1:-1] if chat else events[:-1]
        ids = [t for e in body_events for t in e["choices"][0]["token_ids"]]
        text = "".join(e["choices"][0]["delta"]["content"] if chat else e["choices"][0].get("text", "")
                       for e in body_events)
        return ids, text

    assert joined(pev) == joined(jev)
    if "stop" in name:  # the stop string is met mid-output
        assert pev[-1]["choices"][0]["finish_reason"] == "stop" and joined(pev)[1]
    strip = lambda e: {k: v for k, v in e.items() if k != "id"}  # noqa: E731
    assert strip(pev[-1]) == strip(jev[-1])
    if chat:
        assert strip(pev[0]) == strip(jev[0])


@pytest.mark.parametrize(
    "messages",
    [[{"role": "user", "content": "hi"}],
     [{"role": "system", "content": "be brief"}, {"role": "user", "content": "héllo 🦜"}],
     [{"role": "user", "content": "a"}, {"role": "assistant", "content": "b"}, {"role": "user", "content": "c d"}]],
    ids=["user", "system-unicode", "multi-turn"],
)
def test_chat_prompt_tokens_match_the_jax_package(tokenizers, messages):
    from ssi_tpu.serve import _chat_prompt_tokens as j_chat_prompt_tokens

    ptok, jtok = tokenizers
    assert _chat_prompt_tokens(ptok, messages) == j_chat_prompt_tokens(jtok, messages)


def test_incremental_decoder_matches_the_jax_package(tokenizers):
    """The same pushes of real token ids (a multi-byte character split across
    pushes among them) give the same pieces from both packages' decoders."""
    from ssi_tpu.serve import _IncrementalDecoder as JIncrementalDecoder

    ptok, jtok = tokenizers
    ids = ptok.encode("héllo 🦜 wörld, straße!", add_bos=False, add_eos=False)
    assert ids == jtok.encode("héllo 🦜 wörld, straße!", add_bos=False, add_eos=False)
    for width in (1, 2, 3):
        pdec, jdec = _IncrementalDecoder(ptok), JIncrementalDecoder(jtok)
        pushes = [ids[i : i + width] for i in range(0, len(ids), width)]
        pieces = [pdec.push(p) for p in pushes]
        assert pieces == [jdec.push(p) for p in pushes]
        assert "".join(pieces) == "héllo 🦜 wörld, straße!"


def test_metrics_keys_and_roofline_bytes_match_the_jax_server(setup):
    """``/metrics`` has the JAX server's key set, and after the same greedy
    stream (sequential requests; both engines at harvest depth 1) the
    roofline byte counters are equal."""
    metrics_parity(setup, depth=1)


def test_metrics_match_the_jax_server_at_depth_2(setup):
    """The same with both engines at depth 2, their chunks unfinished until
    harvested (one schedule: the counters include the chunks in flight)."""
    metrics_parity(setup, depth=2)


def metrics_parity(setup, depth):
    cfg, jparams, tparams = setup
    sp = dict(temperature=0.0, max_tokens=8, stop_token_ids=())
    jsrv = JServer(slow_jax(make_jax_engine(jparams, cfg, n_slots=3, max_context=64, pipeline_depth=depth)),
                   JSamplingParams(**sp), model_id="t")
    psrv = Server(slow_port(make_engine(tparams, cfg, n_slots=3, max_context=64, pipeline_depth=depth)),
                  SamplingParams(**sp), model_id="t")
    jurl, jstop = serve_http(jsrv)
    purl, pstop = serve_http(psrv)
    try:
        rng = np.random.default_rng(221)
        prompts = [rng.integers(1, cfg.vocab_size - 1, int(n)).tolist() for n in (5, 17, 30)]
        prompts.append(prompts[2][:20] + [3, 4, 5])  # a prefix-cache hit: the suffix pass
        for prompt in prompts:
            jcode, jbody = _post(jurl, "/v1/completions", {"prompt": prompt})
            pcode, pbody = _post(purl, "/v1/completions", {"prompt": prompt})
            assert jcode == pcode == 200 and pbody["choices"][0]["token_ids"] == jbody["choices"][0]["token_ids"]
        _, jm = _get(jurl, "/metrics")
        _, pm = _get(purl, "/metrics")
    finally:
        jstop()
        pstop()
    assert set(pm) == set(jm)
    assert pm["weight_bytes"] > 0 and pm["kv_bytes"] > 0 and pm["cached_prompt_tokens"] > 0
    for key in ("weight_bytes", "kv_bytes", "chunk_dispatches", "slot_chunks", "prefill_dispatches", "prefill_rows",
                "prefill_token_area", "prompt_tokens", "tokens_out", "cached_prompt_tokens", "pages_shared",
                "requests", "free_pages", "cached_pages", "n_pages"):
        assert pm[key] == jm[key], key
    # and after the stream ends, the engines' own records agree on the keys too
    assert set(psrv.engine.last_stats) == set(jsrv.engine.last_stats)
