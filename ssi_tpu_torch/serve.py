"""OpenAI-style HTTP serving over the paged engine — the port's twin of
``ssi_tpu/serve.py`` (the ``vllm serve`` role).

A single scheduler thread owns the engine and runs the incremental API in a
loop; HTTP handler threads submit requests through a queue and block on
per-request events. Endpoints, request and response schemas and messages are
the JAX package's:

- ``POST /v1/completions`` — body ``{"prompt": str | [int], "max_tokens"?,
  "temperature"?, "top_p"?, "top_k"?, "seed"?, "n"?, "presence_penalty"?,
  "frequency_penalty"?, "repetition_penalty"?, "stop"?, "logprobs"?,
  "stream"?}``. String prompts require a tokenizer; token-id prompts always
  work. Returns an OpenAI-shaped text_completion with ``token_ids`` in every
  choice (and ``text`` when a tokenizer is present). ``stop`` (string or list)
  ends generation at the first match, excluded from the returned text — the
  scheduler scans decoded output each pass and host-cancels via
  ``engine.cancel_request``; a mid-stream client disconnect aborts the same
  way, so a dead socket never holds a slot.
- ``POST /v1/chat/completions`` — body ``{"messages": [{"role", "content"}],
  ...same sampling fields...}``, rendered through the Llama-3 chat format
  (``tokenize_messages`` with an open assistant turn); OpenAI
  ``chat.completion`` objects (``chat.completion.chunk`` deltas under
  ``stream=true``). Requires a tokenizer.
- ``GET /health`` — liveness.
- ``GET /v1/models`` — the served model id.
- ``GET /metrics`` — the engine stream's counters (``last_stats``: the JAX
  engine's keys) plus page-pool gauges.

Which sampling branches the stream carries is fixed at startup
(``features`` — default sample+topk+topp; add "pen" for the penalty params);
a request needing an absent branch gets a clean 400.

The engine below pipelines two decode chunks, as the JAX engine does, so a
request's tokens reach the stream pushes one harvest after the card wrote
them; when a chunk counts as finished is timing, so streamed deltas may be
cut at other token boundaries than the JAX server's (their concatenation and
every final record are the same). ``n > 1`` returns n choices (not with
``stream`` or ``stop``: 400s, as in JAX); a client that goes away cancels
every sequence of its request. Grad mode and the current CUDA device are
per thread in PyTorch: the scheduler thread runs the engine under
``no_grad`` on the engine's card. Under ``tensor_parallel`` the server runs
on rank 0, the engine's driver; cancels and stop cuts are host-side there,
so the other ranks, which only run its device dispatches, stay in step.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import torch

from ssi_tpu_torch.generate.engine import SamplingParams

LOGGER = logging.getLogger(__name__)

# sampling branches opened on the serving stream by default: temperature/
# top_p/top_k/seed per request. "pen" is opt-in — its [slots, vocab] count
# arrays add a large host->device transfer to every dispatch.
DEFAULT_FEATURES = frozenset({"sample", "topk", "topp"})


@dataclass
class _Pending:
    prompt: list[int]
    max_tokens: int | None
    sampling: SamplingParams | None = None
    seed: int | None = None
    event: threading.Event = field(default_factory=threading.Event)
    outputs: list[dict] | None = None
    error: str | None = None
    # OpenAI `stop` strings: the scheduler scans decoded output each pass and
    # host-cancels the request at the first match (engine.cancel_request)
    stop: tuple = ()
    stop_text: str | None = None   # decoded output truncated AT the stop match
    scan_from: int = 0             # tokens already stop-scanned (see scan_stops)
    rid: int | None = None         # engine request id (set at admission)
    aborted: bool = False          # client disconnected; cancel instead of admit
    # streaming: the scheduler pushes newly-harvested token-id deltas here and
    # a final None sentinel; `sent` tracks how many tokens have been pushed.
    # Under greedy decoding deltas are exact even across preemption (the
    # re-decode reproduces the same stream, only tokens past `sent` are
    # pushed); with temperature > 0 a preempted request's re-sampled prefix
    # may diverge from what was already streamed.
    stream: bool = False
    deltas: "queue.Queue[list[int] | str | None]" = field(default_factory=queue.Queue)
    sent: int = 0


class Server:
    """Scheduler thread + request queue around one PagedDecodeEngine stream."""

    def __init__(
        self,
        engine: Any,
        sp: SamplingParams,
        *,
        tokenizer: Any = None,
        model_id: str = "ssi-tpu",
        idle_poll_s: float = 0.02,
        features: Any = DEFAULT_FEATURES,
    ):
        self.engine = engine
        self.sp = sp
        self.tokenizer = tokenizer
        self.model_id = model_id
        self.idle_poll_s = idle_poll_s
        self.features = frozenset(features) if features is not None else frozenset()
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._cancels: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._start_error: Exception | None = None
        self._n_requests = 0
        self._count_lock = threading.Lock()  # handler threads count requests concurrently

    # --- scheduler thread ----------------------------------------------------------

    def _loop(self) -> None:
        # grad mode and the current CUDA device are per thread: the engine's
        # tensors record no autograd graph here and launch on its card
        device = getattr(self.engine, "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)
        with torch.no_grad():
            self._serve()

    def _serve(self) -> None:
        eng = self.engine
        try:
            eng.begin_stream(self.sp, features=self.features)
        except Exception as e:
            # surface config errors (bad feature names, invalid sp, spec-mode
            # sampling) to start() instead of leaving it waiting forever
            self._start_error = e
            self._started.set()
            return
        self._started.set()
        by_id: dict[int, _Pending] = {}
        restarts = 0

        def admit(item: _Pending) -> bool:
            if item.aborted:  # client vanished while queued
                item.error = "client disconnected"
                item.event.set()
                return False
            try:
                rid = eng.add_request(
                    item.prompt, max_tokens=item.max_tokens,
                    sampling=item.sampling, seed=item.seed,
                )
            except Exception as e:  # validation errors (and refusals) -> the waiting handler
                item.error = str(e)
                if item.stream:
                    item.deltas.put(None)
                item.event.set()
                return False
            item.rid = rid
            by_id[rid] = item
            return True

        def stop_cut(pend: _Pending, out: list[int]) -> int | None:
            """Shortest token prefix of ``out`` whose decoded text contains a
            stop string (None if no match); sets ``pend.stop_text`` to the text
            truncated AT the match (the stop sequence itself is excluded)."""
            text = self.tokenizer.decode(out)
            if not any(s in text for s in pend.stop):
                return None
            lo, hi = 1, len(out)
            while lo < hi:
                mid = (lo + hi) // 2
                if any(s in self.tokenizer.decode(out[:mid]) for s in pend.stop):
                    hi = mid
                else:
                    lo = mid + 1
            ktext = self.tokenizer.decode(out[:lo])
            pend.stop_text = ktext[: min(ktext.index(s) for s in pend.stop if s in ktext)]
            return lo

        def scan_stops(pend: _Pending, req: Any) -> None:
            """Mid-run stop-string check: host-cancel at the first match so the
            slot frees immediately instead of decoding to the budget.

            Incremental: only the unscanned tail (plus a char-aligned backoff of
            maxlen(stop)-1 chars for matches straddling the boundary) is decoded
            each pass. Exact for byte-level BPE: decode(out[j:]) with no leading
            U+FFFD is the char suffix of the full text. A tail hit falls back to
            the exact global cut once."""
            out = req.out
            start = pend.scan_from
            pend.scan_from = len(out)
            if start > 0:
                hb = max(len(s) for s in pend.stop) - 1
                j = start
                while j > 0:
                    t = self.tokenizer.decode(out[j:start])
                    if len(t) >= hb and not t.startswith("�"):
                        break
                    j -= 1
            else:
                j = 0
            if not any(s in self.tokenizer.decode(out[j:]) for s in pend.stop):
                return
            k = stop_cut(pend, out)
            if k is not None:
                eng.cancel_request(pend.rid, keep_tokens=k, finish_reason="stop")

        def finalize_stops(pend: _Pending) -> None:
            """Completion-time stop cut: a match can arrive in the same harvest
            that finishes the request (budget/stop-token), after the last
            mid-run scan — truncate the finished record in place."""
            out = pend.outputs[0]
            if pend.stop_text is not None or not out["token_ids"]:
                return  # already cut by the mid-run cancel (or empty)
            k = stop_cut(pend, out["token_ids"])
            if k is None:
                return
            out["token_ids"] = out["token_ids"][:k]
            out["finish_reason"] = "stop"
            out["stop_reason"] = None
            if out.get("logprobs"):
                out["logprobs"] = out["logprobs"][:k]
                out["cumulative_logprob"] = float(sum(out["logprobs"]))

        try:
            while not self._stop.is_set() or by_id or not self._q.empty():
                moved = False
                while True:
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        break
                    moved |= admit(item)
                if not by_id and not moved:
                    # nothing in flight: block briefly on the queue instead of
                    # spinning step() against an idle engine
                    try:
                        admit(self._q.get(timeout=self.idle_poll_s))
                    except queue.Empty:
                        pass
                    continue
                try:
                    records = eng.step()
                except Exception as e:
                    # a failed step ends the engine stream (it released every
                    # slot/page); fail the in-flight requests and restart so
                    # the server outlives one bad scheduling state
                    restarts += 1
                    LOGGER.exception(f"engine step failed (restart {restarts}): {e}")
                    for pend in by_id.values():
                        pend.error = f"engine error: {e}"
                        if pend.stream:
                            pend.deltas.put(None)
                        pend.event.set()
                    by_id.clear()
                    if restarts > 16:
                        raise  # persistent failure: stop serving rather than loop
                    eng.begin_stream(self.sp, features=self.features)
                    continue
                for rec in records:
                    pend = by_id.pop(rec["request_id"], None)
                    if pend is not None:
                        pend.outputs = rec["outputs"]
                        if pend.stop:
                            finalize_stops(pend)
                        if pend.stream:
                            out = pend.outputs[0]["token_ids"]
                            if pend.stop_text is not None:
                                # stop-string cut: the final delta is TEXT so the
                                # stream ends char-exactly at the match (a token
                                # boundary can land mid-stop-string)
                                sent_text = self.tokenizer.decode(out[: pend.sent]) if pend.sent else ""
                                if pend.stop_text.startswith(sent_text) and len(pend.stop_text) > len(sent_text):
                                    pend.deltas.put(pend.stop_text[len(sent_text) :])
                                pend.sent = len(out)
                            elif len(out) > pend.sent:
                                pend.deltas.put(out[pend.sent :])
                                pend.sent = len(out)
                            pend.deltas.put(None)  # terminal sentinel
                        pend.event.set()
                # client-disconnect aborts: free the slot instead of decoding
                # to a dead socket (the terminal record surfaces next step)
                while True:
                    try:
                        pend = self._cancels.get_nowait()
                    except queue.Empty:
                        break
                    # identity check, not just rid membership: engine request
                    # ids restart from 0 on a stream restart, so a stale cancel
                    # queued before a restart must not abort the unrelated new
                    # request that now holds the same rid
                    if pend.rid is not None and by_id.get(pend.rid) is pend:
                        eng.cancel_request(pend.rid, finish_reason="abort")
                # stop strings + streamed-token pushes over the running slots
                if any(p.stop or p.stream for p in by_id.values()):
                    for slot in eng._slots:
                        req = slot.req
                        if req is None or req.idx not in by_id:
                            continue
                        pend = by_id[req.idx]
                        if pend.stop and not slot.done and req.out:
                            scan_stops(pend, req)
                            if slot.req is not req:  # cancelled (slot freed);
                                continue  # the record arrives next step
                        if not pend.stream:
                            continue
                        cap = pend.max_tokens if pend.max_tokens is not None else self.sp.max_tokens
                        have = min(len(req.out), cap)
                        if pend.stop and have > pend.sent:
                            # hold back trailing tokens spanning maxlen(stop)-1
                            # chars so a stop straddling two pushes is never
                            # partially streamed to the client
                            hb = max(len(s) for s in pend.stop) - 1
                            j = have
                            while j > pend.sent and len(self.tokenizer.decode(req.out[j:have])) < hb:
                                j -= 1
                            have = j if len(self.tokenizer.decode(req.out[j:have])) >= hb else pend.sent
                        if have > pend.sent:
                            pend.deltas.put(req.out[pend.sent : have])
                            pend.sent = have
        finally:
            eng.end_stream()
            # unblock anything still waiting (server shutdown)
            for pend in by_id.values():
                pend.error = "server shut down"
                if pend.stream:
                    pend.deltas.put(None)
                pend.event.set()

    def start(self) -> None:
        self._start_error = None
        self._thread = threading.Thread(target=self._loop, name="ssi-serve-scheduler", daemon=True)
        self._thread.start()
        self._started.wait()
        if self._start_error is not None:
            raise self._start_error

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)

    # --- request API ----------------------------------------------------------------

    def submit(
        self,
        prompt: list[int],
        max_tokens: int | None,
        timeout_s: float = 600,
        sampling: SamplingParams | None = None,
        seed: int | None = None,
        stop: tuple = (),
    ) -> _Pending:
        if stop and self.tokenizer is None:
            raise ValueError("stop strings need a tokenizer")
        pend = _Pending(prompt=prompt, max_tokens=max_tokens, sampling=sampling,
                        seed=seed, stop=stop)
        self._q.put(pend)
        if not pend.event.wait(timeout=timeout_s):
            pend.error = "timed out"
            # free the slot: without this the engine keeps decoding to the full
            # budget for a client that already got the timeout response
            self.cancel(pend)
        with self._count_lock:
            self._n_requests += 1
        return pend

    def submit_stream(
        self,
        prompt: list[int],
        max_tokens: int | None,
        sampling: SamplingParams | None = None,
        seed: int | None = None,
        stop: tuple = (),
    ) -> _Pending:
        """Enqueue a streamed request and return immediately; the caller
        drains ``pend.deltas`` (token-id lists — or a str for a stop-string
        cut's char-exact final text — then a None sentinel)."""
        if stop and self.tokenizer is None:
            raise ValueError("stop strings need a tokenizer")
        pend = _Pending(prompt=prompt, max_tokens=max_tokens, stream=True,
                        sampling=sampling, seed=seed, stop=stop)
        self._q.put(pend)
        with self._count_lock:
            self._n_requests += 1
        return pend

    def cancel(self, pend: _Pending) -> None:
        """Abort a request whose client vanished: if already admitted the
        scheduler host-cancels it on its next pass (freeing the slot); if
        still queued it is dropped at admission."""
        pend.aborted = True
        self._cancels.put(pend)

    def metrics(self) -> dict:
        eng = self.engine
        stats = dict(eng.last_stats) if eng.last_stats else {}
        stats.update(
            requests=self._n_requests,
            free_pages=len(eng._free_pages),
            cached_pages=len(eng._cache_lru),
            n_pages=eng.n_pages,
        )
        return stats


class _IncrementalDecoder:
    """Streaming detokenizer: decoding each token-id delta independently splits
    multi-byte UTF-8 characters spanning a harvest boundary into U+FFFD mojibake.
    Decode the full prefix instead and emit only the newly-stable text, holding
    back trailing replacement chars (an incomplete byte sequence the next delta
    completes; genuinely-invalid trailing bytes at stream end stay held back —
    the OpenAI/vLLM streaming convention)."""

    def __init__(self, tokenizer: Any):
        self.tokenizer = tokenizer
        self.ids: list[int] = []
        self.sent_chars = 0

    def push(self, ids: list[int]) -> str:
        self.ids.extend(ids)
        full = self.tokenizer.decode(self.ids)
        stable = len(full)
        while stable > self.sent_chars and full[stable - 1] == "�":
            stable -= 1
        new = full[self.sent_chars : stable]
        self.sent_chars = stable
        return new


def _make_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        # quiet the default per-request stderr lines
        def log_message(self, fmt, *args):
            LOGGER.debug("http: " + fmt, *args)

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [{"id": server.model_id, "object": "model"}]})
            elif self.path == "/metrics":
                self._json(200, server.metrics())
            else:
                self._json(404, {"error": {"message": f"unknown path {self.path}"}})

        def _stream_completion(
            self, tokens: list[int], mt: int | None,
            sampling: SamplingParams | None, seed: int | None,
            chat: bool = False, stop: tuple = (),
        ) -> None:
            """Server-sent events: one `data:` line per harvested token delta,
            a final record with finish_reason, then `data: [DONE]`. A client
            disconnect mid-stream aborts the request (frees its slot)."""
            pend = server.submit_stream(tokens, mt, sampling=sampling, seed=seed, stop=stop)
            obj = "chat.completion.chunk" if chat else "text_completion"
            cid = f"{'chatcmpl' if chat else 'cmpl'}-{int(time.time() * 1e3)}"
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

            def emit(obj_: dict) -> None:
                self.wfile.write(b"data: " + json.dumps(obj_).encode() + b"\n\n")
                self.wfile.flush()

            dec = _IncrementalDecoder(server.tokenizer)

            def delta_text(ids: list[int]) -> str | None:
                return dec.push(ids) if server.tokenizer is not None else None

            try:
                if chat:  # conventional first chunk carrying the role
                    emit({"id": cid, "object": obj, "model": server.model_id,
                          "choices": [{"index": 0, "delta": {"role": "assistant"},
                                       "finish_reason": None}]})
                while True:
                    try:
                        delta = pend.deltas.get(timeout=600)
                    except queue.Empty:
                        pend.error = "timed out"
                        server.cancel(pend)  # free the slot for live clients
                        break
                    if delta is None:
                        break
                    if isinstance(delta, str):  # char-exact stop-string tail
                        text, ids = delta, []
                    else:
                        ids = delta
                        text = delta_text(delta)
                    if chat:
                        choice = {"index": 0, "delta": {"content": text},
                                  "token_ids": ids, "finish_reason": None}
                    else:
                        choice = {"index": 0, "token_ids": ids, "finish_reason": None}
                        if text is not None:
                            choice["text"] = text
                    emit({"id": cid, "object": obj, "model": server.model_id,
                          "choices": [choice]})
                if pend.error is not None:
                    emit({"id": cid, "error": {"message": pend.error}})
                else:
                    out = pend.outputs[0]
                    final = {"index": 0, "finish_reason": out["finish_reason"]}
                    if chat:
                        final["delta"] = {}
                    else:
                        final["token_ids"] = []
                    emit({"id": cid, "object": obj, "model": server.model_id,
                          "choices": [final],
                          "usage": {"prompt_tokens": len(tokens),
                                    "completion_tokens": len(out["token_ids"])}})
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                # the client can vanish at any point, including between the last
                # content delta and [DONE] — abort quietly either way
                server.cancel(pend)
                return

        def do_POST(self):
            chat = self.path == "/v1/chat/completions"
            if self.path != "/v1/completions" and not chat:
                self._json(404, {"error": {"message": f"unknown path {self.path}"}})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                if chat:
                    tokens = _chat_prompt_tokens(server.tokenizer, req.get("messages"))
                else:
                    prompt = req.get("prompt")
                    if isinstance(prompt, str):
                        if server.tokenizer is None:
                            raise ValueError("string prompts need a tokenizer; pass token ids")
                        tokens = server.tokenizer.encode(prompt, add_bos=True, add_eos=False)
                    elif isinstance(prompt, list) and all(isinstance(t, int) for t in prompt):
                        tokens = prompt
                    else:
                        raise ValueError("prompt must be a string or a list of token ids")
                mt = req.get("max_tokens")
                mt = int(mt) if mt is not None else None
                stream = bool(req.get("stream", False))
                # per-request sampling params (OpenAI surface); only build an
                # override when the request actually sets one, so default
                # traffic stays on the stream's params
                overrides: dict[str, Any] = {}
                for name, cast in (
                    ("temperature", float), ("top_p", float), ("top_k", int),
                    ("n", int), ("presence_penalty", float),
                    ("frequency_penalty", float), ("repetition_penalty", float),
                ):
                    if req.get(name) is not None:
                        overrides[name] = cast(req[name])
                sampling = dataclasses.replace(server.sp, **overrides) if overrides else None
                seed = int(req["seed"]) if req.get("seed") is not None else None
                n = overrides.get("n", server.sp.n)
                if stream and n != 1:
                    raise ValueError("stream=true requires sampling n == 1")
                # OpenAI `stop` strings: scanned host-side over decoded output
                stop = req.get("stop")
                if stop is None:
                    stop = ()
                elif isinstance(stop, str):
                    stop = (stop,)
                elif isinstance(stop, list) and all(isinstance(s, str) and s for s in stop):
                    stop = tuple(stop)
                else:
                    raise ValueError("stop must be a non-empty string or a list of them")
                if stop and server.tokenizer is None:
                    raise ValueError("stop strings need a tokenizer")
                if stop and n != 1:
                    raise ValueError("stop strings require sampling n == 1")
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                # TypeError covers non-numeric JSON values in the casts above
                # (e.g. "temperature": [0.5]) — a 400, not a handler crash
                self._json(400, {"error": {"message": str(e), "type": "invalid_request_error"}})
                return

            if stream:
                self._stream_completion(tokens, mt, sampling, seed, chat=chat, stop=stop)
                return

            pend = server.submit(tokens, mt, sampling=sampling, seed=seed, stop=stop)
            if pend.error is not None:
                self._json(400, {"error": {"message": pend.error, "type": "invalid_request_error"}})
                return
            choices = []
            for i, out in enumerate(pend.outputs):
                choice = {
                    "index": i,
                    "token_ids": out["token_ids"],
                    "finish_reason": out["finish_reason"],
                    "cumulative_logprob": out["cumulative_logprob"],
                }
                if req.get("logprobs"):
                    # OpenAI logprobs object (chosen-token logprobs; top-N
                    # alternatives are not tracked -> top_logprobs null)
                    lps = out.get("logprobs") or []
                    ids = out["token_ids"][: len(lps)]
                    if server.tokenizer is not None:
                        toks = [server.tokenizer.decode([t]) for t in ids]
                        offs, pos = [], 0
                        for t in toks:
                            offs.append(pos)
                            pos += len(t)
                    else:
                        toks = [str(t) for t in ids]
                        offs = None
                    choice["logprobs"] = {"tokens": toks, "token_logprobs": lps,
                                          "top_logprobs": None, "text_offset": offs}
                # a stop-string cut's text is char-exact (the last token can
                # straddle the match); token_ids were truncated by the engine
                text = pend.stop_text if pend.stop_text is not None and out["finish_reason"] == "stop" \
                    else (server.tokenizer.decode(out["token_ids"]) if server.tokenizer is not None else None)
                if chat:
                    choice["message"] = {"role": "assistant", "content": text}
                elif text is not None:
                    choice["text"] = text
                choices.append(choice)
            self._json(200, {
                "id": f"{'chatcmpl' if chat else 'cmpl'}-{int(time.time() * 1e3)}",
                "object": "chat.completion" if chat else "text_completion",
                "model": server.model_id,
                "choices": choices,
                "usage": {
                    "prompt_tokens": len(tokens),
                    "completion_tokens": sum(len(c["token_ids"]) for c in choices),
                },
            })

    return Handler


def _chat_prompt_tokens(tokenizer: Any, messages: Any) -> list[int]:
    """Render an OpenAI chat ``messages`` list to prompt token ids: Llama-3
    chat format with an open assistant turn (the SFT inference construction —
    ref: ssi/data/sft.py:317-326 builds the same empty-assistant tail)."""
    from ssi_tpu_torch.tokenizer.messages import Message

    if tokenizer is None:
        raise ValueError("chat completions need a tokenizer")
    if not isinstance(messages, list) or not messages:
        raise ValueError("messages must be a non-empty list of {role, content}")
    msgs = []
    for m in messages:
        if not isinstance(m, dict):
            raise ValueError("each message must be an object with role and content")
        role, content = m.get("role"), m.get("content")
        if role not in ("system", "user", "assistant"):
            raise ValueError(f"unsupported role {role!r} (system/user/assistant)")
        if not isinstance(content, str):
            raise ValueError("message content must be a string")
        msgs.append(Message(role=role, content=content, masked=True))
    if msgs[-1].role == "assistant":
        raise ValueError("the last message must be a user (or system) turn")
    msgs.append(Message(role="assistant", content="", masked=False))
    tokens, _mask = tokenizer.tokenize_messages(msgs, add_end_tokens=False)
    return tokens


def run_http_server(server: Server, host: str = "127.0.0.1", port: int = 8000) -> ThreadingHTTPServer:
    """Bind and return the HTTP server (caller drives serve_forever/shutdown)."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(server))
    return httpd


def serve_forever(server: Server, host: str = "127.0.0.1", port: int = 8000) -> None:
    server.start()
    httpd = run_http_server(server, host, port)
    LOGGER.info(f"serving on http://{host}:{port} (model {server.model_id})")
    try:
        httpd.serve_forever()
    finally:
        httpd.shutdown()
        server.stop()


def run_server(cfg: Any) -> None:
    """CLI body: load the checkpoint and tokenizer (the resolution of
    ``ssi_tpu/serve.py`` ``run_server``) onto the configured device (the card
    unless ``+device=cpu``) and serve until interrupted.

    With ``tensor_parallel: N > 1`` (a process group of N ranks, joined by
    the CLI) every rank loads only its slices; rank 0 runs the ``Server`` and
    the HTTP port, the other ranks follow its dispatches (ignoring SIGINT)
    until rank 0 stops and closes the engine. Each rank logs its pid."""
    import os
    import shutil
    import signal
    import tempfile

    from ssi_tpu_torch.checkpoint import Checkpointer
    from ssi_tpu_torch.generate import _serving_mesh
    from ssi_tpu_torch.generate.paged_engine import PagedDecodeEngine
    from ssi_tpu_torch.models.configs import get_model_config
    from ssi_tpu_torch.tokenizer import setup_llama3_tokenizer
    from ssi_tpu_torch.utils import resolve_device

    device = resolve_device(cfg)  # refuse before any work when the card is missing
    mesh = _serving_mesh(int(cfg.get("tensor_parallel", 1) or 1))
    if mesh is not None:
        LOGGER.info(f"tensor-parallel rank {mesh.tp_rank} of {mesh.tp} (pid {os.getpid()})")

    tokenizer, _special = setup_llama3_tokenizer(**{k: v for k, v in cfg.tokenizer.items()})
    stop_token_ids = cfg.sampling_params.get("stop_token_ids")
    if stop_token_ids is None:
        stop_token_ids = list(tokenizer.stop_tokens)

    model_cfg = get_model_config(cfg.get("model_config", "llama3_2_1b")).copy()
    model_cfg.update_from_speech_cfg(cfg.speech)
    scratch = tempfile.mkdtemp(prefix="ssi_serve_ckpt_")  # the loader never writes here
    try:
        checkpointer = Checkpointer(
            checkpoint_dir=cfg.model,
            output_dir=scratch,
            model_expectations=model_cfg.checkpoint_expectations,
        )
        dtype = torch.bfloat16 if cfg.get("dtype", "bf16") == "bf16" else torch.float32
        params = checkpointer.load_params(model_cfg, dtype=dtype, device=device, mesh=mesh)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    sp = SamplingParams.from_cfg(cfg.sampling_params, stop_token_ids)
    engine = PagedDecodeEngine(
        params, model_cfg, pad_id=tokenizer.pad_id,
        n_slots=int(cfg.get("batch_size", 32)),
        max_context=int(cfg.get("max_cache_len") or 4096),
        quantize=cfg.get("quantize_weights"),
        speculate_k=int(cfg.get("speculate_k", 0) or 0),
        prefix_caching=bool(cfg.get("prefix_caching", True)),
        prefill_chunk=cfg.get("prefill_chunk"),
        admission_order=str(cfg.get("admission_order", "fifo") or "fifo"),
        mesh=mesh,
    )
    if not engine.is_driver:
        # stopped by rank 0's message, never mid-collective by an interrupt
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        engine.follow()
        LOGGER.info("rank 0 closed the engine; follower done")
        return
    feat_cfg = cfg.server.get("sampling_features", "sample,topk,topp")
    features = frozenset(f.strip() for f in str(feat_cfg or "").split(",") if f.strip())
    server = Server(engine, sp, tokenizer=tokenizer, model_id=str(cfg.model), features=features)
    try:
        serve_forever(server, host=str(cfg.server.host), port=int(cfg.server.port))
    finally:
        if server._thread is not None and server._thread.is_alive():
            # the scheduler thread still dispatches: a message from this
            # thread could interleave with its own on the side group
            LOGGER.error("the scheduler thread did not stop; the followers are not released")
        else:
            engine.close()
