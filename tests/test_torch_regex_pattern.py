"""Arbitrary split regexes in the port's tokenizer against the JAX
tokenizer's tiktoken backend: the ``regex`` package cuts the pieces and the
C++ core merges each whole (``NativeEncoding.encode_pieces``, one native
call a text). Held token for token on seeded texts with DSU characters,
U+001C-U+001F, digits, contractions, CJK and emoji under the PUA pattern
wrapped as ``(?:...)`` (the same language, not the scanner's string),
GPT-2's pattern and o200k's; ``tokenize_messages`` and decode too; the
wrapped pattern equal to the native scanner's ids; the CPT CLI with
``tokenizer.pattern`` set to a raw regex; the refusal when ``regex`` is
missing."""

import base64
import json
import logging
import random
import sys

import numpy as np
import pytest
import torch

import ssi_tpu.tokenizer as jtok
from ssi_tpu.speech import MODALITY_TOKEN_SPEECH, MODALITY_TOKEN_TEXT, dsu2pua
from ssi_tpu.tokenizer.bpe_train import merge_into_tokenizer, train_bpe
from ssi_tpu.tokenizer.messages import Message as JaxMessage
from ssi_tpu_torch.native import bpe as native_bpe
import ssi_tpu_torch.tokenizer as ptok
from ssi_tpu_torch.tokenizer.messages import Message as PortMessage
from tests import helpers
from tests.test_native_bpe import _train_ranks

PUA_WRAPPED = "(?:" + ptok.CL100K_PATTERN_PUA + ")"
GPT2_PATTERN = r"""'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
O200K_PATTERN = "|".join([
    r"""[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?""",
    r"""[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?""",
    r"""\p{N}{1,3}""",
    r""" ?[^\s\p{L}\p{N}]+[\r\n/]*""",
    r"""\s*[\r\n]+""",
    r"""\s+(?!\S)""",
    r"""\s+""",
])
PATTERNS = {"pua_wrapped": PUA_WRAPPED, "gpt2": GPT2_PATTERN, "o200k": O200K_PATTERN}
ALPHABET = (list("ab Zé日本語0189.,!?'ſsSdtm\n\r\t  　") + ["\x1c", "\x1d", "\x1e", "\x1f", "\x85", "😀", "👍🏽",
            "'s", "'ll", "'RE", " don't", "1234567", "", "", "\U000f0000", "\U0010fffd"]
            + [dsu2pua(k) for k in range(24)])


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    """(path, special tokens): the mixed-text ranks of ``tests/test_native_bpe.py``,
    then trained DSU merges and the modality tokens."""
    root = tmp_path_factory.mktemp("regex_pattern")
    base = root / "base.model"
    with open(base, "w") as f:
        for tok, r in sorted(_train_ranks().items(), key=lambda kv: kv[1]):
            f.write(base64.b64encode(tok).decode() + f" {r}\n")
    rng = np.random.default_rng(5)
    rows = ["".join(dsu2pua(int(k)) for k in rng.integers(0, 24, 90)) for _ in range(64)]
    path = root / "tokenizer.model"
    assert merge_into_tokenizer(base, train_bpe(rows, 120), path, use_modality_tokens=True) > 0
    _, special = jtok.setup_llama3_tokenizer(path, verbose=False)
    return path, special


def seeded_texts(seed: int, n: int = 400) -> list[str]:
    rng = random.Random(seed)
    texts = ["", "x", "\x1c\x1d\x1e\x1f", "ab\x1ccd ef\x1f gh", MODALITY_TOKEN_SPEECH + "" + MODALITY_TOKEN_TEXT,
             "it's 12345 dollars, isn't it?\n\n  ", "日本語のテキスト 😀😀 end", "<|begin_of_text|> plain"]
    return texts + ["".join(rng.choice(ALPHABET) for _ in range(rng.randint(1, 80))) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_encode_equals_the_jax_tokenizer(vocab, name):
    path, special = vocab
    pattern = PATTERNS[name]
    port = ptok.Llama3Tokenizer(path, special_tokens=special, pattern=pattern)
    jax = jtok.Llama3Tokenizer(path, special_tokens=special, pattern=pattern)
    assert jax._native is None and port._split is not None  # tiktoken there, regex + the C++ merge here
    for i, s in enumerate(seeded_texts(seed=sorted(PATTERNS).index(name))):
        want = jax.encode(s, add_bos=i % 2 == 0, add_eos=i % 3 == 0)
        assert port.encode(s, add_bos=i % 2 == 0, add_eos=i % 3 == 0) == want, repr(s)
        assert port.decode(want) == jax.decode(want)
    messages = [("system", "Transcribe.\x1c"), ("user", "".join(dsu2pua(k) for k in (3, 3, 7, 1))),
                ("assistant", "it's 2024 — 日本 😀")]
    for max_seq_len in (None, 12):
        port.max_seq_len = jax.max_seq_len = max_seq_len
        for inference in (False, True):
            want = jax.tokenize_messages([JaxMessage(role=r, content=c) for r, c in messages],
                                         add_end_tokens=not inference)
            got = port.tokenize_messages([PortMessage(role=r, content=c) for r, c in messages],
                                         add_end_tokens=not inference)
            assert got == want


def test_setup_with_a_raw_regex_equals_jax(vocab):
    path, _ = vocab
    for pattern in (GPT2_PATTERN, r"\S+|\s+"):
        port, port_special = ptok.setup_llama3_tokenizer(path, verbose=False, pattern=pattern)
        jax, jax_special = jtok.setup_llama3_tokenizer(path, verbose=False, pattern=pattern)
        assert port.pattern == jax.pattern == pattern and port_special == jax_special
        assert port.vocab_size == jax.vocab_size
        for s in seeded_texts(seed=3, n=100):
            assert port.encode(s) == jax.encode(s)


def test_wrapped_pua_pattern_takes_the_regex_route_and_equals_the_scanner(vocab):
    """The same language in another string: regex cuts and the native scanner cut the same pieces."""
    path, special = vocab
    scanner = ptok.Llama3Tokenizer(path, special_tokens=special)
    wrapped = ptok.Llama3Tokenizer(path, special_tokens=special, pattern=PUA_WRAPPED)
    assert scanner._split is None and wrapped._split is not None
    for s in seeded_texts(seed=11):
        assert wrapped.encode(s) == scanner.encode(s), repr(s)


def test_encode_pieces_merges_each_piece_whole(vocab):
    """One native call over many pieces equals each piece's whole-mode encode; empty pieces give nothing."""
    path, special = vocab
    whole = native_bpe.NativeEncoding(str(path), special, pattern="whole")
    rng = random.Random(4)
    for _ in range(200):
        pieces = ["".join(rng.choice(ALPHABET) for _ in range(rng.randint(0, 6))) for _ in range(rng.randint(0, 30))]
        assert whole.encode_pieces(pieces) == [t for p in pieces for t in whole.encode(p)]
    assert whole.encode_pieces([]) == [] and whole.encode_pieces(["", ""]) == []


def test_missing_regex_is_refused_by_name(vocab, monkeypatch):
    path, special = vocab
    monkeypatch.setitem(sys.modules, "regex", None)
    for pattern in (GPT2_PATTERN, PUA_WRAPPED):
        with pytest.raises(ImportError, match="needs the package 'regex'"):
            ptok.Llama3Tokenizer(path, special_tokens=special, pattern=pattern)
        with pytest.raises(ImportError, match="needs the package 'regex'"):
            ptok.setup_llama3_tokenizer(path, verbose=False, pattern=pattern)
    # the two scanner patterns need no regex
    for pattern in (None, "cl100k", ptok.CL100K_PATTERN_PUA):
        assert ptok.setup_llama3_tokenizer(path, verbose=False, pattern=pattern)[0].encode("it's 12") != []


@pytest.fixture()
def one_thread():
    """One thread: the CPU GEMMs then sum in one order however loaded the machine is, so two runs on
    the same batches agree bitwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    yield
    torch.set_num_threads(n)
    for handler in root.handlers:
        if handler not in handlers:
            handler.close()
    root.handlers = handlers
    root.setLevel(level)


def test_cpt_cli_with_a_raw_regex_equals_the_scanner_run(tmp_path, one_thread):
    """``python -m ssi_tpu_torch.cli.train_cpt`` with ``tokenizer.pattern`` the
    wrapped PUA pattern: its tokenizer takes the regex route, and its losses
    and weights are bitwise the scanner run's."""
    from ssi_tpu_torch.cli.train_cpt import main as cpt_main

    step = helpers.make_tiny_hf_checkpoint(tmp_path / "step_0")
    rows = tmp_path / "cpt.jsonl"
    rows.write_text("".join(json.dumps(r) + "\n" for r in helpers.synthetic_cpt_rows(8, seed=2)))
    common = ["data=cpt/mls-hubert_large_ll60k-layer_22", "model_config=tiny_test",
              f"speech.n_dsus={helpers.TINY_N_DSUS}", f"checkpointer.checkpoint_dir={step}",
              f"tokenizer.path={step / 'original' / 'tokenizer.model'}", "tokenizer.max_seq_len=256", "dtype=fp32",
              "max_steps=2", "save_steps=2", "eval_steps=2", "log_interval=1", "wandb.enabled=false",
              "gradient_accumulation_steps=1", "+device=cpu",
              *[a for s in ("train", "dev") for a in (
                  f"data.{s}.dataset.source=json", f"+data.{s}.dataset.data_files={rows}",
                  f"data.{s}.dataset.split=train", f"data.{s}.dataloader.batch_size=2")]]
    runs = {}
    for name, extra in (("scanner", []), ("regex", [f"tokenizer.pattern={PUA_WRAPPED}"])):
        trainer = cpt_main([*common, *extra, f"checkpointer.output_dir={tmp_path / name}"])
        assert (trainer.tokenizer._split is not None) == (name == "regex")
        runs[name] = ([{k: v for k, v in json.loads(line).items()
                        if k not in ("duration_step", "tokens_per_second_per_gpu", "train_clock_time")}
                       for line in (tmp_path / name / "metrics.jsonl").read_text().splitlines()],
                      {k: v.clone() for k, v in trainer.state["params"]["layers"].items()})
    assert runs["regex"][0] == runs["scanner"][0]
    for k, w in runs["scanner"][1].items():
        assert torch.equal(runs["regex"][1][k], w), k
