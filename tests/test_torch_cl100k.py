"""The port's C++ scanner for ``CL100K_PATTERN`` (BPE-compressed DSU runs)
against the JAX tokenizer's tiktoken backend, token for token: the edge cases
of ``tests/test_native_bpe.py`` and private-use codepoints around letters,
digits, punctuation and newlines, 1,500 fuzz strings with DSU characters,
decode round trips, the whole-piece mode against tiktoken's ``(?s:.+)``, and
``split`` against ``regex.finditer``. The vocabulary is
``tests/test_native_bpe.py``'s ``_train_ranks`` recipe plus DSU merges
trained by the JAX package's trainer."""

import base64
import random
import sys

import numpy as np
import pytest
import regex
import tiktoken

import ssi_tpu.tokenizer as jtok
from ssi_tpu.speech import MODALITY_TOKEN_SPEECH, MODALITY_TOKEN_TEXT, dsu2pua
from ssi_tpu.tokenizer.bpe_train import merge_into_tokenizer, train_bpe
from ssi_tpu_torch.native import bpe as native_bpe
import ssi_tpu_torch.tokenizer as ptok
from tests.test_native_bpe import EDGE_CASES, _train_ranks

N_DSUS = 40


def _dsu_line(rng, n: int) -> str:
    """A Markov-ish DSU stream: pairs held 1-2 times, so merges have signal."""
    toks = []
    while len(toks) < n:
        pair = rng.integers(0, N_DSUS, 2)
        toks.extend(int(t) for t in pair for _ in range(rng.integers(1, 3)))
    return "".join(dsu2pua(t) for t in toks[:n])


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    """(path, special tokens): the mixed-text ranks, then trained DSU merges and
    the two modality tokens appended as ``merge_into_tokenizer`` does."""
    root = tmp_path_factory.mktemp("cl100k")
    base = root / "base.model"
    with open(base, "w") as f:
        for tok, r in sorted(_train_ranks().items(), key=lambda kv: kv[1]):
            f.write(base64.b64encode(tok).decode() + f" {r}\n")
    rng = np.random.default_rng(5)
    dsu_ranks = train_bpe([_dsu_line(rng, 90) for _ in range(96)], 200)
    path = root / "tokenizer.model"
    assert merge_into_tokenizer(base, dsu_ranks, path, use_modality_tokens=True) > 0
    _, special = jtok.setup_llama3_tokenizer(path, verbose=False)
    return path, special


@pytest.fixture(scope="module")
def tokenizers(vocab):
    path, special = vocab
    port = ptok.Llama3Tokenizer(path, special_tokens=special, pattern=ptok.CL100K_PATTERN)
    jax = jtok.Llama3Tokenizer(path, special_tokens=special, pattern=jtok.CL100K_PATTERN)
    assert jax._native is None  # the JAX tokenizer runs this pattern on tiktoken
    return port, jax


PUA_CASES = [
    "\ue000abc",  # a private-use prefix of a letter run
    "\U000f0000abc \U00100000xyz \U0010fffdq",  # planes 15 and 16 as prefixes
    "12\ue000 3\U000f0001\U000f0002",  # after digits
    "a\ue000\ue001\ue002b",  # a DSU run between letters
    "!?\ue000.,\ue001;(\U000f0000)",  # among punctuation: one piece
    " \ue000\ue001!\r\n\r\nx",  # space + DSU/punct run + trailing newlines
    "\ue000\r\n\ue001\n\n",  # before \r\n
    "\ue000   \ue001  ",  # whitespace before and after: \s+(?!\S) leaves the last space
    "  \ue000\n",
    MODALITY_TOKEN_SPEECH + "\ue000\ue001\ue002" + MODALITY_TOKEN_TEXT + " the end",
    "'s\ue000 it's\U000f0000's",
    "\ue000" * 3 + "text" + "\uf8ff" * 2,
]


def _enc(tok, s):
    return tok.encode(s, add_bos=False, add_eos=False)


def test_edge_cases_equal_tiktoken(tokenizers):
    port, jax = tokenizers
    rng = np.random.default_rng(9)
    for s in EDGE_CASES + PUA_CASES + [_dsu_line(rng, 300), "hello " + _dsu_line(rng, 50) + " world"]:
        assert _enc(port, s) == _enc(jax, s), repr(s)


def test_fuzz_equal_tiktoken(tokenizers):
    port, jax = tokenizers
    alphabet = list(
        "abcdefghij THEQUICKtheol 'ſS'sſ éß日本語中文 0123456789.,!?;:()[]#@-_\n\r\t   　"
    ) + ["\uf8ff", "\U000f0000", "\U00100000", "\U0010fffd", "😀", "'", MODALITY_TOKEN_TEXT,
         MODALITY_TOKEN_SPEECH] + [dsu2pua(i) for i in range(0, N_DSUS, 3)] * 3
    rng = random.Random(1)
    for _ in range(1500):
        s = "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 80)))
        assert _enc(port, s) == _enc(jax, s), repr(s)


def test_decode_round_trip(tokenizers):
    port, jax = tokenizers
    rng = np.random.default_rng(3)
    for s in PUA_CASES + [_dsu_line(rng, 120), "hello 'ſ world  中文"]:
        ids = port.encode(s) + [port.eot_id] + port.encode("after", add_bos=False)
        for trunc in (True, False):
            for skip in (True, False):
                assert port.decode(ids, truncate_at_eos=trunc, skip_special_tokens=skip) == \
                    jax.decode(ids, truncate_at_eos=trunc, skip_special_tokens=skip)
        assert port.decode(_enc(port, s), truncate_at_eos=False) == s
    assert port.vocab_size == jax.vocab_size


def test_dsu_spans_compress(tokenizers, vocab):
    """Under cl100k a DSU span is one piece and the trained merges fire: fewer
    tokens than DSUs; under the PUA pattern at least one a DSU."""
    port, _ = tokenizers
    pua, _ = ptok.setup_llama3_tokenizer(vocab[0], verbose=False)
    line = _dsu_line(np.random.default_rng(11), 200)
    assert len(_enc(port, line)) < len(line) <= len(_enc(pua, line))


def test_whole_piece_mode_equals_tiktoken(vocab):
    path, _ = vocab
    ranks = ptok.load_tiktoken_bpe(path)
    tt = tiktoken.Encoding(name="whole", pat_str=r"(?s:.+)", mergeable_ranks=ranks, special_tokens={})
    whole = native_bpe.NativeEncoding(str(path), pattern="whole")
    from_ranks = native_bpe.NativeEncoding(None, pattern="whole", ranks=ranks)
    rng = random.Random(4)
    nrng = np.random.default_rng(4)
    texts = EDGE_CASES + PUA_CASES + [_dsu_line(nrng, 200) for _ in range(5)]
    texts += ["".join(rng.choice("ab \n\ue000\ue003.1") for _ in range(rng.randint(1, 60))) for _ in range(300)]
    for s in texts:
        want = tt.encode(s, allowed_special=set(), disallowed_special=())
        assert whole.encode(s) == want == from_ranks.encode(s), repr(s)


def test_split_equals_regex():
    alphabet = list("ab Zé日0189.,!'ſs\n\r\t  　") + ["\ue000", "\uf8ff", "\U000f0000", "\U0010fffd", "😀"]
    rng = random.Random(2)
    pats = {"cl100k": regex.compile(jtok.CL100K_PATTERN), "cl100k_pua": regex.compile(jtok.CL100K_PATTERN_PUA)}
    for _ in range(1500):
        s = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 60)))
        for name, pat in pats.items():
            assert native_bpe.split(s, name) == [m.group() for m in pat.finditer(s)], (name, repr(s))
    assert native_bpe.split("ab \ue000", "whole") == ["ab \ue000"] and native_bpe.split("", "whole") == []
    with pytest.raises(ValueError, match="unknown native split pattern"):
        native_bpe.split("x", "gpt2")


def test_other_regex_raises_naming_a11(vocab, monkeypatch):
    """A regex the scanner does not implement goes to the ``regex`` package
    (A11's remainder, ported): equal to tiktoken, and refused by the
    package's name when ``regex`` is missing; the two scanner patterns load
    without it."""
    path, special = vocab
    for pattern in (r"\S+|\s+", jtok.CL100K_PATTERN + "|x"):
        port = ptok.Llama3Tokenizer(path, special_tokens=special, pattern=pattern)
        jax = jtok.Llama3Tokenizer(path, special_tokens=special, pattern=pattern)
        for s in PUA_CASES:
            assert _enc(port, s) == _enc(jax, s), repr(s)
        assert ptok.setup_llama3_tokenizer(path, verbose=False, pattern=pattern)[0].pattern == pattern
    monkeypatch.setitem(sys.modules, "regex", None)
    for pattern in (r"\S+|\s+", jtok.CL100K_PATTERN + "|x"):
        with pytest.raises(ImportError, match="'regex'"):
            ptok.Llama3Tokenizer(path, special_tokens=special, pattern=pattern)
        with pytest.raises(ImportError, match="'regex'"):
            ptok.setup_llama3_tokenizer(path, verbose=False, pattern=pattern)
    for name, pattern in (("cl100k", ptok.CL100K_PATTERN), ("cl100k_pua", ptok.CL100K_PATTERN_PUA),
                          (None, ptok.CL100K_PATTERN_PUA), (ptok.CL100K_PATTERN, ptok.CL100K_PATTERN)):
        assert ptok.setup_llama3_tokenizer(path, verbose=False, pattern=name)[0].pattern == pattern
