"""The port's tokenizer stack (``tokenizer.model`` reader, native C++ BPE core,
``Llama3Tokenizer``, DSU extension, speech helpers) against the JAX package's
tokenizer on its tiktoken backend, on the tiny extended vocabulary and on the
128,000-entry base vocabulary the WER drive synthesizes."""

import importlib.util
from pathlib import Path
import sys

import pytest
from tiktoken.load import load_tiktoken_bpe as tiktoken_load

import ssi_tpu.extend as jextend
import ssi_tpu.speech as jspeech
import ssi_tpu.tokenizer as jtok
import ssi_tpu.tokenizer.messages as jmessages
import ssi_tpu_torch.extend as pextend
import ssi_tpu_torch.speech as pspeech
import ssi_tpu_torch.tokenizer as ptok
import ssi_tpu_torch.tokenizer.messages as pmessages
from tests import helpers

REPO = Path(__file__).resolve().parent.parent
N_DSUS = 5000


def _load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def wer_drive():
    import logging

    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    try:
        return _load_module("wer_drive_for_tests", REPO / "tools" / "wer_drive.py")
    finally:  # the script configures console logging when it is imported
        root.handlers = handlers
        root.setLevel(level)


@pytest.fixture(scope="module")
def vocabularies(tmp_path_factory, wer_drive):
    """{name: extended tokenizer.model}: the tiny byte vocabulary + 16 DSUs, and
    the drive's 128,000-entry base + 5,000 DSUs (both with modality tokens)."""
    root = tmp_path_factory.mktemp("vocab")
    tiny = helpers.write_tiny_tokenizer(root / "tiny" / "tokenizer.model")
    jextend.extend_tiktoken(helpers.TINY_N_DSUS, True, tiny, tiny)
    big = root / "big" / "tokenizer.model"
    wer_drive.build_base_tokenizer(big, wer_drive.WORDS)
    jextend.extend_tiktoken(N_DSUS, True, big, big)
    return {"tiny": (tiny, helpers.TINY_N_DSUS), "128k": (big, N_DSUS)}


@pytest.fixture(scope="module", params=["tiny", "128k"])
def tokenizers(request, vocabularies):
    path, n_dsus = vocabularies[request.param]
    port, port_special = ptok.setup_llama3_tokenizer(path, verbose=False)
    _, jax_special = jtok.setup_llama3_tokenizer(path, verbose=False)
    assert port_special == jax_special
    jax = jtok.Llama3Tokenizer(path, special_tokens=jax_special, backend="tiktoken")
    return port, jax, n_dsus


def _texts(n_dsus: int, words: list[str]) -> list[str]:
    dsus = "".join(jspeech.dsu2pua(i % n_dsus) for i in (0, 1, 1, 7, n_dsus - 1, 3, 3, 3))
    return [
        "",
        "the people of the world",
        " ".join(words[:40]) + "  \n\n  " + " ".join(words[40:60]),
        dsus,
        jspeech.MODALITY_TOKEN_SPEECH + dsus + jspeech.MODALITY_TOKEN_TEXT + " the end",
        "it's <|begin_of_text|> and <|eot_id|> in user text <|reserved_special_token_7|>",
        "numbers 12345 and punctuation!?... café ſ 'S 'll",
        "x" * (jtok.MAX_NO_WHITESPACE_CHARS + 777) + " tail",
        (dsus * 4000)[: jtok.MAX_NO_WHITESPACE_CHARS * 2 + 5],
        ("the world " + dsus) * (jtok.MAX_ENCODE_CHARS // 18 + 1),  # past MAX_ENCODE_CHARS
    ]


def test_model_reader_equals_tiktoken(vocabularies):
    for path, _ in vocabularies.values():
        assert ptok.load_tiktoken_bpe(path) == tiktoken_load(str(path))


def test_encode_decode_equal_jax(tokenizers, wer_drive):
    port, jax, n_dsus = tokenizers
    assert port.vocab_size == jax.vocab_size and port.base_vocab_size == jax.base_vocab_size
    assert (port.bos_id, port.eos_id, port.pad_id, port.stop_tokens) == (jax.bos_id, jax.eos_id, jax.pad_id,
                                                                            jax.stop_tokens)
    for text in _texts(n_dsus, wer_drive.WORDS):
        for add_bos, add_eos in ((True, True), (False, False)):
            ids = port.encode(text, add_bos=add_bos, add_eos=add_eos)
            assert ids == jax.encode(text, add_bos=add_bos, add_eos=add_eos), text[:40]
        ids = port.encode(text) + [port.eot_id] + port.encode("after", add_bos=False)
        for trunc in (True, False):
            for skip in (True, False):
                assert port.decode(ids, truncate_at_eos=trunc, skip_special_tokens=skip) == \
                    jax.decode(ids, truncate_at_eos=trunc, skip_special_tokens=skip)


def test_tokenize_messages_equal_jax(tokenizers):
    port, jax, n_dsus = tokenizers
    span = "".join(pspeech.dsu2pua(i % n_dsus) for i in range(0, 60, 3))

    def conversation(messages_mod):
        m = messages_mod.Message
        return [
            m(role="system", content="You will act as an ASR system. ", masked=True),
            m(role="user", content=[{"type": "text", "content": pspeech.MODALITY_TOKEN_SPEECH + span}], masked=True),
            m(role="assistant", content="the world of people <|eot_id|>", masked=False),
        ]

    for add_end_tokens in (True, False):
        assert port.tokenize_messages(conversation(pmessages), add_end_tokens=add_end_tokens) == \
            jax.tokenize_messages(conversation(jmessages), add_end_tokens=add_end_tokens)
    port.max_seq_len = jax.max_seq_len = 17
    try:
        for add_end_tokens in (True, False):
            assert port.tokenize_messages(conversation(pmessages), add_end_tokens=add_end_tokens) == \
                jax.tokenize_messages(conversation(jmessages), add_end_tokens=add_end_tokens)
    finally:
        port.max_seq_len = jax.max_seq_len = None


def test_synthesized_vocabularies_byte_equal(tmp_path, wer_drive):
    """The port's copy of the drive's base tokenizer (``ssi_tpu_torch/wer_drive.py``,
    which chip_smoke.py uses too) and the port's ``extend_tiktoken`` write the
    bytes the originals write."""
    from ssi_tpu_torch import wer_drive as port_drive

    assert port_drive.WORDS == wer_drive.WORDS and port_drive.BASE_VOCAB == wer_drive.BASE_VOCAB
    a, b = tmp_path / "a" / "tokenizer.model", tmp_path / "b" / "tokenizer.model"
    wer_drive.build_base_tokenizer(a, wer_drive.WORDS)
    port_drive.build_base_tokenizer(b, port_drive.WORDS)
    assert a.read_bytes() == b.read_bytes()
    for modality in (True, False):
        ja, pa = tmp_path / f"j{modality}.model", tmp_path / f"p{modality}.model"
        jextend.extend_tiktoken(N_DSUS, modality, a, ja)
        pextend.extend_tiktoken(N_DSUS, modality, a, pa)
        assert ja.read_bytes() == pa.read_bytes()
    with pytest.raises(FileExistsError):
        pextend.extend_tiktoken(1, False, a, pa)


def test_copied_sources_and_helpers_equal():
    # bpe.cc adds the CL100K_PATTERN scanner, so only the Unicode tables stay a
    # byte copy; tests/test_torch_cl100k.py holds both scanners to tiktoken
    name = "unicode_tables.h"
    assert (REPO / "ssi_tpu_torch" / "native" / "src" / name).read_bytes() == \
        (REPO / "ssi_tpu" / "native" / "src" / name).read_bytes(), name
    for dsu in (0, 1, 6399, 6400, 8191, pspeech.MAX_DSUS - 1):
        assert pspeech.dsu2pua(dsu) == jspeech.dsu2pua(dsu)
        assert pspeech.pua2dsu(pspeech.dsu2pua(dsu)) == dsu
    assert (pspeech.MODALITY_TOKEN_TEXT, pspeech.MODALITY_TOKEN_SPEECH, pspeech.MAX_DSUS) == \
        (jspeech.MODALITY_TOKEN_TEXT, jspeech.MODALITY_TOKEN_SPEECH, jspeech.MAX_DSUS)
    assert ptok.LLAMA3_SPECIAL_TOKENS == jtok.LLAMA3_SPECIAL_TOKENS
    assert ptok.CL100K_PATTERN_PUA == jtok.CL100K_PATTERN_PUA
    assert ptok.CL100K_PATTERN == jtok.CL100K_PATTERN
    for bad in ([], [pmessages.Message("assistant", "x"), pmessages.Message("user", "y")]):
        with pytest.raises(ValueError):
            pmessages.validate_messages(bad)


def test_cl100k_pattern_raises_naming_its_item(vocabularies, monkeypatch):
    """``cl100k`` loads (tests/test_torch_cl100k.py holds it to tiktoken); a
    split regex the C++ scanner does not implement loads through the
    ``regex`` package (tests/test_torch_regex_pattern.py), and is refused
    by that package's name when it is missing."""
    path, _ = vocabularies["tiny"]
    tok, _ = ptok.setup_llama3_tokenizer(path, verbose=False, pattern="cl100k")
    assert tok.pattern == ptok.CL100K_PATTERN
    tok, _ = ptok.setup_llama3_tokenizer(path, verbose=False, pattern=r"\S+|\s+")
    assert tok.pattern == r"\S+|\s+" and tok.encode("ab  cd", add_bos=False, add_eos=False)
    monkeypatch.setitem(sys.modules, "regex", None)
    with pytest.raises(ImportError, match="'regex'"):
        ptok.setup_llama3_tokenizer(path, verbose=False, pattern=r"\S+|\s+")


def test_native_build_has_no_fallback(tmp_path, monkeypatch):
    """Without g++ the native core raises; it never switches to another backend."""
    import ssi_tpu_torch.native as native

    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load_native()
