"""The port's BPE trainer (``ssi_tpu_torch/tokenizer/bpe_train.py``) and its
``python -m ssi_tpu_torch.cli.train_dsu_bpe`` against the JAX package's
(``ssi_tpu/tokenizer/bpe_train.py``, ``scripts/train_dsu_bpe.py``): ranks
dict-equal in the three split modes on three seeded corpora, ``save_ranks``
and ``merge_into_tokenizer`` files byte-equal, ``compression_ratio`` floats
exactly equal, the CLI's ``tokenizer.model`` and ``stats.json`` byte-equal
to the script's, and the compressed tokenizer end to end (the twin of
``tests/test_bpe_train.py::test_compressed_dsu_tokenizer_end_to_end``)."""

import json
import os
from pathlib import Path
import subprocess
import sys

import numpy as np
import pytest

import ssi_tpu.tokenizer as jtok
import ssi_tpu.tokenizer.bpe_train as jbpe
from ssi_tpu.speech import dsu2pua
import ssi_tpu_torch.tokenizer as ptok
import ssi_tpu_torch.tokenizer.bpe_train as pbpe
from tests import helpers

REPO = Path(__file__).resolve().parent.parent
WORDS = ["the", "people", "world", "it's", "café", "naïve", "ſ", "12345", "x1", "don't", "日本語"]


def _dsu_corpus(n_rows=64, n_dsus=50, seed=0):
    """Markov-ish DSU streams: repeated bigrams so merges have signal
    (``tests/test_bpe_train.py``'s recipe)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_rows):
        toks = []
        while len(toks) < 80:
            pair = rng.integers(0, n_dsus, 2)
            toks.extend(int(t) for t in pair for _ in range(rng.integers(1, 3)))
        rows.append("".join(dsu2pua(t) for t in toks[:80]))
    return rows


def _text_corpus(seed: int, n_rows: int = 48) -> list[str]:
    """Words, punctuation, digits, newlines and DSU runs mixed, for the text modes."""
    rng = np.random.default_rng(seed)
    dsus = _dsu_corpus(n_rows, 20, seed)
    rows = []
    for i in range(n_rows):
        words = [WORDS[j] for j in rng.integers(0, len(WORDS), int(rng.integers(4, 16)))]
        cut = int(rng.integers(0, 40))
        rows.append(" ".join(words) + (",  " if i % 3 else "!\n\n") + dsus[i][cut:cut + 12] + " end.")
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["none", "cl100k", "s_or_space"])
def test_train_bpe_equals_jax(seed, mode, tmp_path):
    """Ranks dict-equal, the saved files byte-equal and the compression ratios
    exactly equal, with ``split_pattern`` None (DSU rows), ``CL100K_PATTERN``
    (the native split) and ``\\S+|\\s+`` (the ``regex`` package)."""
    pattern = {"none": None, "cl100k": jtok.CL100K_PATTERN, "s_or_space": r"\S+|\s+"}[mode]
    corpus = _dsu_corpus(seed=seed) if pattern is None else _text_corpus(seed)
    for min_pair_count in (2, 3):
        want = jbpe.train_bpe(corpus, 160, split_pattern=pattern, min_pair_count=min_pair_count)
        got = pbpe.train_bpe(corpus, 160, split_pattern=pattern, min_pair_count=min_pair_count)
        assert got == want and list(got) == list(want) and len(got) > 256
    jbpe.save_ranks(want, tmp_path / "jax.model")
    pbpe.save_ranks(got, tmp_path / "port.model")
    assert (tmp_path / "jax.model").read_bytes() == (tmp_path / "port.model").read_bytes()
    assert pbpe.compression_ratio(corpus, got) == jbpe.compression_ratio(corpus, want)
    assert pbpe.compression_ratio(["", *corpus[:3]], got) == jbpe.compression_ratio(["", *corpus[:3]], want)


def test_train_bpe_stops_and_raises_as_jax(monkeypatch):
    """No merge where no pair reaches the count; ``\\p{...}`` classes compile
    (the ``regex`` package, as in the JAX trainer), and without ``regex`` a
    text-mode pattern other than the two scanner patterns is refused by the
    package's name."""
    corpus = ["ab", "cd"]  # no pair reaches 2: no merge
    assert pbpe.train_bpe(corpus, 10) == jbpe.train_bpe(corpus, 10)
    assert pbpe.train_bpe([], 10) == jbpe.train_bpe([], 10)
    assert pbpe.compression_ratio([], jbpe.train_bpe([], 0)) == jbpe.compression_ratio([], jbpe.train_bpe([], 0))
    text = _text_corpus(4)
    assert pbpe.train_bpe(text, 40, split_pattern=r"\p{L}+") == jbpe.train_bpe(text, 40, split_pattern=r"\p{L}+")
    want = jbpe.train_bpe(text, 40, split_pattern=jtok.CL100K_PATTERN)
    monkeypatch.setitem(sys.modules, "regex", None)
    with pytest.raises(ImportError, match="'regex'"):
        pbpe.train_bpe(["a b"], 4, split_pattern=r"\p{L}+")
    assert pbpe.train_bpe(text, 40, split_pattern=jtok.CL100K_PATTERN) == want  # the scanner needs no regex


def test_text_mode_split_matches_jax_on_information_separators():
    """C8: ``re``'s ``\\s`` matches U+001C-U+001F and ``regex``'s does not, so
    ``\\S+|\\s+`` cut rows holding them into other pieces, and trained other
    merges, than the JAX trainer. The ranks are now bitwise the JAX
    trainer's, on rows where ``re``'s pieces differ."""
    import re

    import regex

    rng = np.random.default_rng(8)
    seps = ["\x1c", "\x1d", "\x1e", "\x1f"]
    rows = [" ".join(WORDS[j] + (seps[k % 4] if k % 3 else "") + WORDS[(j + k) % len(WORDS)]
                     for j, k in zip(rng.integers(0, len(WORDS), 12), rng.integers(0, 12, 12)))
            + seps[i % 4] + " " for i in range(40)]
    rows.append("ab\x1ccd ef\x1f gh")
    pattern = r"\S+|\s+"
    pieces_re = [m.group() for row in rows for m in re.finditer(pattern, row)]
    pieces_regex = [m.group() for row in rows for m in regex.finditer(pattern, row)]
    assert pieces_re != pieces_regex  # the rows reach C8
    assert [p.decode() for p in pbpe._pieces(rows, pattern)] == pieces_regex
    for min_pair_count in (2, 3):
        want = jbpe.train_bpe(rows, 120, split_pattern=pattern, min_pair_count=min_pair_count)
        got = pbpe.train_bpe(rows, 120, split_pattern=pattern, min_pair_count=min_pair_count)
        assert got == want and list(got) == list(want) and len(got) > 256


@pytest.mark.parametrize("modality", [False, True])
def test_merge_into_tokenizer_equals_jax(tmp_path, modality):
    ranks = jbpe.train_bpe(_dsu_corpus(n_rows=64, n_dsus=24, seed=11), 120)
    base = helpers.write_tiny_tokenizer(tmp_path / "base" / "tokenizer.model")
    j, p = tmp_path / "jax.model", tmp_path / "port.model"
    assert pbpe.merge_into_tokenizer(base, ranks, p, use_modality_tokens=modality) == \
        jbpe.merge_into_tokenizer(base, ranks, j, use_modality_tokens=modality) > 0
    assert p.read_bytes() == j.read_bytes()
    with pytest.raises(FileExistsError):
        pbpe.merge_into_tokenizer(base, ranks, p)
    if modality:  # a base that already holds a modality token
        with pytest.raises(RuntimeError, match="already exists"):
            pbpe.merge_into_tokenizer(p, ranks, tmp_path / "twice.model", use_modality_tokens=True)


def _rows_file(path: Path, n: int = 40, seed: int = 0) -> Path:
    """Speech-token rows as the script reads them: ints, a space-joined string
    on every third row, and holds (runs of one unit) for ``--deduplicate``."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        toks = np.repeat(rng.integers(0, 30, 40), rng.integers(1, 3, 40)).tolist()
        rows.append({"speech_tokens": " ".join(map(str, toks)) if i % 3 == 0 else toks, "ID": i})
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return path


@pytest.mark.parametrize("extra", [[], ["--deduplicate"], ["--n-samples", "17"], ["--deduplicate", "--n-samples", "9",
                                                                                  "--min-pair-count", "3"]])
def test_train_dsu_bpe_cli_writes_the_script_bytes(tmp_path, extra):
    """``scripts/train_dsu_bpe.py`` (a subprocess, ``--dataset json
    --data-files``) and ``python -m ssi_tpu_torch.cli.train_dsu_bpe`` (a
    subprocess too) write byte-identical ``tokenizer.model`` and ``stats.json``."""
    data = _rows_file(tmp_path / "rows.jsonl")
    env = {**os.environ, "PYTHONPATH": f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}"}
    args = ["--dataset", "json", "--data-files", str(data), "--n-merges", "64", *extra]
    outs = {}
    for name, cmd in (("jax", [str(REPO / "scripts" / "train_dsu_bpe.py")]),
                      ("port", ["-m", "ssi_tpu_torch.cli.train_dsu_bpe"])):
        outs[name] = tmp_path / name
        proc = subprocess.run([sys.executable, *cmd, str(outs[name]), *args], capture_output=True, text=True,
                              timeout=300, env=env, cwd=tmp_path)
        assert proc.returncode == 0, proc.stderr[-2000:]
    for f in ("tokenizer.model", "stats.json"):
        assert (outs["port"] / f).read_bytes() == (outs["jax"] / f).read_bytes(), f
    stats = json.loads((outs["port"] / "stats.json").read_text())
    assert stats["n_rows"] == (int(extra[extra.index("--n-samples") + 1]) if "--n-samples" in extra else 40)


def test_train_dsu_bpe_refusals(tmp_path):
    from ssi_tpu_torch.cli.train_dsu_bpe import main, parse_args

    data = _rows_file(tmp_path / "rows.jsonl")
    with pytest.raises(NotImplementedError, match="A12"):
        main(parse_args([str(tmp_path / "a"), "--dataset", "anilkeshwani/mls-hubert_large_ll60k-layer_22"]))
    with pytest.raises(NotImplementedError, match="A12"):
        main(parse_args([str(tmp_path / "b"), "--dataset", "text", "--data-files", str(data)]))
    with pytest.raises(KeyError):
        main(parse_args([str(tmp_path / "c"), "--dataset", "json", "--data-files", str(data),
                         "--speech-tokens-key", "absent"]))
    stats = main(parse_args([str(tmp_path / "d"), "--dataset", "json", "--data-files", str(data), "--n-merges", "8"]))
    assert stats["n_merges_learned"] == 8
    with pytest.raises(FileExistsError):
        main(parse_args([str(tmp_path / "d"), "--dataset", "json", "--data-files", str(data)]))


def test_streaming_json_source_is_lazy_and_in_file_order(tmp_path):
    from ssi_tpu_torch.data import load_hf_dataset

    data = _rows_file(tmp_path / "rows.jsonl", n=5)
    want = [json.loads(line) for line in data.read_text().splitlines()]
    rows = load_hf_dataset("json", data_files=str(data), split="train", streaming=True)
    assert not isinstance(rows, list) and next(rows) == want[0] and list(rows) == want[1:]
    assert load_hf_dataset("json", data_files=str(data), split="train", streaming=False) == want
    with pytest.raises(NotImplementedError, match="A12"):
        load_hf_dataset("json", data_files=str(data), split="train", streaming=True, num_proc=2)


def test_compressed_dsu_tokenizer_end_to_end(tmp_path):
    """The compression axis, operationally, through the port: train merges ->
    append to a base tokenizer -> load with the non-PUA pattern -> DSU streams
    encode shorter than 1 token/DSU, round-trip exactly, new ids sit in the
    appended range, and every id equals the JAX tokenizer's."""
    corpus = _dsu_corpus(n_rows=128, n_dsus=40, seed=7)
    ranks = pbpe.train_bpe(corpus, 300, split_pattern=None)

    base = helpers.write_tiny_tokenizer(tmp_path / "base" / "tokenizer.model")
    compressed = tmp_path / "compressed" / "tokenizer.model"
    compressed.parent.mkdir()
    n_appended = pbpe.merge_into_tokenizer(base, ranks, compressed)
    assert n_appended > 0

    tok, _specials = ptok.setup_llama3_tokenizer(compressed, verbose=False)
    assert tok.pattern != ptok.CL100K_PATTERN  # default load = PUA contract
    comp = ptok.Llama3Tokenizer(compressed, special_tokens=tok.special_tokens, pattern=ptok.CL100K_PATTERN)
    jax = jtok.Llama3Tokenizer(compressed, special_tokens=tok.special_tokens, pattern=jtok.CL100K_PATTERN)
    for line in corpus[:8]:
        ids_pua = tok.encode(line, add_bos=False, add_eos=False)
        ids_comp = comp.encode(line, add_bos=False, add_eos=False)
        assert len(ids_pua) >= len(line)  # tiny base has no 3-byte DSU tokens
        assert len(ids_comp) < len(line)
        assert comp.decode(ids_comp, truncate_at_eos=False, skip_special_tokens=False) == line
        assert all(i < comp.base_vocab_size for i in ids_comp)
        assert ids_comp == jax.encode(line, add_bos=False, add_eos=False)
