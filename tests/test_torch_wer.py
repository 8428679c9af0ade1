"""The port's WER layer (``ssi_tpu_torch/eval``, ``cli/wer.py``,
``cli/wer_parity.py``) against the JAX package's (``ssi_tpu/eval``,
``scripts/wer.py``, ``scripts/wer_parity.py``) on the CPU: the twins of
``tests/test_wer.py``'s contracts, the vendored normalizer held to the
``transformers`` original, equal WERs and normalized strings on
hypothesis-generated text, and equal artifacts from both CLIs."""

import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

import ssi_tpu.eval as jeval
import ssi_tpu.eval.wer as jwer
import ssi_tpu_torch.eval as peval
import ssi_tpu_torch.eval.whisper_normalizer as pnorm
import ssi_tpu_torch.eval.wer as pwer

REPO = Path(__file__).resolve().parent.parent
_SETTINGS = dict(deadline=None, suppress_health_check=list(HealthCheck), derandomize=True)


def _load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def normalizers():
    return peval.english_normalizer(), jeval.english_normalizer()


# --- the copies ------------------------------------------------------------------------------


def test_spelling_map_is_a_byte_copy_with_the_drive_fingerprint():
    src = REPO / "ssi_tpu" / "eval" / "english_spelling.json"
    assert (REPO / "ssi_tpu_torch" / "eval" / "english_spelling.json").read_bytes() == src.read_bytes()
    assert peval.load_spelling_mapping() == jeval.load_spelling_mapping()
    fp = pwer.spelling_mapping_fingerprint()
    assert fp == jwer.spelling_mapping_fingerprint()
    record = json.loads((REPO / "artifacts" / "wer_drive" / "summary.json").read_text())
    assert fp == {"spelling_map_entries": record["spelling_map_entries"],
                  "spelling_map_sha256": record["spelling_map_sha256"]} == \
        {"spelling_map_entries": 2017, "spelling_map_sha256": record["spelling_map_sha256"]}
    assert fp["spelling_map_sha256"].startswith("4e2c3d99")


@pytest.mark.parametrize("name", ["ADDITIONAL_DIACRITICS", "remove_symbols_and_diacritics", "remove_symbols",
                                  "EnglishNumberNormalizer", "EnglishSpellingNormalizer", "EnglishTextNormalizer"])
def test_vendored_normalizer_equals_the_transformers_original(name):
    """Each kept piece of Whisper's normalizer is the ``transformers`` source,
    unchanged; the copy needs neither ``transformers`` nor ``regex``."""
    import transformers.models.whisper.english_normalizer as original

    ours, theirs = getattr(pnorm, name), getattr(original, name)
    if isinstance(theirs, dict):
        assert ours == theirs
    else:
        assert inspect.getsource(ours) == inspect.getsource(theirs)
    source = (REPO / "ssi_tpu_torch" / "eval" / "whisper_normalizer.py").read_text()
    assert "import regex" not in source and "transformers" not in source.split('"""')[2]
    assert not hasattr(pnorm, "BasicTextNormalizer")


@pytest.mark.parametrize("name", ["_edit_distance", "word_error_rate", "load_spelling_mapping",
                                  "spelling_mapping_fingerprint", "suspected_unmapped_words"])
def test_wer_functions_are_copies(name):
    assert inspect.getsource(getattr(pwer, name)) == inspect.getsource(getattr(jwer, name))


def test_british_classes_equal():
    assert [(n, p.pattern, e) for n, p, e in pwer._BRITISH_CLASSES] == \
        [(n, p.pattern, e) for n, p, e in jwer._BRITISH_CLASSES]


# --- twins of tests/test_wer.py ---------------------------------------------------------------


def test_wer_exact_and_known_values():
    wer = peval.word_error_rate
    assert wer(["hello world"], ["hello world"]) == 0.0
    assert wer(["hello world"], ["hello there"]) == pytest.approx(0.5)
    assert wer(["a b c"], ["a c"]) == pytest.approx(1 / 3)
    assert wer(["a b"], ["a x b"]) == pytest.approx(0.5)
    assert wer(["a"], ["x y z"]) == pytest.approx(3.0)
    assert wer(["a b c d e f g h i j", "a"], ["a b c d e f g h i j", "x"]) == pytest.approx(1 / 11)
    assert wer(["a b c"], [""]) == pytest.approx(1.0)


def test_wer_validates_lengths():
    with pytest.raises(ValueError, match="Length mismatch"):
        peval.word_error_rate(["a"], ["a", "b"])
    with pytest.raises(ValueError, match="zero"):
        peval.word_error_rate([""], [""])


# frozen goldens of tests/test_wer.py (test_whisper_normalizer_canonicalizes,
# test_spelling_mapping_vendored, test_normalizer_adversarial_goldens,
# test_normalizer_class_boundary_goldens)
GOLDENS = [
    ("Hello, World!", "hello world"),
    ("I won't go", "i will not go"),
    ("Mr. Smith", "mister smith"),
    ("twenty one dollars", "$21"),
    ("The colour of the theatre was analysed.", "the color of the theater was analyzed"),
    ("My neighbour's behaviour was marvellous!", "my neighbor is behavior was marvelous"),
    ("He travelled to the centre to practise.", "he traveled to the center to practice"),
    ("A grey aluminium tyre on the kerb.", "a gray aluminum tire on the curb"),
    ("They organised a programme for the labourers.", "they organized a program for the laborers"),
    ("four hours on tour", "4 hours on tour"),
    ("this is ours", "this is ours"),
    ("one hundred and twenty three people", "123 people"),
    ("the third of March, nineteen eighty-four", "the 3rd of march 1984"),
    ("one million two hundred thirty four thousand five hundred sixty seven", "1234567"),
    ("two thousand and one", "2001"),
    ("1st 2nd 3rd 21st 102nd", "1st 2nd 3rd 21st 102nd"),
    ("twenty-first century, the 1970s, and the '90s", "21st century the 1970s and the 90s"),
    ("ninety-nine point nine percent", "99.9%"),
    ("minus five degrees, plus three", "-5 degrees +3"),
    ("seven eighths of an inch", "7 eighths of an inch"),
    ("It costs five dollars and fifty cents.", "it costs $5.50"),
    ("He paid £3.50 for two and a half kilos.", "he paid £3.50 for 2.5 kilos"),
    ("three pounds of flour", "£3 of flour"),
    ("Dr. Jones met Mrs. O'Brien at St. Mary's.", "doctor jones met missus 0 brien at saint mary is"),
    ("number one and No. 2", "number one and no 2"),
    ("I can't, shouldn't, and won't do it; they're gonna leave.",
     "i can not should not and will not do it they are going to leave"),
    ("He's got 'em, ain't he?", "he has got em aint he"),
    ("a half past ten o'clock", "a half past 100 clock"),
    ("double-decker bus re-enactment co-operate", "double decker bus re enactment co operate"),
    ("umm, uh, hmm, you know, like, actually", "umm you know like actually"),
    ("they recognise and advertise", "they recognize and advertise"),
    ("she apologised, he will exercise", "she apologized he will exercise"),
    ("paralysed while they analyse", "paralyzed while they analyze"),
    ("the labour of four hours", "the labor of 4 hours"),
    ("rumour has it our flour is sour", "rumor has it our flour is sour"),
    ("the theatre near the acre", "the theater near the acre"),
    ("a litre of lucre at the centre", "a liter of lucre at the center"),
    ("he travelled and was compelled", "he traveled and was compelled"),
    ("modelling while propelling", "modeling while propelling"),
    ("the defence of the licence", "the defense of the license"),
    ("a catalogue in vogue", "a catalog in vogue"),
    ("anaemia near the phoenix", "anemia near the phoenix"),
]


@pytest.mark.parametrize("raw, expected", GOLDENS, ids=[f"golden{i}" for i in range(len(GOLDENS))])
def test_normalizer_goldens_equal_jax(normalizers, raw, expected):
    port, jax = normalizers
    assert port(raw) == jax(raw) == expected


def test_normalizer_on_every_drive_word_equals_jax(normalizers):
    from ssi_tpu_torch.wer_drive import WORDS

    port, jax = normalizers
    for w in WORDS:
        assert port(w) == jax(w), w
    line = " ".join(WORDS)
    assert port(line) == jax(line)


def test_spelling_can_be_disabled_and_the_pipeline_scores_zero():
    assert peval.english_normalizer({})("colour") == "colour"
    normalize = peval.english_normalizer()
    assert peval.word_error_rate([normalize("Hello, World!")], [normalize("hello world")]) == 0.0


def test_suspected_unmapped_words_equal_jax():
    m = pwer.load_spelling_mapping()
    texts = ["he zzzourised the quxxtre twice while zzzising", "zzzourised gooelled rrhoea",
             "four hours on tour with flour and a promise to exercise surprise",
             "compelled spelling across the acre in vogue analyzing dwelling", " ".join(m.keys())]
    for t in texts:
        assert pwer.suspected_unmapped_words([t], m) == jwer.suspected_unmapped_words([t], m)
    assert pwer.suspected_unmapped_words(texts[:2], m)["zzzourised"] == 2


# --- hypothesis: the port equals the JAX package ------------------------------------------------

_WORD = st.sampled_from(["a", "b", "the", "cat", "sat", "x", "colour", "one", "two", ""])


@settings(max_examples=300, **_SETTINGS)
@given(st.lists(st.tuples(st.lists(_WORD, min_size=1, max_size=8), st.lists(_WORD, max_size=8)),
                min_size=1, max_size=6))
def test_word_error_rate_equals_jax(pairs):
    refs = [" ".join(r) for r, _ in pairs]
    hyps = [" ".join(h) for _, h in pairs]
    if sum(len(r.split()) for r in refs) == 0:
        with pytest.raises(ValueError):
            pwer.word_error_rate(refs, hyps)
        return
    assert pwer.word_error_rate(refs, hyps) == jwer.word_error_rate(refs, hyps)


_PIECES = st.sampled_from([
    "one", "two", "three", "twenty", "hundred", "thousand", "million", "and", "a", "half", "point", "oh",
    "first", "second", "twenty-first", "third", "fifth", "ninth", "twelfth", "1st", "22nd", "103rd",
    "$", "£", "€", "¢", "%", "dollars", "cents", "pounds", "euros", "percent", "minus", "plus",
    "1,000", "3.50", "1970s", "'90s", "$20", "£3.50", "7%", "0.5", "2nd",
    "colour", "theatre", "organise", "favourite", "centre", "behaviour", "honour", "analyse", "programme",
    "labour", "neighbour", "travelled", "marvellous", "grey", "tyre", "licence", "defence", "catalogue",
    "Mr.", "Mrs.", "Dr.", "St.", "won't", "can't", "it's", "they're", "I'd", "y'all", "gonna",
    "hmm", "uh", "umm", "[noise]", "(laughs)", "co-operate", "O'Brien", "café", "naïve", "Æsop",
    ",", ".", "!", "?", ";", "-", "  ", "\n", "the", "of", "people", "years",
])


@settings(max_examples=400, **_SETTINGS)
@given(st.lists(_PIECES, max_size=14), st.booleans())
def test_normalizer_equals_jax_on_generated_text(normalizers, pieces, spaced):
    """Numbers, currency, ordinals, abbreviations, contractions, British
    spellings, brackets and diacritics in any order: the same string."""
    port, jax = normalizers
    text = (" " if spaced else "").join(pieces)
    assert port(text) == jax(text)


@settings(max_examples=200, **_SETTINGS)
@given(st.text(max_size=40))
def test_normalizer_equals_jax_on_any_text(normalizers, text):
    port, jax = normalizers
    assert port(text) == jax(text)


# --- the CLIs ---------------------------------------------------------------------------------


def _generations(gen_dir: Path, texts: list[str]) -> None:
    gen_dir.mkdir(parents=True, exist_ok=True)
    with open(gen_dir / "generations.jsonl", "w") as f:
        for t in texts:
            f.write(json.dumps({"prompt": "p", "outputs": [{"text": t}]}) + "\n")


HYPS = ["the colour of the theatre was analysed", "he travelled to the centre", "twenty one dollars",
        "zzzourised the quxxtre"]
REFS = ["The color of the theater was analyzed.", "he traveled to the center", "$21 only", "the cat"]


def _run(script: list[str], args: list[str]) -> None:
    proc = subprocess.run([sys.executable, *script, *map(str, args)], capture_output=True, text=True, cwd=REPO,
                          env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]


@pytest.mark.parametrize("reference_wer", [None, 0.05, 0.9], ids=["no-reference", "within", "exceeds"])
def test_wer_parity_json_equals_the_jax_scripts(tmp_path, reference_wer):
    """``python -m ssi_tpu_torch.cli.wer_parity --skip-generate --refs-jsonl``
    writes the ``wer_parity.json`` that ``scripts/wer_parity.py`` writes on the
    same generations (the same path, so the reference command matches too)."""
    gen_dir = tmp_path / "mls-hubert" / "dev"
    _generations(gen_dir, HYPS)
    refs = tmp_path / "refs.jsonl"
    refs.write_text("".join(json.dumps({"transcript": r}) + "\n" for r in REFS[:3]) + REFS[3] + "\n\n")
    args = ["--skip-generate", gen_dir, "--refs-jsonl", refs]
    if reference_wer is not None:
        (tmp_path / "wer.json").write_text(json.dumps({"wer": reference_wer}))
        args += ["--reference-wer", tmp_path / "wer.json"]
    _run([str(REPO / "scripts" / "wer_parity.py")], args)
    want = (gen_dir / "wer_parity.json").read_text()
    (gen_dir / "wer_parity.json").unlink()
    _run(["-m", "ssi_tpu_torch.cli.wer_parity"], args)
    got = (gen_dir / "wer_parity.json").read_text()
    assert got == want
    art = json.loads(got)
    assert art["dataset"] == "mls-hubert" and art["split"] == "dev" and art["n_samples"] == 4
    assert 0 < art["wer"] < 1 and art["suspected_unmapped_words"] > 0


def test_wer_parity_without_refs_raises_naming_a12(tmp_path):
    from ssi_tpu_torch.cli.wer_parity import main

    gen_dir = tmp_path / "mls-hubert" / "dev"
    _generations(gen_dir, HYPS)
    with pytest.raises(NotImplementedError, match="A12"):
        main(["--skip-generate", str(gen_dir)])
    assert not (gen_dir / "wer_parity.json").exists()


def _jax_args(module, argv: list[str], monkeypatch):
    """``scripts/wer.py`` parses ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", ["wer.py", *argv])
    return module.parse_args()


@pytest.fixture()
def jax_wer_script():
    return _load_module("scripts_wer_for_tests", REPO / "scripts" / "wer.py")


@pytest.mark.parametrize("normalizer", ["whisper", "none"])
def test_wer_cli_writes_the_jax_wer_json(tmp_path, monkeypatch, jax_wer_script, normalizer):
    """``python -m ssi_tpu_torch.cli.wer`` and ``scripts/wer.py`` on the same
    generations and (local, patched-in) references write the same wer.json;
    the path inference is the JAX script's; a second run refuses to overwrite."""
    import ssi_tpu_torch.cli.wer as pcli

    gen = tmp_path / "mls-hubert_large" / "test" / "abc1234" / "generations.jsonl"
    _generations(gen.parent, HYPS)
    fetched = []

    def refs(dataset, split, col="transcript"):
        fetched.append((dataset, split, col))
        return list(REFS)

    monkeypatch.setattr(jax_wer_script, "ref_from_hf_dataset", refs)
    monkeypatch.setattr(pcli, "ref_from_hf_dataset", refs)
    jax_wer_script.main(_jax_args(jax_wer_script, [str(gen), "--normalizer", normalizer], monkeypatch))
    want = (gen.parent / "wer.json").read_text()
    (gen.parent / "wer.json").unlink()
    pcli.main(pcli.parse_args([str(gen), "--normalizer", normalizer]))
    assert (gen.parent / "wer.json").read_text() == want
    assert fetched[0] == fetched[1] == ("mls-hubert_large", "test", "transcript")
    with pytest.raises(FileExistsError, match="Refusing to overwrite"):
        pcli.main(pcli.parse_args([str(gen)]))


@pytest.mark.parametrize("path", ["mls-x/dev/generations.jsonl", "mls-x/test/h1/generations.jsonl",
                                  "unknown/test/generations.jsonl", "json/validation/generations.jsonl"])
def test_wer_cli_infers_dataset_and_split_as_jax(tmp_path, jax_wer_script, monkeypatch, path):
    import ssi_tpu_torch.cli.wer as pcli

    results = []
    for parse, infer in ((lambda a: _jax_args(jax_wer_script, a, monkeypatch), jax_wer_script._infer_dataset_and_split),
                         (pcli.parse_args, pcli._infer_dataset_and_split)):
        args = parse([str(tmp_path / path)])
        try:
            infer(args)
            results.append((args.dataset, args.split))
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]


def test_wer_cli_hub_read_raises_naming_a12(tmp_path):
    from ssi_tpu_torch.cli.wer import main, parse_args
    from ssi_tpu_torch.utils import ref_from_hf_dataset

    with pytest.raises(NotImplementedError, match="A12"):
        ref_from_hf_dataset("mls-hubert_large", "test")
    gen = tmp_path / "mls-hubert_large" / "test" / "generations.jsonl"
    _generations(gen.parent, HYPS)
    with pytest.raises(NotImplementedError, match="A12"):
        main(parse_args([str(gen)]))
    assert not (gen.parent / "wer.json").exists()
