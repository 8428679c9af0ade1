"""The port's prompt templates (``ssi_tpu_torch/templates``,
``ssi_tpu_torch/generate/templates.py``) and its standalone generation CLI
(``python -m ssi_tpu_torch.cli.generate_sample``) against the JAX package's
(``ssi_tpu/generate/templates.py`` with jinja2, ``scripts/generate_sample.py``).

Held: the seven templates byte-equal; ``render_template`` equal to the JAX
one for every template, with and without deduplication, and raising for an
undefined variable with jinja2's message; a path template with other Jinja
syntax rendered by jinja2, or refused when jinja2 cannot be imported, never
rendered wrongly; ``generate_sample`` records equal to the JAX script's on
``make_tiny_hf_checkpoint`` (f32, greedy; ``cumulative_logprob`` within
1e-5 relative) for text, token-id and template prompts.
"""

import importlib.util
import json
import logging
from pathlib import Path
import sys

import jinja2
import pytest
import torch

from ssi_tpu.generate import templates as jtemplates
from ssi_tpu_torch.generate import templates as ptemplates
from tests import helpers

REPO = Path(__file__).resolve().parent.parent
SPEECH = [3, 3, 7, 1, 1, 1, 15, 0, 7]


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


def test_templates_are_byte_equal_copies():
    jax_dir = REPO / "ssi_tpu" / "templates"
    assert ptemplates.list_templates() == jtemplates.list_templates()
    assert len(ptemplates.list_templates()) == 7
    for name in jtemplates.list_templates():
        assert (ptemplates.TEMPLATES_DIR / f"{name}.jinja").read_bytes() == (jax_dir / f"{name}.jinja").read_bytes()


@pytest.mark.parametrize("name", sorted(p.stem for p in (REPO / "ssi_tpu" / "templates").glob("*.jinja")))
def test_render_template_equals_jax(name, monkeypatch):
    """Each template with speech tokens (deduplicated and not) and an unused
    extra variable, and without speech tokens: the same text as jinja2, or
    the same undefined-variable error; the port never imports jinja2 for
    them."""
    want = {}
    for kw in ({"speech_tokens": SPEECH}, {"speech_tokens": SPEECH, "deduplicate": True},
               {"speech_tokens": [], "extra": 5}, {}):
        try:
            want[json.dumps(kw)] = ("ok", jtemplates.render_template(name, **kw))
        except jinja2.exceptions.UndefinedError as e:
            want[json.dumps(kw)] = ("undefined", str(e))
    monkeypatch.setitem(sys.modules, "jinja2", None)  # an import of jinja2 would raise
    for key, (kind, value) in want.items():
        kw = json.loads(key)
        if kind == "ok":
            assert ptemplates.render_template(name, **kw) == value
        else:
            with pytest.raises(ptemplates.UndefinedError) as err:
                ptemplates.render_template(name, **kw)
            assert str(err.value) == value == "'speech_tokens' is undefined"
    if name == "repeat_this_modality_switch":
        from ssi_tpu_torch.speech import MODALITY_TOKEN_SPEECH, MODALITY_TOKEN_TEXT, dsu2pua

        assert ptemplates.render_template(name, speech_tokens=[1, 1, 2], deduplicate=True) == \
            f"Repeat the following: {MODALITY_TOKEN_SPEECH}{dsu2pua(1)}{dsu2pua(2)}{MODALITY_TOKEN_TEXT}\n"


@pytest.mark.parametrize("source", [
    "Say {{ word }} then {{word}} and {{   MODALITY_TOKEN_TEXT}}.\n\n",
    "no variables at all, } { }} {",
])
def test_path_templates_with_substitution_only_render_without_jinja2(tmp_path, monkeypatch, source):
    path = tmp_path / "t.jinja"
    path.write_text(source)
    want = jtemplates.render_template(path, word="hi")
    monkeypatch.setitem(sys.modules, "jinja2", None)
    assert ptemplates.render_template(path, word="hi") == want
    if "word" in source:
        with pytest.raises(ptemplates.UndefinedError, match="^'word' is undefined$"):
            ptemplates.render_template(path)


@pytest.mark.parametrize("source", [
    "{% for t in items %}{{ t }},{% endfor %}\n",
    "{{ word | upper }} {# a comment #}",
    "{{ items[0] }}{{ word ~ 'x' }}",
])
def test_other_jinja_syntax_goes_to_jinja2_or_is_refused(tmp_path, monkeypatch, source):
    path = tmp_path / "t.jinja"
    path.write_text(source)
    kw = {"word": "hi", "items": ["a", "b"]}
    assert ptemplates.render_template(path, **kw) == jtemplates.render_template(path, **kw)
    monkeypatch.setitem(sys.modules, "jinja2", None)
    with pytest.raises(NotImplementedError, match="other than .* substitution.* jinja2 is not installed"):
        ptemplates.render_template(path, **kw)


def test_unknown_template_raises_file_not_found():
    with pytest.raises(FileNotFoundError, match="Template not found"):
        ptemplates.render_template("no_such_template")


# --- the CLI ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location("generate_sample_script", REPO / "scripts" / "generate_sample.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return helpers.make_tiny_hf_checkpoint(tmp_path_factory.mktemp("sample") / "step_0")


COMMON = ["--n_dsus", str(helpers.TINY_N_DSUS), "--model_config", "tiny_test", "--dtype", "fp32",
          "--max_tokens", "8"]


@pytest.mark.parametrize("prompt", [
    ["--text", "The capital of France is"],
    ["--token_ids", "5", "17", "42", "99", "3"],
    ["--template", "repeat_this_modality_switch", "--speech_tokens", "3", "3", "7", "1", "--deduplicate"],
    ["--template", "basic", "--speech_tokens", "1", "2", "3", "--repetition_penalty", "1.3"],
    ["--template", "capital_of_france_text_modality_token", "--var", "unused=1"],
])
def test_generate_sample_records_equal_jax(jax_script, model_dir, tmp_path, prompt, capsys):
    """The same arguments through the JAX script's ``main`` and the port's
    (``--device cpu``): the same record, appended to ``--jsonl_out``."""
    argv = ["--model", str(model_dir), *COMMON, *prompt]
    saved = sys.argv
    try:
        sys.argv = ["generate_sample.py", *argv, "--jsonl_out", str(tmp_path / "jax.jsonl")]
        jax_script.main(jax_script.parse_args())
    finally:
        sys.argv = saved
    from ssi_tpu_torch.cli.generate_sample import main, parse_args

    record = main(parse_args([*argv, "--jsonl_out", str(tmp_path / "port.jsonl"), "--device", "cpu"]))
    j = json.loads((tmp_path / "jax.jsonl").read_text())
    p = json.loads((tmp_path / "port.jsonl").read_text())
    assert p == json.loads(json.dumps(record, ensure_ascii=False))
    assert list(p) == list(j) and list(p["outputs"][0]) == list(j["outputs"][0])
    lp, lj = p["outputs"][0].pop("cumulative_logprob"), j["outputs"][0].pop("cumulative_logprob")
    assert abs(lp - lj) <= 1e-5 * abs(lj)
    assert p == j
    assert p["finished"] is True and p["outputs"][0]["token_ids"]
    assert p["outputs"][0]["text"] + "\n" in capsys.readouterr().out  # both print the text


@pytest.mark.parametrize("pattern", [r"\S+|\s+", r"[^\s]{1,3}|\s"])
def test_generate_sample_with_a_raw_split_regex_equals_jax(jax_script, model_dir, tmp_path, pattern, capsys):
    """A raw split regex as ``--pattern`` (the PUA contract and cl100k are
    the named ones): the port splits by it through the ``regex`` package, as
    the JAX script's tokenizer does, and writes the same record."""
    argv = ["--model", str(model_dir), *COMMON, "--text", "The capital of France is", "--pattern", pattern]
    saved = sys.argv
    try:
        sys.argv = ["generate_sample.py", *argv, "--jsonl_out", str(tmp_path / "jax.jsonl")]
        jax_script.main(jax_script.parse_args())
    finally:
        sys.argv = saved
    from ssi_tpu_torch.cli.generate_sample import main, parse_args

    main(parse_args([*argv, "--jsonl_out", str(tmp_path / "port.jsonl"), "--device", "cpu"]))
    j = json.loads((tmp_path / "jax.jsonl").read_text())
    p = json.loads((tmp_path / "port.jsonl").read_text())
    lp, lj = p["outputs"][0].pop("cumulative_logprob"), j["outputs"][0].pop("cumulative_logprob")
    assert abs(lp - lj) <= 1e-5 * abs(lj)
    assert p == j and p["prompt_token_ids"] and p["outputs"][0]["token_ids"]
    capsys.readouterr()


def test_generate_sample_refusals(model_dir, monkeypatch):
    """A split regex other than the two cl100k patterns needs the ``regex``
    package, refused by name when it is missing; no card and no ``--device
    cpu`` refuses before any work; one prompt mode at a time."""
    from ssi_tpu_torch.cli.generate_sample import generate_sample

    with monkeypatch.context() as m:
        m.setitem(sys.modules, "regex", None)
        with pytest.raises(ImportError, match="'regex'"):
            generate_sample(model_dir, helpers.TINY_N_DSUS, text="hi", model_config="tiny_test",
                            pattern=r"\S+|\s+", device="cpu")
    with pytest.raises(ValueError, match="^Provide exactly one of: text, token_ids, template$"):
        generate_sample(model_dir, helpers.TINY_N_DSUS, text="hi", token_ids=[1], model_config="tiny_test",
                        device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        generate_sample(model_dir, helpers.TINY_N_DSUS, text="hi", model_config="tiny_test")
