"""The port's config system (``ssi_tpu_torch.config`` and its first-party YAML
reader and writer) against the JAX package's (pyyaml): every file of
``conf/``, override texts, ``compose`` of the entry configs with the WER
drive's overrides, and ``to_yaml`` / ``hash_cfg`` byte for byte, on the
composed configs and on generated trees that hold the emitter's traps."""

import math
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings, strategies as st

import ssi_tpu.config as jcfg
import ssi_tpu.constants as jconst
import ssi_tpu.utils as jutils
import ssi_tpu_torch.config as pcfg
import ssi_tpu_torch.constants as pconst
import ssi_tpu_torch.utils as putils
from ssi_tpu_torch.config import yaml_subset

REPO = Path(__file__).resolve().parent.parent
CONF_FILES = sorted((REPO / "conf").rglob("*.yaml"))

# the overrides tools/wer_drive.py passes to train_sft and generate (json data files)
DRIVE = [
    "model_config=llama3_2_100m", "base_model_name=Llama-3.2-100M",
    "data=sft/mls-hubert_large_ll60k-layer_22",
    "data.train.dataset.source=json", "+data.train.dataset.data_files=/data/train.jsonl",
    "data.train.dataset.split=train",
    "data.dev.dataset.source=json", "+data.dev.dataset.data_files=/data/dev.jsonl", "data.dev.dataset.split=train",
]
COMPOSE_CASES = {
    "generate": DRIVE + [
        "model=/x/experiments/run/checkpoints/step_0", "data.test.dataset.source=json",
        "+data.test.dataset.data_files=/data/test.jsonl", "data.test.dataset.split=train", "gen.split=test",
        "gen.output_dir=/x/gen_bf16", "batch_size=48", "quantize_weights=null", "observability=true",
        "speech.n_dsus=5000", "sampling_params.max_tokens=128", "+device=cpu",
    ],
    "sft": DRIVE + [
        "data.train.dataloader.batch_size=8", "gradient_accumulation_steps=1", "tokenizer.max_seq_len=2048",
        "optimizer.lr=3e-4", "lr_scheduler.num_warmup_steps=100", "max_steps=1000", "eval_steps=500",
        "save_steps=1000", "log_interval=20", "clip_grad_norm=1.0", "wandb.enabled=false",
        "loss_chunk_size=3072", "speech.n_dsus=5000",
    ],
    "cpt": ["data=cpt/mls-hubert_large_ll60k-layer_22", "speech.n_dsus=5000", "optimizer.betas=[0.9, 0.95]",
            "hydra/job_logging=none"],
    "serve": ["model=/x/step_0", "speech.n_dsus=5000", "server.port=8731", "tokenizer.path=/x/t.model",
              "prefill_chunk=null", "server.sampling_features=''"],
}


def test_constants_and_utils_copies_equal():
    for name in ("SUPPORTED_DATASETS", "HF_OWNER", "LLAMA_3_2_CONFIG_RELPATH", "TRAIN_CONFIG_FILENAME",
                 "CROSS_ENTROPY_IGNORE_IDX", "RESERVED_BATCH_KEYS"):
        assert getattr(pconst, name) == getattr(jconst, name), name


def test_every_conf_file_reads_as_pyyaml_reads_it():
    assert len(CONF_FILES) == 19
    for path in CONF_FILES:
        text = path.read_text()
        assert yaml_subset.load(text) == jcfg._yaml_load(text), path
        assert pcfg.load_yaml(path) == jcfg.load_yaml(path), path


@pytest.mark.parametrize("text", [
    "1", "-7", "0.5", "2e-4", "1e-3", "-1.5E+3", "1_000", "012", "0x1F", "0b101", "1:30", ".inf", "-.inf",
    "null", "~", "Null", "true", "False", "yes", "off", "???", "${a.b}", "'quoted'", '"dq\\tesc\\u00e9"',
    "'it''s'", "[1, 2]", "[a, 'b', [c, {d: 1}]]", "{a: 1, b: [x, y]}", "{}", "[]", "2001-12-14",
    "/path/to/step_0", "sft/mls-hubert_large_ll60k-layer_22", "a b c", "x: 1", "- a\n- b", "# just a comment",
    "${oc.env:HOME,/tmp}/x", "'a\n  b\n\n  c'", "plain\n  folded\n\n  lines",
])
def test_override_texts_read_as_pyyaml_reads_them(text):
    a, b = yaml_subset.load(text), jcfg._yaml_load(text)
    assert type(a) is type(b)
    assert a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))
    assert pcfg._parse_override_value(text) == jcfg._parse_override_value(text)


@pytest.mark.parametrize("name", sorted(COMPOSE_CASES))
def test_compose_to_yaml_and_hash_equal_jax(name):
    overrides = COMPOSE_CASES[name]
    p = pcfg.compose(REPO / "conf", name, overrides=overrides)
    j = jcfg.compose(REPO / "conf", name, overrides=overrides)
    assert p._data == j._data
    assert pcfg.missing_keys(p) == jcfg.missing_keys(j)
    for resolve in (False, True):
        assert pcfg.to_container(p, resolve=resolve) == jcfg.to_container(j, resolve=resolve)
        for sort_keys in (False, True):
            assert pcfg.to_yaml(p, resolve=resolve, sort_keys=sort_keys) == \
                jcfg.to_yaml(j, resolve=resolve, sort_keys=sort_keys)
    assert putils.hash_cfg(p) == jutils.hash_cfg(j)
    # the long system prompt folds onto two lines, as pyyaml writes it
    if name in ("generate", "sft"):
        assert "  Transcribe the speech tokens into English text. '\n" in pcfg.to_yaml(p)


def test_snapshot_reads_back_to_the_resolved_config(tmp_path):
    cfg = pcfg.compose(REPO / "conf", "generate", overrides=COMPOSE_CASES["generate"])
    pcfg.save(cfg, tmp_path / "snap.yaml")
    assert pcfg.load_yaml(tmp_path / "snap.yaml") == pcfg.to_container(cfg, resolve=True)
    assert (tmp_path / "snap.yaml").read_text() == jcfg.to_yaml(jcfg.Config(pcfg.to_container(cfg)))


@pytest.mark.parametrize("group", ["job_logging", "hydra_logging"])
def test_logging_config_read_as_jax_reads_it(tmp_path, monkeypatch, group):
    """The job and hydra logging YAML reaches ``dictConfig`` as the JAX
    package hands it over (placeholders substituted, colorlog degraded)."""
    import logging.config

    import ssi_tpu.train.metric_logging as jml
    import ssi_tpu_torch.train.metric_logging as pml

    seen = []
    monkeypatch.setattr(logging.config, "dictConfig", seen.append)
    path = REPO / "conf" / "hydra" / group / "custom.yaml"
    subs = {"${hydra.runtime.output_dir}": str(tmp_path), "${hydra.job.name}": "generate"}
    pml._dict_config_from_yaml(path, subs)
    jml._dict_config_from_yaml(path, subs)
    assert len(seen) == 2 and seen[0] == seen[1]
    cfg = pcfg.compose(REPO / "conf", "generate", overrides=["model=x"])
    pml.configure_hydra_logging(cfg)
    pml.configure_job_logging(cfg, tmp_path / "run", job_name="generate")
    assert seen[-1]["handlers"]["file"]["filename"] == str(tmp_path / "run" / "generate.log")
    pml.attach_run_file_logging(tmp_path / "plain")  # the composer-less fallback
    root = logging.getLogger()
    added = [h for h in root.handlers if getattr(h, "baseFilename", "") == str(tmp_path / "plain" / "train.log")]
    assert len(added) == 1
    root.removeHandler(added[0])
    added[0].close()


def test_emitter_traps_written_as_pyyaml_writes_them():
    tree = {"a": "null", "b": "", "c": "1e-3", "d": "???", "e": "${x.y}", "f": 0.0002, "g": 1e-05, "h": {},
            "i": [], "j": ["x", {"k": [1, None, True]}], "long": "word " * 30, "k": -0.0, "l": 1e16}
    for sort_keys in (False, True):
        expected = yaml.safe_dump(tree, sort_keys=sort_keys, allow_unicode=True)
        assert yaml_subset.dump(tree, sort_keys=sort_keys) == expected
    text = yaml_subset.dump(tree)
    assert "a: 'null'\nb: ''\nc: 1e-3\nd: ???\ne: ${x.y}\nf: 0.0002\ng: 1.0e-05\nh: {}\ni: []\n" in text
    assert "\nj:\n- x\n- k:\n  - 1\n" in text


_TRAPS = st.sampled_from([
    "null", "", "1e-3", "???", "${x.y}", "yes", "No", "123", "0.5", "- a", "a: b", "#c", "a #b", " lead", "trail ",
    "x\ny", "it's", 'say "hi"', "tab\there", "\U000ffffc", "2001-12-14", "~", "-", ":", "?x", "[a]", "{b}", "a  b",
    "a\n\nb", "x\\y", "é", "---", "0x1F", "012", "1:30", ".inf", "+1", "x" * 130, "word " * 40,
    "You will act as an automatic speech recognition (ASR) system. Transcribe the speech tokens into English text. ",
])
_TEXT = st.one_of(_TRAPS, st.text(max_size=40),
                  st.text(alphabet=st.sampled_from(list("ab :#-'\"\n\\ \t?,[]{}xé")), max_size=200))
_SCALARS = st.one_of(st.none(), st.booleans(), st.integers(-10**20, 10**20), st.floats(allow_nan=False), _TEXT)
_KEYS = st.one_of(st.text(max_size=20), _TRAPS, st.integers(-5, 5))
_TREES = st.recursive(_SCALARS, lambda ch: st.one_of(st.lists(ch, max_size=4), st.dictionaries(_KEYS, ch, max_size=4)),
                      max_leaves=20)


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck), derandomize=True)
@given(st.dictionaries(_KEYS, _TREES, max_size=5), st.booleans())
def test_generated_trees_dump_and_read_as_pyyaml(tree, sort_keys):
    try:
        expected = yaml.safe_dump(tree, sort_keys=sort_keys, allow_unicode=True)
    except yaml.YAMLError:
        return  # not representable by pyyaml either
    assert yaml_subset.dump(tree, sort_keys=sort_keys) == expected
    assert repr(yaml_subset.load(expected)) == repr(jcfg._yaml_load(expected))
    if all(isinstance(k, str) for k in tree):
        assert _outcome(putils.hash_cfg, tree) == _outcome(jutils.hash_cfg, tree)


def _outcome(fn, *args):
    """``fn``'s result, or the name of the error it raises (an unresolvable
    ``${...}`` must fail alike in both packages)."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - compared by name across the two packages
        return type(e).__name__
