"""The port's dataset loading (JSON lines, no ``datasets``) and ``SFTDataset``
against the JAX package's: the JAX side gets its rows from the
``synthetic_data`` fixture, the port reads the same rows from a JSON-lines
file, and every sample (tokens, mask, labels) must be equal."""

import json

import pytest

import ssi_tpu.tokenizer as jtok
import ssi_tpu_torch.tokenizer as ptok
from ssi_tpu.data.sft import SFTDataset as JaxSFTDataset
from ssi_tpu_torch.data import load_dataset_subset, load_hf_dataset
from ssi_tpu_torch.data.sft import SFTDataset

SYSTEM_PROMPT = "You will act as an automatic speech recognition (ASR) system. "


def _write_jsonl(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return path


def _kwargs(**over):
    kw = dict(deduplicate=True, use_modality_tokens=True, train_on_input=False, inference=False,
              column_map={"input": "speech_tokens", "output": "transcript"}, new_system_prompt=SYSTEM_PROMPT,
              filter_fn=None, n_samples=None)
    kw.update(over)
    return kw


def _short(row) -> bool:
    return len(row["speech_tokens"]) < 40


@pytest.mark.parametrize("case", ["train", "inference", "train_on_input", "n_samples", "filter", "n_samples_filter",
                                  "no_modality_no_dedupe"])
def test_sft_samples_equal_jax(tmp_path, synthetic_data, tiny_extended_tokenizer_path, case):
    over = {
        "train": {},
        "inference": {"inference": True},
        "train_on_input": {"train_on_input": True, "new_system_prompt": None},
        "n_samples": {"n_samples": 5},
        "filter": {"filter_fn": _short},
        "n_samples_filter": {"n_samples": 5, "filter_fn": _short},
        "no_modality_no_dedupe": {"use_modality_tokens": False, "deduplicate": False},
    }[case]
    split = _write_jsonl(tmp_path / "sft.jsonl", synthetic_data["sft"])
    port_tok, _ = ptok.setup_llama3_tokenizer(tiny_extended_tokenizer_path, verbose=False)
    jax_tok, _ = jtok.setup_llama3_tokenizer(tiny_extended_tokenizer_path, verbose=False)
    port = SFTDataset(source="json", data_files=str(split), split="train", model_tokenizer=port_tok,
                      additional_keys=["ID"], **_kwargs(**over))
    jax = JaxSFTDataset(source="synthetic/sft", split="train", model_tokenizer=jax_tok, additional_keys=["ID"],
                        **_kwargs(**over))
    assert len(port) == len(jax) > 0
    for i in range(len(jax)):
        p, j = port[i], jax[i]
        assert list(p) == list(j)
        assert p == j, i
    if case in ("n_samples", "n_samples_filter"):
        assert len(port) == 5
    if "filter" in case:
        assert all(len(port._data[i]["speech_tokens"]) < 40 for i in range(len(port)))


def test_json_split_forms(tmp_path):
    a = _write_jsonl(tmp_path / "a.jsonl", [{"x": 1}, {"x": 2, "y": "b"}])
    b = _write_jsonl(tmp_path / "b.jsonl", [{"y": "c"}])
    rows = [{"x": 1, "y": None}, {"x": 2, "y": "b"}, {"x": None, "y": "c"}]
    assert load_hf_dataset("json", data_files=str(a), split="train") == rows[:2]
    assert load_hf_dataset("json", data_files=[str(a), str(b)], split="train") == rows
    assert load_hf_dataset("json", data_files={"test": [str(a)], "train": str(b)}, split="test") == rows[:2]
    assert load_hf_dataset("json", data_files={"test": [str(a)], "train": str(b)}, split="train") == [{"y": "c"}]
    assert load_dataset_subset("json", 1, filter_fn=lambda r: r["x"] == 2, data_files=str(a), split="train") == \
        [{"x": 2, "y": "b"}]
    with pytest.raises(ValueError, match="Unknown split"):
        load_hf_dataset("json", data_files=str(a), split="test")
    with pytest.raises(FileNotFoundError):
        load_hf_dataset("json", data_files=str(tmp_path / "absent.jsonl"), split="train")
    with pytest.raises(ValueError, match="split"):
        load_dataset_subset("json", 1, data_files=str(a))


def test_other_sources_raise_naming_their_item(tmp_path):
    """Hub ids and the text source stay refused (A12); csv and parquet are read
    (``tests/test_torch_data_sources.py``)."""
    with pytest.raises(NotImplementedError, match="A12"):
        load_hf_dataset("anilkeshwani/mls-hubert_large_ll60k-layer_22", split="test")
    with pytest.raises(NotImplementedError, match="A12"):
        load_dataset_subset("text", 3, data_files=str(tmp_path / "x.txt"), split="train")


def test_reserved_keys_rejected(tmp_path, tiny_extended_tokenizer_path):
    split = _write_jsonl(tmp_path / "bad.jsonl", [{"speech_tokens": [1], "transcript": "a", "labels": [0]}])
    tok, _ = ptok.setup_llama3_tokenizer(tiny_extended_tokenizer_path, verbose=False)
    with pytest.raises(ValueError, match="reserved keys"):
        SFTDataset(source="json", data_files=str(split), split="train", model_tokenizer=tok, **_kwargs())
