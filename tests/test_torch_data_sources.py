"""The port's local dataset sources (``ssi_tpu_torch/data/sources.py``) and
Alpaca loader against the JAX package's ``load_hf_dataset`` /
``load_dataset_subset`` / ``setup_alpaca_data``, which hand the source to
``datasets.load_dataset`` (run offline, its cache under ``tmp_path``).

Held: rows equal with their Python types (``True`` is not ``1``, ``1.0`` is
not ``1``), in order, for parquet shards with several row groups and nulls,
for csv under each inference rule of ``datasets``' pandas reader (a case
each), and for the directory layouts of a downloaded HF dataset repo
(``data/<split>-*`` shards, ``<split>/`` directories, split keywords in file
names with ``dev`` -> ``validation``, a README ``configs:`` block);
``load_dataset_subset`` with ``n_samples`` and ``filter_fn``; the copied
split patterns and NA words equal to the originals; Alpaca samples and
batches bitwise; the SFT and CPT CLIs on a parquet directory bitwise their
own JSON-lines runs; the refusals.
"""

import json
import logging
from pathlib import Path
import random
import sys

import numpy as np
import pytest
import torch

import ssi_tpu.data as jdata
import ssi_tpu.tokenizer as jtok
import ssi_tpu_torch.data as pdata
from ssi_tpu_torch.data import sources
import ssi_tpu_torch.tokenizer as ptok
from tests import helpers


@pytest.fixture(autouse=True)
def offline_datasets(tmp_path, monkeypatch):
    """``datasets`` offline, with its cache in this test's directory (xdist runs workers side by side)."""
    import datasets

    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE", tmp_path / "hf_cache")
    monkeypatch.setattr(datasets.config, "HF_HUB_OFFLINE", True)
    datasets.disable_progress_bars()
    monkeypatch.chdir(tmp_path)


def tagged(x):
    """``x`` with the type of every value beside it, so ``True`` != ``1`` and ``1.0`` != ``1``."""
    if isinstance(x, dict):
        return [(k, tagged(v)) for k, v in x.items()]
    if isinstance(x, list):
        return ["list", [tagged(v) for v in x]]
    return (type(x).__name__, x)


def jax_rows(source, **kwargs) -> list:
    return [dict(r) for r in jdata.load_hf_dataset(source, **kwargs)]


def assert_rows_equal(port, jax):
    assert tagged(list(port)) == tagged(list(jax))


# --------------------------------------------------------------------------------
# parquet
# --------------------------------------------------------------------------------


def mls_rows(n: int, seed: int) -> list[dict]:
    """MLS-shaped rows: speech tokens, word-level alignments, a transcript and an ID; some nulls."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        n_words = int(rng.integers(1, 6))
        ends = np.cumsum(rng.uniform(0.2, 0.6, n_words))
        rows.append({
            "ID": f"mls_{seed}_{i}",
            "speech_tokens": rng.integers(0, 5000, int(rng.integers(0, 40))).tolist(),
            "transcript": None if i % 7 == 3 else " ".join(f"w{j}" for j in rng.integers(0, 50, n_words)),
            "tokenized": [f"w{j}" for j in rng.integers(0, 50, n_words)],
            "align_t_starts": np.concatenate([[0.0], ends[:-1]]).tolist(),
            "align_t_ends": ends.tolist(),
            "n_frames": None if i % 5 == 1 else int(rng.integers(0, 1000)),
        })
    return rows


def write_parquet(path: Path, rows: list[dict], row_group_size: int = 3) -> Path:
    import pyarrow as pa
    import pyarrow.parquet as pq

    path.parent.mkdir(parents=True, exist_ok=True)
    pq.write_table(pa.Table.from_pylist(rows), path, row_group_size=row_group_size)
    return path


def test_parquet_shards_and_streaming_equal_jax(tmp_path):
    a = write_parquet(tmp_path / "a.parquet", mls_rows(8, 0))
    b = write_parquet(tmp_path / "b.parquet", mls_rows(5, 1), row_group_size=2)
    for data_files in ([str(a), str(b)], [str(b), str(a)], str(tmp_path / "*.parquet"), "*.parquet",
                       {"train": str(a), "test": [str(b)]}):
        for split in (["train", "test"] if isinstance(data_files, dict) else ["train"]):
            kwargs = {"data_files": data_files, "split": split}
            want = jax_rows("parquet", **kwargs)
            assert_rows_equal(pdata.load_hf_dataset("parquet", **kwargs), want)
            streamed = pdata.load_hf_dataset("parquet", streaming=True, **kwargs)
            assert not isinstance(streamed, list)
            assert_rows_equal(streamed, want)
    assert len(jax_rows("parquet", data_files=[str(a), str(b)], split="train")) == 13


def test_parquet_later_shard_cast_to_the_first_schema(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    a = write_parquet(tmp_path / "a.parquet", [{"x": 1, "y": "a"}, {"x": 2, "y": "b"}])
    b = tmp_path / "b.parquet"
    pq.write_table(pa.table({"x": pa.array([3, 4], pa.int32()), "y": ["c", None]}), b)
    kwargs = {"data_files": [str(a), str(b)], "split": "train"}
    assert_rows_equal(pdata.load_hf_dataset("parquet", **kwargs), jax_rows("parquet", **kwargs))


@pytest.mark.parametrize("n_samples", [1, 4, 13, 50])
def test_subset_with_and_without_filter_equals_jax(tmp_path, n_samples):
    files = [str(write_parquet(tmp_path / f"{i}.parquet", mls_rows(n, i))) for i, n in enumerate((8, 5))]
    csv_file = tmp_path / "rows.csv"
    csv_file.write_text("a,b\n" + "".join(f"{i},{'x' if i % 3 else ''}\n" for i in range(20)))
    for source, data_files, keep in (("parquet", files, lambda r: len(r["speech_tokens"]) % 2 == 0),
                                     ("csv", str(csv_file), lambda r: r["b"] is not None)):
        for filter_fn in (None, keep):
            kwargs = {"data_files": data_files, "split": "train"}
            want = [dict(r) for r in jdata.load_dataset_subset(source, n_samples, filter_fn=filter_fn, **kwargs)]
            got = pdata.load_dataset_subset(source, n_samples, filter_fn=filter_fn, **kwargs)
            assert_rows_equal(got, want)


# --------------------------------------------------------------------------------
# csv: each inference rule of datasets' pandas reader, a case each
# --------------------------------------------------------------------------------

CSV_CASES = {
    # the issue's column set: an int column with a blank, "007", bools with a blank, a quoted comma, strings
    "int_blank_float_bool_quoted": 'a,b,c,d,e\n1,007,True,"y,z",s\n,2,,plain,t\n3,,False,x,\n',
    "int_whitespace_and_signs": "a\n 1\n2 \n+3\n-0\n\t4\t\n00\n-007\n",
    "float_forms": "a\n1e3\n.5\n5.\n-1.5E-2\n 1e5 \n1.5\t\n1e500\n1e-400\n-0.0\n",
    "inf_words": "a\ninf\n-inf\nInfinity\niNf\n+Infinity\n-iNfInItY\n",
    "inf_with_a_space_is_a_string": "a\ninf \n1\n",
    "not_numbers": "a\n1_000\n0x10\n١٢\n1d3\n1.5e\n.\ne5\n+\n- 1\n1 2\n\xa03\n",
    "bools": "a,b,c\nTrue,true,True\nfalse,FALSE,1\nTRUE,,\n",
    "bool_with_whitespace_is_a_string": "a\n True\nFalse\n",
    "all_blank_column": "a,b\n,1\n,2\n",
    "quoted_numbers_and_blanks": 'a,b,c\n"1","",x\n"2",y,""\n',
    "whitespace_fields": "a,b\n  ,1\nx,2\n",
    "every_na_word": "a,b\n" + "".join(f"{w},1\n" for w in sorted(sources.NA_VALUES) if w and "," not in w),
    "na_lookalikes": "a\nNAN\nnAn\n+nan\nNaN \n NaN\n-nan\nnone\n",
    "duplicate_and_empty_names": "a,a,a.1,,b,\n1,2,3,4,5,6\n",
    "fewer_fields": "a,b,c\n1,2\n3,4,5\n",
    "blank_and_whitespace_lines": "a,b\n\n1,2\n   \n\t\n3,4\n\n",
    "single_column_blank_line": "a\nTrue\n\nFalse\n",
    "crlf_and_quoted_newline": 'a,b\r\n"x\r\ny",1\r\n"he said ""hi""",2\r\n',
    "bom": "﻿a,b\n1,2\n",
    "only_header": "a,b\n",
    "numeric_header": "1,2\n3,4\n",
    "header_whitespace": " a ,b\n1,2\n",
    "mixed_int_float": "a,b\n1,2.5\n2,3\n",
    "unicode_strings": "a,b\ncafé,日本語\n,😀\n",
    "uint64": "a\n9223372036854775808\n1\n",
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_csv_inference_equals_jax(tmp_path, case):
    path = tmp_path / f"{case}.csv"
    path.write_bytes(CSV_CASES[case].encode("utf-8"))
    kwargs = {"data_files": str(path), "split": "train"}
    if case == "only_header":  # no rows: no split on either side
        with pytest.raises(ValueError, match="corresponds to no data"):
            jax_rows("csv", **kwargs)
        with pytest.raises(ValueError, match="corresponds to no data"):
            pdata.load_hf_dataset("csv", **kwargs)
        return
    want = jax_rows("csv", **kwargs)
    assert_rows_equal(pdata.load_hf_dataset("csv", **kwargs), want)


def test_csv_decimal_parser_equals_pandas_on_a_float_fuzz(tmp_path):
    """pandas' ``precise_xstrtod`` is not correctly rounded past 17 digits and
    at large exponents: 2,000 seeded decimal strings read as the JAX rows read them."""
    rng = random.Random(0)
    fmts = ["%.17g", "%.15g", "%.20g", "%.6e", "%.25f", "%.3f", "%.18e", "%.1g"]
    vals = [rng.choice(fmts) % ((rng.random() - 0.3) * 10.0 ** rng.randint(-300, 300)) for _ in range(2000)]
    path = tmp_path / "floats.csv"
    path.write_text("a,b\n" + "".join(f"{v},{i}\n" for i, v in enumerate(vals)))
    kwargs = {"data_files": str(path), "split": "train"}
    want = jax_rows("csv", **kwargs)
    assert_rows_equal(pdata.load_hf_dataset("csv", **kwargs), want)
    assert sum(float(v) != r["a"] for v, r in zip(vals, want)) > 0  # the fuzz reaches pandas' rounding


@pytest.mark.parametrize("later", ["blank", "ints", "floats_in_int_column"])
def test_csv_chunks_cast_to_the_first_chunk_types(tmp_path, later):
    """``datasets`` infers each 10,000-row chunk alone and casts later chunks
    to the first's types; a cast Arrow refuses fails on both sides."""
    n = sources.CSV_CHUNK_ROWS
    first = [str(i) for i in range(n)] if later != "ints" else [f"{i}.5" for i in range(n)]
    second = {"blank": ["", "7"], "ints": ["1", "2"], "floats_in_int_column": ["2.5", "3"]}[later]
    path = tmp_path / "chunks.csv"
    path.write_text("a\n" + "\n".join(first + second) + "\n")
    kwargs = {"data_files": str(path), "split": "train"}
    if later == "floats_in_int_column":
        with pytest.raises(Exception):
            jax_rows("csv", **kwargs)
        with pytest.raises(NotImplementedError, match="column 'a'"):
            pdata.load_hf_dataset("csv", **kwargs)
        return
    assert_rows_equal(pdata.load_hf_dataset("csv", **kwargs), jax_rows("csv", **kwargs))


def test_copied_patterns_and_na_words_equal_the_originals():
    from datasets import data_files as hf
    from datasets.packaged_modules.csv.csv import CsvConfig
    from pandas._libs.parsers import STR_NA_VALUES

    assert sources.DEFAULT_PATTERNS_SPLIT_IN_FILENAME == {str(k): v for k, v in
                                                          hf.DEFAULT_PATTERNS_SPLIT_IN_FILENAME.items()}
    assert sources.DEFAULT_PATTERNS_SPLIT_IN_DIR_NAME == {str(k): v for k, v in
                                                          hf.DEFAULT_PATTERNS_SPLIT_IN_DIR_NAME.items()}
    assert sources.SPLIT_PATTERN_SHARDED == hf.SPLIT_PATTERN_SHARDED
    assert [{str(k): v for k, v in p.items()} for p in hf.ALL_DEFAULT_PATTERNS] == sources.ALL_DEFAULT_PATTERNS
    assert sources.FILES_TO_IGNORE == hf.FILES_TO_IGNORE
    assert sources.NA_VALUES == STR_NA_VALUES
    assert sources.CSV_CHUNK_ROWS == CsvConfig.chunksize


# --------------------------------------------------------------------------------
# local dataset directories
# --------------------------------------------------------------------------------

README_CONFIGS = """---
license: cc-by-4.0
pretty_name: 'MLS: speech tokens'
task_categories:
- automatic-speech-recognition
language: [en]
configs:
- config_name: default
  data_files:
  - split: train
    path: shards/part-a-*
  - split: dev
    path:
    - shards/part-b-*
---
# A dataset card

Text after the header.
"""


def _layout(root: Path, layout: str) -> Path:
    """A dataset directory in one of the layouts ``datasets`` resolves by itself."""
    d = root / layout
    rows = {k: mls_rows(n, s) for k, n, s in (("a", 8, 0), ("b", 5, 1), ("c", 4, 2))}
    if layout == "hf_shards":  # data/<split>-0000i-of-0000n.parquet, as the hub writes them
        write_parquet(d / "data" / "train-00000-of-00002.parquet", rows["a"])
        write_parquet(d / "data" / "train-00001-of-00002.parquet", rows["b"])
        write_parquet(d / "data" / "validation-00000-of-00001.parquet", rows["c"])
        (d / "README.md").write_text("---\nlicense: cc-by-4.0\n---\n# no configs\n")
    elif layout == "split_dirs":  # <split>/ directories of csv files
        for split, key in (("train", "a"), ("test", "c")):
            (d / split).mkdir(parents=True)
            (d / split / "0.csv").write_text("x,y\n" + "".join(f"{r['ID']},{r['n_frames'] or ''}\n" for r in rows[key]))
            (d / split / "1.csv").write_text("x,y\n" + "".join(f"{r['ID']}b,{len(r['speech_tokens'])}\n"
                                                               for r in rows[key]))
    elif layout == "split_names":  # keywords in file names: dev -> validation
        d.mkdir()
        for name, key in (("train.jsonl", "a"), ("dev.jsonl", "b"), ("my_test.jsonl", "c"), ("train-2.jsonl", "c")):
            (d / name).write_text("".join(json.dumps(r) + "\n" for r in rows[key]))
        (d / ".hidden.jsonl").write_text(json.dumps(rows["a"][0]) + "\n")
        (d / "__pycache__").mkdir()
        (d / "__pycache__" / "train.jsonl").write_text(json.dumps(rows["a"][0]) + "\n")
    elif layout == "readme_configs":  # a README configs block with a custom split name
        write_parquet(d / "shards" / "part-a-0.parquet", rows["a"])
        write_parquet(d / "shards" / "part-a-1.parquet", rows["b"])
        write_parquet(d / "shards" / "part-b-0.parquet", rows["c"])
        write_parquet(d / "data" / "train-00000-of-00001.parquet", rows["c"])  # ignored: the configs decide
        (d / "README.md").write_text(README_CONFIGS)
    elif layout == "no_keywords":  # every file is train
        write_parquet(d / "x" / "one.parquet", rows["a"])
        write_parquet(d / "two.parquet", rows["b"])
        (d / "notes.txt").write_text("not data\n")
    return d


@pytest.mark.parametrize("layout", ["hf_shards", "split_dirs", "split_names", "readme_configs", "no_keywords"])
def test_directory_layouts_equal_jax(tmp_path, layout):
    import datasets

    d = _layout(tmp_path, layout)
    splits = list(datasets.load_dataset(str(d)))
    assert splits == {"hf_shards": ["train", "validation"], "split_dirs": ["train", "test"],
                      "split_names": ["train", "validation", "test"], "readme_configs": ["train", "dev"],
                      "no_keywords": ["train"]}[layout]
    for split in splits:
        want = jax_rows(str(d), split=split)
        assert want
        assert_rows_equal(pdata.load_hf_dataset(str(d), split=split), want)
        assert_rows_equal(pdata.load_dataset_subset(str(d), 3, split=split),
                          [dict(r) for r in jdata.load_dataset_subset(str(d), 3, split=split)])
    with pytest.raises(ValueError, match="Unknown split"):
        pdata.load_hf_dataset(str(d), split="absent")


# --------------------------------------------------------------------------------
# Alpaca
# --------------------------------------------------------------------------------


def alpaca_rows(n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    words = ["give", "three", "tips", "for", "staying", "healthy", "translate", "café", "日本語", "it's"]
    pick = lambda k: " ".join(words[j] for j in rng.integers(0, len(words), k))  # noqa: E731
    return [{"instruction": pick(int(rng.integers(2, 8))), "input": pick(int(rng.integers(1, 5))) if i % 3 else "",
             "output": pick(int(rng.integers(1, 12)))} for i in range(n)]


@pytest.mark.parametrize("source", ["json", "parquet"])
def test_alpaca_samples_and_batches_bitwise(tmp_path, tiny_extended_tokenizer_path, source):
    rows = alpaca_rows(11)
    if source == "json":
        path = tmp_path / "alpaca.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    else:
        path = write_parquet(tmp_path / "alpaca.parquet", rows)
    jtk, _ = jtok.setup_llama3_tokenizer(tiny_extended_tokenizer_path, max_seq_len=192, verbose=False)
    ptk, _ = ptok.setup_llama3_tokenizer(tiny_extended_tokenizer_path, max_seq_len=192, verbose=False)
    kwargs = {"source": source, "data_files": str(path)}
    for shuffle, replicas, rank in ((True, 1, 0), (False, 1, 0), (True, 2, 1)):
        jl, js = jdata.setup_alpaca_data(jtk, 2, shuffle=shuffle, num_replicas=replicas, rank=rank, **kwargs)
        pl, ps = pdata.setup_alpaca_data(ptk, 2, shuffle=shuffle, num_replicas=replicas, rank=rank, **kwargs)
        for i in range(len(rows)):
            assert tagged(pl.dataset[i]) == tagged(jl.dataset[i])
        for epoch in (0, 1):
            js.set_epoch(epoch)
            ps.set_epoch(epoch)
            jb, pb = list(jl), list(pl)
            assert len(jb) == len(pb) > 0
            for a, b in zip(jb, pb):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_alpaca_default_source_is_a_refused_hub_id(tiny_extended_tokenizer_path):
    ptk, _ = ptok.setup_llama3_tokenizer(tiny_extended_tokenizer_path, max_seq_len=64, verbose=False)
    with pytest.raises(NotImplementedError, match="hub dataset 'tatsu-lab/alpaca'.*A12"):
        pdata.setup_alpaca_data(ptk, 2)


# --------------------------------------------------------------------------------
# the training CLIs on a parquet directory
# --------------------------------------------------------------------------------


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


def hf_directory(root: Path, train: list[dict], dev: list[dict]) -> Path:
    """``train`` in two parquet shards and ``dev`` in one, with a README configs block naming them."""
    half = len(train) // 2
    write_parquet(root / "data" / "train-00000-of-00002.parquet", train[:half])
    write_parquet(root / "data" / "train-00001-of-00002.parquet", train[half:])
    write_parquet(root / "data" / "validation-00000-of-00001.parquet", dev)
    (root / "README.md").write_text("---\nconfigs:\n- config_name: default\n  data_files:\n  - split: train\n"
                                    "    path: data/train-*\n  - split: validation\n    path: data/validation-*\n"
                                    "---\n")
    return root


@pytest.mark.parametrize("kind", ["sft", "cpt"])
def test_training_cli_on_a_parquet_directory_is_bitwise_its_json_lines_run(tmp_path, one_thread, kind):
    from ssi_tpu_torch.checkpoint.safetensors_io import safe_open
    from ssi_tpu_torch.cli.train_cpt import main as cpt_main
    from ssi_tpu_torch.cli.train_sft import main as sft_main

    step = helpers.make_tiny_hf_checkpoint(tmp_path / "step_0")
    make = helpers.synthetic_sft_rows if kind == "sft" else helpers.synthetic_cpt_rows
    train, dev = make(8, seed=5), make(4, seed=6)
    jsonl = {}
    for name, rows in (("train", train), ("dev", dev)):
        jsonl[name] = tmp_path / f"{name}.jsonl"
        jsonl[name].write_text("".join(json.dumps(r) + "\n" for r in rows))
    directory = hf_directory(tmp_path / "hf", train, dev)
    common = [f"data={kind}/mls-hubert_large_ll60k-layer_22", "model_config=tiny_test",
              f"speech.n_dsus={helpers.TINY_N_DSUS}", f"checkpointer.checkpoint_dir={step}",
              f"tokenizer.path={step / 'original' / 'tokenizer.model'}", "tokenizer.max_seq_len=384",
              "dtype=fp32", "max_steps=2", "save_steps=2", "eval_steps=2", "log_interval=1", "clip_grad_norm=1.0",
              "wandb.enabled=false", "gradient_accumulation_steps=1", "+device=cpu",
              "data.train.dataloader.batch_size=2", "data.dev.dataloader.batch_size=2"]
    runs, batches = {}, {}
    for name, split_args in (
            ("json", [a for s in ("train", "dev") for a in (
                f"data.{s}.dataset.source=json", f"+data.{s}.dataset.data_files={jsonl[s]}",
                f"data.{s}.dataset.split=train")]),
            ("dir", [f"data.train.dataset.source={directory}", f"data.dev.dataset.source={directory}",
                     "data.train.dataset.split=train", "data.dev.dataset.split=validation"])):
        out = tmp_path / name
        trainer = (sft_main if kind == "sft" else cpt_main)([*common, *split_args, f"checkpointer.output_dir={out}"])
        batches[name] = [b for loader in (trainer.data_train, trainer.data_dev) for b in loader]
        metrics = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
        with safe_open(next((out / "step_2").glob("*.safetensors"))) as f:
            weights = {k: f.get_tensor(k) for k in f.keys()}
        runs[name] = ([{k: v for k, v in m.items() if k not in ("duration_step", "tokens_per_second_per_gpu",
                                                                  "train_clock_time")} for m in metrics], weights)
    assert len(batches["dir"]) == len(batches["json"]) > 0
    for a, b in zip(batches["dir"], batches["json"]):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert runs["dir"][0] == runs["json"][0] and any("dev_loss" in m for m in runs["dir"][0])
    assert runs["dir"][1].keys() == runs["json"][1].keys()
    for k, w in runs["json"][1].items():
        assert torch.equal(runs["dir"][1][k], w), k


# --------------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------------


def test_refusals(tmp_path, monkeypatch):
    a = write_parquet(tmp_path / "a.parquet", mls_rows(3, 0))
    for source in ("text", "arrow", "imagefolder"):
        with pytest.raises(NotImplementedError, match=f"'{source}'.*A12"):
            pdata.load_hf_dataset(source, data_files=str(a), split="train")
    with pytest.raises(NotImplementedError, match="hub dataset 'anilkeshwani/mls-hubert_large_ll60k-layer_22'.*A12"):
        pdata.load_hf_dataset("anilkeshwani/mls-hubert_large_ll60k-layer_22", split="train")
    with pytest.raises(NotImplementedError, match=r"arguments \['columns'\].*A12"):
        pdata.load_hf_dataset("parquet", data_files=str(a), split="train", columns=["ID"])
    d = tmp_path / "texts"
    d.mkdir()
    (d / "train.txt").write_text("a line\n")
    with pytest.raises(NotImplementedError, match="'text' builder.*A12"):
        pdata.load_hf_dataset(str(d), split="train")
    with pytest.raises(FileNotFoundError):
        pdata.load_hf_dataset("parquet", data_files=str(tmp_path / "absent.parquet"), split="train")
    two = tmp_path / "two_configs"  # a README naming two configs and no default: datasets wants a config name
    write_parquet(two / "a.parquet", mls_rows(2, 0))
    (two / "README.md").write_text("---\nconfigs:\n- config_name: x\n  data_files: a.parquet\n"
                                   "- config_name: y\n  data_files: a.parquet\n---\n")
    with pytest.raises(ValueError, match="Config name is missing"):
        jax_rows(str(two), split="train")
    with pytest.raises(NotImplementedError, match=r"configs \['x', 'y'\].*none is the default.*A12"):
        pdata.load_hf_dataset(str(two), split="train")
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="Reading parquet files needs the package 'pyarrow'"):
        pdata.load_hf_dataset("parquet", data_files=str(a), split="train")
