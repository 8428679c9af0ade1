"""The port's training data pipeline (``ssi_tpu_torch/data``: ``Sampler``,
``padded_collate_sft``, ``Loader``, ``setup_sft_data``,
``setup_text_completion_data``, the CPT dataset) and ``TrainingGeometry``
against the JAX package's. The JAX side gets its rows from the
``synthetic_data`` fixture, the port reads the same rows from a JSON-lines
file; every batch (tokens, labels, pass-through keys) must be equal over two
epochs."""

import json

import numpy as np
import pytest

import ssi_tpu.data as jdata
import ssi_tpu.tokenizer as jtok
import ssi_tpu_torch.data as pdata
import ssi_tpu_torch.tokenizer as ptok
from ssi_tpu.config import Config as JaxConfig
from ssi_tpu.train.geometry import TrainingGeometry as JaxGeometry
from ssi_tpu_torch.config import Config as PortConfig
from ssi_tpu_torch.train.geometry import TrainingGeometry
from tests import helpers


@pytest.mark.parametrize("n,replicas,shuffle,drop_last", [
    (10, 1, True, False), (10, 3, True, False), (10, 3, False, False), (11, 4, True, True), (7, 2, False, True),
    (1, 3, True, False), (64, 2, True, False),
])
def test_sampler_indices_equal_jax(n, replicas, shuffle, drop_last):
    for rank in range(replicas):
        for seed in (0, 42_831):
            p = pdata.Sampler(n, num_replicas=replicas, rank=rank, shuffle=shuffle, seed=seed, drop_last=drop_last)
            j = jdata.Sampler(n, num_replicas=replicas, rank=rank, shuffle=shuffle, seed=seed, drop_last=drop_last)
            assert len(p) == len(j)
            for epoch in range(3):
                p.set_epoch(epoch)
                j.set_epoch(epoch)
                assert list(p) == list(j)


def _cfgs(kind: str, split_path, **dataloader):
    """(JAX config node, port config node) of ``data.train`` for ``kind``."""
    node = helpers.base_train_cfg_dict("/m", "/o", kind=kind)["data"]["train"]
    node["dataloader"].update(dataloader)
    node["dataset"]["additional_keys"] = ["ID"] if kind == "sft" else []
    port = json.loads(json.dumps(node))
    port["dataset"].update(source="json", data_files=str(split_path), split="train")
    return JaxConfig(node), PortConfig(port)


def _tokenizers(path, max_seq_len):
    return (jtok.setup_llama3_tokenizer(path, max_seq_len=max_seq_len, verbose=False)[0],
            ptok.setup_llama3_tokenizer(path, max_seq_len=max_seq_len, verbose=False)[0])


@pytest.mark.parametrize("kind,dataloader", [
    ("sft", {}), ("sft", {"pad_mode": "bucket", "bucket_multiple": 32, "drop_last": False}),
    ("cpt", {}), ("cpt", {"pad_mode": "batch_max", "batch_size": 3}),
])
def test_loader_batches_equal_jax_over_two_epochs(tmp_path, synthetic_data, tiny_extended_tokenizer_path, kind,
                                                  dataloader):
    split = tmp_path / "train.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in synthetic_data[kind]))
    jcfg, pcfg = _cfgs(kind, split, **dataloader)
    jax_tok, port_tok = _tokenizers(tiny_extended_tokenizer_path, 128)
    setup = {"sft": (jdata.setup_sft_data, pdata.setup_sft_data),
             "cpt": (jdata.setup_text_completion_data, pdata.setup_text_completion_data)}[kind]
    j_loader, j_sampler = setup[0](jcfg, jax_tok)
    p_loader, p_sampler = setup[1](pcfg, port_tok)
    assert len(p_loader) == len(j_loader) > 0
    n_batches = 0
    for epoch in range(2):
        for sampler, loader in ((j_sampler, j_loader), (p_sampler, p_loader)):
            sampler.set_epoch(epoch)
            if hasattr(loader.dataset, "set_epoch"):
                loader.dataset.set_epoch(epoch)
        for jb, pb in zip(j_loader, p_loader, strict=True):
            assert list(pb) == list(jb)
            for key in jb:
                if isinstance(jb[key], np.ndarray):
                    assert pb[key].dtype == jb[key].dtype and np.array_equal(pb[key], jb[key]), key
                else:
                    assert pb[key] == jb[key], key
            n_batches += 1
    assert n_batches == 2 * len(j_loader)


def test_training_geometry_equals_jax(tmp_path, synthetic_data, tiny_extended_tokenizer_path):
    split = tmp_path / "train.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in synthetic_data["sft"]))
    jcfg, pcfg = _cfgs("sft", split)
    jax_tok, port_tok = _tokenizers(tiny_extended_tokenizer_path, 128)
    j_loader, _ = jdata.setup_sft_data(jcfg, jax_tok)
    p_loader, _ = pdata.setup_sft_data(pcfg, port_tok)
    for accum, max_steps in ((1, 5), (3, 17), (4, 100), (32, 1)):
        top = {"data": {"train": {"dataloader": {"batch_size": 2}}}, "gradient_accumulation_steps": accum,
               "max_steps": max_steps}
        assert TrainingGeometry.from_config(PortConfig(top), p_loader, 1) == \
            TrainingGeometry.from_config(JaxConfig(top), j_loader, 1)
    top["gradient_accumulation_steps"] = 33
    with pytest.raises(ValueError, match="< gradient_accumulation_steps"):
        TrainingGeometry.from_config(PortConfig(top), p_loader, 1)


def test_collate_equals_jax():
    batch = [{"tokens": [1, 2, 3], "labels": [-100, 2, 3], "ID": "a"}, {"tokens": [4], "labels": [4], "ID": "b"}]
    for kw in ({}, {"pad_to": 8}, {"bucket_multiple": 4}, {"padding_idx": 7, "additional_keys": ["ID"]}):
        p, j = pdata.padded_collate_sft(batch, **kw), jdata.padded_collate_sft(batch, **kw)
        assert list(p) == list(j)
        assert all(np.array_equal(p[k], j[k]) and np.asarray(p[k]).dtype == np.asarray(j[k]).dtype for k in j)
    with pytest.raises(ValueError, match="exceeds collate pad_to"):
        pdata.padded_collate_sft(batch, pad_to=2)
