"""The port's checkpoint reading (safetensors I/O, HF key conversion,
``Checkpointer``) against the ``safetensors`` package and the JAX package's
``Checkpointer.load_params``, bit for bit, on the tiny extended checkpoint
that ``tests/helpers.py`` writes."""

import json

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open as st_safe_open
from safetensors.numpy import save_file as st_save_file

import ssi_tpu.checkpoint as jckpt
import ssi_tpu.models.configs as jconfigs
import ssi_tpu_torch.checkpoint as pckpt
import ssi_tpu_torch.models.configs as pconfigs
from ssi_tpu_torch.checkpoint.convert import expected_hf_keys, hf_to_internal, internal_to_hf
from ssi_tpu_torch.checkpoint.safetensors_io import load_file, safe_open, save_file
from ssi_tpu_torch.models.llama3 import params_from_numpy
from tests import helpers


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bytes as a numpy array (bf16 included)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _np_bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


@pytest.fixture()
def arrays():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16": rng.standard_normal((4, 7)).astype(ml_dtypes.bfloat16),
        "f16": rng.standard_normal((6,)).astype(np.float16),
        "scalar": np.asarray(np.float32(2.5)),
        "empty": np.zeros((0, 3), np.float32),
        "i64": np.arange(5, dtype=np.int64),
    }


def test_reader_reads_safetensors_output_bit_for_bit(tmp_path, arrays):
    path = tmp_path / "a.safetensors"
    st_save_file(arrays, str(path), metadata={"format": "pt"})
    with safe_open(path) as f:
        assert sorted(f.keys()) == sorted(arrays)
        assert f.metadata() == {"format": "pt"}
        for name, a in arrays.items():
            t = f.get_tensor(name)
            assert tuple(t.shape) == a.shape
            assert np.array_equal(_bits(t), _np_bits(a)), name
    assert load_file(path)["bf16"].dtype == torch.bfloat16


def test_writer_output_read_by_safetensors_bit_for_bit(tmp_path, arrays):
    tensors = {k: torch.from_numpy(np.array(a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a))
               for k, a in arrays.items()}
    tensors["bf16"] = tensors["bf16"].view(torch.bfloat16)
    tensors["transposed"] = torch.arange(12, dtype=torch.float32).reshape(3, 4).t()  # not contiguous
    path = tmp_path / "b.safetensors"
    save_file(tensors, path, metadata={"format": "pt"})
    with st_safe_open(str(path), framework="np") as f:
        assert f.metadata() == {"format": "pt"}
        assert sorted(f.keys()) == sorted(tensors)
        for name, t in tensors.items():
            assert np.array_equal(_np_bits(f.get_tensor(name)), _bits(t)), name
    assert int.from_bytes(path.read_bytes()[:8], "little") % 8 == 0  # header padded


def test_key_conversion_round_trips():
    cfg = helpers.tiny_config()
    pcfg = pconfigs.get_model_config("tiny_test")
    pcfg.n_dsus, pcfg.modality_tokens = cfg.n_dsus, cfg.modality_tokens
    gen = torch.Generator().manual_seed(0)
    hf = {k: torch.randn(3, 4, generator=gen) for k in expected_hf_keys(pcfg)}
    back = internal_to_hf(hf_to_internal(hf, pcfg), pcfg)
    assert set(back) == set(hf) and all(torch.equal(back[k], hf[k]) for k in hf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_params_equals_jax_bitwise(tmp_path, dtype):
    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    jcfg, pcfg = helpers.tiny_config(), pconfigs.get_model_config("tiny_test")
    pcfg.n_dsus, pcfg.modality_tokens = jcfg.n_dsus, jcfg.modality_tokens
    assert pcfg.checkpoint_expectations == tuple(jcfg.checkpoint_expectations)
    jax_params = jckpt.Checkpointer(model_dir, output_dir=tmp_path / "j",
                                    model_expectations=jcfg.checkpoint_expectations).load_params(
        jcfg, dtype=ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    ckpt = pckpt.Checkpointer(model_dir, output_dir=tmp_path / "p", model_expectations=pcfg.checkpoint_expectations)
    port_params = ckpt.load_params(pcfg, dtype=getattr(torch, dtype), device="cpu")
    want = params_from_numpy(jax_params, device="cpu")
    assert sorted(port_params) == sorted(want) and sorted(port_params["layers"]) == sorted(want["layers"])
    for name in ("embed", "final_norm"):
        assert port_params[name].dtype == getattr(torch, dtype)
        assert np.array_equal(_bits(port_params[name]), _bits(want[name])), name
    for name, w in want["layers"].items():
        assert np.array_equal(_bits(port_params["layers"][name]), _bits(w)), name
    assert ckpt.checkpoint_bytes == (model_dir / "model.safetensors").stat().st_size


def test_speech_config_update_equals_jax():
    for name in pconfigs.MODEL_CONFIGS:
        p, j = pconfigs.get_model_config(name), jconfigs.get_model_config(name).copy()
        speech = helpers.make_cfg({"n_dsus": 5000, "use_modality_tokens": True})
        p.update_from_speech_cfg(speech)
        j.update_from_speech_cfg(speech)
        assert p.vocab_size == j.vocab_size and tuple(p.checkpoint_expectations) == tuple(j.checkpoint_expectations)
        with pytest.raises(ValueError, match="n_dsus"):
            p.update_from_speech_cfg(helpers.make_cfg({"n_dsus": -1, "use_modality_tokens": True}))


def _errors(fn) -> str:
    with pytest.raises((ValueError, FileNotFoundError)) as info:
        fn()
    return str(info.value)


def test_validation_errors_match_jax(tmp_path):
    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    jcfg, pcfg = helpers.tiny_config(), pconfigs.get_model_config("tiny_test")
    pcfg.n_dsus, pcfg.modality_tokens = jcfg.n_dsus, jcfg.modality_tokens

    def both(make):
        return _errors(lambda: make(pckpt, pcfg)), _errors(lambda: make(jckpt, jcfg))

    # shard count: a second shard in the directory
    (model_dir / "model-extra.safetensors").write_bytes((model_dir / "model.safetensors").read_bytes())
    p, j = both(lambda m, c: m.Checkpointer(model_dir, output_dir=tmp_path / "o",
                                            model_expectations=c.checkpoint_expectations))
    assert p == j and "Expected 1 model shard(s)" in p
    (model_dir / "model-extra.safetensors").unlink()
    # config.json reporting another vocabulary
    config = json.loads((model_dir / "config.json").read_text())
    config["vocab_size"] += 1
    (model_dir / "config.json").write_text(json.dumps(config))
    p, j = both(lambda m, c: m.Checkpointer(model_dir, output_dir=tmp_path / "o",
                                            model_expectations=c.checkpoint_expectations))
    assert p == j and "vocab_size" in p
    config["vocab_size"] -= 1
    (model_dir / "config.json").write_text(json.dumps(config))
    # embedding rows against cfg.vocab_size (a model extended with another n_dsus)
    jcfg.n_dsus, pcfg.n_dsus = jcfg.n_dsus + 2, pcfg.n_dsus + 2
    p, j = both(lambda m, c: m.Checkpointer(model_dir, output_dir=tmp_path / "o").load_params(
        c, **({"device": "cpu", "dtype": torch.float32} if m is pckpt else {"dtype": np.float32})))
    assert p == j and "Embedding rows" in p
    # the output dir inside the checkpoint dir, and a missing directory
    p, j = both(lambda m, c: m.Checkpointer(model_dir, output_dir=model_dir / "out"))
    assert p == j and "must not be inside" in p
    p, j = both(lambda m, c: m.discover_safetensor_files(tmp_path / "absent"))
    assert p == j


def test_resume_state_not_ported(tmp_path):
    """Resume is ported (it once raised naming A7): a missing training-state
    file raises as the JAX package's does, and a present one is read back."""
    model_dir = helpers.make_tiny_hf_checkpoint(tmp_path / "model")
    p = _errors(lambda: pckpt.Checkpointer(model_dir, output_dir=tmp_path / "o",
                                           training_state_checkpoint=tmp_path / "state"))
    j = _errors(lambda: jckpt.Checkpointer(model_dir, output_dir=tmp_path / "o",
                                           training_state_checkpoint=tmp_path / "state"))
    assert p == j and "not found" in p
    (tmp_path / "state").write_bytes(jckpt.pack_state({"global_step": 3, "count": np.zeros((), np.int32)}))
    state = pckpt.Checkpointer(model_dir, output_dir=tmp_path / "o",
                               training_state_checkpoint=tmp_path / "state").load_training_state()
    assert state["global_step"] == 3 and state["count"].dtype == np.int32
