"""The port's first-party msgpack subset (``ssi_tpu_torch/checkpoint/msgpack_io.py``)
against the JAX package's ``pack_state`` / ``unpack_state`` (the ``msgpack``
package, imported here by the test only): byte-equal encoding of schema-v1
training states and of fuzzed trees (hypothesis, derandomized), decoding of
JAX-written bytes to equal values, and the streamed file writer."""

import random

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from ssi_tpu.checkpoint import pack_state, save_rng_states, unpack_state
from ssi_tpu_torch.checkpoint import msgpack_io
from ssi_tpu_torch.checkpoint import save_rng_states as port_save_rng_states

INT_EDGES = [0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, 2**64 - 1,
             -1, -31, -32, -33, -127, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]


def v1_state(torch_leaves: bool) -> dict:
    """A schema-v1 training state as the Trainer writes it: the optimizer
    moments (bf16 mu, f32 nu) and a 0-d int32 count, Python and numpy RNG
    states, hparams, metrics. ``torch_leaves``: the moments as the port holds
    them (torch tensors), else as the JAX package writes them (numpy)."""
    rng = np.random.default_rng(3)
    mu = {"embed": rng.standard_normal((7, 4)).astype(np.float32),
          "layers": {"wq": rng.standard_normal((2, 4, 4)).astype(np.float32)}}
    nu = {"embed": np.abs(rng.standard_normal((7, 4))).astype(np.float32),
          "layers": {"wq": np.abs(rng.standard_normal((2, 4, 4))).astype(np.float32)}}

    def leaf(x, bf16):
        if torch_leaves:
            t = torch.from_numpy(x)
            return t.to(torch.bfloat16) if bf16 else t
        return x.astype(ml_dtypes.bfloat16) if bf16 else x

    def tree(t, bf16):
        return {k: tree(v, bf16) if isinstance(v, dict) else leaf(v, bf16) for k, v in t.items()}

    random.seed(11)
    np.random.seed(12)
    return {
        "checkpoint_version": 1,
        "global_step": 4,
        "seed": 42_831,
        "optimizer": {"count": np.asarray(4, dtype=np.int32), "mu": tree(mu, True), "nu": tree(nu, False)},
        "lr_scheduler": {"last_step": 4},
        "rng_state": save_rng_states(),
        "training_hparams": {"batch_size": 2, "gradient_accumulation_steps": 4, "world_size": 1,
                             "steps_per_epoch": 8},
        "consumed_samples": 32,
        "cumulative_metrics": {"tokens_train_total": 123_456, "wall_clock_seconds": 12.5,
                               "token_type_counts": {"dsu": 10, "text": 2**33, "total": 2**40 + 3},
                               "consumed_windows": 4},
        "timestamp": "2026-10-17T00:00:00+00:00",
        "ssi_version": "0.1.0",
        "ints": INT_EDGES,
        "extras": [None, True, False, 0.1, -2.5, "", "x" * 31, "y" * 32, "é" * 200, "z" * 70_000,
                   b"", b"\x01" * 300, b"\x02" * 70_000, (1, (2, 3)), list(range(20)),
                   {str(i): i for i in range(17)}, np.int64(-5), np.uint8(200), np.float32(0.25)],
    }


@pytest.mark.parametrize("torch_leaves", [False, True], ids=["numpy", "torch"])
def test_v1_state_bytes_equal_pack_state(torch_leaves):
    assert msgpack_io.pack(v1_state(torch_leaves)) == pack_state(v1_state(False))


def test_every_dtype_and_shape_bytes_equal():
    arrays = [np.zeros((), np.int32), np.arange(5, dtype=np.int64), np.ones((2, 0, 3), np.float32),
              np.arange(6, dtype=np.float64).reshape(2, 3), np.arange(4, dtype=np.uint8),
              np.array([True, False]), np.arange(6, dtype=np.float32).reshape(3, 2).T,  # non-contiguous
              np.linspace(-3, 3, 7).astype(ml_dtypes.bfloat16), np.arange(3, dtype=np.int16),
              np.full((300,), 7, np.int8), np.zeros((40_000,), np.float16)]
    for a in arrays:
        assert msgpack_io.pack(a) == pack_state(a), a.dtype
    tensors = [torch.zeros((), dtype=torch.int32), torch.linspace(-3, 3, 7).to(torch.bfloat16),
               torch.arange(6, dtype=torch.float32).reshape(3, 2).t(), torch.ones(3, dtype=torch.bool)]
    for t in tensors:
        as_np = t.to(torch.float32).numpy().astype(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16 else t.numpy()
        assert msgpack_io.pack(t) == pack_state(as_np), t.dtype


def test_decodes_jax_written_bytes_to_equal_values():
    data = pack_state(v1_state(False))
    got, want = msgpack_io.unpack(data), unpack_state(data)

    def same(a, b):
        if isinstance(b, dict):
            assert isinstance(a, dict) and list(a) == list(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, list):
            assert isinstance(a, list) and len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(b, np.ndarray) and b.dtype == ml_dtypes.bfloat16:
            assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
            assert np.array_equal(a.view(torch.int16).numpy().view(np.uint16), b.view(np.uint16))
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b

    same(got, want)


def test_rng_states_round_trip_through_the_file(tmp_path):
    from ssi_tpu_torch.checkpoint import restore_rng_states

    random.seed(1)
    np.random.seed(2)
    state = port_save_rng_states()
    want = (random.random(), np.random.random())
    path = tmp_path / "s.msgpack"
    with open(path, "wb") as f:
        msgpack_io.pack_to_file({"rng_state": state}, f)
    assert path.read_bytes() == pack_state({"rng_state": state})
    random.seed(99)
    np.random.seed(99)
    restore_rng_states(msgpack_io.load(path)["rng_state"])
    assert (random.random(), np.random.random()) == want


def test_out_of_range_ints_raise_as_pack_state_does():
    for n in (2**64, -2**63 - 1):
        with pytest.raises(TypeError):
            pack_state(n)
        with pytest.raises(TypeError):
            msgpack_io.pack(n)


_DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.int8, np.float16, ml_dtypes.bfloat16]


@st.composite
def arrays(draw):
    dtype = draw(st.sampled_from(_DTYPES))
    shape = tuple(draw(st.lists(st.integers(0, 5), max_size=3)))
    n = int(np.prod(shape))
    values = draw(st.lists(st.integers(-100, 100), min_size=n, max_size=n))
    return np.asarray(values, dtype=np.float64).astype(dtype).reshape(shape)


_leaves = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1) | st.floats(allow_nan=False)
           | st.text(max_size=40) | st.binary(max_size=40) | arrays())
_trees = st.recursive(_leaves, lambda kids: st.lists(kids, max_size=18) | st.dictionaries(st.text(max_size=8), kids,
                                                                                            max_size=18), max_leaves=40)


@settings(max_examples=300, derandomize=True, deadline=None, suppress_health_check=list(HealthCheck))
@given(_trees)
def test_fuzzed_trees_bytes_equal_and_round_trip(tree):
    data = pack_state(tree)
    assert msgpack_io.pack(tree) == data
    assert msgpack_io.pack(msgpack_io.unpack(data)) == data
