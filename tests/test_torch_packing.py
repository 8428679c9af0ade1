"""The port's packing (``ssi_tpu_torch/data/packing.py`` and its wiring in
``ssi_tpu_torch/data/__init__.py`` ``_build_loader``) against the JAX
package's ``ssi_tpu.data.packing``.

Held bitwise: packs from ``greedy_pack`` and ``PackedDataset`` (per-epoch
re-pack, clamped or cycled to the epoch-0 count), ``WindowedPackedDataset``
(shuffle on and off, over epochs, a partial tail window) and collated
batches, with a hypothesis sweep over lengths, ``split_across_pack``,
``drop_long`` and ``window``; the SFT and CPT loaders with ``packed: true``
over two epochs. Held in f32: the packed loss equals the per-sample sum
(rtol 1e-5) and the JAX package's packed loss; the port's ``Trainer`` with
``packed: true``, with and without ``pack_window``, gives the JAX Trainer's
losses (rtol 2e-5, as ``tests/test_torch_trainer.py``), resumes bitwise
across an epoch boundary, resumes a packed state the JAX Trainer wrote, and
the JAX Trainer resumes one the port wrote.
"""

import copy
import json

from hypothesis import given, settings, strategies as st
import numpy as np
import pytest
import torch

import ssi_tpu.data as jdata
import ssi_tpu.data.packing as jpack
import ssi_tpu.tokenizer as jtok
import ssi_tpu_torch.data as pdata
import ssi_tpu_torch.data.packing as ppack
import ssi_tpu_torch.tokenizer as ptok
from ssi_tpu.config import Config as JaxConfig
from ssi_tpu.train import Trainer as JaxTrainer
from ssi_tpu_torch.config import Config as PortConfig
from ssi_tpu_torch.train.geometry import TrainingGeometry
from ssi_tpu_torch.train.trainer import Trainer
from tests import helpers

PAD = 99
KEYS = ("tokens", "labels", "segment_ids", "positions")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class ListDataset:
    """Rows ``{"tokens", "labels"}`` of fixed lengths, or of lengths redrawn
    per epoch from ``(seed, epoch, index)`` when ``jitter`` (as CPT
    interleaving draws them), so a re-pack can change the pack count."""

    def __init__(self, lengths, jitter: int = 0, seed: int = 0):
        self.lengths, self.jitter, self.seed = list(lengths), jitter, seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, i):
        n = self.lengths[i]
        if self.jitter:
            n = max(1, n + int(np.random.default_rng((self.seed, self.epoch, i)).integers(-self.jitter,
                                                                                          self.jitter + 1)))
        toks = list(range(1000 * i + 1, 1000 * i + 1 + n))
        return {"tokens": toks, "labels": [t if t % 3 else -100 for t in toks]}


def assert_packs_equal(p, j):
    assert len(p) == len(j)
    for a, b in zip(p, j):
        assert list(a) == list(b) == list(KEYS)
        for k in KEYS:
            assert a[k].dtype == b[k].dtype == np.int32 and np.array_equal(a[k], b[k]), k


def items(ds):
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("split_across_pack", [False, True])
@pytest.mark.parametrize("drop_long", [False, True])
def test_greedy_pack_equals_jax(split_across_pack, drop_long):
    ds = ListDataset([5, 7, 16, 4, 30, 10, 3, 1, 15, 2])  # 30 > 16: dropped, raised or split
    kw = dict(max_seq_len=16, pad_id=PAD, split_across_pack=split_across_pack, drop_long=drop_long)
    if not split_across_pack and not drop_long:
        for mod in (ppack, jpack):
            with pytest.raises(ValueError, match="Sample 4 length 30 exceeds max_seq_len 16"):
                mod.greedy_pack(items(ds), **kw)
        return
    assert_packs_equal(ppack.greedy_pack(items(ds), **kw), jpack.greedy_pack(items(ds), **kw))


@pytest.mark.parametrize("lengths,jitter", [
    ([5, 7, 4, 10, 3, 6, 2, 8, 9, 1, 12], 0),
    ([5, 7, 4, 10, 3, 6, 2, 8, 9, 1, 12, 4, 4, 6], 4),  # epochs pack to other counts: clamped or cycled
    ([14, 13, 15, 2, 16, 1], 3),
])
def test_packed_dataset_over_epochs_equals_jax(lengths, jitter):
    p = ppack.PackedDataset(ListDataset(lengths, jitter), max_seq_len=16, pad_id=PAD)
    j = jpack.PackedDataset(ListDataset(lengths, jitter), max_seq_len=16, pad_id=PAD)
    counts = set()
    for epoch in range(5):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        assert p.dataset.epoch == j.dataset.epoch == epoch
        assert_packs_equal(items(p), items(j))
        counts.add(len(jpack.greedy_pack(items(j.dataset), max_seq_len=16, pad_id=PAD)))
    if jitter:
        assert len(counts) > 1  # the clamp or the cycle ran


@pytest.mark.parametrize("n,window,jitter", [(64, 8, 0), (65, 8, 0), (37, 8, 3), (20, 100, 2), (9, 1, 0)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_windowed_packed_over_epochs_equals_jax(n, window, jitter, shuffle):
    lengths = [int(x) for x in np.random.default_rng(n).integers(1, 12, n)]
    kw = dict(max_seq_len=16, pad_id=PAD, window=window, shuffle=shuffle, seed=7)
    p = ppack.WindowedPackedDataset(ListDataset(lengths, jitter), **kw)
    j = jpack.WindowedPackedDataset(ListDataset(lengths, jitter), **kw)
    assert (p.n_windows, p.packs_per_window, p.packs_tail, len(p)) == \
        (j.n_windows, j.packs_per_window, j.packs_tail, len(j))
    for epoch in (0, 1, 2, 1):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        order = np.random.default_rng(epoch).permutation(len(j))  # out-of-order reads, as a resume makes
        assert_packs_equal([p[int(i)] for i in order], [j[int(i)] for i in order])
        assert_packs_equal(items(p), items(j))
    with pytest.raises(IndexError):
        p[len(p)]


@settings(max_examples=60, deadline=None, derandomize=True)
@given(lengths=st.lists(st.integers(1, 40), min_size=1, max_size=40), split=st.booleans(),
       drop_long=st.booleans(), window=st.integers(1, 12), seq=st.sampled_from([8, 16, 32]))
def test_packing_sweep_equals_jax(lengths, split, drop_long, window, seq):
    kw = dict(max_seq_len=seq, pad_id=PAD, split_across_pack=split, drop_long=drop_long)

    def outcome(fn):
        try:
            return fn(), None
        except ValueError as e:
            return None, str(e)

    p, pe = outcome(lambda: ppack.PackedDataset(ListDataset(lengths), **kw))
    j, je = outcome(lambda: jpack.PackedDataset(ListDataset(lengths), **kw))
    assert pe == je
    if j is not None:
        assert_packs_equal(items(p), items(j))
        pc, pe = outcome(lambda: ppack.padded_collate_packed(items(p)))
        jc, je = outcome(lambda: jpack.padded_collate_packed(items(j)))
        assert pe == je  # no packs: nothing to stack
        if jc is not None:
            assert_packs_equal([pc], [jc])
    for shuffle in (False, True):
        p, pe = outcome(lambda: ppack.WindowedPackedDataset(ListDataset(lengths), window=window, shuffle=shuffle,
                                                            seed=3, **kw))
        j, je = outcome(lambda: jpack.WindowedPackedDataset(ListDataset(lengths), window=window, shuffle=shuffle,
                                                            seed=3, **kw))
        if pe is not None or je is not None:
            assert pe == je
            continue
        for epoch in (0, 1):
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            pi, pe = outcome(lambda: items(p))
            ji, je = outcome(lambda: items(j))
            assert pe == je
            if ji is not None:
                assert_packs_equal(pi, ji)


def test_collate_packed_equals_jax():
    packs = items(jpack.PackedDataset(ListDataset([5, 7, 4, 10, 3, 6]), max_seq_len=16, pad_id=PAD))
    p, j = ppack.padded_collate_packed(packs), jpack.padded_collate_packed(packs)
    assert list(p) == list(j) == list(KEYS)
    assert all(p[k].dtype == j[k].dtype and p[k].shape == j[k].shape == (len(packs), 16)
               and np.array_equal(p[k], j[k]) for k in KEYS)


# --- the loaders -------------------------------------------------------------------------------


def _cfgs(kind: str, split_path, pack_window):
    node = helpers.base_train_cfg_dict("/m", "/o", kind=kind)["data"]["train"]
    node.update(packed=True, pack_window=pack_window)
    port = json.loads(json.dumps(node))
    port["dataset"].update(source="json", data_files=str(split_path), split="train")
    return JaxConfig(node), PortConfig(port)


@pytest.mark.parametrize("kind", ["sft", "cpt"])
@pytest.mark.parametrize("pack_window", [None, 8])
def test_packed_loaders_equal_jax_over_two_epochs(tmp_path, synthetic_data, tiny_extended_tokenizer_path, kind,
                                                  pack_window):
    """``packed: true`` through ``setup_sft_data`` / ``setup_text_completion_data``:
    the same packs in the same order (the sampler shuffles packs, or with
    ``pack_window`` goes sequential and the dataset shuffles), epoch by epoch,
    and the same training geometry."""
    split = tmp_path / "train.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in synthetic_data[kind]))
    jcfg, pcfg = _cfgs(kind, split, pack_window)
    jax_tok = jtok.setup_llama3_tokenizer(tiny_extended_tokenizer_path, max_seq_len=256, verbose=False)[0]
    port_tok = ptok.setup_llama3_tokenizer(tiny_extended_tokenizer_path, max_seq_len=256, verbose=False)[0]
    setup = {"sft": (jdata.setup_sft_data, pdata.setup_sft_data),
             "cpt": (jdata.setup_text_completion_data, pdata.setup_text_completion_data)}[kind]
    j_loader, j_sampler = setup[0](jcfg, jax_tok)
    p_loader, p_sampler = setup[1](pcfg, port_tok)
    assert type(p_loader.dataset).__name__ == type(j_loader.dataset).__name__ == \
        ("WindowedPackedDataset" if pack_window else "PackedDataset")
    assert p_sampler.shuffle == j_sampler.shuffle == (pack_window is None)
    assert len(p_loader) == len(j_loader) > 1
    assert len(p_loader.dataset) < len(synthetic_data[kind])  # more than one sample a pack
    for epoch in range(2):
        for sampler, loader in ((j_sampler, j_loader), (p_sampler, p_loader)):
            sampler.set_epoch(epoch)
            loader.dataset.set_epoch(epoch)
        batches = list(zip(j_loader, p_loader, strict=True))
        for jb, pb in batches:
            assert list(pb) == list(jb) == list(KEYS)
            assert all(pb[k].dtype == jb[k].dtype and np.array_equal(pb[k], jb[k]) for k in KEYS)
    top = {"data": {"train": {"dataloader": {"batch_size": 2}}}, "gradient_accumulation_steps": 2, "max_steps": 9}
    assert TrainingGeometry.from_config(PortConfig(top), p_loader, 1) == \
        TrainingGeometry.from_config(JaxConfig(top), j_loader, 1)


def test_packed_loader_needs_max_seq_len(tmp_path, synthetic_data, tiny_extended_tokenizer_path):
    split = tmp_path / "train.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in synthetic_data["sft"]))
    jcfg, pcfg = _cfgs("sft", split, None)
    for setup, tok, cfg in ((jdata.setup_sft_data, jtok, jcfg), (pdata.setup_sft_data, ptok, pcfg)):
        with pytest.raises(ValueError, match="^PackedDataset requires a max_seq_len to be set on the tokenizer.$"):
            setup(cfg, tok.setup_llama3_tokenizer(tiny_extended_tokenizer_path, verbose=False)[0])


# --- the packed loss ---------------------------------------------------------------------------


def test_packed_loss_equals_the_per_sample_sum_and_jax():
    """A pack's summed NLL and token count equal the sum over its samples run
    alone (the boundary-masked shift drops exactly the cross-sample labels),
    f32, rtol 1e-5; and equal the JAX package's packed loss on the same
    weights."""
    import jax
    import jax.numpy as jnp

    from ssi_tpu.models.llama3 import init_params
    from ssi_tpu.train.step import make_loss_fn as jax_loss_fn
    from ssi_tpu_torch.models.llama3 import params_from_numpy
    from ssi_tpu_torch.train.step import make_loss_fn

    cfg = helpers.tiny_config()
    jparams = init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    loss_fn = make_loss_fn(cfg, remat=False, chunk_size=64)
    rng = np.random.default_rng(0)
    rows = []
    for n in (9, 13, 6, 20, 11, 30, 4):
        toks = rng.integers(0, cfg.vocab_size, n).tolist()
        rows.append({"tokens": toks, "labels": [t if i % 5 else -100 for i, t in enumerate(toks)]})
    packs = items(ppack.PackedDataset(rows, max_seq_len=32, pad_id=0))
    assert len(packs) < len(rows) and int(packs[0]["segment_ids"].max()) > 1
    batch = ppack.padded_collate_packed(packs)
    packed_loss, packed_n = loss_fn(params, *(torch.from_numpy(batch[k]) for k in KEYS))
    solo_loss, solo_n = 0.0, 0
    for r in rows:
        ls, nt = loss_fn(params, torch.tensor([r["tokens"]], dtype=torch.int32),
                         torch.tensor([r["labels"]], dtype=torch.int32))
        solo_loss += float(ls)
        solo_n += int(nt)
    assert int(packed_n) == solo_n
    np.testing.assert_allclose(float(packed_loss), solo_loss, rtol=1e-5)
    j_loss, j_n = jax_loss_fn(cfg, attn_impl="xla", remat=False, chunk_size=64)(
        jparams, *(jnp.asarray(batch[k]) for k in KEYS))
    assert int(j_n) == int(packed_n)
    np.testing.assert_allclose(float(packed_loss), float(j_loss), rtol=1e-5)


def test_packed_gradients_are_bitwise_repeatable():
    """The loss's gradients on one packed batch are the same bits run after
    run (two threads): the embedding's gradient sums repeated tokens' rows in
    a fixed order, which a bitwise resume needs."""
    from ssi_tpu_torch.models.configs import get_model_config
    from ssi_tpu_torch.models.llama3 import init_params
    from ssi_tpu_torch.train.step import make_loss_fn

    cfg = get_model_config("tiny_test")
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    rows = [{"tokens": t, "labels": t} for t in (rng.integers(0, cfg.vocab_size, n).tolist()
                                                 for n in rng.integers(100, 200, 8))]
    batch = ppack.padded_collate_packed(items(ppack.PackedDataset(rows, max_seq_len=384, pad_id=0))[:2])
    loss_fn = make_loss_fn(cfg, remat="save_qkv_mlp", chunk_size=128)

    def grads():
        p = {k: ({n: w.clone().requires_grad_() for n, w in v.items()} if isinstance(v, dict)
                 else v.clone().requires_grad_()) for k, v in params.items()}
        loss_fn(p, *(torch.from_numpy(batch[k]) for k in KEYS))[0].backward()
        return [p["embed"].grad, p["final_norm"].grad, *(w.grad for w in p["layers"].values())]

    first = grads()
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, grads()))


# --- the Trainer -------------------------------------------------------------------------------

N_ROWS = 24  # SFT at max_seq_len 384: 12 packs of about 2 rows, 3 windows of 2 x 2 per epoch


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("packed_trainer")
    model_dir = helpers.make_tiny_hf_checkpoint(root / "model")
    rows = helpers.synthetic_sft_rows(N_ROWS)
    split = root / "sft.jsonl"
    split.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return root, model_dir, split, rows


@pytest.fixture(scope="module")
def jax_rows(assets):
    import datasets as hfd

    mp = pytest.MonkeyPatch()
    rows = assets[3]
    mp.setattr(jdata, "load_hf_dataset", lambda source, **kw: hfd.Dataset.from_list(rows))
    yield
    mp.undo()


def cfg_dict(model_dir, out, split, port: bool, pack_window, **over) -> dict:
    d = helpers.base_train_cfg_dict(model_dir, out, kind="sft")
    d.update(max_steps=8, save_steps=2, eval_steps=2, remat="save_qkv_mlp", lr_scheduler=None)
    d["tokenizer"]["max_seq_len"] = 384
    for name in ("train", "dev"):
        d["data"][name].update(packed=True, pack_window=pack_window)
    if port:
        d.update(attn_impl="auto", device="cpu")
        for name in ("train", "dev"):
            d["data"][name]["dataset"].update(source="json", data_files=str(split), split="train")
    d.update(copy.deepcopy(over))
    return d


def run(port: bool, assets, out, pack_window, src=None, **over):
    """A Trainer of either package; from ``src/step_4`` and its state when given."""
    root, model_dir, split, _ = assets
    cfg = cfg_dict(src / "step_4" if src else model_dir, root / out, split, port, pack_window, **over)
    if src:
        cfg["checkpointer"]["training_state_checkpoint"] = str(src / "training_state.msgpack")
    t = (Trainer if port else JaxTrainer)((PortConfig if port else JaxConfig)(cfg))
    t.setup()
    losses: list[float] = []
    t._loss_log = losses
    t.train()
    t.cleanup()
    dev = [r["dev_loss"] for r in t.metric_logger.history if "dev_loss" in r]
    hist = [{k: v for k, v in r.items() if k not in ("duration_step", "tokens_per_second_per_gpu",
                                                     "train_clock_time")} for r in t.metric_logger.history]
    return t, losses, dev, hist


@pytest.fixture(scope="module", params=[None, 4], ids=["packed", "pack_window_4"])
def packed_runs(request, assets, jax_rows):
    w = request.param
    tag = f"w{w}"
    out = {"port_full": run(True, assets, f"port_full_{tag}", w),
           "jax_full": run(False, assets, f"jax_full_{tag}", w),
           "port_half": run(True, assets, f"port_half_{tag}", w, max_steps=4),
           "jax_half": run(False, assets, f"jax_half_{tag}", w, max_steps=4)}
    return w, out


def test_packed_trainer_matches_jax(packed_runs):
    """8 steps over 2+ epochs (3 optimizer steps an epoch), dev loss every 2 on
    the packed dev split: losses, dev losses, token counts and samples within
    2e-5 of the JAX Trainer's, counts exactly."""
    _, runs = packed_runs
    pt, p_losses, p_dev, p_hist = runs["port_full"]
    jt, j_losses, j_dev, j_hist = runs["jax_full"]
    assert vars(pt.geometry) == vars(jt.geometry)
    assert pt.geometry.batches_per_epoch == 6 and len(p_losses) == len(j_losses) == 8
    np.testing.assert_allclose(p_losses, j_losses, rtol=2e-5)
    assert len(p_dev) == len(j_dev) == 4
    np.testing.assert_allclose(p_dev, j_dev, rtol=2e-5)
    count_keys = lambda r: {k: v for k, v in r.items() if k.startswith("n_tokens.") or k in ("step", "tokens_total",
                                                                                               "max_seq_len_step")}
    assert [count_keys(r) for r in p_hist] == [count_keys(r) for r in j_hist]
    assert (pt.consumed_samples, pt.tokens_train_total, dict(pt.token_type_counts_total)) == \
        (jt.consumed_samples, jt.tokens_train_total, dict(jt.token_type_counts_total))


def test_packed_resume_is_bitwise_across_an_epoch_boundary(assets, packed_runs):
    """4 steps, then a fresh Trainer from step_4/ and its state: steps 5-8 (an
    epoch ends after step 6, and the next one re-packs) equal the
    uninterrupted run's, loss for loss and metric for metric, and so do the
    final weights."""
    w, runs = packed_runs
    root = assets[0]
    _, half, _, half_hist = runs["port_half"]
    _, full, _, full_hist = runs["port_full"]
    t, rest, _, rest_hist = run(True, assets, f"port_resumed_w{w}", w, src=root / f"port_half_w{w}")
    assert t.global_step == 8 and half + rest == full
    merged = {r["step"]: r for r in half_hist + rest_hist}
    assert [merged[r["step"]] for r in full_hist] == full_hist
    assert (root / f"port_resumed_w{w}" / "step_8" / "ft-model-00001-of-00001.safetensors").read_bytes() == \
        (root / f"port_full_w{w}" / "step_8" / "ft-model-00001-of-00001.safetensors").read_bytes()


def test_packed_state_written_by_jax_resumed_by_the_port(assets, packed_runs):
    w, runs = packed_runs
    _, jax_full, _, _ = runs["jax_full"]
    t, rest, _, _ = run(True, assets, f"port_from_jax_w{w}", w, src=assets[0] / f"jax_half_w{w}")
    assert t.global_step == 8 and len(rest) == 4
    np.testing.assert_allclose(rest, jax_full[4:], rtol=2e-5)


def test_packed_state_written_by_the_port_resumed_by_jax(assets, packed_runs):
    w, runs = packed_runs
    _, port_full, _, _ = runs["port_full"]
    t, rest, _, _ = run(False, assets, f"jax_from_port_w{w}", w, src=assets[0] / f"port_half_w{w}")
    assert t.global_step == 8 and len(rest) == 4
    np.testing.assert_allclose(rest, port_full[4:], rtol=2e-5)
