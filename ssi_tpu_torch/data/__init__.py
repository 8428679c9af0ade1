"""Host-side data pipeline for the port — ``ssi_tpu/data/__init__.py``
without the ``datasets`` package: ``load_hf_dataset`` and
``load_dataset_subset``; the ``Sampler`` (deterministic epoch-seeded shuffle
plus per-rank sharding), the fixed-shape collate ``padded_collate_sft`` and
the ``Loader`` yielding collated numpy batches; ``setup_sft_data`` and
``setup_text_completion_data``; and the Alpaca debug loader
(``setup_alpaca_data``). ``tests/test_torch_train_data.py`` holds sampler
indices and loader batches equal to the JAX package's,
``tests/test_torch_data_sources.py`` the sources' rows and the Alpaca
batches.

Packed sequences (``packed: true``, with or without ``pack_window``) go
through the port's copy of ``data/packing.py``, as in the JAX package.

A split is read from a local source (``data/sources.py``): ``source`` one of
``json`` (JSON lines), ``parquet`` or ``csv`` with ``data_files`` (a path or
glob, a list of them, or a dict of split -> paths), or a local dataset
directory in the layout of a downloaded HF dataset repo, and ``split``. A
split is a list of row dicts, every row carrying every column seen in the
split (absent -> None), as a ``datasets.Dataset`` row does; with
``streaming=True`` (as ``python -m ssi_tpu_torch.cli.train_dsu_bpe`` passes
it) ``load_hf_dataset`` yields the rows lazily, in file order, each as its
file holds it. Hub ids, the ``text`` and ``arrow`` sources and other
``load_dataset`` arguments raise ``NotImplementedError``: the card has no
network, and maybe no ``datasets``.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator
from functools import partial
import logging
import math
from typing import Any

import numpy as np

from ssi_tpu_torch.constants import CROSS_ENTROPY_IGNORE_IDX, SEED
from ssi_tpu_torch.data.sources import read_split, resolve_split
from ssi_tpu_torch.utils import round_up as _round_up

LOGGER = logging.getLogger(__name__)

__all__ = [
    "Loader",
    "Sampler",
    "load_dataset_subset",
    "load_hf_dataset",
    "padded_collate_sft",
    "setup_alpaca_data",
    "setup_sft_data",
    "setup_text_completion_data",
]


def load_hf_dataset(source: str, **load_dataset_kwargs) -> list[dict[str, Any]] | Iterator[dict[str, Any]]:
    """Load a full split (``datasets.load_dataset(source, **kwargs)``'s rows);
    with ``streaming=True`` an iterator over them, read as they are taken."""
    streaming = load_dataset_kwargs.pop("streaming", False)
    rows = read_split(*resolve_split(source, load_dataset_kwargs))
    if streaming:
        return rows
    rows = list(rows)
    if not rows:  # datasets builds no split from files without rows
        raise ValueError(f'Instruction "{load_dataset_kwargs["split"]}" corresponds to no data!')
    return _with_all_columns(rows)


def load_dataset_subset(source: str, n_samples: int, filter_fn=None, **load_dataset_kwargs) -> list[dict[str, Any]]:
    """The first ``n_samples`` rows of a split, read as a stream.

    ``filter_fn`` is applied to the stream BEFORE the take, so the result is
    "the first n_samples MATCHING rows" — filtering after the take would
    silently return fewer samples than requested.
    """
    if "split" not in load_dataset_kwargs:
        raise ValueError("load_dataset_subset requires a 'split' kwarg (e.g. split='train')")
    rows = []
    for row in read_split(*resolve_split(source, load_dataset_kwargs)):
        if len(rows) >= n_samples:
            break
        if filter_fn is None or filter_fn(row):
            rows.append(row)
    LOGGER.info(
        f"Streamed {len(rows)}/{n_samples} samples from {source} (split={load_dataset_kwargs.get('split', '?')})"
    )
    return _with_all_columns(rows)


def _with_all_columns(rows: list[dict]) -> list[dict]:
    columns: dict[str, None] = {}
    for row in rows:
        columns.update(dict.fromkeys(row))
    return [{k: row.get(k) for k in columns} for row in rows]


# --------------------------------------------------------------------------------
# Sampler: deterministic shuffle + per-process sharding
# --------------------------------------------------------------------------------


class Sampler:
    """Deterministic, shardable index sampler (DistributedSampler-equivalent).

    Pads the index list by wrapping so every rank yields the same count, shuffles
    with ``np.random.default_rng(seed + epoch)`` when requested, and yields the
    rank's strided slice. ``set_epoch`` reshuffles deterministically per epoch
    (ref: torch DistributedSampler semantics used at ssi/data/__init__.py:83).
    """

    def __init__(
        self,
        dataset_len: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = SEED,
        drop_last: bool = False,
    ) -> None:
        if not (0 <= rank < num_replicas):
            raise ValueError(f"rank ({rank}) must be in [0, num_replicas={num_replicas})")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_len % num_replicas != 0:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = math.ceil(dataset_len / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_len).tolist()
        else:
            indices = list(range(self.dataset_len))
        if not self.drop_last:
            padding = self.total_size - len(indices)
            if padding > 0:
                indices += (indices * math.ceil(padding / max(len(indices), 1)))[:padding]
        else:
            indices = indices[: self.total_size]
        assert len(indices) == self.total_size
        return iter(indices[self.rank : self.total_size : self.num_replicas])


# --------------------------------------------------------------------------------
# Fixed-shape collation
# --------------------------------------------------------------------------------


def padded_collate_sft(
    batch: list[dict[str, Any]],
    padding_idx: int = 0,
    ignore_idx: int = CROSS_ENTROPY_IGNORE_IDX,
    additional_keys: list[str] | None = None,
    *,
    pad_to: int | None = None,
    bucket_multiple: int | None = None,
) -> dict[str, Any]:
    """Pad token/label lists into int32 arrays of a static sequence length.

    Behavioural superset of the reference collate (ref: ssi/data/__init__.py:139-199):
    tokens pad with ``padding_idx``, labels with ``ignore_idx``, ``additional_keys``
    pass through as lists. Shapes are TPU-static:

    - ``pad_to`` set: always pad to exactly ``pad_to`` (one compiled shape);
    - else ``bucket_multiple`` set: pad to the smallest multiple that fits;
    - else: pad to the batch max (reference behaviour; CPU/debug only).
    """
    if additional_keys is None:
        additional_keys = []
    batch_max = max(len(x["tokens"]) for x in batch)
    batch_max = max(batch_max, max(len(x["labels"]) for x in batch))
    if pad_to is not None:
        if batch_max > pad_to:
            raise ValueError(f"Sequence of length {batch_max} exceeds collate pad_to={pad_to}")
        seq_len = pad_to
    elif bucket_multiple is not None:
        seq_len = _round_up(batch_max, bucket_multiple)
    else:
        seq_len = batch_max

    n = len(batch)
    tokens = np.full((n, seq_len), padding_idx, dtype=np.int32)
    labels = np.full((n, seq_len), ignore_idx, dtype=np.int32)
    for i, x in enumerate(batch):
        tokens[i, : len(x["tokens"])] = x["tokens"]
        labels[i, : len(x["labels"])] = x["labels"]

    additional_keys_dict = {key: [x[key] for x in batch] for key in additional_keys}
    return {"tokens": tokens, "labels": labels} | additional_keys_dict


# --------------------------------------------------------------------------------
# Loader: host iterator yielding collated numpy batches
# --------------------------------------------------------------------------------


class Loader:
    """Minimal deterministic DataLoader: sampler -> dataset rows -> collate.

    Single-process by design — the reference also runs ``num_workers: 0``
    (conf/data/_cpt_base.yaml:25); host tokenization overlaps device compute
    naturally because JAX dispatch is async.
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        sampler: Sampler,
        collate_fn: Callable[[list[dict[str, Any]]], dict[str, Any]],
        drop_last: bool = True,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.collate_fn = collate_fn
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        buf: list[dict[str, Any]] = []
        for idx in self.sampler:
            buf.append(self.dataset[idx])
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)


# --------------------------------------------------------------------------------
# Setup entry points (ref: ssi/data/__init__.py:59-131)
# --------------------------------------------------------------------------------


def _collate_for(cfg_dataset: Any, model_tokenizer: Any) -> Callable:
    dataloader_cfg = cfg_dataset.dataloader
    pad_mode = dataloader_cfg.get("pad_mode", "max_seq_len")
    pad_to = None
    bucket_multiple = None
    if pad_mode == "max_seq_len":
        if model_tokenizer.max_seq_len is None:
            raise ValueError("pad_mode=max_seq_len requires tokenizer.max_seq_len to be set")
        pad_to = int(model_tokenizer.max_seq_len)
    elif pad_mode == "bucket":
        bucket_multiple = int(dataloader_cfg.get("bucket_multiple", 128))
    elif pad_mode != "batch_max":
        raise ValueError(f"Unknown pad_mode: {pad_mode!r} (expected max_seq_len | bucket | batch_max)")
    return partial(
        padded_collate_sft,
        padding_idx=model_tokenizer.pad_id,
        ignore_idx=CROSS_ENTROPY_IGNORE_IDX,
        additional_keys=list(cfg_dataset.dataset.get("additional_keys", []) or []),
        pad_to=pad_to,
        bucket_multiple=bucket_multiple,
    )


def _build_loader(
    dataset: Any,
    cfg_dataset: Any,
    model_tokenizer: Any,
    num_replicas: int,
    rank: int,
) -> tuple[Loader, Sampler]:
    sampler_shuffle = bool(cfg_dataset["shuffle"])
    if cfg_dataset.get("packed", False):
        from ssi_tpu_torch.data.packing import PackedDataset, WindowedPackedDataset, padded_collate_packed

        if model_tokenizer.max_seq_len is None:
            raise ValueError("PackedDataset requires a max_seq_len to be set on the tokenizer.")
        pack_window = cfg_dataset.get("pack_window")
        if pack_window:
            # Streaming-scale path: O(window) memory; the shuffle moves INTO the
            # dataset (hierarchical window/pack permutation) so index access
            # stays window-local — the sampler must iterate sequentially.
            dataset = WindowedPackedDataset(
                dataset,
                max_seq_len=int(model_tokenizer.max_seq_len),
                pad_id=model_tokenizer.pad_id,
                window=int(pack_window),
                split_across_pack=bool(cfg_dataset.get("split_across_pack", False)),
                shuffle=sampler_shuffle,
                seed=SEED,
            )
            sampler_shuffle = False
        else:
            dataset = PackedDataset(
                dataset,
                max_seq_len=int(model_tokenizer.max_seq_len),
                pad_id=model_tokenizer.pad_id,
                split_across_pack=bool(cfg_dataset.get("split_across_pack", False)),
            )
        collate_fn = padded_collate_packed
    else:
        collate_fn = _collate_for(cfg_dataset, model_tokenizer)
    sampler = Sampler(
        dataset_len=len(dataset),
        num_replicas=num_replicas,
        rank=rank,
        shuffle=sampler_shuffle,
        seed=SEED,
    )
    loader = Loader(
        dataset=dataset,
        batch_size=int(cfg_dataset.dataloader.batch_size),
        sampler=sampler,
        collate_fn=collate_fn,
        drop_last=bool(cfg_dataset.dataloader.get("drop_last", True)),
    )
    return loader, sampler


def _as_kwargs(node: Any) -> dict[str, Any]:
    """Materialize a config node into plain-python kwargs."""
    from ssi_tpu_torch.config import to_container

    out = to_container(node, resolve=True)
    if not isinstance(out, dict):
        raise TypeError(f"Expected a mapping config node, got {type(out)}")
    return out


def setup_text_completion_data(
    cfg_dataset: Any,
    model_tokenizer: Any,
    num_replicas: int = 1,
    rank: int = 0,
) -> tuple[Loader, Sampler]:
    """Build the CPT loader (ref: ssi/data/__init__.py:59-95)."""
    from ssi_tpu_torch.data.cpt import TextCompletionDataset

    kwargs = _as_kwargs(cfg_dataset.dataset)
    dataset = TextCompletionDataset(tokenizer=model_tokenizer, **kwargs)
    loader, sampler = _build_loader(dataset, cfg_dataset, model_tokenizer, num_replicas, rank)
    LOGGER.info(f"Dataset and Sampler initialized from {cfg_dataset.dataset.source}.")
    return loader, sampler


def setup_sft_data(
    cfg_dataset: Any,
    model_tokenizer: Any,
    num_replicas: int = 1,
    rank: int = 0,
) -> tuple[Loader, Sampler]:
    """Build the SFT loader (ref: ssi/data/__init__.py:98-131)."""
    from ssi_tpu_torch.data.sft import SFTDataset

    kwargs = _as_kwargs(cfg_dataset.dataset)
    dataset = SFTDataset(model_tokenizer=model_tokenizer, **kwargs)
    loader, sampler = _build_loader(dataset, cfg_dataset, model_tokenizer, num_replicas, rank)
    LOGGER.info(f"Dataset and Sampler initialized from {cfg_dataset.dataset.source}.")
    return loader, sampler


####################################################################################################
# Debug: Alpaca text-SFT loader (ref: ssi/data/__init__.py:213-231 — used to
# demonstrate OOM behavior during SFT; torchtune's alpaca_dataset equivalent)
####################################################################################################


class _AlpacaDataset:
    """Alpaca instruction rows -> masked SFT samples (torchtune alpaca_dataset
    semantics: train_on_input=True, instruction+input form the user turn)."""

    _PROMPT_WITH_INPUT = (
        "Below is an instruction that describes a task, paired with an input that provides "
        "further context. Write a response that appropriately completes the request.\n\n"
        "### Instruction:\n{instruction}\n\n### Input:\n{input}\n\n### Response:\n"
    )
    _PROMPT_NO_INPUT = (
        "Below is an instruction that describes a task. Write a response that appropriately "
        "completes the request.\n\n### Instruction:\n{instruction}\n\n### Response:\n"
    )

    def __init__(self, tokenizer: Any, source: str = "tatsu-lab/alpaca",
                 train_on_input: bool = True, **load_dataset_kwargs) -> None:
        from ssi_tpu_torch.tokenizer.messages import Message

        self._tokenizer = tokenizer
        self._data = load_hf_dataset(source, split=load_dataset_kwargs.pop("split", "train"), **load_dataset_kwargs)
        self._train_on_input = train_on_input
        self._Message = Message

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, index: int) -> dict[str, Any]:
        row = self._data[int(index)]
        template = self._PROMPT_WITH_INPUT if row.get("input") else self._PROMPT_NO_INPUT
        user = template.format(instruction=row["instruction"], input=row.get("input", ""))
        messages = [
            self._Message(role="user", content=user, masked=not self._train_on_input, eot=True),
            self._Message(role="assistant", content=row["output"], masked=False, eot=True),
        ]
        tok = self._tokenizer({"messages": messages}, inference=False)
        tok["labels"] = list(np.where(tok["mask"], CROSS_ENTROPY_IGNORE_IDX, tok["tokens"]))
        return tok


def setup_alpaca_data(
    tokenizer: Any,
    batch_size: int,
    shuffle: bool = True,
    num_replicas: int = 1,
    rank: int = 0,
    source: str = "tatsu-lab/alpaca",
    **load_dataset_kwargs,
) -> tuple[Loader, Sampler]:
    """Debug SFT loader over the Alpaca dataset (ref: ssi/data/__init__.py:213-231).

    Kept for parity with the reference's OOM-debug workflow; unlike the reference
    it emits fixed-shape batches (pad_to=max_seq_len). The default source is a
    hub id, which the port refuses: pass a local source (``source="json"``
    with ``data_files``, a parquet or csv file, or a dataset directory).
    """
    ds = _AlpacaDataset(tokenizer, source=source, **load_dataset_kwargs)
    sampler = Sampler(len(ds), num_replicas=num_replicas, rank=rank, shuffle=shuffle, seed=SEED, drop_last=True)
    collate = partial(
        padded_collate_sft,
        padding_idx=tokenizer.pad_id,
        ignore_idx=CROSS_ENTROPY_IGNORE_IDX,
        pad_to=tokenizer.max_seq_len,
    )
    loader = Loader(ds, sampler=sampler, batch_size=batch_size, collate_fn=collate, drop_last=True)
    LOGGER.info(f"Alpaca debug dataset and Sampler initialized from {source}.")
    return loader, sampler
