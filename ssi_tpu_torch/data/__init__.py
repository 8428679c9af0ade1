"""Dataset loading for the port — ``load_hf_dataset`` and
``load_dataset_subset`` of ``ssi_tpu/data/__init__.py`` (46-77), without the
``datasets`` package.

The generation entry point reads its split the way ``tools/wer_drive.py``
passes it: ``source="json"`` with ``data_files`` (a path, a list of paths, or
a dict of split -> paths) and ``split``. Each file holds JSON lines; a split
is a list of row dicts,
every row carrying every column seen in the split (absent -> None), as a
``datasets.Dataset`` row does. Any other source raises
``NotImplementedError``: the card has no network, and maybe no ``datasets``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any

LOGGER = logging.getLogger(__name__)

__all__ = ["load_dataset_subset", "load_hf_dataset"]


def _not_ported(source: str) -> NotImplementedError:
    return NotImplementedError(
        f"Dataset source {source!r} is not ported to ssi_tpu_torch yet: only source='json' with "
        "data_files (JSON lines) is (ROADMAP.md queue A, item A12: hub and other file-type sources)"
    )


def _split_files(data_files: Any, split: str | None) -> list[Path]:
    if split is None:
        raise ValueError("source='json' needs a 'split' (e.g. split='train')")
    if isinstance(data_files, (str, Path)):
        data_files = {"train": [data_files]}
    elif isinstance(data_files, (list, tuple)):
        data_files = {"train": list(data_files)}
    elif not isinstance(data_files, dict):
        raise ValueError(f"data_files must be a path, a list of paths, or a dict of split -> paths; got {data_files!r}")
    if split not in data_files:
        raise ValueError(f'Unknown split "{split}". Should be one of {list(data_files)}.')
    entries = data_files[split]
    paths: list[Path] = []
    for entry in [entries] if isinstance(entries, (str, Path)) else entries:
        if not Path(entry).is_file():
            raise FileNotFoundError(f"Unable to find data file {entry!r}")
        paths.append(Path(entry))
    return paths


def _read_rows(paths: list[Path]):
    for path in paths:
        for line in path.read_text().splitlines():
            if line.strip():
                yield json.loads(line)


def _with_all_columns(rows: list[dict]) -> list[dict]:
    columns: dict[str, None] = {}
    for row in rows:
        columns.update(dict.fromkeys(row))
    return [{k: row.get(k) for k in columns} for row in rows]


def _json_kwargs(source: str, load_dataset_kwargs: dict[str, Any]) -> tuple[Any, str | None]:
    if source != "json":
        raise _not_ported(source)
    kwargs = dict(load_dataset_kwargs)
    data_files, split = kwargs.pop("data_files", None), kwargs.pop("split", None)
    if data_files is None:
        raise ValueError("source='json' needs data_files")
    if kwargs:
        raise NotImplementedError(f"load_dataset arguments {sorted(kwargs)} are not ported (source='json'; "
                                  "ROADMAP.md queue A, item A12)")
    return data_files, split


def load_hf_dataset(source: str, **load_dataset_kwargs) -> list[dict[str, Any]]:
    """Load a full split (``datasets.load_dataset(source, **kwargs)``'s rows)."""
    data_files, split = _json_kwargs(source, load_dataset_kwargs)
    return _with_all_columns(list(_read_rows(_split_files(data_files, split))))


def load_dataset_subset(source: str, n_samples: int, filter_fn=None, **load_dataset_kwargs) -> list[dict[str, Any]]:
    """The first ``n_samples`` rows of a split, read as a stream.

    ``filter_fn`` is applied to the stream BEFORE the take, so the result is
    "the first n_samples MATCHING rows" — filtering after the take would
    silently return fewer samples than requested.
    """
    if "split" not in load_dataset_kwargs:
        raise ValueError("load_dataset_subset requires a 'split' kwarg (e.g. split='train')")
    data_files, split = _json_kwargs(source, load_dataset_kwargs)
    rows = []
    for row in _read_rows(_split_files(data_files, split)):
        if len(rows) >= n_samples:
            break
        if filter_fn is None or filter_fn(row):
            rows.append(row)
    LOGGER.info(
        f"Streamed {len(rows)}/{n_samples} samples from {source} (split={load_dataset_kwargs.get('split', '?')})"
    )
    return _with_all_columns(rows)
