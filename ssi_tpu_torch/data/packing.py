"""Fixed-shape sequence packing for CPT/SFT — the port's copy of
``ssi_tpu/data/packing.py``, line for line (host numpy);
``tests/test_torch_packing.py`` holds its packs, windowed packs and
collated batches bitwise equal to the original's.

The reference declares packed-dataset support but never implements it (ref:
ssi/data/__init__.py:69,106 raise NotImplementedError; plans/Feature - Packed
Dataset Support.md). On TPU packing is the *natural* data layout (SURVEY.md §7.1):
fixed-shape packs eliminate padding waste and recompiles, and the attention mask
(segment ids) plus per-segment positions keep the loss semantics identical to the
unpacked case because normalization counts only non-ignored tokens.

``PackedDataset`` greedily packs samples in deterministic dataset order into
``max_seq_len``-length rows. Packing is per-epoch deterministic: ``set_epoch``
re-packs so per-sample RNG (CPT interleaving) still varies across epochs while
resume-by-index stays exact.

Pack layout per row:
- ``tokens``   int32 [S] — concatenated sample tokens, pad_id tail;
- ``labels``   int32 [S] — concatenated labels, ignore_index tail;
- ``segment_ids`` int32 [S] — 1-based segment per sample, 0 on padding;
- ``positions``   int32 [S] — restart at 0 per segment (RoPE-correct), 0 on padding.

The cross-segment label shift is masked inside the loss (train.step.shift_labels_packed).
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np

from ssi_tpu_torch.constants import CROSS_ENTROPY_IGNORE_IDX

LOGGER = logging.getLogger(__name__)


def greedy_pack(
    samples: Any,
    *,
    max_seq_len: int,
    pad_id: int,
    split_across_pack: bool = False,
    drop_long: bool = True,
) -> list[dict[str, np.ndarray]]:
    """Greedily pack an iterable of ``{"tokens", "labels"}`` samples, in order,
    into fixed-length rows (the shared core of both packers)."""
    s = int(max_seq_len)
    packs: list[dict[str, np.ndarray]] = []
    tokens = np.full(s, pad_id, np.int32)
    labels = np.full(s, CROSS_ENTROPY_IGNORE_IDX, np.int32)
    segs = np.zeros(s, np.int32)
    pos = np.zeros(s, np.int32)
    fill = 0
    seg_id = 0

    def flush():
        nonlocal tokens, labels, segs, pos, fill, seg_id
        if fill > 0:
            packs.append({"tokens": tokens, "labels": labels, "segment_ids": segs, "positions": pos})
        tokens = np.full(s, pad_id, np.int32)
        labels = np.full(s, CROSS_ENTROPY_IGNORE_IDX, np.int32)
        segs = np.zeros(s, np.int32)
        pos = np.zeros(s, np.int32)
        fill = 0
        seg_id = 0

    for idx, sample in enumerate(samples):
        tk = np.asarray(sample["tokens"], np.int32)
        lb = np.asarray(sample["labels"], np.int32)
        if len(tk) > s and not split_across_pack:
            if drop_long:
                LOGGER.warning(f"Dropping sample {idx}: length {len(tk)} > max_seq_len {s}")
                continue
            raise ValueError(f"Sample {idx} length {len(tk)} exceeds max_seq_len {s}")
        offset = 0
        while offset < len(tk):
            space = s - fill
            take = min(space, len(tk) - offset)
            if take < len(tk) - offset and not split_across_pack:
                flush()
                continue
            seg_id += 1
            tokens[fill : fill + take] = tk[offset : offset + take]
            labels[fill : fill + take] = lb[offset : offset + take]
            segs[fill : fill + take] = seg_id
            # positions restart per segment: a split continuation is a fresh
            # segment (attention cannot see its severed prefix, so restarting
            # RoPE positions keeps the geometry self-consistent)
            pos[fill : fill + take] = np.arange(take, dtype=np.int32)
            fill += take
            offset += take
            if fill == s:
                flush()
    flush()
    return packs


class PackedDataset:
    """Eagerly pack an indexable token dataset into fixed-length rows.

    Args:
        dataset: indexable dataset yielding ``{"tokens": [...], "labels": [...]}``.
        max_seq_len: pack row length (the static model sequence length).
        pad_id: token padding value.
        split_across_pack: split samples across pack boundaries instead of starting
            a new pack (keeps zero padding between packs; a sample's continuation
            starts a new segment so attention never crosses the boundary).
        drop_long: drop samples longer than ``max_seq_len`` when not splitting
            (False raises instead).
    """

    def __init__(
        self,
        dataset: Any,
        max_seq_len: int,
        pad_id: int,
        split_across_pack: bool = False,
        drop_long: bool = True,
    ) -> None:
        self.dataset = dataset
        self.max_seq_len = int(max_seq_len)
        self.pad_id = int(pad_id)
        self.split_across_pack = split_across_pack
        self.drop_long = drop_long
        self._epoch: int | None = None
        self._packs: list[dict[str, np.ndarray]] = []
        self._ensure_packed(0)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        self._ensure_packed(epoch)

    def _ensure_packed(self, epoch: int) -> None:
        if self._epoch == epoch:
            return
        first_pack = self._epoch is None
        self._epoch = epoch
        self._packs = self._pack_all()
        if first_pack:
            self._target_len = len(self._packs)
        else:
            # Stochastic sample lengths (CPT interleaving) can change the pack count
            # across epochs; training geometry (steps_per_epoch, resume math) requires
            # a constant epoch length, so clamp to the epoch-0 count.
            if len(self._packs) > self._target_len:
                self._packs = self._packs[: self._target_len]
            elif len(self._packs) < self._target_len:
                if not self._packs:
                    raise ValueError(f"Epoch {epoch} packed to zero rows; cannot pad to {self._target_len}")
                base = list(self._packs)
                i = 0
                while len(self._packs) < self._target_len:  # cycle distinct packs, not pack 0
                    self._packs.append(base[i % len(base)])
                    i += 1
        LOGGER.info(
            f"Packed {len(self.dataset)} samples into {len(self._packs)} rows of {self.max_seq_len} "
            f"(epoch {epoch}, split_across_pack={self.split_across_pack})"
        )

    def _pack_all(self) -> list[dict[str, np.ndarray]]:
        n = len(self.dataset)
        return greedy_pack(
            (self.dataset[i] for i in range(n)),
            max_seq_len=self.max_seq_len,
            pad_id=self.pad_id,
            split_across_pack=self.split_across_pack,
            drop_long=self.drop_long,
        )

    def __len__(self) -> int:
        return len(self._packs)

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        return self._packs[int(index)]


class WindowedPackedDataset:
    """Streaming-scale packer: O(window) memory, exact resume by construction.

    ``PackedDataset`` materializes every pack of the epoch and re-packs on
    ``set_epoch`` — fine for subsets, impossible for the MLS-scale (44k h) CPT
    corpora the reference targets (ref: plans/Feature - Packed Dataset
    Support.md; VERDICT r2 weak #4). This packer instead treats the source
    dataset as fixed-size **windows** of ``window`` consecutive samples and
    packs one window at a time, on demand:

    - Window ``w`` covers source indices ``[w*window, (w+1)*window)``; its
      packs are a pure function of ``(epoch, w)`` (per-sample RNG inside the
      source dataset is keyed ``(seed, epoch, idx)``), so **no packer state
      needs checkpointing** — resume-by-index is exact by construction, the
      same stateless-data design the reference chose for CPT interleaving
      (ref: plans/Checkpointing - Consolidated Plan.md §D6).
    - Every full window is clamped/cycled to the pack count ``P`` of window 0
      at epoch 0 (the calibration window); the final window, if partial, gets
      a PRORATED quota ``round(P * tail/window)`` and always iterates last.
      ``len(self)`` is the constant ``(n_windows-1)*P + P_tail`` — required by
      TrainingGeometry's steps_per_epoch and by the resume arithmetic. With
      hundreds of samples per window the per-window pack-count deviation is
      ~1/sqrt(window), so clamp waste and cycle duplication stay in the low
      percent for full AND partial windows alike.
    - Only the most recently packed windows are cached (O(window) memory).

    Shuffling: global index shuffling would touch a different window every
    item, so the loader must use a sequential sampler and set
    ``shuffle=True`` HERE: the dataset then applies an epoch-seeded
    hierarchical permutation — window order, then pack order within each
    window — i.e. a shuffle-buffer of ``window`` samples, the standard
    streaming-pipeline trade. Sequential (or strided per-rank) index access
    then sweeps one permuted window at a time, preserving cache locality.
    """

    _CACHE_WINDOWS = 2

    def __init__(
        self,
        dataset: Any,
        max_seq_len: int,
        pad_id: int,
        window: int = 2048,
        split_across_pack: bool = False,
        drop_long: bool = True,
        shuffle: bool = False,
        seed: int = 0,
    ) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.dataset = dataset
        self.max_seq_len = int(max_seq_len)
        self.pad_id = int(pad_id)
        self.window = int(window)
        self.split_across_pack = split_across_pack
        self.drop_long = drop_long
        self.shuffle = shuffle
        self.seed = int(seed)
        self._epoch = 0
        self._cache: dict[tuple[int, int], list[dict[str, np.ndarray]]] = {}
        self._perm_epoch: int | None = None
        self._window_perm: np.ndarray | None = None
        self._offset_perms: dict[int, np.ndarray] = {}
        self.n_windows = max(1, -(-len(dataset) // self.window))
        calibration = self._pack_window(0)
        if not calibration:
            raise ValueError("Calibration window packed to zero rows (empty dataset?)")
        self.packs_per_window = len(calibration)
        # The final window may be partial (len % window samples). Prorate its
        # pack quota instead of cycling its few samples up to a full window's
        # share — at 2049 samples / window 2048 the tail would otherwise
        # duplicate ONE sample into half the epoch's tokens.
        tail_samples = len(dataset) - (self.n_windows - 1) * self.window
        if self.n_windows > 1 and tail_samples < self.window:
            self.packs_tail = max(1, round(self.packs_per_window * tail_samples / self.window))
        else:
            self.packs_tail = self.packs_per_window
        self._cache[(0, 0)] = calibration
        LOGGER.info(
            f"Windowed packing: {len(dataset)} samples, {self.n_windows} windows of {self.window}, "
            f"{self.packs_per_window} packs/window (calibrated), tail {self.packs_tail}, len={len(self)}"
        )

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        if epoch != self._epoch:
            self._epoch = epoch
            self._cache.clear()

    def __len__(self) -> int:
        return (self.n_windows - 1) * self.packs_per_window + self.packs_tail

    def _quota(self, w: int) -> int:
        return self.packs_tail if w == self.n_windows - 1 else self.packs_per_window

    def _pack_window(self, w: int) -> list[dict[str, np.ndarray]]:
        lo = w * self.window
        hi = min(lo + self.window, len(self.dataset))
        samples = (self.dataset[i] for i in range(lo, hi))
        return greedy_pack(
            samples,
            max_seq_len=self.max_seq_len,
            pad_id=self.pad_id,
            split_across_pack=self.split_across_pack,
            drop_long=self.drop_long,
        )

    def _window_packs(self, w: int) -> list[dict[str, np.ndarray]]:
        key = (self._epoch, w)
        if key not in self._cache:
            packs = self._pack_window(w)
            if not packs:
                raise ValueError(f"Window {w} (epoch {self._epoch}) packed to zero rows")
            quota = self._quota(w)
            if len(packs) > quota:
                packs = packs[:quota]
            elif len(packs) < quota:
                base = list(packs)
                i = 0
                while len(packs) < quota:  # cycle distinct packs
                    packs.append(base[i % len(base)])
                    i += 1
            if len(self._cache) >= self._CACHE_WINDOWS:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = packs
        return self._cache[key]

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        index = int(index)
        if not 0 <= index < len(self):
            raise IndexError(index)
        # the (possibly prorated) tail window is always LAST in iteration
        # order — uniform divmod indexing for the rest, shuffled or not
        tail_start = (self.n_windows - 1) * self.packs_per_window
        if index >= tail_start:
            q, r = self.n_windows - 1, index - tail_start
        else:
            q, r = divmod(index, self.packs_per_window)
        if self.shuffle:
            if self._perm_epoch != self._epoch:
                # permute the full windows; the partial tail stays last so the
                # per-position window size is independent of the permutation
                self._window_perm = np.concatenate([
                    np.random.default_rng((self.seed, self._epoch)).permutation(self.n_windows - 1),
                    np.asarray([self.n_windows - 1], dtype=np.int64),
                ])
                self._offset_perms = {}
                self._perm_epoch = self._epoch
            w = int(self._window_perm[q])
            if w not in self._offset_perms:
                if len(self._offset_perms) > 2 * self._CACHE_WINDOWS:
                    self._offset_perms.clear()
                self._offset_perms[w] = np.random.default_rng(
                    (self.seed, self._epoch, w)
                ).permutation(self._quota(w))
            r = int(self._offset_perms[w][r])
        else:
            w = q
        return self._window_packs(w)[r]


def padded_collate_packed(batch: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Stack fixed-length packs into [B, S] arrays (no padding needed)."""
    return {key: np.stack([row[key] for row in batch]) for key in ("tokens", "labels", "segment_ids", "positions")}
