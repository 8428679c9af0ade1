"""Completion-style CPT dataset: interleaved / concatenated speech-text sequences —
the port's copy of ``ssi_tpu/data/cpt.py``, over a list of row dicts (from
``ssi_tpu_torch.data``) instead of a ``datasets.Dataset``;
``tests/test_torch_train_data.py`` holds its batches equal to the original's.

Behavioural rebuild of the reference CPT dataset (ref: ssi/data/cpt.py:30-222) with
identical randomness semantics: a fresh ``np.random.default_rng((seed, epoch, index))``
per sample, binomial span boundaries, 50/50 start-with-text choice, consecutive-DSU
dedup via groupby, and alignment-time -> DSU-index conversion.

Differences from the reference (deliberate):
- the ``*_key`` column-name options are actually honoured (the reference resolves
  them and then ignores them);
- no torch ``Dataset`` base class; this is a plain indexable object consumed by the
  host-side :class:`ssi_tpu_torch.data.Loader`.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from enum import Enum
from functools import partial
from itertools import groupby, zip_longest
import logging
from typing import Any

import numpy as np

from ssi_tpu_torch.constants import SEED
from ssi_tpu_torch.speech import (
    ALIGNMENT_END_TIME_KEY,
    ALIGNMENT_START_TIME_KEY,
    MODALITY_TOKEN_SPEECH,
    MODALITY_TOKEN_TEXT,
    SPEECH_TOKENS_KEY,
    TOKENIZED_KEY,
    dsu2pua,
    times_to_dsu_idxs,
)
from ssi_tpu_torch.tokenizer import Llama3Tokenizer, truncate

LOGGER = logging.getLogger(__name__)


class CompletionSequenceType(Enum):
    INTERLEAVED = "interleaved"
    CONCATENATED_TXT_DSU = "concatenated_txt_dsu"
    CONCATENATED_DSU_TXT = "concatenated_dsu_txt"

    # Declared but left unimplemented by the reference (ref: ssi/data/cpt.py:36-38);
    # implemented here per the reference's own enum comments: DSU-only sequences,
    # regular text completion, and per-sample alternation between the two.
    DSU_ONLY = "dsu_only"
    TEXT_ONLY = "text_only"
    ALTERNATING = "alternating"


class TextCompletionDataset:
    """Builds tokenized completion sequences from aligned speech-text rows.

    Args:
        tokenizer: project tokenizer used to encode the constructed prompt string.
        source: local data-file type (``"json"``; see ``ssi_tpu_torch.data``).
        split: dataset split.
        sequence_type: one of :class:`CompletionSequenceType` values.
        deduplicate: drop consecutive duplicate speech tokens.
        use_modality_tokens: wrap spans with modality boundary tokens.
        add_eos: append EOS after the sequence.
        n_samples: if set, stream only the first N samples.
        *_key: dataset column names (``None`` -> project defaults).
        filter_fn: optional row filter applied before any preprocessing.
        interleave_kwargs: required for the interleaved sequence type
            (sampling_rate, downsampling_ratio, mean_seq_len_tokens, binom_prob).
    """

    def __init__(
        self,
        tokenizer: Llama3Tokenizer,
        source: str,
        split: str,
        sequence_type: str,
        deduplicate: bool,
        use_modality_tokens: bool,
        add_eos: bool = True,
        n_samples: int | None = None,
        tokenized_key: str | None = None,
        alignment_start_time_key: str | None = None,
        alignment_end_time_key: str | None = None,
        speech_tokens_key: str | None = None,
        filter_fn: Callable | None = None,
        interleave_kwargs: dict[str, Any] | None = None,
        additional_keys: list[str] | None = None,
        **load_dataset_kwargs: Any,
    ) -> None:
        self._tokenizer = tokenizer
        from ssi_tpu_torch.data import load_dataset_subset, load_hf_dataset

        if n_samples is not None:
            # filter rides on the stream BEFORE the take: "first n MATCHING rows"
            self._data = load_dataset_subset(
                source, n_samples, filter_fn=filter_fn, split=split, **load_dataset_kwargs
            )
            filter_fn = None
        else:
            self._data = load_hf_dataset(source, split=split, **load_dataset_kwargs)
        self.add_eos = add_eos

        self.keys = {
            "tokenized": tokenized_key or TOKENIZED_KEY,
            "t_starts": alignment_start_time_key or ALIGNMENT_START_TIME_KEY,
            "t_ends": alignment_end_time_key or ALIGNMENT_END_TIME_KEY,
            "speech_tokens": speech_tokens_key or SPEECH_TOKENS_KEY,
        }

        self.sequence_type = CompletionSequenceType(sequence_type)
        if self.sequence_type is CompletionSequenceType.INTERLEAVED:
            if not interleave_kwargs:
                raise ValueError("interleave_kwargs must be provided for interleaved sequence type")
            self.prompt_fn = partial(interleave, keys=self.keys, **interleave_kwargs)
        elif self.sequence_type is CompletionSequenceType.CONCATENATED_TXT_DSU:
            self.prompt_fn = partial(concatenate_speech_text, keys=self.keys, start_with_text=True)
        elif self.sequence_type is CompletionSequenceType.CONCATENATED_DSU_TXT:
            self.prompt_fn = partial(concatenate_speech_text, keys=self.keys, start_with_text=False)
        elif self.sequence_type is CompletionSequenceType.DSU_ONLY:
            self.prompt_fn = partial(single_modality, keys=self.keys, modality="dsu")
        elif self.sequence_type is CompletionSequenceType.TEXT_ONLY:
            self.prompt_fn = partial(single_modality, keys=self.keys, modality="text")
        elif self.sequence_type is CompletionSequenceType.ALTERNATING:
            self.prompt_fn = partial(alternating, keys=self.keys)
        else:
            raise ValueError(f"Unsupported sequence type: {self.sequence_type}")

        self.deduplicate = deduplicate
        self.use_modality_tokens = use_modality_tokens
        # extra dataset columns passed through per sample (the collate forwards
        # them un-padded — links samples to ground truth, e.g. IDs for ASR).
        # The reference DECLARES this on the CPT collate but its dataset crashes
        # on the kwarg (ref: ssi/data/__init__.py:80 vs ssi/data/cpt.py:41).
        self.additional_keys = list(additional_keys or [])
        self._seed = SEED
        self._epoch = 0

        if filter_fn is not None:
            self._data = [row for row in self._data if filter_fn(row)]

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, index: int) -> dict[str, list[int]]:
        sample = self._data[int(index)]
        # Per-sample deterministic RNG: order-independent, resumable by construction
        # (ref: ssi/data/cpt.py:124-127).
        rng = np.random.default_rng((self._seed, self._epoch, int(index)))
        return self._prepare_sample(sample, rng)

    def _prepare_sample(self, sample: Mapping[str, Any], rng: np.random.Generator) -> dict[str, list[int]]:
        prompt = self.prompt_fn(
            sample=sample,
            deduplicate=self.deduplicate,
            use_modality_tokens=self.use_modality_tokens,
            rng=rng,
        )
        tokens = self._tokenizer.encode(text=prompt, add_bos=True, add_eos=self.add_eos)
        # Truncate without coercing EOS; the -1 matches the reference exactly
        # (ref: ssi/data/cpt.py:147-149).
        if self._tokenizer.max_seq_len is not None:
            tokens = truncate(tokens, self._tokenizer.max_seq_len - 1)
        labels = tokens.copy()
        out = {"tokens": tokens, "labels": labels}
        for key in self.additional_keys:
            out[key] = sample[key]
        return out


def get_span_idxs_binomial(n: int, p: float, seq_len: int, rng: np.random.Generator) -> list[int]:
    """Cumulative span boundaries from binomial draws, lower-bounded at 1 per span."""
    subspan_idxs = np.maximum(rng.binomial(n, p, size=seq_len), 1).cumsum()
    return [0, *subspan_idxs[subspan_idxs < seq_len].tolist(), seq_len]


def interleave(
    sample: dict[str, Any],
    deduplicate: bool,
    use_modality_tokens: bool,
    *,
    rng: np.random.Generator,
    sampling_rate: int,
    downsampling_ratio: int,
    mean_seq_len_tokens: float,
    binom_prob: float,
    keys: dict[str, str],
) -> str:
    """Alternate text spans and DSU spans over a single aligned utterance."""
    start_with_text = rng.choice([True, False], p=[0.5, 0.5])
    tokens = sample[keys["tokenized"]]
    align_t_starts = sample[keys["t_starts"]]
    align_t_ends = sample[keys["t_ends"]]
    speech_tokens: list[int] = sample[keys["speech_tokens"]]
    span_idxs = get_span_idxs_binomial(int(mean_seq_len_tokens), binom_prob, len(tokens), rng=rng)
    idxs1 = zip(span_idxs[:-1:2], span_idxs[1::2])
    idxs2 = zip(span_idxs[1:-1:2], span_idxs[2::2])
    text_idxs, dsu_idxs = (idxs1, idxs2) if start_with_text else (idxs2, idxs1)
    text_spans: list[str] = [" ".join(tokens[start_idx:end_idx]) for start_idx, end_idx in text_idxs]
    dsu_spans: list[str] = []
    for start_idx, end_idx in dsu_idxs:
        start_idx_dsu, end_idx_dsu = times_to_dsu_idxs(
            (align_t_starts[start_idx], align_t_ends[end_idx - 1]),
            sampling_rate,
            downsampling_ratio,
        )
        sp_tkns_spn = speech_tokens[start_idx_dsu:end_idx_dsu]
        if deduplicate:
            sp_tkns_spn = [k for k, _ in groupby(sp_tkns_spn)]
        dsu_spans.append("".join([dsu2pua(sp_tkn) for sp_tkn in sp_tkns_spn]))

    if use_modality_tokens:
        text_spans = [" ".join((MODALITY_TOKEN_TEXT, text_span)) for text_span in text_spans]
        dsu_spans = [" ".join((MODALITY_TOKEN_SPEECH, dsu_span)) for dsu_span in dsu_spans]

    mm_spans = (text_spans, dsu_spans) if start_with_text else (dsu_spans, text_spans)
    return " ".join([span for spans in zip_longest(*mm_spans) for span in spans if span is not None])


def single_modality(
    sample: dict[str, Any],
    deduplicate: bool,
    use_modality_tokens: bool,
    *,
    rng: np.random.Generator,  # unused; uniform prompt_fn(..., rng=rng) interface
    modality: str,
    keys: dict[str, str],
) -> str:
    """Whole-utterance single-modality sequence: ``dsu_only`` / ``text_only``
    (declared by the reference enum, ref: ssi/data/cpt.py:36-37). Span
    construction matches the corresponding half of ``concatenate_speech_text``
    exactly (dedup, PUA mapping, modality-token prefixing)."""
    if modality == "text":
        text: str = " ".join(sample[keys["tokenized"]])
        return " ".join((MODALITY_TOKEN_TEXT, text)) if use_modality_tokens else text
    speech_tokens: list[int] = sample[keys["speech_tokens"]]
    if deduplicate:
        speech_tokens = [k for k, _ in groupby(speech_tokens)]
    dsus_str: str = "".join([dsu2pua(sp_tkn) for sp_tkn in speech_tokens])
    return " ".join((MODALITY_TOKEN_SPEECH, dsus_str)) if use_modality_tokens else dsus_str


def alternating(
    sample: dict[str, Any],
    deduplicate: bool,
    use_modality_tokens: bool,
    *,
    rng: np.random.Generator,
    keys: dict[str, str],
) -> str:
    """Per-sample 50/50 alternation between text-only and DSU-only sequences
    (ref enum comment, ssi/data/cpt.py:38). Uses the same per-sample RNG
    discipline as ``interleave``'s start_with_text draw — the choice is a pure
    function of (seed, epoch, index), so it is order-independent and
    resume-exact."""
    use_text = bool(rng.choice([True, False], p=[0.5, 0.5]))
    return single_modality(
        sample, deduplicate, use_modality_tokens, rng=rng,
        modality="text" if use_text else "dsu", keys=keys,
    )


def concatenate_speech_text(
    sample: dict[str, Any],
    deduplicate: bool,
    use_modality_tokens: bool,
    *,
    rng: np.random.Generator,  # unused; uniform prompt_fn(..., rng=rng) interface
    start_with_text: bool,
    keys: dict[str, str],
) -> str:
    """Whole-utterance text and DSU block, concatenated in either order."""
    speech_tokens: list[int] = sample[keys["speech_tokens"]]
    if deduplicate:
        speech_tokens = [k for k, _ in groupby(speech_tokens)]
    text: str = " ".join(sample[keys["tokenized"]])
    dsus_str: str = "".join([dsu2pua(sp_tkn) for sp_tkn in speech_tokens])
    if use_modality_tokens:
        text = " ".join((MODALITY_TOKEN_TEXT, text))
        dsus_str = " ".join((MODALITY_TOKEN_SPEECH, dsus_str))
    return " ".join((text, dsus_str) if start_with_text else (dsus_str, text))
