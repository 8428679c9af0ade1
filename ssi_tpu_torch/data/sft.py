"""SFT (ASR instruction) dataset: DSU speech-token input -> transcript output —
the port's copy of ``ssi_tpu/data/sft.py``, over a list of row dicts (from
``ssi_tpu_torch.data``) instead of a ``datasets.Dataset``;
``tests/test_torch_data.py`` holds its rows equal to the original's.

Behavioural rebuild of the reference SFT dataset (ref: ssi/data/sft.py:25-345)
without torch/torchtune: rows with "input" (speech token IDs) and "output"
(transcript) columns become user/assistant messages; user-side tokens are
loss-masked unless ``train_on_input``; inference mode leaves the assistant content
empty and omits end tokens so the sequence stays open for generation.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from itertools import groupby
import logging
from typing import Any

import numpy as np

from ssi_tpu_torch.constants import CROSS_ENTROPY_IGNORE_IDX, RESERVED_BATCH_KEYS
from ssi_tpu_torch.speech import MODALITY_TOKEN_SPEECH, MODALITY_TOKEN_TEXT, dsu2pua
from ssi_tpu_torch.tokenizer import Llama3Tokenizer
from ssi_tpu_torch.tokenizer.messages import Message, validate_messages

LOGGER = logging.getLogger(__name__)


class SFTDataset:
    """Supervised fine-tuning dataset (ref: ssi/data/sft.py:25-231).

    Args:
        source: local data-file type (``"json"``; see ``ssi_tpu_torch.data``).
        model_tokenizer: project tokenizer; must return ``tokens`` and ``mask``.
        inference: leave assistant content empty (generation mode).
        deduplicate: drop consecutive duplicate speech tokens.
        use_modality_tokens: wrap the speech span with modality boundary tokens.
        n_samples: if set, stream only the first N rows.
        filter_fn: optional row filter applied before preprocessing.
        train_on_input: include user-prompt tokens in the loss.
        column_map: remap of the expected ``input``/``output`` column names.
        new_system_prompt: optional system message prepended to each sample.
        additional_keys: extra dataset columns passed through per sample.
        **load_dataset_kwargs: ``data_files`` and ``split``, as ``datasets.load_dataset`` takes them.
    """

    def __init__(
        self,
        *,
        source: str,
        model_tokenizer: Llama3Tokenizer,
        inference: bool = False,
        deduplicate: bool,
        use_modality_tokens: bool,
        n_samples: int | None = None,
        filter_fn: Callable | None = None,
        train_on_input: bool,
        column_map: dict[str, str] | None = None,
        new_system_prompt: str | None = None,
        additional_keys: list[str] | None = None,
        **load_dataset_kwargs: Any,
    ) -> None:
        if additional_keys is None:
            additional_keys = []
        self._message_transform = InputOutputToMessages(
            train_on_input=train_on_input,
            column_map=column_map,
            new_system_prompt=new_system_prompt,
        )
        self._model_tokenizer = model_tokenizer
        from ssi_tpu_torch.data import load_dataset_subset, load_hf_dataset

        if n_samples is not None:
            # filter rides on the stream BEFORE the take: "first n MATCHING rows"
            self._data = load_dataset_subset(source, n_samples, filter_fn=filter_fn, **load_dataset_kwargs)
            filter_fn = None
        else:
            self._data = load_hf_dataset(source, **load_dataset_kwargs)
        if not isinstance(self._data, list):
            raise TypeError(f"Expected a list of rows but found {type(self._data)}")
        features = set().union(*self._data) if self._data else set()
        if any((k in features) for k in RESERVED_BATCH_KEYS):
            raise ValueError(f"Dataset contains reserved keys: {RESERVED_BATCH_KEYS}")
        if filter_fn is not None:
            self._data = [row for row in self._data if filter_fn(row)]
        self._inference = inference
        self._deduplicate = deduplicate
        self._use_modality_tokens = use_modality_tokens
        self.additional_keys = additional_keys

    # Typed setters mirror ref: ssi/data/sft.py:158-186 (generate.py flips inference).

    @property
    def inference(self) -> bool:
        return self._inference

    @inference.setter
    def inference(self, value: bool) -> None:
        if not isinstance(value, bool):
            raise ValueError("inference must be a boolean.")
        self._inference = value

    @property
    def deduplicate(self) -> bool:
        return self._deduplicate

    @deduplicate.setter
    def deduplicate(self, value: bool) -> None:
        if not isinstance(value, bool):
            raise TypeError("deduplicate must be a boolean.")
        self._deduplicate = value

    @property
    def use_modality_tokens(self) -> bool:
        return self._use_modality_tokens

    @use_modality_tokens.setter
    def use_modality_tokens(self, value: bool) -> None:
        if not isinstance(value, bool):
            raise TypeError("use_modality_tokens must be a boolean.")
        self._use_modality_tokens = value

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, index: int) -> dict[str, Any]:
        sample = self._data[int(index)]
        return self._prepare_sample(sample) | {k: sample[k] for k in self.additional_keys}

    def _prepare_sample(self, sample: Mapping[str, Any]) -> dict[str, Any]:
        transformed_sample = self._message_transform(
            sample,
            deduplicate=self._deduplicate,
            use_modality_tokens=self._use_modality_tokens,
            inference=self._inference,
        )
        if "messages" in transformed_sample:
            validate_messages(transformed_sample["messages"])

        tokenized_dict = self._model_tokenizer(transformed_sample, inference=self._inference)

        if not ("tokens" in tokenized_dict and "mask" in tokenized_dict):
            keys_str = ", ".join(tokenized_dict.keys())
            raise ValueError(
                f"model_tokenizer returned the following keys: {keys_str}. Must return 'tokens' and 'mask' as keys."
            )

        # mask == True -> excluded from loss (ref: ssi/data/sft.py:222-228)
        tokenized_dict["labels"] = list(
            np.where(tokenized_dict["mask"], CROSS_ENTROPY_IGNORE_IDX, tokenized_dict["tokens"])
        )
        assert len(tokenized_dict["tokens"]) == len(tokenized_dict["labels"])
        return tokenized_dict


class InputOutputToMessages:
    """Convert an input/output row to user/assistant messages (ref: ssi/data/sft.py:234-345).

    The ``input`` column holds speech token IDs; they are rendered as a span of PUA
    characters, optionally wrapped ``MODALITY_SPEECH + span + MODALITY_TEXT``
    (text follows — the next tokens are the assistant message header).
    """

    def __init__(
        self,
        train_on_input: bool,
        column_map: dict[str, str] | None = None,
        new_system_prompt: str | None = None,
    ) -> None:
        self.train_on_input = train_on_input
        self.new_system_prompt = new_system_prompt
        if column_map is not None:
            if "input" not in column_map:
                raise ValueError(f"Expected a key of 'input' in column_map but found {column_map.keys()}.")
            if "output" not in column_map:
                raise ValueError(f"Expected a key of 'output' in column_map but found {column_map.keys()}.")
            self.column_map = column_map
        else:
            self.column_map = {"input": "input", "output": "output"}

    def __call__(
        self,
        sample: Mapping[str, Any],
        *,
        deduplicate: bool,
        use_modality_tokens: bool,
        inference: bool,
    ) -> Mapping[str, Any]:
        sp_tkns = sample[self.column_map["input"]]
        if deduplicate:
            sp_tkns = [k for k, _ in groupby(sp_tkns)]
        sp_span = "".join(map(dsu2pua, sp_tkns))
        if use_modality_tokens:
            sp_span = MODALITY_TOKEN_SPEECH + sp_span + MODALITY_TOKEN_TEXT
        content = [{"type": "text", "content": sp_span}]
        if inference:
            output_content = [{"type": "text", "content": ""}]
        else:
            output_content = [{"type": "text", "content": sample[self.column_map["output"]]}]
        messages = [
            Message(role="user", content=content, masked=not self.train_on_input, eot=True),
            Message(role="assistant", content=output_content, masked=False, eot=True),
        ]
        if self.new_system_prompt is not None:
            messages = [Message(role="system", content=self.new_system_prompt, masked=True, eot=True), *messages]
        return {"messages": messages}
