"""Evaluation subsystem: WER + text normalization — the port's copy of
``ssi_tpu/eval``.

- :func:`word_error_rate` is a first-party corpus-level WER (total edit distance /
  total reference words), the definition jiwer/evaluate implement.
- :func:`english_normalizer` returns Whisper's ``EnglishTextNormalizer`` (vendored
  in ``whisper_normalizer.py``, so neither ``transformers`` nor ``regex`` is
  needed) with the vendored British->American spelling map
  (``english_spelling.json``).
"""

from ssi_tpu_torch.eval.wer import english_normalizer, load_spelling_mapping, word_error_rate  # noqa: F401
