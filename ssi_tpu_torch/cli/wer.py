"""Word Error Rate from model generations — the port's twin of ``scripts/wer.py``
(ref: scripts/wer.py:30-78).

Usage::

    python -m ssi_tpu_torch.cli.wer <.../<dataset>/<split>/generations.jsonl> [--dataset D] [--split S]
        [--gt_transcript_colname transcript] [--normalizer whisper|none]

The same CLI surface: positional generations.jsonl, dataset/split inferred
from the path layout when not given, refuses to clobber an existing
wer.json. The reference transcripts come from the HF hub, which the port
does not read yet: that read raises ``NotImplementedError`` naming ROADMAP
A12 (score local transcripts with ``python -m ssi_tpu_torch.cli.wer_parity
--skip-generate <dir> --refs-jsonl <file>``). Scoring runs on the host; no
card is needed.
"""

from argparse import ArgumentParser, Namespace
import json
import logging
import os
from pathlib import Path
from pprint import pformat
import sys

from ssi_tpu_torch.constants import SUPPORTED_DATASETS
from ssi_tpu_torch.eval import english_normalizer, word_error_rate
from ssi_tpu_torch.utils import extract_texts_from_generations_jsonl, ref_from_hf_dataset

LOGGER = logging.getLogger(__name__)

_KNOWN_SPLITS = frozenset({"train", "dev", "test", "validation"})


def parse_args(argv: list[str] | None = None) -> Namespace:
    parser = ArgumentParser(description="Score generations.jsonl against reference transcripts (WER).")
    parser.add_argument("generations_jsonl", type=Path,
                        help="generations.jsonl produced by python -m ssi_tpu_torch.cli.generate")
    parser.add_argument("--dataset", type=str, help="HF dataset holding the ground-truth transcripts")
    parser.add_argument("--split", type=str, help="split of --dataset to score against")
    parser.add_argument(
        "--gt_transcript_colname",
        type=str,
        default="transcript",
        help="dataset column containing the ground-truth transcript",
    )
    parser.add_argument(
        "--normalizer", type=str, default="whisper", choices=["whisper", "none"], help="text normalizer to apply"
    )
    return parser.parse_args(argv)


def _infer_dataset_and_split(args: Namespace) -> None:
    """Fill args.dataset/args.split from the generations path when absent.

    Expected layout .../<dataset>/<split>/generations.jsonl, optionally with a
    trailing cfg-hash directory: .../<dataset>/<split>/<hash>/generations.jsonl.
    """
    parents = args.generations_jsonl.parents
    shift = 0 if parents[0].name in _KNOWN_SPLITS or parents[1].name not in _KNOWN_SPLITS else 1
    if args.dataset is None:
        args.dataset = parents[1 + shift].name
        if args.dataset.split("-")[0] not in SUPPORTED_DATASETS:
            raise ValueError(
                f"Path-derived dataset {args.dataset!r} is unknown (supported: "
                f"{sorted(SUPPORTED_DATASETS)}); pass --dataset explicitly."
            )
        LOGGER.info(f"Inferred dataset from path: {args.dataset}")
    if args.split is None:
        args.split = parents[shift].name
        LOGGER.info(f"Inferred split from path: {args.split}")


def main(args: Namespace) -> None:
    wer_json = args.generations_jsonl.parent / "wer.json"
    if wer_json.exists():
        existing = pformat(json.loads(wer_json.read_text()))
        raise FileExistsError(f"Refusing to overwrite {wer_json} — existing contents:\n{existing}")
    _infer_dataset_and_split(args)
    generated = extract_texts_from_generations_jsonl(args.generations_jsonl)
    reference = ref_from_hf_dataset(args.dataset, args.split, args.gt_transcript_colname)
    artifact = {}
    if args.normalizer == "whisper":
        from ssi_tpu_torch.eval.wer import spelling_mapping_fingerprint, suspected_unmapped_words

        normalize = english_normalizer()
        generated = [normalize(text) for text in generated]
        reference = [normalize(text) for text in reference]
        # pin the vendored map + quantify the residual normalizer divergence:
        # words still British-shaped AFTER normalization either slipped through
        # the (reconstructed) spelling map or are heuristic false positives
        suspects = suspected_unmapped_words(generated + reference)
        artifact |= spelling_mapping_fingerprint()
        artifact["suspected_unmapped_words"] = sum(suspects.values())
        artifact["suspected_unmapped_distinct"] = len(suspects)
        artifact["suspected_unmapped_examples"] = dict(list(suspects.items())[:20])
    else:
        LOGGER.info("Normalization disabled; scoring raw text.")
    wer = word_error_rate(references=reference, hypotheses=generated)
    with open(wer_json, "x") as f:
        json.dump({"wer": wer} | artifact, f, indent=4)
    LOGGER.info(f"WER {wer:.5f} -> {wer_json}")


if __name__ == "__main__":
    logging.basicConfig(
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
        level=os.environ.get("LOG_LEVEL", "INFO").upper(),
        stream=sys.stdout,
        force=True,
    )
    main(parse_args())
