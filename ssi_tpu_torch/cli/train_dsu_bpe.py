"""Train BPE merges over DSU (speech-token) sequences for compressed-DSU runs —
the port's twin of ``scripts/train_dsu_bpe.py``.

Usage::

    python -m ssi_tpu_torch.cli.train_dsu_bpe <out_dir> --dataset json --data-files <rows.jsonl> \\
        --n-merges 4096 [--deduplicate] [--split train] [--speech-tokens-key speech_tokens] [--n-samples N]

Reads aligned rows through the port's loader, streamed: ``--dataset`` one
of ``json``, ``parquet`` and ``csv`` with ``--data-files``, or a local
dataset directory (hub ids and the ``text`` source raise naming ROADMAP
item A12), converts each row's speech tokens to the PUA string form via
``ssi_tpu_torch.speech.dsu2pua``, trains byte-level BPE with
whole-sequence pieces (merges span adjacent DSUs — the point of
compression), and writes a ``tokenizer.model``-format merges file plus a
stats JSON with the achieved compression ratio, byte for byte the files
the JAX script writes (``tests/test_torch_bpe_train.py``). Host code only:
it touches no device.

The merges file is appended to a base tokenizer by
``ssi_tpu_torch.tokenizer.bpe_train.merge_into_tokenizer``; a compressed
run loads it with ``tokenizer.pattern: cl100k`` (``docs/COMPRESSED_DSU.md``).
"""

from argparse import ArgumentParser, Namespace
from itertools import groupby
import json
import logging
import os
from pathlib import Path
import sys

from ssi_tpu_torch.speech import SPEECH_TOKENS_KEY, dsu2pua
from ssi_tpu_torch.tokenizer.bpe_train import compression_ratio, save_ranks, train_bpe

LOGGER = logging.getLogger(__name__)


def parse_args(argv: list[str] | None = None) -> Namespace:
    parser = ArgumentParser(description="Train BPE merges over DSU sequences.")
    parser.add_argument("output_dir", type=Path, help="Directory for tokenizer.model + stats.json.")
    parser.add_argument("--dataset", type=str, required=True,
                        help="Dataset source: 'json', 'parquet' or 'csv' (with --data-files), or a local "
                        "dataset directory; hub ids are not ported (A12).")
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--data-files", type=str, default=None, help="data_files for json/csv sources.")
    parser.add_argument("--n-merges", type=int, default=4096, help="Number of merges to learn.")
    parser.add_argument("--n-samples", type=int, default=None, help="Cap on corpus rows (streamed).")
    parser.add_argument("--speech-tokens-key", type=str, default=SPEECH_TOKENS_KEY)
    parser.add_argument("--min-pair-count", type=int, default=2)
    parser.add_argument(
        "--deduplicate",
        action="store_true",
        help="Collapse consecutive duplicate DSUs before training, matching the data "
        "pipeline's `speech.deduplicate` (default true there). Merges trained on raw "
        "streams mostly capture hold-repeats that deduplication removes at training "
        "time, so they never fire — set this whenever the consuming run deduplicates.",
    )
    return parser.parse_args(argv)


def dsu_corpus(args: Namespace) -> list[str]:
    from ssi_tpu_torch.data import load_hf_dataset

    kwargs = {"split": args.split, "streaming": True}
    if args.data_files:
        kwargs["data_files"] = args.data_files
    ds = load_hf_dataset(args.dataset, **kwargs)
    corpus: list[str] = []
    for i, row in enumerate(ds):
        if args.n_samples is not None and i >= args.n_samples:
            break
        toks = row[args.speech_tokens_key]
        if isinstance(toks, str):
            toks = [int(t) for t in toks.split()]
        if args.deduplicate:
            toks = [k for k, _ in groupby(toks)]
        corpus.append("".join(dsu2pua(int(t)) for t in toks))
    if not corpus:
        raise ValueError(f"No rows with key {args.speech_tokens_key!r} in {args.dataset}:{args.split}")
    return corpus


def main(args: Namespace) -> dict:
    """Writes ``tokenizer.model`` and ``stats.json`` under ``args.output_dir``;
    returns the stats."""
    args.output_dir.mkdir(parents=True, exist_ok=True)
    out_model = args.output_dir / "tokenizer.model"
    if out_model.exists():
        raise FileExistsError(f"Output merges file already exists: {out_model}")

    corpus = dsu_corpus(args)
    n_dsu_tokens = sum(len(c) for c in corpus)
    LOGGER.info(f"Training {args.n_merges} merges over {len(corpus)} rows / {n_dsu_tokens} DSUs")
    ranks = train_bpe(corpus, args.n_merges, split_pattern=None, min_pair_count=args.min_pair_count)
    save_ranks(ranks, out_model)
    ratio = compression_ratio(corpus, ranks)
    stats = {
        "n_rows": len(corpus),
        "deduplicate": args.deduplicate,
        "n_dsu_tokens": n_dsu_tokens,
        "n_merges_learned": len(ranks) - 256,
        "vocab_size": len(ranks),
        "compression_ratio_chars_per_token": round(ratio, 4),
    }
    (args.output_dir / "stats.json").write_text(json.dumps(stats, indent=2))
    LOGGER.info(f"Wrote {out_model} ({len(ranks)} ranks); compression {ratio:.3f} chars/token")
    return stats


if __name__ == "__main__":
    logging.basicConfig(
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
        level=os.environ.get("LOG_LEVEL", "INFO").upper(),
        stream=sys.stdout,
        force=True,
    )
    main(parse_args())
