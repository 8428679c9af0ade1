"""First-party BPE trainer — the port's copy of ``ssi_tpu/tokenizer/bpe_train.py``
(the DSU-compression axis), with no tiktoken:
``tests/test_torch_bpe_train.py`` holds its ranks, files and floats equal
to the JAX package's.

It trains byte-level BPE merges in the exact ``tokenizer.model`` format the
tokenizer stack loads, so a compressed-DSU vocabulary plugs into the
extend -> train -> generate pipeline unchanged.

Two modes, selected by ``split_pattern``:

- ``None`` (DSU compression): each corpus line is ONE piece, so merges freely
  span adjacent DSU codepoints — exactly what compression needs. A
  compressed-DSU tokenizer must be loaded with ``pattern=CL100K_PATTERN``
  (``tokenizer.pattern: cl100k``), which does not split ``\\p{Co}``, if
  merged-DSU tokens are to fire at encode time.
- a regex (text mode): pieces are the pattern's matches, reproducing standard
  GPT-style training semantics (merges never cross piece boundaries). The two
  cl100k patterns split in the C++ scanner (``ssi_tpu_torch/native``); any
  other is matched by the ``regex`` package, as in the JAX trainer (not by
  Python's ``re``, whose ``\\s`` also matches U+001C-U+001F: fault C8).

Training is the classic frequency-table algorithm with incremental pair-count
updates (only the counts touched by a merge are adjusted), so cost scales with
corpus *vocabulary*, not corpus length, per merge. It is the JAX trainer's
algorithm and tie-break, with one change of representation: the JAX trainer
keys its pair -> words sets by the word tuples, so every set operation hashes
a whole word (a DSU row of hundreds of bytes), and merges two words that a
merge makes equal; here each distinct piece has an integer id and keeps it.
The pair counts, and so the merges and the ranks, are the same: they are sums
over the words, whatever the order in which a merge rewrites them.
"""

from __future__ import annotations

import base64
from collections import Counter
from pathlib import Path
from typing import Iterable, Iterator

from ssi_tpu_torch.native.bpe import NativeEncoding, split
from ssi_tpu_torch.tokenizer import _NATIVE_PATTERNS, compile_split_regex

__all__ = ["compression_ratio", "merge_into_tokenizer", "save_ranks", "train_bpe"]


def _pieces(corpus: Iterable[str], split_pattern: str | None) -> Iterator[bytes]:
    if split_pattern is None:
        for line in corpus:
            if line:
                yield line.encode("utf-8")
        return
    native = _NATIVE_PATTERNS.get(split_pattern)
    if native is not None:
        for line in corpus:
            for piece in split(line, native):
                yield piece.encode("utf-8")
        return
    pat = compile_split_regex(split_pattern)
    for line in corpus:
        for m in pat.finditer(line):
            yield m.group().encode("utf-8")


def train_bpe(
    corpus: Iterable[str],
    n_merges: int,
    *,
    split_pattern: str | None = None,
    min_pair_count: int = 2,
) -> dict[bytes, int]:
    """Train byte-level BPE; returns mergeable ranks {token_bytes: rank}.

    Ranks 0..255 are the byte alphabet; learned merges follow in order. Stops
    early when no pair reaches ``min_pair_count``. Ties break lexicographically
    (deterministic for a fixed corpus).
    """
    ranks: dict[bytes, int] = {bytes([i]): i for i in range(256)}

    # each distinct word (a tuple of current tokens) has an integer id, so the
    # pair -> words sets hash ints, not whole words; a merge rewrites it in place
    counted = Counter(tuple(bytes([b]) for b in piece) for piece in _pieces(corpus, split_pattern))
    words, freqs = list(counted), list(counted.values())

    pair_counts: Counter = Counter()
    pair_words: dict[tuple[bytes, bytes], set[int]] = {}
    for i, (w, freq) in enumerate(zip(words, freqs)):
        for a, b in zip(w, w[1:]):
            pair_counts[(a, b)] += freq
            pair_words.setdefault((a, b), set()).add(i)

    for rank in range(256, 256 + n_merges):
        if not pair_counts:
            break
        (a, b), cnt = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))
        if cnt < min_pair_count:
            break
        merged_tok = a + b
        ranks[merged_tok] = rank

        # rewrite only the words containing the merged pair
        affected = list(pair_words.pop((a, b), ()))
        pair_counts.pop((a, b), None)
        for i in affected:
            w, freq = words[i], freqs[i]
            # remove old pair contributions
            for pa, pb in zip(w, w[1:]):
                pair_counts[(pa, pb)] -= freq
                if pair_counts[(pa, pb)] <= 0:
                    del pair_counts[(pa, pb)]
                ws = pair_words.get((pa, pb))
                if ws is not None:
                    ws.discard(i)
                    if not ws:
                        del pair_words[(pa, pb)]
            # apply the merge left-to-right
            new_w, k = [], 0
            while k < len(w):
                if k + 1 < len(w) and w[k] == a and w[k + 1] == b:
                    new_w.append(merged_tok)
                    k += 2
                else:
                    new_w.append(w[k])
                    k += 1
            words[i] = new_w = tuple(new_w)
            for pa, pb in zip(new_w, new_w[1:]):
                pair_counts[(pa, pb)] += freq
                pair_words.setdefault((pa, pb), set()).add(i)

    return ranks


def save_ranks(ranks: dict[bytes, int], path: str | Path) -> None:
    """Write ranks in tokenizer.model format ("<base64> <rank>" lines)."""
    with open(path, "w") as f:
        for tok, rank in sorted(ranks.items(), key=lambda kv: kv[1]):
            f.write(base64.b64encode(tok).decode() + f" {rank}\n")


def compression_ratio(corpus: Iterable[str], ranks: dict[bytes, int]) -> float:
    """Mean tokens-per-codepoint improvement: len(chars) / len(tokens) under a
    greedy whole-piece encoding with the trained ranks (no split pattern: the
    C++ core's ``whole`` mode, tiktoken's ``(?s:.+)``)."""
    enc = NativeEncoding(None, pattern="whole", ranks=ranks)
    total_chars = total_tokens = 0
    for line in corpus:
        if not line:
            continue
        total_chars += len(line)
        total_tokens += len(enc.encode(line))
    return total_chars / max(1, total_tokens)


def merge_into_tokenizer(
    base_model: str | Path,
    trained_ranks: dict[bytes, int],
    output_path: str | Path,
    use_modality_tokens: bool = False,
) -> int:
    """Append trained DSU-compression merges to a base ``tokenizer.model``.

    Tokens with rank >= 256 in ``trained_ranks`` (the learned merges, which by
    BPE construction include every intermediate needed to assemble them) are
    appended after the base vocabulary with consecutive ranks, mirroring the
    PUA append of ``ssi_tpu_torch.extend.extend_tiktoken`` but for *merged*
    DSU sequences. The resulting file is the ``tokenizer.model`` of a
    compressed run; load it with ``pattern=CL100K_PATTERN`` (see
    Llama3Tokenizer) so the merges fire, and extend the model embedding by the
    RETURNED count (pass it as ``n_dsus``).

    ``use_modality_tokens``: also append the two modality tokens after the
    merges, matching ``extend_tiktoken``'s [dsu | modality] layout. Required
    when this file substitutes the tokenizer of a model extended with
    ``speech.use_modality_tokens`` (the default) — without them the specials
    land two ranks below the extended ``config.json``'s bos/eos ids and the
    modality codepoints fall back to raw UTF-8 bytes. Modality tokens do NOT
    count toward the returned ``n_dsus`` (the embedding layout accounts for
    them separately, exactly as in the uncompressed path).

    Returns the number of appended compression tokens (single-DSU + merges).
    """
    base_model = Path(base_model)
    output_path = Path(output_path)
    if output_path.exists():
        raise FileExistsError(f"Extended tokenizer output already exists at: {output_path}")
    lines = base_model.read_text().splitlines()
    existing = {base64.b64decode(line.split()[0]) for line in lines if line}
    next_rank = 1 + max(int(line.split()[1]) for line in lines if line)

    new_tokens = [tok for tok, r in sorted(trained_ranks.items(), key=lambda kv: kv[1]) if r >= 256]
    appended = 0
    with open(output_path, "w") as f:
        f.write("\n".join(lines) + "\n")
        for tok in new_tokens:
            if tok in existing:
                continue  # byte alphabet / overlap with base vocab
            f.write(base64.b64encode(tok).decode() + f" {next_rank}\n")
            next_rank += 1
            appended += 1
        if use_modality_tokens:
            from ssi_tpu_torch.speech import MODALITY_TOKEN_SPEECH, MODALITY_TOKEN_TEXT

            for tok_str in (MODALITY_TOKEN_TEXT, MODALITY_TOKEN_SPEECH):
                tok = tok_str.encode("utf-8")
                if tok in existing:
                    raise RuntimeError(f"Modality token {tok_str!r} already exists in the base vocabulary")
                f.write(base64.b64encode(tok).decode() + f" {next_rank}\n")
                next_rank += 1
    return appended
