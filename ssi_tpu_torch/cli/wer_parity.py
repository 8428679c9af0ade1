"""One-command WER-parity harness — the port's twin of ``scripts/wer_parity.py``:
generate over a split with the port, score WER, and write a
reference-comparable ``wer_parity.json``.

Usage::

    python -m ssi_tpu_torch.cli.wer_parity model=/path/to/step_N [key=value ...] [--refs-jsonl refs.jsonl]
    python -m ssi_tpu_torch.cli.wer_parity --skip-generate <generations dir> --refs-jsonl refs.jsonl
        [--reference-wer wer.json]

Without ``--skip-generate`` the remaining arguments go to
``python -m ssi_tpu_torch.cli.generate`` (run in this process; on the card
unless ``+device=cpu``). ``wer_parity.json`` lands next to the generations
with the same keys, and the same values on the same generations, as the JAX
script writes: the WER (the vendored Whisper normalizer and spelling map),
the run fingerprint, the suspected-unmapped-word counts, the reference
command and, with ``--reference-wer``, the delta against it. Reference
transcripts come from ``--refs-jsonl`` (JSON lines with a ``transcript``
field, or plain text, one per line); the hub read raises naming ROADMAP A12.
"""

import argparse
import json
import logging
from pathlib import Path
import sys

from ssi_tpu_torch._build import write_launch_counts

LOGGER = logging.getLogger(__name__)


def parse_args(argv: list[str]) -> tuple[argparse.Namespace, list[str]]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reference-wer", type=Path, default=None,
                    help="Path to a wer.json produced by the REFERENCE scripts/wer.py for the same generations")
    ap.add_argument("--skip-generate", type=Path, default=None, metavar="GENERATIONS_DIR",
                    help="Score an existing generations dir instead of generating")
    ap.add_argument("--refs-jsonl", type=Path, default=None,
                    help="Local reference transcripts (jsonl with a 'transcript' field, "
                         "or plain text, one per line) instead of the HF hub")
    return ap.parse_known_args(argv)


def main(argv: list[str]) -> None:
    args, overrides = parse_args(argv)

    from ssi_tpu_torch.eval import english_normalizer, load_spelling_mapping, word_error_rate
    from ssi_tpu_torch.utils import extract_texts_from_generations_jsonl, ref_from_hf_dataset

    if args.skip_generate is not None:
        gen_dir = args.skip_generate
    else:
        gen_dir = _run_generate(overrides)

    gen_jsonl = gen_dir / "generations.jsonl"
    hyps_raw = extract_texts_from_generations_jsonl(gen_jsonl)
    # dataset/split from the path layout (same inference as scripts/wer.py)
    split = gen_dir.name if gen_dir.name in {"train", "dev", "test", "validation"} else gen_dir.parent.name
    dataset = gen_dir.parent.name if gen_dir.name == split else gen_dir.parents[1].name
    if args.refs_jsonl is not None:
        refs_raw = []
        for line in args.refs_jsonl.read_text().splitlines():
            if not line.strip():
                continue
            try:
                refs_raw.append(json.loads(line)["transcript"])
            except (json.JSONDecodeError, TypeError, KeyError):
                refs_raw.append(line)
        refs_raw = refs_raw[: len(hyps_raw)]
    else:
        refs_raw = ref_from_hf_dataset(dataset=dataset, split=split)[: len(hyps_raw)]
    if len(refs_raw) != len(hyps_raw):
        raise ValueError(f"{len(refs_raw)} references for {len(hyps_raw)} hypotheses")

    from ssi_tpu_torch.eval.wer import spelling_mapping_fingerprint, suspected_unmapped_words

    normalize = english_normalizer()
    refs = [normalize(t) for t in refs_raw]
    hyps = [normalize(t) for t in hyps_raw]
    wer = word_error_rate(refs, hyps)

    mapping = load_spelling_mapping()
    # residual normalizer divergence, quantified per run: post-normalization
    # words that still look British-spelled but are absent from the vendored
    # map — each is a potential WER shift vs the reference's hub-hosted mapping
    suspects = suspected_unmapped_words(refs + hyps, mapping)
    artifact = {
        "wer": wer,
        "n_samples": len(hyps),
        "dataset": dataset,
        "split": split,
        # the JAX script's value: the same class, vendored here from transformers
        "normalizer": "transformers-vendored EnglishTextNormalizer",
        **spelling_mapping_fingerprint(mapping),
        "suspected_unmapped_words": sum(suspects.values()),
        "suspected_unmapped_distinct": len(suspects),
        "suspected_unmapped_examples": dict(list(suspects.items())[:20]),
        "reference_command": (
            f"python scripts/wer.py {gen_jsonl} "
            "# run inside the reference repo; compares whisper_normalizer vs our vendored normalizer "
            "on identical generations"
        ),
        "target_wer_delta": 0.1,
    }
    if args.reference_wer is not None:
        ref_wer = json.loads(args.reference_wer.read_text())["wer"]
        artifact["reference_wer"] = ref_wer
        artifact["wer_delta"] = abs(wer - ref_wer)
        artifact["within_target"] = artifact["wer_delta"] <= artifact["target_wer_delta"]

    out = gen_dir / "wer_parity.json"
    out.write_text(json.dumps(artifact, indent=2) + "\n")
    LOGGER.info(f"WER {wer:.4f} over {len(hyps)} samples -> {out}")
    if "wer_delta" in artifact:
        status = "WITHIN" if artifact["within_target"] else "EXCEEDS"
        LOGGER.info(f"Delta vs reference: {artifact['wer_delta']:.4f} ({status} the 0.1 target)")


def _run_generate(overrides: list[str]) -> Path:
    """Run ``python -m ssi_tpu_torch.cli.generate``'s ``main`` (its config
    auto-resolution included), capturing the output dir it writes."""
    import ssi_tpu_torch.cli.generate as gen_cli

    captured: list[Path] = []
    original = gen_cli.run_generation

    def capture(cfg):
        out = original(cfg)
        captured.append(out)
        return out

    gen_cli.run_generation = capture
    try:
        gen_cli.main(overrides)
    finally:
        gen_cli.run_generation = original
    return captured[0]


if __name__ == "__main__":
    logging.basicConfig(
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
        level=logging.INFO,
        stream=sys.stdout,
    )
    main(sys.argv[1:])
    write_launch_counts("wer_parity")
