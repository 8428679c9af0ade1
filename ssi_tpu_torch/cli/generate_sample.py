"""Standalone sample-wise generation — the port's twin of
``scripts/generate_sample.py``: generate from an arbitrary prompt without a
dataset config, through the port's dense ``DecodeEngine``.

Prompt input modes: raw text, raw token IDs, or a template (by name from
ssi_tpu_torch/templates or by path) with variables. The arguments and the
record are the JAX script's; the port adds ``--device`` (default ``cuda``;
with no card visible it refuses unless ``--device cpu`` is given).

Examples::

    python -m ssi_tpu_torch.cli.generate_sample --model /path/to/step_N --n_dsus 5000 \\
        --text "The capital of France is"
    python -m ssi_tpu_torch.cli.generate_sample --model M --n_dsus 5000 \\
        --template repeat_this_modality_switch --speech_tokens 17 17 23 900
    python -m ssi_tpu_torch.cli.generate_sample --model M --n_dsus 5000 --token_ids 133002 72 73 --device cpu
"""

from argparse import ArgumentParser, Namespace
import json
import logging
from pathlib import Path
import sys

from ssi_tpu_torch._build import write_launch_counts

LOGGER = logging.getLogger(__name__)


def generate_sample(
    model_dir: Path | str,
    n_dsus: int,
    *,
    text: str | None = None,
    token_ids: list[int] | None = None,
    template: str | None = None,
    template_vars: dict | None = None,
    speech_tokens: list[int] | None = None,
    deduplicate: bool = False,
    use_modality_tokens: bool = True,
    temperature: float = 0.0,
    top_p: float = 1.0,
    top_k: int = -1,
    max_tokens: int = 256,
    repetition_penalty: float = 1.0,
    stop_token_ids: list[int] | None = None,
    add_bos: bool = True,
    model_config: str = "llama3_2_1b",
    dtype: str = "bf16",
    seed: int = 0,
    pattern: str | None = None,
    device: str = "cuda",
) -> dict:
    """Generate one completion; returns a structured record (vLLM-style).

    ``pattern``: tokenizer split-pattern selector (``None`` = PUA contract;
    ``"cl100k"`` for BPE-compressed DSU checkpoints; any other raw regex
    splits through the ``regex`` package, as ``setup_llama3_tokenizer``
    does, and raises only when that package is missing). ``device``: the
    card unless the caller names the CPU; with no card the default raises.
    """
    import torch

    from ssi_tpu_torch.checkpoint import Checkpointer
    from ssi_tpu_torch.generate.engine import DecodeEngine, SamplingParams
    from ssi_tpu_torch.generate.templates import render_template
    from ssi_tpu_torch.models.configs import get_model_config
    from ssi_tpu_torch.tokenizer import setup_llama3_tokenizer
    from ssi_tpu_torch.utils import resolve_device

    dev = resolve_device({"device": device}, "--device cpu")
    model_dir = Path(model_dir)
    tokenizer, special_tokens = setup_llama3_tokenizer(
        model_dir / "original" / "tokenizer.model", verbose=False, pattern=pattern
    )
    special_int2str = {v: k for k, v in special_tokens.items()}

    if sum(x is not None for x in (text, token_ids, template)) != 1:
        raise ValueError("Provide exactly one of: text, token_ids, template")
    if template is not None:
        text = render_template(
            template, speech_tokens=speech_tokens, deduplicate=deduplicate, **(template_vars or {})
        )
    if token_ids is None:
        token_ids = tokenizer.encode(text, add_bos=add_bos, add_eos=False)

    model_cfg = get_model_config(model_config).copy()
    model_cfg.n_dsus = n_dsus
    model_cfg.modality_tokens = use_modality_tokens
    checkpointer = Checkpointer(
        checkpoint_dir=model_dir,
        output_dir=model_dir.parent / "_gen_sample_scratch",
        model_expectations=model_cfg.checkpoint_expectations,
    )
    params = checkpointer.load_params(model_cfg, dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
                                      device=dev)

    if stop_token_ids is None:
        stop_token_ids = list(tokenizer.stop_tokens)
    sp = SamplingParams(
        temperature=temperature,
        top_p=top_p,
        top_k=top_k,
        max_tokens=max_tokens,
        repetition_penalty=repetition_penalty,
        stop_token_ids=tuple(stop_token_ids),
    )
    engine = DecodeEngine(params, model_cfg, pad_id=tokenizer.pad_id)
    out = engine.generate_batch([list(token_ids)], sp, seed=seed)[0]

    generated_text = tokenizer.decode(list(out["token_ids"]))
    stop_reason = out["stop_reason"]
    return {
        "prompt": tokenizer.decode(list(token_ids), truncate_at_eos=False, skip_special_tokens=False),
        "prompt_token_ids": list(map(int, token_ids)),
        "outputs": [
            {
                "index": 0,
                "text": generated_text,
                "token_ids": list(map(int, out["token_ids"])),
                "cumulative_logprob": out.get("cumulative_logprob"),
                "finish_reason": out["finish_reason"],
                "stop_reason": int(stop_reason) if stop_reason is not None else None,
                "stop_reason_text": special_int2str.get(stop_reason) if stop_reason is not None else None,
            }
        ],
        "finished": True,
    }


def parse_args(argv: list[str] | None = None) -> Namespace:
    parser = ArgumentParser(description="Generate from an arbitrary prompt (no dataset config needed).")
    parser.add_argument("--model", type=Path, required=True, help="HF checkpoint dir (step_N or extended model)")
    parser.add_argument("--n_dsus", type=int, required=True)
    parser.add_argument("--no-modality-tokens", action="store_false", dest="use_modality_tokens")
    parser.add_argument("--deduplicate", action="store_true", help="Dedup consecutive speech tokens")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--text", type=str, help="Raw text prompt")
    group.add_argument("--token_ids", type=int, nargs="+", help="Pre-tokenized prompt ids")
    group.add_argument("--template", type=str, help="Template name (ssi_tpu_torch/templates) or .jinja path")
    parser.add_argument("--speech_tokens", type=int, nargs="*", default=None, help="DSU ids for the template")
    parser.add_argument("--var", action="append", default=[], metavar="KEY=VALUE", help="Extra template variables")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top_p", type=float, default=1.0)
    parser.add_argument("--top_k", type=int, default=-1)
    parser.add_argument("--max_tokens", type=int, default=256)
    parser.add_argument("--repetition_penalty", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--model_config", type=str, default="llama3_2_1b")
    parser.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    parser.add_argument(
        "--pattern", type=str, default=None,
        help="Tokenizer split pattern: omit for the PUA contract; 'cl100k' for BPE-compressed DSU checkpoints",
    )
    parser.add_argument("--jsonl_out", type=Path, default=None, help="Append the structured record here")
    parser.add_argument("--device", default="cuda", help="Device the model runs on (default: cuda)")
    return parser.parse_args(argv)


def main(args: Namespace) -> dict:
    template_vars = dict(kv.split("=", 1) for kv in args.var)
    record = generate_sample(
        args.model,
        args.n_dsus,
        text=args.text,
        token_ids=args.token_ids,
        template=args.template,
        template_vars=template_vars,
        speech_tokens=args.speech_tokens,
        deduplicate=args.deduplicate,
        use_modality_tokens=args.use_modality_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
        top_k=args.top_k,
        max_tokens=args.max_tokens,
        repetition_penalty=args.repetition_penalty,
        seed=args.seed,
        model_config=args.model_config,
        dtype=args.dtype,
        pattern=args.pattern,
        device=args.device,
    )
    print(record["outputs"][0]["text"])
    if args.jsonl_out is not None:
        with open(args.jsonl_out, "a") as f:
            f.write(json.dumps(record, ensure_ascii=False) + "\n")
        LOGGER.info(f"Appended structured record to {args.jsonl_out}")
    return record


if __name__ == "__main__":
    logging.basicConfig(
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
        level=logging.INFO,
        stream=sys.stdout,
    )
    main(parse_args())
    write_launch_counts("generate_sample")
