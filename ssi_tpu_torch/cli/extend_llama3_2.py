"""Extend a base Llama 3.2 HF checkpoint with DSU tokens — the port's twin of
``scripts/extend_llama3_2.py`` (ref: scripts/extend_llama3_2.py:50-143).

Usage::

    python -m ssi_tpu_torch.cli.extend_llama3_2 --n_new_dsus 5000 --input_dir <base> --output_dir <out> [--device cpu]

Produces a self-contained extended model directory, the same files as the
JAX script (``tests/test_torch_extend.py`` holds them bitwise equal):

- embedding matrix grown with Gaussian-sampled rows, layout [text | dsu | modality? | special];
- tokenizer.model extended in place with PUA merge lines;
- config.json / original/params.json / generation_config.json vocab+bos/eos shifted.

The weights are loaded in fp32 onto ``--device`` (the CUDA card unless the
caller names the CPU; with no card visible the default refuses) and written
from there by the port's ``Checkpointer``; the Gaussian fit and the new rows
are numpy on the host, as in the JAX script.
"""

from argparse import ArgumentParser, Namespace
import logging
import os
from pathlib import Path
import sys

import numpy as np
import torch

from ssi_tpu_torch.checkpoint import SUFFIXES_TO_NOT_COPY, Checkpointer
from ssi_tpu_torch.constants import (
    EXTENDED_MODELS_DIR,
    LLAMA_3_2_1B_BASE_DIR,
    LLAMA_3_2_CONFIG_RELPATH,
    LLAMA_3_2_GENERATION_CONFIG_RELPATH,
    LLAMA_3_2_PARAMS_RELPATH,
    LLAMA_3_2_TOKENIZER_RELPATH,
    LLAMA_BOS_TOKEN,
    LLAMA_EOS_TOKEN,
    SEED,
)
from ssi_tpu_torch.extend import (
    extend_config,
    extend_embeddings,
    extend_generation_config,
    extend_params,
    extend_tiktoken,
)
from ssi_tpu_torch.models.configs import MODEL_CONFIGS, get_model_config
from ssi_tpu_torch.tokenizer import setup_llama3_tokenizer
from ssi_tpu_torch.utils import resolve_device

LOGGER = logging.getLogger(__name__)


def parse_args(argv: list[str] | None = None) -> Namespace:
    parser = ArgumentParser(description="Extend a tokenizer.model and model safetensors for DSUs")
    parser.add_argument("--n_new_dsus", type=int, required=True, help="Number of DSUs to add as tokens")
    parser.add_argument(
        "--input_dir",
        type=Path,
        default=LLAMA_3_2_1B_BASE_DIR,
        help=f"Input Llama 3.2 HF directory. Default: {LLAMA_3_2_1B_BASE_DIR}",
    )
    parser.add_argument("--output_dir", type=Path, default=None, help="Output directory for the extended files")
    parser.add_argument(
        "--model-config",
        default="llama3_2_1b",
        choices=sorted(MODEL_CONFIGS),
        help="Architecture registry key for the base checkpoint being extended",
    )
    parser.add_argument(
        "--sigma-scaling",
        type=float,
        default=1e-5,
        help="Covariance scale for the Gaussian the new embedding rows are sampled "
        "from (default 1e-5, the reference semantics; from-scratch pipelines on a "
        "random-init base pass 1.0 to draw rows at the base embedding distribution's scale)",
    )
    parser.add_argument(
        "--no-modality-tokens",
        action="store_false",
        dest="use_modality_tokens",
        help="Do not add special modality boundary tokens",
    )
    parser.add_argument("--device", default="cuda", help="Device the weights are loaded onto (default: cuda)")
    args = parser.parse_args(argv)
    if args.output_dir is None:
        dirname = f"{args.input_dir.name}-{args.n_new_dsus}-dsus"
        if not args.use_modality_tokens:
            dirname += "-no_modality_tokens"
        args.output_dir = EXTENDED_MODELS_DIR / dirname
    return args


def main(args: Namespace) -> None:
    device = resolve_device({"device": args.device}, "--device cpu")
    rng = np.random.default_rng(SEED)
    llama_cfg = get_model_config(args.model_config).copy()  # base (unextended) expectations for loading

    checkpointer = Checkpointer(
        checkpoint_dir=args.input_dir,
        checkpoint_files=["model.safetensors"],
        config_json=args.input_dir / LLAMA_3_2_CONFIG_RELPATH,
        output_dir=args.output_dir,
    )
    # fp32 for the Gaussian fit (ref loads fp32: scripts/extend_llama3_2.py:166)
    params = checkpointer.load_params(llama_cfg, dtype=torch.float32, device=device)

    extended_cfg = get_model_config(args.model_config).copy()
    extended_cfg.n_dsus = args.n_new_dsus
    extended_cfg.modality_tokens = args.use_modality_tokens

    embed = params["embed"].cpu().numpy()
    params["embed"] = torch.from_numpy(
        extend_embeddings(
            embed, llama_cfg, args.n_new_dsus, args.use_modality_tokens, rng,
            sigma_scaling=args.sigma_scaling,
        )
    ).to(device)
    del embed

    checkpointer.save_model_checkpoint(
        params,
        extended_cfg,
        global_step=0,
        output_dir=args.output_dir,
        ignore_suffixes=[*SUFFIXES_TO_NOT_COPY, ".pth", ".txt", ".md", "tokenizer_config.json", "tokenizer.json"],
    )

    # Extend tokenizer in place in the output dir
    extend_tiktoken(
        args.n_new_dsus,
        args.use_modality_tokens,
        args.output_dir / LLAMA_3_2_TOKENIZER_RELPATH,
        args.output_dir / LLAMA_3_2_TOKENIZER_RELPATH,
    )
    tokenizer_extended, special_tokens = setup_llama3_tokenizer(args.output_dir / LLAMA_3_2_TOKENIZER_RELPATH)

    extend_config(
        args.output_dir / LLAMA_3_2_CONFIG_RELPATH,
        bos_token_id=special_tokens[LLAMA_BOS_TOKEN],
        eos_token_id=special_tokens[LLAMA_EOS_TOKEN],
        vocab_size=tokenizer_extended.vocab_size,
        llama_config=llama_cfg,
    )
    extend_params(
        args.output_dir / LLAMA_3_2_PARAMS_RELPATH,
        vocab_size=tokenizer_extended.vocab_size,
        llama_config=llama_cfg,
    )
    extend_generation_config(
        args.output_dir / LLAMA_3_2_GENERATION_CONFIG_RELPATH,
        bos_token_id=special_tokens[LLAMA_BOS_TOKEN],
        eos_token_id=special_tokens[LLAMA_EOS_TOKEN],
    )

    # Invariants (ref: scripts/extend_llama3_2.py:132-138)
    base_vocab_size = llama_cfg.base_vocab_size_txt
    special_tokens_size = llama_cfg.n_special_txt
    assert (
        tokenizer_extended.vocab_size
        == base_vocab_size + special_tokens_size + args.n_new_dsus + 2 * args.use_modality_tokens
    )
    assert params["embed"].shape[0] == tokenizer_extended.vocab_size
    LOGGER.info(f"Extended model written to {args.output_dir}")


if __name__ == "__main__":
    logging.basicConfig(
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
        level=os.environ.get("LOG_LEVEL", "INFO").upper(),
        stream=sys.stdout,
        force=True,
    )
    main(parse_args())
