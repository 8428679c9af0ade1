"""Helpers copied from ``ssi_tpu/utils/__init__.py`` (held equal to the
originals by ``tests/test_torch_optimizer.py`` and ``tests/test_torch_config.py``),
and the port's own ``resolve_device``."""

from __future__ import annotations

from hashlib import sha256
import importlib
import json
from pathlib import Path
from typing import Any


def extract_texts_from_generations_jsonl(generations_jsonl: Path) -> list[str]:
    """One generated text per prompt (ref: ssi/utils.py:29-39)."""
    texts = []
    with open(generations_jsonl) as f:
        for line in f:
            data = json.loads(line)
            is_single_generation = len(data["outputs"]) == 1
            if is_single_generation:
                texts.append(data.pop("outputs").pop(0).pop("text"))
            else:
                raise NotImplementedError("Multiple generations per prompt are not supported by this script.")
    return texts


def ref_from_hf_dataset(dataset: str, split: str, gt_transcript_colname: str = "transcript") -> list[str]:
    """Ground-truth transcripts from the HF hub (ref: ssi/utils.py:42-47): not
    ported. The JAX package reads them through ``datasets`` from the hub; the
    port reads no hub source (no machine it runs on has the network), so this
    raises before any work (score against local transcripts with
    ``--refs-jsonl`` instead)."""
    raise NotImplementedError(
        f"Reading reference transcripts of {dataset!r} ({split}, column {gt_transcript_colname!r}) from the HF hub "
        "is not ported to ssi_tpu_torch: it needs the network (ROADMAP.md queue A, item A12: hub ids)"
    )


def import_optional(module: str, needed_for: str) -> Any:
    """Import ``module`` of an optional library (pyarrow, regex, matplotlib,
    seaborn, sklearn) for the one function that needs it. The port depends on
    none of them and has no fallback: a missing one raises ``ImportError``
    naming it."""
    try:
        return importlib.import_module(module)
    except ImportError:
        package = module.split(".")[0]
        raise ImportError(f"{needed_for} needs the package {package!r}, which is not installed (ssi_tpu_torch does "
                          f"not depend on it and has no fallback)") from None


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= n (shape/bucket alignment helper)."""
    return ((n + multiple - 1) // multiple) * multiple


def hash_cfg(cfg: Any, length: int = 7) -> str:
    """Truncated SHA-256 of the resolved, key-sorted config (ref: ssi/utils.py:80-82)."""
    from ssi_tpu_torch.config import to_yaml

    return sha256(to_yaml(cfg, resolve=True, sort_keys=True).encode()).hexdigest()[:length]


def resolve_device(cfg: Any, override: str = "+device=cpu"):
    """An entry point's ``device`` setting (``cfg["device"]``, default
    ``cuda``) as a torch device. A CUDA device raises when none is visible:
    the port does not fall back to the CPU; ``override`` names the switch
    that asks for the CPU."""
    import torch

    device = torch.device(str(cfg.get("device", "cuda")))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device.type} (the default) but no CUDA device is visible; the port does not "
                           f"fall back to the CPU: pass {override} to run on the CPU")
    return device
