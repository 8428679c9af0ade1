"""t-SNE plots of the embedding matrix coloured by token type — the port's
twin of ``scripts/plt_embed_tsne.py`` (ref: scripts/plt_embed_tsne.py:1-247).

Usage::

    python -m ssi_tpu_torch.cli.plt_embed_tsne output_dir=/path/to/plots \\
        checkpointer.checkpoint_dir=/path/to/model data=cpt/mls-... [overrides]

Composes ``conf/tsne.yaml`` through the port's config, reads only
``model.embed_tokens.weight`` from the checkpoint's safetensors shards
(``checkpoint/safetensors_io.py``, not the ``safetensors`` package), and
renders (a) combined t-SNE plots at each of ``tsne.perplexities`` over a
seeded row subsample of at most ``tsne.max_points`` rows, after a PCA to
``tsne.n_pca_components``, and (b) per-token-type subplots, the ranges from
``train_utils.get_token_type_ranges``. matplotlib, seaborn and sklearn are
imported when a plot is drawn, and refused by name when one is missing (a
refusal is raised, where another failure of one plot is logged and the next
plot drawn, as in the script). Host code only: it touches no device.
"""

import logging
import os
from pathlib import Path
import sys

import numpy as np

from ssi_tpu_torch.config import compose
from ssi_tpu_torch.constants import SEED
from ssi_tpu_torch.models.configs import get_model_config
from ssi_tpu_torch.train.train_utils import get_token_type_ranges, resolve_n_dsus
from ssi_tpu_torch.utils import import_optional

LOGGER = logging.getLogger(__name__)

CONF_DIR = Path(__file__).resolve().parents[2] / "conf"


def _pyplot():
    matplotlib = import_optional("matplotlib", "Plotting the embeddings")
    matplotlib.use("Agg")
    return import_optional("matplotlib.pyplot", "Plotting the embeddings")


def load_embeddings(checkpoint_dir: Path) -> np.ndarray:
    """Read model.embed_tokens.weight straight from the safetensors shards."""
    import torch

    from ssi_tpu_torch.checkpoint import discover_safetensor_files
    from ssi_tpu_torch.checkpoint.safetensors_io import safe_open

    for fname in discover_safetensor_files(checkpoint_dir):
        with safe_open(checkpoint_dir / fname) as f:
            if "model.embed_tokens.weight" in f.keys():
                return f.get_tensor("model.embed_tokens.weight").to(torch.float32).numpy()
    raise KeyError(f"model.embed_tokens.weight not found in any shard under {checkpoint_dir}")


def create_token_type_labels(ranges: dict[str, tuple[int, int]], vocab_size: int) -> tuple[np.ndarray, list]:
    labels = np.full(vocab_size, -1, dtype=int)
    label_names = []
    for i, (token_type, (start, end)) in enumerate(ranges.items()):
        labels[start : end + 1] = i
        label_names.append(token_type)
    return labels, label_names


def plot_embeddings(
    embeddings: np.ndarray,
    labels: np.ndarray,
    label_names: list,
    output_dir: Path,
    perplexity: int,
    n_components: int = 2,
    n_pca_components: int = -1,
) -> None:
    plt = _pyplot()
    sns = import_optional("seaborn", "Plotting the embeddings")
    PCA = import_optional("sklearn.decomposition", "The embeddings' PCA").PCA
    TSNE = import_optional("sklearn.manifold", "The embeddings' t-SNE").TSNE

    LOGGER.info(f"Running t-SNE with perplexity={perplexity}, n_components={n_components}")
    if n_pca_components > 0 and embeddings.shape[1] > n_pca_components:
        pca = PCA(n_components=n_pca_components, random_state=SEED)
        embeddings = pca.fit_transform(embeddings)
        LOGGER.info(f"PCA explained variance ratio: {pca.explained_variance_ratio_.sum():.3f}")

    tsne = TSNE(n_components=n_components, perplexity=perplexity, random_state=SEED, init="pca", learning_rate="auto")
    pts = tsne.fit_transform(embeddings)

    plt.figure(figsize=(12, 10))
    colors = sns.color_palette("husl", len(label_names))
    for i, label_name in enumerate(label_names):
        mask = labels == i
        if mask.sum() > 0:
            plt.scatter(pts[mask, 0], pts[mask, 1], c=[colors[i]], label=f"{label_name} ({mask.sum()} tokens)",
                        alpha=0.7, s=20)
    plt.title(f"t-SNE Visualization of Model Embeddings (perplexity={perplexity})")
    plt.xlabel("t-SNE 1")
    plt.ylabel("t-SNE 2")
    plt.legend(bbox_to_anchor=(1.05, 1), loc="upper left")
    plt.grid(True, alpha=0.3)
    plt.tight_layout()
    output_file = output_dir / f"embeddings_tsne_perplexity_{perplexity}.png"
    plt.savefig(output_file, dpi=300, bbox_inches="tight")
    LOGGER.info(f"Saved t-SNE plot to: {output_file}")
    plt.close()


def plot_embeddings_by_token_type(embeddings: np.ndarray, ranges: dict, output_dir: Path) -> None:
    plt = _pyplot()
    TSNE = import_optional("sklearn.manifold", "The embeddings' t-SNE").TSNE

    _fig, axes = plt.subplots(2, 2, figsize=(15, 12))
    axes = axes.flatten()
    for i, (token_type, (start, end)) in enumerate(ranges.items()):
        if i >= len(axes):
            break
        token_embeddings = embeddings[start : end + 1]
        if len(token_embeddings) > 30:
            tsne = TSNE(n_components=2, perplexity=min(30, len(token_embeddings) // 3), random_state=SEED,
                        init="pca", learning_rate="auto")
            pts = tsne.fit_transform(token_embeddings)
            axes[i].scatter(pts[:, 0], pts[:, 1], alpha=0.7, s=20)
            axes[i].set_title(f"{token_type.capitalize()} Tokens ({len(token_embeddings)} tokens)")
            axes[i].grid(True, alpha=0.3)
        else:
            axes[i].text(0.5, 0.5, f"Too few {token_type} tokens\nfor t-SNE ({len(token_embeddings)})",
                         ha="center", va="center", transform=axes[i].transAxes)
            axes[i].set_title(f"{token_type.capitalize()} Tokens")
    for i in range(len(ranges), len(axes)):
        axes[i].set_visible(False)
    plt.tight_layout()
    output_file = output_dir / "embeddings_by_token_type.png"
    plt.savefig(output_file, dpi=300, bbox_inches="tight")
    LOGGER.info(f"Saved token type plots to: {output_file}")
    plt.close()


def main(argv: list[str]) -> None:
    cfg = compose(str(CONF_DIR), "tsne", overrides=argv)
    if cfg.get("data") is not None:
        resolve_n_dsus(cfg)
    output_dir = Path(cfg.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    model_cfg = get_model_config(cfg.get("model_config", "llama3_2_1b")).copy()
    model_cfg.update_from_speech_cfg(cfg.speech)

    embeddings = load_embeddings(Path(cfg.checkpointer.checkpoint_dir))
    LOGGER.info(f"Embeddings shape: {embeddings.shape}")

    ranges = get_token_type_ranges(model_cfg)
    for token_type, (start, end) in ranges.items():
        LOGGER.info(f"  {token_type}: {start}-{end} ({end - start + 1} tokens)")
    labels, label_names = create_token_type_labels(ranges, embeddings.shape[0])

    # Optional row subsampling: t-SNE over the full 133k-row extended vocab takes
    # hours; a stratified subsample preserves the token-type structure.
    max_points = int(cfg.tsne.get("max_points", 0) or 0)
    if max_points and embeddings.shape[0] > max_points:
        rng = np.random.default_rng(SEED)
        keep = np.sort(rng.choice(embeddings.shape[0], size=max_points, replace=False))
        embeddings_plot, labels_plot = embeddings[keep], labels[keep]
        LOGGER.info(f"Subsampled embeddings for t-SNE: {max_points}/{len(labels)} rows")
    else:
        embeddings_plot, labels_plot = embeddings, labels

    n_pca = int(cfg.tsne.get("n_pca_components", 50) or -1)
    for perplexity in cfg.tsne.perplexities:
        try:
            plot_embeddings(
                embeddings_plot, labels_plot, label_names, output_dir, int(perplexity), n_pca_components=n_pca
            )
        except ImportError:
            raise
        except Exception as e:  # noqa: PERF203
            LOGGER.error(f"Failed to create t-SNE plot with perplexity {perplexity}: {e}")

    try:
        plot_embeddings_by_token_type(embeddings, ranges, output_dir)
    except ImportError:
        raise
    except Exception as e:
        LOGGER.error(f"Failed to create token type plots: {e}")

    LOGGER.info("Embedding visualization complete!")


if __name__ == "__main__":
    logging.basicConfig(
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
        level=os.environ.get("LOG_LEVEL", "INFO").upper(),
        stream=sys.stdout,
        force=True,
    )
    main(sys.argv[1:])
