"""Plot train/dev loss curves with a WER overlay — the port's twin of
``scripts/plot_wandb_losses.py`` (ref: scripts/plot_wandb_losses.py:1-210).

Usage::

    python -m ssi_tpu_torch.cli.plot_wandb_losses <run_dir>/generations <output_dir> [--ext png]
        [--dataset D] [--split dev]

The history comes from the run's local ``metrics.jsonl`` (always written by
the trainer, under ``<run_dir>/checkpoints/`` or ``<run_dir>/``); WER points
from the ``wer.json`` files under the generations directory's step
directories. It writes ``losses_linear.<ext>`` and ``losses_log.<ext>``.
matplotlib is imported when a plot is drawn, and refused by name when it is
missing. ``--wandb`` (the W&B API) needs the network, which the port does
not use: it is refused. Host code only: it touches no device.
"""

from argparse import ArgumentParser, Namespace
import json
import logging
import os
from pathlib import Path
import sys

from ssi_tpu_torch.constants import WANDB_ENTITY_DEFAULT, WANDB_PROJECT_DEFAULT
from ssi_tpu_torch.utils import import_optional

LOGGER = logging.getLogger(__name__)


def extract_run_info(generations_dir: Path) -> tuple[str, str]:
    """W&B-style run name/id from '<run_name>-id_<run_id>' dir (ref: :40-48)."""
    if len(generations_dir.parts) < 2:
        raise ValueError("Path too short to extract run info.")
    run_dir = generations_dir.parts[-2]
    if "-id_" not in run_dir:
        raise ValueError("Run directory does not match expected format '<run_name>-id_<run_id>'")
    run_name, run_id = run_dir.split("-id_")
    return run_name, run_id


def extract_wer_data(generations_dir: Path, dataset: str, split: str = "dev") -> list[tuple[int, float]]:
    """(step, wer) points from wer.json files under step dirs (ref: :57-78)."""
    wer_data = []
    for pattern in ("global_step_*", "step_*"):
        for step_dir in generations_dir.rglob(pattern):
            try:
                step_num = int(step_dir.name.split("_")[-1])
                wer_file = step_dir / dataset / split / "wer.json"
                if wer_file.exists():
                    wer_value = json.loads(wer_file.read_text()).get("wer")
                    if wer_value is not None:
                        wer_data.append((step_num, wer_value))
            except (ValueError, json.JSONDecodeError, KeyError) as e:  # noqa: PERF203
                LOGGER.warning(f"Could not parse WER data from {step_dir}: {e}")
    wer_data.sort(key=lambda x: x[0])
    return wer_data


def load_history_jsonl(run_dir: Path) -> list[dict]:
    metrics = run_dir / "checkpoints" / "metrics.jsonl"
    if not metrics.exists():
        metrics = run_dir / "metrics.jsonl"
    if not metrics.exists():
        raise FileNotFoundError(f"No metrics.jsonl under {run_dir} (looked in checkpoints/ and run root)")
    return [json.loads(line) for line in metrics.read_text().splitlines() if line.strip()]


def load_history_wandb(run_id: str, entity: str, project: str) -> list[dict]:
    """The W&B API's history (the script's ``--wandb``): refused, it needs the network."""
    raise NotImplementedError(
        f"--wandb reads run {entity}/{project}/{run_id} from the W&B API over the network, which ssi_tpu_torch does "
        "not use: plot the run's local metrics.jsonl (omit --wandb)"
    )


def plot(history: list[dict], wer_data: list[tuple[int, float]], output_dir: Path, title: str, ext: str) -> None:
    matplotlib = import_optional("matplotlib", "Plotting the loss curves")
    matplotlib.use("Agg")
    plt = import_optional("matplotlib.pyplot", "Plotting the loss curves")

    steps = [h["step"] for h in history if "loss" in h]
    losses = [h["loss"] for h in history if "loss" in h]
    dev_pts = [(h["step"], h["dev_loss"]) for h in history if h.get("dev_loss") is not None]

    for scale_type in ["linear", "log"]:
        _fig, ax1 = plt.subplots(figsize=(12, 8))
        lines = []
        if losses:
            lines += ax1.plot(steps, losses, label="loss", color="tab:blue")
        if dev_pts:
            ds, dl = zip(*dev_pts)
            lines += ax1.plot(ds, dl, label="dev_loss", color="tab:orange", marker="o", markersize=3)
        ax1.set_xlabel("global step")
        ax1.set_ylabel("loss")
        if scale_type == "log":
            ax1.set_yscale("log")
        ax1.grid(True, alpha=0.3)

        if wer_data:
            ws, wv = zip(*wer_data)
            ax2 = ax1.twinx()
            lines += ax2.plot(ws, [v * 100 for v in wv], label="WER (%)", color="tab:red", marker="s", linestyle="--")
            ax2.set_ylabel("WER (%)")

        ax1.legend(lines, [ln.get_label() for ln in lines], loc="upper right")
        plt.title(title)
        plt.tight_layout()
        out = output_dir / f"losses_{scale_type}.{ext}"
        plt.savefig(out, dpi=200, bbox_inches="tight")
        LOGGER.info(f"Saved {out}")
        plt.close()


def parse_args(argv: list[str] | None = None) -> Namespace:
    parser = ArgumentParser(description="Plot train/dev loss with WER overlay.")
    parser.add_argument("generations_dir", type=Path)
    parser.add_argument("output_dir", type=Path)
    parser.add_argument("--ext", default="png")
    parser.add_argument("--wandb", action="store_true",
                        help="Pull history from the W&B API instead of metrics.jsonl (refused: needs the network)")
    parser.add_argument("--entity", default=WANDB_ENTITY_DEFAULT)
    parser.add_argument("--project", default=WANDB_PROJECT_DEFAULT)
    parser.add_argument("--dataset", default=None, help="Dataset dir name for wer.json discovery")
    parser.add_argument("--split", default="dev")
    return parser.parse_args(argv)


def main(args: Namespace) -> None:
    run_dir = args.generations_dir.parent
    run_name, run_id = extract_run_info(args.generations_dir)
    if args.wandb:
        history = load_history_wandb(run_id, args.entity, args.project)
    else:
        history = load_history_jsonl(run_dir)

    dataset = args.dataset
    if dataset is None:
        candidates = {p.parent.parent.name for p in args.generations_dir.rglob("wer.json")}
        dataset = sorted(candidates)[0] if candidates else ""
    wer_data = extract_wer_data(args.generations_dir, dataset=dataset, split=args.split) if dataset else []

    args.output_dir.mkdir(parents=True, exist_ok=True)
    plot(history, wer_data, args.output_dir, title=f"{run_name} (id {run_id})", ext=args.ext)


if __name__ == "__main__":
    logging.basicConfig(
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
        level=os.environ.get("LOG_LEVEL", "INFO").upper(),
        stream=sys.stdout,
        force=True,
    )
    main(parse_args())
