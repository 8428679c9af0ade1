"""Standing completions server over a step_N checkpoint — the port's twin of
``scripts/serve.py`` (the ``vllm serve`` role).

Usage::

    python -m ssi_tpu_torch.cli.serve model=/path/to/step_N [server.port=8000] [key=value ...]

Endpoints: POST /v1/completions, POST /v1/chat/completions, GET /health,
GET /v1/models, GET /metrics (``ssi_tpu_torch/serve.py``). Composes
``conf/serve.yaml`` (read in place, by the port's own config reader) and
resolves speech.n_dsus from the training-config snapshot next to the
checkpoint when not given explicitly. It serves from the CUDA card; with no
card visible it refuses unless ``+device=cpu`` is given. ``tensor_parallel >
1`` is refused, naming its ROADMAP item (A9's remainder).
The server runs until SIGINT; then, when ``SSI_TPU_TORCH_LAUNCH_COUNTS``
names a file, it appends the process's kernel launch counts to it.
"""

import logging
from pathlib import Path
import sys

from ssi_tpu_torch._build import write_launch_counts
from ssi_tpu_torch.config import compose, load_yaml
from ssi_tpu_torch.constants import TRAIN_CONFIG_FILENAME
from ssi_tpu_torch.serve import run_server
from ssi_tpu_torch.utils import resolve_device

LOGGER = logging.getLogger(__name__)

CONF_DIR = Path(__file__).resolve().parents[2] / "conf"


def main(argv: list[str]) -> None:
    logging.basicConfig(
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
        level=logging.INFO,
        stream=sys.stdout,
    )
    cfg = compose(str(CONF_DIR), "serve", overrides=argv)
    resolve_device(cfg)  # refuse before any work when the card is missing

    if cfg.speech.n_dsus is None:
        train_cfg = None
        if cfg.get("train_yaml") is not None:
            train_cfg = load_yaml(cfg.train_yaml)
        else:
            for parent_idx in (0, 1):
                p = Path(cfg.model).parents[parent_idx] / TRAIN_CONFIG_FILENAME
                if p.exists():
                    train_cfg = load_yaml(p)
                    LOGGER.warning(f"Loaded training config from {p!s}")
                    break
        if train_cfg and train_cfg.get("speech", {}).get("n_dsus") is not None:
            cfg.speech.n_dsus = train_cfg["speech"]["n_dsus"]
            LOGGER.info(f"Auto-setting cfg.speech.n_dsus to {cfg.speech.n_dsus} from training config.")
        else:
            raise ValueError("cfg.speech.n_dsus must be specified via CLI or the training config snapshot.")

    run_server(cfg)


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except KeyboardInterrupt:  # SIGINT: serve_forever has stopped the server
        LOGGER.info("interrupted; server stopped")
    finally:
        write_launch_counts("serve")
