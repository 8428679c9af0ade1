"""Standing completions server over a step_N checkpoint — the port's twin of
``scripts/serve.py`` (the ``vllm serve`` role).

Usage::

    python -m ssi_tpu_torch.cli.serve model=/path/to/step_N [server.port=8000] [key=value ...]

Endpoints: POST /v1/completions, POST /v1/chat/completions, GET /health,
GET /v1/models, GET /metrics (``ssi_tpu_torch/serve.py``). Composes
``conf/serve.yaml`` (read in place, by the port's own config reader) and
resolves speech.n_dsus from the training-config snapshot next to the
checkpoint when not given explicitly. It serves from the CUDA card; with no
card visible it refuses unless ``+device=cpu`` is given.
The server runs until SIGINT; then, when ``SSI_TPU_TORCH_LAUNCH_COUNTS``
names a file, it appends the process's kernel launch counts to it.

Tensor-parallel serving runs one process a rank under torchrun::

    torchrun --nproc_per_node N -m ssi_tpu_torch.cli.serve model=... tensor_parallel=N

The process group comes up from torchrun's environment (NCCL on the card,
gloo with ``+device=cpu``). Rank 0 binds the HTTP port and schedules; the
other ranks follow its dispatches and ignore SIGINT: stop the server with
SIGINT to rank 0 (each rank logs its pid), which releases the followers
before it exits.
"""

import logging
from pathlib import Path
import sys

from ssi_tpu_torch._build import write_launch_counts
from ssi_tpu_torch.config import compose, load_yaml
from ssi_tpu_torch.constants import TRAIN_CONFIG_FILENAME
from ssi_tpu_torch.parallel import joined_from_launcher
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
    device = resolve_device(cfg)  # refuse before any work when the card is missing

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

    with joined_from_launcher(device):
        run_server(cfg)


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except KeyboardInterrupt:  # SIGINT: serve_forever has stopped the server
        LOGGER.info("interrupted; server stopped")
    finally:
        write_launch_counts("serve")
