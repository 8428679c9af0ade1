"""Continued pre-training entry point — the port's twin of ``scripts/train_cpt.py``.

Usage::

    python -m ssi_tpu_torch.cli.train_cpt data=cpt/mls-hubert_large_ll60k-layer_22 [key=value ...]

Composes ``conf/cpt.yaml`` (read in place, by the port's own config
reader), applies the hydra logging config, resolves ``speech.n_dsus`` from
the data config and runs the port's ``Trainer`` (``train/trainer.py``
``run_training``). It trains on the CUDA card; with no card visible it
refuses unless ``+device=cpu`` is given. Under ``torchrun --nproc_per_node
N`` with ``parallel.distributed=true`` it trains across the N ranks as the
JAX mesh ``(dp, tp)`` (``parallel.tp``, ``parallel.dp``; ``train/trainer.py``).
"""

from functools import partial
import sys

from ssi_tpu_torch.train.trainer import run_training

main = partial(run_training, "cpt")

if __name__ == "__main__":
    main(sys.argv[1:])
