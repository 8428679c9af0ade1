"""Helpers copied from ``ssi_tpu/utils/__init__.py`` (held equal to the
originals by ``tests/test_torch_optimizer.py``)."""


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= n (shape/bucket alignment helper)."""
    return ((n + multiple - 1) // multiple) * multiple
