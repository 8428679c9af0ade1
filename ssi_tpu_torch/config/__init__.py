"""Minimal Hydra/OmegaConf-equivalent configuration system — the port's copy
of ``ssi_tpu/config/__init__.py``, line for line, with pyyaml replaced by the
first-party ``yaml_subset`` reader and writer (pyyaml is not a dependency of
the port). ``tests/test_torch_config.py`` holds the reader, ``compose``,
``to_yaml`` and ``hash_cfg`` equal to the original on every file of ``conf/``.

The reference composes its config from YAML groups with a defaults list, lazy
``${...}`` interpolation, ``???`` mandatory markers, and dotted CLI overrides
(ref: conf/cpt.yaml:1-7, conf/common.yaml:11, ssi/train_utils.py:84-86 use
``OmegaConf.missing_keys``). Neither hydra nor omegaconf is a dependency of this
rebuild; this module implements the subset of their behaviour the config surface
actually uses:

- ``compose(config_dir, config_name, overrides)`` — load ``<config_name>.yaml``,
  recursively merge its ``defaults:`` list (group entries land under the group key,
  ``override hydra/...`` entries are ignored), then apply CLI overrides.
- ``Config`` — attribute/item access, ``.get``, lazy interpolation resolution
  against the composition root, ``???`` -> :class:`MissingMandatoryValue` on access.
- ``missing_keys(cfg)``, ``to_container(cfg, resolve=...)``, ``to_yaml``, ``save``.

Interpolation supports ``${dotted.path}``. A value that is exactly one
interpolation resolves to the referenced value with its original type; embedded
interpolations stringify. ``${hydra:job.config_name}`` resolves to the injected
``config_name`` for drop-in compatibility with the reference's conf files.
"""

from __future__ import annotations

from pathlib import Path
import re
from typing import Any

from ssi_tpu_torch.config import yaml_subset

__all__ = [
    "Config",
    "MissingMandatoryValue",
    "InterpolationError",
    "MISSING",
    "compose",
    "load_yaml",
    "merge",
    "missing_keys",
    "to_container",
    "to_yaml",
    "save",
]

MISSING = "???"

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


class MissingMandatoryValue(ValueError):
    """Raised when a ``???`` mandatory value is accessed before being set."""


class InterpolationError(ValueError):
    """Raised when an interpolation target cannot be resolved."""


# ----------------------------------------------------------------------------------
# Core container
# ----------------------------------------------------------------------------------


class Config:
    """Attribute-accessible view over a nested dict, with lazy interpolation.

    All ``Config`` views created from the same composition share a single root dict;
    mutations write through, so later assignments (e.g. ``cfg.speech.n_dsus = 5000``)
    are visible to every interpolation that references them.
    """

    __slots__ = ("_data", "_root")

    def __init__(self, data: dict[str, Any], root: dict[str, Any] | None = None):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_root", root if root is not None else data)

    # -- access -----------------------------------------------------------------

    def _wrap(self, key: str, value: Any) -> Any:
        if isinstance(value, dict):
            return Config(value, self._root)
        if isinstance(value, str):
            if value == MISSING:
                raise MissingMandatoryValue(f"Missing mandatory value: {key}")
            if "${" in value:
                return _resolve_str(value, self._root)
        if isinstance(value, list):
            return [self._wrap(f"{key}[{i}]", v) for i, v in enumerate(value)]
        return value

    def __getattr__(self, key: str) -> Any:
        try:
            value = self._data[key]
        except KeyError:
            raise AttributeError(f"Config has no key {key!r}. Available: {sorted(self._data)}") from None
        return self._wrap(key, value)

    def __getitem__(self, key: str) -> Any:
        return self._wrap(key, self._data[key])

    def __setattr__(self, key: str, value: Any) -> None:
        if isinstance(value, Config):
            value = value._data
        self._data[key] = value

    __setitem__ = __setattr__

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return ((k, self._wrap(k, v)) for k, v in self._data.items())

    def get(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            return default
        value = self._data[key]
        if value == MISSING:
            return default
        return self._wrap(key, value)

    def select(self, dotted: str, default: Any = None) -> Any:
        """Fetch a dotted path, returning ``default`` if any segment is absent."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Config) or part not in node:
                return default
            node = node[part]
        return node

    def setdefault(self, key: str, value: Any) -> Any:
        if key not in self._data:
            self._data[key] = value
        return self._wrap(key, self._data[key])

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self._data == other._data
        if isinstance(other, dict):
            return self._data == other
        return NotImplemented


# ----------------------------------------------------------------------------------
# Interpolation
# ----------------------------------------------------------------------------------


def _lookup(root: dict[str, Any], dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            raise InterpolationError(f"Interpolation key not found: {dotted!r} (failed at {part!r})")
        node = node[part]
    return node


def _resolve_value(value: Any, root: dict[str, Any], _depth: int = 0) -> Any:
    if isinstance(value, str) and "${" in value:
        return _resolve_str(value, root, _depth)
    return value


def _resolve_str(value: str, root: dict[str, Any], _depth: int = 0) -> Any:
    if _depth > 16:
        raise InterpolationError(f"Interpolation recursion limit exceeded resolving {value!r}")

    def resolve_ref(dotted: str) -> Any:
        if dotted.startswith("hydra:"):
            # Hydra resolver compatibility: only job.config_name is used by the ref conf tree.
            if dotted == "hydra:job.config_name":
                return _lookup(root, "config_name")
            raise InterpolationError(f"Unsupported hydra resolver: {dotted!r}")
        if dotted.startswith("oc.env:"):
            import os

            spec = dotted[len("oc.env:") :]
            name, _, default = spec.partition(",")
            return os.environ.get(name, default if default else None)
        return _lookup(root, dotted)

    m = _INTERP_RE.fullmatch(value)
    if m:  # whole-string interpolation: preserve referenced type
        resolved = resolve_ref(m.group(1))
        return _resolve_value(resolved, root, _depth + 1)

    def sub(match: re.Match) -> str:
        resolved = _resolve_value(resolve_ref(match.group(1)), root, _depth + 1)
        return "" if resolved is None else str(resolved)

    return _INTERP_RE.sub(sub, value)


# ----------------------------------------------------------------------------------
# Composition
# ----------------------------------------------------------------------------------


def _yaml_load(text_or_stream) -> Any:
    """``yaml.load`` with ``SafeLoader`` plus the YAML 1.2 float rule (pyyaml,
    a YAML 1.1 reader, reads ``2e-4`` as a *string*; OmegaConf/Hydra read it
    as a float, and so does this loader)."""
    text = text_or_stream if isinstance(text_or_stream, str) else text_or_stream.read()
    return yaml_subset.load(text)


def load_yaml(path: Path | str) -> dict[str, Any]:
    with open(path) as f:
        data = _yaml_load(f)
    return data if data is not None else {}


def merge(base: dict[str, Any], override: dict[str, Any]) -> dict[str, Any]:
    """Deep merge ``override`` into a copy of ``base`` (override wins)."""
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = merge(out[key], value)
        else:
            out[key] = value
    return out


def _find_config_file(name: str, search_dirs: list[Path]) -> Path:
    for d in search_dirs:
        candidate = d / f"{name}.yaml"
        if candidate.exists():
            return candidate
    raise FileNotFoundError(f"Config {name!r}.yaml not found in any of: {[str(d) for d in search_dirs]}")


def _load_with_defaults(
    path: Path,
    config_root: Path,
    group_root: Path,
    group_selections: dict[str, str | None],
) -> dict[str, Any]:
    """Load a config file, recursively composing its ``defaults:`` list."""
    raw = load_yaml(path)
    defaults = raw.pop("defaults", [])
    composed: dict[str, Any] = {}
    search_dirs = [path.parent, group_root, config_root]

    for entry in defaults:
        if isinstance(entry, str):
            if entry == "_self_":
                composed = merge(composed, raw)
                raw = {}
                continue
            sub_path = _find_config_file(entry, search_dirs)
            composed = merge(composed, _load_with_defaults(sub_path, config_root, sub_path.parent, group_selections))
        elif isinstance(entry, dict):
            (group, option), = entry.items()
            if group.startswith("override hydra/") or group.startswith("hydra/"):
                continue  # hydra logging config: not applicable
            if group in group_selections:
                option = group_selections[group]
            if option == MISSING:
                raise MissingMandatoryValue(
                    f"Config group {group!r} is mandatory — select it on the CLI, e.g. {group}=<option>"
                )
            if option is None:
                continue
            grp_dir = config_root / group
            sub_path = _find_config_file(option, [grp_dir])
            sub_cfg = _load_with_defaults(sub_path, config_root, grp_dir, group_selections)
            composed = merge(composed, {group: sub_cfg})
        else:
            raise ValueError(f"Unsupported defaults entry in {path}: {entry!r}")

    return merge(composed, raw)


def _parse_override_value(text: str) -> Any:
    return _yaml_load(text) if text != "" else ""


def _set_dotted(data: dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = data
    for part in parts[:-1]:
        nxt = node.get(part)
        if not isinstance(nxt, dict):
            nxt = {}
            node[part] = nxt
        node = nxt
    node[parts[-1]] = value


def compose(
    config_dir: Path | str,
    config_name: str,
    overrides: list[str] | None = None,
) -> Config:
    """Compose a config in the manner of ``hydra.compose``.

    Overrides of the form ``group=option`` (where ``conf/<group>/<option>.yaml``
    exists) select a config-group option; everything else is a dotted value
    override. A leading ``+`` (add) is accepted and treated identically.
    """
    config_root = Path(config_dir)
    overrides = list(overrides or [])

    group_selections: dict[str, str | None] = {}
    value_overrides: list[tuple[str, Any]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value, got: {ov!r}")
        key, _, val_text = ov.partition("=")
        key = key.lstrip("+~")
        value = _parse_override_value(val_text)
        if key in ("hydra/job_logging", "hydra/hydra_logging"):  # validated at resolution below
            group_selections[key] = None if value is None else str(value)
        elif isinstance(value, str) and (config_root / key / f"{value}.yaml").exists():
            group_selections[key] = value
        elif value is None and (config_root / key).is_dir() and "." not in key:
            group_selections[key] = None
        else:
            value_overrides.append((key, value))

    top_path = _find_config_file(config_name, [config_root])
    data = _load_with_defaults(top_path, config_root, config_root, group_selections)

    for key, value in value_overrides:
        _set_dotted(data, key, value)

    data.setdefault("config_name", config_name)
    if data.get("config_name") == "${hydra:job.config_name}":
        data["config_name"] = config_name

    # hydra logging config-group surfaces (ref: conf/hydra/{job,hydra}_logging/custom.yaml):
    # users select with `hydra/job_logging=<name>` / `hydra/hydra_logging=<name>`
    # (or `none` to disable); the resolved yaml paths ride along for the runtime —
    # hydra_logging is applied by the CLI entry right after compose, job_logging
    # is dictConfig'd at Trainer/job setup.
    hydra_node = data.setdefault("hydra", {})
    for group in ("job_logging", "hydra_logging"):
        logging_choice = group_selections.pop(f"hydra/{group}", "custom")
        hydra_node.setdefault(group, logging_choice)
        choice = hydra_node[group]
        if choice not in (None, "none"):
            logging_yaml = config_root / "hydra" / group / f"{choice}.yaml"
            if logging_yaml.exists():
                hydra_node[f"{group}_config"] = str(logging_yaml)
            elif choice != "custom":  # an explicit selection must resolve
                raise FileNotFoundError(f"hydra/{group} option {choice!r} not found at {logging_yaml}")
    return Config(data)


# ----------------------------------------------------------------------------------
# Introspection / serialization
# ----------------------------------------------------------------------------------


def missing_keys(cfg: Config | dict[str, Any]) -> set[str]:
    """Dotted paths of all ``???`` values (ref: OmegaConf.missing_keys)."""
    data = cfg._data if isinstance(cfg, Config) else cfg
    out: set[str] = set()

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}[{i}]")
        elif node == MISSING:
            out.add(prefix)

    walk(data, "")
    return out


def to_container(cfg: Config | dict[str, Any] | Any, resolve: bool = True) -> Any:
    """Materialize a plain python object; optionally resolve interpolations."""
    if isinstance(cfg, Config):
        root = cfg._root
        data = cfg._data
    else:
        root = cfg if isinstance(cfg, dict) else {}
        data = cfg

    def conv(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        if resolve and isinstance(node, str) and "${" in node:
            return conv(_resolve_str(node, root))
        return node

    return conv(data)


def to_yaml(cfg: Config | dict[str, Any], resolve: bool = True, sort_keys: bool = False) -> str:
    return yaml_subset.dump(to_container(cfg, resolve=resolve), sort_keys=sort_keys)


def save(cfg: Config | dict[str, Any], path: Path | str, resolve: bool = True) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(to_yaml(cfg, resolve=resolve))
