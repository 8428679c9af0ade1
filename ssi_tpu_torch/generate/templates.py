"""Prompt-template rendering for standalone sample-wise generation — the
port's twin of ``ssi_tpu/generate/templates.py``, over its own copies of the
seven templates (``ssi_tpu_torch/templates/*.jinja``, byte-equal to the JAX
package's).

The port does not depend on jinja2. Every shipped template uses only
``{{ name }}`` substitution, which this module renders itself with jinja2's
``StrictUndefined`` semantics (an undefined variable raises
:class:`UndefinedError`, with jinja2's message) and ``keep_trailing_newline``.
A template from a path that holds any other Jinja syntax (``{%``, ``{#``, a
filter or an expression inside ``{{ }}``) is rendered by jinja2 when it
imports, and otherwise refused with an error that says so: it is never
rendered wrongly. ``tests/test_torch_generate_sample.py`` holds every
template's rendering equal to the JAX function's.
"""

from __future__ import annotations

from itertools import groupby
from pathlib import Path
import re
from typing import Any

from ssi_tpu_torch.speech import MODALITY_TOKEN_SPEECH, MODALITY_TOKEN_TEXT, dsu2pua

TEMPLATES_DIR = Path(__file__).resolve().parent.parent / "templates"

_VARIABLE = re.compile(r"\{\{\s*([A-Za-z_][A-Za-z0-9_]*)\s*\}\}")
_OTHER_SYNTAX = re.compile(r"\{\{|\{%|\{#")


class UndefinedError(NameError):
    """A template variable that was not given (jinja2's ``StrictUndefined``)."""


def list_templates() -> list[str]:
    return sorted(p.stem for p in TEMPLATES_DIR.glob("*.jinja"))


def _render_variables(source: str, env_vars: dict[str, Any]) -> str:
    def substitute(match: re.Match) -> str:
        name = match.group(1)
        if name not in env_vars:
            raise UndefinedError(f"'{name}' is undefined")
        return str(env_vars[name])

    return _VARIABLE.sub(substitute, source)


def _render_with_jinja2(path: Path, source: str, env_vars: dict[str, Any]) -> str:
    try:
        import jinja2
    except ImportError:
        raise NotImplementedError(
            f"Template {path} uses Jinja syntax other than {{{{ name }}}} substitution, which the port renders "
            "only through jinja2, and jinja2 is not installed"
        ) from None
    tmpl = jinja2.Environment(undefined=jinja2.StrictUndefined, keep_trailing_newline=True).from_string(source)
    return tmpl.render(**env_vars)


def render_template(
    template: str | Path,
    speech_tokens: list[int] | None = None,
    deduplicate: bool = False,
    **variables: Any,
) -> str:
    """Render a prompt template by name (from ssi_tpu_torch/templates) or path.

    Args:
        template: template stem (e.g. ``"basic"``) or a path to a ``.jinja`` file.
        speech_tokens: raw DSU ids; rendered as a PUA character span.
        deduplicate: drop consecutive duplicate speech tokens before encoding.
        **variables: additional template variables.
    """
    path = Path(template)
    if not path.suffix:
        path = TEMPLATES_DIR / f"{template}.jinja"
    if not path.exists():
        raise FileNotFoundError(f"Template not found: {path} (available: {list_templates()})")

    env_vars: dict[str, Any] = {
        "MODALITY_TOKEN_SPEECH": MODALITY_TOKEN_SPEECH,
        "MODALITY_TOKEN_TEXT": MODALITY_TOKEN_TEXT,
        **variables,
    }
    if speech_tokens is not None:
        toks = [k for k, _ in groupby(speech_tokens)] if deduplicate else list(speech_tokens)
        env_vars["speech_tokens"] = "".join(dsu2pua(t) for t in toks)

    source = path.read_text()
    if _OTHER_SYNTAX.search(_VARIABLE.sub("", source)):
        return _render_with_jinja2(path, source, env_vars)
    return _render_variables(source, env_vars)
