"""Local dataset sources: the rows ``datasets.load_dataset(source, **kwargs)``
returns the JAX package (``ssi_tpu/data/__init__.py:46-71``) for a local
source, read without the ``datasets`` package.

- ``source="json"`` / ``"parquet"`` / ``"csv"`` with ``data_files`` (a path
  or glob, a list, or a dict of split -> paths) and ``split``;
- ``source=<a local directory>``: the layout of a downloaded HF dataset repo.
  Its splits resolve as ``datasets`` resolves them: from the default config's
  ``data_files`` in the ``configs:`` block of ``<dir>/README.md``'s YAML
  header (read by ``config/yaml_subset.py``), else from the shard names
  ``data/<split>-00000-of-00002.*``, else from the split keywords
  (``train|training``, ``validation|valid|dev|val``,
  ``test|testing|eval|evaluation``) in directory, then file names, else every
  file is ``train``. The builder follows the files' extension.

Rows keep each column in file order, with the Python values and types the
JAX package's rows hold:

- parquet (``pyarrow``, imported when a parquet file is read, and refused by
  name when missing): shards in ``data_files`` order, row groups in file
  order, each table cast to the first shard's schema, values as
  ``to_pylist`` gives them (``list<int64>`` a list of ints, ``null`` None);
- csv: a first-party reader on the stdlib ``csv`` module that infers each
  column as ``datasets`` does through ``pandas.read_csv`` and Arrow: per
  chunk of 10,000 rows, int64 if every non-blank field is an integer (float64
  when the column has a blank), else float64 by pandas' own decimal parser
  (``precise_xstrtod``), else bool for ``True``/``False`` words, else str;
  pandas' default NA words read as None, whitespace-only lines are skipped,
  duplicate and empty header names are renamed as pandas renames them, and
  a later chunk is cast to the first chunk's types;
- json: JSON lines (``data/__init__.py``'s reader).

``tests/test_torch_data_sources.py`` holds each rule against the JAX
function. ``text``, ``arrow`` and other builders, hub ids, compressed files
and the builders' own options are refused.
"""

from __future__ import annotations

from collections import Counter
from collections.abc import Iterator
import csv
import json
import math
import os
from pathlib import Path, PurePosixPath
import re
from typing import Any

from ssi_tpu_torch.utils import import_optional

__all__ = ["resolve_split", "read_split"]

# --- split patterns: copies of datasets.data_files' (fsspec >= 2023.12), held equal by the tests
SPLIT_KEYWORDS = {
    "train": ["train", "training"],
    "validation": ["validation", "valid", "dev", "val"],
    "test": ["test", "testing", "eval", "evaluation"],
}
NON_WORDS_CHARS = "-._ 0-9"
KEYWORDS_IN_FILENAME_BASE_PATTERNS = ["**/{keyword}[{sep}]*", "**/*[{sep}]{keyword}[{sep}]*"]
KEYWORDS_IN_DIR_NAME_BASE_PATTERNS = [
    "**/{keyword}/**",
    "**/{keyword}[{sep}]*/**",
    "**/*[{sep}]{keyword}/**",
    "**/*[{sep}]{keyword}[{sep}]*/**",
]
DEFAULT_PATTERNS_SPLIT_IN_FILENAME = {
    split: [p.format(keyword=k, sep=NON_WORDS_CHARS) for k in keywords for p in KEYWORDS_IN_FILENAME_BASE_PATTERNS]
    for split, keywords in SPLIT_KEYWORDS.items()
}
DEFAULT_PATTERNS_SPLIT_IN_DIR_NAME = {
    split: [p.format(keyword=k, sep=NON_WORDS_CHARS) for k in keywords for p in KEYWORDS_IN_DIR_NAME_BASE_PATTERNS]
    for split, keywords in SPLIT_KEYWORDS.items()
}
SPLIT_PATTERN_SHARDED = "data/{split}-[0-9][0-9][0-9][0-9][0-9]-of-[0-9][0-9][0-9][0-9][0-9]*.*"
ALL_DEFAULT_PATTERNS = [
    {"logs": ["**/*.eval"]},
    DEFAULT_PATTERNS_SPLIT_IN_DIR_NAME,
    DEFAULT_PATTERNS_SPLIT_IN_FILENAME,
    {"train": ["**"]},
]
FILES_TO_IGNORE = ["README.md", "config.json", "dataset_info.json", "dataset_infos.json", "dummy_data.zip",
                   "dataset_dict.json"]
_SPLIT_NAME = re.compile(r"^\w+(\.\w+)*$")

# the tabular builders by extension: a directory's split takes the most common one; the port reads three
_BUILDERS = {".parquet": "parquet", ".csv": "csv", ".json": "json", ".jsonl": "json",
             ".tsv": "csv (sep='\\t')", ".ndjson": "json", ".txt": "text", ".arrow": "arrow"}
_PORTED = {"parquet", "csv", "json"}
_README_KEYS = {"config_name", "data_files", "data_dir", "default"}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to ssi_tpu_torch: it reads local json, parquet and csv files and local dataset "
        "directories (ROADMAP.md queue A, item A12: hub ids and the text and arrow sources)"
    )


# --------------------------------------------------------------------------------
# Data files: patterns -> files, as datasets.data_files.resolve_pattern resolves them
# --------------------------------------------------------------------------------


def _glob_regex(pattern: str) -> re.Pattern:
    """fsspec's glob on a POSIX path: ``*`` and ``?`` within a name, ``[...]``
    a class (``[!...]`` negated), ``**`` any run of names (none included when
    a ``/`` follows it)."""
    out, i = [], 0
    while i < len(pattern):
        c = pattern[i]
        if pattern.startswith("**/", i):
            out.append("(?:.*/)?")
            i += 3
        elif pattern.startswith("**", i):
            out.append(".*")
            i += 2
        elif c == "*":
            out.append("[^/]*")
            i += 1
        elif c == "?":
            out.append("[^/]")
            i += 1
        elif c == "[" and "]" in pattern[i + 2:]:
            end = pattern.index("]", i + 2)
            body = pattern[i + 1:end]
            out.append("[" + ("^" + body[1:] if body.startswith("!") else body).replace("\\", "\\\\") + "]")
            i = end + 1
        else:
            out.append(re.escape(c))
            i += 1
    return re.compile("".join(out) + r"\Z", re.S)


def _has_magic(pattern: str) -> bool:
    return any(c in pattern for c in "*?[")


def _hidden_parts(path: str) -> int:
    return sum(1 for part in PurePosixPath(path).parts if part.startswith(".") and set(part) != {"."})


def _special_parts(path: str) -> int:
    return sum(1 for part in PurePosixPath(path).parent.parts if part.startswith("__"))


def resolve_pattern(pattern: str, base: Path) -> list[Path]:
    """The files ``pattern`` (relative to ``base``, or absolute) names, sorted
    by path, without hidden files, ``__*`` directories and the repo's
    metadata files unless the pattern names them."""
    full = Path(pattern) if Path(pattern).is_absolute() else base / pattern
    full_posix = full.as_posix()
    if not _has_magic(pattern):
        if not full.is_file():
            raise FileNotFoundError(f"Unable to find data file {pattern!r}")
        return [full]
    # the walk starts at the pattern's longest literal directory
    root = Path("/") if full_posix.startswith("/") else Path(".")
    for part in PurePosixPath(full_posix).parts[(1 if full_posix.startswith("/") else 0):]:
        if _has_magic(part):
            break
        root = root / part
    if not root.is_dir():
        return []
    regex = _glob_regex(full_posix)
    ignore = set(FILES_TO_IGNORE) - {PurePosixPath(full_posix).name}
    matched = []
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = Path(dirpath, name).as_posix()
            if (regex.match(path) and name not in ignore and os.path.isfile(path)
                    and _special_parts(path) == _special_parts(full_posix)
                    and _hidden_parts(path) == _hidden_parts(full_posix)):
                matched.append(path)
    return [Path(p) for p in sorted(matched)]


def sanitize_patterns(patterns: Any) -> dict[str, list[str]]:
    """``data_files`` as a dict of split -> patterns (``datasets.data_files.sanitize_patterns``)."""
    if isinstance(patterns, dict):
        return {str(k): [str(p) for p in v] if isinstance(v, (list, tuple)) else [str(v)] for k, v in patterns.items()}
    if isinstance(patterns, (str, Path)):
        return {"train": [str(patterns)]}
    if isinstance(patterns, (list, tuple)):
        if any(isinstance(p, dict) for p in patterns):
            for p in patterns:
                if not (isinstance(p, dict) and len(p) == 2 and "split" in p and isinstance(p.get("path"), (str, list))):
                    raise ValueError("Invalid format for data_files entry. Each item must be a dictionary with the "
                                     f"structure {{'split': <split_name>, 'path': <path_or_list_of_paths>}}.\n"
                                     f"Received: {p}")
            splits = [p["split"] for p in patterns]
            if len(set(splits)) != len(splits):
                raise ValueError(f"Some splits are duplicated in data_files: {splits}")
            return {str(p["split"]): p["path"] if isinstance(p["path"], list) else [p["path"]] for p in patterns}
        return {"train": [str(p) for p in patterns]}
    raise ValueError(f"data_files must be a path, a list of paths, or a dict of split -> paths; got {patterns!r}")


def _resolve_splits(patterns: dict[str, list[str]], base: Path) -> dict[str, list[Path]]:
    out = {}
    for split, split_patterns in patterns.items():
        files: list[Path] = []
        for pattern in split_patterns:
            files.extend(resolve_pattern(pattern, base))  # a missing literal path raises
        out[split] = files
    return out


def _string_to_dict(string: str, pattern: str) -> dict[str, str] | None:
    """``datasets.utils.py_utils.string_to_dict``."""
    pattern = re.sub(r"{([^:}]+)(?::[^}]+)?}", r"{\1}", pattern)
    found = re.search(re.sub(r"{(.+?)}", r"(?P<_\1>.+)", pattern), string)
    return None if found is None else dict(zip(re.findall(r"{(.+?)}", pattern), found.groups()))


def default_split_patterns(base: Path) -> dict[str, list[str]]:
    """``datasets.data_files.get_data_patterns``: the shard names, then the
    split keywords in directory and file names, then everything as train."""
    shards = resolve_pattern(SPLIT_PATTERN_SHARDED.replace("{split}", "*"), base)
    if shards:
        splits = {_string_to_dict(p.name, PurePosixPath(SPLIT_PATTERN_SHARDED).name)["split"] for p in shards}
        if any(not _SPLIT_NAME.match(s) for s in splits):
            raise ValueError(f"Split name should match '{_SPLIT_NAME.pattern}'' but got '{splits}'.")
        ordered = [s for s in SPLIT_KEYWORDS if s in splits] + sorted(splits - set(SPLIT_KEYWORDS))
        return {s: [SPLIT_PATTERN_SHARDED.format(split=s)] for s in ordered}
    for patterns in ALL_DEFAULT_PATTERNS:
        found = [split for split, split_patterns in patterns.items()
                 if any(resolve_pattern(p, base) for p in split_patterns)]
        if found:
            return {split: patterns[split] for split in found}
    raise FileNotFoundError(f"The directory {base} holds no data files")


def _readme_config(directory: Path) -> dict[str, Any] | None:
    """The default config of ``<dir>/README.md``'s ``configs:`` block
    (``datasets``' ``MetadataConfigs``): the only one, the one named
    ``default`` or the one marked ``default: true``."""
    readme = directory / "README.md"
    if not readme.is_file():
        return None
    text = readme.read_text(encoding="utf-8")
    header = re.match(r"^---\s*\n(.*?)\n---\s*(?:\n|$)", text, re.S)
    if header is None:
        return None
    from ssi_tpu_torch.config.yaml_subset import load

    configs = (load(header.group(1)) or {}).get("configs")
    if not configs:
        return None
    by_name = {c["config_name"]: c for c in configs}
    defaults = [n for n, c in by_name.items() if len(by_name) == 1 or n == "default" or c.get("default")]
    if len(defaults) > 1:
        raise ValueError(f"Dataset has several default configs: '{defaults[0]}' and '{defaults[1]}'.")
    if not defaults:
        raise not_ported(f"Choosing one of the configs {list(by_name)} of {readme} (none is the default)")
    name = defaults[0]
    config = by_name[name]
    extra = set(config) - _README_KEYS
    if extra:
        raise not_ported(f"The builder options {sorted(extra)} of config {name!r} in {readme}")
    return config


def _builder_of(files: list[Path]) -> tuple[str, list[Path]]:
    """The split's builder by its files' most common tabular extension
    (``datasets``' tie-break: parquet, arrow, jsonl, json, csv), and its files."""
    counts = Counter(p.suffix.lower() for p in files if p.suffix.lower() in _BUILDERS)
    if not counts:
        raise FileNotFoundError(f"No data files among {[str(p) for p in files]}")
    ext = max(counts, key=lambda e: (counts[e], e == ".parquet", e == ".arrow", e == ".jsonl", e == ".json",
                                      e == ".csv", e))
    builder = _BUILDERS[ext]
    if builder not in _PORTED:
        raise not_ported(f"The {builder!r} builder (files with extension {ext})")
    return builder, [p for p in files if _BUILDERS.get(p.suffix.lower()) == builder]


def resolve_split(source: str, kwargs: dict[str, Any]) -> tuple[str, list[Path]]:
    """(builder, files) of the split that ``load_dataset(source, **kwargs)``
    reads: ``kwargs`` holds ``split`` and maybe ``data_files``."""
    kwargs = dict(kwargs)
    split, data_files = kwargs.pop("split", None), kwargs.pop("data_files", None)
    if source in _PORTED:
        builder = source
        if data_files is None:
            raise ValueError(f"source={source!r} needs data_files")
        splits = _resolve_splits(sanitize_patterns(data_files), Path.cwd())
    elif Path(source).is_dir():
        base = Path(source)
        if data_files is not None:
            patterns = sanitize_patterns(data_files)
        else:
            config = _readme_config(base)
            if config is not None and config.get("data_dir"):
                base = base / config["data_dir"]
            if config is not None and config.get("data_files") is not None:
                patterns = sanitize_patterns(config["data_files"])
            else:
                patterns = default_split_patterns(base)
        splits = _resolve_splits(patterns, base)
        builder = None
    elif source in {"text", "arrow"} or "/" not in source:
        raise not_ported(f"Dataset source {source!r}")
    else:
        raise not_ported(f"The hub dataset {source!r}")
    if kwargs:
        raise not_ported(f"The load_dataset arguments {sorted(kwargs)} (source={source!r})")
    if split is None:
        raise ValueError(f"source={source!r} needs a 'split' (e.g. split='train')")
    if split not in splits:
        raise ValueError(f'Unknown split "{split}". Should be one of {list(splits)}.')
    if builder is None:
        builder, files = _builder_of(splits[split])
    else:
        files = splits[split]
    return builder, files


# --------------------------------------------------------------------------------
# Readers: a split's rows, lazily and in file order
# --------------------------------------------------------------------------------


def read_split(builder: str, files: list[Path]) -> Iterator[dict[str, Any]]:
    return {"json": _json_rows, "parquet": _parquet_rows, "csv": _csv_rows}[builder](files)


def _json_rows(files: list[Path]) -> Iterator[dict[str, Any]]:
    for path in files:
        with open(path, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    yield json.loads(line)


def _parquet_rows(files: list[Path]) -> Iterator[dict[str, Any]]:
    pq = import_optional("pyarrow.parquet", "Reading parquet files")
    schema = None
    for path in files:
        pf = pq.ParquetFile(path)
        if schema is None:
            schema = pf.schema_arrow
        for i in range(pf.num_row_groups):
            table = pf.read_row_group(i)
            if table.schema != schema:
                table = table.cast(schema)
            yield from table.to_pylist()


# --- csv -------------------------------------------------------------------------

# pandas' default NA strings (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
                       "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
CSV_CHUNK_ROWS = 10_000  # datasets' CsvConfig.chunksize: types are inferred per chunk
_TRUE, _FALSE = {"True", "TRUE", "true"}, {"False", "FALSE", "false"}
_WS = " \t\n\v\f\r"
_INT = re.compile(r"[ \t\n\v\f\r]*[+-]?[0-9]+[ \t\n\v\f\r]*\Z")
_INFS = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf, "infinity": math.inf, "+infinity": math.inf,
         "-infinity": -math.inf}
_POW10 = [float(f"1e{i}") for i in range(309)]
_INT64 = (-(2**63), 2**63 - 1)


def precise_xstrtod(s: str) -> float | None:
    """pandas' default decimal parser (``precise_xstrtod``): at most 17
    digits, then one scaling by a power of ten; None where it does not read
    the whole field."""
    n, p = len(s), 0
    while p < n and s[p] in _WS:
        p += 1
    negative = p < n and s[p] == "-"
    p += p < n and s[p] in "+-"
    number, exponent, n_digits, n_decimals = 0.0, 0, 0, 0
    while p < n and "0" <= s[p] <= "9":
        if n_digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            n_digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        while n_digits < 17 and p < n and "0" <= s[p] <= "9":
            number = number * 10.0 + (ord(s[p]) - 48)
            p += 1
            n_digits += 1
            n_decimals += 1
        while p < n and "0" <= s[p] <= "9":
            p += 1
        exponent -= n_decimals
    if n_digits == 0:
        return None
    if negative:
        number = -number
    if p < n and s[p] in "eE":
        q = p + 1
        negative_exp = q < n and s[q] == "-"
        q += q < n and s[q] in "+-"
        k = e = 0
        while k < 17 and q < n and "0" <= s[q] <= "9":
            e, k, q = e * 10 + (ord(s[q]) - 48), k + 1, q + 1
        if k:
            exponent, p = exponent - e if negative_exp else exponent + e, q
    if exponent > 308:
        number = math.copysign(math.inf, number) if number else number
    elif exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -616:
        number *= 0.0
    elif exponent < -308:
        number = number / _POW10[-308 - exponent] / _POW10[308]
    else:
        number /= _POW10[-exponent]
    while p < n and s[p] in _WS:
        p += 1
    return number if p == n else None


def _infer_column(fields: list[str | None]) -> tuple[str, list[Any]]:
    """(type, values) of one column of a chunk, by pandas' order: int, float, bool, str."""
    present = [f for f in fields if f is not None]
    if all(_INT.match(f) for f in present):
        ints = [None if f is None else int(f) for f in fields]
        if any(v is not None and not _INT64[0] <= v <= _INT64[1] for v in ints):
            if len(present) == len(fields) and all(0 <= v < 2**64 for v in ints):
                return "uint", ints
            raise not_ported("A csv column of integers beyond int64, with a blank or below zero,")
        if len(present) == len(fields):
            return "int", ints
        return "float", [None if v is None else float(v) for v in ints]
    floats = [None if f is None else precise_xstrtod(f) if f.lower() not in _INFS else _INFS[f.lower()] for f in fields]
    if all(v is not None for v, f in zip(floats, fields) if f is not None):
        return "float", [None if v is None or v != v else v for v in floats]
    if all(f in _TRUE or f in _FALSE for f in present):
        return "bool", [None if f is None else f in _TRUE for f in fields]
    return "str", fields


def _cast(values: list[Any], have: str, want: str, column: str) -> list[Any]:
    """A later chunk's column to the first chunk's type, as Arrow's cast in
    ``datasets``' writer: ints to floats, integral floats to ints, blanks to
    any type; other casts are refused."""
    if have == want or all(v is None for v in values):
        return values
    if (have, want) == ("int", "float"):
        return [None if v is None else float(v) for v in values]
    if (have, want) == ("float", "int") and all(v is None or (math.isfinite(v) and v == int(v)) for v in values):
        return [None if v is None else int(v) for v in values]
    raise not_ported(f"A csv column {column!r} typed {want} in its first {CSV_CHUNK_ROWS} rows and {have} later")


def _header_names(header: list[str]) -> list[str]:
    """pandas' column names: an empty name ``Unnamed: i``, duplicates mangled
    ``name.1``, ``name.2`` (named columns first, skipping names the header
    already has)."""
    names = [h if h != "" else f"Unnamed: {i}" for i, h in enumerate(header)]
    unnamed = [i for i, h in enumerate(header) if h == ""]
    counts: dict[str, int] = {}
    for i in [i for i in range(len(names)) if i not in unnamed] + unnamed:
        col = old = names[i]
        cur = counts.get(col, 0)
        if cur > 0:
            while cur > 0:
                counts[old] = cur + 1
                col = f"{old}.{cur}"
                cur = cur + 1 if col in names else counts.get(col, 0)
            names[i] = col
        counts[col] = cur + 1
    return names


def _csv_chunks(path: Path) -> Iterator[tuple[list[str], list[list[str | None]]]]:
    with open(path, encoding="utf-8-sig", newline="") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        if header is None:
            raise ValueError(f"No columns to parse from file {path}")
        names = _header_names(header)
        chunk: list[list[str | None]] = []
        for row in reader:
            if all(c in " \t" for c in "".join(row)) and len(row) <= 1:
                continue  # a blank or whitespace-only line
            if len(row) > len(names):
                raise ValueError(f"Error tokenizing data. C error: Expected {len(names)} fields in line "
                                 f"{reader.line_num}, saw {len(row)}")
            chunk.append([None if f in NA_VALUES else f for f in row] + [None] * (len(names) - len(row)))
            if len(chunk) == CSV_CHUNK_ROWS:
                yield names, chunk
                chunk = []
        if chunk:
            yield names, chunk


def _csv_rows(files: list[Path]) -> Iterator[dict[str, Any]]:
    types: dict[str, str] = {}  # the first chunk's, as datasets' writer keeps its first table's schema
    for path in files:
        for names, chunk in _csv_chunks(path):
            columns = []
            for j, name in enumerate(names):
                have, values = _infer_column([row[j] for row in chunk])
                columns.append(_cast(values, have, types.setdefault(name, have), name))
            for values in zip(*columns):
                yield dict(zip(names, values))
