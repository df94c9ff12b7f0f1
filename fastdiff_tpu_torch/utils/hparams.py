"""Hierarchical YAML configs with CLI overrides (``fastdiff_tpu/utils/hparams.py``).

- ``base_config:`` lists resolve depth-first with dict-merge override and a
  cycle guard; relative paths resolve against the including file.
- With ``--exp_name``, a saved ``checkpoints/<exp>/config.yaml`` takes
  precedence over the config file unless ``--reset``.
- ``--hparams "a=1,b.c=2,d=[1 1 1]"`` dotted-key overrides: bools, lists and
  dicts go through ``ast.literal_eval`` (spaces in lists become commas),
  everything else is cast to the existing value's type.
- The merged config is saved to the work dir (not under ``--infer``).

The YAML reader and writer are this module's own, with no PyYAML: the card's
machine has none. The reader covers the subset that the configs use, and
types every scalar as ``yaml.safe_load`` (YAML 1.1) does:

- block mappings nested by indentation, block lists (``- item``, also at the
  parent key's indentation, as ``yaml.safe_dump`` writes them), flow lists of
  scalars (``[8, 8, 4]``, ``[]``, ``['dp']``, nested), the empty flow mapping
  ``{}``;
- plain, single-quoted and double-quoted scalars on one line; full-line and
  trailing ``#`` comments;
- null (``~``, ``null``, empty), bool (``true``/``yes``/``on`` and their
  negations), decimal int and float (``2e-4`` has no dot and stays a string,
  as in YAML 1.1; ``1.0e-06``, ``.inf``, ``.nan`` are floats).

Anything else (anchors, tags, block scalars, multi-line scalars, documents,
base-2/8/16 or sexagesimal numbers, timestamps, tabs) raises ``YamlError``
naming the line. ``dump_yaml`` writes a config that this reader and
``yaml.safe_load`` both read back to the same dict.
"""

from __future__ import annotations

import argparse
import ast
import math
import os
import re
import shutil

hparams = {}
_printed_once = False


class YamlError(ValueError):
    """A config outside the YAML subset this module reads or writes."""


# --------------------------------------------------------------------------
# scalars
# --------------------------------------------------------------------------

_BOOL = {s: v for v, words in ((True, "yes true on"), (False, "no false off"))
         for w in words.split() for s in (w, w.capitalize(), w.upper())}
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# forms YAML 1.1 types that this reader does not: base 2, 8 and 16 and
# sexagesimal numbers, timestamps, the merge key and the value key
_UNSUPPORTED = re.compile(
    r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
    r"|[0-9]{4}-[0-9][0-9]?-[0-9][0-9]?(?:[Tt ].*)?$|<<$|=$")
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"


def _plain(text: str, where: str):
    """A plain scalar typed as ``yaml.safe_load`` types it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    m = _INF.match(text)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    if _UNSUPPORTED.match(text) or re.search(r":(?: |$)", text):
        raise YamlError(f"{where}: the scalar {text!r} is outside the "
                        "supported YAML subset")
    if text[0] in _INDICATORS and not (text[0] in "-?:" and len(text) > 1
                                       and text[1] not in " "):
        raise YamlError(f"{where}: {text!r} starts with a YAML indicator "
                        "this reader does not support")
    return text


def _quoted(s: str, i: int, where: str) -> tuple:
    """The quoted scalar starting at ``s[i]`` and the index after it."""
    quote = s[i]
    out = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if quote == "'" and c == "'":
            if s[j + 1: j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if quote == '"' and c == '"':
            return "".join(out), j + 1
        if quote == '"' and c == "\\":
            esc = s[j + 1: j + 2]
            table = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
                     "0": "\0", " ": " "}
            if esc not in table:
                raise YamlError(f"{where}: escape \\{esc} is outside the "
                                "supported YAML subset")
            out.append(table[esc])
            j += 2
            continue
        out.append(c)
        j += 1
    raise YamlError(f"{where}: unterminated quoted scalar (multi-line "
                    "scalars are outside the supported YAML subset)")


def _strip_comment(s: str) -> str:
    """``s`` without a trailing ``#`` comment (one that follows a blank or
    starts the text), ignoring ``#`` inside quotes."""
    quote = None
    j = 0
    while j < len(s):
        c = s[j]
        if quote == "'" and c == "'" and s[j + 1: j + 2] == "'":
            j += 1                            # '' inside single quotes
        elif quote == '"' and c == "\\":
            j += 1                            # an escaped character
        elif quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (j == 0 or s[j - 1] in " [,"):
            quote = c
        elif c == "#" and (j == 0 or s[j - 1] in " \t"):
            return s[:j].rstrip()
        j += 1
    return s.rstrip()


def _flow(s: str, i: int, where: str) -> tuple:
    """The flow list (or empty flow mapping) at ``s[i]`` and the index
    after it."""
    if s[i] == "{":
        j = i + 1
        while j < len(s) and s[j] == " ":
            j += 1
        if s[j: j + 1] != "}":
            raise YamlError(f"{where}: only the empty flow mapping {{}} is "
                            "supported")
        return {}, j + 1
    items = []
    j = i + 1
    while True:
        while j < len(s) and s[j] == " ":
            j += 1
        if j >= len(s):
            raise YamlError(f"{where}: unterminated flow list")
        if s[j] == "]" and not items:
            return items, j + 1
        if s[j] in "[{":
            item, j = _flow(s, j, where)
        elif s[j] in "'\"":
            item, j = _quoted(s, j, where)
        else:
            k = j
            while k < len(s) and s[k] not in ",]{}[":
                k += 1
            text = s[j:k].strip()
            if not text:
                raise YamlError(f"{where}: empty item in a flow list")
            item, j = _plain(text, where), k
        items.append(item)
        while j < len(s) and s[j] == " ":
            j += 1
        if s[j: j + 1] == ",":
            j += 1
        elif s[j: j + 1] == "]":
            return items, j + 1
        else:
            raise YamlError(f"{where}: expected ',' or ']' in a flow list")


def _value(text: str, where: str):
    """An inline value: a flow list or mapping, a quoted or a plain
    scalar."""
    if text[:1] in "[{":
        value, end = _flow(text, 0, where)
    elif text[:1] in "'\"":
        value, end = _quoted(text, 0, where)
    else:
        return _plain(text, where)
    if text[end:].strip():
        raise YamlError(f"{where}: unexpected text after a value: "
                        f"{text[end:]!r}")
    return value


def _split_key(text: str, where: str):
    """(key, rest) of a ``key: value`` line, or None when the line holds no
    mapping key."""
    if text[:1] in "'\"":
        key, end = _quoted(text, 0, where)
        rest = text[end:]
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            return None
        return key, rest[1:].strip()
    m = re.search(r":(?: |$)", text)
    if not m:
        return None
    return _plain(text[:m.start()].rstrip(), where), text[m.end():].strip()


# --------------------------------------------------------------------------
# block structure
# --------------------------------------------------------------------------

def _lines(text: str, name: str) -> list:
    """(indent, content, where) of every line that holds more than a
    comment."""
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        if "\t" in raw[: len(raw) - len(raw.lstrip(" \t"))]:
            raise YamlError(f"{where}: tab in indentation")
        content = _strip_comment(raw.strip(" "))
        if not content:
            continue
        if content in ("---", "...") or content.startswith(("--- ", "%")):
            raise YamlError(f"{where}: document markers and directives are "
                            "outside the supported YAML subset")
        out.append((len(raw) - len(raw.lstrip(" ")), content, where))
    return out


def _block(lines: list, i: int, indent: int) -> tuple:
    """The block node whose first line is ``lines[i]`` at ``indent``, and
    the index of the first line after it."""
    content = lines[i][1]
    if content == "-" or content.startswith("- "):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _nested(lines: list, i: int, indent: int, seq_ok: bool, where: str):
    """The node under a ``key:`` or ``-`` with nothing after it at
    ``indent``: a deeper block, a block list at the same indentation (for a
    key), or null."""
    if i < len(lines):
        child_indent, content, _ = lines[i]
        is_seq = content == "-" or content.startswith("- ")
        if child_indent > indent or (seq_ok and is_seq
                                     and child_indent == indent):
            return _block(lines, i, child_indent)
    return None, i


def _mapping(lines: list, i: int, indent: int) -> tuple:
    out = {}
    while i < len(lines):
        ind, content, where = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise YamlError(f"{where}: unexpected indentation (multi-line "
                            "scalars are outside the supported YAML subset)")
        parts = _split_key(content, where)
        if parts is None:
            raise YamlError(f"{where}: expected 'key: value', got "
                            f"{content!r}")
        key, rest = parts
        if rest:
            out[key] = _value(rest, where)
            i += 1
        else:
            out[key], i = _nested(lines, i + 1, indent, True, where)
    return out, i


def _sequence(lines: list, i: int, indent: int) -> tuple:
    out = []
    while i < len(lines):
        ind, content, where = lines[i]
        if ind != indent or not (content == "-" or content.startswith("- ")):
            if ind > indent:
                raise YamlError(f"{where}: unexpected indentation")
            break
        rest = content[1:].strip()
        if rest == "-" or rest.startswith("- "):
            # a list inside a list on the item's line ("- - 2"): its items
            # sit at the inner dash's column
            inner = ind + len(content) - len(rest)
            lines[i] = (inner, rest, where)
            item, i = _sequence(lines, i, inner)
            out.append(item)
        elif rest:
            if _split_key(rest, where) is not None:
                raise YamlError(f"{where}: mappings inside block lists are "
                                "outside the supported YAML subset")
            out.append(_value(rest, where))
            i += 1
        else:
            item, i = _nested(lines, i + 1, indent, False, where)
            out.append(item)
    return out, i


def parse_yaml(text: str, name: str = "<yaml>"):
    """The document in ``text`` as ``yaml.safe_load`` reads it, for the
    subset in the module docstring; ``YamlError`` outside it."""
    lines = _lines(text, name)
    if not lines:
        return None
    indent, content, where = lines[0]
    if len(lines) == 1 and _split_key(content, where) is None and not (
            content == "-" or content.startswith("- ")):
        return _value(content, where)
    node, i = _block(lines, 0, indent)
    if i != len(lines):
        raise YamlError(f"{lines[i][2]}: unexpected indentation")
    return node


def load_yaml(path: str):
    with open(path) as f:
        return parse_yaml(f.read(), path)


def _scalar_text(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        if "\n" in value or "\r" in value:
            raise YamlError(f"cannot write the multi-line string {value!r}")
        if re.fullmatch(r"[A-Za-z0-9_./][A-Za-z0-9_./+-]*", value):
            try:
                if _plain(value, "") == value:
                    return value
            except YamlError:
                pass
        return "'" + value.replace("'", "''") + "'"
    raise YamlError(f"cannot write a {type(value).__name__} to a config")


def _flow_text(value) -> str:
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_flow_text(v) for v in value) + "]"
    if isinstance(value, dict):
        if value:
            raise YamlError("cannot write a mapping inside a list")
        return "{}"
    return _scalar_text(value)


def dump_yaml(cfg: dict) -> str:
    """``cfg`` as block YAML (keys sorted, as ``yaml.safe_dump`` sorts them;
    lists in flow style) that ``parse_yaml`` and ``yaml.safe_load`` both
    read back to ``cfg``."""
    out = []

    def emit(node: dict, indent: int):
        for key in sorted(node, key=str):
            value = node[key]
            head = " " * indent + _scalar_text(key) + ":"
            if isinstance(value, dict) and value:
                out.append(head)
                emit(value, indent + 2)
            else:
                out.append(f"{head} {_flow_text(value)}")

    emit(cfg, 0)
    return "\n".join(out) + "\n"


# --------------------------------------------------------------------------
# the config cascade
# --------------------------------------------------------------------------

def _deep_merge(dst: dict, src: dict) -> None:
    """Merge ``src`` into ``dst`` in place; nested dicts merge recursively."""
    for key, val in src.items():
        if isinstance(val, dict) and isinstance(dst.get(key), dict):
            _deep_merge(dst[key], val)
        else:
            dst[key] = val


def load_config_cascade(config_path: str, _seen=None) -> dict:
    """Load a YAML file, resolving its ``base_config`` ancestry depth-first."""
    if _seen is None:
        _seen = set()
    if not os.path.exists(config_path):
        return {}
    _seen.add(os.path.normpath(config_path))
    cfg = load_yaml(config_path) or {}
    bases = cfg.get("base_config", [])
    if not isinstance(bases, list):
        bases = [bases]
    merged: dict = {}
    for base in bases:
        if base.startswith("."):
            base = os.path.normpath(os.path.join(os.path.dirname(config_path),
                                                 base))
        if os.path.normpath(base) not in _seen:
            _deep_merge(merged, load_config_cascade(base, _seen))
    _deep_merge(merged, cfg)
    return merged


def _coerce(node: dict, key: str, raw: str):
    """Coerce a CLI-override string to the type already present in the
    config."""
    raw = raw.strip("'\" ")
    current = node.get(key)
    if raw in ("True", "False") or isinstance(current, (bool, list, dict)):
        if isinstance(current, list):
            raw = raw.replace(" ", ",")
        return ast.literal_eval(raw)
    if current is None:
        # a new key: a Python literal where it parses, else the string
        try:
            return ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            return raw
    return type(current)(raw)


def apply_overrides(cfg: dict, hparams_str: str) -> None:
    """Apply ``"a=1,b.c=2"``-style dotted overrides to ``cfg`` in place."""
    if not hparams_str:
        return
    for assignment in hparams_str.split(","):
        if not assignment.strip():
            continue
        key, val = assignment.split("=", 1)
        node = cfg
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _coerce(node, parts[-1], val)


def add_config_args(parser: argparse.ArgumentParser) -> None:
    """The flags ``set_hparams`` reads."""
    parser.add_argument("--config", type=str, default="")
    parser.add_argument("--exp_name", type=str, default="")
    parser.add_argument("--hparams", type=str, default="")
    parser.add_argument("--infer", action="store_true")
    parser.add_argument("--validate", action="store_true")
    parser.add_argument("--reset", action="store_true")
    parser.add_argument("--remove", action="store_true")
    parser.add_argument("--debug", action="store_true")


def set_hparams(config="", exp_name="", hparams_str="", print_hparams=True,
                global_hparams=True, args=None) -> dict:
    """Build the merged hparams dict from config file + saved config + CLI."""
    if args is None:
        if config == "" and exp_name == "":
            parser = argparse.ArgumentParser(description="fastdiff_tpu_torch")
            add_config_args(parser)
            args, _ = parser.parse_known_args()
        else:
            args = argparse.Namespace(
                config=config, exp_name=exp_name, hparams=hparams_str,
                infer=False, validate=False, reset=False, remove=False,
                debug=False)
    if args.config == "" and args.exp_name == "":
        raise ValueError("must provide --config or --exp_name")

    work_dir = ""
    saved = {}
    saved_config_path = ""
    if args.exp_name:
        work_dir = os.path.join("checkpoints", args.exp_name)
        saved_config_path = os.path.join(work_dir, "config.yaml")
        if os.path.exists(saved_config_path):
            saved = load_yaml(saved_config_path) or {}

    cfg: dict = {}
    if args.config:
        _deep_merge(cfg, load_config_cascade(args.config))
    if not args.reset:
        _deep_merge(cfg, saved)
    cfg["work_dir"] = work_dir

    apply_overrides(cfg, args.hparams)

    if work_dir and getattr(args, "remove", False):
        answer = input("REMOVE old checkpoint? Y/N [Default: N]: ")
        if answer.lower() == "y":
            shutil.rmtree(work_dir, ignore_errors=True)

    if work_dir and (not os.path.exists(saved_config_path) or args.reset) \
            and not args.infer:
        os.makedirs(work_dir, exist_ok=True)
        with open(saved_config_path, "w") as f:
            f.write(dump_yaml(cfg))

    cfg["infer"] = args.infer
    cfg["debug"] = args.debug
    cfg["validate"] = args.validate
    cfg["exp_name"] = args.exp_name

    global _printed_once
    if global_hparams:
        hparams.clear()
        hparams.update(cfg)
    if print_hparams and not _printed_once and global_hparams:
        print("| Hparams: ")
        for i, (k, v) in enumerate(sorted(cfg.items())):
            print(f"{k}: {v}, ", end="\n" if i % 5 == 4 else "")
        print("")
        _printed_once = True
    return cfg
