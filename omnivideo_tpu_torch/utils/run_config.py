"""The YAML training-config tier (port of omnivideo_tpu/utils/run_config.py).

Precedence CLI-explicit > YAML file > argparse defaults: a flag the user
typed (or an unambiguous prefix of it, which argparse accepts) always wins.
Unknown YAML keys are an error, and the merged namespace is written to
`<output_dir>/run_config.yaml`.

The card's machine has no PyYAML, so this module reads and writes the YAML
these files hold itself: a flat mapping whose values are scalars (str,
int, float, bool, null) or lists of them, block (`- item`) or flow (`[a,
b]`), with comments, quoted scalars and the folded continuation lines
PyYAML writes for long strings. Scalars resolve by PyYAML's YAML 1.1 rules
(its SafeLoader's implicit resolvers: `1.0e-4` is a float, `1e-4` a string,
`yes` true, `0o7`... as PyYAML), so `read_yaml` gives what `yaml.safe_load`
gives for such a file, and `write_yaml` writes what `yaml.safe_load` reads
back as the same mapping. Anything else (nesting, anchors, tags, block
scalars, dates, several documents) raises, naming the line.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

def _pattern(pattern: str, flags: int = 0):
    """A matcher for `pattern` (the re module caches it)."""
    return lambda s: re.match(pattern, s, flags)


_BOOL = _pattern(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FLOAT = _pattern(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = _pattern(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = _pattern(r"^(?:~|null|Null|NULL|)$")
_UNSUPPORTED = _pattern(r"""^(?:[0-9]{4}-[0-9]{2}-[0-9]{2}
                    |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}:[0-9]{2}
                     (?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?
                    |<<|=)$""", re.X)


class YAMLError(ValueError):
    pass


def _sexagesimal(s: str, conv):
    total = 0
    for part in s.split(":"):
        total = total * 60 + conv(part)
    return total


def _plain(s: str, line: int):
    """A plain scalar resolved as PyYAML's SafeLoader resolves it."""
    if _NULL(s):
        return None
    if _BOOL(s):
        return s in _TRUE
    if _INT(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ":" in v else int(v))
    if _FLOAT(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if _UNSUPPORTED(s):
        raise YAMLError(f"line {line}: {s!r} is a YAML date or merge key; not supported")
    if s[0] in "&*!|>%@`{":
        raise YAMLError(f"line {line}: {s!r}: anchors, aliases, tags and block scalars are "
                        "not supported")
    return s


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


def _double(body: str, line: int) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1] if i + 1 < len(body) else ""
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX:
            n = _HEX[e]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise YAMLError(f"line {line}: unknown escape \\{e}")
    return "".join(out)


def _fold(lines: List[str]) -> str:
    """YAML line folding: one break between two lines is a space, each
    further (empty) line a newline."""
    out, pending = "", 0
    for j, seg in enumerate(lines):
        if 0 < j < len(lines) - 1 and seg == "":
            pending += 1
            continue
        if j:
            out += "\n" * pending if pending else " "
        pending = 0
        out += seg
    return out


def _trim(segs: List[str]) -> List[str]:
    """The lines of a folded scalar with the whitespace around each inner
    line break removed (the first line's start and the last's end kept)."""
    n = len(segs)
    return [(seg.lstrip() if j else seg).rstrip() if j < n - 1 else (seg.lstrip() if j else seg)
            for j, seg in enumerate(segs)]


def _scalar(text: str, line: int):
    """One scalar (possibly folded over lines joined by '\\n'), quoted or plain."""
    if text[:1] == "'":
        if not text.endswith("'") or len(text) < 2:
            raise YAMLError(f"line {line}: unterminated single-quoted scalar")
        return _fold(_trim(text[1:-1].split("\n"))).replace("''", "'")
    if text[:1] == '"':
        if not text.endswith('"') or len(text) < 2:
            raise YAMLError(f"line {line}: unterminated double-quoted scalar")
        parts = text[1:-1].split("\n")
        joined, glued = [], False  # glued: the previous line ended in an escaped break
        for j, seg in enumerate(parts):
            if j:
                seg = seg.lstrip(" \t")
            last = j == len(parts) - 1
            odd = (len(seg) - len(seg.rstrip("\\"))) % 2 == 1
            if not last and odd:
                seg = seg[:-1]
            elif not last:
                seg = seg.rstrip(" \t")
            if glued:
                joined[-1] += seg
            else:
                joined.append(seg)
            glued = not last and odd
        return _double(_fold(joined), line)
    return _plain(_fold(_trim(text.split("\n"))).strip(), line)


# where a quoted scalar can begin: after "key: " or "- ", or inside a flow
# list after "[" or "," (a quote that starts a line continues a plain one)
_SCALAR_START = _pattern(r"^\s*(?:[A-Za-z_][\w.-]*\s*:\s+|-\s+)"
                           r"(?:\[(?:[^\[\]]*,)?\s*)?$")


def _uncomment(text: str) -> List[Tuple[str, bool]]:
    """Each line without its ' #' comment, and whether it starts inside a
    quoted scalar (which can span lines), so that a '#' or '%' there is text."""
    out, quote = [], None
    for raw in text.splitlines():
        inside, cut = quote is not None, len(raw)
        i = 0
        while i < len(raw):
            c = raw[i]
            if quote == "'":
                if c == "'" and raw[i + 1:i + 2] == "'":
                    i += 1  # an escaped quote
                elif c == "'":
                    quote = None
            elif quote == '"':
                if c == "\\":
                    i += 1
                elif c == '"':
                    quote = None
            elif c in "'\"" and _SCALAR_START(raw[:i]):
                quote = c
            elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
                cut = i
                break
            i += 1
        out.append((raw[:cut].rstrip() if cut < len(raw) or not quote else raw[:cut], inside))
    return out


def _flow(text: str, line: int) -> list:
    body = text[1:-1].strip()
    if not body:
        return []
    items, cur, quote = [], "", None
    for c in body:
        if quote:
            cur += c
            if c == quote:
                quote = None
        elif c in "'\"" and not cur.strip():
            quote, cur = c, cur + c
        elif c == ",":
            items.append(cur.strip())
            cur = ""
        elif c in "[]{}":
            raise YAMLError(f"line {line}: nested collections are not supported")
        else:
            cur += c
    items.append(cur.strip())
    return [_scalar(it, line) for it in items if it != ""]


def _value(text: str, line: int):
    if text.startswith("["):
        if not text.endswith("]"):
            raise YAMLError(f"line {line}: a flow list must end on its line")
        return _flow(text, line)
    if text.startswith("{"):
        raise YAMLError(f"line {line}: nested mappings are not supported")
    return _scalar(text, line)


_KEY = _pattern(r"^([A-Za-z_][A-Za-z0-9_.-]*)[ \t]*:(?:[ \t]+(.*))?$")


def read_yaml(text: str) -> Optional[dict]:
    """A flat YAML mapping of scalars and lists of scalars → dict (None for
    an empty document, as yaml.safe_load)."""
    rows: List[Tuple[int, int, str, bool]] = []  # (line number, indent, content, inside quotes)
    for n, (s, inside) in enumerate(_uncomment(text), 1):
        if inside:
            rows.append((n, 1, s.strip(), True))  # a continuation of a quoted scalar
            continue
        if "\t" in s[: len(s) - len(s.lstrip())]:
            raise YAMLError(f"line {n}: tab indentation")
        if n == 1 and s.strip() == "---":
            continue
        if s.strip() in ("---", "..."):
            raise YAMLError(f"line {n}: one document only")
        if s.startswith("%"):
            raise YAMLError(f"line {n}: directives are not supported")
        rows.append((n, len(s) - len(s.lstrip()), s.strip(), False))
    out: Dict = {}
    i = 0
    while i < len(rows):
        n, ind, s, _ = rows[i]
        if not s:
            i += 1
            continue
        m = _KEY(s)
        if m is None or ind != 0:
            raise YAMLError(f"line {n}: expected 'key: value' at column 0, got {s!r}")
        key, rest = m.group(1), (m.group(2) or "")
        if key in out:
            raise YAMLError(f"line {n}: duplicate key {key!r}")
        i += 1
        cont = []  # continuation lines: more indented, inside quotes, or list items
        while i < len(rows) and (rows[i][3] or not rows[i][2] or rows[i][1] > 0
                                 or rows[i][2].startswith("- ") or rows[i][2] == "-"):
            cont.append(rows[i])
            i += 1
        while cont and not cont[-1][2] and not cont[-1][3]:
            cont.pop()
        if not rest and cont and cont[0][2].startswith("-"):
            items, base = [], cont[0][1]
            for cn, cind, cs, inside in cont:
                if not inside and cs.startswith("-") and cind == base:
                    body = cs[1:].strip()
                    if body.startswith(("- ", "[", "{")) or _KEY(body):
                        raise YAMLError(f"line {cn}: nested collections are not supported")
                    items.append([cn, body])
                elif items and (inside or not cs or cind > base):
                    items[-1][1] += "\n" + cs
                else:
                    raise YAMLError(f"line {cn}: unexpected {cs!r} in the list of {key!r}")
            out[key] = [_scalar(body, cn) for cn, body in items]
        else:
            for cn, cind, cs, inside in cont:
                if inside:
                    continue
                if cs.startswith("- ") or cs == "-":
                    raise YAMLError(f"line {cn}: a list item after a scalar value")
                if _KEY(cs) and not rest.startswith(("'", '"')):
                    raise YAMLError(f"line {cn}: nested mappings are not supported")
            full = "\n".join(([rest] if rest else []) + [cs for _, _, cs, _ in cont])
            out[key] = _value(full, n) if full.strip() else None
    return out or None


def _quoted(s: str) -> str:
    """A string PyYAML reads back as itself: plain where that resolves to
    the string, else single-quoted, else double-quoted with escapes."""
    plain_ok = (s == s.strip() and s and s[0] not in "-?:,[]{}#&*!|>'\"%@`~"
                and not re.search(r": |#|[\[\]{},]|\s#", s) and not s.endswith(":")
                and all(c.isprintable() for c in s))
    if plain_ok:
        try:
            if _plain(s, 0) == s:
                return s
        except YAMLError:
            pass
    if all(c.isprintable() for c in s) and "\n" not in s:
        return "'" + s.replace("'", "''") + "'"
    return json.dumps(s, ensure_ascii=False)


def _scalar_text(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()
        if "." not in r and "e" in r:  # PyYAML's form: 1e-05 → 1.0e-05
            r = r.replace("e", ".0e")
        return r
    if isinstance(v, str):
        return _quoted(v)
    raise YAMLError(f"cannot write {type(v).__name__} {v!r}: scalars and lists of them only")


def write_yaml(mapping: dict) -> str:
    """A flat mapping as YAML, keys sorted (yaml.safe_dump(sort_keys=True,
    default_flow_style=False) reads the same back)."""
    lines = []
    for k in sorted(mapping):
        v = mapping[k]
        if isinstance(v, (list, tuple)):
            if not v:
                lines.append(f"{k}: []")
                continue
            lines.append(f"{k}:")
            lines.extend(f"- {_scalar_text(x)}" for x in v)
        else:
            lines.append(f"{k}: {_scalar_text(v)}")
    return "\n".join(lines) + "\n"


def explicit_cli_dests(parser: argparse.ArgumentParser,
                       argv: Optional[Iterable[str]] = None) -> set:
    """Dests of options the user actually typed on the command line (an
    unambiguous prefix of a long option counts, as argparse accepts it)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    opt_to_dest = {opt: action.dest for action in parser._actions
                   for opt in action.option_strings}
    dests = set()
    for a in argv:
        if not a.startswith("-"):
            continue
        tok = a.split("=", 1)[0]
        if tok in opt_to_dest:
            dests.add(opt_to_dest[tok])
        elif tok.startswith("--"):
            matches = {d for o, d in opt_to_dest.items()
                       if o.startswith("--") and o.startswith(tok)}
            if len(matches) == 1:
                dests.add(next(iter(matches)))
    return dests


def apply_yaml_config(args: argparse.Namespace, parser: argparse.ArgumentParser,
                      argv: Optional[Iterable[str]] = None) -> argparse.Namespace:
    """Merge args.config (a YAML mapping) under the explicitly typed CLI
    flags. Mutates and returns `args`; a no-op without --config."""
    if not getattr(args, "config", None):
        return args
    try:
        overrides = read_yaml(Path(args.config).read_text()) or {}
    except YAMLError as e:
        raise SystemExit(f"--config {args.config}: {e}") from e
    known = {a.dest for a in parser._actions}
    unknown = sorted(set(overrides) - known)
    if unknown:
        raise SystemExit(f"--config {args.config}: unknown keys {unknown}; "
                         f"valid keys are the CLI flag names (see --help)")
    explicit = explicit_cli_dests(parser, argv)
    for k, v in overrides.items():
        if k not in explicit:
            setattr(args, k, v)
    return args


def dump_run_config(args: argparse.Namespace, output_dir) -> Path:
    """Write the merged namespace to <output_dir>/run_config.yaml."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    resolved = {k: (str(v) if isinstance(v, Path) else v) for k, v in vars(args).items()}
    path = out / "run_config.yaml"
    path.write_text(write_yaml(resolved))
    return path
