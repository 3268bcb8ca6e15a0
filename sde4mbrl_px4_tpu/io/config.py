"""MPC config schema loading (L7).

The YAML schema is the reference's entire solver hyper-parameter surface
(SURVEY.md §2.10; ``launch/iris_sitl_traj_mpc.yaml``): model checkpoint
path, optional trajectory CSV, input box constraints, cost weights, horizon
discretization, particle count and the ``apg_mpc`` optimizer block.

Configs are read by :func:`parse_yaml`, a small reader for the block-style
YAML subset the shipped configs (and ``yaml.safe_dump`` output) use: block
mappings and sequences, flow lists and mappings (nested, may span lines),
plain and quoted scalars resolved as YAML 1.1 resolves them (``True``,
``null``, ``1.0e-4``, ``0x1F``...), and comments. Everything else — block
scalars, anchors, aliases, tags, multi-document streams, timestamps —
raises :class:`YAMLError` naming the line, never a silent misread.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["load_yaml_config", "input_bounds_from_config", "load_yaml",
           "parse_yaml", "YAMLError", "reject_removed_keys"]


class YAMLError(ValueError):
    """Unsupported or malformed YAML; the message names the source line."""


# YAML 1.1 implicit scalar types, as PyYAML's SafeLoader resolves them.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# Resolved by YAML 1.1 but not supported here: sexagesimal numbers,
# timestamps, merge keys and the value key.
_UNSUPPORTED = re.compile(
    r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt ].*)?|<<|=)$")
_DQ_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
               "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
               " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
               "_": "\xa0", "L": " ", "P": " "}


def _resolve_plain(s: str, where: str) -> Any:
    """YAML 1.1 resolution of a plain (unquoted) scalar."""
    if _NULL.match(s):
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _UNSUPPORTED.match(s):
        raise YAMLError(f"{where}: unsupported scalar {s!r} (sexagesimal, "
                        "timestamp or merge key) — quote it")
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        if v.endswith("inf"):
            return float("-inf") if v[0] == "-" else float("inf")
        if v.endswith("nan"):
            return float("nan")
        return float(v)
    if s[0] in "&*!|>%@`":
        raise YAMLError(f"{where}: unsupported YAML syntax at {s!r} "
                        "(anchors, aliases, tags, block scalars, "
                        "directives)")
    return s


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (at line start or after whitespace) outside
    quoted scalars."""
    quote = None
    prev = " "
    i = 0
    while i < len(line):
        c = line[i]
        if quote == "'":
            if c == "'":
                if i + 1 < len(line) and line[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and prev in " \t[{,:-":
            quote = c
        elif c == "#" and prev in " \t":
            return line[:i]
        prev = c
        i += 1
    return line


class _Flow:
    """Recursive-descent reader of one flow node (``[...]``, ``{...}`` or
    a scalar) inside a string."""

    def __init__(self, text: str, where: str):
        self.s, self.i, self.where = text, 0, where

    def error(self, msg: str):
        raise YAMLError(f"{self.where}: {msg} in {self.s.strip()!r}")

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self, stops: str) -> Any:
        self.ws()
        if self.i >= len(self.s):
            self.error("unexpected end of flow collection")
        c = self.s[self.i]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c in "'\"":
            v, self.i = _quoted(self.s, self.i, self.where)
            return v
        j = self.i
        while j < len(self.s) and self.s[j] not in stops:
            if self.s[j] == ":" and ":" in stops and (
                    j + 1 == len(self.s) or self.s[j + 1] in " ,]}"):
                break
            j += 1
        tok = self.s[self.i:j].strip()
        self.i = j
        return _resolve_plain(tok, self.where)

    def seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == "]":
                self.i += 1
                return out
            out.append(self.node(",]"))
            self.ws()
            if self.i >= len(self.s):
                self.error("unclosed '['")
            if self.s[self.i] == ",":
                self.i += 1
            elif self.s[self.i] != "]":
                self.error(f"expected ',' or ']' at column {self.i}")

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == "}":
                self.i += 1
                return out
            key = self.node(",}:")
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == ":":
                self.i += 1
                val = self.node(",}")
            else:
                val = None
            if key in out:
                self.error(f"duplicate key {key!r}")
            out[key] = val
            self.ws()
            if self.i >= len(self.s):
                self.error("unclosed '{'")
            if self.s[self.i] == ",":
                self.i += 1
            elif self.s[self.i] != "}":
                self.error(f"expected ',' or '}}' at column {self.i}")


def _quoted(s: str, i: int, where: str) -> Tuple[str, int]:
    """Read the quoted scalar starting at ``s[i]``; returns (value, end)."""
    q = s[i]
    out: List[str] = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if j + 1 < len(s) and s[j + 1] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = s[j + 1:j + 2]
            if e in _DQ_ESCAPES:
                out.append(_DQ_ESCAPES[e])
                j += 2
                continue
            n = {"x": 2, "u": 4, "U": 8}.get(e)
            if n is None or not re.fullmatch(r"[0-9a-fA-F]{%d}" % n,
                                             s[j + 2:j + 2 + n]):
                raise YAMLError(f"{where}: bad escape '\\{e}' in {s!r}")
            out.append(chr(int(s[j + 2:j + 2 + n], 16)))
            j += 2 + n
            continue
        out.append(c)
        j += 1
    raise YAMLError(f"{where}: unterminated {q}-quoted scalar (multi-line "
                    "quoted scalars are not supported)")


def _flow_balance(text: str) -> int:
    """Open-bracket depth at the end of ``text`` (quotes respected)."""
    depth, i = 0, 0
    while i < len(text):
        c = text[i]
        if c in "'\"":
            _, i = _quoted(text, i, "flow")
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    return depth


class _Block:
    """Indentation-driven reader over the comment-stripped lines."""

    def __init__(self, lines: List[Tuple[int, int, str]], source: str):
        self.lines, self.i, self.source = lines, 0, source

    def where(self, ln: int) -> str:
        return f"{self.source}:{ln}"

    def split_key(self, text: str, ln: int) -> Optional[Tuple[Any, str]]:
        """``key: rest`` -> (key, rest), or None if ``text`` is no mapping
        entry."""
        if text[0] in "'\"":
            key, j = _quoted(text, 0, self.where(ln))
            rest = text[j:].lstrip(" ")
            if rest == ":" or rest.startswith(": "):
                return key, rest[1:].strip()
            return None
        if text[0] in "[{":
            return None
        m = re.search(r":(?: |$)", text)
        if m is None:
            return None
        return (_resolve_plain(text[:m.start()].rstrip(), self.where(ln)),
                text[m.end():].strip())

    @staticmethod
    def is_item(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def node(self, indent: int) -> Any:
        _, _, text = self.lines[self.i]
        return self.seq(indent) if self.is_item(text) else self.mapping(indent)

    def inline(self, rest: str, ln: int) -> Any:
        """Value written on the line itself: flow node or scalar. Consumes
        continuation lines of an unclosed flow collection."""
        where = self.where(ln)
        if rest[0] in "'\"":
            val, j = _quoted(rest, 0, where)
            if rest[j:].strip():
                raise YAMLError(f"{where}: text after quoted scalar: "
                                f"{rest[j:].strip()!r}")
            return val
        if rest[0] in "[{":
            while _flow_balance(rest) > 0:
                if self.i >= len(self.lines):
                    raise YAMLError(f"{where}: unclosed flow collection")
                rest += " " + self.lines[self.i][2]
                self.i += 1
            f = _Flow(rest, where)
            val = f.node("")
            if rest[f.i:].strip():
                raise YAMLError(f"{where}: text after flow collection: "
                                f"{rest[f.i:].strip()!r}")
            return val
        return _resolve_plain(rest, where)

    def mapping(self, indent: int) -> dict:
        out: Dict[Any, Any] = {}
        while self.i < len(self.lines):
            ln, ind, text = self.lines[self.i]
            if ind < indent or (ind == indent and self.is_item(text)):
                break
            if ind > indent:
                raise YAMLError(f"{self.where(ln)}: unexpected indentation")
            kv = self.split_key(text, ln)
            if kv is None:
                raise YAMLError(f"{self.where(ln)}: expected 'key: value', "
                                f"got {text!r}")
            key, rest = kv
            self.i += 1
            if rest:
                val = self.inline(rest, ln)
            elif self.i < len(self.lines) and (
                    self.lines[self.i][1] > indent
                    or (self.lines[self.i][1] == indent
                        and self.is_item(self.lines[self.i][2]))):
                val = self.node(self.lines[self.i][1])
            else:
                val = None
            if key in out:
                raise YAMLError(f"{self.where(ln)}: duplicate key {key!r}")
            out[key] = val
        return out

    def seq(self, indent: int) -> list:
        out: List[Any] = []
        while self.i < len(self.lines):
            ln, ind, text = self.lines[self.i]
            if ind < indent or (ind == indent and not self.is_item(text)):
                break
            if ind > indent:
                raise YAMLError(f"{self.where(ln)}: unexpected indentation")
            rest = text[1:].lstrip(" ")
            if not rest:
                self.i += 1
                if (self.i < len(self.lines)
                        and self.lines[self.i][1] > indent):
                    out.append(self.node(self.lines[self.i][1]))
                else:
                    out.append(None)
            elif self.is_item(rest) or self.split_key(rest, ln) is not None:
                # Compact nested node ("- - x" / "- key: v"): re-read the
                # rest of the line as a block at its own column.
                sub = indent + len(text) - len(rest)
                self.lines[self.i] = (ln, sub, rest)
                out.append(self.node(sub))
            else:
                self.i += 1
                out.append(self.inline(rest, ln))
        return out


def parse_yaml(text: str, source: str = "<yaml>") -> Any:
    """Parse one YAML document of the supported subset (module docstring).
    ``source`` names the text in error messages."""
    lines = []
    for ln, raw in enumerate(text.splitlines(), start=1):
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped[0] == "\t" or "\t" in body[:len(body) - len(stripped)]:
            raise YAMLError(f"{source}:{ln}: tab in indentation")
        if stripped.startswith(("---", "...", "%")):
            raise YAMLError(f"{source}:{ln}: document markers and "
                            "directives are not supported")
        lines.append((ln, len(body) - len(stripped), stripped))
    if not lines:
        return None
    r = _Block(lines, source)
    if r.split_key(lines[0][2], lines[0][0]) is None and not r.is_item(
            lines[0][2]):
        r.i = 1
        doc = r.inline(lines[0][2], lines[0][0])
    else:
        doc = r.node(lines[0][1])
    if r.i < len(lines):
        ln = lines[r.i][0]
        raise YAMLError(f"{source}:{ln}: unexpected content "
                        f"{lines[r.i][2]!r}")
    return doc


def load_yaml(path: str) -> Any:
    """Read and parse a YAML file with :func:`parse_yaml`."""
    path = os.path.expanduser(path)
    with open(path, "r") as f:
        return parse_yaml(f.read(), source=path)


_DEFAULTS: Dict[str, Any] = {
    "enforce_ubound": True,
    "discount": 1.0,
    "num_particles": 1,
    "horizon": 20,
    "num_short_dt": 20,
    "short_step_dt": 0.05,
    "long_step_dt": 0.05,
}

# Every top-level key any consumer reads (reference schema, SURVEY.md §2.10,
# + this framework's documented extensions). Unknown keys WARN (typos like
# "antithetik" silently doing nothing is an operator footgun) but never
# fail — forward compatibility.
_KNOWN_KEYS = set(_DEFAULTS) | {
    "learned_model_params", "trajectory_path", "input_constr",
    "state_constr", "cost_params", "apg_mpc", "seed",
    # framework extensions (engine/mpc_loader.py)
    "antithetic", "initial_state_std", "warm_shift", "matmul_precision",
    "solver", "mppi", "policy",
}

# Keys that once selected code paths which no longer exist: a config that
# still sets one is refused rather than silently flying something else.
_REMOVED_KEYS = {
    "pallas_chunk": "the fused-kernel particle chunking is gone; every "
                    "solve runs the XLA path — delete the key",
}


def reject_removed_keys(cfg: Dict[str, Any], source: str = "config") -> None:
    """Raise if ``cfg`` sets a key whose code path was removed."""
    for k, why in _REMOVED_KEYS.items():
        if k in cfg:
            raise ValueError(f"{source}: key {k!r} is no longer supported "
                             f"({why})")


def load_yaml_config(path: str) -> Dict[str, Any]:
    """Load + validate an MPC YAML config; fills schema defaults."""
    path = os.path.expanduser(path)
    cfg = load_yaml(path)
    if not isinstance(cfg, dict):
        raise ValueError(f"config {path} did not parse to a mapping")
    for k, v in _DEFAULTS.items():
        cfg.setdefault(k, v)
    for req in ("input_constr", "cost_params", "apg_mpc"):
        if req not in cfg:
            raise ValueError(f"config {path} missing required block {req!r}")
    reject_removed_keys(cfg, f"config {path}")
    unknown = sorted(k for k in cfg
                     if k not in _KNOWN_KEYS and not k.startswith("_"))
    if unknown:
        import warnings

        warnings.warn(
            f"config {os.path.basename(path)}: unknown key(s) {unknown} "
            "will be ignored (typo?)", stacklevel=2)
    n_u = len(cfg["input_constr"]["input_id"])
    if len(cfg["input_constr"]["input_bound"]) != n_u:
        raise ValueError("input_bound length must match input_id length")
    if len(np.atleast_1d(cfg["cost_params"]["uref"])) != n_u:
        raise ValueError("cost_params.uref length must match number of inputs")
    # Relative asset paths resolve against the config file's directory (the
    # reference resolves configs as ``config_dir + "/" + name``,
    # ``sde_control.py:161``; asset paths there are absolute/home-anchored).
    base = os.path.dirname(os.path.abspath(path))
    for key in ("learned_model_params", "trajectory_path"):
        p = cfg.get(key)
        if p:
            p = os.path.expanduser(p)
            if not os.path.isabs(p):
                p = os.path.join(base, p)
            cfg[key] = p
    cfg["_config_path"] = path
    return cfg


def input_bounds_from_config(cfg: Dict[str, Any]):
    """(lb, ub) arrays from ``input_constr.input_bound``
    (``iris_sitl_traj_mpc.yaml:8-11``)."""
    b = np.asarray(cfg["input_constr"]["input_bound"], np.float32)
    return b[:, 0], b[:, 1]
