"""The config reader (``io/config.parse_yaml``) that replaces PyYAML on the
main path: every committed config must read exactly as ``yaml.safe_load``
reads it, ``yaml.safe_dump`` output must round-trip, and syntax outside
the supported subset must fail loudly with the line number."""
import glob
import math
import os

import pytest
import yaml

from sde4mbrl_px4_tpu.io.config import YAMLError, load_yaml, parse_yaml

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, _ROOT) for p in
                 glob.glob(os.path.join(_ROOT, "configs", "**", "*.yaml"),
                           recursive=True))


def test_all_committed_configs_are_covered():
    assert len(CONFIGS) == 14, CONFIGS


@pytest.mark.parametrize("rel", CONFIGS)
def test_committed_config_matches_pyyaml(rel):
    path = os.path.join(_ROOT, rel)
    with open(path) as f:
        text = f.read()
    ref = yaml.safe_load(text)
    assert load_yaml(path) == ref
    # and the block / flow / mixed dumps of the same data round-trip
    for style in (False, True, None):
        assert parse_yaml(yaml.safe_dump(ref, default_flow_style=style)) \
            == ref, style


@pytest.mark.parametrize("text", [
    "a: [1, [2, 3], {x: 1, y: [a, b]}]",
    "a:\n  - x: 1\n    y: 2\n  - z\n",
    "- - 1\n  - 2\n- 3",
    "a: 'it''s # not a comment'\nb: \"q\\n\\u00e9\"",
    "a: ~\nb:\nc: 0x1F\nd: 017\ne: -.inf\nf: +12\ng: 1_000\nh: yes\ni: On",
    "a: [1,\n  2,\n  3]\nb: 1",
    "addr: 127.0.0.1:14998  # trailing comment",
    "a: 1e-4\nb: 1.0e-4\nc: .5\nd: -1.5e+3\ne: 1.",
    "a: {}\nb: []\nc: ''",
])
def test_scalars_and_collections_match_pyyaml(text):
    assert repr(parse_yaml(text)) == repr(yaml.safe_load(text))


def test_nan_resolves_like_pyyaml():
    assert math.isnan(parse_yaml("a: .nan")["a"])


@pytest.mark.parametrize("text,line,what", [
    ("a: 1\nb: &anchor 2", 2, "unsupported YAML syntax"),
    ("a: *alias", 1, "unsupported YAML syntax"),
    ("a: !!str 1", 1, "unsupported YAML syntax"),
    ("a: |\n  block", 1, "unsupported YAML syntax"),
    ("a:\n\tb: 1", 2, "tab in indentation"),
    ("a: [1, 2", 1, "unclosed flow collection"),
    ("a: 1\n  b: 2", 2, "unexpected indentation"),
    ("---\na: 1", 1, "document markers"),
    ("a: 1\nb: 2\na: 3", 3, "duplicate key"),
    ("a: 2001-12-14", 1, "unsupported scalar"),
    ("a: 1:30", 1, "unsupported scalar"),
    ("a: 'open", 1, "unterminated"),
    ("a: [1, 2] trailing", 1, "text after flow collection"),
])
def test_unsupported_syntax_names_the_line(text, line, what):
    with pytest.raises(YAMLError, match=f"cfg.yaml:{line}: .*{what}"):
        parse_yaml(text, source="cfg.yaml")
