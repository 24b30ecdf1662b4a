"""The port's config reader (utils/yaml_subset.py, config.load_config)
without PyYAML: every config file of the repo, and the YAML 1.1 scalar
rules, against ``yaml.safe_load`` value for value (exact); constructs
outside the subset raise ``ValueError`` naming the line."""

import math
import sys
from pathlib import Path

import pytest
import yaml

from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch.utils import yaml_subset

REPO = Path(__file__).resolve().parents[1]
CONFIGS = [REPO / "config.yaml"] + sorted((REPO / "scripts").glob("*.yaml"))


def _reference_config(path: Path) -> tconfig.Config:
    """What load_config built with PyYAML: Config.from_dict of
    yaml.safe_load, with the bottleneck resolved from use_conv_lstm."""
    raw = yaml.safe_load(path.read_text())
    cfg = tconfig.Config.from_dict(raw)
    if "bottleneck" not in ((raw or {}).get("model") or {}):
        cfg.model.bottleneck = "convlstm" if cfg.model.use_conv_lstm else "lif"
    return cfg


def test_every_config_of_the_repo_is_found():
    assert len(CONFIGS) == 7 and all(p.is_file() for p in CONFIGS)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.relative_to(REPO).as_posix())
def test_load_config_without_pyyaml_equals_safe_load(path, monkeypatch):
    text = path.read_text()
    want_raw = yaml.safe_load(text)
    want = _reference_config(path)
    monkeypatch.setitem(sys.modules, "yaml", None)  # `import yaml` now raises
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    assert yaml_subset.parse(text) == want_raw
    assert tconfig.load_config(path) == want


SCALARS = [
    "5e-4", "1.0e-4", "1e-4", "1.0e4", "1.5E+3", "0.0005", "3.", ".5", "-.5", "+1", "-0", "017",
    "09", "0o17", "1_000", "0_1", ".inf", "-.inf", ".NaN",
    "yes", "Yes", "YES", "yEs", "no", "on", "On", "ON", "off", "OFF", "true", "False", "TRUE",
    "y", "n", "~", "null", "Null", "NULL", "", "'it''s'", '"there # not a comment"',
    "b # a comment", "b#c", "b:c", "http://x", "'1'", '""', "[480, 640]", "[1, 2.5, 'x', yes, ~]",
    "[]", "[1, 2,]", '["a,b", \'c]\']', "2001-12-14x", "'quoted' # comment",
]


@pytest.mark.parametrize("value", SCALARS)
def test_yaml_1_1_scalars_resolve_as_safe_load(value):
    text = f"key: {value}\n"
    want, got = yaml.safe_load(text), yaml_subset.parse(text)
    if isinstance(want["key"], float) and math.isnan(want["key"]):
        assert math.isnan(got["key"])
    else:
        assert got == want and type(got["key"]) is type(want["key"])


STRUCTURES = [
    "a:\n  b:\n    c: 1\n  d: 2\ne: 3\n",
    "---\na: 1\n",
    "  a: 1\n  b: 2\n",
    "a:\nb: 2\n",
    "a:  # comment\n  b: 1\n",
    "# only a comment\n",
    "",
    "yes: 1\n1: x\n",
    "a: 1\na: 2\n",
]


@pytest.mark.parametrize("text", STRUCTURES)
def test_mappings_comments_and_documents_as_safe_load(text):
    assert yaml_subset.parse(text) == yaml.safe_load(text)


OUTSIDE = {
    "anchor": ("a: &x 1\n", 1, "anchors"),
    "alias": ("a: 1\nb: *x\n", 2, "aliases"),
    "literal block": ("a: |\n  x\n", 1, "block scalars"),
    "folded block": ("a: >\n  x\n", 1, "block scalars"),
    "flow mapping": ("a: {b: 1}\n", 1, "flow mappings"),
    "nested flow": ("a: [1, [2]]\n", 1, "nested flow"),
    "two documents": ("a: 1\n---\nb: 2\n", 2, "multi-document"),
    "document end": ("a: 1\n...\n", 2, "multi-document"),
    "tab": ("a:\n\tb: 1\n", 2, "tabs"),
    "block sequence": ("a:\n  - 1\n", 2, "expected 'key: value'"),
    "tag": ("a: !!str 1\n", 1, "tags"),
    "multi-line scalar": ("a: b\n  c\n", 2, "indentation"),
    "date": ("a: 2001-12-14\n", 1, "date"),
    "date and time": ("a: 2001-12-14t21:59:43.10-05:00\n", 1, "date"),
    "hex integer": ("a: 0x1F\n", 1, "hex"),
    "binary integer": ("a: 0b101\n", 1, "binary"),
    "base-60 integer": ("a: 1:30\n", 1, "base-60"),
    "base-60 float": ("a: [1:30.5]\n", 1, "base-60"),
    "backslash escape": ('a: "tab\\there"\n', 1, "backslash"),
    "unterminated quote": ("a: 'b\n", 1, "unterminated"),
}


@pytest.mark.parametrize("case", list(OUTSIDE))
def test_constructs_outside_the_subset_raise_with_the_line(case):
    text, line, what = OUTSIDE[case]
    with pytest.raises(ValueError, match=f"line {line}: .*{what}"):
        yaml_subset.parse(text)
