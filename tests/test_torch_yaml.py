"""The port's YAML reader (dogs_tpu_torch/utils/yaml_subset.py) against
PyYAML's safe loader: every shipped config, the scalars a `key=value`
override may carry, and input outside the subset, which must raise."""

import json
import math
from pathlib import Path

import pytest
import yaml

from dogs_tpu_torch.utils import config as tconfig
from dogs_tpu_torch.utils import yaml_subset

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(REPO.glob("config/*/*.yaml"))
# PyYAML's YAML 1.1 traps among them: an exponent without a sign or a dot
# keeps a string; yes/no/on/off are booleans; underscores, 0x, 0b, a leading
# 0 (octal) and colons (base 60) make ints.
SCALARS = [
    "2e-4", "1e5", "1.0e1", "1.0e+1", "1.0e-5", "0.0000016", "1.", ".5", "-1_0.5_", "190:20:30.15",
    "yes", "no", "on", "off", "true", "True", "FALSE", "Yes", "y", "n",
    "~", "null", "", "1_000", "0x10", "0b101", "017", "1:30", "+5", "-0",
    ".inf", "-.inf", "+.inf", "1", "-3", "1.0", "[1, 2]", "[]", "'q'", "abc", '"a\\tb"', "'it''s'",
    '[a, [1, 2.5], "x y", ~]', "x # comment", "${trainer.max_iterations}", '"a\\Lb\\x41\\u00e9\\U0001F600"',
]
OUTSIDE = ["2001-12-14", "&a x", "*a", "!!str x", "{a: 1}", "|", "[1, 2,]", "a: b", "[a: 1]"]
OUTSIDE_DOCS = ["a:\n  - b: 1\n", "a: 1\n  b: 2\n", "---\na: 1\n", "a: |\n  x\n", "a: {b: 1}\n",
                "a: &x 1\n", "a: 1\na: 2\n", "a: b\n  c\n"]


def same(a, b) -> bool:
    """Equal values of equal types (JSON tells 1 from 1.0 and True)."""
    return a == b and json.dumps(a) == json.dumps(b)


@pytest.mark.parametrize("path", CONFIGS, ids=[f"{p.parent.name}/{p.stem}" for p in CONFIGS])
def test_load_equals_pyyaml_on_shipped_configs(path):
    text = path.read_text()
    assert same(yaml_subset.load(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", SCALARS)
def test_override_scalars_equal_pyyaml(text):
    assert same(yaml_subset.parse_scalar(text), yaml.safe_load(text))
    assert same(tconfig._parse_scalar(text), yaml.safe_load(text))


def test_nan_and_block_lists_equal_pyyaml():
    assert math.isnan(yaml_subset.parse_scalar(".nan")) and math.isnan(yaml.safe_load(".nan"))
    doc = "a:\n- 1\n- x\nb:\n  - [1]\n  -\nc:\n"
    assert same(yaml_subset.load(doc), yaml.safe_load(doc))


@pytest.mark.parametrize("text", OUTSIDE)
def test_scalars_outside_the_subset_raise(text):
    with pytest.raises(ValueError):
        yaml_subset.parse_scalar(text)


@pytest.mark.parametrize("doc", OUTSIDE_DOCS)
def test_documents_outside_the_subset_raise(doc):
    with pytest.raises(ValueError):
        yaml_subset.load(doc)
