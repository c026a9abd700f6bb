"""The port's config reader and writer (`yolopoint_tpu_torch.utils.config`,
no PyYAML) against PyYAML's `safe_load` and the JAX package's
`utils/config.py`:

* every file under `configs/` loads to the JAX `load_config` dict, values
  and types equal;
* edge scalars resolve as `yaml.safe_load` resolves them (YAML 1.1:
  `1e-3` a string, `1.0e-3` a float, `yes`/`off` booleans, `~` None,
  `'0-62'` a string, nested flow maps, a flow list over several lines);
* `save_config` output reads back to the same dict through both
  `yaml.safe_load` and the port's reader, for every config and for strings
  that need quoting;
* `resolve_sub_configs` on `configs/concat_datasets.yaml` equals the JAX
  result; `dict_update` and `get` behave alike.
"""

import math
from pathlib import Path

import pytest
import yaml

from yolopoint_tpu.utils import config as jax_config
from yolopoint_tpu_torch.utils import config as port_config

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


def same(a, b) -> bool:
    """Equal values of equal types (floats by value, NaN equal to NaN), keys in order."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_equals_jax(path):
    assert same(port_config.load_config(path), jax_config.load_config(path))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_save_config_round_trip(path, tmp_path):
    cfg = port_config.load_config(path)
    out = tmp_path / "config.yml"
    port_config.save_config(cfg, out)
    assert same(yaml.safe_load(out.read_text()), cfg)
    assert same(port_config.load_config(out), cfg)


EDGE = """\
# a comment line
lr_string: 1e-3
lr_float: 1.0e-3
big: 1.0e3
signed: 3.5e+2
yes_key: yes
off_key: off
On: ON
tilde: ~
nothing:
null_word: null
slice: '0-62'
plain_slice: 0-62
ints: [0, -0, +12, 017, 0x1F, 0b11, 1_000, 1:30]
floats: [6., .5, -1.5, .inf, -.Inf]
nested: {a: {b: [1, 2, {c: no}]}, d: 'e, f', g: "h # i"}   # trailing comment
long_list: [polygon, star,
  ellipse, checkerboard]
quoted: ['it''s', "tab\\there", "x: y"]
names:
- polygon
- star
items:
  - config: kitti.yaml
  - config: coco.yaml
    overrides:
      data: {augmentation: {mosaic: 0.0}}
  - - 1
    - 2
empty_map: {}
empty_list: []
text: plain words with spaces
"""


def test_edge_scalars_resolve_as_pyyaml():
    want = yaml.safe_load(EDGE)
    got = port_config.parse_yaml(EDGE)
    assert same(got, want)
    assert got["lr_string"] == "1e-3" and got["lr_float"] == 1e-3 and got["big"] == "1.0e3"
    assert got["yes_key"] is True and got["off_key"] is False and got[True] is True
    assert got["tilde"] is None and got["nothing"] is None and got["slice"] == "0-62"
    assert math.isnan(port_config.parse_yaml("x: .nan")["x"])


@pytest.mark.parametrize("text", ["x: &a 1", "x: *a", "x: !!str 1", "x: |\n  a", "x: 2024-01-01",
                                  "---\na: 1\n---\nb: 2"])
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        port_config.parse_yaml(text)


def test_save_config_quotes_what_would_change(tmp_path):
    cfg = {
        "strings": ["yes", "off", "1e-3", "0-62", "1.5", "0x10", "null", "~", "", " lead",
                    "a: b", "- x", "#c", "x #y", "[a]", "{a}", "it's", 'q"d', "tab\there",
                    "new\nline", "back\\slash", "ü", "?q", "a:b"],
        "floats": [1e-5, 1e20, -0.0, 0.1, 123456789.125, math.inf, -math.inf],
        "ints": [0, -7, 2 ** 40], "bools": [True, False], "none": None,
        "empty": {}, "empty_list": [], "nested": [[1, [2, []]], {"a": {}}, {"b": [1]}],
        5: "int key", "yes": "string key",
    }
    out = tmp_path / "c.yml"
    port_config.save_config(cfg, out)
    assert same(yaml.safe_load(out.read_text()), cfg)
    assert same(port_config.parse_yaml(out.read_text()), cfg)


def test_resolve_sub_configs_equals_jax():
    path = REPO / "configs" / "concat_datasets.yaml"
    got = port_config.resolve_sub_configs(port_config.load_config(path), path.parent)
    want = jax_config.resolve_sub_configs(jax_config.load_config(path), path.parent)
    assert len(got) == 2 and same(got, want)


def test_dict_update_and_get():
    base = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    over = {"a": {"c": {"d": 5, "f": 6}}, "g": None}
    assert same(port_config.dict_update(dict(base), over),
                jax_config.dict_update(dict(base), over))
    cfg = port_config.load_config(REPO / "configs" / "synthetic_s640.yaml")
    for dotted in ("model.superpoint.nms", "training_params.ema.decay", "data.x.y", "names"):
        assert same(port_config.get(cfg, dotted, 4), jax_config.get(cfg, dotted, 4))
