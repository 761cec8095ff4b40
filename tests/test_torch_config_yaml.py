"""The port's own YAML reader (`frenetix_tpu_torch.utils.config.simple_yaml_load`).

A machine without PyYAML (the GPU machine) reads `--config-dir` with it, so
it must resolve every scalar as `yaml.safe_load` does (YAML 1.1, PyYAML's
resolvers), or raise ValueError on a form it does not build.  Held against
PyYAML on every scalar form the resolvers distinguish and on every config
file the port's tests write.
"""
import dataclasses
import math

import pytest
import yaml

from frenetix_tpu_torch.utils import config as tconfig
from frenetix_tpu_torch.utils.config import simple_yaml_load

# plain, quoted and flow scalars that both readers must read alike
SAME = [
    # bools: the three casings of yes/no/on/off/true/false; y and n stay strings
    "yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON", "off", "Off", "OFF",
    "true", "True", "TRUE", "false", "False", "FALSE", "y", "n", "Y", "N", "nO",
    # null
    "null", "Null", "NULL", "~", "None", "none",
    # ints: hex, binary, leading-0 octal, separators; 0o and 0X stay strings
    "0", "-0", "+12", "42", "1_000", "0x10", "-0x1f", "0x_ff", "0b101", "010",
    "-017", "08", "0o10", "0X10",
    # floats: only PyYAML's form (a dot; a signed exponent)
    "1.5", "-1.5", "+1.5", "1.", "0.", ".5", "-.5", "1_000.5", "0.1_0",
    "1.0e-3", "1.0e+3", "1e-3", "1.0e3", "1e3", "6.02E+23",
    ".inf", "-.inf", "+.inf", ".Inf", ".INF", ".nan", ".NaN", ".NAN", "inf", "nan",
    # strings, comments, quotes
    "hybrid", "ground_truth", "a:b", "http://x", "a#b", "1 2", "a # b", "3.14  # pi",
    "'a # b'", '"a # b"', "'it''s'", "'no'", '"010"', "'  padded  '",
    # flow lists of scalars
    "[]", "[1, 2, 'x']", "[no, 0x10, .inf]", "[a,]", "['a, b', c]",
]

# forms PyYAML reads as something this reader does not build
REFUSED = ["1:30", "-1:30", "1:30.5", "2001-12-14", "2001-12-14 21:59:43.10 -5",
           "<<", "=", "[a, [b]]", "{a: 1}", "&x 1", "!!str 1", "|", ">", "'a'#b",
           '"tab\\tbed"', "'unterminated"]


def _same(got, want):
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    if isinstance(want, list):
        return (isinstance(got, list) and len(got) == len(want)
                and all(_same(g, w) for g, w in zip(got, want)))
    return type(got) is type(want) and got == want


@pytest.mark.parametrize("scalar", SAME)
def test_scalar_resolves_as_pyyaml(scalar):
    text = f"k: {scalar}\n"
    got, want = simple_yaml_load(text)["k"], yaml.safe_load(text)["k"]
    assert _same(got, want), (scalar, got, want)


@pytest.mark.parametrize("scalar", REFUSED)
def test_forms_it_does_not_build_raise(scalar):
    with pytest.raises(ValueError):
        simple_yaml_load(f"k: {scalar}\n")


@pytest.mark.parametrize("text", [
    "a:\nb:\n  c: 1\n  d:\ne: 2\n",                  # empty values are null
    "---\nx:\n  y:\n    z: off\n  w: 0x1f\n# tail\n",
    "k: 1 # comment\n\n  # indented comment\nj: 'a # b'  # after\n",
    "'quoted key': 1\n",
])
def test_documents_resolve_as_pyyaml(text):
    assert simple_yaml_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["yes: 1\n", "k: 1\n---\nj: 2\n", "- a\n",
                                  "k:\n\t- a\n", "just text\n"])
def test_documents_it_does_not_build_raise(text):
    with pytest.raises(ValueError):
        simple_yaml_load(text)


def _behavior_yaml():
    """The behavior.yaml of `test_torch_behavior.py`: every BehaviorConfig
    key, set away from its default, each line with a comment."""
    values = {}
    for f in dataclasses.fields(tconfig.BehaviorConfig):
        d = f.default
        values[f.name] = (not d if isinstance(d, bool) else "hybrid"
                          if isinstance(d, str) else d + 1)
    lines = [f"{k}: {str(v).lower() if isinstance(v, bool) else v}  # set"
             for k, v in values.items()]
    return "# behavior\n" + "\n".join(lines) + "\n"


@pytest.mark.parametrize("text", [
    _behavior_yaml(),
    "use_behavior_planner: true\n",
    "sampling_min: 1\nsampling_max: 2\n",
    "replanning_frequency: 1\nunknown_key: 3\n",
    "cost_weights:\n  prediction: 0.7\n",
    "cost_weights:\n  prediction: 0.7\nexternal_cost_weights:\n  occ_pm: 1.5\n",
    "cost_weights:\n  responsibility: 0.2\n",
    "calc_occlusions: true\nmax_obstacles: 4\n",
    "use_occlusion_module: true\nharm_threshold: 0.02\n"
    "metric_thresholds:\n  dce: 2.0\n",
])
def test_config_files_of_the_tests_read_as_pyyaml(text):
    assert simple_yaml_load(text) == yaml.safe_load(text)


def test_load_config_without_pyyaml_turns_the_planner_off_for_no(tmp_path, monkeypatch):
    """`use_behavior_planner: no` is False for both readers (it was the
    truthy string 'no' before), and `1e-3` stays the string PyYAML reads."""
    import builtins

    (tmp_path / "behavior.yaml").write_text("use_behavior_planner: no\n")
    (tmp_path / "planning.yaml").write_text("replanning_frequency: 0x2\n")
    with_pyyaml = tconfig.load_config(str(tmp_path))
    real_import = builtins.__import__

    def no_yaml(name, *a, **k):
        if name == "yaml":
            raise ImportError("no PyYAML here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    without = tconfig.load_config(str(tmp_path))
    for cfg in (with_pyyaml, without):
        assert cfg.behavior.use_behavior_planner is False
        assert cfg.planning.replanning_frequency == 2
