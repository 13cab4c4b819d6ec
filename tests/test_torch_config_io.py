"""The port's reader and writer of the config files' YAML subset
(`devis_torch.config.load_yaml` / `dump_yaml`) against PyYAML: every file
under `configs/` reads to what `yaml.safe_load` gives, a dumped config reads
back to an equal tree (with both readers), and input outside the subset
raises `ValueError` naming the file and line. Exact equality throughout."""
import glob
import os

import pytest
import yaml

from devis_torch.config import dump_yaml, get_cfg_defaults, load_yaml, parse_yaml_value

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.relpath(p, ROOT) for p in CONFIGS])
def test_every_config_file_reads_as_pyyaml_reads_it(path):
    with open(path) as f:
        text = f.read()
    assert load_yaml(text, path) == (yaml.safe_load(text) or {})


@pytest.mark.parametrize("path", CONFIGS[:4], ids=[os.path.relpath(p, ROOT) for p in CONFIGS[:4]])
def test_dump_reads_back_to_an_equal_tree(path):
    cfg = get_cfg_defaults()
    cfg.merge_from_file(path)
    text = cfg.dump()
    assert load_yaml(text) == cfg.to_dict()
    assert yaml.safe_load(text) == cfg.to_dict()
    again = get_cfg_defaults()
    again.merge_from_other_cfg(load_yaml(text))
    assert again == cfg


def test_scalars_of_the_subset():
    doc = ("# comment\nA: 1\nB: -2.5\nC: 1e-4\nD: 2.0e-05\nE: True\nF: off\nG: null\nH: ~\n"
           "I: 'it''s # not a comment'\nJ: \"tab\\there\"\nK: bare words  # comment\n"
           "L: [1, 'a', [2.5, null], ]\nM:\n  - 3\n  - [4]\nN:\nO:\n  P: []\n")
    got = load_yaml(doc)
    assert got == {"A": 1, "B": -2.5, "C": 1e-4, "D": 2e-05, "E": True, "F": False,
                   "G": None, "H": None, "I": "it's # not a comment", "J": "tab\there",
                   "K": "bare words", "L": [1, "a", [2.5, None]], "M": [3, [4]], "N": None,
                   "O": {"P": []}}
    assert isinstance(got["C"], float)
    tree = {"X": {"Y": [1.5, -3, "q'x", None, True, [0.0001, 1e20]], "Z": float("inf")},
            "W": ""}
    assert load_yaml(dump_yaml(tree)) == tree


def test_overrides_parse_as_yaml_values():
    assert parse_yaml_value("0.0001") == 1e-4
    assert parse_yaml_value("1e-4") == 1e-4
    assert parse_yaml_value("[['/32', 'encoded'], ]") == [["/32", "encoded"]]
    assert parse_yaml_value("") is None and parse_yaml_value("''") == ""
    cfg = get_cfg_defaults()
    cfg.merge_from_list(["SOLVER.BASE_LR", "1e-4", "SOLVER.STEPS", "[3, 7]",
                         "MODEL.WEIGHTS", "", "TEST.EPOCHS_TO_EVAL", "[1]"])
    assert cfg.SOLVER.BASE_LR == 1e-4 and cfg.SOLVER.STEPS == [3, 7]
    assert cfg.MODEL.WEIGHTS is None and cfg.TEST.EPOCHS_TO_EVAL == [1]


@pytest.mark.parametrize("text,line", [
    ("A: {x: 1}\n", 1), ("A:\n\tB: 1\n", 2), ("A: [1, 2\n", 1), ("A: 0x1f\n", 1),
    ("A: &anchor 1\n", 1), ("A: b: c\n", 1), ("A: 1\nA: 2\n", 2), ("- a: 1\n", 1),
    ("A: |\n  text\n", 1), ("A: 1\n  B: 2\n", 2), ("just text\n", 1), ("A: 'open\n", 1),
    ("A: [1] x\n", 1), ("A: 1_000\n", 1)])
def test_input_outside_the_subset_raises_naming_file_and_line(text, line):
    with pytest.raises(ValueError, match=f"^bad.yaml:{line}: "):
        load_yaml(text, "bad.yaml")
