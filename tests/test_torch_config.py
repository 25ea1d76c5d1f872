"""The port's YAML reader (``utils/yaml_subset.py``) against PyYAML's
``safe_load``, and the configs it loads against the JAX package's
``Config.load`` (PyYAML plus its scalar coercion), on every file in
``configs/``."""

import glob
import os

import pytest
import yaml

from ct_pvae_tpu.config import Config as JaxConfig
from ct_pvae_tpu_torch.config import Config
from ct_pvae_tpu_torch.utils import yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_configs_read_as_pyyaml_reads_them(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    got = yaml_subset.load(path)
    assert got == want and all(type(got[k]) is type(want[k]) for k in want)
    if "base" in want:  # the HPO sweep file: a run config under `base`
        assert Config.from_dict(got["base"]).to_dict() == JaxConfig.from_dict(want["base"]).to_dict()
    else:
        assert Config.load(path).to_dict() == JaxConfig.load(path).to_dict()


def test_yaml_reader_refuses_what_it_does_not_read():
    assert yaml_subset.loads("a: 1.0e4\nb: [1, 2.5, x]\nc:\n  d: ~\n") == \
        {"a": "1.0e4", "b": [1, 2.5, "x"], "c": {"d": None}}
    for text in ("a:\n  - 1\n", "a: {b: 1}\n", "a: &x 1\n", "a: 1\n a: 2\n", "a: [[1]]\n",
                 "a: 1\na: 2\n"):
        with pytest.raises(ValueError):
            yaml_subset.loads(text)
