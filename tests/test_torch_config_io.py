"""The port's config I/O against apr_tpu's: the YAML reader (standard
library only) against ``yaml.safe_load`` and the reference's
``APRConfig.from_yaml``, ``config.json`` both ways, and the train CLI's
flags.  Everything here is exact: the same keys with the same values."""

import dataclasses
import glob
import json
import os

import pytest
import yaml

import train as ref_train
from apr_torch import train as port_train
from apr_torch.config import APRConfig, flatten, read_yaml
from apr_tpu.config import APRConfig as RefConfig

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(_ROOT, "configs", "*", "*.yaml")))
SHARED = sorted({f.name for f in dataclasses.fields(APRConfig)}
                & {f.name for f in dataclasses.fields(RefConfig)})


def _shared(a, b):
    da, db = a.to_dict(), b.to_dict()
    return {k: da[k] for k in SHARED}, {k: db[k] for k in SHARED}


def test_the_port_has_the_fields_its_loops_read():
    port = {f.name for f in dataclasses.fields(APRConfig)}
    assert {"val_batch_size", "max_epoch", "stat_freq", "val_epoch_freq",
            "best_val_metric", "seed", "neighborhood_limits_pinned",
            "w_saliency_loss", "dataset", "pair_min_dist", "pair_max_dist",
            "train_capacity_buckets", "out_dir", "resume", "weights",
            "profile_dir", "profile_start", "profile_steps", "num_devices",
            "fused_build", "mesh_n_builders"} <= port
    assert len(SHARED) == len(port)            # every port field is shared
    ref, got = RefConfig(), APRConfig()
    assert _shared(got, ref)[0] == _shared(got, ref)[1]   # same defaults


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_read_yaml_equals_safe_load_and_the_reference(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    got = read_yaml(path)
    assert got == want
    assert [type(v) for v in flatten(got).values()] == [
        type(v) for v in flatten(want).values()]
    a, b = _shared(APRConfig.from_yaml(path), RefConfig.from_yaml(path))
    assert a == b


def test_read_yaml_scalars_and_comments(tmp_path):
    text = """# a comment line
top: 3   # trailing comment
section:
  an_int: -42
  big: 1_000
  float_dot: 0.000001
  float_exp: 1.5e-3
  not_a_float: 1e-6
  yes_word: yes
  off_word: Off
  bools: [true, False, on]
  nothing:
  tilde: ~
  quoted: "a # not a comment"
  single: 'x: y'
  path: ./outputs/run
  empty_list: []
  nets: [self, cross, self]
  inf: .inf
other:
  deeper:
    leaf: 0.5
"""
    p = tmp_path / "c.yaml"
    p.write_text(text)
    assert read_yaml(str(p)) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a:\n  - 1\n  - 2\n", "a: {b: 1}\n",
                                  "a: 0x1f\n", "a:\n   b: 1\n  c: 2\n"])
def test_read_yaml_refuses_what_it_does_not_parse(tmp_path, text):
    p = tmp_path / "c.yaml"
    p.write_text(text)
    with pytest.raises(ValueError):
        read_yaml(str(p))


def test_json_round_trip_and_the_reference_config_json(tmp_path):
    cfg = APRConfig(capacities=(64, 32, 16, 8), nets=("self", "cross"),
                    lr=0.05, weights="w", fused_build=True)
    cfg.save_json(str(tmp_path / "port.json"))
    back = APRConfig.load_json(str(tmp_path / "port.json"))
    assert back == cfg
    assert isinstance(back.capacities, tuple)
    ref = RefConfig(capacities=(64, 32, 16, 8), nets=("self", "cross"),
                    lr=0.05, weights="w", fused_build=True)
    ref.save_json(str(tmp_path / "ref.json"))
    port_json = json.load(open(tmp_path / "port.json"))
    ref_json = json.load(open(tmp_path / "ref.json"))
    assert port_json == {k: ref_json[k] for k in port_json}
    # a reference config.json loads into the port (its extra keys drop)
    assert APRConfig.load_json(str(tmp_path / "ref.json")) == cfg
    assert cfg.replace(capacities=[8, 4, 2, 1]).capacities == (8, 4, 2, 1)


ARGVS = [
    ["--trainer", "GenerativePairTrainer", "--model", "ResUNetBN2",
     "--model_n_out", "16", "--capacities", "1024", "512", "256", "128",
     "--voxel_size", "1.0", "--fused_build", "true", "--max_epoch", "1"],
    ["--symmetric", "yes", "--iter_size", "2", "--lr", "0.01",
     "--test_ransac_dist_thresh", "0.5", "--num_devices", "1",
     "--resume", "somewhere", "--profile_dir", "prof", "--normalize_feature",
     "false", "--neighborhood_limits", "20", "20", "20", "20"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_config_from_args_equals_the_reference(argv):
    a, b = _shared(port_train.config_from_args(argv),
                   ref_train.config_from_args(argv))
    assert a == b


def test_resume_dir_reapplies_config_json(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    RefConfig(model_n_out=16, batch_size=2, lr=0.3,
              capacities=(64, 32, 16, 8)).save_json(str(run / "config.json"))
    argv = ["--resume_dir", str(run), "--max_epoch", "5", "--lr", "0.2"]
    got = port_train.config_from_args(argv)
    a, b = _shared(got, ref_train.config_from_args(argv))
    assert a == b
    assert (got.resume, got.model_n_out, got.lr, got.max_epoch) == (
        str(run), 16, 0.2, 5)
    # --device is the port's own flag, not a config field
    assert port_train.config_from_args(argv + ["--device", "cpu"]) == got
