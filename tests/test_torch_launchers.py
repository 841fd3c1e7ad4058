"""The paper-recipe launchers ``apr_torch/scripts/*.sh`` against the root
``scripts/*.sh``.

Each launcher runs under bash with a ``python`` shim first on ``PATH``
that writes its argv as JSON, with the same environment and one extra
flag passed through ``"$@"``.  Then:

- the port's launchers call ``python -m apr_torch.train`` /
  ``python -m apr_torch.scripts.test_apr|test_fcgf``;
- for a training launcher, the port's parser
  (``apr_torch/train.py::config_from_args``) gives the config the root
  ``train.py``'s gives on the reference's argv, field for field on the
  fields both configs have;
- for an eval launcher, the port entry's parser gives the reference
  entry's namespace, flag for flag (``tests/test_torch_eval_scripts.py``
  holds the effective configs equal for the same flags);
- ``train_apr_kitti.sh`` writes ``env.txt`` and tees the log, as the
  reference's does.

The documented differences, named:
- tuple flags: the port's parser takes each tuple field's element type
  (``--nets self cross self``), where the root ``train.py`` parses every
  tuple flag as ints (ROADMAP, "Faults of the reference");
- ``scripts/test_fcgf_nuscenes.sh`` passes ``--LoNUSCENES``, which the
  root ``scripts/test_fcgf.py`` refuses; the port's test_fcgf takes it.
"""

import argparse
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import pytest

from apr_torch.config import APRConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["train_apr_kitti", "train_apr_nuscenes", "train_fcgf_kitti",
         "train_fcgf_nuscenes"]
TEST = ["test_apr_kitti", "test_apr_nuscenes", "test_fcgf_kitti",
        "test_fcgf_nuscenes"]
SHIM = """#!{python}
import json, os, sys
with open(os.environ["SHIM_OUT"], "w") as f:
    json.dump(sys.argv[1:], f)
"""


def _launch(script, tmp_path, extra):
    """argv the launcher ``script`` (a path) gives ``python``."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    shim = bin_dir / "python"
    shim.write_text(SHIM.format(python=sys.executable))
    shim.chmod(0o755)
    out = tmp_path / f"argv_{os.path.basename(os.path.dirname(script))}.json"
    env = {k: v for k, v in os.environ.items()
           if k not in ("OUT_DIR", "SAVE_DIR", "LR", "MAX_EPOCH")}
    env.update(PATH=f"{bin_dir}{os.pathsep}{env['PATH']}", SHIM_OUT=str(out),
               OUT_DIR=str(tmp_path / "out"), SAVE_DIR=str(tmp_path / "run"))
    subprocess.run(["bash", script, *extra], env=env, cwd=str(tmp_path),
                   check=True, timeout=60, capture_output=True)
    return json.loads(out.read_text())


def _pair(name, tmp_path, extra):
    ref = _launch(os.path.join(ROOT, "scripts", f"{name}.sh"), tmp_path,
                  extra)
    ours = _launch(os.path.join(ROOT, "apr_torch", "scripts", f"{name}.sh"),
                   tmp_path, extra)
    return ref, ours


def _common(ours: APRConfig, ref) -> None:
    ref_d = ref.to_dict()
    ours_d = ours.to_dict()
    shared = [f.name for f in dataclasses.fields(APRConfig)
              if f.name in ref_d]
    assert len(shared) > 100
    assert {k: ours_d[k] for k in shared} == {k: ref_d[k] for k in shared}


@pytest.mark.parametrize("name", TRAIN)
def test_training_launcher_gives_the_references_config(name, tmp_path):
    import train as ref_train

    from apr_torch import train as port_train

    ref, ours = _pair(name, tmp_path, ["--seed", "7"])
    assert ref[0] == "train.py"
    assert ours[:2] == ["-m", "apr_torch.train"]
    assert ours[2:] == ref[1:]
    cfg = port_train.config_from_args(ours[2:])
    assert cfg.seed == 7 and cfg.dataset.startswith("PairComplement")
    _common(cfg, ref_train.config_from_args(ref[1:]))
    if name == "train_apr_kitti":
        out = tmp_path / "out"
        assert (out / "env.txt").read_text().startswith("git sha: ")
        assert [p.name for p in out.glob("log_*.txt")]


class _Parsed(Exception):
    pass


def _parsed(monkeypatch, main, argv):
    """The namespace ``main``'s parser makes of ``argv``; stops ``main``
    there, before it reads a run."""
    parse = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise _Parsed(vars(parse(self, args, namespace)))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as got:
        main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    return got.value.args[0]


@pytest.mark.parametrize("name", TEST)
def test_eval_launcher_parses_as_the_reference(name, tmp_path, monkeypatch):
    ref, ours = _pair(name, tmp_path, ["--num_pairs", "3"])
    entry = name.rsplit("_", 1)[0]                 # test_apr | test_fcgf
    assert ref[:2] == ["-m", f"scripts.{entry}"]
    assert ours[:2] == ["-m", f"apr_torch.scripts.{entry}"]
    assert ours[2:] == ref[2:]
    ref_argv = ref[2:]
    ref_main = importlib.import_module(f"scripts.{entry}").main
    if name == "test_fcgf_nuscenes":
        # the reference's launcher passes a flag its entry refuses
        with pytest.raises(SystemExit):
            _parsed(monkeypatch, ref_main, ref_argv)
        at = ref_argv.index("--LoNUSCENES")
        ref_argv = ref_argv[:at] + ref_argv[at + 2:]
    want = _parsed(monkeypatch, ref_main, ref_argv)
    got = _parsed(monkeypatch,
                  importlib.import_module(f"apr_torch.scripts.{entry}").main,
                  ours[2:])
    assert got["device"] == "cuda" and "device" not in want
    shared = set(got) & set(want)
    assert len(shared) >= 8 and set(want) - shared == set()
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert got["num_pairs"] == 3 and got["save_dir"] == str(tmp_path / "run")
    assert got["LoNUSCENES"] is {"test_apr_nuscenes": True,
                                 "test_fcgf_nuscenes": False}.get(name)


def test_tuple_flags_take_their_element_type():
    """The documented difference: ``--nets self cross self`` configures
    the port's GCN; the root train.py's parser refuses it."""
    import train as ref_train

    from apr_torch import train as port_train

    argv = ["--nets", "self", "cross", "self", "--kp_capacities", "8192",
            "4096", "2048", "1024"]
    cfg = port_train.config_from_args(argv)
    assert cfg.nets == ("self", "cross", "self")
    assert cfg.kp_capacities == (8192, 4096, 2048, 1024)
    with pytest.raises(SystemExit):
        ref_train.build_parser().parse_args(argv)
    # int tuples parse alike
    ref = ref_train.config_from_args(argv[4:])
    assert tuple(ref.kp_capacities) == cfg.kp_capacities


@pytest.mark.parametrize("name", TRAIN + TEST)
def test_launcher_is_executable_and_passes_its_flags_through(name):
    path = os.path.join(ROOT, "apr_torch", "scripts", f"{name}.sh")
    assert os.access(path, os.X_OK)
    text = open(path).read()
    assert text.startswith("#!/bin/bash\n") and "set -e" in text
    assert '"$@"' in text and 'cd "$(dirname "$0")/../.."' in text
