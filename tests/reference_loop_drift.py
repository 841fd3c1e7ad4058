"""How far apr_tpu's own FCGF training loop moves under a change of its
float32 rounding: the loop at tests/test_torch_rank_bodies.py's
LOOP_FIELDS (two steps over the tiny synthetic dataset of TINY["fcgf"])
on one device, against

- ``mesh``: the same loop on a 2-device CPU mesh (the other summation
  order of data parallelism), and
- ``nudged``: the same loop on one device from initial parameters each
  multiplied by (1 + NUDGE * a standard normal draw), about one float32
  ulp,

per seed.  Writes the fixture tests/test_torch_mesh_loops.py reads:

    python tests/reference_loop_drift.py 0 1 2 3 4 5 6 7 8 9 \
        --out tests/reference_loop_drift.json

A move is the largest move of a conv kernel (max |other - 1-device| over
that kernel's largest entry).  A float32 tie (a ReLU input, a hardest
negative) that flips under the other rounding moves a kernel by ~1e-3 of
its largest entry or more; without a flip the move is rounding, ~1e-6.
The fixture records the fields it was made at, so that a change of
LOOP_FIELDS or TINY shows as a stale fixture; a call adds its seeds to a
file made at the same fields, so the seeds may be spread over calls made
one after another (one process holds about three seeds before its JIT
memory runs out).  Not a test: it takes ~5 minutes a seed (the
reference's compiles).
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import conftest  # noqa: E402,F401  (the 8-device CPU mesh, before jax)
import jax  # noqa: E402
import numpy as np  # noqa: E402

import apr_tpu.data.datasets as ref_datasets  # noqa: E402
import apr_tpu.training.checkpoints as ref_checkpoints  # noqa: E402
import apr_tpu.training.trainer as ref_trainer  # noqa: E402
from apr_tpu.config import APRConfig  # noqa: E402
from apr_tpu.training.loop import run_training  # noqa: E402
from test_torch_rank_bodies import LOOP_FIELDS, TINY, \
    loop_fields_json  # noqa: E402

NUDGE = 1e-7


def kernel_drift(a, b):
    """The largest move of a conv kernel of ``a`` from ``b`` (dicts of
    name -> array), over that kernel's largest entry."""
    return max(float(np.abs(np.asarray(a[k], np.float64) - b[k]).max()
                     / np.abs(b[k]).max())
               for k in b if k.endswith("kernel"))


def reference_params(seed, num_devices, out_dir, nudge=0.0):
    """The reference loop's parameters after LOOP_FIELDS' epoch at
    ``seed`` on ``num_devices`` CPU devices, by '/'-joined name; with
    ``nudge`` its initial parameters are nudged as the module docstring
    says (draws from numpy's generator at ``seed``)."""
    n_train, n_val, n_points, apc = TINY["fcgf"]
    base = ref_datasets.SyntheticPairDataset

    class Tiny(base):
        def __init__(self, **kw):
            kw["num_pairs"] = {"train": n_train}.get(kw["phase"], n_val)
            kw.update(n_points=n_points, apc_points=apc, extent=25.0)
            super().__init__(**kw)

    saved = {}

    def save(self, epoch, state, extra=None, tag=None):
        saved["params"] = jax.device_get(state.params)

    real_init = ref_trainer.FCGFTrainer.init_state

    def nudged_init(self, key, sample):
        state = real_init(self, key, sample)
        rng = np.random.default_rng(seed)
        return state._replace(params=jax.tree_util.tree_map(
            lambda x: (np.asarray(x) * (1 + nudge * rng.standard_normal(
                np.shape(x)))).astype(np.asarray(x).dtype), state.params))

    real_save = ref_checkpoints.CheckpointManager.save
    ref_datasets.SyntheticPairDataset = Tiny
    ref_checkpoints.CheckpointManager.save = save
    if nudge:
        ref_trainer.FCGFTrainer.init_state = nudged_init
    try:
        run_training(APRConfig(**dict(LOOP_FIELDS, seed=seed,
                                      num_devices=num_devices,
                                      out_dir=out_dir)))
    finally:
        ref_datasets.SyntheticPairDataset = base
        ref_checkpoints.CheckpointManager.save = real_save
        ref_trainer.FCGFTrainer.init_state = real_init
    return {"/".join(str(getattr(p, "key", p)) for p in path):
            np.asarray(v, np.float64)
            for path, v in jax.tree_util.tree_leaves_with_path(
                saved["params"])}


def main(seeds, path=None):
    out = dict(loop_fields_json(), jax=jax.__version__, nudge=NUDGE,
               mesh={}, nudged={})
    with tempfile.TemporaryDirectory() as tmp:
        for seed in seeds:
            d = os.path.join(tmp, str(seed))
            one = reference_params(seed, 1, d + "_1")
            out["mesh"][str(seed)] = kernel_drift(
                reference_params(seed, 2, d + "_2"), one)
            out["nudged"][str(seed)] = kernel_drift(
                reference_params(seed, 1, d + "_n", NUDGE), one)
            print(f"reference loop, seed {seed}: the largest conv-kernel "
                  f"move on 2 devices {out['mesh'][str(seed)]!r}, nudged "
                  f"{out['nudged'][str(seed)]!r}", flush=True)
    if path:
        # a file made at the same fields keeps its other seeds
        old = {}
        if os.path.exists(path):
            with open(path) as f:
                old = json.load(f)
        same = all(old.get(k) == out[k] for k in
                   ("loop_fields", "tiny", "jax", "nudge"))
        for key in ("mesh", "nudged"):
            seen = dict(old.get(key, {}) if same else {}, **out[key])
            out[key] = {s: seen[s] for s in sorted(seen, key=int)}
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    path = None
    if "--out" in args:
        i = args.index("--out")
        path = args[i + 1]
        del args[i:i + 2]
    main([int(s) for s in args] or [0], path)
