"""The rank bodies of the multi-rank tests (tests/test_torch_parallel_mesh.py,
test_torch_dp_fcgf.py, test_torch_dp_predator.py,
test_torch_sharded_eval.py and test_torch_mesh_loops.py).

The tests spawn gloo ranks on the CPU through
``apr_torch.parallel.launch.spawn``; each rank imports this module by name,
so it imports no JAX and nothing of apr_tpu (the tests compute the
reference in their own process).  Everything crosses the process boundary
as numpy arrays.  It holds no test.
"""

import logging
import os
import time

import numpy as np
import torch


def np_tree(tree):
    """Tensors -> numpy arrays, through dicts, lists, tuples and
    NamedTuples (NamedTuples become tuples)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    return tree


def torch_tree(tree):
    """numpy arrays -> tensors (the inverse of :func:`np_tree` for state
    dicts)."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [torch_tree(v) for v in tree]
    return tree


def replay(queue):
    """The contrastive sampler takes, call after call, the queued scores
    (numpy arrays drawn by the reference)."""
    from apr_torch.losses import contrastive

    def sample(generator, mask, num):
        return contrastive.top_valid(torch.from_numpy(queue.pop(0).copy()),
                                     mask, num)
    contrastive._sample_without_replacement = sample


def module_states(trainer):
    return [np_tree(m.state_dict()) for m in trainer.modules()]


def load_modules(trainer, states):
    for m, sd in zip(trainer.modules(), states):
        m.load_state_dict(torch_tree(sd), strict=True)
    return trainer


# --- the mesh and the collectives ---------------------------------------

def mesh_basics(mesh, tree, fields, raw):
    """shard_batch of ``tree``; a trainer with its own seed and one
    meshless step (so the optimizer has state), its step count changed,
    before and after ``replicate``."""
    from apr_torch.config import APRConfig
    from apr_torch.parallel import replicate, shard_batch
    from apr_torch.training.trainer import FCGFTrainer

    shards = np_tree(shard_batch(tree, mesh))
    trainer = FCGFTrainer(APRConfig(**fields), device="cpu", seed=mesh.rank)
    trainer.train_step(trainer.build_batch(raw),
                       torch.Generator().manual_seed(mesh.rank))
    trainer.step = 10 + mesh.rank
    trainer._set_group_lr(0.5 + mesh.rank)
    before = np_tree(trainer.state_dict())
    replicate(trainer, mesh)
    return dict(shards=shards, before=before,
                after=np_tree(trainer.state_dict()))


def autograd_checks(mesh, xs, w):
    """The gather's and the all-reduce's backward on this rank's x (float64):
    C = sum(sin(gather(x)) * w), the same on every rank; and this rank's
    share m * sum(x) + sum(cos(x)) of L = sum over ranks, with m the
    all-reduced sum of x * x."""
    from apr_torch.parallel.collectives import all_reduce_sum, gather_batch

    x = torch.tensor(xs[mesh.rank], dtype=torch.float64, requires_grad=True)
    c = (torch.sin(gather_batch(x, mesh)) * torch.tensor(w)).sum()
    c.backward()
    x2 = torch.tensor(xs[mesh.rank], dtype=torch.float64, requires_grad=True)
    m = all_reduce_sum((x2 * x2).sum(), mesh)
    (m * x2.sum() + torch.cos(x2).sum()).backward()
    return dict(c=float(c), m=float(m), g_gather=np_tree(x.grad),
                g_reduce=np_tree(x2.grad))


def chamfer_sp_rank(mesh, a, b, am, bm):
    """The sequence-parallel Chamfer's value and whole input gradients."""
    from apr_torch.parallel.chamfer_sp import chamfer_distance_sp

    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    v = chamfer_distance_sp(mesh)(ta, tb, torch.tensor(am),
                                  torch.tensor(bm))
    v.backward()
    return float(v), np_tree(ta.grad), np_tree(tb.grad)


def stall(mesh, seconds, timeout):
    """Both ranks make a group with a ``timeout`` of seconds; rank 0
    sleeps, and rank 1 waits in an all-reduce of that group that rank 0
    never joins, until the timeout."""
    import datetime

    import torch.distributed as dist

    group = dist.new_group([0, 1], timeout=datetime.timedelta(
        seconds=timeout))
    if mesh.rank == 0:
        time.sleep(seconds)
        return None
    t = torch.zeros(1)
    dist.all_reduce(t, group=group)
    return float(t)


def fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("planted failure on rank 1")
    return mesh.rank


# --- the FCGF data-parallel step -----------------------------------------

def fcgf_dp(mesh, fields, modules, raw, queues):
    """From the same weights (``modules``): this rank's build; two SGD
    steps with the queued reference draws (every rank the same); two
    iter_size=2 mini-steps; a valid step after the two SGD steps; a step
    with a non-finite target on rank 1 only, then a finite one."""
    from apr_torch.config import APRConfig
    from apr_torch.parallel import shard_batch
    from apr_torch.training.trainer import FCGFTrainer

    cfg = APRConfig(**fields)

    def fresh(**kw):
        trainer = FCGFTrainer(cfg.replace(**kw), device="cpu", seed=5)
        load_modules(trainer, modules)
        trainer.use_mesh(mesh)
        return trainer

    out = {}
    trainer = fresh()
    batch = trainer.build_batch(shard_batch(raw, mesh))
    out["build"] = np_tree(tuple(batch))
    out["steps"] = []
    for q in queues:
        replay(list(q))
        m = trainer.train_step(batch)
        out["steps"].append(dict(
            metrics={k: float(v) for k, v in m.items()},
            state=module_states(trainer),
            grads=[np_tree(p.grad) for p in trainer.parameters()]))
    acc = fresh(iter_size=2)
    moved = []
    for q in queues:
        before = [p.detach().clone() for p in acc.parameters()]
        replay(list(q))
        acc.train_step(batch)
        moved.append(any(not torch.equal(a, p) for a, p in zip(
            before, acc.parameters())))
    out["iter2"] = dict(state=module_states(acc), moved=moved,
                        mini_step=acc.accumulation.mini_step)
    replay(list(queues[-1]))
    out["valid"] = {k: float(v) for k, v in trainer.valid_step(
        batch).items()}
    gated = fresh()
    before = module_states(gated)
    bad = batch
    if mesh.rank == 1:
        bad = batch._replace(apc0=batch.apc0.clone())
        bad.apc0[0, 0] = float("inf")
    replay(list(queues[0]))
    m = gated.train_step(bad)
    after = module_states(gated)
    momenta = sum("momentum_buffer" in v
                  for v in gated.optimizer.state.values())
    replay(list(queues[0]))
    m2 = gated.train_step(batch)
    out["nonfinite"] = dict(
        skipped=float(m["skipped_nonfinite"]), loss=float(m["loss"]),
        unchanged=all(np.array_equal(a[k], b[k]) for a, b in zip(
            before, after) for k in a),
        momenta_after_skip=momenta,
        next_skipped=float(m2["skipped_nonfinite"]), step=gated.step)
    return out


# --- the Predator grouped step --------------------------------------------

def predator_dp(mesh, fields, modules, raws, weights, scores):
    """This rank's pair of the group, stepped from the same weights under
    each of the group's ``weights`` (a dict of names), with its own
    replayed draws."""
    from apr_torch.config import APRConfig
    from apr_torch.training.predator import PredatorTrainer

    out = {}
    for name, w in weights.items():
        trainer = PredatorTrainer(APRConfig(**fields), device="cpu", seed=5)
        load_modules(trainer, modules)
        trainer.use_mesh(mesh)
        raw = tuple(np.stack([x]) for x in raws[mesh.rank])
        batch = trainer.build_batch_group(raw)
        replay([scores[mesh.rank]])
        m = trainer.train_step_batched(batch, None, 1.0, pair_weights=w)
        out[name] = dict(metrics={k: float(v) for k, v in m.items()},
                         state=np_tree(trainer.state_dict()))
    return out


# --- test_sharded ---------------------------------------------------------

def sharded_eval(mesh, jobs):
    """``test_sharded`` of the FCGF ("fcgf") or Predator tester for each
    job (kind, fields, modules, pairs, seed, draws), with the reference's
    draws looked up by each pair's ground truth: (uniform scores, RANSAC
    stage draws) for FCGF, ((u0, u1), stage draws) for Predator."""
    return [_sharded_eval(mesh, *job) for job in jobs]


def _sharded_eval(mesh, kind, fields, modules, pairs, seed, draws):
    from apr_torch.config import APRConfig
    from apr_torch.eval import FeatureTester, PredatorTester
    from apr_torch.training.predator import PredatorTrainer
    from apr_torch.training.trainer import FCGFTrainer

    cfg = APRConfig(**fields)
    if kind == "fcgf":
        trainer = FCGFTrainer(cfg, device="cpu")
        tester = FeatureTester(cfg, trainer, device="cpu")
    else:
        trainer = PredatorTrainer(cfg, device="cpu")
        tester = PredatorTester(cfg, trainer, device="cpu")
    load_modules(trainer, modules)
    real_step = tester.step
    seen = []

    def step(batch, generator=None):
        key = batch.t_gt.reshape(4, 4).numpy().astype(np.float32).tobytes()
        seen.append(key)
        u, stage = draws[key]
        stage = [torch.from_numpy(np.asarray(x)) for x in stage]
        if kind == "fcgf":
            m0 = batch.pyramid0.levels[0].mask[0]
            scores = torch.where(m0, torch.from_numpy(u), -1.0)
            return real_step(batch, scores=scores, stage_draws=stage)
        return real_step(batch, uniforms=tuple(torch.from_numpy(x)
                                               for x in u),
                         stage_draws=stage)

    tester.step = step
    stats = tester.test_sharded(pairs, mesh=mesh, seed=seed)
    return dict(rte=stats.rte, rre=stats.rre, success=stats.success,
                fitness=stats.fitness, pair_dist=stats.pair_dist,
                sec_per_pair=stats.sec_per_pair, seen=seen)


# --- the loops ------------------------------------------------------------

# the FCGF loop is ill-conditioned at float32 rounding: a ReLU input
# within one float32 ulp of the layer's scale of 0 takes the other sign
# under the ranks' other summation order, and the flipped element's
# gradient moves a conv kernel by ~1e-3 of its largest entry in one step
# (seeds 0 and 1 have such an input: one at seed 0, four at seed 1).  So
# the loops' tolerance tests take a seed without one;
# test_torch_mesh_loops.py runs seeds 0 and 1 with every ReLU decision of
# the one-process loop pinned to the ranks' (ReluDecisions), which leaves
# rounding only, and holds their unpinned move to the reference loop's
# own (tests/reference_loop_drift.py)
LOOP_SEED = 2
LOOP_FIELDS = dict(
    trainer="GenerativePairTrainer", model="ResUNetBN2", model_n_out=16,
    conv1_kernel_size=3, generator_model="GenerativeMLP_54",
    point_generation_ratio=2, dataset="synthetic", batch_size=2,
    num_pos_per_batch=64, num_hn_samples_per_batch=32, voxel_size=1.0,
    point_capacity=2048, capacities=(1024, 512, 256, 128),
    apc_capacity=2048, max_epoch=1, stat_freq=1, pair_min_dist=4.0,
    pair_max_dist=8.0, compute_dtype="float32", val_batch_size=2,
    seed=LOOP_SEED)
PRED_LOOP_FIELDS = dict(
    trainer="PredatorTrainer", seed=42, first_feats_dim=16,
    final_feats_dim=8, first_subsampling_dl=1.0, conv_radius=2.5,
    compute_dtype="float32", gnn_feats_dim=16, dgcnn_k=4, num_head=2,
    generator_model="GenerativeMLP_4", point_generation_ratio=2,
    pos_radius=1.0, safe_radius=2.5, overlap_radius=1.2,
    matchability_radius=1.2, max_points=64, lr=0.01, sgd_momentum=0.98,
    max_epoch=1, stat_freq=1, dataset="synthetic", pair_min_dist=4.0,
    pair_max_dist=8.0, point_capacity=2500, apc_capacity=1024,
    kp_capacities=(1024, 512, 256, 128), neighborhood_limits=(16,) * 4,
    chamfer_mode="pallas")
TINY = dict(fcgf=(4, 3, 1500, 1500), predator=(3, 3, 2000, 500))
# the seeds whose FCGF loop has a ReLU input at a float32 tie
TIE_SEEDS = (0, 1)


def kernel_move(got, want):
    """The largest move of a conv kernel of ``got`` from ``want`` (lists of
    module state dicts), over that kernel's largest entry."""
    return max(float(np.abs(got[i][k].astype(np.float64) - want[i][k])
                     .max() / np.abs(want[i][k]).max())
               for i in range(len(want)) for k in want[i]
               if k.endswith("kernel"))


def loop_fields_json():
    """What tests/reference_loop_drift.json is made at: LOOP_FIELDS
    without the seed and the tiny FCGF dataset's sizes, as JSON values."""
    fields = {k: list(v) if isinstance(v, tuple) else v
              for k, v in LOOP_FIELDS.items() if k != "seed"}
    return dict(loop_fields=fields, tiny=list(TINY["fcgf"]))


def tiny_datasets(n_train, n_val, n_points, apc_points):
    """The synthetic dataset with few, small pairs (assigned into
    apr_torch.data.datasets, where make_dataset finds it); returns the
    class it replaced."""
    import apr_torch.data.datasets as dsmod

    base = getattr(dsmod.SyntheticPairDataset, "_full", None) or \
        dsmod.SyntheticPairDataset

    class Tiny(base):
        _full = base

        def __init__(self, **kw):
            kw["num_pairs"] = {"train": n_train}.get(kw["phase"], n_val)
            kw.update(n_points=n_points, apc_points=apc_points,
                      extent=25.0)
            super().__init__(**kw)

    dsmod.SyntheticPairDataset = Tiny
    return base


class ReluDecisions:
    """Within the block, records the sign decision (input > 0) of every
    ``torch.relu`` whose input requires grad (the train steps' forwards),
    in call order.  With ``pins`` (per call, the recorded masks of each
    rank, in rank order) it imposes them instead: the call returns the
    input where the pin says positive and 0 elsewhere, and ``ties`` gets,
    for each call whose own decision differed, the largest such input's
    magnitude over the call's largest one."""

    def __init__(self, pins=None):
        self.pins = pins
        self.masks = []
        self.ties = []

    def __enter__(self):
        self._relu = torch.relu
        torch.relu = self._decide
        return self

    def __exit__(self, *exc):
        torch.relu = self._relu

    def _decide(self, x):
        if not x.requires_grad:
            return self._relu(x)
        own = (x > 0).detach()
        j = len(self.masks)
        self.masks.append(own.cpu().numpy().copy())
        if self.pins is None:
            return self._relu(x)
        parts = self.pins[j]
        # a rank's call holds its pairs' rows: the whole batch's call is
        # the ranks' rows in rank order, or the same array on every rank
        pin = parts[0] if parts[0].shape == tuple(x.shape) else \
            np.concatenate(parts)
        pin = torch.from_numpy(pin).to(x.device)
        moved = pin != own
        if moved.any():
            a = x.detach().abs()
            self.ties.append(float(a[moved].max() / a.max()))
        return torch.where(pin, x, 0.0)


class Spy:
    """Counts this process's file writes and records the trainers the
    loops make and the log lines at WARNING and above."""

    def __init__(self):
        import apr_torch.training.loop as loopmod
        import apr_torch.training.predator_loop as ploop
        from apr_torch.config import APRConfig
        from apr_torch.training.checkpoints import CheckpointManager

        self.writes = {"config": 0, "metrics": 0, "checkpoint": 0}
        self.trainers = []
        self.warnings = []
        spy = self

        def counted(cls, name, kind):
            real = getattr(cls, name)

            def wrapper(*a, **k):
                spy.writes[kind] += 1
                return real(*a, **k)
            setattr(cls, name, wrapper)

        counted(APRConfig, "save_json", "config")
        counted(loopmod.MetricsLogger, "write", "metrics")
        counted(CheckpointManager, "save", "checkpoint")
        for module, name in ((loopmod, "get_trainer"),
                             (ploop, "PredatorTrainer")):
            real = getattr(module, name)

            def make(*a, _real=real, **k):
                trainer = _real(*a, **k)
                spy.trainers.append(trainer)
                return trainer
            setattr(module, name, make)

        class Handler(logging.Handler):
            def emit(self, record):
                spy.warnings.append(record.getMessage())

        handler = Handler(level=logging.WARNING)
        logging.getLogger("apr_torch").addHandler(handler)


def loop_scenarios(mesh, tmp):
    """Both loops over the mesh on tiny synthetic datasets: the FCGF loop
    data parallel (num_devices=2), its loader's epoch, the builder /
    trainer split (mesh_n_builders=1), an incompatible split (2 builders
    of 2 ranks) and the Predator loop.  Per scenario: this rank's summary,
    final trainer state and file writes."""
    from apr_torch.config import APRConfig
    from apr_torch.data.datasets import make_dataset
    from apr_torch.data.pipeline import PairLoader
    from apr_torch.training.loop import run_training
    from apr_torch.training.predator_loop import run_predator_training

    spy = Spy()
    out = {}

    def fcgf(name, **kw):
        tiny_datasets(*TINY["fcgf"])
        spy.writes = dict.fromkeys(spy.writes, 0)
        spy.warnings.clear()
        cfg = APRConfig(**LOOP_FIELDS).replace(
            out_dir=os.path.join(tmp, name), **kw)
        with ReluDecisions() as relus:
            summary = run_training(cfg, device="cpu")
        trainer = spy.trainers[-1]
        out[name] = dict(summary=summary, writes=dict(spy.writes),
                         warnings=list(spy.warnings),
                         modules=module_states(trainer), step=trainer.step,
                         relus=relus.masks if "seed" in kw else None)

    fcgf("dp", num_devices=2)
    for seed in TIE_SEEDS:
        fcgf(f"dp_seed{seed}", num_devices=2, seed=seed)
    cfg = APRConfig(**LOOP_FIELDS)
    loader = PairLoader(make_dataset(cfg, "train"), cfg, shuffle=True,
                        seed=cfg.seed, device="cpu", mesh=mesh)
    loader.set_epoch(0)
    out["loader"] = [np_tree(tuple(b)) for b in loader]
    fcgf("pipeline", num_devices=2, mesh_n_builders=1)
    fcgf("fallback", num_devices=2, mesh_n_builders=2)

    tiny_datasets(*TINY["predator"])
    spy.writes = dict.fromkeys(spy.writes, 0)
    cfg = APRConfig(**PRED_LOOP_FIELDS).replace(
        out_dir=os.path.join(tmp, "predator"), num_devices=2)
    summary = run_predator_training(cfg, device="cpu")
    trainer = spy.trainers[-1]
    out["predator"] = dict(summary=summary, writes=dict(spy.writes),
                           modules=module_states(trainer),
                           step=trainer.step)
    return out
