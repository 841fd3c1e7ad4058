"""apr_torch.parallel's mesh, its collectives and the launcher, over gloo
ranks on the CPU (the rank bodies are in test_torch_rank_bodies.py), and
the sequence-parallel Chamfer against apr_tpu's on a 2-device mesh.

- ``shard_batch`` gives rank r rows [r b, (r + 1) b) of every leaf, exactly;
  a batch that does not divide the mesh raises, as GSPMD's sharding does;
- ``replicate`` makes a trainer's whole state (parameters, running stats,
  the optimizer's momentum, step and learning rate) rank 0's, bit for bit;
- the gather's backward keeps each rank's slice and the all-reduce's sums
  the ranks' gradients: their gradients match central finite differences
  of the global function (float64, within 1e-6);
- ``chamfer_distance_sp`` over 2 ranks against apr_tpu's
  ``chamfer_distance_sp`` on 2 devices and against the one-device
  ``chamfer_distance``: the JAX test's tolerances (value rtol 1e-5,
  gradients rtol 1e-4 and atol 1e-6);
- a rank that raises fails the launch with its traceback, a collective
  that one rank never joins fails at the group's timeout, and a CUDA mesh
  without a card raises.
"""

import jax
import numpy as np
import pytest
import torch

from apr_tpu.ops.chamfer import chamfer_distance as ref_chamfer
from apr_tpu.parallel import make_mesh as ref_make_mesh
from apr_tpu.parallel.chamfer_sp import chamfer_distance_sp as ref_sp
from apr_torch.config import APRConfig
from apr_torch.ops.chamfer import chamfer_distance
from apr_torch.parallel import make_mesh, shard_batch
from apr_torch.parallel.launch import spawn
from apr_torch.parallel.mesh import Mesh
from test_torch_rank_bodies import autograd_checks, chamfer_sp_rank, \
    fail_on_rank_one, mesh_basics, stall
from test_torch_train import FIELDS, _raw

TIMEOUT = 60          # seconds a collective may wait
DEADLINE = 300        # seconds a launch may take


def _launch(tmp_path, fn, *args, world=2, **kw):
    kw = dict(dict(timeout=TIMEOUT, deadline=DEADLINE), **kw)
    return spawn(fn, world, args=args, devices="cpu",
                 init_file=str(tmp_path / f"rdzv_{fn.__name__}"), **kw)


@pytest.fixture(scope="module")
def basics(tmp_path_factory):
    tree = dict(a=np.arange(24, dtype=np.float32).reshape(4, 6),
                b=(np.arange(8).reshape(4, 2) % 3 == 0, np.float32(3.5)))
    raw = _raw(APRConfig(**FIELDS))
    out = _launch(tmp_path_factory.mktemp("mesh"), mesh_basics, tree, FIELDS,
                  raw)
    return tree, out


def test_shard_batch_keeps_each_ranks_rows(basics):
    tree, out = basics
    for r, got in enumerate(out):
        np.testing.assert_array_equal(got["shards"]["a"],
                                      tree["a"][2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["shards"]["b"][0],
                                      tree["b"][0][2 * r:2 * r + 2])
        assert got["shards"]["b"][1] == tree["b"][1]


def test_shard_batch_refuses_a_batch_that_does_not_divide():
    mesh = Mesh(rank=1, size=3, device=torch.device("cpu"), ranks=(0, 1, 2))
    assert shard_batch(np.zeros((6, 2)), mesh).shape == (2, 2)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch((np.zeros((6, 2)), torch.zeros(4, 1)), mesh)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, x in tree.items()
                for k2, v in _flat(x, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v for i, x in enumerate(tree)
                for k2, v in _flat(x, f"{prefix}{i}.").items()}
    return {prefix: tree}


def test_replicate_makes_the_whole_state_rank_zeros(basics):
    _, out = basics
    src, other = _flat(out[0]["before"]), _flat(out[1]["before"])
    differs = [k for k in src if not np.array_equal(src[k], other[k])]
    assert any("momentum_buffer" in k for k in differs)
    assert "step." in differs and "lr." in differs
    for r in (0, 1):
        after = _flat(out[r]["after"])
        assert after.keys() == src.keys()
        for k in src:
            np.testing.assert_array_equal(after[k], src[k], err_msg=k)


def _central(f, x, eps=1e-6):
    g = np.zeros_like(x)
    for i in range(x.size):
        d = np.zeros_like(x)
        d.flat[i] = eps
        g.flat[i] = (f(x + d) - f(x - d)) / (2 * eps)
    return g


def test_gather_and_all_reduce_backward_match_finite_differences(tmp_path):
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(2, 3))
    w = rng.normal(size=6)
    out = _launch(tmp_path, autograd_checks, xs, w)

    def c(x):
        return float((np.sin(x.reshape(-1)) * w).sum())

    def loss(x):
        return float((x * x).sum() * x.sum() + np.cos(x).sum())

    g_c, g_l = _central(c, xs), _central(loss, xs)
    for r, got in enumerate(out):
        assert got["c"] == pytest.approx(c(xs), rel=1e-12)
        assert got["m"] == pytest.approx(float((xs * xs).sum()), rel=1e-12)
        np.testing.assert_allclose(got["g_gather"], g_c[r], atol=1e-6)
        np.testing.assert_allclose(got["g_reduce"], g_l[r], atol=1e-6)


def test_chamfer_sp_matches_reference_and_one_device(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.uniform(-20, 20, (512, 3)).astype(np.float32)
    b = rng.uniform(-20, 20, (768, 3)).astype(np.float32)
    am = np.ones(512, bool)
    am[490:] = False
    bm = np.ones(768, bool)
    bm[700:] = False
    out = _launch(tmp_path, chamfer_sp_rank, a, b, am, bm)

    args = tuple(jax.numpy.asarray(x) for x in (a, b, am, bm))
    f_sp = ref_sp(ref_make_mesh(jax.devices()[:2]))
    v_sp, (ga_sp, gb_sp) = jax.jit(jax.value_and_grad(
        f_sp, argnums=(0, 1)))(*args)
    v_1, (ga_1, gb_1) = jax.jit(jax.value_and_grad(
        ref_chamfer, argnums=(0, 1)))(*args)
    ta = torch.tensor(a[None], requires_grad=True)
    tb = torch.tensor(b[None], requires_grad=True)
    v_port = chamfer_distance(ta, tb, torch.tensor(am[None]),
                              torch.tensor(bm[None]))[0]
    v_port.backward()
    want = [(float(v_sp), np.asarray(ga_sp), np.asarray(gb_sp)),
            (float(v_1), np.asarray(ga_1), np.asarray(gb_1)),
            (float(v_port.detach()), ta.grad[0].numpy(),
             tb.grad[0].numpy())]
    for v, ga, gb in out:
        for wv, wa, wb in want:
            np.testing.assert_allclose(v, wv, rtol=1e-5)
            np.testing.assert_allclose(ga, wa, rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-6)
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_a_failing_rank_fails_the_launch(tmp_path):
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        _launch(tmp_path, fail_on_rank_one)


def test_a_collective_one_rank_never_joins_fails_at_the_timeout(tmp_path):
    """The group's short timeout, not the launch's deadline, ends the
    wait: rank 1 fails while rank 0 still sleeps."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        _launch(tmp_path, stall, 60, 3, deadline=120)


def test_a_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: a CUDA mesh is legal here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh("cuda", rank=0, world_size=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(rank=0, world_size=1)
