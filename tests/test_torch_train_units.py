"""Units of the FCGF-APR training slice of apr_torch against apr_tpu:
GT correspondences, the scatter-free conv backward, train-mode norms, the
generative MLP, the NPR and hardest-contrastive losses, the optimizers and
the robust pose fit, on the same numpy inputs at a small size.

Tolerances: integer and selection work exactly; one layer or loss within
1e-5 relative (float32 sums in another order); the robust pose within
1e-4, its 20 IRLS solves amplify rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.training import get_trainer
from apr_torch.bridge import mlp_state_dict
from apr_torch.config import APRConfig
from apr_torch.training.trainer import FCGFTrainer
from test_torch_train import FIELDS, TOL, _close, _randomize, _raw, \
    _replay, _scores


@pytest.fixture(scope="module")
def run():
    """The port's batch of the train-step tests' pairs (the train-step tests
    hold it equal to the reference's)."""
    cfg = APRConfig(**FIELDS)
    return dict(cfg=cfg, batch=FCGFTrainer(cfg, device="cpu").build_batch(
        _raw(cfg)))

def test_gt_correspondences_match_and_cap_above_one_raises(rng):
    """Cap 1 matches the reference; cap 2, which raised until the radius
    search was ported, no longer raises and matches it too."""
    from apr_tpu.registration.matching import gt_correspondences as ref_gt
    from apr_torch.registration.matching import gt_correspondences

    x0 = rng.uniform(-6, 6, (2, 400, 3)).astype(np.float32)
    t = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    t[:, :3, 3] = [[0.2, -0.1, 0.0], [1.0, 0.5, 0.1]]
    x1 = (x0 @ t[:, :3, :3].transpose(0, 2, 1) + t[:, None, :3, 3]
          + rng.normal(0, 0.2, x0.shape).astype(np.float32))
    m0, m1 = rng.random((2, 400)) > 0.1, rng.random((2, 400)) > 0.2
    got = gt_correspondences(*map(torch.from_numpy, (x0, x1, t)), 0.45, 1,
                             torch.from_numpy(m0), torch.from_numpy(m1))
    for i in range(2):
        want = jax.jit(lambda a, c, tr, ma, mc: ref_gt(a, c, tr, 0.45, 1,
                                                       ma, mc))(
            *map(jnp.asarray, (x0[i], x1[i], t[i], m0[i], m1[i])))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert got.mask.float().mean() > 0.3
    got2 = gt_correspondences(*map(torch.from_numpy, (x0, x1, t)), 0.45, 2,
                              torch.from_numpy(m0), torch.from_numpy(m1))
    for i in range(2):
        want = jax.jit(lambda a, c, tr, ma, mc: ref_gt(a, c, tr, 0.45, 2,
                                                       ma, mc))(
            *map(jnp.asarray, (x0[i], x1[i], t[i], m0[i], m1[i])))
        for g, w in zip(got2, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert got2.mask.sum() > got.mask.sum()


# --- layers --------------------------------------------------------------

@pytest.mark.parametrize("reverse_k,maps,dtype,t_form", [
    (True, "same", None, "flat"), (False, "down", None, "flat"),
    (False, "up", None, "flat"), (True, "same", "bfloat16", "flat"),
    (False, "down", "bfloat16", "flat"), (True, "same", None, "none"),
    (False, "down", None, "cloud"), (False, "up", "bfloat16", "cloud"),
])
def test_sparse_conv_adjoint_grads_match(run, reverse_k, maps, dtype,
                                         t_form):
    """The scatter-free backward against jax.grad of the reference's custom
    VJP, and (float32) against autograd of the plain gather conv.  The port
    takes the transpose table per cloud ("cloud"), folded beforehand as
    one cloud ("flat"), or as None for the same-level table ("none")."""
    from apr_tpu.models.sparse import sparse_conv_adjoint as ref_adjoint
    from apr_torch.models.sparse import fold_table, sparse_conv_adjoint, \
        sparse_conv_apply

    pyr = run["batch"].pyramid0
    masks = [lv.mask for lv in pyr.levels]
    if maps == "same":
        table, table_t, m_out, m_in = (pyr.same_maps[1], pyr.same_maps[1],
                                       masks[1], masks[1])
    elif maps == "down":
        table, table_t, m_out, m_in = (pyr.down_maps[0], pyr.up_maps[0],
                                       masks[1], masks[0])
    else:
        table, table_t, m_out, m_in = (pyr.up_maps[0], pyr.down_maps[0],
                                       masks[0], masks[1])
    b, n_out, k = table.shape
    n_in = table_t.shape[1]
    tab, tab_t = fold_table(table, n_in), fold_table(table_t, n_out)
    port_t = {"flat": tab_t[None], "cloud": table_t, "none": None}[t_form]
    rng = np.random.default_rng(5)
    f = rng.normal(size=(b * n_in, 6)).astype(np.float32)
    w = rng.normal(size=(k, 6, 5)).astype(np.float32)
    g = rng.normal(size=(b * n_out, 5)).astype(np.float32)
    cd = None if dtype is None else getattr(torch, dtype)

    def port(fn):
        tf, tw = (torch.from_numpy(x).requires_grad_() for x in (f, w))
        out = fn(tf, tw)
        (out * torch.from_numpy(g)).sum().backward()
        return out.detach().numpy(), tf.grad.numpy(), tw.grad.numpy()

    got = port(lambda tf, tw: sparse_conv_adjoint(
        tf, tab, port_t, tw, m_out.reshape(-1), m_in.reshape(-1),
        reverse_k, cd))
    ref_out, vjp = jax.vjp(lambda x, y: ref_adjoint(
        x, jnp.asarray(tab.numpy()), jnp.asarray(tab_t.numpy()), y,
        jnp.asarray(m_out.reshape(-1).numpy()),
        jnp.asarray(m_in.reshape(-1).numpy()), reverse_k, dtype),
        jnp.asarray(f), jnp.asarray(w))
    want = (np.asarray(ref_out),) + tuple(map(np.asarray,
                                              vjp(jnp.asarray(g))))
    for a, c in zip(got, want):
        _close(a, c, rtol=TOL, floor=TOL)
    if dtype is None:
        plain = port(lambda tf, tw: sparse_conv_apply(
            tf, tab, tw, m_out.reshape(-1)))
        # the plain autograd leaves the rows that are masked out of the
        # input untouched: compare valid input rows only
        valid = m_in.reshape(-1).numpy()
        _close(got[1][valid], plain[1][valid], rtol=TOL, floor=TOL)
        _close(got[2], plain[2], rtol=TOL, floor=TOL)


def _adjoint_case(run, maps):
    """(folded table, folded transpose table, out mask, in mask, reverse)
    of a same-level, a stride-2 down or a transposed conv of the batch's
    first pyramid."""
    from apr_torch.models.sparse import fold_table

    pyr = run["batch"].pyramid0
    masks = [lv.mask.reshape(-1) for lv in pyr.levels]
    table, table_t, m_out, m_in, reverse = {
        "same": (pyr.same_maps[1], pyr.same_maps[1], masks[1], masks[1],
                 True),
        "down": (pyr.down_maps[0], pyr.up_maps[0], masks[1], masks[0],
                 False),
        "up": (pyr.up_maps[0], pyr.down_maps[0], masks[0], masks[1],
               False)}[maps]
    n_out, n_in = table.shape[1], table_t.shape[1]
    return (fold_table(table, n_in), fold_table(table_t, n_out), m_out,
            m_in, reverse)


def _adjoint_grads(run, maps, cd, f, w, g):
    """(d feats, d W) of the port's sparse_conv_adjoint."""
    from apr_torch.models.sparse import sparse_conv_adjoint

    tab, tab_t, m_out, m_in, reverse = _adjoint_case(run, maps)
    tf, tw = (torch.from_numpy(x).requires_grad_() for x in (f, w))
    out = sparse_conv_adjoint(tf, tab, tab_t[None], tw, m_out, m_in,
                              reverse, cd)
    return torch.autograd.grad(out, (tf, tw), torch.from_numpy(g))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("maps", ["same", "down", "up"])
def test_sparse_conv_adjoint_backward_is_the_materialised_chain(run, maps,
                                                                dtype):
    """The backward widens its operands before it gathers them; that is
    the same float32 matrices for the same matmuls as gathering the rows
    in the compute dtype and copying them to float32, so the gradients
    equal that chain's bit for bit (a sum in another order would not)."""
    tab, tab_t, m_out, m_in, reverse = _adjoint_case(run, maps)
    rng = np.random.default_rng(11)
    n_in, n_out = m_in.shape[0], m_out.shape[0]
    f = rng.normal(size=(n_in, 24)).astype(np.float32)
    w = rng.normal(size=(27, 24, 16)).astype(np.float32)
    g = rng.normal(size=(n_out, 16)).astype(np.float32)
    cd = None if dtype is None else getattr(torch, dtype)
    got_df, got_dw = _adjoint_grads(run, maps, cd, f, w, g)

    def low(x):
        x = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        return x.to(cd) if cd is not None else x

    def gathered(src, table):               # rows in the compute dtype
        padded = torch.cat([src, src.new_zeros((1, src.shape[1]))])
        return padded[table.clamp(max=src.shape[0]).long()].reshape(
            table.shape[0], -1)

    gm = low(torch.where(m_out[:, None], torch.from_numpy(g), 0.0))
    w_t = torch.from_numpy(w).transpose(1, 2)
    w_t = w_t.flip(0) if reverse else w_t
    want_df = torch.where(m_in[:, None], torch.matmul(
        gathered(gm, tab_t).float(), low(w_t).reshape(-1, 24).float()), 0.0)
    want_dw = torch.matmul(gathered(low(f), tab).float().T,
                           gm.float()).reshape(27, 24, 16)
    assert torch.equal(got_df, want_df) and torch.equal(got_dw, want_dw)
    assert bool(got_df[~m_in].eq(0).all()) and bool(got_df[m_in].ne(0).any())


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("maps", ["same", "down", "up"])
def test_sparse_conv_adjoint_exact_on_integer_inputs(run, maps, dtype):
    """On small integers every product and every float32 sum is exact,
    whatever its order: the port's gradients then equal the reference's
    custom VJP bit for bit, so a dropped, doubled or misplaced product (a
    wrong tap, sentinel or mask) shows with no tolerance."""
    from apr_tpu.models.sparse import sparse_conv_adjoint as ref_adjoint

    tab, tab_t, m_out, m_in, reverse = _adjoint_case(run, maps)
    rng = np.random.default_rng(12)
    n_in, n_out = m_in.shape[0], m_out.shape[0]
    f, w, g = (rng.integers(-4, 5, shape).astype(np.float32) for shape in
               ((n_in, 8), (27, 8, 16), (n_out, 16)))
    cd = None if dtype is None else getattr(torch, dtype)
    got = _adjoint_grads(run, maps, cd, f, w, g)
    J = jnp.asarray
    _, vjp = jax.vjp(lambda x, y: ref_adjoint(
        x, J(tab.numpy()), J(tab_t.numpy()), y, J(m_out.numpy()),
        J(m_in.numpy()), reverse, dtype), J(f), J(w))
    for a, want in zip(got, vjp(J(g))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(want))
    assert float(got[1].abs().sum()) > 0


def test_kernel_map_up_is_the_oracle_of_the_up_maps(run):
    from apr_torch.models.sparse import kernel_map_up

    pyr = run["batch"].pyramid1
    for l in range(3):
        slow = kernel_map_up(pyr.levels[l], pyr.levels[l + 1], 3)
        assert torch.equal(slow, pyr.up_maps[l])


@pytest.mark.parametrize("groups", [1, 2])
def test_batch_norm_train_mode_matches(rng, groups):
    from apr_tpu.models.layers import MaskedBatchNorm as RefBN
    from apr_torch.models.layers import MaskedBatchNorm

    x = rng.normal(1.0, 2.0, (4, 60, 5)).astype(np.float32)
    m = rng.random((4, 60)) > 0.3
    m[1] = False                  # an empty cloud in group 1
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
                    "bias": rng.normal(size=5).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=5).astype(np.float32),
                         "var": rng.uniform(0.5, 2, 5).astype(np.float32)}}
    want, upd = RefBN(momentum=0.05, stats_groups=groups).apply(
        v, jnp.asarray(x), jnp.asarray(m), use_running_average=False,
        mutable=["batch_stats"])
    bn = MaskedBatchNorm(5, momentum=0.05).train()
    bn.load_state_dict({k: torch.from_numpy(a) for sub in v.values()
                        for k, a in sub.items()})
    tx = torch.from_numpy(x).requires_grad_()
    got = bn(tx, torch.from_numpy(m), stats_groups=groups)
    _close(got.detach(), want, rtol=TOL, floor=TOL)
    for name in ("mean", "var"):
        _close(getattr(bn, name), upd["batch_stats"][name], rtol=TOL,
               floor=TOL, what=name)
    # the running stats are buffers, outside autograd
    got.sum().backward()
    assert not bn.mean.requires_grad and tx.grad is not None


def test_generative_mlp_train_and_eval_match(rng):
    from apr_tpu.models.mlp import make_generative_mlp as ref_mlp
    from apr_torch.models.mlp import make_generative_mlp

    x = rng.normal(size=(2, 40, 16)).astype(np.float32)
    m = rng.random((2, 40)) > 0.25
    ref = ref_mlp("GenerativeMLP_54", out_points=3, bn_momentum=0.05)
    shapes = jax.eval_shape(lambda: ref.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(m)))
    v = _randomize(dict(shapes), 3)
    mlp = make_generative_mlp("GenerativeMLP_54", out_points=3,
                              in_channels=16, bn_momentum=0.05,
                              device="cpu")
    mlp.load_state_dict(mlp_state_dict(v["params"], v["batch_stats"]),
                        strict=True)
    with torch.no_grad():
        _close(mlp(torch.from_numpy(x), torch.from_numpy(m)),
               ref.apply(v, jnp.asarray(x), jnp.asarray(m)), rtol=TOL,
               floor=TOL)
        want, upd = ref.apply(v, jnp.asarray(x), jnp.asarray(m), train=True,
                              mutable=["batch_stats"])
        got = mlp.train()(torch.from_numpy(x), torch.from_numpy(m))
    _close(got, want, rtol=TOL, floor=TOL)
    assert got.shape == (2, 40, 9) and (got[~torch.from_numpy(m)] == 0).all()
    state = mlp_state_dict(v["params"], upd["batch_stats"])
    for name, buf in mlp.named_buffers():
        _close(buf, state[name], rtol=TOL, floor=TOL, what=name)


# --- losses --------------------------------------------------------------

@pytest.mark.parametrize("reg_type", ["L2", "RepelL2", "RepelL1"])
def test_offset_regularization_matches(rng, reg_type):
    from apr_tpu.losses.generative import offset_regularization as ref_reg
    from apr_torch.losses.generative import offset_regularization

    o = rng.normal(0, 0.5, (2, 30, 3, 3)).astype(np.float32)
    m = rng.random((2, 30)) > 0.3
    got = offset_regularization(torch.from_numpy(o), torch.from_numpy(m),
                                reg_type, alpha=0.7)
    for i in range(2):
        _close(got[i], ref_reg(jnp.asarray(o[i]), jnp.asarray(m[i]),
                               reg_type, 0.7), rtol=TOL, floor=0)


@pytest.mark.parametrize("mode", ["pallas", "exact", "window"])
def test_npr_reconstruction_matches(run, mode):
    """Value, parts and the gradient with respect to the MLP output, per
    cloud, on the batch's anchors and APC targets."""
    from apr_tpu.losses.generative import npr_reconstruction as ref_npr
    from apr_torch.losses.generative import npr_reconstruction

    batch, vs = run["batch"], run["cfg"].voxel_size
    pyr = batch.pyramid0
    mask = pyr.levels[0].mask
    anchors = pyr.levels[0].coords.float() * vs
    rng = np.random.default_rng(7)
    out = np.abs(rng.normal(0, 0.6, mask.shape + (6,))).astype(np.float32)
    kw = dict(voxel_size=vs, reg_type="RepelL2", reg_strength=0.01,
              alpha=1.0, chamfer_mode=mode, chamfer_cell_size=4 * vs)
    t_out = torch.from_numpy(out).requires_grad_()
    totals, cds, regs, clamps = npr_reconstruction(
        t_out, anchors, batch.apc0, mask, batch.apc0_mask, **kw)
    (totals * torch.tensor([1.0, 3.0])).sum().backward()
    for i, w in enumerate((1.0, 3.0)):
        def ref(o):
            res = ref_npr(o, jnp.asarray(anchors[i].numpy()),
                          jnp.asarray(batch.apc0[i].numpy()),
                          jnp.asarray(mask[i].numpy()),
                          jnp.asarray(batch.apc0_mask[i].numpy()), **kw)
            return w * res[0], res

        (_, want), grad = jax.jit(jax.value_and_grad(ref, has_aux=True))(
            jnp.asarray(out[i]))
        for got, ref_v in zip((totals, cds, regs, clamps), want):
            _close(got[i].detach(), ref_v, rtol=TOL, floor=0)
        _close(t_out.grad[i], grad, rtol=TOL, floor=TOL)
    assert float(cds[0].detach()) > 0


def test_hardest_contrastive_loss_with_replayed_draws(run, monkeypatch):
    from apr_tpu.losses.contrastive import hardest_contrastive_loss as ref_hc
    from apr_torch.losses.contrastive import hardest_contrastive_loss

    batch = run["batch"]
    b, n = batch.pos_src.shape
    rng = np.random.default_rng(9)
    f0, f1 = (rng.normal(size=(b * n, 8)).astype(np.float32) * 0.4
              for _ in range(2))
    offs = (np.arange(b) * n)[:, None]
    src = (batch.pos_src.numpy() + offs).reshape(-1)
    tgt = (batch.pos_tgt.numpy() + offs).reshape(-1)
    pm = batch.pos_mask.numpy().reshape(-1)
    m0 = batch.pyramid0.levels[0].mask.numpy().reshape(-1)
    m1 = batch.pyramid1.levels[0].mask.numpy().reshape(-1)
    # the hardest negative of some positives is their own GT partner, which
    # the rank-compressed exclusion must drop
    f1[tgt[pm][:20]] = f0[src[pm][:20]] + 0.01
    key = jax.random.PRNGKey(4)
    kw = dict(num_pos=128, num_hn_samples=64, pos_thresh=0.1,
              neg_thresh=1.4)
    def ref(a, c):
        return ref_hc(key, a, c, *map(jnp.asarray, (src, tgt, pm, m0, m1)),
                      **kw)

    pos, neg = ref(jnp.asarray(f0), jnp.asarray(f1))
    g0, g1 = jax.grad(lambda a, c: sum(ref(a, c)), argnums=(0, 1))(
        jnp.asarray(f0), jnp.asarray(f1))
    _replay(monkeypatch, _scores(key, (pm.size, m0.size, m1.size)))
    t0, t1 = (torch.from_numpy(x).requires_grad_() for x in (f0, f1))
    got = hardest_contrastive_loss(
        None, t0, t1, *map(torch.from_numpy, (src, tgt, pm, m0, m1)), **kw)
    sum(got).backward()
    _close(got[0].detach(), pos, rtol=TOL, floor=0)
    _close(got[1].detach(), neg, rtol=TOL, floor=0)
    _close(t0.grad, g0, rtol=TOL, floor=TOL)
    _close(t1.grad, g1, rtol=TOL, floor=TOL)
    assert float(got[1].detach()) > 0


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_optimizer_matches_optax_chain(rng, name):
    """Coupled weight decay before the inner optimizer, three steps."""
    import optax

    cfg = RefConfig(**{**FIELDS, "optimizer": name, "lr": 0.05})
    tx = get_trainer(cfg).tx
    p0 = rng.normal(size=(7, 3)).astype(np.float32)
    grads = [rng.normal(size=(7, 3)).astype(np.float32) for _ in range(3)]
    params, opt = {"w": jnp.asarray(p0)}, None
    opt = tx.init(params)
    for g in grads:
        upd, opt = tx.update({"w": jnp.asarray(g)}, opt, params)
        params = optax.apply_updates(params, upd)
    trainer = FCGFTrainer(APRConfig(**{**FIELDS, "optimizer": name,
                                       "lr": 0.05}), device="cpu")
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    trainer.optimizer.param_groups[0]["params"] = [w]
    for g in grads:
        w.grad = torch.from_numpy(g)
        trainer.optimizer.step()
    _close(w.detach(), params["w"], rtol=TOL, floor=TOL)


def test_robust_pose_and_hit_ratio_match(rng):
    from apr_tpu.geometry.robust import est_rigid_robust as ref_robust
    from apr_tpu.registration.metrics import hit_ratio as ref_hit
    from apr_torch.geometry.robust import est_rigid_robust
    from apr_torch.registration.metrics import hit_ratio

    src = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
    yaw = 0.2
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                 [0, 0, 1]]
    t[:3, 3] = [1.0, -0.5, 0.2]
    tgt = (src @ t[:3, :3].T + t[:3, 3]
           + rng.normal(0, 0.05, src.shape)).astype(np.float32)
    tgt[:60] = rng.uniform(-20, 20, (60, 3))
    w = (rng.random(300) > 0.1).astype(np.float32)
    got = est_rigid_robust(torch.from_numpy(src), torch.from_numpy(tgt),
                           torch.from_numpy(w))
    want = jax.jit(ref_robust)(jnp.asarray(src), jnp.asarray(tgt),
                               jnp.asarray(w))
    _close(got, want, rtol=1e-4, floor=1e-4)
    _close(got, t, rtol=0, floor=0.02)
    hr = hit_ratio(torch.from_numpy(src), torch.from_numpy(tgt),
                   torch.from_numpy(t), 0.3, torch.from_numpy(w > 0))
    _close(hr, ref_hit(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(t),
                       0.3, jnp.asarray(w > 0)), rtol=TOL, floor=0)
