"""The reference's ``.pth`` layout imported by the port
(apr_torch/import_checkpoint.py) against the reference's own tool
(tools/import_torch_checkpoint.py) and apr_tpu's forward.

State dicts in the reference's layout are built here.  Each goes through
the tool plus the flax forward, and through the port's import plus the
port's forward.  Tolerances: the float32 encoder features within 1e-4 of
their unit norm (as tests/test_torch_resunet.py), the KPFCNN's outputs
within 1e-4 (as tests/test_torch_kpfcnn.py); imported generator trees
equal the tool's leaf for leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_torch.config import APRConfig
from apr_torch.import_checkpoint import load_reference_checkpoint_, \
    module_tree
from apr_torch.models import sparse
from apr_torch.ops.voxelize import voxelize_lean
from test_torch_resunet import _to_ref_pyramid
from tools.import_torch_checkpoint import import_generative_mlp, \
    import_generative_mlp_predator, import_kpfcnn, import_resunet

CAPS = (512, 256, 128, 64)
CHANNELS, TR = (32, 64, 128, 256), (32, 64, 64, 128)     # ResUNetBN2
FCGF = dict(trainer="GenerativePairTrainer", model="ResUNetBN2",
            model_n_out=16, generator_model="GenerativeMLP_54",
            point_generation_ratio=2, compute_dtype="float32",
            capacities=CAPS)


def resunet_pth(k1, n_out=16, seed=0):
    """A ResUNetBN2 state_dict in ME's layout (sparse kernels [K, in,
    out], norms wrapping a BatchNorm as ``.bn``) at a sane scale."""
    rng = np.random.default_rng(seed)
    sd = {}

    def kernel(k, ci, co):
        bound = np.sqrt(3.0 / (k * ci))
        return torch.from_numpy(
            rng.uniform(-bound, bound, (k, ci, co)).astype(np.float32))

    def vec(c, lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32))

    def norm(name, c):
        sd[f"{name}.bn.weight"] = vec(c, 0.6, 1.4)
        sd[f"{name}.bn.bias"] = vec(c, -0.2, 0.2)
        sd[f"{name}.bn.running_mean"] = vec(c, -0.2, 0.2)
        sd[f"{name}.bn.running_var"] = vec(c, 0.5, 1.5)

    def block(name, c):
        sd[f"{name}.conv1.kernel"] = kernel(27, c, c)
        sd[f"{name}.conv1.bias"] = vec(c, -0.1, 0.1)
        sd[f"{name}.conv2.kernel"] = kernel(27, c, c)
        norm(f"{name}.norm1", c)
        norm(f"{name}.norm2", c)

    prev = 1
    for i, c in enumerate(CHANNELS, 1):
        sd[f"conv{i}.kernel"] = kernel(k1 if i == 1 else 27, prev, c)
        norm(f"norm{i}", c)
        block(f"block{i}", c)
        prev = c
    ins = {4: CHANNELS[3], 3: CHANNELS[2] + TR[3], 2: CHANNELS[1] + TR[2]}
    for i in (4, 3, 2):
        sd[f"conv{i}_tr.kernel"] = kernel(27, ins[i], TR[i - 1])
        norm(f"norm{i}_tr", TR[i - 1])
        block(f"block{i}_tr", TR[i - 1])
    sd["conv1_tr.kernel"] = kernel(1, CHANNELS[0] + TR[1], TR[0])[0]
    sd["final.kernel"] = kernel(1, TR[0], n_out)
    sd["final.bias"] = vec(n_out, -0.1, 0.1)
    return sd


def mlp_pth(module, seed=1):
    """The reference's GenerativeMLP Sequential (Linear, ReLU, BatchNorm1d
    per hidden layer; the last Linear, ReLU) with ``module``'s shapes."""
    rng = np.random.default_rng(seed)
    tree = module_tree(module)
    sd, i, n = {}, 0, sum(k.startswith("Dense_") for k in tree)
    for j in range(n):
        w = tree[f"Dense_{j}"]["kernel"]
        sd[f"mlp.{i}.weight"] = torch.from_numpy(
            rng.normal(0, 0.3, w.shape[::-1]).astype(np.float32))
        sd[f"mlp.{i}.bias"] = torch.from_numpy(
            rng.normal(0, 0.1, w.shape[1]).astype(np.float32))
        if f"MaskedBatchNorm_{j}" in tree:
            c = w.shape[1]
            for k, (lo, hi) in (("weight", (0.6, 1.4)), ("bias", (-.2, .2)),
                                ("running_mean", (-.2, .2)),
                                ("running_var", (0.5, 1.5))):
                sd[f"mlp.{i + 2}.{k}"] = torch.from_numpy(
                    rng.uniform(lo, hi, c).astype(np.float32))
        i += 3
    return sd


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-8, 8, (2, 1500, 3)).astype(np.float32)
    pts[..., 2] *= 0.3
    coords, keys, vmask, _ = voxelize_lean(torch.from_numpy(pts), 0.5,
                                           CAPS[0])
    out = {}
    for k1 in (3, 5):
        out[k1] = (sparse.build_pyramid_from_level(
            sparse.SparseLevel(coords, keys, vmask), CAPS, k1),
            vmask[..., None].float())
    return out


def _flax_norm_names(tree):
    """The tool names the U-Net's top-level norms as torch does; flax
    calls them MaskedBatchNorm_k in call order."""
    order = ["norm1", "norm2", "norm3", "norm4", "norm4_tr", "norm3_tr",
             "norm2_tr"]
    return {f"MaskedBatchNorm_{order.index(k)}" if k in order else k: v
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("k1,permuted", [(5, False), (3, True)])
def test_fcgf_import_matches_the_tool(batch, k1, permuted):
    """Encoder features: the tool's tree in apr_tpu's ResUNet2 against the
    port's import in its own; the generator trees leaf for leaf.  With
    ``--kernel_order`` a permutation of the 27 offsets (conv1 3^3)."""
    from apr_tpu.models import make_resunet as ref_make_resunet

    from apr_torch.training.trainer import FCGFTrainer

    pyr, feats = batch[k1]
    order = np.random.default_rng(4).permutation(27) if permuted else None
    cfg = APRConfig(conv1_kernel_size=k1, **FCGF)
    trainer = FCGFTrainer(cfg, device="cpu")
    sd = resunet_pth(125 if k1 == 5 else 27)
    gen_sd = mlp_pth(trainer.generator)
    load_reference_checkpoint_(
        trainer, {"epoch": 7, "encoder_state_dict": sd,
                  "generator_state_dict": gen_sd, "optimizer": {}}, order)

    params, stats = import_resunet(sd, order)
    ref = ref_make_resunet("ResUNetBN2", in_channels=1, out_channels=16,
                           normalize_feature=True, conv1_kernel_size=k1,
                           ones_input=True)
    ref_pyr, ref_feats = _to_ref_pyramid(pyr), jnp.asarray(feats.numpy())
    want = np.asarray(jax.jit(lambda v, f, p: ref.apply(
        v, f, p, train=False))({
            "params": _flax_norm_names(params),
            "batch_stats": _flax_norm_names(stats)}, ref_feats, ref_pyr))
    with torch.inference_mode():
        got = trainer.encoder(feats, pyr).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert float(np.abs(want).max()) > 0.1

    gp, gs = import_generative_mlp(gen_sd)
    tool = dict(_leaves(gp))
    tool.update(_leaves(gs))
    ours = dict(_leaves(module_tree(trainer.generator)))
    assert tool.keys() == ours.keys()
    for k in tool:
        np.testing.assert_array_equal(ours[k], tool[k], err_msg=k)


def test_encoder_only_checkpoint(batch):
    """A checkpoint without a generator loads the encoder alone."""
    from apr_torch.training.trainer import FCGFTrainer

    trainer = FCGFTrainer(APRConfig(conv1_kernel_size=5, **FCGF),
                          device="cpu")
    before = {k: v.clone() for k, v in trainer.generator.state_dict().items()}
    sd = resunet_pth(125, seed=3)
    load_reference_checkpoint_(trainer, {"state_dict": sd})
    assert torch.equal(trainer.encoder.conv2.kernel, sd["conv2.kernel"])
    for k, v in trainer.generator.state_dict().items():
        assert torch.equal(v, before[k])
    with pytest.raises(KeyError):
        load_reference_checkpoint_(trainer, {"state_dict": {
            k: v for k, v in sd.items() if k != "final.bias"}})


def _torch_layout_kpfcnn(model):
    """The reference Predator KPFCNN's state_dict with the tensors of the
    flax tree ``model`` (the inverse of the tool's mapping)."""
    from tools.import_torch_checkpoint import KPFCNN_DECODER_MAP, \
        KPFCNN_ENCODER_MAP

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    sd = {}
    for ti, name in KPFCNN_ENCODER_MAP:
        blk, pre = model["encoder"][name], f"encoder_blocks.{ti}"
        if "conv" in blk:
            sd[f"{pre}.KPConv.weights"] = t(blk["conv"]["weights"])
            sd[f"{pre}.KPConv.kernel_points"] = t(
                blk["conv"]["kernel_points"])
        for unary in ("unary1", "unary2", "unary_shortcut"):
            if unary in blk:
                sd[f"{pre}.{unary}.mlp.weight"] = t(
                    blk[unary]["Dense_0"]["kernel"].T)
    for name in ("bottle", "proj_gnn", "proj_score"):
        sd[f"{name}.weight"] = t(model[name]["kernel"].T[..., None])
        sd[f"{name}.bias"] = t(model[name]["bias"])
    for name, d in model["gnn"].items():
        pre = f"gnn.layers.{name.rsplit('_', 1)[1]}"
        if name.startswith("self"):
            for conv in ("conv1", "conv2", "conv3"):
                sd[f"{pre}.{conv}.weight"] = t(
                    d[conv]["kernel"].T[..., None, None])
            continue
        for key, sub in ([(f"attn.proj.{j}", n) for j, n in
                          enumerate("qkv")] + [("attn.merge", "merge"),
                                               ("mlp.0", "mlp1"),
                                               ("mlp.3", "mlp2")]):
            sd[f"{pre}.{key}.weight"] = t(d[sub]["kernel"].T[..., None])
            sd[f"{pre}.{key}.bias"] = t(d[sub]["bias"])
    sd["epsilon"] = t(np.reshape(model["epsilon"], (1,)))
    for ti, name in KPFCNN_DECODER_MAP:
        sd[f"decoder_blocks.{ti}.mlp.weight"] = t(
            model["decoder"][name]["Dense_0"]["kernel"].T)
    sd["decoder_blocks.5.mlp.weight"] = t(
        model["decoder"]["last_unary"]["kernel"].T)
    return sd


def _torch_layout_predator_mlp(gen, stats):
    sd = {}
    for k, v in gen.items():
        i = int(k.split("_")[-1])
        if k.startswith("Dense_"):
            sd[f"list_modules.{i}.0.weight"] = torch.from_numpy(
                np.asarray(v["kernel"]).T.copy())
            sd[f"list_modules.{i}.0.bias"] = torch.from_numpy(
                np.array(v["bias"]))
        else:
            for name, src in (("weight", v["scale"]), ("bias", v["bias"]),
                              ("running_mean", stats[k]["mean"]),
                              ("running_var", stats[k]["var"])):
                sd[f"list_modules.{i}.2.{name}"] = torch.from_numpy(
                    np.array(src))
    return sd


def test_predator_import_matches_the_tool():
    """KPFCNN with its GCN: the tool's import_kpfcnn over apr_tpu's init
    tree and the flax forward, against the port's import over its own
    modules and its forward; the Predator MLP leaf for leaf."""
    from apr_tpu.config import APRConfig as RefConfig
    from apr_tpu.data.synthetic import synthetic_pair
    from apr_tpu.eval.predator_tester import PredatorTester as RefTester
    from apr_tpu.training.predator import PredatorTrainer as RefTrainer

    from apr_torch.eval.predator_tester import PredatorTester
    from apr_torch.training.predator import PredatorTrainer
    from test_torch_kpconv import _randomize
    from test_torch_kpfcnn import FIELDS

    pair = synthetic_pair(7, n_points=2500, apc_points=4, distance=6.0,
                          extent=30.0)
    ref_trainer = RefTrainer(RefConfig(trainer="PredatorTrainer", **FIELDS))
    ref_tester = RefTester(ref_trainer.config, ref_trainer, None)
    ref_batch = ref_tester._pair_to_batch(pair)
    state = ref_trainer.init_state(jax.random.PRNGKey(0), ref_batch)
    init = jax.device_get(state.params)
    drawn = _randomize({"params": init["model"]}, 11)
    gen_params = _randomize({"params": init["generator"]}, 12)
    gen_stats = jax.device_get(state.batch_stats)["generator"]
    sd = _torch_layout_kpfcnn(drawn)
    gen_sd = _torch_layout_predator_mlp(gen_params, gen_stats)

    tool = import_kpfcnn(sd, init["model"])
    want = jax.jit(ref_trainer.model.apply)({"params": tool},
                                            ref_batch.pyr0, ref_batch.pyr1)
    cfg = APRConfig(trainer="PredatorTrainer", **FIELDS)
    trainer = PredatorTrainer(cfg, device="cpu")
    load_reference_checkpoint_(trainer, {"state_dict": sd,
                                         "generator_state_dict": gen_sd})
    tester = PredatorTester(cfg, trainer, device="cpu")
    got = tester.forward(tester._pair_to_batch(pair))
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    assert float(np.asarray(want.overlap0).std()) > 1e-3

    gp, gs = import_generative_mlp_predator(gen_sd)
    tool_gen = dict(_leaves(gp))
    tool_gen.update(_leaves(gs))
    ours = dict(_leaves(module_tree(trainer.generator)))
    assert tool_gen.keys() == ours.keys()
    for k in tool_gen:
        np.testing.assert_array_equal(ours[k], tool_gen[k], err_msg=k)


def test_cli_writes_a_run_the_eval_scripts_read(tmp_path):
    """``python -m apr_torch.import_checkpoint`` writes config.json and a
    checkpoint whose weights are the imported ones."""
    from apr_torch.import_checkpoint import main
    from apr_torch.training.checkpoints import CheckpointManager
    from apr_torch.training.trainer import FCGFTrainer

    cfg = APRConfig(conv1_kernel_size=5, **FCGF)
    cfg.save_json(str(tmp_path / "config.json"))
    trainer = FCGFTrainer(cfg, device="cpu")
    sd = resunet_pth(125, seed=5)
    torch.save({"epoch": 3, "state_dict": sd,
                "generator_state_dict": mlp_pth(trainer.generator)},
               tmp_path / "ckpt.pth")
    out = tmp_path / "imported"
    main(["--pth", str(tmp_path / "ckpt.pth"), "--config",
          str(tmp_path / "config.json"), "--out_dir", str(out),
          "--device", "cpu"])
    _, meta = CheckpointManager(str(out)).restore_weights_only(trainer)
    assert meta["epoch"] == 3
    assert APRConfig.load_json(str(out / "config.json")).model == \
        "ResUNetBN2"
    assert torch.equal(trainer.encoder.block3.conv1.kernel,
                       sd["block3.conv1.kernel"])
