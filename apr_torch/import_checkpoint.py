"""Import the reference's ``.pth`` checkpoints into the port (the
counterpart of ``tools/import_torch_checkpoint.py``).

The reference saves ``{epoch, encoder_state_dict (or state_dict),
generator_state_dict, optimizer, ...}`` (FCGF_APR/lib/complement_trainer.py:
249-263; Predator_APR/lib/trainer.py:70-85).  The functions below map those
tensors into the flax-shaped numpy trees of ``tools/import_torch_checkpoint.
py`` (the same mappings: torch Linear [out, in] -> Dense [in, out], ME
sparse kernels [K, in, out] kept, with an optional ``kernel_order``
permutation of the K offsets; BatchNorm weight / bias / running stats ->
scale / bias / mean / var), and :mod:`apr_torch.bridge` loads those trees
strictly into a trainer's modules, so the names are mapped in one place.

- FCGF: ResUNet2 (:func:`import_resunet`) and GenerativeMLP
  (:func:`import_generative_mlp`); a symmetric trainer's generator is a
  second ResUNet;
- Predator: KPFCNN with its GCN (:func:`import_kpfcnn`), the symmetric
  KPFCNNDecoder (:func:`import_kpfcnn_decoder`) and the Predator MLP
  (:func:`import_generative_mlp_predator`); the tree skeleton (the leaves
  the reference lacks: the identity affines of its affine-free instance
  norms, last_unary's zero bias) comes from the port's own modules.

    python -m apr_torch.import_checkpoint --pth checkpoint.pth \\
        --config run/config.json --out_dir imported [--kernel_order p.npy]

writes ``imported/config.json`` and a checkpoint that ``python -m
apr_torch.scripts.test_apr --save_dir imported`` evaluates.
"""

from __future__ import annotations

import argparse
import copy
import logging
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from apr_torch import bridge
from apr_torch.config import APRConfig

log = logging.getLogger(__name__)


def _t(x):
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                      else x)


def import_resunet(sd: Dict, kernel_order: Optional[np.ndarray] = None):
    """An FCGF ResUNet2 state_dict as (params, batch_stats) trees."""
    params: Dict = {}
    stats: Dict = {}

    def conv_kernel(name):
        w = _t(sd[f"{name}.kernel"])
        if w.ndim == 2:  # 1x1 convs are stored [in, out]
            return w
        return w if kernel_order is None else w[kernel_order]

    def norm(name):
        # a top-level norm wraps its BatchNorm as ``.bn`` or is one
        pre = f"{name}.bn" if f"{name}.bn.weight" in sd else name
        return ({"scale": _t(sd[f"{pre}.weight"]),
                 "bias": _t(sd[f"{pre}.bias"])},
                {"mean": _t(sd[f"{pre}.running_mean"]),
                 "var": _t(sd[f"{pre}.running_var"])})

    def block(name):
        blk = {"conv1": {"kernel": conv_kernel(f"{name}.conv1")},
               "conv2": {"kernel": conv_kernel(f"{name}.conv2")}}
        if f"{name}.conv1.bias" in sd:
            blk["conv1"]["bias"] = _t(sd[f"{name}.conv1.bias"])
        bstats = {}
        for j in range(2):
            blk[f"MaskedBatchNorm_{j}"], bstats[f"MaskedBatchNorm_{j}"] = \
                norm(f"{name}.norm{j + 1}.bn")
        return blk, bstats

    for name in ([f"{i}" for i in range(1, 5)]
                 + [f"{i}_tr" for i in range(4, 1, -1)]):
        params[f"conv{name}"] = {"kernel": conv_kernel(f"conv{name}")}
        params[f"norm{name}"], stats[f"norm{name}"] = norm(f"norm{name}")
        params[f"block{name}"], stats[f"block{name}"] = block(
            f"block{name}")
    # 1x1 fusion + final (ME stores [1, in, out] or [in, out])
    w = _t(sd["conv1_tr.kernel"])
    params["conv1_tr"] = {"kernel": w.reshape(w.shape[-2], w.shape[-1])}
    wf = _t(sd["final.kernel"])
    params["final"] = {"kernel": wf.reshape(wf.shape[-2], wf.shape[-1]),
                       "bias": _t(sd["final.bias"]).reshape(-1)}
    return params, stats


def import_generative_mlp(sd: Dict):
    """An FCGF GenerativeMLP state_dict (``mlp.<i>`` Linear / ReLU / BN
    Sequential) as (params, batch_stats) trees."""
    layers = {k.split(".")[1] for k in sd if k.startswith("mlp.")
              and k.endswith(".weight")}
    bns = sorted((i for i in layers if f"mlp.{i}.running_mean" in sd),
                 key=int)
    linears = sorted(layers - set(bns), key=int)
    params: Dict = {}
    stats: Dict = {}
    for i, lk in enumerate(linears):
        params[f"Dense_{i}"] = {"kernel": _t(sd[f"mlp.{lk}.weight"]).T,
                                "bias": _t(sd[f"mlp.{lk}.bias"])}
    for i, bk in enumerate(bns):
        params[f"MaskedBatchNorm_{i}"] = {"scale": _t(sd[f"mlp.{bk}.weight"]),
                                          "bias": _t(sd[f"mlp.{bk}.bias"])}
        stats[f"MaskedBatchNorm_{i}"] = {
            "mean": _t(sd[f"mlp.{bk}.running_mean"]),
            "var": _t(sd[f"mlp.{bk}.running_var"])}
    return params, stats


# --- Predator_APR: KPFCNN / KPFCNNDecoder / GenerativeMLP ---------------

def _linear_w(sd, key):
    return _t(sd[key]).T                      # Linear [out, in] -> [in, out]


def _conv1d_w(sd, key):
    return _t(sd[key])[..., 0].T              # Conv1d [out, in, 1] -> [in, out]


def _conv2d_w(sd, key):
    return _t(sd[key])[..., 0, 0].T           # Conv2d 1x1 -> [in, out]


# the reference's encoder_blocks index -> the KPEncoder block name, for the
# kitti / nuscenes / indoor architecture (simple, resnetb, then 3x
# [resnetb_strided, resnetb, resnetb])
KPFCNN_ENCODER_MAP = [
    ("0", "enc_simple"), ("1", "enc_l0_resnetb"), ("2", "enc_l0_strided"),
    ("3", "enc_l1_resnetb1"), ("4", "enc_l1_resnetb2"),
    ("5", "enc_l1_strided"), ("6", "enc_l2_resnetb1"),
    ("7", "enc_l2_resnetb2"), ("8", "enc_l2_strided"),
    ("9", "enc_l3_resnetb1"), ("10", "enc_l3_resnetb2"),
]
# decoder_blocks index -> the KPDecoder unary (upsample / unary / upsample /
# unary / upsample / last_unary: indices 1 and 3; 5 is last_unary)
KPFCNN_DECODER_MAP = [("1", "dec_unary2"), ("3", "dec_unary1")]


def _import_kp_block(sd, prefix, dst):
    """One SimpleBlock / ResnetBottleneckBlock worth of tensors."""
    if f"{prefix}.KPConv.weights" in sd:
        dst["conv"]["weights"] = _t(sd[f"{prefix}.KPConv.weights"])
        dst["conv"]["kernel_points"] = _t(sd[f"{prefix}.KPConv.kernel_points"])
    for unary in ("unary1", "unary2", "unary_shortcut"):
        key = f"{prefix}.{unary}.mlp.weight"
        if (key in sd) != (unary in dst):
            raise ValueError(f"{prefix}.{unary}: the checkpoint and the "
                             f"model disagree on the block's architecture")
        if key in sd:
            dst[unary]["Dense_0"]["kernel"] = _linear_w(sd, key)


def import_gcn(sd, dst, nets=("self", "cross", "self"), prefix="gnn"):
    """The reference's GCN (models/gcn.py:171-206) into ``dst``: bias-free
    1x1 Conv2d self-attention convs; cross-attention q / k / v / merge and
    the MLP as Conv1d with bias (the head split in torch's (dk, heads)
    channel order, as the port's CrossAttention keeps it)."""
    for i, kind in enumerate(nets):
        t = f"{prefix}.layers.{i}" if prefix else f"layers.{i}"
        d = dst[f"{kind}_{i}"]
        if kind == "self":
            for conv in ("conv1", "conv2", "conv3"):
                d[conv]["kernel"] = _conv2d_w(sd, f"{t}.{conv}.weight")
            continue
        for j, name in enumerate(("q", "k", "v")):
            d[name]["kernel"] = _conv1d_w(sd, f"{t}.attn.proj.{j}.weight")
            d[name]["bias"] = _t(sd[f"{t}.attn.proj.{j}.bias"])
        for name, key in (("merge", "attn.merge"), ("mlp1", "mlp.0"),
                          ("mlp2", "mlp.3")):
            d[name]["kernel"] = _conv1d_w(sd, f"{t}.{key}.weight")
            d[name]["bias"] = _t(sd[f"{t}.{key}.bias"])


def _import_kp_decoder(sd, dst):
    for ti, name in KPFCNN_DECODER_MAP:
        dst[name]["Dense_0"]["kernel"] = _linear_w(
            sd, f"decoder_blocks.{ti}.mlp.weight")
    dst["last_unary"]["kernel"] = _linear_w(sd, "decoder_blocks.5.mlp.weight")
    # the reference's LastUnaryBlock has no bias
    dst["last_unary"]["bias"] = np.zeros_like(dst["last_unary"]["bias"])


def import_kpfcnn(sd, params, nets=("self", "cross", "self")):
    """A copy of the KPFCNN tree ``params`` with the reference's state_dict
    mapped in; leaves the reference lacks keep their values."""
    params = copy.deepcopy(params)
    for ti, name in KPFCNN_ENCODER_MAP:
        _import_kp_block(sd, f"encoder_blocks.{ti}", params["encoder"][name])
    for name in ("bottle", "proj_gnn", "proj_score"):
        params[name]["kernel"] = _conv1d_w(sd, f"{name}.weight")
        params[name]["bias"] = _t(sd[f"{name}.bias"])
    import_gcn(sd, params["gnn"], nets=nets)
    params["epsilon"] = _t(sd["epsilon"]).reshape(())
    _import_kp_decoder(sd, params["decoder"])
    return params


def import_kpfcnn_decoder(sd, params):
    """The symmetric NPR KPFCNNDecoder (architectures.py:215-340): encoder
    and decoder blocks only."""
    params = copy.deepcopy(params)
    for ti, name in KPFCNN_ENCODER_MAP:
        _import_kp_block(sd, f"encoder_blocks.{ti}", params["encoder"][name])
    _import_kp_decoder(sd, params["decoder"])
    return params


def import_generative_mlp_predator(sd):
    """The Predator MLP (models/mlp.py:108-180): ``list_modules.{i}`` =
    Sequential(Linear, ReLU, BatchNorm1d) for every layer, the last
    included; (params, batch_stats) of GenerativeMLP(final_bn=True)."""
    params: Dict = {}
    stats: Dict = {}
    for i in sorted({int(k.split(".")[1]) for k in sd
                     if k.startswith("list_modules.")}):
        pre = f"list_modules.{i}"
        params[f"Dense_{i}"] = {"kernel": _linear_w(sd, f"{pre}.0.weight"),
                                "bias": _t(sd[f"{pre}.0.bias"])}
        if f"{pre}.2.weight" in sd:
            params[f"MaskedBatchNorm_{i}"] = {
                "scale": _t(sd[f"{pre}.2.weight"]),
                "bias": _t(sd[f"{pre}.2.bias"])}
            stats[f"MaskedBatchNorm_{i}"] = {
                "mean": _t(sd[f"{pre}.2.running_mean"]),
                "var": _t(sd[f"{pre}.2.running_var"])}
    return params, stats


def module_tree(module: torch.nn.Module) -> Dict:
    """``module``'s state as a nested dict of numpy arrays (the flax-shaped
    skeleton the Predator mappings fill)."""
    tree: Dict = {}
    for name, value in module.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value.detach().cpu().numpy()
    return tree


def _sub_dict(ckpt, *keys):
    for k in keys:
        if ckpt.get(k) is not None:
            return {n: _t(v) for n, v in ckpt[k].items()}
    return None


def load_reference_checkpoint_(trainer, ckpt, kernel_order=None):
    """Load a reference checkpoint dict (``torch.load`` of its ``.pth``)
    into ``trainer`` (an FCGF or Predator trainer) in place, strictly.  A
    checkpoint without a generator loads the encoder only."""
    enc = _sub_dict(ckpt, "encoder_state_dict", "state_dict")
    gen = _sub_dict(ckpt, "generator_state_dict",
                    "generative_model_state_dict")
    if any(k.startswith("encoder_blocks.") for k in enc):
        model = import_kpfcnn(enc, module_tree(trainer.model),
                              trainer.config.nets)
        if gen is None:
            trainer.model.load_state_dict(bridge.kpfcnn_state_dict(model),
                                          strict=True)
            return trainer
        if trainer.symmetric:
            gp, gs = import_kpfcnn_decoder(
                gen, module_tree(trainer.generator)), {}
        else:
            gp, gs = import_generative_mlp_predator(gen)
        return bridge.load_flax_predator_(
            trainer, {"model": model, "generator": gp},
            {"model": {}, "generator": gs})
    ep, es = import_resunet(enc, kernel_order)
    if gen is None:
        bridge.load_flax_resunet_(trainer.encoder, ep, es)
        return trainer
    gp, gs = (import_resunet(gen, kernel_order) if trainer.symmetric
              else import_generative_mlp(gen))
    return bridge.load_flax_train_state_(
        trainer, {"encoder": ep, "generator": gp},
        {"encoder": es, "generator": gs})


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pth", required=True, help="the reference checkpoint")
    ap.add_argument("--config", required=True,
                    help="config.json or YAML of the model to build")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--kernel_order", default=None,
                    help=".npy permutation of the sparse kernel offsets")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    from apr_torch.training.checkpoints import CheckpointManager

    cfg = (APRConfig.load_json(args.config) if args.config.endswith(".json")
           else APRConfig.from_yaml(args.config))
    if cfg.trainer == "PredatorTrainer":
        from apr_torch.training.predator import PredatorTrainer

        trainer = PredatorTrainer(cfg, device=args.device, seed=cfg.seed)
    else:
        from apr_torch.training.trainer import get_trainer

        trainer = get_trainer(cfg, device=args.device, seed=cfg.seed)
    ckpt = torch.load(args.pth, map_location="cpu", weights_only=False)
    order = None if args.kernel_order is None else np.load(args.kernel_order)
    load_reference_checkpoint_(trainer, ckpt, order)
    epoch = int(ckpt.get("epoch") or 0)
    os.makedirs(args.out_dir, exist_ok=True)
    cfg.replace(out_dir=args.out_dir).save_json(
        os.path.join(args.out_dir, "config.json"))
    CheckpointManager(args.out_dir).save(epoch, trainer)
    log.info("imported %s (epoch %d) into %s", args.pth, epoch, args.out_dir)


if __name__ == "__main__":
    main(sys.argv[1:])
