# Frozen copy of apr_torch/losses/circle.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""MetricLoss of the Predator path: circle loss, overlap BCE and saliency
BCE (port of ``apr_tpu/losses/circle.py``), over masked fixed-capacity
buffers.

- The circle loss runs over the pairwise coordinate and feature distances
  of at most ``max_points`` GT correspondences drawn among the tight ones
  (within ``pos_radius - 0.001``); padded picks get a coordinate distance
  midway between ``pos_radius`` and ``safe_radius`` and a -1e9 logit bias,
  so they drop out of every term;
- feature-match recall: the argmin feature distance of each row lands
  within ``pos_radius``;
- the overlap BCE: overlap scores against membership in the GT
  correspondence set, each class weighted by the other's frequency;
- the saliency BCE on the overlap points: the mutual best feature match
  lands within ``matchability_radius``.

The masks hang on the last bit of coordinate distances, so those are
computed as the jitted reference rounds them (:func:`_norm3`,
:func:`_sq_dist_coords`) and square roots are correctly rounded.  All of
the loss's randomness is the correspondence draw, through
``contrastive._sample_without_replacement``, which a test can replace.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from reference.aprref.geometry.se3 import apply_transform
from reference.aprref.losses import contrastive
from reference.aprref.ops.neighbors import sq_norm
from reference.aprref.ops.pooling import gather_rows

# entries of the [N0, N1] saliency score matrix held at once (256 MiB)
_SCORE_ELEMS = 1 << 26


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference casts a Python threshold
    compared with a float32 array."""
    return float(np.float32(x))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root of x >= 0, as the reference's
    and the card's are.  torch's vectorised CPU square roots (float32 and
    float64) miss by an ulp now and then, so the root is rounded to the
    nearer of its float32 neighbours by exact float64 arithmetic: a
    neighbours' midpoint has 25 significant bits, its square 50."""
    y = torch.sqrt(x)
    lo = torch.nextafter(y, torch.zeros_like(y))
    hi = torch.nextafter(y, torch.full_like(y, float("inf")))
    xd, yd = x.double(), y.double()
    y = torch.where(xd >= torch.square(0.5 * (yd + hi.double())), hi, y)
    return torch.where(xd < torch.square(0.5 * (lo.double() + yd)), lo, y)


def _norm3(d: torch.Tensor) -> torch.Tensor:
    """The reference's jitted ``jnp.linalg.norm(d, axis=-1)`` of 3-vectors:
    ``fma(z, z, fma(y, y, x * x))``, then the square root."""
    return _sqrt(sq_norm(d[..., 0], d[..., 1], d[..., 2]))


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared feature distances [P, Q] by the float32 expansion (TF32 is
    off); ``torch.maximum`` splits the gradient at 0 as ``jnp.maximum``."""
    d2 = ((a * a).sum(1)[:, None] - 2.0 * (a @ b.T)
          + (b * b).sum(1)[None, :])
    return torch.maximum(d2, d2.new_zeros(()))


def _sq_dist_coords(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared coordinate distances [P, Q] from exact per-coordinate
    differences (the expansion cancels at LiDAR range).  The reference's
    ``d2 + diff * diff`` over x, y, z compiles to ``fma(dz, dz, fma(dx,
    dx, dy * dy))``."""
    return sq_norm(*(a[:, None, c] - b[None, :, c] for c in (1, 0, 2)))


def weighted_bce(pred: torch.Tensor, gt: torch.Tensor,
                 weight_mask: torch.Tensor):
    """The reference's weighted BCE over the entries ``weight_mask`` keeps:
    (loss, precision, recall)."""
    w = weight_mask.float()
    n = torch.clamp(w.sum(), min=1.0)
    eps = 1e-7
    p = torch.minimum(torch.maximum(pred, pred.new_tensor(eps)),
                      pred.new_tensor(1 - eps))
    bce = -(gt * torch.log(p) + (1 - gt) * torch.log(1 - p))

    w_negative = (gt * w).sum() / n
    w_positive = 1.0 - w_negative
    cls_w = torch.where(gt >= 0.5, w_positive, w_negative)
    loss = (cls_w * bce * w).sum() / n

    pred_pos = (p >= 0.5).float() * w
    true_pos = pred_pos * gt
    precision = true_pos.sum() / torch.clamp(pred_pos.sum(), min=1e-12)
    recall = true_pos.sum() / torch.clamp((gt * w).sum(), min=1e-12)
    return loss, precision, recall


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, x.new_zeros(()))


def circle_loss(
    coords_dist: torch.Tensor,
    feats_dist: torch.Tensor,
    pos_radius: float,
    safe_radius: float,
    pos_margin: float = 0.1,
    neg_margin: float = 1.4,
    log_scale: float = 48.0,
    pos_optimal: float = 0.1,
    neg_optimal: float = 1.4,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Circle loss over [K, K] distances; ``valid`` [K] marks real rows
    and columns (padded pairs get a -1e9 logit bias)."""
    pos_mask = coords_dist < _f32(pos_radius)
    neg_mask = coords_dist > _f32(safe_radius)
    pad_bias = 0.0
    if valid is not None:
        pad_bias = torch.where(valid[:, None] & valid[None, :], 0.0, -1e9)

    row_sel = pos_mask.any(-1) & neg_mask.any(-1)
    col_sel = pos_mask.any(-2) & neg_mask.any(-2)

    fd = feats_dist.detach()
    pos_weight = torch.clamp(fd - 1e5 * (~pos_mask).float() - pos_optimal,
                             min=0.0)
    neg_weight = torch.clamp(neg_optimal - (fd + 1e5 * (~neg_mask).float()),
                             min=0.0)
    pos_logits = log_scale * (feats_dist - pos_margin) * pos_weight + pad_bias
    neg_logits = log_scale * (neg_margin - feats_dist) * neg_weight + pad_bias

    loss_row = _softplus(torch.logsumexp(pos_logits, -1)
                         + torch.logsumexp(neg_logits, -1)) / log_scale
    loss_col = _softplus(torch.logsumexp(pos_logits, -2)
                         + torch.logsumexp(neg_logits, -2)) / log_scale

    wr, wc = row_sel.float(), col_sel.float()
    mean_row = (loss_row * wr).sum() / torch.clamp(wr.sum(), min=1.0)
    mean_col = (loss_col * wc).sum() / torch.clamp(wc.sum(), min=1.0)
    return 0.5 * (mean_row + mean_col)


def feature_match_recall(coords_dist: torch.Tensor, feats_dist: torch.Tensor,
                         pos_radius: float) -> torch.Tensor:
    """Share of rows with a positive whose argmin feature distance (the
    first on ties) lies within ``pos_radius``."""
    r = _f32(pos_radius)
    has_pos = (coords_dist < r).any(-1)
    sel = torch.argmin(feats_dist, dim=-1)
    sel_dist = coords_dist.gather(1, sel[:, None])[:, 0]
    n_pred = ((sel_dist < r) & has_pos).float().sum()
    return n_pred / (has_pos.float().sum() + 1e-12)


@torch.no_grad()
def _mutual_argmax(f0: torch.Tensor, f1: torch.Tensor, in0: torch.Tensor,
                   in1: torch.Tensor):
    """Over the scores ``f0 @ f1.T``: per row the column of the largest
    score among the ``in1`` columns, per column the row of the largest
    among the ``in0`` rows; ties to the lower index and an empty set to 0,
    as ``jnp.argmax``.  Runs in row chunks of at most _SCORE_ELEMS
    scores."""
    n0, n1 = f0.shape[0], f1.shape[0]
    rows = max(1, _SCORE_ELEMS // max(n1, 1))
    idx1 = []
    best = torch.full((n1,), float("-inf"), device=f0.device)
    idx0 = torch.zeros(n1, dtype=torch.long, device=f0.device)
    for i in range(0, n0, rows):
        s = f0[i:i + rows] @ f1.T
        idx1.append(torch.where(in1[None, :], s, float("-inf")).argmax(1))
        top, arg = torch.where(in0[i:i + rows, None], s,
                               float("-inf")).max(0)
        take = top > best          # earlier rows keep their ties
        best = torch.where(take, top, best)
        idx0 = torch.where(take, arg + i, idx0)
    return torch.cat(idx1), idx0


def metric_loss(
    generator: Optional[torch.Generator],
    src_pcd: torch.Tensor,
    tgt_pcd: torch.Tensor,
    src_mask: torch.Tensor,
    tgt_mask: torch.Tensor,
    src_feats: torch.Tensor,
    tgt_feats: torch.Tensor,
    corr_src: torch.Tensor,
    corr_tgt: torch.Tensor,
    corr_mask: torch.Tensor,
    t_gt: torch.Tensor,
    scores_overlap_src: torch.Tensor,
    scores_overlap_tgt: torch.Tensor,
    scores_saliency_src: torch.Tensor,
    scores_saliency_tgt: torch.Tensor,
    pos_radius: float = 0.21,
    safe_radius: float = 0.75,
    matchability_radius: float = 0.3,
    pos_margin: float = 0.1,
    neg_margin: float = 1.4,
    log_scale: float = 48.0,
    max_points: int = 512,
) -> Dict[str, torch.Tensor]:
    """The whole MetricLoss of one pair: level-0 points [N, 3] / [M, 3]
    with masks, features, the GT correspondences (flat, with their mask),
    t_gt and the four score vectors.  ``generator`` draws the circle
    loss's correspondences."""
    n, m = src_pcd.shape[0], tgt_pcd.shape[0]
    src_warp = apply_transform(src_pcd, t_gt)

    # overlap BCE: membership in the correspondence set
    src_gt = src_pcd.new_zeros(n + 1).index_fill_(
        0, torch.where(corr_mask, corr_src, n).long(), 1.0)[:n]
    tgt_gt = tgt_pcd.new_zeros(m + 1).index_fill_(
        0, torch.where(corr_mask, corr_tgt, m).long(), 1.0)[:m]
    overlap_loss, overlap_prec, overlap_rec = weighted_bce(
        torch.cat([scores_overlap_src, scores_overlap_tgt]),
        torch.cat([src_gt, tgt_gt]), torch.cat([src_mask, tgt_mask]))

    # saliency BCE on the overlap points: mutual best-feature matchability
    in0 = (src_gt > 0.5) & src_mask
    in1 = (tgt_gt > 0.5) & tgt_mask
    idx1, idx0 = _mutual_argmax(src_feats.detach(), tgt_feats.detach(), in0,
                                in1)
    mr = _f32(matchability_radius)
    sal_gt = torch.cat([_norm3(src_warp - tgt_pcd[idx1]) < mr,
                        _norm3(tgt_pcd - src_warp[idx0]) < mr]).float()
    saliency_loss, sal_prec, sal_rec = weighted_bce(
        torch.cat([scores_saliency_src, scores_saliency_tgt]), sal_gt,
        torch.cat([in0, in1]))

    # circle loss over <= max_points sampled tight correspondences
    c_src = corr_src.clamp(0, n - 1).long()
    c_tgt = corr_tgt.clamp(0, m - 1).long()
    c_dist = _norm3(src_warp[c_src] - tgt_pcd[c_tgt])
    # the reference traces the radii as float32 arguments: its threshold
    # is a float32 difference
    tight = corr_mask & (c_dist < float(np.float32(pos_radius)
                                        - np.float32(0.001)))
    pick, pick_ok = contrastive._sample_without_replacement(
        generator, tight, min(max_points, corr_src.shape[0]))
    ps, pt = c_src[pick.long()], c_tgt[pick.long()]
    coords_dist = _sqrt(_sq_dist_coords(src_warp[ps], tgt_pcd[pt]))
    feats_dist = torch.sqrt(_sq_dist(gather_rows(src_feats, ps),
                                     gather_rows(tgt_feats, pt)))
    # padded rows and columns: neither positive nor negative
    bad = ~pick_ok
    neutral = np.float32(0.5) * (np.float32(pos_radius)
                                 + np.float32(safe_radius))
    coords_dist = torch.where(bad[:, None] | bad[None, :], float(neutral),
                              coords_dist)
    closs = circle_loss(coords_dist, feats_dist, pos_radius, safe_radius,
                        pos_margin, neg_margin, log_scale, valid=pick_ok)
    # the recall's argmin must not pick a padded column
    recall = feature_match_recall(
        coords_dist, torch.where(bad[None, :], float("inf"),
                                 feats_dist.detach()), pos_radius)

    return dict(
        circle_loss=closs,
        recall=recall,
        overlap_loss=overlap_loss,
        overlap_precision=overlap_prec,
        overlap_recall=overlap_rec,
        saliency_loss=saliency_loss,
        saliency_precision=sal_prec,
        saliency_recall=sal_rec,
    )
