# Frozen copy of apr_torch/losses/contrastive.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Contrastive metric-learning losses (port of
``apr_tpu/losses/contrastive.py``).

``hardest_contrastive_loss``: sample P positive pairs and two subsets of S
candidate points; the hardest negative of each positive endpoint is its
nearest candidate in feature space, excluding pairs that are themselves
positives; pos_loss = relu(||f0 - f1||^2 - pos_thresh) (squared distance)
and neg_loss = relu(neg_thresh - min_dist)^2 (Euclidean distance).
``contrastive_loss_random_negatives`` pairs the positives with random
points, and ``triplet_loss`` is the triplet margin loss with random or
hardest negatives.

Every random number is drawn through two seams, so that a test can replay
the reference's draws: :func:`_sample_without_replacement` and
:func:`_random_picks`.  The Euclidean distances are ``sqrt(sum(d * d))``,
as the reference's ``jnp.linalg.norm``: at a zero vector their gradient is
not finite (``torch.linalg.norm``'s would be 0), so a step with a
zero-length positive is skipped by the trainers' finite gate, as the
reference's is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from reference.aprref.ops.pooling import gather_rows

_BIG = 2**31 - 1


def top_valid(scores: torch.Tensor, mask: torch.Tensor, num: int):
    """The ``num`` valid entries of ``mask`` [N] with the largest
    ``scores`` [N], in descending order, ties to the lower index (the
    reference's top-k), padded with invalid ones when fewer are valid:
    (idx int32 [num], ok bool [num])."""
    scores = torch.where(mask, scores, -1.0)
    top, idx = torch.sort(scores, descending=True, stable=True)
    return idx[:num].to(torch.int32), top[:num] >= 0.0


def _sample_without_replacement(generator: Optional[torch.Generator],
                                mask: torch.Tensor, num: int):
    """``num`` random valid entries of ``mask``: :func:`top_valid` of
    uniform scores drawn from ``generator``.  All of the loss's randomness
    is drawn here, so a test can replay the reference's draws by replacing
    this function."""
    return top_valid(torch.rand(mask.shape[0], generator=generator,
                                device=mask.device), mask, num)


def _random_picks(generator: Optional[torch.Generator], num: int,
                  high: int, device) -> torch.Tensor:
    """``num`` uniform integers in [0, high) (int64): the triplet loss's
    random negative of each positive."""
    return torch.randint(0, high, (num,), generator=generator,
                         device=device)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Row norms as ``jnp.linalg.norm(x, axis=1)``: sqrt of the sum of
    squares, with its non-finite gradient at a zero row."""
    return torch.sqrt((x * x).sum(1))


def _pdist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances [P, S] in full float32 (TF32 off)."""
    d2 = ((a * a).sum(1)[:, None] - 2.0 * (a @ b.T)
          + (b * b).sum(1)[None, :])
    return torch.clamp(d2, min=0.0)


def _member(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """queries in sorted_keys (both int32 1-D)."""
    slot = torch.searchsorted(sorted_keys, queries).clamp(
        0, sorted_keys.shape[0] - 1)
    return sorted_keys[slot] == queries


def _rank_in(sample, sample_ok, x):
    """Index of x in sorted(valid sample), else len(sample) (sentinel)."""
    sorted_s = torch.sort(torch.where(sample_ok, sample, _BIG)).values
    slot = torch.searchsorted(sorted_s, x).clamp(0, sample.shape[0] - 1)
    return torch.where(sorted_s[slot] == x, slot,
                       sample.shape[0]).to(torch.int32)


def hardest_contrastive_loss(
    generator: Optional[torch.Generator],
    feats0: torch.Tensor,
    feats1: torch.Tensor,
    pos_src: torch.Tensor,
    pos_tgt: torch.Tensor,
    pos_mask: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
    num_pos: int = 1024,
    num_hn_samples: int = 256,
    pos_thresh: float = 0.1,
    neg_thresh: float = 1.4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_loss, neg_loss) over flattened feats [N, C] and positives [P]."""
    n0, n1 = feats0.shape[0], feats1.shape[0]
    dev = feats0.device
    if mask0 is None:
        mask0 = torch.ones(n0, dtype=torch.bool, device=dev)
    if mask1 is None:
        mask1 = torch.ones(n1, dtype=torch.bool, device=dev)

    pidx, pok = _sample_without_replacement(generator, pos_mask, num_pos)
    s0, s0ok = _sample_without_replacement(generator, mask0, num_hn_samples)
    s1, s1ok = _sample_without_replacement(generator, mask1, num_hn_samples)
    i0 = pos_src[pidx.long()]
    i1 = pos_tgt[pidx.long()]

    pf0 = gather_rows(feats0, i0.clamp(0, n0 - 1))
    pf1 = gather_rows(feats1, i1.clamp(0, n1 - 1))
    sub0 = gather_rows(feats0, s0)
    sub1 = gather_rows(feats1, s1)

    d01 = torch.where(s1ok[None, :], _pdist2(pf0, sub1), float("inf"))
    d10 = torch.where(s0ok[None, :], _pdist2(pf1, sub0), float("inf"))
    min01, arg01 = torch.min(d01, dim=1)
    min10, arg10 = torch.min(d10, dim=1)
    d01_min, d10_min = torch.sqrt(min01), torch.sqrt(min10)
    d01_arg, d10_arg = s1[arg01], s0[arg10]

    # Exclude hardest negatives that are themselves positive pairs.  The
    # candidate side of each pair key is rank-compressed into its
    # num_hn-sized subsample, so keys stay below (num_hn + 1) * max(n0, n1)
    # and fit int32 at full scale.
    assert (num_hn_samples + 1) * max(n0, n1) < 2 ** 31, (
        "pair-key encoding would overflow int32; lower num_hn_samples "
        "or the flattened buffer size")
    stride = num_hn_samples + 1
    # direction 0: pairs (anchor src, candidate in s1)
    keys0 = torch.sort(torch.where(
        pos_mask, pos_src * stride + _rank_in(s1, s1ok, pos_tgt),
        _BIG)).values
    not_pos0 = ~_member(keys0, i0 * stride + _rank_in(s1, s1ok, d01_arg))
    # direction 1: pairs (candidate in s0, anchor tgt)
    keys1 = torch.sort(torch.where(
        pos_mask, _rank_in(s0, s0ok, pos_src) * n1 + pos_tgt, _BIG)).values
    not_pos1 = ~_member(keys1, _rank_in(s0, s0ok, d10_arg) * n1 + i1)

    pos_d2 = ((pf0 - pf1) ** 2).sum(1)
    w = pok.float()
    pos_loss = (torch.relu(pos_d2 - pos_thresh) * w).sum() / torch.clamp(
        w.sum(), min=1.0)

    w0 = (pok & not_pos0 & torch.isfinite(d01_min)).float()
    w1 = (pok & not_pos1 & torch.isfinite(d10_min)).float()
    neg0 = torch.relu(neg_thresh - torch.where(w0 > 0, d01_min, 0.0)) ** 2
    neg1 = torch.relu(neg_thresh - torch.where(w1 > 0, d10_min, 0.0)) ** 2
    neg_loss = 0.5 * ((neg0 * w0).sum() / torch.clamp(w0.sum(), min=1.0)
                      + (neg1 * w1).sum() / torch.clamp(w1.sum(), min=1.0))
    return pos_loss, neg_loss


def _positives(generator, feats0, feats1, pos_src, pos_tgt, pos_mask,
               num_pos):
    """The features of ``num_pos`` sampled positive pairs and their
    validity."""
    pidx, pok = _sample_without_replacement(generator, pos_mask, num_pos)
    pf0 = gather_rows(feats0, pos_src[pidx.long()].clamp(
        0, feats0.shape[0] - 1))
    pf1 = gather_rows(feats1, pos_tgt[pidx.long()].clamp(
        0, feats1.shape[0] - 1))
    return pf0, pf1, pok


def _masked_mean(terms: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (terms * w).sum() / torch.clamp(w.sum(), min=1.0)


def contrastive_loss_random_negatives(
    generator: Optional[torch.Generator],
    feats0: torch.Tensor,
    feats1: torch.Tensor,
    pos_src: torch.Tensor,
    pos_tgt: torch.Tensor,
    pos_mask: torch.Tensor,
    mask1: Optional[torch.Tensor] = None,
    num_pos: int = 1024,
    num_neg: int = 1024,
    pos_thresh: float = 0.1,
    neg_thresh: float = 1.4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ContrastiveLossTrainer's (pos_loss, neg_loss): relu(d -
    pos_thresh)^2 over sampled positive pairs and relu(neg_thresh - d)^2
    over the sampled positives' cloud-0 side paired with random valid
    cloud-1 points."""
    if mask1 is None:
        mask1 = torch.ones(feats1.shape[0], dtype=torch.bool,
                           device=feats1.device)
    pf0, pf1, pok = _positives(generator, feats0, feats1, pos_src, pos_tgt,
                               pos_mask, num_pos)
    nidx, nok = _sample_without_replacement(generator, mask1, num_neg)
    nf1 = gather_rows(feats1, nidx)
    take = min(num_pos, num_neg)
    pos_d = _norm(pf0 - pf1)
    neg_d = _norm(pf0[:take] - nf1[:take])
    pos_loss = _masked_mean(torch.relu(pos_d - pos_thresh) ** 2,
                            pok.float())
    neg_loss = _masked_mean(torch.relu(neg_thresh - neg_d) ** 2,
                            (pok[:take] & nok[:take]).float())
    return pos_loss, neg_loss


def triplet_loss(
    generator: Optional[torch.Generator],
    feats0: torch.Tensor,
    feats1: torch.Tensor,
    pos_src: torch.Tensor,
    pos_tgt: torch.Tensor,
    pos_mask: torch.Tensor,
    mask1: Optional[torch.Tensor] = None,
    num_pos: int = 1024,
    num_hn_samples: int = 256,
    margin: float = 1.0,
    hardest: bool = False,
) -> torch.Tensor:
    """Triplet margin loss relu(margin + d_pos - d_neg) over sampled
    positives; the negative of each is a random one (``hardest=False``) or
    the nearest (``hardest=True``) of ``num_hn_samples`` sampled cloud-1
    points (the Triplet and HardestTriplet trainers)."""
    if mask1 is None:
        mask1 = torch.ones(feats1.shape[0], dtype=torch.bool,
                           device=feats1.device)
    pf0, pf1, pok = _positives(generator, feats0, feats1, pos_src, pos_tgt,
                               pos_mask, num_pos)
    d_pos = _norm(pf0 - pf1)
    sidx, sok = _sample_without_replacement(generator, mask1, num_hn_samples)
    d2 = torch.where(sok[None, :], _pdist2(pf0, gather_rows(feats1, sidx)),
                     float("inf"))
    if hardest:
        d_neg = torch.sqrt(d2.min(1).values)
    else:
        pick = _random_picks(generator, num_pos, num_hn_samples,
                             feats0.device)
        d_neg = torch.sqrt(d2[torch.arange(num_pos, device=d2.device),
                              pick])
    w = (pok & torch.isfinite(d_neg)).float()
    return _masked_mean(torch.relu(margin + d_pos
                                   - torch.where(w > 0, d_neg, 0.0)), w)
