"""Batched RANSAC for rigid registration (port of
``apr_tpu/registration/ransac.py``).

Per hypothesis: sample ``ransac_n`` correspondences, apply Open3D's two
pruning checkers (edge-length similarity inside the tuple, point distance
after the fit), fit with the Newton-polar Kabsch, and score every hypothesis
against all correspondences by inlier count, tie-broken by inlier RMSE.  A
weighted Kabsch refit on the best hypothesis' inliers (3 steps) plays the
role of Open3D's local refinement.

Drawing is split from using: :func:`ransac_pose` draws the index tuples
from a ``torch.Generator`` and hands them to :func:`ransac_from_draws`, so
a test can feed the reference's own random numbers.  Either call is one
``ransac`` span (:func:`apr_torch.utils.profiling.span`), and
``ransac_from_draws.hypotheses`` counts the hypotheses scored, from every
thread: stage 1 and each escalation rung that ran, known on the host.
"""

from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional

import torch

from apr_torch.geometry.kabsch import _det3, kabsch, kabsch_fast
from apr_torch.geometry.se3 import apply_transform
from apr_torch.utils.profiling import span

_count_lock = threading.Lock()


class RansacResult(NamedTuple):
    transform: torch.Tensor   # [4, 4]
    fitness: torch.Tensor     # scalar: inliers / valid correspondences
    inlier_rmse: torch.Tensor
    inliers: torch.Tensor     # bool [M] over the correspondence set


def trials_needed(w: torch.Tensor, ransac_n: int,
                  confidence: float) -> torch.Tensor:
    """Open3D's RANSAC stopping count T = log(1-conf) / log(1-w^n): trials
    such that drawing one all-inlier n-tuple has probability >= confidence
    at inlier ratio w.  inf when w <= 0."""
    log_miss = torch.log1p(-torch.clamp(w ** ransac_n, 0.0, 1.0 - 1e-12))
    return torch.where(log_miss < 0,
                       torch.log1p(torch.tensor(-confidence)) / log_miss,
                       torch.inf)


def _edge_length_ok(src: torch.Tensor, tgt: torch.Tensor,
                    similarity: float) -> torch.Tensor:
    """Open3D CorrespondenceCheckerBasedOnEdgeLength over tuples [h, n, 3]:
    for every pair (i, j), s * d_src <= d_tgt <= d_src / s."""
    ds = torch.linalg.vector_norm(src[:, :, None] - src[:, None, :], dim=-1)
    dt = torch.linalg.vector_norm(tgt[:, :, None] - tgt[:, None, :], dim=-1)
    n = src.shape[1]
    diag = torch.eye(n, dtype=torch.bool, device=src.device)
    ok = (dt >= similarity * ds) & (ds >= similarity * dt)
    return (ok | diag).all(dim=2).all(dim=1)


def stage_sizes(num_hypotheses: int, hypothesis_chunk: int = 1024,
                escalation_factor: int = 0,
                escalation_rungs: int = 1) -> List[int]:
    """Hypotheses per stage: stage 1, then one entry per escalation rung."""
    chunk = min(hypothesis_chunk, num_hypotheses)
    h = (num_hypotheses // chunk) * chunk
    n_esc = max((escalation_factor * h) // chunk, 1) * chunk
    rungs = max(escalation_rungs, 1) if escalation_factor > 0 else 0
    return [h] + [n_esc] * rungs


def ransac_from_draws(
    src_xyz: torch.Tensor,
    tgt_xyz: torch.Tensor,
    corr_mask: Optional[torch.Tensor],
    stage_draws: List[torch.Tensor],
    distance_threshold: float = 0.3,
    ransac_n: int = 4,
    edge_length_similarity: float = 0.9,
    hypothesis_chunk: int = 1024,
    escalation_min_inliers: int = 30,
    escalation_confidence: float = 0.0,
) -> RansacResult:
    """RANSAC over matched pairs src_xyz[i] <-> tgt_xyz[i] ([M, 3]) given
    the draws: ``stage_draws[0]`` [H, n] for stage 1, then one [H_esc, n]
    per escalation rung; each entry is uniform in [0, n_valid).  A rung
    runs when the best hypothesis so far has fewer than
    ``escalation_min_inliers`` inliers or, with ``escalation_confidence``
    in (0, 1), when fewer trials than Open3D's stopping count have run.
    """
    with span("ransac"):
        return _ransac(src_xyz, tgt_xyz, corr_mask, stage_draws,
                       distance_threshold, ransac_n, edge_length_similarity,
                       hypothesis_chunk, escalation_min_inliers,
                       escalation_confidence)


def _count_hypotheses(n: int) -> None:
    """``n`` more in ``ransac_from_draws.hypotheses``, exact when several
    threads register."""
    with _count_lock:
        ransac_from_draws.hypotheses += n


def _ransac(src_xyz, tgt_xyz, corr_mask, stage_draws, distance_threshold,
            ransac_n, edge_length_similarity, hypothesis_chunk,
            escalation_min_inliers, escalation_confidence) -> RansacResult:
    """:func:`ransac_from_draws`'s body, outside its span."""
    m = src_xyz.shape[0]
    dev = src_xyz.device
    if corr_mask is None:
        corr_mask = torch.ones(m, dtype=torch.bool, device=dev)
    n_valid = corr_mask.sum()
    # valid correspondence positions first, m-sentinels last
    valid_sorted = torch.sort(torch.where(
        corr_mask, torch.arange(m, dtype=torch.int32, device=dev), m)).values
    thr2 = distance_threshold * distance_threshold
    sx, sy, sz = src_xyz[:, 0], src_xyz[:, 1], src_xyz[:, 2]
    tx, ty, tz = tgt_xyz[:, 0], tgt_xyz[:, 1], tgt_xyz[:, 2]
    off_diag = ~torch.eye(ransac_n, dtype=torch.bool, device=dev)

    def eval_chunk(sample):                              # [h, n] int
        s = src_xyz[sample]                              # [h, n, 3]
        t = tgt_xyz[sample]
        edge_ok = _edge_length_ok(s, t, edge_length_similarity)
        # Open3D samples distinct indices; a repeated one makes the tuple
        # degenerate while it trivially passes the edge checker
        dup = ((sample[:, :, None] == sample[:, None, :])
               & off_diag).any(dim=2).any(dim=1)
        transforms = kabsch_fast(s, t)                   # [h, 4, 4]
        proper = _det3(transforms[:, :3, :3]) > 0.5
        r, tr = transforms[:, :3, :3], transforms[:, :3, 3]
        # plane-wise scoring against every correspondence: [h, M]
        wx = (r[:, 0, 0, None] * sx + r[:, 0, 1, None] * sy
              + r[:, 0, 2, None] * sz + tr[:, 0, None])
        wy = (r[:, 1, 0, None] * sx + r[:, 1, 1, None] * sy
              + r[:, 1, 2, None] * sz + tr[:, 1, None])
        wz = (r[:, 2, 0, None] * sx + r[:, 2, 1, None] * sy
              + r[:, 2, 2, None] * sz + tr[:, 2, None])
        d2 = (wx - tx) ** 2 + (wy - ty) ** 2 + (wz - tz) ** 2
        inl = (d2 <= thr2) & corr_mask
        n_inl = inl.sum(dim=1)
        rmse = torch.sqrt(torch.where(inl, d2, 0.0).sum(dim=1)
                          / torch.clamp(n_inl, min=1))
        # distance checker on the sampled tuple: all n points inliers
        dist_ok = (torch.gather(d2, 1, sample.long()) <= thr2).all(dim=1)
        ok = edge_ok & ~dup & dist_ok & proper
        n_inl = torch.where(ok, n_inl, 0)
        score = n_inl.to(torch.float32) - rmse / (rmse + 1.0)
        best = torch.argmax(score)
        return score[best], transforms[best]

    def run_stage(draws):
        samples = torch.clamp(valid_sorted[draws.long()], max=m - 1)
        best_s, best_t = None, None
        for chunk in torch.split(samples, hypothesis_chunk):
            s, t = eval_chunk(chunk)
            if best_s is None:
                best_s, best_t = s, t
            else:  # strict >: the first chunk holding the max wins
                better = s > best_s
                best_s = torch.where(better, s, best_s)
                best_t = torch.where(better, t, best_t)
        return best_s, best_t

    best_score, best_t = run_stage(stage_draws[0])
    n_done = stage_draws[0].shape[0]
    scored = n_done
    for draws in stage_draws[1:]:
        # score = n_inl - rmse/(rmse+1), the penalty in [0, 1): score < k
        # <=> best inlier count <= k for the integer thresholds used here
        trig = best_score < escalation_min_inliers
        if escalation_confidence > 0.0:
            w = torch.ceil(best_score) / torch.clamp(n_valid, min=1)
            trig = trig | (n_done < trials_needed(w, ransac_n,
                                                  escalation_confidence))
        if bool(trig):
            s1, t1 = run_stage(draws)
            better = s1 > best_score
            best_score = torch.where(better, s1, best_score)
            best_t = torch.where(better, t1, best_t)
            scored += draws.shape[0]
        n_done += draws.shape[0]
    _count_hypotheses(scored)

    # local refinement: weighted Kabsch on the best hypothesis' inliers
    for _ in range(3):
        d2 = ((apply_transform(src_xyz, best_t) - tgt_xyz) ** 2).sum(dim=-1)
        w = ((d2 <= thr2) & corr_mask).to(src_xyz.dtype)
        has = w.sum() >= ransac_n
        best_t = torch.where(has, kabsch(src_xyz, tgt_xyz, w), best_t)

    d2 = ((apply_transform(src_xyz, best_t) - tgt_xyz) ** 2).sum(dim=-1)
    inliers = (d2 <= thr2) & corr_mask
    n_inl = inliers.sum()
    return RansacResult(
        transform=best_t,
        fitness=n_inl / torch.clamp(n_valid, min=1),
        inlier_rmse=torch.sqrt(torch.where(inliers, d2, 0.0).sum()
                               / torch.clamp(n_inl, min=1)),
        inliers=inliers,
    )


ransac_from_draws.hypotheses = 0


def draw_stages(generator: torch.Generator, n_valid: torch.Tensor,
                sizes: List[int], ransac_n: int = 4) -> List[torch.Tensor]:
    """Uniform index tuples in [0, max(n_valid, 1)) for every stage, drawn
    on the generator's device without a host sync."""
    hi = torch.clamp(n_valid, min=1).to(torch.float64)
    draws = []
    for h in sizes:
        u = torch.rand((h, ransac_n), generator=generator,
                       dtype=torch.float64, device=generator.device)
        draws.append(torch.minimum((u * hi).to(torch.int64),
                                   (hi - 1).to(torch.int64)))
    return draws


def ransac_pose(
    generator: torch.Generator,
    src_xyz: torch.Tensor,
    tgt_xyz: torch.Tensor,
    corr_mask: Optional[torch.Tensor] = None,
    distance_threshold: float = 0.3,
    ransac_n: int = 4,
    num_hypotheses: int = 32768,
    edge_length_similarity: float = 0.9,
    hypothesis_chunk: int = 1024,
    escalation_factor: int = 0,
    escalation_min_inliers: int = 30,
    escalation_rungs: int = 1,
    escalation_confidence: float = 0.0,
) -> RansacResult:
    """RANSAC over a matched correspondence set; returns the best rigid
    transform mapping src -> tgt.  ``escalation_factor > 0`` adds up to
    ``escalation_rungs`` stages of ``escalation_factor * num_hypotheses``
    more hypotheses (see :func:`ransac_from_draws`)."""
    if corr_mask is None:
        corr_mask = torch.ones(src_xyz.shape[0], dtype=torch.bool,
                               device=src_xyz.device)
    sizes = stage_sizes(num_hypotheses, hypothesis_chunk, escalation_factor,
                        escalation_rungs)
    with span("ransac"):
        draws = draw_stages(generator, corr_mask.sum(), sizes, ransac_n)
        return _ransac(src_xyz, tgt_xyz, corr_mask, draws,
                       distance_threshold, ransac_n, edge_length_similarity,
                       hypothesis_chunk, escalation_min_inliers,
                       escalation_confidence)
