"""Segment pooling over sentinel-padded index tables (port of
``apr_tpu/ops/pooling.py``); every function takes stacked clouds
[P, N, F] with tables [P, Nq, K] whose sentinel is N."""

from __future__ import annotations

import torch


def segment_mean_capped(values: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Mean of values [P, N, F] per segment; ids == num_segments are
    dropped (the barycenter pooling of grid subsampling)."""
    p = values.shape[0]
    ids = torch.clamp(segment_ids, max=num_segments).long()
    valid = segment_ids < num_segments
    s = torch.zeros((p, num_segments + 1) + values.shape[2:],
                    dtype=values.dtype, device=values.device)
    s.scatter_add_(1, ids[..., None].expand(values.shape),
                   torch.where(valid[..., None], values, 0.0))
    c = torch.zeros((p, num_segments + 1), dtype=torch.int32,
                    device=values.device)
    c.scatter_add_(1, ids, valid.to(torch.int32))
    return s[:, :num_segments] / torch.clamp(c[:, :num_segments],
                                             min=1)[..., None]


def _padded_rows(feats: torch.Tensor, neighbor_idx: torch.Tensor):
    """Rows of feats [P, N, F] (one zero row appended as the sentinel N)
    gathered by neighbor_idx [P, Nq, K] -> [P, Nq, K, F]."""
    p, n, f = feats.shape
    padded = torch.cat([feats, feats.new_zeros((p, 1, f))], 1)
    idx = torch.clamp(neighbor_idx, max=n).long()
    rows = torch.gather(padded, 1, idx.reshape(p, -1, 1).expand(-1, -1, f))
    return rows.reshape(idx.shape + (f,))


def gather_neighbors(feats: torch.Tensor,
                     neighbor_idx: torch.Tensor) -> torch.Tensor:
    """[P, Nq, K, F] features by a sentinel-padded table; the sentinel
    yields a zero row (the reference's shadow point)."""
    return _padded_rows(feats, neighbor_idx)


def max_pool_neighbors(feats: torch.Tensor,
                       neighbor_idx: torch.Tensor) -> torch.Tensor:
    """Max over each row's neighbours [P, Nq, F]; a shadow neighbour
    contributes a ZERO row, so the max is floored at 0 wherever a row has
    one (the reference's ``max_pool`` pads with zeros; kept for checkpoint
    fidelity)."""
    return _padded_rows(feats, neighbor_idx).amax(dim=2)
