"""SE(3) pose-graph optimization, the multiway registration backend (port
of ``apr_tpu/geometry/pose_graph.py``, which replaces Open3D's PoseGraph and
GlobalOptimizationLevenbergMarquardt of the reference's APG multiway
registration).

For edge (i, j) with measured transform Z_ij (source i into target j, from
pairwise ICP) and node poses X_i (node to reference), the residual is
log(Z_ij^-1 X_j^-1 X_i) in se(3); uncertain edges are down-weighted
Cauchy-style, as the reference approximates Open3D's edge pruning.  The
Jacobians are forward differences (eps 1e-7), which multiply any last-bit
change of a residual by 1e7, so every step keeps the reference's order.

This is host math, float64 numpy, as in the reference: the graphs hold 4
nodes and 6 edges, and on a card each step would be a handful of launches
and nothing else.  No device is involved.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


# --- se(3) log/exp (numpy) -------------------------------------------------

def _hat(v: np.ndarray) -> np.ndarray:
    return np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """xi = [omega(3), upsilon(3)] -> 4x4."""
    omega, ups = xi[:3], xi[3:]
    theta = np.linalg.norm(omega)
    o_hat = _hat(omega)
    if theta < 1e-10:
        r = np.eye(3) + o_hat
        v = np.eye(3) + 0.5 * o_hat
    else:
        a = np.sin(theta) / theta
        b = (1 - np.cos(theta)) / theta ** 2
        c = (1 - a) / theta ** 2
        r = np.eye(3) + a * o_hat + b * (o_hat @ o_hat)
        v = np.eye(3) + b * o_hat + c * (o_hat @ o_hat)
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = v @ ups
    return out


def se3_log(t: np.ndarray) -> np.ndarray:
    r = t[:3, :3]
    cos = np.clip((np.trace(r) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-10:
        omega = np.array([
            r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]
        ]) * 0.5
        v_inv = np.eye(3) - 0.5 * _hat(omega)
    elif np.sin(theta) < 1e-6:
        # theta ~ pi: the vee vector AND sin(theta) both vanish, so the
        # usual theta/(2 sin theta) * vee form is 0/0 — recover the axis
        # from the symmetric part instead: R + I = 2 n n^T at theta = pi
        # (loop-closure edges with ~180 deg relative rotation are common
        # in multiway registration of opposing scans)
        a_sym = 0.5 * (r + np.eye(3))
        diag = np.maximum(np.diag(a_sym), 0.0)
        k = int(np.argmax(diag))
        n = a_sym[:, k] / max(np.sqrt(diag[k]), 1e-12)
        n = n / max(np.linalg.norm(n), 1e-12)
        # sign is free at exactly pi; keep continuity with the vee vector
        vee = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0],
                        r[1, 0] - r[0, 1]])
        if np.dot(n, vee) < 0:
            n = -n
        omega = theta * n
        o_hat = _hat(omega)
        v_inv = (
            np.eye(3)
            - 0.5 * o_hat
            + (1 - theta * np.cos(theta / 2) / (2 * np.sin(theta / 2)))
            / theta ** 2 * (o_hat @ o_hat)
        )
        ups = v_inv @ t[:3, 3]
        return np.concatenate([omega, ups])
    else:
        omega = theta / (2 * np.sin(theta)) * np.array([
            r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]
        ])
        o_hat = _hat(omega)
        v_inv = (
            np.eye(3)
            - 0.5 * o_hat
            + (1 - theta * np.cos(theta / 2) / (2 * np.sin(theta / 2)))
            / theta ** 2 * (o_hat @ o_hat)
        )
    ups = v_inv @ t[:3, 3]
    return np.concatenate([omega, ups])


# --- pose graph ------------------------------------------------------------

@dataclass
class PoseGraphNode:
    pose: np.ndarray  # node-to-reference 4x4


@dataclass
class PoseGraphEdge:
    source: int
    target: int
    transformation: np.ndarray   # measured source -> target
    information: np.ndarray      # 6x6
    uncertain: bool = False


@dataclass
class PoseGraph:
    nodes: List[PoseGraphNode] = field(default_factory=list)
    edges: List[PoseGraphEdge] = field(default_factory=list)


def _numeric_jacobian(f, x0, eps=1e-7):
    y0 = f(x0)
    jac = np.zeros((len(y0), len(x0)))
    for k in range(len(x0)):
        dx = np.zeros_like(x0)
        dx[k] = eps
        jac[:, k] = (f(x0 + dx) - y0) / eps
    return jac


def global_optimization(
    graph: PoseGraph,
    max_iterations: int = 100,
    edge_prune_threshold: float = 0.25,
    reference_node: int = 0,
    mu_init: float = 1e-3,
) -> PoseGraph:
    """Levenberg-Marquardt over all node poses (reference node fixed).

    Mutates and returns ``graph`` with optimized node poses, matching the
    call pattern of o3d.global_optimization (complement_data_loader:453-461).
    """
    n = len(graph.nodes)
    if n <= 1:
        return graph
    poses = [g.pose.copy() for g in graph.nodes]
    free = [i for i in range(n) if i != reference_node]
    idx_of = {node: k for k, node in enumerate(free)}

    def edge_residual(poses_, e: PoseGraphEdge) -> np.ndarray:
        xi = poses_[e.source]
        xj = poses_[e.target]
        return se3_log(np.linalg.inv(e.transformation) @ np.linalg.inv(xj) @ xi)

    def total_error(poses_):
        err = 0.0
        for e in graph.edges:
            r = edge_residual(poses_, e)
            c = float(r @ e.information @ r)
            if e.uncertain:
                c = c / (1.0 + c / max(edge_prune_threshold, 1e-9))
            err += c
        return err

    mu = mu_init
    prev_err = total_error(poses)
    for _ in range(max_iterations):
        h = np.zeros((6 * len(free), 6 * len(free)))
        b = np.zeros(6 * len(free))
        for e in graph.edges:
            r0 = edge_residual(poses, e)
            w = 1.0
            if e.uncertain:
                c = float(r0 @ e.information @ r0)
                w = 1.0 / (1.0 + c / max(edge_prune_threshold, 1e-9)) ** 2

            blocks = {}
            for node in (e.source, e.target):
                if node == reference_node:
                    continue

                def f(xi, node=node):
                    p2 = list(poses)
                    p2[node] = se3_exp(xi) @ poses[node]
                    return edge_residual(p2, e)

                blocks[node] = _numeric_jacobian(f, np.zeros(6))

            info = w * e.information
            for ni, ji in blocks.items():
                a = idx_of[ni] * 6
                b[a:a + 6] -= ji.T @ info @ r0
                for nj, jj in blocks.items():
                    c2 = idx_of[nj] * 6
                    h[a:a + 6, c2:c2 + 6] += ji.T @ info @ jj

        try:
            delta = np.linalg.solve(h + mu * np.eye(h.shape[0]), b)
        except np.linalg.LinAlgError:
            mu *= 10
            continue
        new_poses = list(poses)
        for node, k in idx_of.items():
            new_poses[node] = se3_exp(delta[k * 6:(k + 1) * 6]) @ poses[node]
        err = total_error(new_poses)
        if err < prev_err:
            poses = new_poses
            if prev_err - err < 1e-9 * max(prev_err, 1.0):
                prev_err = err
                break
            prev_err = err
            mu = max(mu * 0.5, 1e-9)
        else:
            mu *= 4.0
            if mu > 1e6:
                break

    for i in range(n):
        graph.nodes[i].pose = poses[i]
    return graph
