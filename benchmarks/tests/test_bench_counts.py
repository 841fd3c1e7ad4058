"""The work counts behind the shares, against brute counts at a tiny
size: a sparse conv's valid (in, out) pairs, K1's bytes, K2's valid
pairs, a KPConv's valid neighbours, the MLP's valid rows."""

import torch

from frozen import bounds
from reference.aprref import tally
from reference.aprref.models.kpconv import KPConvLayer
from reference.aprref.models.mlp import GenerativeMLP
from reference.aprref.models.resunet import SparseConv
from reference.aprref.ops.distance import nn_min
from reference.aprref.ops.searchsorted import searchsorted_left_many


def test_sparse_conv_counts_valid_pairs():
    g = torch.Generator().manual_seed(0)
    b, n_in, n_out, k, ci, co = 2, 7, 5, 4, 3, 6
    table = torch.randint(0, n_in + 1, (b, n_out, k), generator=g,
                          dtype=torch.int32)
    out_mask = torch.rand((b, n_out), generator=g) < 0.7
    conv = SparseConv(ci, co, k)
    torch.nn.init.normal_(conv.kernel, generator=g)
    feats = torch.randn((b, n_in, ci), generator=g)
    with tally.counting() as c:
        conv(feats, table, out_mask)
    brute = sum(1 for i in range(b) for o in range(n_out) for j in range(k)
                if out_mask[i, o] and table[i, o, j] < n_in)
    assert c["fwd_flops"] == 2 * ci * co * brute


def test_k1_bytes_and_bound():
    sup = torch.sort(torch.randint(0, 100, (2, 9), dtype=torch.int32)).values
    q = torch.randint(0, 100, (2, 3, 4), dtype=torch.int32)
    with tally.counting() as c:
        searchsorted_left_many([(sup, q), (sup, q[:, :1])])
    # supports read once, queries read once, results written once
    want = 4 * ((2 * 9 + 2 * 2 * 12) + (2 * 9 + 2 * 2 * 4))
    assert c["k1_bytes"] == want
    assert bounds.k1_bound_s(want) == want / 3.35e12


def test_k2_counts_valid_pairs():
    g = torch.Generator().manual_seed(1)
    q, s = torch.randn((2, 6, 3), generator=g), torch.randn((2, 5, 3),
                                                            generator=g)
    sm = torch.rand((2, 5), generator=g) < 0.6
    qm = torch.rand((2, 6), generator=g) < 0.5
    with tally.counting() as c:
        nn_min(q, s, sm, qm)
    brute = sum(int(qm[i].sum()) * int(sm[i].sum()) for i in range(2))
    assert c["k2_pairs"] == brute
    assert bounds.k2_bound_s(brute, 0) == brute * 8 / 3.35e13


def test_kpconv_counts_valid_neighbours():
    g = torch.Generator().manual_seed(2)
    layer = KPConvLayer(4, 5, kp_extent=1.0, radius=2.0,
                        num_kernel_points=3)
    nq, ns, nmax = 6, 8, 4
    nb = torch.randint(0, ns + 1, (nq, nmax), generator=g)
    x = torch.randn((ns, 4), generator=g)
    with tally.counting() as c:
        layer(torch.randn((nq, 3), generator=g),
              torch.randn((ns, 3), generator=g), nb, x)
    valid = nb < ns
    want = 2 * 3 * 4 * int(valid.sum()) + 2 * 3 * 4 * 5 * int(
        valid.any(1).sum())
    assert c["fwd_flops"] == want


def test_mlp_counts_valid_rows_only():
    mlp = GenerativeMLP(8, hidden=(4,), out_points=2)
    mlp.reset_parameters(torch.Generator().manual_seed(3))
    mask = torch.tensor([[True, False, True, True, False]])
    with tally.counting() as c:
        mlp(torch.randn((1, 5, 8)), mask)
    assert c["fwd_flops"] == 2 * 3 * (8 * 4 + 4 * 6)


def test_mfu_share():
    assert bounds.mfu_percent(989e12, 1.0) == 100.0
