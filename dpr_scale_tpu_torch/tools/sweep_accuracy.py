"""How far the MIPS sweep kernels' fp32 sums sit from exact, against their
plain versions, at a given width (GPU).

    python -m dpr_scale_tpu_torch.tools.sweep_accuracy [--dims 30522 4098 30528]

For each D and each kind of vectors (small integers, mixed-sign and sparse
non-negative, where every sum is exact in fp32; sparse and dense
non-negative floats; normal), B queries against N bf16 rows: the tile
maxima of ``tile_max_scores`` (kernel and plain) against fp64, and
``count_above``'s counts against plain at thresholds midway between each
query's k-th and (k+1)-th exact score (those clear of both by twice
``COUNT_MARGIN_REL`` x |tau| must agree); ``groupmax``'s 8-row group
maxima against fp64 and ``count_above_groups``' counts over 256-row groups
against plain in the groups with no score that near tau. D % 8 != 0 takes
the score-tile route, D % 8 == 0 the wgmma route. One JSON line per case.
"""
from __future__ import annotations

import argparse
import json

import torch

from dpr_scale_tpu_torch.index.mips import COUNT_MARGIN_REL
from dpr_scale_tpu_torch.ops import mips_kernels as mk

KINDS = ("int_mixed", "int_nonneg_sparse", "float_nonneg_sparse", "dense_nonneg", "normal")


def vectors(kind, n, D, g, dev):
    x = torch.randn(n, D, generator=g, device=dev)
    if kind == "normal":
        return x
    if kind == "dense_nonneg":
        return torch.relu(x) * 2 + 0.1 * (x > 0)
    if kind.startswith("int"):
        lo = -3 if kind == "int_mixed" else 0
        x = torch.randint(lo, 4, (n, D), generator=g, device=dev).float()
    else:
        x = torch.relu(x) * 3
    if kind.endswith("sparse"):
        x = x * (torch.rand(n, D, generator=g, device=dev) < 0.05)
    return x


def case(kind, B, N, D, k, g, dev):
    q = vectors(kind, B, D, g, dev).to(torch.bfloat16)
    c = vectors(kind, N, D, g, dev).to(torch.bfloat16)
    exact = q.double() @ c.double().T
    best = torch.topk(exact, k + 1, dim=1).values
    tau = ((best[:, k - 1] + best[:, k]) / 2).float().contiguous()
    clear = (best[:, k - 1] - best[:, k]) > 2 * COUNT_MARGIN_REL * tau.abs().double()
    tile = exact.view(B, -1, 256).amax(2)
    before = dict(mk.tile_max_scores_kernel.launches_by_route)
    kernel_max = mk.tile_max_scores_kernel(q, c, 256).double()
    route = next(r for r, n in mk.tile_max_scores_kernel.launches_by_route.items() if n > before[r])
    counts = mk.count_above_kernel(q, c, tau)
    plain = mk.count_above_plain(q, c, tau)
    t1, _t2 = mk.groupmax_kernel(q, c)
    near = ((exact - tau.double()[:, None]).abs() <= 2 * COUNT_MARGIN_REL * tau.abs().double()[:, None])
    clear_groups = ~near.view(B, -1, 256).any(dim=2)
    groups = mk.count_above_groups_kernel(q, c, tau, 256)
    plain_groups = mk.count_above_groups_plain(q, c, tau, 256)
    return {
        "D": D, "kind": kind, "route": route,
        "tile_max_err_kernel": (kernel_max - tile).abs().max().item(),
        "tile_max_err_plain": (mk.tile_max_scores_plain(q, c, 256).double() - tile).abs().max().item(),
        "max_score": tile.abs().max().item(),
        "counts_differing": int((counts != plain).sum()),
        "clear_thresholds": int(clear.sum()),
        "clear_counts_differing": int((counts != plain)[clear].sum()),
        "groupmax_err_kernel": (t1.double().T - exact.view(B, -1, 8).amax(2)).abs().max().item(),
        "clear_groups": int(clear_groups.sum()),
        "clear_group_counts_differing": int((groups != plain_groups)[clear_groups].sum()),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dims", type=int, nargs="+", default=[30522, 4098, 30528])
    parser.add_argument("--kinds", nargs="+", default=list(KINDS), choices=KINDS)
    parser.add_argument("--queries", type=int, default=256)
    parser.add_argument("--rows", type=int, default=1280, help="a multiple of 256")
    parser.add_argument("--k", type=int, default=100)
    args = parser.parse_args(argv)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for D in args.dims:
        for kind in args.kinds:
            out.append(case(kind, args.queries, args.rows, D, args.k, g, dev))
            print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
