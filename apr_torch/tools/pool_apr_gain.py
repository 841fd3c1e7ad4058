"""Pool per-seed PAIRED lines from validate_apr_gain runs (the counterpart
of the root ``tools/pool_apr_gain.py``; it reads the logs of either
package's tool).

When repetitions run as separate invocations (``--seeds 1 --seed0 k``,
which makes partial progress durable), each prints its own PAIRED line per
eval distance.  This sums the discordant counts across runs and reprints
the pooled paired analysis (delta, Wald CI, exact McNemar): the same math
as the in-process pooling of ``--seeds N``.  Host only.

    python -m apr_torch.tools.pool_apr_gain log1.txt [log2.txt ...]
"""

import re
import sys

from apr_torch.tools.validate_apr_gain import mcnemar_exact_p, \
    paired_delta_ci

PAT = re.compile(
    r"PAIRED eval_dist=([\d.]+) apr=([\d.]+) baseline=([\d.]+) .*"
    r"discordant=(\d+)/(\d+) .* n=(\d+)")


def pool(lines):
    """Per distance: the summed discordant counts, pair count, recall
    sums and run count of the PAIRED lines among ``lines``."""
    acc = {}
    for line in lines:
        m = PAT.search(line)
        if not m:
            continue
        dist = float(m.group(1))
        apr, base = float(m.group(2)), float(m.group(3))
        n10, n01, n = int(m.group(4)), int(m.group(5)), int(m.group(6))
        a = acc.setdefault(dist, dict(n10=0, n01=0, n=0, apr=0.0, base=0.0,
                                      runs=0))
        a["n10"] += n10
        a["n01"] += n01
        a["n"] += n
        a["apr"] += apr * n
        a["base"] += base * n
        a["runs"] += 1
    return acc


def main(paths):
    lines = []
    for path in paths:
        with open(path) as f:
            lines.extend(f)
    out = []
    for dist, a in sorted(pool(lines).items()):
        d, lo, hi = paired_delta_ci(a["n01"], a["n10"], a["n"])
        p = mcnemar_exact_p(a["n01"], a["n10"])
        out.append(
            f"POOLED eval_dist={dist} runs={a['runs']} "
            f"apr={a['apr'] / a['n']:.3f} baseline={a['base'] / a['n']:.3f} "
            f"delta={d:+.3f} ci95=[{lo:+.3f},{hi:+.3f}] "
            f"discordant={a['n10']}/{a['n01']} mcnemar_p={p:.4f} "
            f"n={a['n']}")
        print(out[-1])
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
