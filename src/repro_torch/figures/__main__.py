"""The paper's four figure datasets and the two ablations on the port, at
a chosen scale.

    python -m repro_torch.figures --smoke --device cpu   # seconds, CPU
    python -m repro_torch.figures --paper                # §V scale, card
    python -m repro_torch.figures --paper --from-store   # JSONs, no run

Counterpart of ``examples/private_social_training.py`` (and of the figure
and ablation rows of ``benchmarks/run.py``): prints each figure's rows and
derived check, and writes ``fig2_privacy_coordinate.json``,
``fig3_topology.json``, ``fig4_sparsity.json``, ``fig5_nodes.json``,
``ablation_sparse_methods.json``, ``ablation_delay.json`` and
``BENCH_delay.json`` under ``--out``.
"""
from __future__ import annotations

import argparse

from repro_torch.figures import (ablation_delay, ablation_sparse_methods,
                                 fig2_privacy, fig3_topology, fig4_sparsity,
                                 fig5_nodes)
from repro_torch.figures.common import FIGURES, STORE, Scale


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.figures")
    ap.add_argument("--paper", action="store_true",
                    help="paper scale (100,000 samples, n=10,000, m=64)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny scale (n=64, m=8, T=120): seconds")
    ap.add_argument("--from-store", action="store_true",
                    help="regenerate the JSONs from the sweep store without "
                         "running")
    ap.add_argument("--out", default=FIGURES)
    ap.add_argument("--store", default=STORE)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.paper and args.smoke:
        ap.error("--paper and --smoke are mutually exclusive")
    scale = (Scale.paper() if args.paper
             else Scale.smoke() if args.smoke else Scale())
    kw = dict(out_dir=args.out, from_store=args.from_store,
              device=args.device, store=args.store)

    print(f"scale: n={scale.n} m={scale.m} T={scale.T} on {args.device}")
    print("\n[Fig 2] privacy level vs regret")
    r2 = fig2_privacy.run(scale, **kw)
    for eps, row in r2["rows"].items():
        print(f"  eps={eps:>5s}: regret={row['regret_final']:12.1f} "
              f"acc={row['accuracy']:.3f}")
    print("  ordering holds:", r2["ordering_holds"])

    print("\n[Fig 3] topology invariance")
    r3 = fig3_topology.run(scale, **kw)
    for topo, row in r3["rows"].items():
        print(f"  {topo:14s}: acc={row['accuracy']:.3f}")
    print(f"  spread={r3['spread']:.3f}")

    print("\n[Fig 4] sparsity sweep")
    r4 = fig4_sparsity.run(scale, **kw)
    for row in r4["rows"]:
        print(f"  lam={row['lambda']:7.3f} sparsity={row['sparsity']:.3f} "
              f"acc={row['accuracy']:.3f}")
    print("  interior optimum:", r4["interior_best"])

    print("\n[Fig 5] node-count sweep")
    r5 = fig5_nodes.run(scale, **kw)
    for row in r5["rows"]:
        print(f"  m={row['nodes']:3d}: acc={row['accuracy']:.3f}")
    print("  declines with m:", r5["declines"])

    print("\n[Ablation] sparse online learning methods")
    ra = ablation_sparse_methods.run(scale, **kw)
    for name, row in ra["rows"].items():
        print(f"  {name:26s} acc={row['accuracy']:.3f} "
              f"sparsity={row['sparsity']:.3f}")

    print("\n[Ablation] gossip delay")
    rd = ablation_delay.run(scale, delays=(ablation_delay.SMOKE_DELAYS
                                           if args.smoke
                                           else ablation_delay.DELAYS), **kw)
    for row in rd["bench"]["rows"]:
        print(f"  delay={row['delay']:3d}: acc={row['accuracy']:.3f} "
              f"regret/T={row['regret_per_round']:.4f}")
    print("  graceful degradation:", rd["graceful"])
    print(f"\nfigure data written to {args.out}/")
    return {"fig2": r2, "fig3": r3, "fig4": r4, "fig5": r5,
            "ablation_sparse_methods": ra, "ablation_delay": rd}


if __name__ == "__main__":
    main()
