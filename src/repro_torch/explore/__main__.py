"""CLI: ``python -m repro_torch.explore --config nid_mlp --quick``.

Runs the design-space sweep on the card (CUDA; the build raises without
one) and prints the headline numbers; the full record lands in
``--out-dir`` (default ``experiments/explore_torch/``).
"""

from __future__ import annotations

import argparse
import json

from repro_torch.explore.explorer import ExploreConfig, explore


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="nid_mlp",
                    choices=("nid_mlp", "cnv_quick"))
    ap.add_argument("--quick", action="store_true",
                    help="3x3 corner grid + fast autotune phase (CI smoke)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default="experiments/explore_torch")
    ap.add_argument("--no-cache-phase", action="store_true",
                    help="skip the cold/warm autotune comparison")
    args = ap.parse_args(argv)

    batch = args.batch if args.batch is not None else (256 if args.quick else 1024)
    cfg = ExploreConfig(
        config=args.config, quick=args.quick, batch=batch, reps=args.reps,
        seed=args.seed, out_dir=args.out_dir,
        cache_phase=not args.no_cache_phase)
    rec = explore(cfg)

    front = {p["point_id"]: p for p in rec["points"] if p["pareto"]}
    print(json.dumps({
        "name": rec["name"],
        "n_points": rec["n_points"],
        "pareto_front": rec["pareto_front"],
        "bit_exact": rec["bit_exact"],
        "s_per_cycle": rec["calibration"].get("s_per_cycle"),
        "model_error_p90": rec.get("model_error_p90"),
        "cache_speedup": rec.get("cache_speedup"),
        "path": rec.get("path"),
    }, indent=2))
    for pid, p in front.items():
        print(f"# pareto {pid}: {p['samples_per_s']:.0f} samples/s, "
              f"lut={p['lut_bytes']} ff={p['ff_bytes']} bram={p['bram_bytes']}")
    if rec.get("cache"):
        c = rec["cache"]
        print(f"# autotune cache: cold {c['cold_wall_s']:.2f}s -> warm "
              f"{c['warm_wall_s']:.2f}s ({c['cache_speedup']:.1f}x, "
              f"{c['warm_hits']} hits / {c['warm_misses']} misses)")
    return rec


if __name__ == "__main__":
    main()
