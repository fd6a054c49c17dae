"""CLI: evo-style APE/RPE between two TUM trajectories.

Usage: python -m simpleslam_tpu_torch.eval GT_TUM EST_TUM [--delta N] [--no-align]
"""

import argparse

from .metrics import evaluate


def main() -> int:
    ap = argparse.ArgumentParser(description="APE/RPE between TUM files")
    ap.add_argument("gt")
    ap.add_argument("est")
    ap.add_argument("--delta", type=int, default=10, help="RPE frame delta")
    ap.add_argument("--max-diff", type=float, default=0.02)
    ap.add_argument("--no-align", action="store_true")
    args = ap.parse_args()
    a, r = evaluate(args.gt, args.est, delta=args.delta,
                    max_diff=args.max_diff, align=not args.no_align)
    print("APE:", a.row())
    print(f"RPE(delta={args.delta}):", r.row())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
