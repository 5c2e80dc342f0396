"""Runnable PIGS-style training demo (BASELINE.json config 4).

Fits a Gaussian field to a manufactured periodic Poisson problem with a PDE
residual + data loss, backpropagating through values, means and (via the
scale/rotation chain) covariances.  Uses the tiled pair kernels with
capacities from the host planner; one GPU, or the CPU (kernels in the Pallas
interpreter - small sizes only).

    python examples/train_pigs.py --gaussians 2000 --steps 200

For multi-chip, see dgs.parallel.mesh (make_sharded_pigs_step /
make_model_sharded_pigs_step) and ``chip_smoke.py --four-cards``.
"""

import argparse
import sys

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gaussians", type=int, default=2000)
    ap.add_argument("--dims", type=int, default=2, choices=(1, 2, 3))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--collocation", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--method", default="tiled",
                    choices=("tiled", "dense"))
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--metrics", default=None,
                    help="JSONL metrics path (optional)")
    ap.add_argument("--checkpoint", default=None,
                    help="save the final TrainState here (Orbax)")
    args = ap.parse_args()

    from dgs.config import SamplerConfig
    from dgs.models import pigs
    from dgs.utils.metrics import JsonlLogger

    cfg = SamplerConfig()
    logger = JsonlLogger(args.metrics) if args.metrics else JsonlLogger(
        stream=sys.stdout
    )
    state, history = pigs.train(
        cfg, P=args.gaussians, D=args.dims, steps=args.steps,
        n_collocation=args.collocation, learning_rate=args.lr,
        method=args.method, log_every=args.log_every, logger=logger,
    )
    if args.checkpoint:
        from dgs.utils import checkpoint

        checkpoint.save(args.checkpoint, state)
        print(f"saved TrainState to {args.checkpoint}")
    print(f"final loss: {history[-1]['loss']:.4f} "
          f"(pde {history[-1]['pde']:.4f}, data {history[-1]['data']:.6f})")


if __name__ == "__main__":
    main()
