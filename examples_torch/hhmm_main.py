"""HHMM driver (the port's ``examples/hhmm_main.py``) — the reference's
`hhmm/main.R` (2×2 hierarchical mixture) with the semisup fit its
missing Stan file was meant to run: build the tree, simulate from the
recursive engine, fit the hierarchy directly with TreeHMM, and report
parameter + top-state recovery.

  python examples_torch/hhmm_main.py
  python examples_torch/hhmm_main.py --tree fine1998
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _common import configure, host, print_summary, run_sampler, standard_parser


def main() -> None:
    ap = standard_parser(__doc__)
    ap.add_argument("--tree", choices=("hier2x2", "fine1998"), default="hier2x2")
    ap.add_argument("--T", type=int, default=500)
    ap.add_argument("--unsup", action="store_true", help="drop the group labels")
    args = ap.parse_args()
    cfg = configure(args)

    import torch

    from hhmm_tpu_torch._device import resolve_device
    from hhmm_tpu_torch.hhmm import compile_hhmm, fine1998_tree, hhmm_sim, hier2x2_tree, leaf_groups
    from hhmm_tpu_torch.infer import init_chains
    from hhmm_tpu_torch.models import TreeHMM

    dev = resolve_device(args.device)
    tree_fn = hier2x2_tree if args.tree == "hier2x2" else fine1998_tree
    tree = tree_fn()
    flat = compile_hhmm(tree)
    print(f"tree compiled: K={flat.K} leaves {flat.names}")
    print("flat pi:", np.round(flat.pi, 3))
    print("flat A:\n", np.round(flat.A, 3))

    rng = np.random.default_rng(args.seed)
    zleaf, x = hhmm_sim(tree, T=args.T, rng=rng)
    g = leaf_groups(tree)[zleaf]

    semisup = not args.unsup
    model = TreeHMM(tree_fn(), semisup=semisup, gate_mode="hard")
    data = {"x": torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)}
    if semisup:
        data["g"] = torch.as_tensor(np.asarray(g), device=dev)
    theta0 = init_chains(model, data, cfg.num_chains, seed=args.seed + 1, device=dev)
    qs, stats = run_sampler(None, theta0, cfg, args.seed + 2, dev, vg_fn=model.make_vg(data))
    print(f"divergence rate: {float(host(stats['diverging']).mean()):.4f}")
    print_summary(model.constrained_draws(qs), top=16)

    out = model.generated(qs[:, :: max(1, cfg.num_samples // 50)], data, device=dev)
    gamma = host(out["gamma"]).mean(axis=(0, 1))
    top_hat = np.asarray(model.groups)[gamma.argmax(axis=1)]
    top_true = leaf_groups(tree)[zleaf]
    print(f"top-state recovery: {(top_hat == top_true).mean():.3f}")


if __name__ == "__main__":
    main()
