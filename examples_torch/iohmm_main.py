"""IOHMM driver (the port's ``examples/iohmm_main.py``) — the reference's
`iohmm-reg/main.R` and `iohmm-mix/main.R`: simulate an input-driven HMM,
fit, summarize, relabel, and report state recovery.

  python examples_torch/iohmm_main.py                 # regression emissions
  python examples_torch/iohmm_main.py --variant hmix  # hierarchical mixture
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _common import configure, host, print_summary, run_sampler, save_figure, standard_parser


def main() -> None:
    ap = standard_parser(__doc__, plots=True)
    ap.add_argument("--variant", choices=("reg", "hmix"), default="reg")
    ap.add_argument("--T", type=int, default=300)
    args = ap.parse_args()
    cfg = configure(args)

    import torch

    from hhmm_tpu_torch._device import resolve_device
    from hhmm_tpu_torch.infer import confusion_matrix, greedy_relabel, init_chains
    from hhmm_tpu_torch.models import IOHMMHMix, IOHMMReg
    from hhmm_tpu_torch.sim import iohmm_sim, obsmodel_mix, obsmodel_reg

    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)  # the simulation runs on the host
    rng = np.random.default_rng(args.seed)
    if args.variant == "reg":
        # `iohmm-reg/main.R:10-22`: T=300, K=3, M=4
        K, M = 3, 4
        u = np.column_stack([np.ones(args.T), rng.normal(size=(args.T, M - 1))])
        w = rng.normal(size=(K, M)) * 1.5
        b = rng.normal(size=(K, M)) * 2.0
        sim = iohmm_sim(gen, u, w, obsmodel_reg(b, np.full(K, 0.4)))
        model = IOHMMReg(K=K, M=M)
    else:
        # `iohmm-mix/main.R:10-39`: K=4, L=3 hierarchical mixture
        from hhmm_tpu_torch.apps.hassan import DEFAULT_HYPERPARAMS

        K, M, L = 4, 4, 3
        u = np.column_stack([np.ones(args.T), rng.normal(size=(args.T, M - 1))])
        w = rng.normal(size=(K, M)) * 1.5
        lambdas = rng.dirichlet(np.ones(L), size=K)
        mu = np.sort(rng.normal(size=(K, L)) * 3.0, axis=1) + np.arange(K)[:, None] * 4.0
        sim = iohmm_sim(gen, u, w, obsmodel_mix(lambdas, mu, np.full((K, L), 0.5)))
        model = IOHMMHMix(K=K, M=M, L=L, hyperparams=DEFAULT_HYPERPARAMS)

    data = {"u": sim["u"].to(dev), "x": sim["x"].to(dev)}
    theta0 = init_chains(model, data, cfg.num_chains, seed=args.seed + 1, device=dev)
    qs, stats = run_sampler(None, theta0, cfg, args.seed + 2, dev, vg_fn=model.make_vg(data))
    print(f"divergence rate: {float(host(stats['diverging']).mean()):.4f}")
    print_summary(model.constrained_draws(qs))

    # greedy relabeling + confusion vs simulated states (`iohmm-reg/main.R:78-94`)
    out = model.generated(qs[:, :: max(1, cfg.num_samples // 50)], data, device=dev)
    alpha = host(out["alpha"]).mean(axis=(0, 1))
    z_true = host(sim["z"])
    z_hat = alpha.argmax(axis=1)
    perm = greedy_relabel(z_true, z_hat, model.K)
    z_hat = perm[z_hat]
    print("filtered-state confusion (rows=true):")
    print(confusion_matrix(z_true, z_hat, model.K))
    print(f"filtered accuracy: {(z_hat == z_true).mean():.3f}")

    if args.plots_dir:
        from hhmm_tpu_torch.viz.plots import plot_inputoutput

        fig = plot_inputoutput(sim["x"], sim["u"], z=z_true)
        save_figure(fig, args.plots_dir, f"iohmm_{args.variant}_inputoutput.png")


if __name__ == "__main__":
    main()
