"""HMM driver (the port's ``examples/hmm_main.py``) — the reference's
`hmm/main.R`, `main-multinom.R`, and `main-multinom-semisup.R` in one
script: simulate → fit → posterior summary → state-recovery confusion
tables.

  python examples_torch/hmm_main.py                      # Gaussian K=2, T=500
  python examples_torch/hmm_main.py --variant multinom   # K=3, L=5
  python examples_torch/hmm_main.py --variant semisup    # K=4, L=9 Tayal-shaped
  python examples_torch/hmm_main.py --cpu --quick        # on the CPU, small budget
  python examples_torch/hmm_main.py --cpu --quick --plots-dir plots   # + PNGs
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _common import configure, host, print_summary, run_sampler, save_figure, standard_parser


def main() -> None:
    ap = standard_parser(__doc__, plots=True)
    ap.add_argument("--variant", choices=("gaussian", "multinom", "semisup"), default="gaussian")
    ap.add_argument("--T", type=int, default=500)
    args = ap.parse_args()
    cfg = configure(args)

    import torch

    from hhmm_tpu_torch._device import resolve_device
    from hhmm_tpu_torch.infer import confusion_matrix, greedy_relabel, init_chains
    from hhmm_tpu_torch.models import GaussianHMM, MultinomialHMM, SemisupMultinomialHMM
    from hhmm_tpu_torch.sim import hmm_sim, obsmodel_categorical, obsmodel_gaussian

    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)  # the simulation runs on the host
    if args.variant == "gaussian":
        # `hmm/main.R:7-11` shapes: sticky 2-state chain, separated means
        K = 2
        A = np.array([[0.9, 0.1], [0.2, 0.8]])
        p1 = np.array([0.5, 0.5])
        z, x = hmm_sim(gen, args.T, A, p1, obsmodel_gaussian(np.array([-1.0, 2.5]), np.array([0.6, 1.0])))
        model = GaussianHMM(K=K)
        data = {"x": x}
    elif args.variant == "multinom":
        # `hmm/main-multinom.R:7-27`: K=3, L=5
        K, L = 3, 5
        rng = np.random.default_rng(args.seed)
        A = np.array([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.15, 0.15, 0.7]])
        p1 = np.ones(K) / K
        phi = rng.dirichlet(np.ones(L) * 0.8, size=K)
        z, x = hmm_sim(gen, args.T, A, p1, obsmodel_categorical(phi))
        model = MultinomialHMM(K=K, L=L)
        data = {"x": x}
    else:
        # `hmm/main-multinom-semisup.R:7-41`: K=4, L=9, Tayal-shaped sparse A
        K, L = 4, 9
        rng = np.random.default_rng(args.seed)
        A = np.array(
            [[0.0, 0.4, 0.6, 0.0], [1.0, 0.0, 0.0, 0.0], [0.3, 0.0, 0.0, 0.7], [0.0, 0.0, 1.0, 0.0]]
        )
        p1 = np.array([0.5, 0.0, 0.5, 0.0])
        phi = rng.dirichlet(np.ones(L) * 1.5, size=K)
        z, x = hmm_sim(gen, args.T, A, p1, obsmodel_categorical(phi))
        groups = np.array([0, 1, 1, 0])
        model = SemisupMultinomialHMM(K=K, L=L, groups=groups, gate_mode="hard")
        data = {"x": x, "g": torch.as_tensor(groups)[z]}
    data = {k: v.to(dev) for k, v in data.items()}

    theta0 = init_chains(model, data, cfg.num_chains, seed=args.seed + 1, device=dev)
    qs, stats = run_sampler(None, theta0, cfg, args.seed + 2, dev, vg_fn=model.make_vg(data))
    print(f"divergence rate: {float(host(stats['diverging']).mean()):.4f}")
    print_summary(model.constrained_draws(qs))

    # state recovery (`hmm/main.R:89-101`): hard-classified filtered
    # states vs simulated truth, after greedy relabeling
    out = model.generated(qs[:, :: max(1, cfg.num_samples // 50)], data, device=dev)
    alpha = host(out["alpha"]).mean(axis=(0, 1))
    z_hat = alpha.argmax(axis=1)
    z_true = host(z)
    perm = greedy_relabel(z_true, z_hat, model.K)
    z_hat = perm[z_hat]
    print("filtered-state confusion (rows=true):")
    print(confusion_matrix(z_true, z_hat, model.K))
    print(f"filtered accuracy: {(z_hat == z_true).mean():.3f}")

    if args.plots_dir:
        from hhmm_tpu_torch.viz.plots import plot_statepath, plot_stateprobability

        fig = plot_stateprobability(
            out["alpha"].reshape(-1, *out["alpha"].shape[2:]),
            out["gamma"].reshape(-1, *out["gamma"].shape[2:]),
            z=z_true,
        )
        save_figure(fig, args.plots_dir, f"hmm_{args.variant}_stateprob.png")
        fig = plot_statepath(out["zstar"].reshape(-1, out["zstar"].shape[-1]), z=z_true)
        save_figure(fig, args.plots_dir, f"hmm_{args.variant}_statepath.png")


if __name__ == "__main__":
    main()
