"""Iterative No-U-Turn Sampler over a flat batch of lanes (counterpart of
``hhmm_tpu/infer/nuts.py``).

The JAX module writes one chain's transition as bounded
``lax.while_loop``s (tree doublings, then the leaves of a subtree) and
vmaps it over chains and series. Here :func:`nuts_step` takes every lane
at once (``q [N, dim]``, one lane a (series, chain) pair) and keeps the
semantics of that vmapped program:

- **Lockstep.** The host runs the doublings and leaves. A lane whose
  loop condition is false keeps its state (``torch.where(active, new,
  old)``); its leapfrog is still computed, from the frozen state, and
  thrown away, as a vmapped ``while_loop`` does. A non-finite position
  (a diverged lane's endpoint) is replaced by the transition's start
  before the log density sees it, and its log density read as NaN, so
  the value-and-grad kernels only ever get finite inputs.
- **Shared depth.** Every active lane is at the same depth ``d`` and
  the same leaf ``n`` of its subtree, so ``2^d``, the checkpoint range
  of leaf ``n`` (``popcount`` and trailing ones of ``n``) and whether
  it is even are host integers. The host reads one thing from the
  device, once a leaf: whether any lane is still active.
- **U-turn checks.** The JAX inner loop stops at the first turning
  checkpoint, so its result is "any checkpoint in ``[idx_min,
  idx_max]`` turns": one batched pass over that slice of the ``[N,
  max_depth, dim]`` checkpoints.
- **Randomness** comes from one source object (:class:`GeneratorDraws`
  by default): the momentum, and per depth the direction bit and the
  subtree-accept uniform, and per leaf the progressive-sampling
  uniform. A test can replay the JAX key splits through its own source.

Kept as in the JAX module: multinomial leaf weights, Betancourt's biased
progressive sampling across subtrees, the accept statistic (mean of
``min(1, exp(-ΔH))`` over the leaves) and Stan's divergence threshold
(ΔH > 1000).

Conventions: positions are unconstrained vectors, ``logp_fn(q [N, dim])
-> (logp [N], grad [N, dim])`` is the joint log density, kinetic energy
uses a diagonal inverse mass matrix ``[N, dim]``, step sizes are ``[N]``.
:func:`find_reasonable_step_size` is the single-point heuristic the
ChEES sampler uses; :func:`find_reasonable_step_size_batched` is its
lockstep form over lanes.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from hhmm_tpu_torch.robust.guards import guard_where

__all__ = [
    "NUTSInfo",
    "GeneratorDraws",
    "nuts_step",
    "find_reasonable_step_size",
    "find_reasonable_step_size_batched",
]

DELTA_MAX = 1000.0


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # [N] mean Metropolis accept prob over the trajectory
    num_leaves: torch.Tensor  # [N] int32, leapfrog steps this lane took
    diverging: torch.Tensor  # [N] bool
    energy: torch.Tensor  # [N] Hamiltonian -logp + kinetic at the accepted point
    depth: torch.Tensor  # [N] int32, tree depth reached
    # host counts of the lockstep run: log-density calls (every lane,
    # frozen ones included) and reads of "any lane active"
    lockstep_leapfrogs: int = 0
    host_syncs: int = 0


class GeneratorDraws:
    """The default randomness source: every draw from one
    ``torch.Generator``, in the order the tree asks for them."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def momentum(self, like: torch.Tensor) -> torch.Tensor:
        """Standard-normal ``[N, dim]``."""
        return torch.randn(like.shape, generator=self.generator, dtype=like.dtype, device=like.device)

    def tree(self, depth: int, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per lane at tree depth ``depth``: ``(go_right bool [N],
        subtree-accept uniform [N])``."""
        u = torch.rand((2, like.shape[0]), generator=self.generator, dtype=like.dtype,
                       device=like.device)
        return u[0] < 0.5, u[1]

    def leaf(self, depth: int, leaf: int, like: torch.Tensor) -> torch.Tensor:
        """Per lane: the progressive-sampling uniform of leaf ``leaf``."""
        return torch.rand((like.shape[0],), generator=self.generator, dtype=like.dtype,
                          device=like.device)


def _leapfrog(logp_fn: Callable, inv_mass, eps, q, p, grad):
    p = p + 0.5 * eps * grad
    q = q + eps * inv_mass * p
    logp, grad = logp_fn(q)
    p = p + 0.5 * eps * grad
    return q, p, logp, grad


def _kinetic(inv_mass: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(inv_mass * p * p, dim=-1)


def _finite_lp(logp_fn: Callable, q_safe: torch.Tensor) -> Callable:
    """``logp_fn`` over lanes, each non-finite position replaced by its
    lane's ``q_safe`` before the call and its log density set to NaN
    after (the divergence a non-finite position would give)."""

    def lp(q):
        ok = torch.isfinite(q).all(-1)
        logp, grad = logp_fn(torch.where(ok[:, None], q, q_safe))
        return torch.where(ok, logp, math.nan), grad

    return lp


def _is_turning(inv_mass, p_left, p_right, p_sum):
    """Generalized U-turn criterion (Betancourt; Stan appendix A.4.2
    form), over leading axes."""
    v_left = inv_mass * p_left
    v_right = inv_mass * p_right
    rho = p_sum - 0.5 * (p_left + p_right)
    return ((v_left * rho).sum(-1) <= 0) | ((v_right * rho).sum(-1) <= 0)


def _ckpt_idxs(n: int) -> Tuple[int, int]:
    """Checkpoint index range a new odd leaf ``n`` is tested against:
    ``idx_max`` = popcount(n >> 1), ``idx_min`` = idx_max − (trailing
    ones of n) + 1 (Phan et al. 2019's iterative bookkeeping)."""
    idx_max = bin(n >> 1).count("1")
    trailing_ones = bin(n & ~(n + 1)).count("1")
    return idx_max - trailing_ones + 1, idx_max


class _Subtree(NamedTuple):
    q: torch.Tensor  # moving endpoint
    p: torch.Tensor
    grad: torch.Tensor
    q_prop: torch.Tensor  # multinomial proposal
    logp_prop: torch.Tensor
    grad_prop: torch.Tensor
    energy_prop: torch.Tensor
    log_weight: torch.Tensor  # logsumexp of the leaves' weights (-H + H0)
    p_sum: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    num_leaves: torch.Tensor


class _Tree(NamedTuple):
    q_left: torch.Tensor
    p_left: torch.Tensor
    grad_left: torch.Tensor
    q_right: torch.Tensor
    p_right: torch.Tensor
    grad_right: torch.Tensor
    q_prop: torch.Tensor
    logp_prop: torch.Tensor
    grad_prop: torch.Tensor
    energy_prop: torch.Tensor
    log_weight: torch.Tensor
    p_sum: torch.Tensor
    depth: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    num_leaves: torch.Tensor


def _build_subtree(lp, draws, inv_mass, eps_signed, max_depth, depth, tree_active, q0, p0,
                   grad0, energy0, counts):
    """Expand up to ``2^depth`` leaves from ``(q0, p0)`` for the lanes in
    ``tree_active``, each lane stopping at its first U-turn or
    divergence. Returns the final :class:`_Subtree`, or None when no
    lane was active at all (``counts``: [leapfrogs, syncs], updated)."""
    N, dim = q0.shape
    zero = torch.zeros((N,), dtype=q0.dtype, device=q0.device)
    false = torch.zeros((N,), dtype=torch.bool, device=q0.device)
    s = _Subtree(q0, p0, grad0, q0, zero, grad0, energy0, torch.full_like(zero, -math.inf),
                 torch.zeros_like(q0), false, false, zero,
                 torch.zeros((N,), dtype=torch.int32, device=q0.device))
    p_ckpts = torch.zeros((N, max_depth, dim), dtype=q0.dtype, device=q0.device)
    p_sum_ckpts = torch.zeros_like(p_ckpts)
    for n in range(1 << depth):
        active = tree_active & ~(s.turning | s.diverging)
        counts[1] += 1
        if not bool(active.any()):
            return s if n else None
        counts[0] += 1
        q, p, logp, grad = _leapfrog(lp, inv_mass, eps_signed, s.q, s.p, s.grad)
        energy = -logp + _kinetic(inv_mass, p)
        delta = energy - energy0
        diverging = (delta > DELTA_MAX) | torch.isnan(delta)
        log_w = torch.where(diverging, -math.inf, -delta)
        accept = torch.nan_to_num(torch.clamp_max(torch.exp(-delta), 1.0), nan=0.0)

        # progressive multinomial sampling within the subtree
        new_log_weight = torch.logaddexp(s.log_weight, log_w)
        take_new = torch.log(draws.leaf(depth, n, q0)) < (log_w - new_log_weight)
        q_prop, logp_prop, grad_prop, energy_prop = guard_where(
            take_new, (q, logp, grad, energy), (s.q_prop, s.logp_prop, s.grad_prop, s.energy_prop)
        )
        p_sum = s.p_sum + p
        idx_min, idx_max = _ckpt_idxs(n)
        if n % 2 == 0:
            # even leaves only checkpoint; U-turn checks run on odd leaves
            p_ckpts[:, idx_max] = guard_where(active, p, p_ckpts[:, idx_max])
            p_sum_ckpts[:, idx_max] = guard_where(active, p_sum, p_sum_ckpts[:, idx_max])
            turning = false
        elif depth == 0:  # a 1-leaf subtree can't turn on itself
            turning = false
        else:
            ck = p_ckpts[:, idx_min : idx_max + 1]
            sub_sum = p_sum[:, None] - p_sum_ckpts[:, idx_min : idx_max + 1] + ck
            turning = _is_turning(inv_mass[:, None], ck, p[:, None], sub_sum).any(-1)
        s = guard_where(active, _Subtree(q, p, grad, q_prop, logp_prop, grad_prop, energy_prop,
                                         new_log_weight, p_sum, turning, diverging,
                                         s.sum_accept + accept, s.num_leaves + 1), s)
    return s


def nuts_step(
    logp_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    draws,
    q: torch.Tensor,
    logp: torch.Tensor,
    grad: torch.Tensor,
    step_size: torch.Tensor,
    inv_mass: torch.Tensor,
    max_treedepth: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, NUTSInfo]:
    """One NUTS transition of every lane: ``q [N, dim]``, ``logp [N]``,
    ``grad [N, dim]``, ``step_size [N]``, ``inv_mass [N, dim]``, with
    randomness from ``draws`` (:class:`GeneratorDraws` or a replay
    source with the same methods). Returns ``(q', logp', grad',
    NUTSInfo)``; every lane's ``q`` must be finite."""
    N = q.shape[0]
    lp = _finite_lp(logp_fn, q)
    p0 = draws.momentum(q) / torch.sqrt(inv_mass)
    energy0 = -logp + _kinetic(inv_mass, p0)
    zero = torch.zeros((N,), dtype=q.dtype, device=q.device)
    false = torch.zeros((N,), dtype=torch.bool, device=q.device)
    int0 = torch.zeros((N,), dtype=torch.int32, device=q.device)
    s = _Tree(q, p0, grad, q, p0, grad, q, logp, grad, energy0, zero, p0, int0, false, false,
              zero, int0)
    counts = [0, 0]  # leapfrogs, syncs
    for depth in range(max_treedepth):
        tree_active = ~(s.turning | s.diverging)
        go_right, u_accept = draws.tree(depth, q)
        eps_signed = torch.where(go_right, step_size, -step_size)[:, None]
        start = guard_where(go_right, (s.q_right, s.p_right, s.grad_right),
                            (s.q_left, s.p_left, s.grad_left))
        sub = _build_subtree(lp, draws, inv_mass, eps_signed, max_treedepth, depth, tree_active,
                             *start, energy0, counts)
        if sub is None:
            break
        complete = ~sub.turning & ~sub.diverging
        # biased progressive sampling across subtrees (Betancourt 2017)
        take_new = complete & (torch.log(u_accept) < (sub.log_weight - s.log_weight))
        q_prop, logp_prop, grad_prop, energy_prop = guard_where(
            take_new, (sub.q_prop, sub.logp_prop, sub.grad_prop, sub.energy_prop),
            (s.q_prop, s.logp_prop, s.grad_prop, s.energy_prop),
        )
        q_left, p_left, grad_left = guard_where(go_right, (s.q_left, s.p_left, s.grad_left),
                                                (sub.q, sub.p, sub.grad))
        q_right, p_right, grad_right = guard_where(go_right, (sub.q, sub.p, sub.grad),
                                                   (s.q_right, s.p_right, s.grad_right))
        p_sum = s.p_sum + sub.p_sum
        turning = sub.turning | (complete & _is_turning(inv_mass, p_left, p_right, p_sum))
        s = guard_where(tree_active, _Tree(
            q_left, p_left, grad_left, q_right, p_right, grad_right, q_prop, logp_prop,
            grad_prop, energy_prop, torch.logaddexp(s.log_weight, sub.log_weight), p_sum,
            s.depth + 1, turning, sub.diverging, s.sum_accept + sub.sum_accept,
            s.num_leaves + sub.num_leaves,
        ), s)
    info = NUTSInfo(
        accept_prob=s.sum_accept / torch.clamp_min(s.num_leaves, 1).to(q.dtype),
        num_leaves=s.num_leaves,
        diverging=s.diverging,
        energy=s.energy_prop,
        depth=s.depth,
        lockstep_leapfrogs=counts[0],
        host_syncs=counts[1],
    )
    return s.q_prop, s.logp_prop, s.grad_prop, info


def find_reasonable_step_size(
    logp_fn: Callable,
    inv_mass: torch.Tensor,
    q: torch.Tensor,
    logp: torch.Tensor,
    grad: torch.Tensor,
    generator: torch.Generator,
    init_step: float = 1.0,
) -> torch.Tensor:
    """Stan's init heuristic: double or halve ε until the one-step accept
    probability crosses 0.5 (at most 50 steps, ε within (1e-7, 1e7)).
    ``q [dim]``; returns ε as a 0-dim tensor on ``q``'s device. Runs on
    the host's control flow (one sync per probe), once per fit."""
    p0 = torch.randn(q.shape, generator=generator, dtype=q.dtype, device=q.device)
    p0 = p0 / torch.sqrt(inv_mass)
    energy0 = -logp + _kinetic(inv_mass, p0)
    log_half = math.log(0.5)

    def accept_logprob(eps: float) -> float:
        _, p1, logp1, _ = _leapfrog(logp_fn, inv_mass, eps, q, p0, grad)
        d = float(energy0 - (-logp1 + _kinetic(inv_mass, p1)))
        return -math.inf if math.isnan(d) else d

    a = accept_logprob(init_step)
    direction = 1.0 if a > log_half else -1.0
    eps, it = float(init_step), 0
    # the first condition reuses the probe at init_step (the JAX loop
    # evaluates it a second time, to the same value)
    while True:
        keep = a > log_half if direction > 0 else a < log_half
        if not (keep and it < 50 and 1e-7 < eps < 1e7):
            break
        eps *= 2.0 if direction > 0 else 0.5
        it += 1
        a = accept_logprob(eps)
    return torch.tensor(eps, dtype=q.dtype, device=q.device)


def find_reasonable_step_size_batched(
    logp_fn: Callable,
    inv_mass: torch.Tensor,
    q: torch.Tensor,
    logp: torch.Tensor,
    grad: torch.Tensor,
    z: torch.Tensor,
    init_step: float = 1.0,
) -> torch.Tensor:
    """:func:`find_reasonable_step_size` for every lane at once, as the
    JAX function vmapped over lanes: ``q``, ``grad``, ``inv_mass`` and
    the standard-normal momentum draws ``z`` are ``[N, dim]``, ``logp``
    ``[N]``; each lane doubles or halves its own ε in its own direction
    until its test fails. One log-density call over every lane a probe
    (a finished lane's probe is recomputed at its frozen ε and thrown
    away), one host sync a probe. Returns ε ``[N]``."""
    lp = _finite_lp(logp_fn, q)
    p0 = z / torch.sqrt(inv_mass)
    energy0 = -logp + _kinetic(inv_mass, p0)
    log_half = math.log(0.5)

    def accept_logprob(eps):
        _, p1, logp1, _ = _leapfrog(lp, inv_mass, eps[:, None], q, p0, grad)
        d = energy0 - (-logp1 + _kinetic(inv_mass, p1))
        return torch.where(torch.isnan(d), torch.full_like(d, -math.inf), d)

    eps = torch.full_like(logp, init_step)
    a = accept_logprob(eps)
    up = a > log_half
    factor = torch.where(up, torch.full_like(eps, 2.0), torch.full_like(eps, 0.5))
    active = torch.ones_like(up)
    # the first condition reuses the probe at init_step (the JAX loop
    # evaluates it a second time, to the same value)
    for _ in range(50):
        keep = torch.where(up, a > log_half, a < log_half)
        active = active & keep & (eps > 1e-7) & (eps < 1e7)
        if not bool(active.any()):
            break
        eps = torch.where(active, eps * factor, eps)
        a = accept_logprob(eps)
    return eps
