"""Mean-field synaptic drift model (port of ``repro.core.drift``; paper §IV-A,
eqs. 21-27, Table I).

Validates the dynamics of ITP-STDP against original STDP:

    w_{t+1} = Π_[0,1]( w_t + η·g(w_t) ),      g(w) = ∫ F(x) p(x|w) dx

with the spike-timing-difference mixture density

    p(x|w) = (1-ρ(w))·Laplace(x; b) + ρ(w)·Exp(x; μ(w), a(w))
    μ(w) = m0 + m1·w,   a(w) = a0 + a1·w,   ρ(w) = αw / (1+βw)

F is the weight-update rule under test (exact eq. 17 vs ITP eq. 20).  The
paper's numbers: RMSE(update curves) = 9.4753 %, equilibrium shift
24.69 %, convergence-time error 7.36 % for uncompensated ITP-STDP.

float32 throughout, as the reference; ``lax.scan`` is a loop.  Tensors
follow their inputs' device; the functions that make their own grids take
``device`` (default ``"cuda"``, resolved by ``repro_torch.device``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.stdp import STDPParams, get_rule
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DriftParams:
    """Table I of the paper."""

    b: float = 5.8         # background Laplace scale
    alpha: float = 0.58    # mixing coefficient numerator
    beta: float = 4.2      # mixing coefficient denominator
    m0: float = 0.0        # base causal delay
    m1: float = 4.5        # weight-dependent causal delay
    a0: float = 0.5        # base causal scale
    a1: float = 4.0        # weight-dependent causal scale
    eta: float = 0.2       # learning rate
    stdp: STDPParams = dataclasses.field(default_factory=STDPParams)
    # integration window: ±10 steps for the drift integral (eq. 22), ±20 for
    # the update-curve RMSE, the conventions that reproduce the paper
    x_lo: float = -10.0
    x_hi: float = 10.0
    n_x: int = 8001


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def density(x: torch.Tensor, w: torch.Tensor, p: DriftParams) -> torch.Tensor:
    """p(x | w) — eqs. 23-27.  Broadcasts x against w."""
    x = _f32(x)
    w = _f32(w, x.device)
    rho = p.alpha * w / (1.0 + p.beta * w)
    p_bg = torch.exp(-torch.abs(x) / p.b) / (2.0 * p.b)
    mu = p.m0 + p.m1 * w
    a = p.a0 + p.a1 * w
    p_c = torch.where(x >= mu, torch.exp(-(x - mu) / a) / a, 0.0)
    return (1.0 - rho) * p_bg + rho * p_c


def drift(w: torch.Tensor, rule: Callable[[torch.Tensor], torch.Tensor],
          p: DriftParams) -> torch.Tensor:
    """g(w) = E[Δw | w] via trapezoidal quadrature on the x grid (eq. 22)."""
    w = torch.atleast_1d(_f32(w))
    x = torch.linspace(p.x_lo, p.x_hi, p.n_x, dtype=torch.float32, device=w.device)
    f = rule(x)                                        # (n_x,)
    pw = density(x[None, :], w[:, None], p)            # (n_w, n_x)
    return torch.trapezoid(f[None, :] * pw, x, dim=-1)


def make_rule(name: str, p: DriftParams) -> Callable[[torch.Tensor], torch.Tensor]:
    base = get_rule(name)
    return lambda x: base(x, p.stdp)


_LN2 = float(np.log(2.0))


def _effective_taus(rule_name: str, s: STDPParams) -> tuple[float, float]:
    """Effective base-e time constants of the exponential rule family."""
    if rule_name == "exact" or rule_name == "itp":       # itp w/ comp ≡ exact
        return s.tau_plus, s.tau_minus
    if rule_name == "itp_nocomp":                         # 2^(-x/τ)=e^(-x/(τ/ln2))
        return s.tau_plus / _LN2, s.tau_minus / _LN2
    raise ValueError(f"no closed form for rule {rule_name!r}")


def drift_analytic(w: torch.Tensor, rule_name: str, p: DriftParams) -> torch.Tensor:
    """Closed-form g(w) for exponential rules on the truncated window (exact
    for ``exact`` / ``itp`` / ``itp_nocomp``; no quadrature noise)."""
    s = p.stdp
    tp, tm = _effective_taus(rule_name, s)
    X = float(p.x_hi)
    w = torch.atleast_1d(_f32(w))
    rho = p.alpha * w / (1.0 + p.beta * w)
    mu = p.m0 + p.m1 * w
    a = p.a0 + p.a1 * w

    lam_p = 1.0 / tp + 1.0 / p.b
    lam_m = 1.0 / tm + 1.0 / p.b
    i_bg = float((s.a_plus / (2 * p.b)) * (1 - np.exp(-lam_p * X)) / lam_p
                 - (s.a_minus / (2 * p.b)) * (1 - np.exp(-lam_m * X)) / lam_m)

    lam_c = 1.0 / tp + 1.0 / a
    i_c = s.a_plus * torch.exp(-mu / tp) \
        * (1 - torch.exp(-lam_c * torch.clamp(X - mu, min=0.0))) / (a * lam_c)
    i_c = torch.where(mu < X, i_c, 0.0)
    return (1.0 - rho) * i_bg + rho * i_c


def iterate(w0: torch.Tensor, rule: Callable[[torch.Tensor], torch.Tensor] | str,
            p: DriftParams, n_steps: int = 400) -> torch.Tensor:
    """Weight trajectory under eq. 21, ``(n_steps+1, n_w)``.

    ``rule`` may be a callable F(x) (quadrature path) or a rule name with a
    closed form ('exact' / 'itp' / 'itp_nocomp', analytic path).
    """
    w = torch.atleast_1d(_f32(w0))
    if isinstance(rule, str):
        g_fn = lambda w: drift_analytic(w, rule, p)
    else:
        g_fn = lambda w: drift(w, rule, p)
    traj = [w]
    for _ in range(n_steps):
        w = torch.clamp(w + p.eta * g_fn(w), 0.0, 1.0)
        traj.append(w)
    return torch.stack(traj)


# ---------------------------------------------------------------------------
# Paper §IV-A metrics
# ---------------------------------------------------------------------------

def update_curve_rmse(p: DriftParams, rule_a: str = "exact",
                      rule_b: str = "itp_nocomp",
                      x_lo: float = -20.0, x_hi: float = 20.0,
                      n: int = 4001, *, device: torch.device | str = "cuda") -> float:
    """RMSE between two update curves F(x) on a symmetric window (±20: the
    paper's 9.4753 % for exact vs uncompensated ITP; 0 with compensation)."""
    x = torch.linspace(x_lo, x_hi, n, dtype=torch.float32, device=resolve_device(device))
    fa = make_rule(rule_a, p)(x)
    fb = make_rule(rule_b, p)(x)
    return float(torch.sqrt(torch.mean((fa - fb) ** 2)))


def equilibrium(rule_name: str, p: DriftParams, n_grid: int = 8001, *,
                device: torch.device | str = "cuda") -> float:
    """Largest stable fixed point of g (root with + → − sign change); the
    analytic drift for exponential rules.  A flow that never crosses reports
    the boundary it pushes to."""
    dev = resolve_device(device)
    w = np.linspace(0.0, 1.0, n_grid)
    wt = _f32(w, dev)
    if rule_name in ("exact", "itp", "itp_nocomp"):
        g = drift_analytic(wt, rule_name, p).cpu().numpy()
    else:
        g = drift(wt, make_rule(rule_name, p), p).cpu().numpy()
    s = np.sign(g)
    idx = np.where((s[:-1] > 0) & (s[1:] <= 0))[0]
    if idx.size == 0:
        return 0.0 if g[-1] < 0 else 1.0
    i = idx[-1]
    x0, x1, y0, y1 = w[i], w[i + 1], g[i], g[i + 1]
    if y1 == y0:
        return float(x0)
    return float(x0 - y0 * (x1 - x0) / (y1 - y0))


def convergence_time(traj: torch.Tensor, w_star: float, tol: float = 0.01) -> np.ndarray:
    """First step where |w_t − w*| < tol and stays there; per trajectory."""
    t = (torch.abs(traj - w_star) < tol).cpu().numpy()    # (T+1, n_w)
    T = t.shape[0]
    not_conv = ~t
    times = np.full(t.shape[1], T, np.int64)
    for j in range(t.shape[1]):
        nz = np.where(not_conv[:, j])[0]
        times[j] = (nz[-1] + 1) if nz.size else 0
    return times


def paper_metrics(p: DriftParams | None = None, n_steps: int = 2000,
                  w0s: np.ndarray | None = None, *,
                  device: torch.device | str = "cuda") -> dict:
    """The three §IV-A numbers: curve RMSE, equilibrium shift, conv-time error.

    Protocol: curve RMSE on ±20; drift window ±10; trajectories start in
    [0.1, 0.6], tol=0.01, 2000 steps.
    """
    dev = resolve_device(device)
    p = p or DriftParams()
    w0s = w0s if w0s is not None else np.linspace(0.1, 0.6, 10)

    rmse = update_curve_rmse(p, device=dev)
    eq_exact = equilibrium("exact", p, device=dev)
    eq_itp = equilibrium("itp_nocomp", p, device=dev)
    eq_err = abs(eq_itp - eq_exact) / max(abs(eq_exact), 1e-9)

    traj_e = iterate(_f32(w0s, dev), "exact", p, n_steps)
    traj_i = iterate(_f32(w0s, dev), "itp_nocomp", p, n_steps)
    t_e = convergence_time(traj_e, eq_exact)
    t_i = convergence_time(traj_i, eq_itp)
    conv_err = float(np.mean(np.abs(t_i - t_e) / np.maximum(t_e, 1)))

    # compensated ITP must match exactly
    rmse_comp = update_curve_rmse(p, "exact", "itp", device=dev)
    return {
        "update_curve_rmse": float(rmse),
        "update_curve_rmse_compensated": float(rmse_comp),
        "equilibrium_exact": float(eq_exact),
        "equilibrium_itp_nocomp": float(eq_itp),
        "equilibrium_rel_err": float(eq_err),
        "convergence_time_rel_err": conv_err,
        "conv_time_exact_mean": float(np.mean(t_e)),
        "conv_time_itp_mean": float(np.mean(t_i)),
    }
