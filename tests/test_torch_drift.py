"""The mean-field drift model (paper §IV-A) and the ISI tools (§IV-B) of
repro_torch against the JAX package.

Drift: the density, the quadrature and analytic drifts, the trajectories,
the equilibria and the paper's three numbers, float32 in both packages,
within rtol=1e-5 (the last bits of ``exp`` and of the trapezoid sums
differ; the quadrature drift at the tolerances its test gives, for the
grids differ by an ulp); the compensated RMSE is ~1e-8 in both (one-ulp windows), held
below 1e-6.  ISI tools: integer histograms, their CDF and the chosen depth,
exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import drift as JD
from repro.core import encoding as JE
from repro_torch.core import drift as TD
from repro_torch.core import encoding as TE

CPU = "cpu"


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=torch.float32)


# ---------------------------------------------------------------------------
# drift
# ---------------------------------------------------------------------------

def test_density_normalises():
    p = TD.DriftParams()
    x = torch.linspace(-80, 80, 64001)
    for w in (0.0, 0.3, 0.9):
        mass = float(torch.trapezoid(TD.density(x, torch.tensor(w), p), x))
        assert abs(mass - 1.0) < 5e-3


@pytest.mark.parametrize("w", [0.0, 0.3, 0.9])
def test_density_matches_reference(w):
    x = np.linspace(-30, 30, 6001, dtype=np.float32)
    want = np.asarray(JD.density(jnp.asarray(x), jnp.asarray(w), JD.DriftParams()))
    got = TD.density(_t(x), torch.tensor(w), TD.DriftParams()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_quadrature_matches_analytic():
    p = TD.DriftParams()
    w = torch.linspace(0.01, 0.99, 25)
    g_quad = TD.drift(w, TD.make_rule("exact", p), p)
    g_ana = TD.drift_analytic(w, "exact", p)
    np.testing.assert_allclose(g_quad.numpy(), g_ana.numpy(), atol=2e-3)


@pytest.mark.parametrize("rule", ["exact", "itp", "itp_nocomp", "linear", "imstdp"])
def test_drift_matches_reference(rule):
    """Quadrature drift.  ``torch.linspace`` and ``jnp.linspace`` place the
    x grid an ulp apart (ROADMAP queue 3), so g crosses zero at slightly
    other places: held at atol=1e-6.  The imstdp window is a step function of
    ⌊|x|⌋ and the grid hits its integer steps, where an ulp moves a point
    into the next LUT bin: the whole drift within 2e-4 (the band of the
    reference's quadrature-vs-analytic test is 2e-3), and on the reference's
    own grid the port's integrand and trapezoid agree within 1e-7."""
    jp, tp = JD.DriftParams(), TD.DriftParams()
    w = np.linspace(0.01, 0.99, 25, dtype=np.float32)
    want = np.asarray(JD.drift(jnp.asarray(w), JD.make_rule(rule, jp), jp))
    got = TD.drift(_t(w), TD.make_rule(rule, tp), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 if rule == "imstdp" else 1e-6)
    x = _t(jnp.linspace(jp.x_lo, jp.x_hi, jp.n_x))
    on_grid = torch.trapezoid(TD.make_rule(rule, tp)(x)[None, :]
                              * TD.density(x[None, :], _t(w)[:, None], tp), x, dim=-1)
    np.testing.assert_allclose(on_grid.numpy(), want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("rule", ["exact", "itp", "itp_nocomp"])
def test_drift_analytic_matches_reference(rule):
    w = np.linspace(0.0, 1.0, 801, dtype=np.float32)
    want = np.asarray(JD.drift_analytic(jnp.asarray(w), rule, JD.DriftParams()))
    got = TD.drift_analytic(_t(w), rule, TD.DriftParams()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_drift_analytic_rejects_rules_without_closed_form():
    with pytest.raises(ValueError, match="no closed form"):
        TD.drift_analytic(torch.tensor([0.5]), "linear", TD.DriftParams())


@pytest.mark.parametrize("rule", ["exact", "itp_nocomp"])
def test_iterate_matches_reference(rule):
    w0 = np.asarray([0.05, 0.2, 0.5, 0.8], np.float32)
    want = np.asarray(JD.iterate(jnp.asarray(w0), rule, JD.DriftParams(), n_steps=300))
    got = TD.iterate(_t(w0), rule, TD.DriftParams(), n_steps=300)
    assert got.shape == (301, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_iterate_quadrature_path_matches_reference():
    w0 = np.asarray([0.2, 0.6], np.float32)
    jp, tp = JD.DriftParams(n_x=2001), TD.DriftParams(n_x=2001)
    want = np.asarray(JD.iterate(jnp.asarray(w0), JD.make_rule("linear", jp), jp, n_steps=20))
    got = TD.iterate(_t(w0), TD.make_rule("linear", tp), tp, n_steps=20).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_update_curve_rmse_reproduces_paper():
    """Paper §IV-A: 9.4753 % RMSE for uncompensated ITP."""
    rmse = TD.update_curve_rmse(TD.DriftParams(), device=CPU)
    assert abs(rmse - 0.094753) < 5e-4
    assert rmse == pytest.approx(JD.update_curve_rmse(JD.DriftParams()), rel=1e-5)


def test_compensated_rmse_is_zero():
    assert TD.update_curve_rmse(TD.DriftParams(), "exact", "itp", device=CPU) < 1e-6


def test_compensated_dynamics_identical():
    """Fig. 5 left column: τ·ln2 compensation → identical trajectories."""
    p = TD.DriftParams()
    w0 = torch.tensor([0.2, 0.5, 0.8])
    np.testing.assert_allclose(TD.iterate(w0, "exact", p, n_steps=300).numpy(),
                               TD.iterate(w0, "itp", p, n_steps=300).numpy(), atol=1e-5)


@pytest.mark.parametrize("rule", ["exact", "itp_nocomp", "linear"])
def test_equilibrium_matches_reference(rule):
    kw = dict(n_grid=2001) if rule == "linear" else {}
    want = JD.equilibrium(rule, JD.DriftParams(), **kw)
    got = TD.equilibrium(rule, TD.DriftParams(), device=CPU, **kw)
    assert got == pytest.approx(want, rel=1e-5)


def test_equilibrium_is_stable_point():
    p = TD.DriftParams()
    for rule in ("exact", "itp_nocomp"):
        w_star = TD.equilibrium(rule, p, device=CPU)
        assert 0.0 < w_star < 1.0
        g = TD.drift_analytic(torch.tensor([w_star - 1e-3, w_star + 1e-3]), rule, p)
        assert float(g[0]) > 0 > float(g[1])


def test_convergence_time_matches_reference():
    w0 = np.linspace(0.1, 0.6, 10).astype(np.float32)
    traj = np.asarray(JD.iterate(jnp.asarray(w0), "exact", JD.DriftParams(), n_steps=800))
    np.testing.assert_array_equal(TD.convergence_time(_t(traj), 0.7756465),
                                  JD.convergence_time(jnp.asarray(traj), 0.7756465))


@pytest.mark.parametrize("n_steps", [400, 1500])
def test_paper_metrics_match_reference(n_steps):
    """The three §IV-A numbers (9.4753 % / 24.69 % / 7.36 % in the paper)."""
    want = JD.paper_metrics(n_steps=n_steps)
    got = TD.paper_metrics(n_steps=n_steps, device=CPU)
    assert set(got) == set(want)
    assert abs(got["update_curve_rmse"] - 0.094753) < 5e-4
    assert got["update_curve_rmse_compensated"] < 1e-6
    assert want["update_curve_rmse_compensated"] < 1e-6
    for k in set(want) - {"update_curve_rmse_compensated"}:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    if n_steps == 1500:
        assert 0.10 < got["equilibrium_rel_err"] < 0.40       # paper: 0.2469
        assert 0.02 < got["convergence_time_rel_err"] < 0.20  # paper: 0.0736


def test_metric_functions_default_to_cuda():
    if torch.cuda.is_available():
        return
    for call in (lambda: TD.update_curve_rmse(TD.DriftParams()),
                 lambda: TD.equilibrium("exact", TD.DriftParams()),
                 lambda: TD.paper_metrics(n_steps=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# ISI tools
# ---------------------------------------------------------------------------

def _raster(seed: int, p: float, shape) -> np.ndarray:
    return (np.random.default_rng(seed).random(shape) < p).astype(np.uint8)


def _same_stats(got, want) -> None:
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.cdf, want.cdf)
    assert got.n_spikes == want.n_spikes and got.n_intervals == want.n_intervals


@pytest.mark.parametrize("p,shape,max_isi", [(0.3, (200, 8), 64), (0.05, (300, 20), 64),
                                             (0.02, (400, 6), 16), (0.9, (50, 3), 64)])
def test_isi_tools_match_reference(p, shape, max_isi):
    s = _raster(int(p * 100) + shape[0], p, shape)
    want = JE.isi_histogram(jnp.asarray(s), max_isi=max_isi)
    _same_stats(TE.isi_histogram(torch.from_numpy(s), max_isi=max_isi), want)
    _same_stats(TE.isi_histogram_batched(torch.from_numpy(s), max_isi=max_isi),
                JE.isi_histogram_batched(jnp.asarray(s), max_isi=max_isi))
    _same_stats(TE.isi_histogram_batched(torch.from_numpy(s).bool(), max_isi=max_isi), want)
    for target in (0.5, 0.9, 0.99):
        assert TE.select_history_depth(TE.isi_histogram_batched(s, max_isi), target) == \
            JE.select_history_depth(want, target)
    for depth in (0, 1, 7, 100):
        assert TE.isi_histogram(s, max_isi).coverage(depth) == want.coverage(depth)


def test_isi_geometric_distribution():
    """Bernoulli(p) spikes → ISI ~ Geometric(p); depth-7 coverage 1-(1-p)^7."""
    stats = TE.isi_histogram_batched(_raster(1, 0.4, (5000, 16)))
    assert abs(stats.coverage(7) - (1 - 0.6 ** 7)) < 0.01


def test_depth_selection():
    s = jax.random.bernoulli(jax.random.PRNGKey(0), 0.5, (10_000, 32)).astype(jnp.uint8)
    stats = TE.isi_histogram_batched(torch.from_numpy(np.array(s)))
    assert TE.select_history_depth(stats, 0.99) == 7   # Geometric(0.5): coverage 0.9922


def test_empty_raster():
    stats = TE.isi_histogram_batched(torch.zeros((50, 4), dtype=torch.uint8))
    assert stats.n_intervals == 0 and stats.coverage(7) == 0.0
    assert TE.select_history_depth(stats) == 64
