"""CSIS (inference compilation) tests: structure discovery, training
convergence, guided ESS gains vs prior SIS, posterior correctness, and the
prior-fallback path — the end-to-end validation the reference only did
manually over two processes (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpprob_jax as ct
from cpprob_jax.core import handlers
from cpprob_jax.distributions import Normal, Uniform
from cpprob_jax.inference.csis import (
    CSIS,
    CSISProposalMessenger,
    discover_structure,
    init_csis_params,
    make_proposal_dist,
)
from cpprob_jax.models import (
    gaussian_posterior_analytic,
    gaussian_unknown_mean_readme,
    hmm,
    hmm_exact_posterior,
)


def test_discover_structure_gaussian():
    s = discover_structure(gaussian_unknown_mean_readme, (0.0, 0.0))
    assert [x.addr for x in s.sites] == ["mu"]
    assert s.sites[0].kind == "normal"
    assert s.observe_addrs == ("y1", "y2")
    assert s.obs_dim == 2


def test_discover_structure_hmm():
    s = discover_structure(hmm, (jnp.zeros(5),))
    assert len(s.sites) == 5
    assert s.sites[0].kind == "uniform_int"
    assert all(x.kind == "categorical" for x in s.sites[1:])
    assert s.obs_dim == 5


def test_uncontrolled_sites_excluded():
    def m(y):
        a = ct.sample(Normal(0.0, 1.0), addr="a", control=False)
        b = ct.sample(Normal(a, 1.0), addr="b")
        ct.observe(Normal(b, 1.0), y, addr="y")

    s = discover_structure(m, (0.0,))
    assert [x.addr for x in s.sites] == ["b"]


class TestGaussianCSIS:
    @pytest.fixture(scope="class")
    def engine_and_params(self):
        eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0))
        params, losses = eng.compile(
            jax.random.key(0), steps=300, batch_size=256
        )
        return eng, params, losses

    def test_training_converges(self, engine_and_params):
        _, _, losses = engine_and_params
        assert float(losses[-10:].mean()) < float(losses[0]) - 0.5

    def test_guided_beats_prior_ess(self, engine_and_params, key):
        eng, params, _ = engine_and_params
        res_g = eng.infer(params, (3.0, 4.0), 20_000, key)
        res_p = ct.sis(gaussian_unknown_mean_readme, (3.0, 4.0), 20_000, key)
        assert float(res_g.ess) > 1.5 * float(res_p.ess)

    def test_guided_posterior_correct(self, engine_and_params, key):
        eng, params, _ = engine_and_params
        res = eng.infer(params, (3.0, 4.0), 50_000, key)
        assert abs(float(res.mean("Mean")) - 2.32353) < 0.03
        assert abs(float(res.variance("Mean")) - 1.05882) < 0.05

    def test_guided_generalizes_across_observations(self, engine_and_params, key):
        """The network amortizes over observations: different y's give the
        right posterior without retraining."""
        eng, params, _ = engine_and_params
        res = eng.infer(params, (-1.0, 0.5), 50_000, key)
        mean, var = gaussian_posterior_analytic(
            [-1.0, 0.5], mu0=1.0, sigma0=1.5, sigma=2.0
        )
        assert abs(float(res.mean("Mean")) - float(mean)) < 0.04


class TestHMMCSIS:
    @pytest.fixture(scope="class")
    def engine_and_params(self):
        eng = CSIS(hmm, (jnp.zeros(6),))
        params, losses = eng.compile(
            jax.random.key(0), steps=300, batch_size=256
        )
        return eng, params

    def test_guided_ess_gain(self, engine_and_params, key):
        eng, params = engine_and_params
        obs = jnp.array([0.9, 0.8, -1.0, 0.0, 1.1, -0.8])
        res_g = eng.infer(params, (obs,), 10_000, key)
        res_p = ct.sis(hmm, (obs,), 10_000, key)
        assert float(res_g.ess) > 2.0 * float(res_p.ess)

    def test_guided_marginals_correct(self, engine_and_params, key):
        eng, params = engine_and_params
        obs = jnp.array([0.9, 0.8, -1.0, 0.0, 1.1, -0.8])
        res = eng.infer(params, (obs,), 30_000, key)
        exact = np.asarray(hmm_exact_posterior(obs))
        states = np.asarray(res.predicts["State"])
        w = np.asarray(res.normalized_weights)
        for t in range(6):
            for s in range(3):
                est = float(np.sum(w * (states[:, t] == s)))
                assert abs(est - exact[t, s]) < 0.04


def test_prior_fallback_on_unknown_address(key):
    """A model whose addresses don't match the trained structure must fall
    back to the prior with zero RN correction (cpprob.hpp:52-56)."""
    eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0))
    params = eng.init(jax.random.key(0))

    def other_model(y1, y2):
        mu = ct.sample(Normal(1.0, 1.5), addr="other_mu")  # unknown addr
        ct.observe(Normal(mu, 2.0), y1, addr="y1")
        ct.observe(Normal(mu, 2.0), y2, addr="y2")
        ct.predict(mu, "Mean")

    factory = eng.proposal_factory(params, (3.0, 4.0))
    res = ct.sis(other_model, (3.0, 4.0), 20_000, key,
                 proposal_messenger=factory)
    # falls back to prior => same estimator quality as plain SIS
    assert abs(float(res.mean("Mean")) - 2.32353) < 0.05


def test_uniform_proposal_family(key):
    """Uniform prior -> truncated-mixture-of-8-normals proposal
    (prior_distributions.py:59-65): samples stay in support."""

    def m(y):
        x = ct.sample(Uniform(-2.0, 3.0), addr="x")
        ct.observe(Normal(x, 0.3), y, addr="y")
        ct.predict(x, "X")

    eng = CSIS(m, (0.0,))
    params, _ = eng.compile(jax.random.key(0), steps=200, batch_size=128)
    res = eng.infer(params, (1.0,), 5_000, key)
    xs = np.asarray(res.predicts["X"])
    assert xs.min() >= -2.0 and xs.max() <= 3.0
    # posterior ~ N(1, 0.3) truncated; mean close to 1
    assert abs(float(res.mean("X")) - 1.0) < 0.1


def test_infer_falls_back_when_model_branches_on_args(key):
    """ADVICE r3 (low): the cached serving path traces args; a model doing
    Python control flow on arg VALUES must fall back to baking them in
    instead of raising ConcretizationTypeError."""
    def m(y, flag):
        mu = ct.sample(Normal(0.0, 2.0), addr="mu")
        if float(flag) > 0:  # Python branch on a traced arg -> fallback
            ct.observe(Normal(mu, 1.0), y, addr="y")
        else:
            ct.observe(Normal(mu, 4.0), y, addr="y")
        ct.predict(mu, "Mu")

    eng = CSIS(m, (0.0, 1.0))
    params, _ = eng.compile(jax.random.key(0), steps=20, batch_size=32)
    res = eng.infer(params, (2.0, 1.0), 500, key)
    assert np.isfinite(np.asarray(res.log_weights)).all()
    assert abs(float(res.mean("Mu"))) < 4.0


def test_infer_defensive_accepts_jnp_scalar(key):
    """ADVICE r3 (low): a jnp scalar defensive weight must not break the
    cache key."""
    eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0))
    params, _ = eng.compile(jax.random.key(0), steps=20, batch_size=32)
    res = eng.infer(
        params, (3.0, 4.0), 500, key, defensive=jnp.float32(0.2)
    )
    assert np.isfinite(np.asarray(res.log_weights)).all()


def test_csis_infer_is_jittable_end_to_end(key):
    eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0))
    params = eng.init(jax.random.key(0))
    factory = eng.proposal_factory(params, (3.0, 4.0))
    from cpprob_jax.inference.sis import make_particle_fn

    particle = make_particle_fn(
        gaussian_unknown_mean_readme, (3.0, 4.0), proposal_messenger=factory
    )
    log_w, predicts = jax.jit(jax.vmap(particle))(jax.random.split(key, 64))
    assert log_w.shape == (64,)
    assert np.all(np.isfinite(np.asarray(log_w)))


def test_masked_variable_structure(key):
    """Variable-size models = static-max + Mask (the static-shape replacement for the
    reference's address-sequence subbatching): masked-out sites must not
    contribute to training loss or inference weights."""
    from cpprob_jax.distributions import Poisson

    MAXN = 6

    def m(ys):
        n = 1 + ct.sample(Poisson(2.0), addr="n", control=False)
        n = jnp.minimum(n, MAXN)
        mu = ct.sample(Normal(0.0, 2.0), addr="mu")
        for i in range(MAXN):
            active = (i < n).astype(jnp.float32)
            with handlers.Mask(active):
                ct.observe(Normal(mu, 0.5), ys[i], addr=f"y[{i}]")
        ct.predict(mu, "Mu")

    eng = CSIS(m, (jnp.zeros(MAXN),))
    # masks recorded for the controlled site
    values, obs = eng._gen(jax.random.key(0), 32)
    assert "__masks__" in values
    params, losses = eng.compile(jax.random.key(0), steps=120, batch_size=128)
    assert float(losses[-1]) < float(losses[0])
    ys = jnp.full((MAXN,), 1.2)
    res = eng.infer(params, (ys,), 4000, key)
    assert np.isfinite(float(res.mean("Mu")))


def test_mdn_head_covers_bimodal_posterior(key):
    """y = x^2 + noise gives a bimodal posterior over x: the single-Gaussian
    head collapses to one mode; the mixture-density head must keep both."""

    def m(y):
        x = ct.sample(Normal(0.0, 2.0), addr="x")
        ct.observe(Normal(x * x, 0.5), y, addr="y")
        ct.predict(x, "X")

    # true posterior modes near +/- sqrt(4) = +/- 2 for y = 4
    eng = CSIS(m, (0.0,), mdn_components=5)
    assert eng.structure.sites[0].kind == "mdn"
    params, losses = eng.compile(jax.random.key(0), steps=400, batch_size=256)
    assert float(losses[-1]) < float(losses[0])
    res = eng.infer(params, (4.0,), 20_000, key)
    xs = np.asarray(res.predicts["X"])
    w = np.asarray(res.normalized_weights)
    frac_pos = float(np.sum(w * (xs > 0)))
    assert 0.15 < frac_pos < 0.85, f"mode collapse: frac_pos={frac_pos}"
    # posterior |x| concentrated near 2
    mean_abs = float(np.sum(w * np.abs(xs)))
    assert abs(mean_abs - 2.0) < 0.15
    # MDN guided ESS beats prior SIS
    res_p = ct.sis(m, (4.0,), 20_000, key)
    assert float(res.ess) > 2.0 * float(res_p.ess)


def test_truncated_prior_gets_proposal_head(key):
    """Truncated priors route to the truncated-mixture head (beyond the
    reference's 4-type parse set, infcomp/traits.py:28-34): the guided
    posterior must match 1-D quadrature and beat the prior-fallback ESS."""
    from cpprob_jax.distributions import Truncated

    def m(y):
        x = ct.sample(Truncated(Normal(0.0, 2.0), -1.0, 3.0), addr="x")
        ct.observe(Normal(x, 0.5), y, addr="y")
        ct.predict(x, "X")

    eng = CSIS(m, (0.0,))
    assert eng.structure.sites[0].kind == "uniform"  # bounded-support head
    params, losses = eng.compile(jax.random.key(3), steps=400, batch_size=256)
    assert float(losses[-1]) < float(losses[0])

    y_obs = 2.5
    res = eng.infer(params, (y_obs,), 20_000, key)
    # quadrature oracle
    xs = np.linspace(-1.0, 3.0, 20_001)
    post = np.exp(-0.5 * (xs / 2.0) ** 2) * np.exp(
        -0.5 * ((y_obs - xs) / 0.5) ** 2
    )
    post /= np.trapezoid(post, xs)
    true_mean = np.trapezoid(xs * post, xs)
    assert abs(float(res.mean("X")) - true_mean) < 0.05
    res_p = ct.sis(m, (y_obs,), 20_000, key)
    assert float(res.ess) > 2.0 * float(res_p.ess)


def test_mixture_prior_gets_mdn_head(key):
    """Mixture priors route to a mixture-density head sized to the prior."""
    from cpprob_jax.distributions import Mixture

    def m(y):
        z = ct.sample(
            Mixture(Normal(jnp.array([-2.0, 2.0]), jnp.array([0.5, 0.5])),
                    jnp.array([0.5, 0.5])),
            addr="z",
        )
        ct.observe(Normal(z, 0.5), y, addr="y")
        ct.predict(z, "Z")

    eng = CSIS(m, (0.0,))
    assert eng.structure.sites[0].kind == "mdn"
    params, losses = eng.compile(jax.random.key(4), steps=400, batch_size=256)
    assert float(losses[-1]) < float(losses[0])

    y_obs = 1.8
    res = eng.infer(params, (y_obs,), 20_000, key)
    zs = np.linspace(-5.0, 5.0, 40_001)
    prior = 0.5 * np.exp(-0.5 * ((zs + 2) / 0.5) ** 2) + 0.5 * np.exp(
        -0.5 * ((zs - 2) / 0.5) ** 2
    )
    post = prior * np.exp(-0.5 * ((y_obs - zs) / 0.5) ** 2)
    post /= np.trapezoid(post, zs)
    true_mean = np.trapezoid(zs * post, zs)
    assert abs(float(res.mean("Z")) - true_mean) < 0.08
    res_p = ct.sis(m, (y_obs,), 20_000, key)
    assert float(res.ess) > 2.0 * float(res_p.ess)


class TestInferMany:
    def test_batched_serving_matches_single(self, key):
        """infer_many scans B queries in one dispatch; each row must equal
        the single-query infer() for the same key (same cached program
        semantics), and posterior estimates must hit the oracle."""
        from cpprob_jax.models import gaussian_unknown_mean_readme

        eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0))
        params, _ = eng.compile(jax.random.key(0), steps=120, batch_size=32)
        keys = jax.random.split(jax.random.key(9), 4)
        many = eng.infer_many(params, (3.0, 4.0), 2000, keys)
        assert many.log_weights.shape == (4, 2000)
        single = eng.infer(params, (3.0, 4.0), 2000, keys[2])
        np.testing.assert_allclose(
            np.asarray(many.log_weights[2]), np.asarray(single.log_weights),
            rtol=1e-5)
        means = []
        for b in range(4):
            w = jax.nn.softmax(many.log_weights[b])
            means.append(float(jnp.sum(w * many.predicts["Mean"][b])))
        assert abs(np.mean(means) - 2.32353) < 0.15
