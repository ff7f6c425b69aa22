"""Compile-mode keep-last rejection dedup (reference state.cpp:124-142) and
CSIS training on guard-based rejection models (thesis ch. 6.2 scenario).

The key property: traces extracted for NN training must record the
*accepted* draw of a rejection loop (the last occurrence per address inside
the guard), not pre-acceptance draws — a CSIS proposal trained on first
draws would learn the raw-proposal distribution instead of the accepted-draw
distribution.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cpprob_jax as ct
from cpprob_jax.core import handlers
from cpprob_jax.inference import nn
from cpprob_jax.inference.csis import CSIS, make_proposal_dist
from cpprob_jax.models import normal_rejection_sampling_guard


def _accept_gt1(x):
    return x > 1.0


def truncated_guard_model():
    """Draws x ~ N(0, 2) inside a guard, accepting only x > 1: the
    accepted-draw distribution is N(0,2) truncated to (1, inf)
    (mean ~2.283, std ~1.035) while the first-draw distribution is N(0, 2)."""
    x, _ = ct.guarded_rejection(
        ct.distributions.Normal(0.0, 2.0), _accept_gt1, addr="x", max_iters=16
    )
    ct.predict(x, "X")
    return x


# analytic moments of N(0, 2) truncated to x > 1
_ALPHA = 0.5
_LAMBDA = math.exp(-0.5 * _ALPHA**2) / math.sqrt(2 * math.pi) / (
    1 - 0.5 * (1 + math.erf(_ALPHA / math.sqrt(2)))
)
TRUNC_MEAN = 2.0 * _LAMBDA                       # ~2.283
TRUNC_STD = 2.0 * math.sqrt(1 + _ALPHA * _LAMBDA - _LAMBDA**2)  # ~1.035


class TestKeepLast:
    def test_trace_records_accepted_draw(self):
        """TraceHandler keeps ONE entry per guarded address — the accepted
        draw — with no @i suffixes (keep-last dedup)."""
        tr = handlers.TraceHandler()
        with handlers.Seed(jax.random.key(0)), tr:
            truncated_guard_model()
        names = [n for n in tr.trace if n.startswith("x")]
        assert names == ["x"], names
        assert float(tr.trace["x"]["value"]) > 1.0

    def test_batch_extraction_is_accepted_distribution(self):
        """Vectorized compile-mode trace extraction yields accepted-draw
        moments, not first-draw moments."""

        def one(key):
            tr = handlers.TraceHandler()
            with handlers.Seed(key), handlers.SimulateObserves(), tr:
                truncated_guard_model()
            return tr.trace["x"]["value"]

        xs = jax.vmap(one)(jax.random.split(jax.random.key(1), 4096))
        xs = np.asarray(xs)
        frac_accept = float((xs > 1.0).mean())
        assert frac_accept > 0.99  # P(no accept in 16) ~ 0.7^16 ~ 0.3%
        assert abs(xs.mean() - TRUNC_MEAN) < 0.1
        assert abs(xs.std() - TRUNC_STD) < 0.1

    def test_logweight_counts_accepted_rn_only(self):
        """Guided run: the guard contributes exactly one RN term — the
        accepted draw's (state.cpp:225-238)."""

        class ConstProposal(handlers.Messenger):
            def __init__(self, dist):
                self.dist = dist

            def process_message(self, msg):
                if (
                    msg["type"] == "sample"
                    and msg["control"]
                    and msg["proposal_dist"] is None
                    and msg["value"] is None
                ):
                    msg["proposal_dist"] = self.dist

        prior = ct.distributions.Normal(0.0, 2.0)
        prop = ct.distributions.Normal(2.0, 1.0)
        lw = handlers.LogWeight()
        tr = handlers.TraceHandler()
        with handlers.Seed(jax.random.key(3)), lw, ConstProposal(prop), tr:
            truncated_guard_model()
        x = tr.trace["x"]["value"]
        expected = prior.log_prob(x) - prop.log_prob(x)
        np.testing.assert_allclose(
            float(lw.log_weight), float(expected), rtol=1e-5
        )

    def test_guard_model_parity_sis(self):
        """normal_rejection_sampling_guard's posterior matches the analytic
        conjugate posterior (models.hpp:82-112 semantics: the guard simulates
        the N(1, sqrt5) prior)."""
        res = ct.sis(
            normal_rejection_sampling_guard, (8.0, 9.0), 40_000,
            jax.random.key(0),
        )
        mu = np.asarray(res.predicts["Mu"])
        w = np.asarray(res.normalized_weights)
        mean = float((w * mu).sum())
        var = float((w * (mu - mean) ** 2).sum())
        # thesis variant: mu | y ~ N(7.25, 5/6)
        assert abs(mean - 7.25) < 0.1
        assert abs(var - 5.0 / 6.0) < 0.15


class TestCSISOnGuard:
    def test_trained_proposal_matches_accepted_distribution(self):
        """CSIS trained on the guard model converges to the accepted-draw
        (truncated) distribution: mean/std near (2.28, 1.04), NOT the
        first-draw N(0, 2)."""
        eng = CSIS(truncated_guard_model, ())
        params, losses = eng.compile(
            jax.random.key(0), steps=1500, batch_size=128, unroll=25,
            learning_rate=3e-3,
        )
        assert float(losses[-1]) < float(losses[0])

        spec = eng.structure.sites[0]
        assert spec.addr == "x" and spec.kind == "normal"
        msgr = eng.proposal_factory(params, ())()
        h, _ = msgr._first_step
        raw = nn.mlp_apply(params["heads"][spec.pkey], h)
        prop = make_proposal_dist(spec, raw)
        mean = float(prop.loc)
        std = float(prop.scale)
        # accepted-draw distribution, not the first-draw N(0, 2)
        assert abs(mean - TRUNC_MEAN) < 0.4, (mean, TRUNC_MEAN)
        assert std < 1.5, std
        assert mean > 1.5  # far from the first-draw mean 0

    def test_guided_inference_runs_guard(self):
        """Guided SIS through the guard: proposal cached per address, ESS
        far above prior-SIS on a tail region."""
        eng = CSIS(truncated_guard_model, ())
        params, _ = eng.compile(
            jax.random.key(1), steps=1500, batch_size=128, unroll=25,
            learning_rate=3e-3,
        )
        res = eng.infer(params, (), 2000, jax.random.key(2))
        x = np.asarray(res.predicts["X"])
        w = np.asarray(res.normalized_weights)
        mean = float((w * x).sum())
        assert abs(mean - TRUNC_MEAN) < 0.35
