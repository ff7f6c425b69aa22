#!/usr/bin/env python
"""Smoke run of cpprob_jax on one NVIDIA GPU: the main paths through the
public entry points at full size, each result checked against an exact
oracle, and the fused SMC kernel against its plain XLA version.

    python chip_smoke.py               # one card: every phase
    python chip_smoke.py --four-cards  # four cards: the sharded phase only
    python chip_smoke.py --rehearse    # CPU, tiny sizes, kernel interpreted

Everything runs in this one process (a second JAX process on the card
would find its memory taken).  Lines before the last give the card's name
and power limit, every timing with the card beside it, and every oracle
check.  Any failed check raises, so the script exits non-zero and prints
no result line.  The last line is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

FULL = dict(hmm_n=1 << 26, user_n=1 << 24, lg_n=1 << 24, sis_n=1 << 22,
            csis_T=16, csis_batch=256, csis_steps=20, csis_n=65536,
            csis_queries=8, same_bits_K=(3, 5, 12), user_K=(5, 12),
            cli_model="hmm",
            sherpa_bins=(35, 35, 20), sherpa_deposits=4096, sherpa_steps=6,
            sherpa_batch=32, reps=5, multi_n=1 << 26, multi_sis_n=1 << 26,
            multi_csis=64, multi_seeds=4)
TINY = dict(hmm_n=1 << 12, user_n=1 << 12, lg_n=1 << 12, sis_n=1 << 12,
            csis_T=2, csis_batch=16, csis_steps=3, csis_n=1024,
            csis_queries=2, same_bits_K=(3,), user_K=(5,),
            cli_model="gaussian",
            sherpa_bins=(4, 4, 3), sherpa_deposits=16, sherpa_steps=2,
            sherpa_batch=4, reps=4, multi_n=4096, multi_sis_n=4096,
            multi_csis=8, multi_seeds=4)
T = 16
FLOOR = 0.02  # nats, as in __graft_entry__.dryrun_multichip


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU at tiny sizes, Pallas kernel in interpret mode")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase, on four devices")
    ap.add_argument("--seed", type=int, default=0, help="workload seed")
    return ap.parse_args(argv)


class Smoke:
    def __init__(self, args, card):
        import jax

        self.jax = jax
        self.args = args
        self.sz = TINY if args.rehearse else FULL
        self.kernel_kw = {"interpret": True} if args.rehearse else {}
        dev = jax.devices()[0]
        self.where = f"{dev.device_kind} [{card}]"

    def log(self, msg):
        print(msg, flush=True)

    def check(self, name, ok, detail):
        self.log(f"check {name}: {'ok' if ok else 'FAILED'} ({detail})")
        if not ok:
            raise AssertionError(f"{name}: {detail}")

    def timed(self, fn, *a):
        """Compile and warm ``fn``, then time ``reps`` calls, each on the
        next key and ending in ``block_until_ready``; returns (median
        seconds, outputs of the timed calls)."""
        jax = self.jax
        jax.block_until_ready(fn(jax.random.key(self.args.seed + 999), *a))
        times, outs = [], []
        for i in range(self.sz["reps"]):
            key = jax.random.key(self.args.seed + i)
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(key, *a))
            times.append(time.perf_counter() - t0)
            outs.append(out)
        import numpy as np

        return float(np.median(times)), outs

    def train_rate(self, eng, steps, batch, lr=1e-3):
        """``eng.compile`` one step per dispatch; the rate counts the steps
        after the first, whose time includes compilation."""
        import numpy as np

        stamps = []
        params, losses = eng.compile(
            self.jax.random.key(self.args.seed + 2), steps=steps,
            batch_size=batch, learning_rate=lr,
            log_fn=lambda loss, n: stamps.append(time.perf_counter()))
        rate = (len(stamps) - 1) * batch / max(stamps[-1] - stamps[0], 1e-9)
        return params, np.asarray(losses), rate

    def evidence_check(self, name, log_zs, exact):
        import numpy as np

        lz = np.asarray(log_zs, np.float64)
        se = lz.std(ddof=1) / np.sqrt(len(lz))
        tol = 4 * se + FLOOR
        self.check(name, abs(lz.mean() - exact) < tol,
                   f"logZ {lz.mean():.5f} vs exact {exact:.5f}, "
                   f"tol 4*SE+{FLOOR} = {tol:.5f}, seeds {len(lz)}")

    # -- phases ----------------------------------------------------------

    def hmm_sweeps(self):
        """3-state HMM SMC at full width: the fused kernel at chunk=16 with
        and without islands, and the plain XLA step at chunk=1."""
        jax = self.jax
        import jax.numpy as jnp
        import numpy as np

        from cpprob_jax.inference.smc import build_smc_run
        from cpprob_jax.models import (
            HMM_MEANS,
            HMM_TRANS,
            discrete_hmm_log_evidence,
            hmm_ssm,
        )
        from cpprob_jax.ops.pallas_ssm import make_fused_discrete_ssm

        n = self.sz["hmm_n"]
        obs = simulate_hmm(HMM_TRANS, HMM_MEANS, np.ones(3),
                           np.full(3, 1 / 3), T, self.args.seed)
        exact = discrete_hmm_log_evidence(HMM_TRANS, HMM_MEANS, np.ones(3),
                                          np.full(3, 1 / 3), obs)
        obs = jnp.asarray(obs, jnp.float32)
        configs = [
            ("kernel chunk=16 island_every=8",
             make_fused_discrete_ssm(HMM_TRANS, HMM_MEANS, island_every=8,
                                     **self.kernel_kw), 16),
            ("kernel chunk=16 island_every=0",
             make_fused_discrete_ssm(HMM_TRANS, HMM_MEANS, **self.kernel_kw),
             16),
            ("xla hmm_ssm chunk=1", hmm_ssm, 1),
        ]
        for i, (label, model, chunk) in enumerate(configs):
            run = jax.jit(lambda k, o, m=model, c=chunk: build_smc_run(
                m, n, ess_threshold=0.5, chunk=c)(k, o).log_evidence)
            if i == 0:
                compiled = run.lower(jax.random.key(0), obs).compile()
                self.log(f"memory_analysis HMM sweep ({label}, n={n}): "
                         f"{compiled.memory_analysis()}")
            t, lzs = self.timed(run, obs)
            self.log(f"time HMM sweep {label}: n={n} T={T} median "
                     f"{t * 1e3:.3f} ms over {self.sz['reps']} runs = "
                     f"{n * T / t:.4g} particle-steps/s on {self.where}")
            self.evidence_check(f"HMM evidence, {label}", lzs, exact)

    def same_bits(self):
        """The compiled kernel against its plain XLA reference on the same
        random bits at real widths: fused init, then a chunk with a forced
        exchange resample, without and with tile islands.

        Both chunks start from the same population and the same ticks, taken
        from the reference's integer state counts: ticks each side derived
        from its own float-summed category weights can differ by one slot,
        which moves one particle's chunk-start state and, once the coupled
        chains meet again, leaves only its log-weight apart.  Without
        islands every decision then uses the same integers and floats in
        both, so states are identical and log-weights agree to 1e-5
        relative (libdevice vs XLA exp/log only touch the partials).  With
        islands, a tile's resample ticks come from float sums whose order
        differs between a Triton block reduction and XLA's; a tick within
        rounding of an integer moves one particle's state, so a few
        particles in 10^5 may differ there."""
        jax = self.jax
        import jax.numpy as jnp
        import numpy as np

        from cpprob_jax.models import HMM_MEANS, HMM_TRANS
        from cpprob_jax.ops.pallas_ssm import make_fused_discrete_ssm

        for K in self.sz["same_bits_K"]:
            n = self.sz["hmm_n" if K == 3 else "user_n"]
            spec = ((HMM_TRANS, HMM_MEANS, np.ones(3), np.full(3, 1 / 3))
                    if K == 3 else user_spec(K))
            ys = jnp.asarray(simulate_hmm(*spec, T, self.args.seed + K),
                             jnp.float32)

            def init(model, key):
                return model.fused_init_batch(key, n, ys[0])[:2]

            def chunk(model, key, s0, w0, ticks):
                out = model.fused_chunk_exchange_batch(
                    key, s0, w0, ys[1:], jnp.int32(T - 1), jnp.int32(1),
                    ticks, partials=True)
                return out.states, out.log_weights, out.partials

            for island_every in (0, 8):
                kw = dict(island_every=island_every, island_thresh=0.9)
                kern = make_fused_discrete_ssm(*spec, **kw, **self.kernel_kw)
                ref = make_fused_discrete_ssm(*spec, reference=True, **kw)
                k0, k1 = jax.random.split(
                    jax.random.key(self.args.seed + 100 + K))
                a = jax.jit(lambda k: init(kern, k))(k0)
                b = jax.jit(lambda k: init(ref, k))(k0)
                # both chunks start from the same population and ticks
                # (see the docstring)
                ref_cat_w = jnp.bincount(b[0], length=K) / n
                ticks = jnp.clip(jnp.ceil(n * jnp.cumsum(ref_cat_w)[:-1]
                                          - 0.5), 0, n).astype(jnp.int32)
                a += jax.jit(lambda k: chunk(kern, k, *b, ticks))(k1)
                b += jax.jit(lambda k: chunk(ref, k, *b, ticks))(k1)
                mism = [int(jnp.sum(a[i] != b[i])) for i in (0, 2)]
                # relative to the weight's magnitude, at least 1 nat: a
                # weight reset to a tile's log-mean can sit near 0
                off = [int(jnp.sum(jnp.abs(a[i] - b[i]) > 1e-5 * jnp.maximum(
                    jnp.abs(b[i]), 1.0))) for i in (1, 3)]
                rel = max(float(jnp.max(jnp.abs(a[i] - b[i]) / jnp.maximum(
                    jnp.abs(b[i]), 1.0))) for i in (1, 3))
                fired = float(jnp.sum(a[4][:, 3 + K]))
                if island_every:
                    ok = max(mism + off) <= 1e-5 * n
                    limit = f"at most {1e-5 * n:.0f} particles may differ"
                else:
                    ok = mism == [0, 0] and rel <= 1e-5
                    limit = "none may differ"
                self.check(
                    f"kernel vs same-bits XLA reference K={K} n={n} "
                    f"island_every={island_every}", ok,
                    f"state mismatches init/chunk {mism}, log-weights off "
                    f"by > 1e-5 relative {off}, max relative difference "
                    f"{rel:.3g}; {limit}; islands fired {fired:.0f}")

    def user_specs(self):
        """User spec HMMs (5 states, 12 states) through the fused sweep."""
        jax = self.jax
        import jax.numpy as jnp

        from cpprob_jax.inference.smc import build_smc_run
        from cpprob_jax.models import discrete_hmm_log_evidence
        from cpprob_jax.ops.pallas_ssm import make_fused_discrete_ssm

        n = self.sz["user_n"]
        for K in self.sz["user_K"]:
            spec = user_spec(K)
            obs = simulate_hmm(*spec, T, self.args.seed + K)
            exact = discrete_hmm_log_evidence(*spec, obs)
            model = make_fused_discrete_ssm(*spec, island_every=8,
                                            **self.kernel_kw)
            run = jax.jit(lambda k, o, m=model: build_smc_run(
                m, n, chunk=16)(k, o).log_evidence)
            t, lzs = self.timed(run, jnp.asarray(obs, jnp.float32))
            self.log(f"time user {K}-state HMM sweep (kernel chunk=16 "
                     f"island_every=8): n={n} median {t * 1e3:.3f} ms = "
                     f"{n * T / t:.4g} particle-steps/s on {self.where}")
            self.evidence_check(f"user {K}-state HMM evidence", lzs, exact)

    def linear_gaussian(self):
        """Scalar linear-Gaussian SSM: ct.smc with live ESS-triggered
        resampling, the no-history sweep, and the continuous resample
        epoch alone."""
        jax = self.jax
        import jax.numpy as jnp
        import numpy as np

        import cpprob_jax as ct
        from cpprob_jax.inference.resampling import (
            continuous_resample_values_lme,
        )
        from cpprob_jax.inference.smc import build_smc_run
        from cpprob_jax.models import kalman_filter_1d, linear_gaussian_ssm

        n = self.sz["lg_n"]
        rng = np.random.RandomState(self.args.seed + 3)
        obs = jnp.asarray(rng.normal(0.0, 1.1, size=T), jnp.float32)
        exact = float(kalman_filter_1d(obs)[2])

        def with_history(key, obs):
            r = ct.smc(linear_gaussian_ssm, obs, n, key, jit=False)
            return r.log_evidence, jnp.sum(r.resampled)

        run_h = jax.jit(with_history)
        t, outs = self.timed(run_h, obs)
        epochs = [int(e) for _, e in outs]
        self.log(f"time LG ct.smc (history kept): n={n} T={T} median "
                 f"{t * 1e3:.3f} ms, resample epochs per run {epochs} "
                 f"on {self.where}")
        self.check("LG resampling live", min(epochs) >= 1,
                   f"epochs {epochs}")
        self.evidence_check("LG ct.smc evidence vs Kalman",
                            [z for z, _ in outs], exact)
        run = jax.jit(lambda k, o: build_smc_run(
            linear_gaussian_ssm, n)(k, o).log_evidence)
        t, lzs = self.timed(run, obs)
        self.log(f"time LG sweep (no history, sorted-fill epochs): n={n} "
                 f"median {t * 1e3:.3f} ms on {self.where}")
        self.evidence_check("LG sweep evidence vs Kalman", lzs, exact)

        k1, k2 = jax.random.split(jax.random.key(self.args.seed + 7))
        states = jax.random.normal(k1, (n,))
        log_w = 2.0 * jax.random.normal(k2, (n,))
        epoch = jax.jit(continuous_resample_values_lme)
        t, outs = self.timed(epoch, log_w, states)
        self.log(f"time XLA continuous resample epoch (sort + scatter + "
                 f"cummax + logsumexp): n={n} median {t * 1e3:.3f} ms "
                 f"on {self.where}")
        w = np.exp(np.asarray(log_w, np.float64) - float(jnp.max(log_w)))
        w /= w.sum()
        sv = np.asarray(states, np.float64)
        target = float((w * sv).sum())
        se = float(np.sqrt((w * (sv - target) ** 2).sum() / n))
        got = float(np.mean(np.asarray(outs[0][0], np.float64)))
        self.check("continuous epoch moments", abs(got - target) < 6 * se,
                   f"resampled mean {got:.5f} vs weighted {target:.5f} "
                   f"(6 SE = {6 * se:.5f})")
        lme = float(outs[0][1])
        want = float(np.log(np.mean(np.exp(np.asarray(log_w, np.float64)))))
        self.check("continuous epoch evidence increment",
                   abs(lme - want) < 1e-4 * max(1.0, abs(want)),
                   f"{lme:.6f} vs {want:.6f}")

    def sis_phase(self):
        jax = self.jax
        import numpy as np

        import cpprob_jax as ct
        from cpprob_jax.models import gaussian_unknown_mean_readme

        n = self.sz["sis_n"]

        def run(key):
            r = ct.sis(gaussian_unknown_mean_readme, (3.0, 4.0), n, key,
                       jit=False)
            return r.mean("Mean"), r.variance("Mean"), r.ess

        t, outs = self.timed(jax.jit(run))
        self.log(f"time SIS conjugate Gaussian: n={n} median "
                 f"{t * 1e3:.3f} ms on {self.where}")
        mean, var, ess = (float(x) for x in outs[0])
        se_m = np.sqrt(1.05882 / ess)
        se_v = 1.05882 * np.sqrt(2.0 / ess)
        self.check("SIS posterior mean", abs(mean - 2.32353) < 4 * se_m
                   + 1e-3, f"{mean:.5f} vs 2.32353 (ESS {ess:.0f})")
        self.check("SIS posterior variance", abs(var - 1.05882) < 4 * se_v
                   + 1e-3, f"{var:.5f} vs 1.05882")

    def csis_phase(self):
        """CSIS on the T=16 HMM: training steps, guided inference per
        query and batched, and the CLI compile -> csis round trip."""
        jax = self.jax
        import jax.numpy as jnp
        import numpy as np

        from cpprob_jax import cli
        from cpprob_jax.inference.csis import CSIS
        from cpprob_jax.models import (
            HMM_MEANS,
            HMM_TRANS,
            hmm,
            hmm_exact_posterior,
        )

        precision = jax.config.jax_default_matmul_precision
        self.log("CSIS matmul precision: jax_default_matmul_precision="
                 f"{precision!r} (None: XLA's default, TF32 for float32 "
                 "products on this card); oracles are float64 numpy")
        obs = jnp.asarray(simulate_hmm(HMM_TRANS, HMM_MEANS, np.ones(3),
                                       np.full(3, 1 / 3), self.sz["csis_T"],
                                       self.args.seed + 11), jnp.float32)
        eng = CSIS(hmm, (obs,))
        steps, batch = self.sz["csis_steps"], self.sz["csis_batch"]
        params, losses, rate = self.train_rate(eng, steps, batch)
        self.log(f"time CSIS.compile: {steps} steps of batch {batch}, "
                 f"{rate:.4g} traces/s after the first (compiling) step on "
                 f"{self.where}; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
        self.check("CSIS losses finite", bool(np.isfinite(losses).all()),
                   f"{losses.tolist()}")
        n = self.sz["csis_n"]
        t, outs = self.timed(lambda k: eng.infer(params, (obs,), n, k))
        self.log(f"time CSIS.infer: n={n} median {t * 1e3:.3f} ms = "
                 f"{n / t:.4g} guided traces/s on {self.where}")
        self.posterior_check("CSIS.infer", outs[0], hmm_exact_posterior(obs))
        q = self.sz["csis_queries"]
        keys = jax.random.split(jax.random.key(5), q)
        many = eng.infer_many(params, (obs,), n, keys)
        jax.block_until_ready(many.log_weights)
        t0 = time.perf_counter()
        many = jax.block_until_ready(
            eng.infer_many(params, (obs,), n, keys))
        dt = time.perf_counter() - t0
        self.log(f"time CSIS.infer_many: {q} queries x n={n} in "
                 f"{dt * 1e3:.3f} ms = {q * n / dt:.4g} guided traces/s on "
                 f"{self.where}")
        first = jax.tree_util.tree_map(lambda x: x[0], many)
        self.posterior_check("CSIS.infer_many", first,
                             hmm_exact_posterior(obs))

        # the CLI's hmm model is the reference CLI's, of length 10; the
        # rehearsal takes the two-site conjugate Gaussian to stay short
        model = self.sz["cli_model"]
        if model == "hmm":
            obs_cli = simulate_hmm(HMM_TRANS, HMM_MEANS, np.ones(3),
                                   np.full(3, 1 / 3), 10,
                                   self.args.seed + 12)
            obs_arg = "[" + " ".join(f"{y:.6f}" for y in obs_cli) + "]"
        else:
            obs_arg = "3.0 4.0"
        with tempfile.TemporaryDirectory() as ckpt:
            rc = cli.main(["--model", model, "-m", "compile", "--steps",
                           str(max(1, steps // 4)), "--batch-size", str(batch),
                           "--ckpt-dir", ckpt, "-o", obs_arg])
            self.check(f"CLI compile ({model})", rc == 0, f"exit {rc}")
            rc = cli.main(["--model", model, "-m", "csis", "--ckpt-dir",
                           ckpt, "-n", str(n), "-o", obs_arg])
            self.check(f"CLI csis ({model})", rc == 0, f"exit {rc}")

    def posterior_check(self, name, res, exact):
        import numpy as np

        states = np.asarray(res.predicts["State"])
        w = np.asarray(res.normalized_weights, np.float64)
        ess = 1.0 / np.sum(w * w)
        worst = 0.0
        for t in range(exact.shape[0]):
            for s in range(3):
                est = float(np.sum(w * (states[:, t] == s)))
                p = exact[t, s]
                tol = 4 * np.sqrt(max(p * (1 - p), 1e-4) / ess) + 0.01
                worst = max(worst, abs(est - p) / tol)
        self.check(f"{name} posterior marginals vs hmm_exact_posterior",
                   worst < 1.0, f"worst |est-exact|/tol {worst:.3f}, "
                   f"ESS {ess:.0f}")

    def sherpa_phase(self):
        """A few CNN3D-embedded CSIS training steps at the full volume."""
        import importlib.util

        import numpy as np

        spec = importlib.util.spec_from_file_location(
            "sherpa_fullscale",
            os.path.join(REPO, "examples", "sherpa_fullscale.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        bins = self.sz["sherpa_bins"]
        eng, _ = mod.build_engine(bins, self.sz["sherpa_deposits"])
        steps, batch = self.sz["sherpa_steps"], self.sz["sherpa_batch"]
        _, losses, rate = self.train_rate(eng, steps, batch, lr=2e-3)
        self.log(f"time SHERPA CNN3D CSIS training: volume {bins}, "
                 f"{steps} steps of batch {batch}, {rate:.4g} traces/s after "
                 f"the first (compiling) step on {self.where} (float32 "
                 f"convolutions at XLA's default precision)")
        self.check("SHERPA losses finite", bool(np.isfinite(losses).all()),
                   f"{losses.tolist()}")

    def external_phase(self):
        """The traced external-simulator bridge (host callback) under
        jit + vmap with the device in the loop."""
        jax = self.jax
        import jax.numpy as jnp
        import numpy as np

        from cpprob_jax.external import SubprocessSimulator, observe_external

        child = ("import sys\nprint('ready 2', flush=True)\n"
                 "for line in sys.stdin:\n"
                 "    x = [float(v) for v in line.split()]\n"
                 "    print(2 * x[0] + 1, x[0] * x[1], flush=True)\n")
        with SubprocessSimulator([sys.executable, "-c", child], 2) as sim:
            f = jax.jit(jax.vmap(
                lambda x: jnp.sum(observe_external(sim, x, 2) * 2.0)))
            xs = jax.random.normal(jax.random.key(3), (256, 2))
            got = np.asarray(f(xs))
        xs = np.asarray(xs, np.float64)
        want = 2.0 * ((2 * xs[:, 0] + 1) + xs[:, 0] * xs[:, 1])
        self.check("external simulator bridge under jit+vmap",
                   np.allclose(got, want, rtol=1e-5, atol=1e-5),
                   f"max |diff| {np.max(np.abs(got - want)):.3g} over "
                   f"{len(xs)} events")

    def gpu_tests(self):
        """The tests marked ``gpu``, in this process."""
        import pytest

        class Tally:
            passed = failed = skipped = 0

            def pytest_runtest_logreport(self, report):
                if report.failed:
                    Tally.failed += 1
                elif report.when == "call" and report.passed:
                    Tally.passed += 1
                elif report.skipped:
                    Tally.skipped += 1

        os.environ["CPPROB_GPU_TESTS"] = "1"
        rc = pytest.main(
            ["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
             os.path.join(REPO, "tests", "test_pallas.py"),
             os.path.join(REPO, "tests", "test_gpu_hw.py")],
            plugins=[Tally()])
        on_card = not self.args.rehearse
        self.check("gpu-marked tests", int(rc) == 0 and Tally.failed == 0
                   and (Tally.passed > 0 or not on_card),
                   f"exit {int(rc)}, passed {Tally.passed}, failed "
                   f"{Tally.failed}, skipped {Tally.skipped}")

    def four_cards(self):
        import __graft_entry__

        t0 = time.perf_counter()
        out = __graft_entry__.dryrun_multichip(
            4, n_per_device=self.sz["multi_n"],
            sis_per_device=self.sz["multi_sis_n"],
            csis_per_device=self.sz["multi_csis"],
            seeds=self.sz["multi_seeds"], one_card=True,
            interpret=self.args.rehearse)
        self.log(f"four-card phase: {len(out)} checks passed in "
                 f"{time.perf_counter() - t0:.1f} s on {self.where}")


def user_spec(K):
    """The user HMMs: a fixed asymmetric 5-state chain, and a random
    12-state chain (seeded)."""
    import numpy as np

    if K == 5:
        trans = np.array([[0.50, 0.20, 0.10, 0.10, 0.10],
                          [0.05, 0.60, 0.20, 0.10, 0.05],
                          [0.10, 0.10, 0.40, 0.30, 0.10],
                          [0.20, 0.05, 0.05, 0.50, 0.20],
                          [0.10, 0.10, 0.10, 0.10, 0.60]])
        return (trans, np.array([-2.0, -1.0, 0.0, 1.0, 2.0]),
                np.array([0.5, 1.0, 0.7, 1.2, 0.9]),
                np.array([0.3, 0.1, 0.2, 0.2, 0.2]))
    rng = np.random.default_rng(K)
    return (rng.dirichlet(np.ones(K), size=K), np.linspace(-3.0, 3.0, K),
            np.linspace(0.5, 1.6, K), np.full(K, 1.0 / K))


def simulate_hmm(trans, means, stds, init, T, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    z = rng.choice(len(init), p=init)
    ys = []
    for _ in range(T):
        ys.append(means[z] + stds[z] * rng.standard_normal())
        z = rng.choice(len(init), p=trans[z])
    return np.asarray(ys, np.float64)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_cards:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4").strip()
    import jax

    from cpprob_jax.util.compile_cache import enable_compile_cache
    from cpprob_jax.util.profiling import card_name_and_power_limit, \
        env_versions

    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
        card = "no card: CPU rehearsal"
    else:
        card = card_name_and_power_limit()
        if card == "unavailable" or jax.default_backend() != "gpu":
            print(f"chip_smoke: no NVIDIA GPU (backend "
                  f"{jax.default_backend()!r}, nvidia-smi: {card})",
                  file=sys.stderr)
            return 1
    n_cards = 4 if args.four_cards else 1
    if len(jax.devices()) < n_cards:
        print(f"chip_smoke: needs {n_cards} devices, found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 1
    print(f"card: {card}", flush=True)
    if not args.rehearse:
        print(f"compile cache: {enable_compile_cache()}", flush=True)
    print(f"versions: {json.dumps(env_versions())}", flush=True)

    smoke = Smoke(args, card)
    if args.four_cards:
        phases = [smoke.four_cards]
    else:
        phases = [smoke.hmm_sweeps, smoke.same_bits, smoke.user_specs,
                  smoke.linear_gaussian, smoke.sis_phase, smoke.csis_phase,
                  smoke.sherpa_phase, smoke.external_phase, smoke.gpu_tests]
    t_all = time.perf_counter()
    for phase in phases:
        t0 = time.perf_counter()
        smoke.log(f"== phase {phase.__name__}")
        phase()
        smoke.log(f"== phase {phase.__name__} done in "
                  f"{time.perf_counter() - t0:.1f} s")
    smoke.log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
