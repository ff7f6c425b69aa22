"""External black-box simulator demo — compile -> guided inference against an
out-of-process event generator (the reference's SHERPA workflow shape,
``src/models/sherpa.cpp:29-86``: sample decay channel + kinematics, run an
external generator, ABC-observe the calorimeter response, predict channel).

Run with no arguments: spawns ITSELF with ``--simulator`` as the external
generator child (a numpy-only toy calorimeter in its own process — the
parent never imports its physics), then

1. trains a static-structure CSIS proposal whose prior-trace generation runs
   THROUGH the child from inside jitted code (``observe_external``
   pure-callback seam), plus a ``DynamicCSIS`` eager proposal (the
   reference's §3.2 per-trace execution model),
2. runs three inference legs on a held-out event: prior-SIS (traced),
   guided-CSIS (TRACED: the CSIS messenger under jit/vmap with the child in
   the loop — one pipelined exchange per site per population), and
   guided-CSIS (eager per-particle messenger) — each timed, so the
   batched-pipeline claim is *measured* against the per-particle path,
3. GATES (assertions, full mode): channel recovery on every leg, mean
   guided/prior ESS ratio > 1 over seeds, and continuous-latent (energy)
   posterior error vs truth bounded — then writes EXTERNAL_BRIDGE.json.

Usage: python examples/external_simulator.py [--traces 4000] [--particles 2048]
"""

import argparse
import json
import os
import sys

# ---------------------------------------------------------------------------
# Child process: the "external" generator.  numpy only — deliberately NOT a
# JAX model; the parent treats it as an opaque executable.
# ---------------------------------------------------------------------------

GRID = 8
OBS_DIM = GRID * GRID
N_CHANNELS = 3


def simulator_main():
    import numpy as np

    # EXTSIM_SEED makes the child reproducible (gate stability); default is
    # per-process randomness, as a real external generator would have
    seed = os.environ.get("EXTSIM_SEED")
    rng = np.random.default_rng(int(seed) if seed else os.getpid())
    # channel-specific shower shapes: blob center (row, col) and width
    centers = [(2.0, 2.0), (5.0, 5.0), (2.0, 5.0)]
    widths = [0.9, 1.4, 0.7]
    yy, xx = np.mgrid[0:GRID, 0:GRID]

    sys.stdout.write(f"ready {OBS_DIM}\n")
    sys.stdout.flush()
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        ch = int(float(parts[0]))
        energy = float(parts[1])
        cy, cx = centers[ch % N_CHANNELS]
        w = widths[ch % N_CHANNELS]
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * w * w))
        mean = energy * blob / blob.sum()
        deposits = rng.poisson(mean).astype(np.float32)
        sys.stdout.write(" ".join(str(v) for v in deposits.ravel()) + "\n")
        sys.stdout.flush()


# ---------------------------------------------------------------------------
# Parent: probabilistic program wrapping the child
# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", type=int, default=4000)
    ap.add_argument("--particles", type=int, default=2048)
    ap.add_argument("--seeds", type=int, default=8,
                    help="independent inference repeats for the ESS-ratio "
                         "and energy-error gates")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    full_mode = args.traces >= 2000  # gates need statistical resolution

    repo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    sys.path.insert(0, repo)

    # honor JAX_PLATFORMS=cpu even when JAX was imported before this line
    if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        import jax as _jax

        _jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    import cpprob_jax as ct
    from cpprob_jax.core import observe, predict, sample
    from cpprob_jax.distributions import Uniform, UniformInt, make_abc
    from cpprob_jax.external import SubprocessSimulator, observe_external
    from cpprob_jax.inference.csis_dynamic import DynamicCSIS, sis_host

    os.environ.setdefault("EXTSIM_SEED", "7")  # reproducible gates
    sim = SubprocessSimulator(
        [sys.executable, os.path.abspath(__file__), "--simulator"], OBS_DIM
    )

    def abc_logpdf(simulated):
        """Poisson-ish per-voxel ABC tolerance (sherpa.cpp:61 uses
        Var = value; here Var = max(simulated, 1))."""
        def logpdf(observed):
            var = jnp.maximum(simulated, 1.0)
            d = observed - simulated
            return jnp.sum(-0.5 * d * d / var - 0.5 * jnp.log(2 * jnp.pi * var))
        return logpdf

    def model_eager(observed):
        """Eager model body: calls the external process directly (the
        reference's execution model — one live trace, one generator call)."""
        ch = sample(UniformInt(0, N_CHANNELS - 1), addr="Decay Channel")
        energy = sample(Uniform(10.0, 50.0), addr="Energy")
        deposits = jnp.asarray(
            sim(np.array([float(ch), float(energy)])), jnp.float32
        )
        observe(make_abc(lambda k: deposits, abc_logpdf(deposits)),
                observed, addr="calo")
        predict(ch, "Channel")
        predict(energy, "Energy")

    def model_traced(observed):
        """Traced model body: same program, simulator via pure_callback —
        runs under jit/vmap with the whole particle batch shipped to the
        child in one pipelined exchange."""
        ch = sample(UniformInt(0, N_CHANNELS - 1), addr="Decay Channel")
        energy = sample(Uniform(10.0, 50.0), addr="Energy")
        deposits = observe_external(
            sim, jnp.stack([ch.astype(jnp.float32), energy]), OBS_DIM
        )
        observe(make_abc(lambda k: deposits, abc_logpdf(deposits)),
                observed, addr="calo")
        predict(ch, "Channel")
        predict(energy, "Energy")

    # ground-truth event from the child itself
    true_ch, true_e = 1, 37.0
    observed = jnp.asarray(sim(np.array([true_ch, true_e])), jnp.float32)
    n = args.particles

    # --- compile A: static CSIS; prior-trace generation runs through the
    # child from inside the jitted training batch (observe_external seam) ---
    import time

    from cpprob_jax.inference.csis import CSIS

    eng_t = CSIS(model_traced, (jnp.zeros(OBS_DIM),))
    steps = max(30, args.traces // 64)
    t0 = time.time()
    params_t, losses_t = eng_t.compile(jax.random.key(0), steps=steps,
                                       batch_size=64)
    print(f"compile traced: {steps * 64} external traces in "
          f"{time.time()-t0:.1f}s, loss {float(losses_t[0]):.2f} -> "
          f"{float(losses_t[-10:].mean()):.2f}", file=sys.stderr)

    # --- compile B: DynamicCSIS eager (the reference's per-trace loop) -----
    n_eager = max(200, args.traces // 4)
    eng_e = DynamicCSIS(model_eager, (jnp.zeros(OBS_DIM),), probe=16)
    params_e, stats = eng_e.compile(jax.random.key(0), n_traces=n_eager)
    print(f"compile eager: {n_eager} external traces, "
          f"loss {stats['losses'][0]:.2f} -> {stats['losses'][-1]:.2f}",
          file=sys.stderr)

    def channel_posterior(res):
        w = np.asarray(res.normalized_weights)
        chs = np.asarray(res.predicts["Channel"])
        return np.array([(w * (chs == c)).sum() for c in range(N_CHANNELS)])

    def energy_mean(res):
        w = np.asarray(res.normalized_weights)
        return float((w * np.asarray(res.predicts["Energy"])).sum())

    def ess(res):
        w = np.asarray(res.normalized_weights)
        return float(1.0 / np.sum(w * w))

    # --- legs over independent seeds: prior (traced) vs guided (traced) ----
    # the traced legs run their host callbacks on the default device
    traced_device = str(jax.devices()[0])
    ess_p, ess_g, em_p, em_g, post_p, post_g = [], [], [], [], [], []
    t_guided = []
    for s in range(args.seeds):
        t0 = time.time()
        rg = eng_t.infer(params_t, (observed,), n, jax.random.key(10 + s))
        channel_posterior(rg)  # force host fetch inside the timed region
        t_guided.append(time.time() - t0)
        rp = ct.sis(model_traced, (observed,), n, jax.random.key(100 + s))
        ess_g.append(ess(rg)); ess_p.append(ess(rp))
        em_g.append(energy_mean(rg)); em_p.append(energy_mean(rp))
        post_g.append(channel_posterior(rg)); post_p.append(channel_posterior(rp))
    # first call compiles; warm calls measure the served pipeline
    traced_pps = n / float(np.median(t_guided[1:]) if len(t_guided) > 1
                           else t_guided[0])

    # --- eager guided leg (per-particle child calls) for the comparison ----
    n_eager_particles = max(32, n // 16)
    t0 = time.time()
    res_eager = eng_e.infer(params_e, (observed,), n_eager_particles,
                            jax.random.key(2))
    eager_pps = n_eager_particles / (time.time() - t0)
    post_eager = channel_posterior(res_eager)

    # --- brute-force reference posterior for the continuous latent ---------
    # the model's energy posterior tracks the OBSERVED event's Poisson-drawn
    # total (not the true generating energy, which carries ~sqrt(E) event
    # noise plus a small low bias from the ABC normalisation term), so the
    # amortized estimate is gated against a large prior-SIS estimate of the
    # same posterior, and the error vs truth is recorded separately
    ref_ems = []
    if full_mode:
        for s in range(4):
            rr = ct.sis(model_traced, (observed,), 16384,
                        jax.random.key(1000 + s))
            ref_ems.append(energy_mean(rr))
    ref_mean = float(np.mean(ref_ems)) if ref_ems else None

    ratio = float(np.mean(ess_g) / np.mean(ess_p))
    err_g = float(np.mean(np.abs(np.asarray(em_g) - true_e)))
    err_p = float(np.mean(np.abs(np.asarray(em_p) - true_e)))
    err_g_ref = (
        float(abs(np.mean(em_g) - ref_mean)) if ref_mean is not None else None
    )
    print(f"true channel {true_ch}; guided traced posterior {post_g[0]}, "
          f"prior {post_p[0]}, eager guided {post_eager}", file=sys.stderr)
    print(f"mean ESS over {args.seeds} seeds: guided {np.mean(ess_g):.1f} "
          f"prior {np.mean(ess_p):.1f} (ratio {ratio:.2f}) / {n}",
          file=sys.stderr)
    print(f"energy |err| vs truth: guided {err_g:.2f} prior {err_p:.2f} "
          f"(true {true_e})", file=sys.stderr)
    print(f"throughput: traced guided {traced_pps:.0f} particles/s vs eager "
          f"guided {eager_pps:.0f} particles/s "
          f"({traced_pps/eager_pps:.1f}x)", file=sys.stderr)

    # --- gates --------------------------------------------------------------
    for name, post in (("guided_traced", post_g[0]), ("prior", post_p[0]),
                       ("eager", post_eager)):
        assert int(post.argmax()) == true_ch, (name, post)
    if full_mode:
        assert ratio > 1.0, f"guided/prior ESS ratio {ratio:.2f} <= 1"
        # the amortized estimate must agree with the reference posterior
        # (both estimate the same integral; ref spread over seeds is ~1.5)
        assert err_g_ref < 5.0, (
            f"guided energy {np.mean(em_g):.2f} vs reference posterior "
            f"{ref_mean:.2f}"
        )
        # and vs truth: posterior-to-truth offset is event noise (sd ~6) plus
        # the ABC-kernel bias — bound it loosely
        assert err_g < 15.0, f"guided energy error {err_g:.2f} vs truth"

    out = {
        "experiment": "external_subprocess_simulator_bridge",
        "reference": "src/models/sherpa.cpp:29-86 (external generator + ABC "
                     "observe + channel/momentum predicts)",
        "simulator": "subprocess (numpy toy calorimeter, line protocol)",
        "n_compile_traces_traced": steps * 64,
        "n_compile_traces_eager": n_eager,
        "n_particles": n,
        "n_seeds": args.seeds,
        "true_channel": true_ch,
        "true_energy": true_e,
        "prior_channel_posterior": post_p[0].tolist(),
        "guided_channel_posterior": post_g[0].tolist(),
        "eager_guided_channel_posterior": post_eager.tolist(),
        "mean_ess_prior": float(np.mean(ess_p)),
        "mean_ess_guided": float(np.mean(ess_g)),
        "ess_ratio_guided_over_prior": ratio,
        "reference_posterior_energy_mean": ref_mean,
        "reference_posterior_energy_seeds": [round(e, 2) for e in ref_ems],
        "energy_abs_err_guided_vs_reference_posterior": err_g_ref,
        "energy_abs_err_guided_vs_truth": err_g,
        "energy_abs_err_prior_vs_truth": err_p,
        "guided_energy_means": [round(e, 2) for e in em_g],
        "throughput_particles_per_s": {
            "guided_traced_jit_vmap": traced_pps,
            "guided_eager_per_particle": eager_pps,
            "speedup": traced_pps / eager_pps,
        },
        "gates_enforced": bool(full_mode),
        "seams": {
            "compile_traced": "CSIS jitted batch gen via observe_external "
                              "(pure_callback inside jit)",
            "compile_eager": "DynamicCSIS eager (host-side trace loop)",
            "prior_sis": "jit+vmap via jax.pure_callback (observe_external)",
            "guided_traced": "CSISProposalMessenger under jit/vmap + "
                             "observe_external (cached serving program)",
            "guided_eager": "eager per-particle messenger",
            "device": traced_device,
        },
    }
    path = args.out or os.path.join(repo, "EXTERNAL_BRIDGE.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {path}", file=sys.stderr)
    sim.close()


if __name__ == "__main__":
    if "--simulator" in sys.argv:
        simulator_main()
    else:
        main()
