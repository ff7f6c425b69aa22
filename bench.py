#!/usr/bin/env python
"""Headline benchmark: SMC throughput on the 3-state HMM with ESS-triggered
systematic resampling, in particle-steps/s on one NVIDIA GPU.

Runs the fused discrete kernel (``--impl kernel``, the default) or the plain
XLA step (``--impl xla``, chunk=1).  Fails when JAX finds no GPU.  Prints ONE
JSON line: {"metric": ..., "value": N, "unit": ..., "detail": {...}}.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=1 << 26)
    ap.add_argument("--steps", type=int, default=16, help="HMM length T")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--impl", choices=["kernel", "xla"], default="kernel")
    ap.add_argument("--chunk", type=int, default=16,
                    help="timesteps per kernel call (kernel impl); ESS "
                         "resample checks move to chunk edges")
    ap.add_argument("--island-every", type=int, default=8,
                    help="steps between tile-local ESS checks inside a "
                         "chunk (kernel impl; even, 0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if jax.default_backend() != "gpu":
        print(f"bench.py needs an NVIDIA GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1

    import jax.numpy as jnp

    from cpprob_jax.inference.smc import build_smc_run
    from cpprob_jax.models import HMM_MEANS, HMM_TRANS, hmm_ssm
    from cpprob_jax.ops.pallas_ssm import make_fused_discrete_ssm
    from cpprob_jax.util.compile_cache import enable_compile_cache
    from cpprob_jax.util.profiling import StageTimer, env_versions

    enable_compile_cache()
    n, T = args.particles, args.steps
    if args.impl == "kernel":
        model = make_fused_discrete_ssm(HMM_TRANS, HMM_MEANS,
                                        island_every=args.island_every)
        chunk = args.chunk
    else:
        model, chunk = hmm_ssm, 1

    # observations simulated from the HMM itself
    rng = np.random.RandomState(args.seed)
    z = rng.randint(0, 3)
    obs = []
    for t in range(T):
        if t > 0:
            z = rng.choice(3, p=HMM_TRANS[z])
        obs.append(rng.normal(HMM_MEANS[z], 1.0))
    obs = jnp.asarray(np.asarray(obs, np.float32))

    st = StageTimer()
    run_one = build_smc_run(model, n, ess_threshold=0.5, chunk=chunk)
    run = jax.jit(lambda k, o: run_one(k, o)[3:5])  # (resampled, log Z)
    with st.stage("compile_warm"):
        jax.block_until_ready(run(jax.random.key(args.seed + 999), obs))
    times, log_zs, epochs = [], [], []
    for i in range(args.iters):
        t0 = time.perf_counter()
        resampled, log_z = jax.block_until_ready(
            run(jax.random.key(args.seed + i), obs))
        times.append(time.perf_counter() - t0)
        log_zs.append(float(log_z))
        epochs.append(int(np.asarray(resampled).sum()))
    dt = float(np.median(times))
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "smc_hmm_particle_steps_per_sec",
        "value": n * T / dt,
        "unit": "particle-steps/s",
        "detail": {
            "n_particles": n, "T": T, "impl": args.impl, "chunk": chunk,
            "island_every": args.island_every if args.impl == "kernel"
            else 0,
            "median_sweep_s": dt, "iters": args.iters,
            "log_evidence_mean": float(np.mean(log_zs)),
            "log_evidence_std": float(np.std(log_zs)),
            "resample_epochs_mean": float(np.mean(epochs)),
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "stages": st.as_dict(),
            "versions": env_versions(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
