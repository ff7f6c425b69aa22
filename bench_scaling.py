#!/usr/bin/env python
"""Weak-scaling study: sharded SMC with fixed particles-per-device over
meshes of 1..K devices.  On the CPU backend this uses virtual devices (the
same code path ``__graft_entry__.dryrun_multichip`` compiles); on a machine
with several GPUs it measures scaling over NVLink.  Prints one JSON line per
mesh size plus a summary line with the weak-scaling efficiency.

Usage:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python bench_scaling.py --per-device 65536
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

# Pin the CPU backend explicitly when asked for it: the config update wins as
# long as no backend is initialized yet (same as tests/conftest.py).
if os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
    jax.config.update("jax_platforms", "cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=1 << 16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--scheme", default="collective",
                    choices=["collective", "island"])
    ap.add_argument("--fixed-total", type=int, default=0, metavar="N",
                    help="instead of weak scaling, hold the TOTAL particle "
                    "count at N while growing the mesh — on a virtual CPU "
                    "mesh (shared host cores) this isolates sharding + "
                    "collective overhead: ratio time(k)/time(1) ~ 1 means "
                    "the sharded path adds no redundant work")
    args = ap.parse_args()

    from cpprob_jax.models import HMM_MEANS, HMM_TRANS, hmm_ssm
    from cpprob_jax.parallel import particle_mesh, smc_sharded

    rng = np.random.RandomState(0)
    z = rng.randint(0, 3)
    obs = []
    for t in range(args.steps):
        if t > 0:
            z = rng.choice(3, p=HMM_TRANS[z])
        obs.append(rng.normal(HMM_MEANS[z], 1.0))
    obs = jnp.asarray(np.asarray(obs, np.float32))

    devices = jax.devices()
    sizes = [k for k in (1, 2, 4, 8, 16, 32) if k <= len(devices)]
    results = []
    for k in sizes:
        mesh = particle_mesh(devices=devices[:k])
        n = args.fixed_total if args.fixed_total else args.per_device * k

        def run(key):
            return smc_sharded(
                hmm_ssm, obs, n, key, mesh=mesh, scheme=args.scheme
            )

        r = run(jax.random.key(0))
        float(r.log_evidence)  # sync
        times = []
        for i in range(args.iters):
            t0 = time.perf_counter()
            r = run(jax.random.key(i + 1))
            float(r.log_evidence)
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        ps = n * args.steps / dt
        results.append({"devices": k, "n_particles": n, "sweep_s": dt,
                        "particle_steps_per_s": ps,
                        "log_evidence": float(r.log_evidence)})
        print(json.dumps(results[-1]))

    if len(results) > 1 and args.fixed_total:
        base = results[0]["sweep_s"]
        for r in results[1:]:
            print(json.dumps({
                "metric": "sharding_overhead_ratio",
                "devices": r["devices"],
                "value": r["sweep_s"] / base,
                "scheme": args.scheme,
            }))
    elif len(results) > 1:
        base = results[0]["particle_steps_per_s"]
        for r in results[1:]:
            eff = r["particle_steps_per_s"] / (base * r["devices"])
            print(json.dumps({
                "metric": "weak_scaling_efficiency",
                "devices": r["devices"],
                "value": eff,
                "scheme": args.scheme,
            }))


if __name__ == "__main__":
    main()
