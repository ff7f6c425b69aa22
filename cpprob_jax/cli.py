"""Command-line driver — counterpart of the reference's
``src/main.cpp`` (boost::program_options CLI: model registry, modes
``--compile/--csis/--sis/--dryrun/--estimate``, observes from string or file,
posterior dump, batch counts; ``main.cpp:116-239``) and ``infcomp/main.py``.

Usage examples (mirroring the reference README):

    python -m cpprob_jax.cli --model gaussian -m sis -n 10000 -o "3.0 4.0"
    python -m cpprob_jax.cli --model hmm -m compile --steps 500 --ckpt-dir /tmp/nn
    python -m cpprob_jax.cli --model hmm -m csis -n 10000 \
        -o "[0.9 0.8 0.7 0.0 -0.025 -5.0 -2.0 -0.1 0.0 0.13]" --ckpt-dir /tmp/nn
    python -m cpprob_jax.cli --model gaussian -m estimate --dump-path posterior
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Tuple

import numpy as np


def _registry() -> Dict[str, dict]:
    """Model registry — counterpart of main.cpp's model tuple (7 models)."""
    import jax.numpy as jnp

    from . import models as M

    return {
        "gaussian": {
            "fn": M.gaussian_unknown_mean_readme,
            "template": (0.0, 0.0),
            "doc": "conjugate Gaussian unknown mean (README variant)",
        },
        "gaussian_models_hpp": {
            "fn": M.gaussian_unknown_mean,
            "template": (0.0, 0.0),
            "doc": "conjugate Gaussian unknown mean (models.hpp variant)",
        },
        "gaussian_2d": {
            "fn": M.gaussian_2d_unknown_mean,
            "template": (jnp.zeros(2),),
            "doc": "2-d diagonal-MVN unknown mean",
        },
        "linear_gaussian": {
            "fn": M.linear_gaussian_1d,
            "template": (jnp.zeros(50),),
            "ssm": M.linear_gaussian_ssm,
            "doc": "linear-Gaussian state-space model (N=50)",
        },
        "hmm": {
            "fn": M.hmm,
            "template": (jnp.zeros(10),),
            "ssm": M.hmm_ssm,
            "doc": "3-state HMM, Gaussian emissions (N=10)",
        },
        "normal_rejection": {
            "fn": M.normal_rejection_sampling,
            "template": (0.0, 0.0),
            "doc": "normal prior via rejection sampling",
        },
        "poly_adjustment": {
            "fn": lambda pts: M.poly_adjustment(pts, degree=1),
            "template": (jnp.zeros((6, 2)),),
            "doc": "polynomial (deg 1) regression",
        },
        "linear_regression": {
            "fn": M.linear_regression,
            "template": (jnp.zeros((6, 2)),),
            "doc": "linear regression with metaobserves",
        },
        "all_distr": {
            "fn": M.all_distr,
            "template": (0, 0),
            "doc": "exercises every prior distribution",
        },
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cpprob_jax",
        description="Probabilistic-programming inference CLI",
    )
    p.add_argument("--model", help="model name (see --list)")
    p.add_argument(
        "-m", "--mode", default="sis",
        choices=["sis", "csis", "compile", "dryrun", "estimate", "smc",
                 "pg", "tempered"],
        help="inference mode (the reference's StateType + smc / "
             "particle-Gibbs / tempered-SMC extensions)",
    )
    p.add_argument("--iters", type=int, default=500,
                   help="pg: number of CSMC sweeps")
    p.add_argument("--burn-in", type=int, default=100,
                   help="pg: sweeps discarded before summarizing")
    p.add_argument("--waste-free", action="store_true",
                   help="tempered: waste-free SMC moves (Dau & Chopin 2022)")
    p.add_argument("--ess-threshold", type=float, default=0.5,
                   help="smc: resample when ESS < threshold * N")
    p.add_argument("--resampling", default="systematic",
                   choices=["systematic", "stratified", "multinomial",
                            "residual"])
    p.add_argument("-n", "--n-particles", type=int, default=10_000)
    p.add_argument("-o", "--observes", default=None,
                   help="observed values, s-expression syntax, e.g. '3.0 4.0'")
    p.add_argument("-f", "--observes-file", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=64,
                   help="compile-mode minibatch (reference default 64)")
    p.add_argument("--steps", type=int, default=400,
                   help="compile-mode training steps")
    p.add_argument("--ckpt-dir", default=None,
                   help="save/load the proposal network here")
    p.add_argument("--obs-embedding", default="fc",
                   choices=["fc", "lstm", "cnn3d", "site-lstm"],
                   help="observation embedding architecture "
                        "(infcomp --obs_embedding, main.py:35; cnn3d and "
                        "site-lstm beyond the reference's fc|lstm)")
    p.add_argument("--resume", action="store_true",
                   help="compile: warm-start from the latest checkpoint in "
                        "--ckpt-dir (infcomp --resume, main.py:38)")
    p.add_argument("--save-every", type=int, default=None, metavar="N_TRACES",
                   help="compile: checkpoint to --ckpt-dir every N processed "
                        "traces (infcomp --save_after_n_traces, main.py:33-34)"
                        "; the training loop is also Ctrl-C-safe — interrupt "
                        "and the partially trained network is still saved")
    p.add_argument("--tie-addresses", action="store_true",
                   help="share (embedding, head) across loop-indexed sites "
                        "name[t] and train them as a lax.scan")
    p.add_argument("--mdn", type=int, default=0, metavar="K",
                   help="mixture-density proposal heads with K components "
                        "on Normal-prior sites")
    p.add_argument("--flow-bins", type=int, default=0, metavar="K",
                   help="rational-quadratic spline-flow proposal heads with "
                        "K bins on Normal-prior sites")
    p.add_argument("--dynamic", action="store_true",
                   help="DynamicCSIS engine: bucketed training + host-side "
                        "guided particles for Python-dynamic model structure")
    p.add_argument("--defensive", type=float, default=None, metavar="LAM",
                   help="csis serving: defensive-mixture weight on the PRIOR "
                        "at every guided site (Hesterberg DIS) — bounds "
                        "importance weights by 1/LAM where the learned "
                        "proposal under-covers")
    p.add_argument("--dump-traces-dir", default=None,
                   help="compile: dump prior-trace shards here instead of "
                        "training (cpprob::compile dump_folder)")
    p.add_argument("--traces-dir", default=None,
                   help="compile: train offline from shards in this dir "
                        "(infcomp --traces_dir)")
    p.add_argument("--n-traces", type=int, default=65536,
                   help="number of traces to dump with --dump-traces-dir")
    p.add_argument("--unroll", type=int, default=1,
                   help="compile: optimizer steps per dispatch")
    p.add_argument("--dump-path", default=None,
                   help="posterior dump path (reference text layout)")
    p.add_argument("--npz", action="store_true", help="dump npz instead of text")
    p.add_argument("--batch", type=int, default=None,
                   help="particle batch size (memory bound)")
    p.add_argument("--list", action="store_true", help="list models and exit")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.model is None and not args.list:
        parser.error("the following arguments are required: --model")

    import jax

    from .util.compile_cache import enable_compile_cache

    enable_compile_cache()

    from . import sis
    from .inference.csis import CSIS
    from .io import dump_posterior, dump_posterior_npz, load_posterior, parse_observes
    from .postprocess import StatsPrinter
    from .util import (
        TrainLogger,
        hardware_banner,
        latest_checkpoint,
        load_pytree,
        save_pytree,
    )

    registry = _registry()
    if args.list:
        for name, entry in registry.items():
            print(f"{name:>22}  {entry['doc']}")
        return 0
    if args.model not in registry:
        print(f"unknown model {args.model!r}; use --list", file=sys.stderr)
        return 2
    entry = registry[args.model]
    model, template = entry["fn"], entry["template"]
    key = jax.random.key(args.seed)
    print(hardware_banner(), file=sys.stderr)

    if args.mode == "estimate":
        # parse + summarize a dumped posterior (reference --estimate path)
        if not args.dump_path:
            print("--estimate needs --dump-path", file=sys.stderr)
            return 2
        predicts, log_w = load_posterior(args.dump_path)
        import jax.numpy as jnp

        class _R:
            pass

        r = _R()
        r.predicts = {
            k: np.asarray(v, dtype=np.float32) for k, v in predicts.items()
        }
        r.log_weights = jnp.asarray(log_w)
        StatsPrinter(r).print(sys.stdout)
        return 0

    observes = template
    if args.observes_file:
        with open(args.observes_file) as f:
            observes = parse_observes(f.read())
    elif args.observes:
        observes = parse_observes(args.observes)

    if args.mode == "dryrun":
        from .core import handlers

        with handlers.Seed(key):
            model(*observes)
        print("dryrun ok", file=sys.stderr)
        return 0

    if args.mode == "smc":
        import jax.numpy as jnp

        from .inference.smc import smc as run_smc

        ssm = entry.get("ssm")
        if ssm is None:
            print(f"model {args.model!r} has no state-space (SSM) form; "
                  "smc supports: "
                  + ", ".join(k for k, e in registry.items() if "ssm" in e),
                  file=sys.stderr)
            return 2
        obs = jnp.ravel(jnp.asarray(observes[0], jnp.float32))
        res = run_smc(
            ssm, obs, args.n_particles, key,
            ess_threshold=args.ess_threshold, resampling=args.resampling,
        )
        print(f"log_evidence: {float(res.log_evidence):.6f}")
        n_res = int(np.asarray(res.resampled).sum())
        print(f"resampling epochs: {n_res} / {obs.shape[0]}")
        w = np.asarray(jax.nn.softmax(res.final_log_weights))
        states = np.asarray(res.final_states)
        print(f"final-state mean: {float((w * states).sum()):.5f}")
        return 0

    if args.mode == "pg":
        import jax.numpy as jnp

        from .inference.particle_gibbs import particle_gibbs

        ssm = entry.get("ssm")
        if ssm is None:
            print(f"model {args.model!r} has no state-space (SSM) form; "
                  "pg supports: "
                  + ", ".join(k for k, e in registry.items() if "ssm" in e),
                  file=sys.stderr)
            return 2
        obs = jnp.ravel(jnp.asarray(observes[0], jnp.float32))
        trajs, log_zs = particle_gibbs(
            ssm, obs, args.n_particles, args.iters, key, burn_in=args.burn_in,
        )
        trajs = np.asarray(trajs, np.float32)  # (iters-burn, T)
        means = trajs.mean(axis=0)
        stds = trajs.std(axis=0)
        kept = trajs.shape[0]
        print(f"particle-Gibbs: {kept} kept sweeps "
              f"(N={args.n_particles}, burn-in {args.burn_in})")
        for t in range(means.shape[0]):
            print(f"z[{t}]  mean {means[t]: .5f}  sd {stds[t]:.5f}")
        upd = float((trajs[1:] != trajs[:-1]).any(axis=1).mean())
        print(f"trajectory update rate: {upd:.3f}", file=sys.stderr)
        return 0

    if args.mode == "tempered":
        from .inference.smc_sampler import smc_sampler

        res = smc_sampler(
            model, observes, args.n_particles, key,
            waste_free=args.waste_free,
        )
        print(f"log_evidence: {float(res.log_evidence):.6f}")
        print(f"temperature stages: {int(res.n_stages)}  "
              f"hmc accept: {float(res.accept_rate):.3f}")
        for addr, vals in res.samples.items():
            vals = np.asarray(vals, np.float32)
            flat = vals.reshape(vals.shape[0], -1)
            m = flat.mean(axis=0)
            v = flat.var(axis=0)
            print(f"{addr}: mean {np.array2string(m, precision=5)} "
                  f"var {np.array2string(v, precision=5)}")
        return 0

    def make_engine():
        if args.dynamic:
            if args.tie_addresses or args.mdn or args.flow_bins:
                print("--dynamic is incompatible with --tie-addresses/"
                      "--mdn/--flow-bins", file=sys.stderr)
                raise SystemExit(2)
            from .inference.csis_dynamic import DynamicCSIS

            return DynamicCSIS(
                model, template, obs_embedding=args.obs_embedding,
                bucket_batch=args.batch_size,
            )
        return CSIS(
            model, template, obs_embedding=args.obs_embedding,
            mdn_components=args.mdn, flow_bins=args.flow_bins,
            tie_addresses=args.tie_addresses,
        )

    if args.mode == "compile":
        engine = make_engine()
        if args.dump_traces_dir:
            paths = engine.dump_traces(
                args.dump_traces_dir, key, args.n_traces, args.batch_size * 16
            )
            print(f"dumped {args.n_traces} traces in {len(paths)} shards to "
                  f"{args.dump_traces_dir}", file=sys.stderr)
            return 0
        logger = TrainLogger(print_every=max(args.steps // 10, 1))
        start_params = None
        if args.resume:
            if not args.ckpt_dir:
                print("--resume needs --ckpt-dir", file=sys.stderr)
                return 2
            ck = latest_checkpoint(args.ckpt_dir)
            if ck is not None:
                start_params = load_pytree(ck, engine.init(jax.random.key(0)))
                print(f"resuming from {ck}", file=sys.stderr)
            else:
                print(f"no checkpoint in {args.ckpt_dir}; starting fresh",
                      file=sys.stderr)
        saver = None
        if args.save_every:
            if not args.ckpt_dir:
                print("--save-every needs --ckpt-dir", file=sys.stderr)
                return 2
            from .util import periodic_saver

            saver = periodic_saver(args.ckpt_dir, args.save_every)
        if args.dynamic:
            params, _stats = engine.compile(
                key, n_traces=args.steps * args.batch_size,
                params=start_params, log_fn=logger.log, saver=saver,
            )
        elif args.traces_dir:
            import glob

            from .io.tracefile import TraceLoader

            paths = sorted(glob.glob(f"{args.traces_dir}/*.cptt"))
            if not paths:
                print(f"no .cptt shards in {args.traces_dir}", file=sys.stderr)
                return 2
            loader = TraceLoader(paths, batch_size=args.batch_size,
                                 seed=args.seed)
            params, losses = engine.compile_offline(
                loader, key, steps=args.steps, params=start_params,
                log_fn=logger.log, saver=saver,
            )
            loader.close()
        else:
            params, losses = engine.compile(
                key, steps=args.steps, batch_size=args.batch_size,
                params=start_params, log_fn=logger.log, unroll=args.unroll,
                saver=saver,
            )
        if args.ckpt_dir:
            import time as _time

            path = save_pytree(
                f"{args.ckpt_dir}/ckpt-{int(_time.time())}-final", params
            )
            print(f"saved proposal network to {path}", file=sys.stderr)
        return 0

    if args.mode == "csis":
        engine = make_engine()
        if not args.ckpt_dir:
            print("csis mode needs --ckpt-dir with a trained network",
                  file=sys.stderr)
            return 2
        ck = latest_checkpoint(args.ckpt_dir)
        if ck is None:
            print(f"no checkpoint in {args.ckpt_dir}", file=sys.stderr)
            return 2
        params = load_pytree(ck, engine.init(jax.random.key(0)))
        if args.dynamic:
            if args.defensive is not None:
                print("--defensive is not supported with --dynamic",
                      file=sys.stderr)
                return 2
            result = engine.infer(params, observes, args.n_particles, key)
        else:
            result = engine.infer(
                params, observes, args.n_particles, key,
                batch_size=args.batch, defensive=args.defensive,
            )
    else:  # sis
        result = sis(
            model, observes, args.n_particles, key, batch_size=args.batch
        )

    StatsPrinter(result).print(sys.stdout)
    if args.dump_path:
        if args.npz:
            dump_posterior_npz(args.dump_path, result)
        else:
            dump_posterior(args.dump_path, result)
        print(f"posterior dumped to {args.dump_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
