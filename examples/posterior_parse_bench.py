"""Posterior-parser benchmark: native C++ vs Python s-expression parser,
measured from the PUBLIC API (StatsPrinter.from_dump / load_posterior) on a
large reference-format dump -> POSTERIOR_PARSE_BENCH.json.

The reference's StatsPrinter parses its dumped posterior text files
(``stats_printer.hpp:88-120``); ours auto-detects the native parser
(``native/src/posterior_parse.cpp``) with a Python fallback.  This measures
the speedup actually reachable through ``load_posterior`` — parsing plus the
(vectorized) per-name assembly — not the raw parser in isolation.

Usage: python examples/posterior_parse_bench.py [--particles 800000]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

import cpprob_jax as ct
from cpprob_jax.io import dump_posterior
from cpprob_jax.io.serialization import load_posterior
from cpprob_jax.io.tracefile import native_available
from cpprob_jax.models import hmm
from cpprob_jax.postprocess.stats import StatsPrinter


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=786_432)
    ap.add_argument("--length", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    repo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

    if not native_available():
        print("native library unavailable; nothing to benchmark",
              file=sys.stderr)
        return

    obs = jax.random.normal(jax.random.key(7), (args.length,))
    res = ct.sis(hmm, (obs,), args.particles, jax.random.key(0),
                 batch_size=min(args.particles, 1 << 17))
    path = os.path.join("/tmp", "posterior_parse_bench")
    t0 = time.perf_counter()
    dump_posterior(path, res)
    dump_s = time.perf_counter() - t0
    size = sum(
        os.path.getsize(path + ext)
        for ext in (".ids", ".int", ".real")
        if os.path.exists(path + ext)
    )
    print(f"dump: {args.particles} particles x {args.length} predicts = "
          f"{size/1e6:.1f} MB in {dump_s:.1f}s", file=sys.stderr)

    def timed(native):
        t0 = time.perf_counter()
        predicts, log_w = load_posterior(path, native=native)
        dt = time.perf_counter() - t0
        return dt, predicts, log_w

    t_native, pred_n, lw_n = timed(True)
    t_python, pred_p, lw_p = timed(False)
    np.testing.assert_allclose(lw_n, lw_p, rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(pred_n["State"], np.float64),
        np.asarray(pred_p["State"], np.float64), rtol=1e-12,
    )

    t0 = time.perf_counter()
    sp = StatsPrinter.from_dump(path)
    summary = sp.summary()
    t_full = time.perf_counter() - t0

    out = {
        "experiment": "posterior_parse_native_vs_python",
        "reference": "stats_printer.hpp:88-120 (StatsPrinter parse stage)",
        "dump_mb": size / 1e6,
        "n_particles": args.particles,
        "entries": args.particles * args.length,
        "load_posterior_native_s": t_native,
        "load_posterior_python_s": t_python,
        "speedup_public_api": t_python / t_native,
        "statsprinter_from_dump_s": t_full,
        "parity": "native and Python parses identical (asserted)",
    }
    print(f"load_posterior: native {t_native:.2f}s vs python {t_python:.2f}s "
          f"= {t_python/t_native:.1f}x; StatsPrinter.from_dump {t_full:.2f}s",
          file=sys.stderr)
    p = args.out or os.path.join(repo, "POSTERIOR_PARSE_BENCH.json")
    with open(p, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {p}", file=sys.stderr)
    for ext in (".ids", ".int", ".real"):
        if os.path.exists(path + ext):
            os.remove(path + ext)


if __name__ == "__main__":
    main()
