"""SHERPA at scale — CNN3D-guided CSIS on the FULL 35x35x20 calorimeter.

The reference drives the external SHERPA generator through an ABC observe on
a 35x35x20 voxel calorimeter with a CNN3D observation embedding
(``src/models/sherpa.cpp:29-86``, ``src/models/calorimeter.cpp``,
``infcomp/nn/observation.py:56-93``) and reports ~1 trace/s compile
throughput on a Titan X (thesis ch. 5).  This example runs the same
structure at full volume on one card: train a CNN3D-embedded CSIS
proposal on the synthetic tau-decay calorimeter model, measure traces/s,
then check the guided proposal identifies the decay channel from held-out
volumes better than prior SIS.  ``chip_smoke.py`` runs the training part
(:func:`build_engine`, :func:`train`) for a few steps.

Writes a JSON record to --out when given.

Usage:  python examples/sherpa_fullscale.py [--steps 300] [--quick]
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
from cpprob_jax.core import handlers
from cpprob_jax.inference.csis import CSIS
from cpprob_jax.models.sherpa import sherpa_calorimeter_wrapper


def build_engine(bins, max_deposits):
    """(CSIS engine with a CNN3D observation embedding, model) at volume
    ``bins``.  The ABC temperature is a TRACED model argument: every engine
    call, guided or prior, any tau, reuses one compiled program per shape."""
    vox = bins[0] * bins[1] * bins[2]

    def model(observed, temper=1.0):
        return sherpa_calorimeter_wrapper(
            observed, n_bins=bins, max_deposits=max_deposits,
            abc_temper=temper,
        )

    eng = CSIS(model, (jnp.zeros(vox), 1.0), embedding_dim=64,
               obs_embedding="cnn3d", obs_shape=bins)
    return eng, model


def train(eng, steps, batch_size, lr, key=None):
    """Online CSIS training; returns (params, losses, wall seconds).  The
    host transfer of the losses closes the timed region."""
    key = jax.random.key(0) if key is None else key
    t0 = time.perf_counter()
    params, losses = eng.compile(key, steps=steps, batch_size=batch_size,
                                 unroll=min(10, steps), learning_rate=lr)
    losses = np.asarray(losses)
    return params, losses, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--max-deposits", type=int, default=4096)
    ap.add_argument("--bins", type=int, nargs=3, default=[35, 35, 20])
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="smoke mode: tiny volume + few steps")
    args = ap.parse_args()

    if args.quick:
        args.bins, args.max_deposits = [7, 7, 5], 256
        args.steps, args.particles = 40, 64

    bins = tuple(args.bins)
    vox = bins[0] * bins[1] * bins[2]

    eng, model = build_engine(bins, args.max_deposits)

    def observed_for(ch):
        tr = handlers.TraceHandler()
        with handlers.Seed(jax.random.key(100 + ch)), handlers.Substitute(
            {"channel_u": jnp.float32(ch + 0.5)}
        ), handlers.SimulateObserves(), tr:
            model(jnp.zeros(vox), 1.0)
        return tr.trace["calo"]["value"]

    def chpost(res):
        chs = np.asarray(res.predicts["Decay Channel"])
        w = np.asarray(res.normalized_weights)
        return np.array([(w * (chs == c)).sum() for c in range(4)])

    dev = jax.devices()[0]
    print(f"device={dev.device_kind} volume={bins} ({vox} voxels) "
          f"max_deposits={args.max_deposits}")

    params, losses, train_s = train(eng, args.steps, args.batch_size,
                                    args.lr)
    traces = args.steps * args.batch_size
    tps = traces / train_s
    print(f"trained {traces} traces in {train_s:.1f}s = {tps:.1f} traces/s "
          f"(reference SHERPA anchor: ~1/s on Titan X)")
    print(f"loss {float(losses[0]):.3f} -> "
          f"{float(np.asarray(losses)[-10:].mean()):.3f}")

    # Amortization evidence, not just throughput: at the
    # exact counting tolerance the 25k-voxel ABC log-likelihood spread is
    # thousands of nats, so BOTH proposals degenerate to ESS ~ 1 and the
    # guided advantage is invisible.  Temper the ABC kernel (power
    # posterior: divides the log-kernel, preserving the template ranking
    # and hence channel recovery EXACTLY — unlike bandwidth widening,
    # whose value-dependent normalizer biases toward low-deposit
    # templates) and report guided-vs-prior ESS ratios + posterior quality
    # per channel across temperatures; the trained proposal is shared (it
    # is an inverse model learned from prior traces — the temperature only
    # enters the observe weight, not the trace law).
    from cpprob_jax.models.sherpa import CHANNEL_MOMENTA

    def mom_truth(ch):
        active = (np.arange(4) <= ch)[:, None]
        return (np.asarray(CHANNEL_MOMENTA)[:, :3] * active).sum(axis=0)

    # Defensive-mixture sweep: the proposal is an
    # amortized inverse model trained on the untempered trace law; when the
    # served (tempered) posterior is wider than the training target, a pure
    # learned proposal under-covers and loses ESS to the prior on the
    # affected channels.  Mixing lam of the PRIOR into every guided site
    # (Hesterberg defensive IS, `infer(defensive=)`) bounds the importance
    # weights by 1/lam where the net under-covers at a (1-lam) cost where it
    # is right — the serving-time lever for this exact failure.
    tol_scales = [1.0, 3.0, 10.0, 30.0, 100.0]
    defensives = [None, 0.1, 0.3, 0.5]
    rows = []
    wins = 0
    for ch in range(4):
        obs = observed_for(ch)
        truth = mom_truth(ch)
        per_scale = []
        for s in tol_scales:
            p = ct.sis(model, (obs, jnp.float32(s)), args.particles,
                       jax.random.key(17 * ch + 2))
            pp = chpost(p)
            mp = np.array([float(p.empirical(f"Momentum {a}").mean)
                           for a in "XYZ"])
            variants = {}
            for lam in defensives:
                g = eng.infer(params, (obs, jnp.float32(s)), args.particles,
                              jax.random.key(17 * ch + 1), defensive=lam)
                pg = chpost(g)
                mg = np.array([float(g.empirical(f"Momentum {a}").mean)
                               for a in "XYZ"])
                variants[str(lam)] = {
                    "guided_posterior": [round(float(x), 4) for x in pg],
                    "guided_ess": round(float(g.ess), 2),
                    "ess_ratio": round(
                        float(g.ess) / max(float(p.ess), 1e-9), 2),
                    "guided_momentum_mean": [round(float(x), 3) for x in mg],
                    "guided_momentum_abs_err": round(
                        float(np.abs(mg - truth).sum()), 3),
                    "guided_channel_correct": bool(pg.argmax() == ch),
                }
            base = variants["None"]
            per_scale.append({
                "abc_temper": s,
                "prior_posterior": [round(float(x), 4) for x in pp],
                "prior_ess": round(float(p.ess), 2),
                "prior_momentum_mean": [round(float(x), 3) for x in mp],
                "true_momentum": [round(float(x), 3) for x in truth],
                "prior_momentum_abs_err": round(
                    float(np.abs(mp - truth).sum()), 3),
                **{k: v for k, v in base.items()},
                "defensive_variants": {
                    k: v for k, v in variants.items() if k != "None"
                },
            })
            ratios = {k: v["ess_ratio"] for k, v in variants.items()}
            print(f"ch {ch} tau {s:>6}: guided "
                  f"{np.round(base['guided_posterior'], 3)} "
                  f"prior_ess {float(p.ess):.1f} ess_ratio by defensive "
                  f"{ratios} |dp| {base['guided_momentum_abs_err']:.2f}"
                  f"/{per_scale[-1]['prior_momentum_abs_err']:.2f}")
        wins += int(per_scale[0]["guided_channel_correct"])
        rows.append({"channel": ch, "by_tolerance": per_scale})

    # --- operating point: the (temper, defensive) with the best worst-case
    # channel ess_ratio; the r3 demand is ratio > 1 on ALL FOUR channels
    best = None
    for si, s in enumerate(tol_scales):
        for lam in defensives:
            key_l = str(lam)
            min_ratio = min(
                (rows[ch]["by_tolerance"][si]["defensive_variants"][key_l]
                 ["ess_ratio"] if lam is not None
                 else rows[ch]["by_tolerance"][si]["ess_ratio"])
                for ch in range(4)
            )
            correct = all(
                (rows[ch]["by_tolerance"][si]["defensive_variants"][key_l]
                 ["guided_channel_correct"] if lam is not None
                 else rows[ch]["by_tolerance"][si]["guided_channel_correct"])
                for ch in range(4)
            )
            err_by_ch = [
                (rows[ch]["by_tolerance"][si]["defensive_variants"][key_l]
                 ["guided_momentum_abs_err"] if lam is not None
                 else rows[ch]["by_tolerance"][si]
                 ["guided_momentum_abs_err"])
                for ch in range(4)
            ]
            cand = {"abc_temper": s, "defensive": lam,
                    "min_channel_ess_ratio": min_ratio,
                    "all_channels_correct": correct,
                    # accuracy column BESIDE the quoted ratio: the
                    # tempered posterior the proposal wins on
                    # is flatter than the temper-1 target, and the quoted
                    # win must carry that cost visibly
                    "guided_momentum_abs_err_by_channel": err_by_ch,
                    "max_channel_momentum_abs_err": max(err_by_ch)}
            if best is None or (
                (correct, min_ratio)
                > (best["all_channels_correct"],
                   best["min_channel_ess_ratio"])
            ):
                best = cand
    print(f"operating point: {best}")

    # --- the accuracy-vs-temper tradeoff, one row per temperature: best
    # defensive by worst-channel ess ratio, with the worst-channel guided
    # and prior momentum errors beside it — and the temper=1 row called
    # out explicitly (the reference's exact-counting-variance target)
    tradeoff = []
    for si, s in enumerate(tol_scales):
        best_s = None
        for lam in defensives:
            key_l = str(lam)

            def get(ch, field):
                bt = rows[ch]["by_tolerance"][si]
                return (bt["defensive_variants"][key_l][field]
                        if lam is not None else bt[field])

            min_ratio = min(get(ch, "ess_ratio") for ch in range(4))
            if best_s is None or min_ratio > best_s["min_channel_ess_ratio"]:
                best_s = {
                    "abc_temper": s,
                    "best_defensive": lam,
                    "min_channel_ess_ratio": min_ratio,
                    "max_channel_guided_momentum_abs_err": max(
                        get(ch, "guided_momentum_abs_err")
                        for ch in range(4)),
                    "max_channel_prior_momentum_abs_err": max(
                        rows[ch]["by_tolerance"][si]
                        ["prior_momentum_abs_err"] for ch in range(4)),
                    "all_channels_correct": all(
                        get(ch, "guided_channel_correct")
                        for ch in range(4)),
                }
        tradeoff.append(best_s)
    untempered = tradeoff[0]
    print("tradeoff (best defensive per temper):")
    for row in tradeoff:
        print(f"  temper {row['abc_temper']:>6}: min ratio "
              f"{row['min_channel_ess_ratio']:.2f} guided |dp| "
              f"{row['max_channel_guided_momentum_abs_err']:.3f} prior "
              f"|dp| {row['max_channel_prior_momentum_abs_err']:.3f}")
    if not args.quick:
        # the r3 demand: guided beats the prior's ESS on ALL FOUR channels
        # at one documented (temper, defensive) operating point
        assert best["all_channels_correct"], best
        assert best["min_channel_ess_ratio"] > 1.0, best

    payload = {
        "experiment": "sherpa_fullscale_cnn3d_csis",
        "reference": "src/models/sherpa.cpp:29-86 + calorimeter.cpp + "
                     "infcomp/nn/observation.py:56-93; ~1 trace/s thesis ch.5",
        "device": str(dev.device_kind),
        "volume": list(bins),
        "max_deposits": args.max_deposits,
        "train": {"steps": args.steps, "batch_size": args.batch_size,
                  "wall_s": train_s, "traces_per_sec": tps,
                  "reference_traces_per_sec_anchor": 1.0,
                  "loss_first": float(losses[0]),
                  "loss_last": float(np.asarray(losses)[-10:].mean())},
        "channel_recovery": rows,
        "operating_point": best,
        "accuracy_vs_temper_tradeoff": tradeoff,
        "untempered_point": {
            **untempered,
            "note": "abc_temper=1 is the reference's exact-counting-"
                    "variance target: the amortized proposal matches the "
                    "posterior mean tightly there (see "
                    "max_channel_guided_momentum_abs_err) but its ESS "
                    "advantage over the prior vanishes — both degenerate "
                    "at the 25k-voxel log-likelihood spread.  The "
                    "tempered operating point trades momentum sharpness "
                    "for the ESS win; this table is the price list.",
        },
        "defensives_swept": [str(d) for d in defensives],
        "abc_tempers": tol_scales,
        "abc_note": "abc_temper divides the ABC log-kernel (power "
                    "posterior): template ranking and channel recovery are "
                    "preserved at any temperature while the log-weight "
                    "spread shrinks; temper 1 = exact counting variance, "
                    "where the 25k-voxel spread degenerates BOTH proposals "
                    "to ESS~1 (see models/sherpa.py docstring)",
        "guided_channel_correct_count_at_temper1": wins,
        "versions": __import__("cpprob_jax.util.profiling", fromlist=["env_versions"]).env_versions(),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
        print("wrote", args.out)
    print(json.dumps({"metric": "sherpa_fullscale_traces_per_sec",
                      "value": tps, "unit": "traces/s",
                      "vs_baseline": tps / 1.0}))


if __name__ == "__main__":
    main()
