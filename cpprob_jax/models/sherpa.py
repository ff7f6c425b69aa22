"""SHERPA-family physics models — vectorized counterparts of
``src/models/sherpa_mini.cpp``, ``src/models/calorimeter.cpp`` and the
ABC-observe structure of ``src/models/sherpa.cpp:49-68``.

The reference wraps the external SHERPA HEP event generator; here (as in the
reference's own ``sherpa_mini`` toy) the generator is replaced by a synthetic
channel-conditioned event source, while the *framework-visible* structure is
identical: latent decay channel -> energy deposits -> histogram -> ABC/MVN
observe -> predicts ("Channel" / momentum components).

Vectorized rewrites:
- the reference's 1000-draw Python-style deposit loops become one batched
  MVN draw + a vectorized ``scatter-add`` histogram (static shapes);
- the calorimeter's Poisson-count deposit loop becomes a capped draw with an
  active-sample mask (bounded-shape rule for data-dependent loop counts).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import observe, predict, sample
from ..distributions import (
    MultivariateNormalDiag,
    Poisson,
    Uniform,
    make_abc,
)

__all__ = [
    "sherpa_mini",
    "sherpa_mini_wrapper",
    "calo_simulation",
    "sherpa_calorimeter_wrapper",
    "CHANNEL_MOMENTA",
]

# The four fixed final-state four-momenta (x, y, z, E) of sherpa_mini.cpp:45-48.
CHANNEL_MOMENTA = np.array(
    [
        [3.12206631, 0.18609799, -0.13257316, 3.16910447],
        [0.46751203, -0.18594433, -0.08841184, 0.52956513],
        [3.03845425, -0.35807276, 0.05962087, 3.06324252],
        [3.37196741, 0.35791909, 0.16136414, 3.39474722],
    ],
    np.float32,
)

_NETA = _NPHI = 100
_DEPOSIT_WIDTH = 0.05
_NSAMPLES = 1000
_OBS_WIDTH = 0.01


def _eta_phi(mom: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Pseudorapidity / azimuth of a four-momentum (x, y, z, E)."""
    px, py, pz = mom[..., 0], mom[..., 1], mom[..., 2]
    pt = jnp.sqrt(px * px + py * py)
    eta = jnp.arcsinh(pz / jnp.maximum(pt, 1e-12))
    phi = jnp.arctan2(py, px)
    return eta, phi


def _histogram2d(x, y, w, n_bins, lo, hi):
    """Vectorized scatter-add 2-D histogram (YODA::Histo2D::fill equivalent)."""
    ix = jnp.floor((x - lo) / (hi - lo) * n_bins).astype(jnp.int32)
    iy = jnp.floor((y - lo) / (hi - lo) * n_bins).astype(jnp.int32)
    ok = (ix >= 0) & (ix < n_bins) & (iy >= 0) & (iy < n_bins)
    ixc = jnp.clip(ix, 0, n_bins - 1)
    iyc = jnp.clip(iy, 0, n_bins - 1)
    hist = jnp.zeros((n_bins, n_bins), jnp.float32)
    return hist.at[ixc, iyc].add(jnp.where(ok, w, 0.0))


def sherpa_mini():
    """Latent channel ~ floor(U[0,4)); deposit 1000 2-D normal samples per
    selected momentum around (eta, phi), weight E/1000, into a 100x100
    histogram over [-1,1]^2 (``sherpa_mini.cpp:63-84``).  Returns the
    flattened histogram."""
    select_ran = sample(Uniform(0.0, 4.0), addr="channel_u")
    channel = jnp.floor(select_ran).astype(jnp.int32)
    predict(channel, "Channel")

    moms = jnp.asarray(CHANNEL_MOMENTA)
    eta, phi = _eta_phi(moms)            # (4,), (4,)
    energies = moms[:, 3]

    # one uncontrolled vector site supplies all deposit randomness
    eps = sample(
        MultivariateNormalDiag(jnp.zeros((4, _NSAMPLES, 2)), 1.0),
        addr="deposits",
        control=False,
    )
    centers = jnp.stack([eta, phi], axis=-1)[:, None, :]     # (4, 1, 2)
    pts = centers + _DEPOSIT_WIDTH * eps                     # (4, S, 2)

    active = (jnp.arange(4) <= channel).astype(jnp.float32)  # momenta 0..channel
    w = (energies / _NSAMPLES) * active                      # (4,)
    weights = jnp.broadcast_to(w[:, None], (4, _NSAMPLES))

    hist = _histogram2d(
        pts[..., 0].ravel(), pts[..., 1].ravel(), weights.ravel(),
        _NETA, -1.0, 1.0,
    )
    return hist.ravel()


def sherpa_mini_wrapper(test_image):
    """Observe the synthetic histogram under MVN(image, 0.01)
    (``sherpa_mini.cpp:87-93``)."""
    img = sherpa_mini()
    observe(
        MultivariateNormalDiag(img, _OBS_WIDTH),
        jnp.ravel(jnp.asarray(test_image, jnp.float32)),
        addr="image",
    )
    return img


# ---------------------------------------------------------------------------
# 3-D calorimeter (calorimeter.cpp)
# ---------------------------------------------------------------------------

_NBINX = _NBINY = 35
_NBINZ = 20
_Z_BEGIN = 4.0
_Z_END = 15.0
_XY_LIM = 3.0
_E_DEPOSIT = 0.005      # min_energy_deposit() in GeV (calorimeter.cpp:17)
_MAX_DEPOSITS = 4096    # static cap on the Poisson deposit count


def _shower_parameters(is_em: jax.Array):
    """EM vs hadronic shower shape (``calorimeter.cpp:56-76``)."""
    sampling_fraction = jnp.where(is_em, 0.5, 0.25)
    widths = jnp.where(
        is_em,
        jnp.array([0.2, 0.2, 0.50]),
        jnp.array([0.2, 0.2, 1.00]),
    )
    return sampling_fraction, widths


def _rot_y(v, theta):
    c, s = jnp.cos(theta), jnp.sin(theta)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([c * x + s * z, y, -s * x + c * z], axis=-1)


def _rot_z(v, phi):
    c, s = jnp.cos(phi), jnp.sin(phi)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([c * x - s * y, s * x + c * y, z], axis=-1)


def calo_simulation(particles, n_bins=( _NBINX, _NBINY, _NBINZ),
                    max_deposits: int = _MAX_DEPOSITS):
    """Vectorized voxel deposition simulator (``calo_simulation``,
    ``calorimeter.cpp:135-170``); default 35x35x20 bins as the reference.

    ``particles``: (P, 8) rows [x, y, z, energy, theta, phi, pdg_id,
    calo_visible] (the reference's particle_data layout).  Returns the voxel
    histogram ``n_bins``; ``max_deposits`` caps the Poisson deposit count
    (static shape).
    """
    nbx, nby, nbz = n_bins
    particles = jnp.asarray(particles, jnp.float32)
    P = particles.shape[0]
    hist = jnp.zeros((nbx, nby, nbz), jnp.float32)

    for p in range(P):
        row = particles[p]
        energy, theta, phi = row[3], row[4], row[5]
        pdg_id = row[6]
        visible = (row[7] > 0) & (pdg_id != -99999)
        is_em = jnp.abs(pdg_id) == 11.0  # electron/photon-like
        sampling_fraction, widths = _shower_parameters(is_em)
        mean_interactions = energy * sampling_fraction / _E_DEPOSIT

        n = sample(
            Poisson(jnp.maximum(mean_interactions, 1e-6)),
            addr=f"n_deposits[{p}]", control=False,
        )
        n = jnp.minimum(n, max_deposits)

        shower_depth = 2.0 * 5.0 * widths[2]
        r_surface = _Z_BEGIN / jnp.cos(theta)
        r_factor = 1.0 + (shower_depth / 2.0) * jnp.cos(theta) / _Z_BEGIN
        center = jnp.array([0.0, 0.0, 1.0]) * r_surface * r_factor

        eps = sample(
            MultivariateNormalDiag(jnp.zeros((max_deposits, 3)), 1.0),
            addr=f"deposit_eps[{p}]", control=False,
        )
        pts = center + widths * eps                       # (M, 3)
        pts = _rot_z(_rot_y(pts, theta), phi)

        ix = jnp.floor((pts[:, 0] + _XY_LIM) / (2 * _XY_LIM) * nbx).astype(jnp.int32)
        iy = jnp.floor((pts[:, 1] + _XY_LIM) / (2 * _XY_LIM) * nby).astype(jnp.int32)
        iz = jnp.floor((pts[:, 2] - _Z_BEGIN) / (_Z_END - _Z_BEGIN) * nbz).astype(jnp.int32)
        mask = (
            (jnp.arange(max_deposits) < n)
            & (ix >= 0) & (ix < nbx)
            & (iy >= 0) & (iy < nby)
            & (iz >= 0) & (iz < nbz)
            & visible
        )
        hist = hist.at[
            jnp.clip(ix, 0, nbx - 1),
            jnp.clip(iy, 0, nby - 1),
            jnp.clip(iz, 0, nbz - 1),
        ].add(jnp.where(mask, _E_DEPOSIT, 0.0))
    return hist


def _synthetic_tau_decay():
    """Channel-conditioned synthetic event source standing in for the external
    SHERPA generator (the reference's out-of-process HEP package).

    The calorimeter face sits on the detector z-axis (z in [4, 15]); the
    mother momentum of these events points along +x, so polar angles are
    measured **relative to the mother's flight axis** (theta = angle from
    +x, phi around it) — a fixed lab rotation that aims the decay products
    into the detector.  Showers are EM (pdg 11) so the widest-angle channel
    still deposits inside the (+-3)^2 transverse window."""
    select_ran = sample(Uniform(0.0, 4.0), addr="channel_u")
    channel = jnp.floor(select_ran).astype(jnp.int32)
    moms = jnp.asarray(CHANNEL_MOMENTA)
    active = (jnp.arange(4) <= channel)[:, None].astype(jnp.float32)
    px, py, pz, e = moms[:, 0], moms[:, 1], moms[:, 2], moms[:, 3]
    # polar angle from the mother axis (+x); azimuth in the (y, z) plane
    theta = jnp.arccos(px / jnp.sqrt(px**2 + py**2 + pz**2))
    phi = jnp.arctan2(pz, py)
    # product 3 (present only in channel 3) is a pion (pdg 211): the
    # reference's tau channels are hadronic, so one channel keeps the HAD
    # shower-parameter branch (sampling 0.25, z-width 1.0;
    # calorimeter.cpp:56-76) exercised end-to-end
    pdg = jnp.asarray([11.0, 11.0, 11.0, 211.0])
    particles = jnp.stack(
        [px, py, pz, e, theta, phi, pdg,
         jnp.ones((4,))], axis=-1,
    ) * active  # inactive rows zeroed (calo_visible=0 -> skipped)
    mother = jnp.sum(moms[:, :3] * active, axis=0)
    return channel, mother, particles


def sherpa_calorimeter_wrapper(observed_histo, n_bins=(_NBINX, _NBINY, _NBINZ),
                               max_deposits: int = _MAX_DEPOSITS,
                               abc_variance: str = "poisson",
                               abc_tolerance_scale: float = 1.0,
                               abc_temper: float = 1.0):
    """Full SHERPA-model structure (``sherpa.cpp:49-68``): simulate the decay,
    run the calorimeter, **ABC-observe** the voxel histogram (dirac sampler +
    MVN approximate logpdf), predict channel + mother momentum.
    ``n_bins``/``max_deposits`` scale the volume (default: the reference's
    35x35x20); tests use a reduced-but-3D volume.

    ``abc_variance`` picks the per-voxel tolerance of the approximate dirac:

    * ``"poisson"`` (default) — the *exact* counting variance of the
      quantized simulator: each voxel is ``n`` deposits of ``_E_DEPOSIT``
      GeV, so Var = ``_E_DEPOSIT * value`` (floor one deposit).  Needed for
      the synthetic source, whose sub-GeV voxel values sit far below the
      regime the reference tolerance was calibrated for.
    * ``"reference"`` — strict parity with ``sherpa.cpp:61``
      (``multivariate_normal(calo_histo, calo_histo)``: Var = value, the
      count-units Poisson formula applied to energy units).  Informative
      only when voxel values are O(1) GeV, i.e. real 45-GeV LEP taus.

    ``abc_tolerance_scale`` multiplies the per-voxel std — the ABC *kernel
    bandwidth*.  At bandwidth 1 the exact counting tolerance over ~25k
    voxels makes the summed log-likelihood spread thousands of nats, so one
    particle carries all the weight (ESS ~ 1) no matter how good the
    proposal is.  NB widening is value-dependent (sigma ~ sqrt(sim)), so
    large scales bias the kernel's normalizer toward low-deposit templates
    — it changes the posterior, not just its sharpness.

    ``abc_temper`` divides the whole ABC log-kernel (a power posterior,
    standard ABC/SMC tempering).  Unlike bandwidth widening this is a
    monotone transform of each template's likelihood: the ranking of
    simulated templates against the observation — and hence the posterior
    mode structure — is preserved EXACTLY at any temperature, while the
    log-weight spread shrinks by the same factor, turning the degenerate
    ESS~1 regime into a usable importance distribution.
    """
    channel, mother, particles = _synthetic_tau_decay()
    calo = calo_simulation(particles, n_bins=n_bins, max_deposits=max_deposits)
    flat = calo.ravel()
    if abc_variance == "poisson":
        std = jnp.sqrt(jnp.maximum(flat * _E_DEPOSIT, _E_DEPOSIT**2))
    elif abc_variance == "reference":
        std = jnp.sqrt(jnp.maximum(flat, 1e-2))
    else:
        raise ValueError(f"unknown abc_variance {abc_variance!r}")
    std = std * abc_tolerance_scale
    approx = MultivariateNormalDiag(flat, std)
    inv_temper = 1.0 / abc_temper
    abc = make_abc(
        sampler=lambda key: flat,
        logpdf_fn=lambda x: inv_temper * approx.log_prob(
            jnp.ravel(jnp.asarray(x, jnp.float32))
        ),
    )
    observe(abc, observed_histo, addr="calo")
    predict(channel, "Decay Channel")
    predict(mother[0], "Momentum X")
    predict(mother[1], "Momentum Y")
    predict(mother[2], "Momentum Z")
    return calo
