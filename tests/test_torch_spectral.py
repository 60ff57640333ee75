"""The port's spectral march, ion integrals and re-emission against JAX's.

The plain spectral march (K2's twin) takes the same numpy packets and
opacities as ``cmacionize_tpu.ops.traversal.trace_packets_spectral``; it
rounds χ_H·σ_H + χ_He·σ_He and the position advance as XLA on the CPU does
(one fused multiply-add each), so flags and positions are bit-equal and the
tally agrees to f32 round-off.  Re-emission draws its own random numbers
(a torch generator cannot reproduce jax.random), so its channel fractions
are compared statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmacionize_torch.models import reemission as trem
from cmacionize_torch.ops import traversal as ttr
from cmacionize_tpu.models import reemission as jrem
from cmacionize_tpu.ops import traversal as jtr

SHAPE = (16, 16, 16)
NCELL = 16**3
N_BINS = 8


def _spectral_inputs(seed, n, transparent):
    rng = np.random.default_rng(seed)
    scale = 1e-3 if transparent else 1.0
    chi_h = (rng.uniform(0.0, 2.0, NCELL) * np.where(rng.uniform(size=NCELL) < 0.5, 1e-3, 1)
             * scale).astype(np.float32)
    chi_he = (rng.uniform(0.0, 0.2, NCELL) * scale).astype(np.float32)
    cos = rng.uniform(-1, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    s = np.sqrt(1 - cos**2)
    d = np.stack([s * np.cos(phi), s * np.sin(phi), cos], 1).astype(np.float32)
    p = (np.array([8.0, 8.0, 8.0]) + 1e-4 * d).astype(np.float32)
    tau = (-np.log1p(-rng.uniform(size=n))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    fbin = rng.integers(0, N_BINS, n).astype(np.int32)
    sh = rng.uniform(0.2, 1.5, n).astype(np.float32)
    she = rng.uniform(0.0, 1.5, n).astype(np.float32)
    return chi_h, chi_he, (p, d, tau, w, sh, she, fbin)


@pytest.mark.parametrize(
    "periodic, transparent",
    [((False,) * 3, False), ((True,) * 3, False), ((False,) * 3, True), ((True, False, True), True)],
    ids=["open", "periodic", "open-transparent", "mixed-transparent"],
)
def test_plain_march_matches_jax(periodic, transparent):
    """Measured (CPU): flags and positions bit-equal, tally rel. L1 0.0."""
    chi_h, chi_he, fields = _spectral_inputs(0, 20000, transparent)
    jp = jtr.make_spectral_packets(*(jnp.asarray(f) for f in fields[:2]),
                                   *(jnp.asarray(f) for f in fields[2:]), SHAPE)
    jt, jout = jtr.trace_packets_spectral(
        jnp.asarray(chi_h), jnp.asarray(chi_he), jp, jnp.zeros(N_BINS * NCELL, jnp.float32),
        shape=SHAPE, n_bins=N_BINS, periodic=periodic)
    tp = ttr.make_spectral_packets(*(torch.tensor(f) for f in fields[:2]),
                                   *(torch.tensor(f) for f in fields[2:]), SHAPE)
    tt, tout = ttr.trace_packets_spectral(
        torch.tensor(chi_h), torch.tensor(chi_he), tp, torch.zeros(N_BINS * NCELL),
        shape=SHAPE, n_bins=N_BINS, periodic=periodic)
    absorbed = np.asarray(jout.absorbed)
    np.testing.assert_array_equal(tout.absorbed.numpy(), absorbed)
    np.testing.assert_array_equal(tout.active.numpy(), np.asarray(jout.active))
    assert 0 < absorbed.sum() <= len(absorbed)
    if not transparent or all(periodic):
        assert absorbed.sum() < len(absorbed) or all(periodic)
    for f in ("px", "py", "pz", "cx", "cy", "cz", "tau_left"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                                      err_msg=f)
    jt = np.asarray(jt)
    assert np.abs(tt.numpy() - jt).sum() <= 1e-6 * np.abs(jt).sum()


def test_inactive_packets_are_left_alone():
    chi_h, chi_he, fields = _spectral_inputs(1, 1000, False)
    tp = ttr.make_spectral_packets(*(torch.tensor(f) for f in fields[:2]),
                                   *(torch.tensor(f) for f in fields[2:]), SHAPE)
    active = torch.arange(1000) % 2 == 0
    tp = tp._replace(active=active)
    tally, out = ttr.trace_packets_spectral(
        torch.tensor(chi_h), torch.tensor(chi_he), tp, torch.zeros(N_BINS * NCELL),
        shape=SHAPE, n_bins=N_BINS)
    assert not out.absorbed[~active].any()
    np.testing.assert_array_equal(out.px[~active].numpy(), tp.px[~active].numpy())
    assert out.absorbed[active].any()


def test_tally_size_is_checked():
    chi_h, chi_he, fields = _spectral_inputs(1, 10, False)
    tp = ttr.make_spectral_packets(*(torch.tensor(f) for f in fields[:2]),
                                   *(torch.tensor(f) for f in fields[2:]), SHAPE)
    with pytest.raises(ValueError):
        ttr.trace_packets_spectral(torch.tensor(chi_h), torch.tensor(chi_he), tp,
                                   torch.zeros(NCELL), shape=SHAPE, n_bins=N_BINS)


def test_spectral_tallies_to_ion_integrals():
    """f32 products whose sums run in another order: within 1e-5 relative."""
    rng = np.random.default_rng(4)
    n_bins, ncell = 64, 512
    tally = rng.uniform(0, 3, n_bins * ncell).astype(np.float32)
    sigma = (rng.uniform(0, 6e-22, (14, n_bins))).astype(np.float32)
    heat = (rng.uniform(0, 1e-6, (2, n_bins))).astype(np.float32)
    ref = np.asarray(jtr.spectral_tallies_to_ion_integrals(
        jnp.asarray(tally), jnp.asarray(sigma), jnp.asarray(heat), ncell))
    got = ttr.spectral_tallies_to_ion_integrals(
        torch.tensor(tally), torch.tensor(sigma), torch.tensor(heat), ncell)
    assert got.dtype == torch.float32 and got.shape == (16, ncell)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_reemission_spectra_tables_equal():
    ref = jrem.ReemissionSpectra.build()
    got = trem.ReemissionSpectra.build()
    for field in ("temperatures", "frequencies", "h_lyc_cdf", "he_lyc_cdf",
                  "he_2pc_freqs", "he_2pc_cdf"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field), err_msg=field)


def test_reemission_probabilities():
    T = np.geomspace(1500.0, 3e4, 200).astype(np.float32)
    p_ref, c_ref = jrem.reemission_probabilities(jnp.asarray(T))
    p_got, c_got = trem.reemission_probabilities(torch.tensor(T))
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_ref), rtol=1e-6)
    for g, r in zip(c_got, c_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    np.testing.assert_allclose(c_got[3].numpy(), 1.0, rtol=1e-6)


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(6)
    xp = np.sort(rng.uniform(0, 1, 50)).astype(np.float32)
    xp[10] = xp[11]  # a zero-width interval
    fp = rng.uniform(0, 5, 50).astype(np.float32)
    x = rng.uniform(-0.2, 1.2, 2000).astype(np.float32)
    ref = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    got = trem.interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_tdep_sampler_is_a_left_search_of_the_nearest_row():
    spectra = trem.ReemissionSpectra.build().on_device("cpu")
    g = torch.Generator().manual_seed(0)
    T = torch.rand(3000, generator=g) * 14000 + 1000
    xi = torch.rand(3000, generator=g)
    got = spectra._sample_tdep(spectra.he_lyc_cdf, xi, T).numpy()
    rows_np = spectra.he_lyc_cdf.numpy()
    freqs = spectra.frequencies.numpy()
    iT = np.clip(((T.double().numpy() - spectra.t0) / spectra.dT + 0.5).astype(np.int32), 0, 63)
    for k in range(3000):
        row = rows_np[iT[k]]
        i = min(max(np.searchsorted(row, xi[k].numpy()), 1), len(row) - 1)
        frac = (xi[k].numpy() - row[i - 1]) / np.maximum(row[i] - row[i - 1], np.float32(1e-12))
        assert got[k] == pytest.approx(freqs[i - 1] + frac * (freqs[i] - freqs[i - 1]), rel=1e-6)


def _channels(reemit, freq, h_channel):
    """Fractions of all packets: re-emitted, H LyC, He 19.8 eV line, He LyC,
    He two-photon continuum; and the mean H LyC frequency."""
    he = reemit & ~h_channel
    line = he & (freq == np.float32(trem.FREQ_19P8EV))
    lyc = he & (freq >= 1.81 * trem.NU_MIN * (1 - 1e-6))
    tpc = he & ~line & ~lyc
    return [reemit.mean(), (reemit & h_channel).mean(), line.mean(), lyc.mean(), tpc.mean()]


def test_reemit_batch_channel_fractions():
    """1e5 absorbed packets in the same cells: each channel fraction within
    4 sigma of JAX's (the JAX Lyα → two-photon frequencies are drawn from
    the reused key, ROADMAP queue 3, so only channels are compared)."""
    n = 100_000
    rng = np.random.default_rng(8)
    absorbed = rng.uniform(size=n) < 0.9
    sig_h = rng.uniform(0.5e-22, 6e-22, n).astype(np.float32)
    sig_he = rng.uniform(0.0, 7e-22, n).astype(np.float32)
    xH = (10.0 ** rng.uniform(-4, 0, n)).astype(np.float32)
    xHe = (10.0 ** rng.uniform(-3, 0, n)).astype(np.float32)
    T = rng.uniform(4000, 12000, n).astype(np.float32)
    jspec = jrem.ReemissionSpectra.build()
    ref = jrem.reemit_batch(jax.random.PRNGKey(3), jspec, jnp.asarray(absorbed),
                            jnp.asarray(sig_h), jnp.asarray(sig_he), jnp.asarray(xH),
                            jnp.asarray(xHe), jnp.asarray(T), 0.1)
    ref = [np.asarray(a) for a in ref]
    g = torch.Generator().manual_seed(3)
    got = trem.reemit_batch(g, trem.ReemissionSpectra.build().on_device("cpu"),
                            torch.tensor(absorbed), torch.tensor(sig_h), torch.tensor(sig_he),
                            torch.tensor(xH), torch.tensor(xHe), torch.tensor(T), 0.1)
    got = [a.numpy() for a in got]
    assert got[1].dtype == np.float32
    assert not got[0][~absorbed].any()
    for p_ref, p_got in zip(_channels(*ref), _channels(*got)):
        sigma = np.sqrt(2.0 * max(p_ref, 1.0 / n) * (1.0 - p_ref) / n)
        assert abs(p_got - p_ref) <= 4.0 * sigma, (p_got, p_ref)
    h_ref = ref[1][ref[0] & ref[2]]
    h_got = got[1][got[0] & got[2]]
    sem = np.sqrt(h_ref.var() / h_ref.size + h_got.var() / h_got.size)
    assert abs(h_got.mean() - h_ref.mean()) <= 4.0 * sem
