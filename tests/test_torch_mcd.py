"""The port's ops/mcd (numpy and scipy) against the JAX package's: every case of
tests/test_mcd.py, each run through both packages (`pkg`), and the port's numbers equal
to the JAX package's bit for bit (the same float64 numpy arithmetic)."""

import numpy as np
import pytest

from tacotron2_tpu.config import default_hparams as jax_hparams
from tacotron2_tpu.ops import mcd as jmcd
from tacotron2_tpu_torch.config import default_hparams
from tacotron2_tpu_torch.ops import mcd as tmcd

from test_mcd import _band_mel, _naive_dtw

PACKAGES = {'jax': (jmcd, jax_hparams), 'torch': (tmcd, default_hparams)}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    """(the package's mcd module, its default_hparams)."""
    return PACKAGES[request.param]


def test_dtw_matches_naive(pkg):
    mcd, _ = pkg
    rng = np.random.default_rng(0)
    for shape in ((5, 5), (17, 9), (30, 41)):
        dist = rng.uniform(0.1, 2.0, shape)
        mean, n = mcd.dtw_path_mean(dist)
        assert n >= max(shape) and n <= sum(shape)
        assert abs(mean * n - _naive_dtw(dist)) < 1e-9
        assert (mean, n) == jmcd.dtw_path_mean(dist)


def test_identical_mels_zero_mcd(pkg):
    mcd, hparams = pkg
    hp = hparams()
    rng = np.random.default_rng(1)
    mel = rng.uniform(-hp.max_abs_value, hp.max_abs_value, (40, hp.num_mels))
    assert mcd.mcd_dtw(mel, mel, hp) < 1e-3
    np.testing.assert_array_equal(mcd.mel_cepstra(mel, hp), jmcd.mel_cepstra(mel, jax_hparams()))


def test_dtw_path_endpoints_and_monotonicity(pkg):
    mcd, _ = pkg
    rng = np.random.default_rng(3)
    dist = rng.uniform(0.1, 2.0, (23, 31))
    mean, path = mcd.dtw_path(dist)
    assert tuple(path[0]) == (0, 0) and tuple(path[-1]) == (22, 30)
    steps = np.diff(path, axis=0)
    assert (steps >= 0).all() and (steps.max(axis=1) == 1).all()
    assert abs(mean * len(path) - _naive_dtw(dist)) < 1e-9
    want_mean, want_path = jmcd.dtw_path(dist)
    assert mean == want_mean and np.array_equal(path, want_path)


def test_centroid_corr_dtw_marginalizes_timing_not_content(pkg):
    """Same band sequence with warped timing scores ~1; a different band sequence
    scores well below; each score the JAX package's."""
    mcd, hparams = pkg
    hp = hparams()
    rng = np.random.default_rng(4)
    bands = rng.integers(10, 70, 12)
    a = _band_mel(hp, bands, 10, rng)
    warped = _band_mel(hp, bands, 10, rng, jitter=0.3)
    other = _band_mel(hp, rng.permutation(bands), 10, rng)
    r_warp = mcd.centroid_corr_dtw(a, warped, hp)
    r_other = mcd.centroid_corr_dtw(a, other, hp)
    assert r_warp > 0.97
    assert r_other < r_warp - 0.1
    jhp = jax_hparams()
    assert r_warp == jmcd.centroid_corr_dtw(a, warped, jhp)
    assert r_other == jmcd.centroid_corr_dtw(a, other, jhp)


def test_time_warp_invariance_and_ordering(pkg):
    """A frame-duplicated copy DTW-aligns back to ~0; different content scores higher
    than a warped copy; each distance the JAX package's."""
    mcd, hparams = pkg
    hp = hparams()
    rng = np.random.default_rng(2)
    base = np.cumsum(rng.normal(0, 0.1, (50, hp.num_mels)), axis=0)
    base = np.clip(base, -hp.max_abs_value, hp.max_abs_value)
    warped = np.repeat(base, 2, axis=0)
    other = np.clip(np.cumsum(rng.normal(0, 0.1, (50, hp.num_mels)), axis=0),
                    -hp.max_abs_value, hp.max_abs_value)
    d_warp = mcd.mcd_dtw(base, warped, hp)
    d_other = mcd.mcd_dtw(base, other, hp)
    assert d_warp < 1e-3
    assert d_other > d_warp + 1.0
    jhp = jax_hparams()
    assert (d_warp, d_other) == (jmcd.mcd_dtw(base, warped, jhp), jmcd.mcd_dtw(base, other, jhp))
