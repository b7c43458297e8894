"""Descriptor matching tests (counterpart of reference feature.cc behavior)."""

import numpy as np
import jax.numpy as jnp
import pytest

from mavmap_tpu.ops import matching


def _make_descriptors(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_exact_match(rng):
    d1 = _make_descriptors(rng, 64)
    perm = rng.permutation(64)
    d2 = d1[perm] + rng.normal(size=(64, 128)).astype(np.float32) * 0.01
    matches, ok = matching.match_brute_force(jnp.asarray(d1), jnp.asarray(d2))
    m = np.asarray(matches)
    assert np.asarray(ok).sum() >= 60
    good = np.asarray(ok)
    inv = np.argsort(perm)
    assert (m[good] == inv[np.arange(64)][good]).all()


def test_ratio_test_rejects_ambiguous(rng):
    d1 = _make_descriptors(rng, 8)
    # d2 contains two near-identical copies of each descriptor -> ambiguous.
    d2 = np.concatenate([d1 + 0.001, d1 + 0.0011], axis=0).astype(np.float32)
    matches, ok = matching.match_brute_force(
        jnp.asarray(d1), jnp.asarray(d2), ratio=0.9
    )
    assert np.asarray(ok).sum() == 0


def test_cross_check(rng):
    d1 = _make_descriptors(rng, 16)
    # Two rows of d1 map to the same d2 descriptor: cross-check keeps at most
    # the mutual pair.
    d2 = d1.copy()
    d1_dup = d1.copy()
    d1_dup[1] = d1[0] + 0.001 * rng.normal(size=128).astype(np.float32)
    matches, ok = matching.match_brute_force(jnp.asarray(d1_dup), jnp.asarray(d2))
    m = np.asarray(matches)
    # Row 0 and row 1 both point at d2[0]; only one may survive.
    assert not (np.asarray(ok)[0] and np.asarray(ok)[1])


def test_masks_exclude_padding(rng):
    d1 = _make_descriptors(rng, 32)
    d2 = d1 + rng.normal(size=(32, 128)).astype(np.float32) * 0.01
    mask1 = np.ones(32, bool); mask1[20:] = False
    mask2 = np.ones(32, bool); mask2[25:] = False
    matches, ok = matching.match_brute_force(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask1), jnp.asarray(mask2)
    )
    okn = np.asarray(ok)
    m = np.asarray(matches)
    assert not okn[20:].any()
    assert (m[okn] < 25).all()


def test_max_distance_prefilter(rng):
    d1 = _make_descriptors(rng, 16)
    d2 = d1 + rng.normal(size=(16, 128)).astype(np.float32) * 0.01
    kp1 = rng.uniform(0, 100, size=(16, 2)).astype(np.float32)
    kp2 = kp1 + 200.0  # all pairs farther than 50 px
    matches, ok = matching.match_brute_force(
        jnp.asarray(d1), jnp.asarray(d2),
        kp1=jnp.asarray(kp1), kp2=jnp.asarray(kp2), max_distance=50.0,
    )
    assert np.asarray(ok).sum() == 0


def test_median_disparity(rng):
    kp1 = jnp.asarray(rng.uniform(0, 100, size=(10, 2)), jnp.float32)
    shift = jnp.asarray([3.0, 4.0])
    kp2 = kp1 + shift  # disparity 5 everywhere
    matches = jnp.arange(10, dtype=jnp.int32)
    valid = jnp.ones(10, bool)
    med = matching.median_feature_disparity(kp1, kp2, matches, valid)
    assert abs(float(med) - 5.0) < 1e-5
    # With half invalid, still 5.
    valid2 = valid.at[5:].set(False)
    med2 = matching.median_feature_disparity(kp1, kp2, matches, valid2)
    assert abs(float(med2) - 5.0) < 1e-5


def test_batch_match_counts_pairs_matches_per_query(rng):
    """The one-round-trip pair-counts pre-gate equals the per-query
    batched counts (same matcher, same ratio)."""
    import numpy as np
    from mavmap_tpu.features import ArrayFeatureProvider
    from mavmap_tpu.sfm import SequentialMapper, SequentialMapperOptions

    F, D, N = 96, 32, 6
    base = rng.normal(size=(F, D)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    feats = []
    for i in range(N):
        d = base + rng.normal(size=(F, D)).astype(np.float32) * (0.02 + 0.1 * i)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        feats.append((np.zeros((F, 2), np.float32), d))
    prov = ArrayFeatureProvider(feats, capacity=F)
    m = SequentialMapper(np.zeros(N, np.int32), np.array([1], np.int32),
                         np.zeros((1, 9), np.float32), prov)
    opts = SequentialMapperOptions()

    pairs = [(0, 1), (0, 3), (2, 5), (4, 1), (3, 3)]
    got = m._batch_match_counts_pairs(pairs, opts)
    for (a, b), n in zip(pairs, got):
        ref = m._batch_match_counts(a, [b], opts)
        assert int(n) == int(ref[0]), (a, b, n, ref)


# ------------------------------------------------ float64 reference checks
#
# The matcher against the plain float64 2-NN / ratio / cross-check
# reference of chip_smoke.py (which runs the same comparison on the card):
# identical match sets and validity masks.


def _pair(rng, n1, n2, noise=0.05):
    d1 = _make_descriptors(rng, n1)
    take = min(n1, n2)
    d2 = np.concatenate([
        d1[rng.permutation(n1)[:take]]
        + rng.normal(size=(take, 128)).astype(np.float32) * noise,
        rng.normal(size=(n2 - take, 128)).astype(np.float32),
    ])
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return d1, d2, rng.random(n1) > 0.1, rng.random(n2) > 0.1


@pytest.mark.parametrize("n1,n2", [(256, 256), (2048, 2048), (200, 200),
                                   (130, 70), (96, 257)])
def test_matches_float64_reference(n1, n2):
    """Masked pairs: square, 2048-wide, and ragged capacities."""
    from chip_smoke import np_match

    rng = np.random.default_rng(n1 * 7 + n2)
    d1, d2, m1, m2 = _pair(rng, n1, n2)
    ref_m, ref_ok = np_match(d1, d2, m1, m2)
    mt, ok = matching.match_brute_force(*map(jnp.asarray, (d1, d2, m1, m2)))
    assert mt.shape == (n1,)
    np.testing.assert_array_equal(np.asarray(mt), ref_m)
    np.testing.assert_array_equal(np.asarray(ok), ref_ok)
    assert ref_ok.sum() > 0.5 * min(n1, n2)


def test_pixel_prefilter_matches_float64_reference():
    from chip_smoke import np_match

    rng = np.random.default_rng(5)
    F = 256
    d1, d2, m1, m2 = _pair(rng, F, F)
    kp1 = rng.uniform(0, 800, size=(F, 2)).astype(np.float32)
    kp2 = rng.uniform(0, 800, size=(F, 2)).astype(np.float32)
    ref_m, ref_ok = np_match(d1, d2, m1, m2, kp1, kp2, max_distance=300.0)
    mt, ok = matching.match_brute_force(
        *map(jnp.asarray, (d1, d2, m1, m2, kp1, kp2)), max_distance=300.0)
    np.testing.assert_array_equal(np.asarray(mt), ref_m)
    np.testing.assert_array_equal(np.asarray(ok), ref_ok)
    unfiltered = np_match(d1, d2, m1, m2)[1].sum()
    assert 0 < ref_ok.sum() < unfiltered  # the prefilter really rejects


def test_vmapped_batch_matches_float64_reference():
    """The batched form the closure sweep and back-fill use."""
    import jax
    from chip_smoke import np_match

    rng = np.random.default_rng(9)
    pairs = [_pair(rng, 128, 128) for _ in range(3)]
    stacked = [jnp.asarray(np.stack([p[k] for p in pairs])) for k in range(4)]
    mt, ok = jax.vmap(matching.match_brute_force)(*stacked)
    for b, p in enumerate(pairs):
        ref_m, ref_ok = np_match(*p)
        np.testing.assert_array_equal(np.asarray(mt)[b], ref_m)
        np.testing.assert_array_equal(np.asarray(ok)[b], ref_ok)


def test_two_view_init_matches_float64_reference():
    """two_view_init's packed match and validity columns equal the
    reference match set."""
    import jax
    from chip_smoke import np_match
    from mavmap_tpu.sfm.kernels import two_view_init

    rng = np.random.default_rng(3)
    F = 128
    d1, d2, m1, m2 = _pair(rng, F, F)
    kp1 = rng.uniform(0, 800, size=(F, 2)).astype(np.float32)
    kp2 = kp1 + rng.normal(size=(F, 2)).astype(np.float32) * 8.0
    rows, _ = two_view_init(
        jax.random.PRNGKey(3),
        *map(jnp.asarray, (kp1, d1, m1, (kp1 - 400.0) / 700.0,
                           kp2, d2, m2, (kp2 - 400.0) / 700.0)),
        jnp.float32(0.9), jnp.float32(1e9), jnp.float32(4.0 / 700.0),
        essential_trials=64, hom_trials=32)
    ref_m, ref_ok = np_match(d1, d2, m1, m2)
    rows = np.asarray(rows)
    np.testing.assert_array_equal(rows[:, 1] > 0.5, ref_ok)
    np.testing.assert_array_equal(rows[ref_ok, 0].astype(np.int64),
                                  ref_m[ref_ok])
