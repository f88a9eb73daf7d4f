"""Port parity: the disclosure metrics — the frozen conv feature extractor,
KID (both ``small_batch`` modes) and pixel MSE — against the reference,
with the reference's own ``feature_params()`` (PRNGKey 1234) passed in as
numpy arrays, as admission will pass them.

Tolerances: features rtol 1e-5 / atol 1e-6 (f32 convolutions summing in
another order; ~1e-7 measured); KID atol 1e-6 on the same features (a sum
of ~m² kernel values near 1, then a difference); MSE rtol 1e-5 (a float32
mean of thousands of squares summed in another order; ~2e-6 measured).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from _torch_parity import np_tree, set_torch_cpu  # noqa: E402
from repro.core import privacy as jpriv  # noqa: E402
from repro_torch.core import privacy as tpriv  # noqa: E402

set_torch_cpu()

FEAT_TOL = dict(rtol=1e-5, atol=1e-6)
KID_TOL = dict(rtol=1e-4, atol=1e-6)
MSE_RTOL = 1e-5


@pytest.fixture(scope="module")
def ref_params():
    return np_tree(jpriv.feature_params())


def _images(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.uniform(-1, 1, shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(6, 32, 32, 1), (5, 17, 17, 1),
                                   (3, 128, 128, 1)])
def test_extract_features_matches_reference(ref_params, shape):
    """Even sizes pad 0 before and 1 after at stride 2 ("SAME"), odd sizes
    1 and 1; the paper's 128×128 included."""
    x = _images(0, shape)
    ref = np.asarray(jpriv.extract_features(ref_params, jnp.asarray(x)))
    out = tpriv.extract_features(ref_params, torch.from_numpy(x))
    assert out.shape == (shape[0], 256) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **FEAT_TOL)


def test_feature_tolerance_catches_symmetric_padding(ref_params):
    """Conv2d(padding=1) — 1 and 1 at stride 2 on an even size, in place of
    "SAME"'s 0 and 1 — fails the feature tolerance."""
    x = _images(1, (4, 32, 32, 1))
    ref = np.asarray(jpriv.extract_features(ref_params, jnp.asarray(x)))
    h = torch.from_numpy(x).permute(0, 3, 1, 2)
    for w in ref_params["convs"]:
        h = F.leaky_relu(F.conv2d(h, torch.from_numpy(w).permute(3, 2, 0, 1),
                                  stride=2, padding=1), 0.2)
    bad = h.mean(dim=(2, 3)) @ torch.from_numpy(ref_params["head"])
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad.numpy(), ref, **FEAT_TOL)


def test_extract_features_chunked_agrees_with_one_shot(ref_params):
    """Chunked against one-shot to FEAT_TOL — no bitwise claim: the
    reference fails its own (tests/test_collafuse.py::
    test_extract_features_chunked_is_bitwise_stable)."""
    x = torch.from_numpy(_images(2, (40, 16, 16, 1)))
    one = tpriv.extract_features(ref_params, x)
    for chunk in (7, 16, 39):
        np.testing.assert_allclose(
            tpriv.extract_features(ref_params, x, chunk_size=chunk).numpy(),
            one.numpy(), **FEAT_TOL)


@pytest.mark.parametrize("m,n", [(6, 9), (2, 2), (8, 3)])
def test_kid_from_features_matches_reference(ref_params, m, n):
    """Both modes on the same features; with m, n >= 2 the flag changes
    nothing.  The biased V-statistic, which keeps the diagonal, is off by
    far more than KID_TOL: the tolerance tells the estimators apart."""
    fx = np.asarray(jpriv.extract_features(
        ref_params, jnp.asarray(_images(3, (m, 16, 16, 1)))))
    fy = np.asarray(jpriv.extract_features(
        ref_params, jnp.asarray(_images(4, (n, 16, 16, 1), 0.5))))
    ref = float(jpriv.kid_from_features(jnp.asarray(fx), jnp.asarray(fy)))
    for mode in ("error", "biased"):
        out = tpriv.kid_from_features(torch.from_numpy(fx),
                                      torch.from_numpy(fy), small_batch=mode)
        np.testing.assert_allclose(float(out), ref, **KID_TOL)
    tx, ty = torch.from_numpy(fx), torch.from_numpy(fy)
    v_stat = (tpriv._poly_kernel(tx, tx).mean() +
              tpriv._poly_kernel(ty, ty).mean() -
              2 * tpriv._poly_kernel(tx, ty).mean())
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(float(v_stat), ref, **KID_TOL)


def test_kid_single_image_batch(ref_params):
    """m < 2 or n < 2: the reference asserts and the port raises; with
    ``small_batch="biased"`` both return the V-statistic."""
    one = np.asarray(jpriv.extract_features(
        ref_params, jnp.asarray(_images(5, (1, 16, 16, 1)))))
    many = np.asarray(jpriv.extract_features(
        ref_params, jnp.asarray(_images(6, (8, 16, 16, 1)))))
    for a, b in ((one, many), (many, one)):
        with pytest.raises(AssertionError):
            jpriv.kid_from_features(jnp.asarray(a), jnp.asarray(b))
        with pytest.raises(ValueError, match=">= 2 images"):
            tpriv.kid_from_features(torch.from_numpy(a), torch.from_numpy(b))
        ref = float(jpriv.kid_from_features(jnp.asarray(a), jnp.asarray(b),
                                            small_batch="biased"))
        out = tpriv.kid_from_features(torch.from_numpy(a),
                                      torch.from_numpy(b),
                                      small_batch="biased")
        np.testing.assert_allclose(float(out), ref, **KID_TOL)
    with pytest.raises(ValueError, match="small_batch"):
        tpriv.kid_from_features(torch.from_numpy(many),
                                torch.from_numpy(many), small_batch="no")


def test_kid_mse_and_disclosure_report_match_reference(ref_params):
    real = _images(7, (6, 32, 32, 1))
    disc = real + _images(8, (6, 32, 32, 1), 0.3)
    rk = float(jpriv.kid(ref_params, jnp.asarray(real), jnp.asarray(disc)))
    rm = float(jpriv.mse_disclosure(jnp.asarray(real), jnp.asarray(disc)))
    tr, td = torch.from_numpy(real), torch.from_numpy(disc)
    np.testing.assert_allclose(float(tpriv.kid(ref_params, tr, td)), rk,
                               **KID_TOL)
    np.testing.assert_allclose(float(tpriv.mse_disclosure(tr, td)), rm,
                               rtol=MSE_RTOL)
    ref = jpriv.disclosure_report(ref_params, jnp.asarray(real),
                                  jnp.asarray(disc))
    out = tpriv.disclosure_report(ref_params, tr, td)
    assert set(out) == {"mse", "kid"}
    np.testing.assert_allclose(out["mse"], ref["mse"], rtol=MSE_RTOL)
    np.testing.assert_allclose(out["kid"], ref["kid"], **KID_TOL)


def test_port_feature_params_follow_dense_init(ref_params):
    """The port's own weights: the reference's shapes, a fan-in scaled
    normal truncated at ±3σ (std 0.880σ), fixed by the seed."""
    own = tpriv.feature_params()
    assert [tuple(w.shape) for w in own["convs"]] == \
        [w.shape for w in ref_params["convs"]]
    assert tuple(own["head"].shape) == ref_params["head"].shape
    for w in own["convs"] + [own["head"]]:
        fan_in = int(np.prod(w.shape[:-1]))
        z = w * fan_in ** 0.5
        assert float(z.abs().max()) <= 3.0
        assert 0.75 < float(z.std()) < 1.0
    again = tpriv.feature_params()
    assert torch.equal(own["head"], again["head"])
    assert not torch.equal(own["head"], tpriv.feature_params(7)["head"])


def test_kid_orders_distributions_with_the_port_weights():
    """With the port's own weights KID keeps the orderings the paper reads,
    as the reference's tests hold its own: a set against itself is small
    (the unbiased estimator's O(1/m) negative bias) next to a different
    distribution, and a nearby distribution scores below a far one."""
    fp = tpriv.feature_params()
    g = torch.Generator().manual_seed(0)
    a = torch.randn((64, 16, 16, 1), generator=g)
    near = torch.randn((64, 16, 16, 1), generator=g)
    far = torch.randn((64, 16, 16, 1), generator=g) * 0.2 + 0.8
    same, k_far = float(tpriv.kid(fp, a, a)), float(tpriv.kid(fp, a, far))
    assert abs(same) < 1e-2 and abs(same) < 0.2 * abs(k_far)
    assert float(tpriv.kid(fp, a, near)) < k_far
