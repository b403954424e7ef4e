"""The port's QuantileTransformer scaler against sklearn's, through the
JAX package's MultiChannelScaler, on the same numpy volumes: the same
quantiles_, the transform within 1e-6, and numpy's global random stream
left in the same state (sklearn draws its 10,000-sample subsample from
it)."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from multiplanarunet_tpu.preprocessing import scaling as j_scaling
from multiplanarunet_tpu_torch.preprocessing import scaling as t_scaling


def _volume(shape, seed, constant_channel=None, dtype=np.float32):
    rng = np.random.RandomState(seed)
    vol = (rng.gamma(2.0, 50.0, size=shape) - 20.0).astype(dtype)
    # repeated values, as in a label-like or quantised channel
    vol[::3] = np.round(vol[::3] / 10.0) * 10.0
    if constant_channel is not None:
        vol[..., constant_channel] = 7.0
    return vol


def _fit_both(vol, ignore_less_eq, seed=11):
    np.random.seed(seed)
    j = j_scaling.get_scaler("QuantileTransformer",
                             ignore_less_eq=ignore_less_eq).fit(vol)
    j_state = np.random.get_state()
    j_out = j.transform(vol)
    np.random.seed(seed)
    t = t_scaling.get_scaler("QuantileTransformer",
                             ignore_less_eq=ignore_less_eq).fit(vol)
    t_state = np.random.get_state()
    t_out = t.transform(vol)
    return j, t, (j_state, t_state), (j_out, t_out)


def _check(vol, ignore_less_eq):
    j, t, (j_state, t_state), (j_out, t_out) = _fit_both(vol, ignore_less_eq)
    assert len(t.channels) == vol.shape[-1]
    for sk, ch in zip(j.scalers, t.channels):
        np.testing.assert_array_equal(ch.quantiles_, sk.quantiles_[:, 0])
        np.testing.assert_array_equal(ch.references_, sk.references_)
    assert t_out.dtype == j_out.dtype == vol.dtype
    np.testing.assert_allclose(t_out, j_out, rtol=0, atol=1e-6)
    assert j_state[0] == t_state[0] and j_state[2:] == t_state[2:]
    np.testing.assert_array_equal(j_state[1], t_state[1])
    assert t.affine_params() == (None, None) == j.affine_params()
    assert t_out.min() >= 0 and t_out.max() <= 1
    return t


@pytest.mark.filterwarnings("ignore:n_quantiles")
@pytest.mark.parametrize("shape,ignore,constant", [
    ((12, 12, 12, 1), None, None),        # 1,728 samples: no subsample
    ((24, 24, 24, 1), None, None),        # 13,824: the subsample is drawn
    ((24, 24, 24, 2), None, None),        # one shuffle per channel
    ((24, 24, 24, 2), [30.0, 80.0], None),  # masked: 2 channels, both sides
    ((10, 10, 10, 2), 5.0, 1),            # a constant channel, scalar mask
    ((24, 24, 24, 2), None, 0),           # a constant channel above 10,000
])
def test_quantile_scaler_matches_sklearn(shape, ignore, constant):
    vol = _volume(shape, seed=sum(shape), constant_channel=constant)
    t = _check(vol, ignore)
    if constant is not None:
        out = t.transform(vol)[..., constant]
        assert np.all(out == 0)  # x == q[0] is set to 0 after x == q[-1]


@pytest.mark.filterwarnings("ignore:n_quantiles")
@settings(max_examples=12, deadline=None)
@given(n=st.integers(1, 40), channels=st.integers(1, 2),
       seed=st.integers(0, 2 ** 16), masked=st.booleans(),
       float64=st.booleans())
def test_quantile_scaler_hypothesis(n, channels, seed, masked, float64):
    vol = _volume((n, 17, 19, channels), seed,
                  dtype=np.float64 if float64 else np.float32)
    # the mask keeps at least the largest sample of each channel
    ignore = (float(vol.min()) - 1.0 if not masked
              else [float(np.median(vol[..., c])) - 1e-3
                    for c in range(channels)])
    _check(vol, ignore)


def test_quantile_bg_value_and_nan():
    """The sampler's scaled bg value (a (1, 1, 1, C) transform) and NaN
    pass through as in sklearn."""
    vol = _volume((24, 24, 24, 2), seed=3)
    j, t, _, _ = _fit_both(vol, None)
    bg = np.asarray([-100.0, 40.0], np.float32).reshape(1, 1, 1, 2)
    np.testing.assert_allclose(t.transform(bg), j.transform(bg), atol=1e-6)
    probe = np.asarray([np.nan, 1e9, -1e9], np.float32).reshape(3, 1, 1, 1)
    jj = j_scaling.get_scaler("QuantileTransformer").fit(vol[..., :1])
    tt = t_scaling.get_scaler("QuantileTransformer").fit(vol[..., :1])
    np.testing.assert_allclose(tt.transform(probe), jj.transform(probe),
                               atol=1e-6, equal_nan=True)


def test_assert_scaler_and_apply_scaling():
    for name in ("QuantileTransformer", "RobustScaler", "StandardScaler",
                 "MinMaxScaler", "MaxAbsScaler"):
        assert t_scaling.assert_scaler(name) and j_scaling.assert_scaler(name)
    assert not t_scaling.assert_scaler("NoSuchScaler")
    assert not j_scaling.assert_scaler("NoSuchScaler")
    # a name sklearn has but neither package can fit on a volume: the
    # JAX package accepts the name and fails in the fit, the port refuses
    # it by name
    assert j_scaling.assert_scaler("KernelCenterer")
    assert not t_scaling.assert_scaler("KernelCenterer")
    with pytest.raises(ValueError):
        j_scaling.apply_scaling(np.ones((2, 2, 2, 1)), "KernelCenterer")
    with pytest.raises(t_scaling.UnsupportedScalerError):
        t_scaling.apply_scaling(np.ones((2, 2, 2, 1)), "KernelCenterer")
    vol = _volume((24, 24, 24, 1), seed=5)
    for name in ("QuantileTransformer", "RobustScaler"):
        np.random.seed(0)
        want = j_scaling.apply_scaling(vol, name, ignore_less_eq=0.0)
        np.random.seed(0)
        got = t_scaling.apply_scaling(vol, name, ignore_less_eq=0.0)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
