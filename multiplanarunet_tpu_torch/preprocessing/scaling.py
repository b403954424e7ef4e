"""Per-channel volume normalization, in numpy.

Port of `multiplanarunet_tpu/preprocessing/scaling.py` without sklearn.
The JAX package fits one `sklearn.preprocessing` class per channel, by
name and with any constructor arguments, on the channel's samples as one
(n, 1) column. Each class it can run on a volume has a per-channel class
here (`CHANNELS`) that computes what sklearn 1.9 computes, with sklearn's
constructor signature: `fit(x)` takes a channel's samples (1-D) and
`transform(x)` an array of any shape. An argument sklearn does not have
raises `TypeError`, as sklearn's constructor does; one that sklearn has
but the port does not implement raises `UnsupportedScalerError` naming
it.

- Affine (x -> (x - center) / scale, one fused float32 transform over
  all channels, as in the JAX package): StandardScaler, MinMaxScaler,
  MaxAbsScaler, RobustScaler. Their (center, scale) are what the JAX
  package reads from the fitted sklearn object, so its quirks carry over:
  StandardScaler(with_mean=False) still centres on the mean when it
  scales, and MinMaxScaler(clip=True) does not clip.
- QuantileTransformer: sklearn's quantiles (a subsample drawn from
  numpy's global random stream, or from `random_state`) and transform,
  uniform or normal (`scipy.stats.norm.ppf`, clipped as sklearn clips).
- PowerTransformer: lambda by `scipy.stats.yeojohnson` / `boxcox` (Brent
  over every sample of the channel), then sklearn's StandardScaler.
- Normalizer, Binarizer, FunctionTransformer, LabelEncoder,
  OrdinalEncoder. The encoders raise `ValueError` on a value not seen in
  the fit, as sklearn does; the output of every non-affine transform has
  the input volume's dtype.

The sklearn classes the JAX package cannot run on a volume either raise
`UnsupportedScalerError` (`REFUSED`, with the reason). It subclasses
ValueError, so one `except` catches the refusal in both packages.
"""

from __future__ import annotations

import numbers
import warnings

import numpy as np

# sklearn.preprocessing's QuantileTransformer constant
BOUNDS_THRESHOLD = 1e-7


class UnsupportedScalerError(ValueError):
    """A scaler name or argument the port does not implement."""


# The sklearn.preprocessing classes that fit no volume in the JAX package
# either (its per-channel fit on one (n, 1) column raises for each)
REFUSED = {
    "KBinsDiscretizer": "gives one output column per bin, which cannot be "
                        "reshaped into the volume",
    "OneHotEncoder": "gives one output column per category",
    "MultiLabelBinarizer": "gives one output column per label",
    "PolynomialFeatures": "gives one output column per power of the input",
    "SplineTransformer": "gives one output column per spline",
    "KernelCenterer": "centres a square kernel matrix, not a column",
    "LabelBinarizer": "rejects a continuous target",
    "TargetEncoder": "needs a target y, which a volume has not",
}


def _handle_zeros_in_scale(scale, constant_mask=None):
    """sklearn's rule: scales that are (near) zero become 1."""
    scale = np.array(scale, copy=True)
    if constant_mask is None:
        constant_mask = scale < 10 * np.finfo(scale.dtype).eps
    scale[constant_mask] = 1.0
    return scale


def _is_constant_feature(var, mean, n_samples):
    """sklearn's test of a variance against the 2-pass error bound."""
    eps = np.finfo(np.float64).eps
    return var <= n_samples * eps * var + (n_samples * mean * eps) ** 2


def _as_float(x):
    """sklearn's input check: float16/32/64 kept, anything else float64."""
    x = np.asarray(x)
    if x.dtype in (np.float64, np.float32, np.float16):
        return x
    return x.astype(np.float64)


def _check_finite(x, name):
    """sklearn's check_array(ensure_all_finite=True)."""
    x = np.asarray(x)
    if x.dtype.kind == "f" and not np.isfinite(x).all():
        what = "NaN" if np.isnan(x).any() else "infinity"
        raise ValueError(f"Input X contains {what}. {name} does not accept "
                         f"missing or infinite values")


def _random_state(seed):
    """sklearn's check_random_state."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a "
                     f"numpy.random.RandomState instance")


def _refuse(cls, **given):
    """UnsupportedScalerError for each sklearn argument of `cls` the port
    does not implement that is given a value other than sklearn's
    default."""
    for name, (value, default) in given.items():
        if value is not default and value != default:
            raise UnsupportedScalerError(
                f"{cls}({name}={value!r}) is not implemented by the PyTorch "
                f"port (it takes {name}={default!r} only)")


# ------------------------------------------------------------------ affine
class _Affine:
    """A channel scaler that is x -> (x - center) / scale."""

    center = scale = None

    def transform(self, x):
        x = np.asarray(x)
        return ((x - np.float32(self.center)) / np.float32(self.scale)
                ).astype(x.dtype, copy=False)


class StandardScaler(_Affine):
    def __init__(self, *, copy=True, with_mean=True, with_std=True):
        self.with_mean, self.with_std = bool(with_mean), bool(with_std)

    def fit(self, x):
        if not (self.with_mean or self.with_std):  # mean_ and scale_ None
            self.center, self.scale = 0.0, 1.0
            return self
        n = x.shape[0]
        mean = np.nansum(x, dtype=np.float64) / n
        temp = x - mean
        correction = np.nansum(temp)
        var = (np.nansum(temp ** 2) - correction ** 2 / n) / n
        scale = _handle_zeros_in_scale(
            np.sqrt(np.atleast_1d(var)),
            np.atleast_1d(_is_constant_feature(var, mean, n)))[0]
        self.center = float(mean)
        self.scale = float(scale) if self.with_std else 1.0
        return self


class MinMaxScaler(_Affine):
    def __init__(self, feature_range=(0, 1), *, copy=True, clip=False):
        if feature_range[0] >= feature_range[1]:
            raise ValueError("Minimum of desired feature range must be "
                             f"smaller than maximum. Got {feature_range}.")
        self.feature_range, self.clip = tuple(feature_range), bool(clip)

    def fit(self, x):
        lo, hi = (np.asarray(v, dtype=x.dtype) for v in self.feature_range)
        data_min, data_max = np.nanmin(x), np.nanmax(x)
        scale_ = (hi - lo) / _handle_zeros_in_scale(
            np.atleast_1d(data_max - data_min))[0]
        min_ = lo - data_min * scale_
        self.center = -float(min_) / float(scale_)
        self.scale = 1.0 / float(scale_)
        return self


class MaxAbsScaler(_Affine):
    def __init__(self, *, copy=True):
        pass

    def fit(self, x):
        self.center = 0.0
        self.scale = float(_handle_zeros_in_scale(
            np.atleast_1d(np.nanmax(np.abs(x))))[0])
        return self


class RobustScaler(_Affine):
    def __init__(self, *, with_centering=True, with_scaling=True,
                 quantile_range=(25.0, 75.0), copy=True,
                 unit_variance=False):
        q_min, q_max = quantile_range
        if not 0 <= q_min <= q_max <= 100:
            raise ValueError(f"Invalid quantile range: {quantile_range}")
        self.with_centering = bool(with_centering)
        self.with_scaling = bool(with_scaling)
        self.quantile_range = tuple(quantile_range)
        self.unit_variance = bool(unit_variance)

    def fit(self, x):
        self.center = (float(np.nanmedian(x)) if self.with_centering
                       else 0.0)
        self.scale = 1.0
        if self.with_scaling:
            q = np.nanpercentile(x, self.quantile_range)
            scale = _handle_zeros_in_scale(np.atleast_1d(q[1] - q[0]))
            if self.unit_variance:
                from scipy import stats

                q_min, q_max = self.quantile_range
                scale = scale / (stats.norm.ppf(q_max / 100.0)
                                 - stats.norm.ppf(q_min / 100.0))
            self.scale = float(scale[0])
        return self


# -------------------------------------------------------------- non-affine
class QuantileTransformer:
    def __init__(self, *, n_quantiles=1000, output_distribution="uniform",
                 ignore_implicit_zeros=False, subsample=10_000,
                 random_state=None, copy=True):
        if output_distribution not in ("uniform", "normal"):
            raise ValueError(f"output_distribution must be 'uniform' or "
                             f"'normal', got {output_distribution!r}")
        if subsample is not None and n_quantiles > subsample:
            raise ValueError(
                "The number of quantiles cannot be greater than the number "
                f"of samples used. Got {n_quantiles} quantiles and "
                f"{subsample} samples.")
        self.n_quantiles = int(n_quantiles)
        self.output_distribution = output_distribution
        self.ignore_implicit_zeros = bool(ignore_implicit_zeros)
        self.subsample = subsample
        self.random_state = random_state
        self.quantiles_ = self.references_ = None

    def fit(self, x):
        x = _as_float(x).reshape(-1, 1)
        n = x.shape[0]
        if n < 1:
            raise ValueError("QuantileTransformer: a channel has no "
                             "samples to fit")
        if self.n_quantiles > n:
            warnings.warn(f"n_quantiles ({self.n_quantiles}) is greater "
                          f"than the total number of samples ({n}). "
                          f"n_quantiles is set to n_samples.")
        rng = _random_state(self.random_state)
        self.references_ = np.linspace(0, 1, max(1, min(self.n_quantiles, n)),
                                       endpoint=True)
        if self.ignore_implicit_zeros:
            warnings.warn("'ignore_implicit_zeros' takes effect only with "
                          "sparse matrix. This parameter has no effect.")
        if self.subsample is not None and self.subsample < n:
            # sklearn.utils.resample(replace=False)
            idx = np.arange(n)
            rng.shuffle(idx)
            x = x[idx[:self.subsample]]
        self.quantiles_ = np.nanpercentile(x, self.references_ * 100,
                                           axis=0)[:, 0]
        return self

    def transform(self, x):
        """sklearn's _transform_col: uniform output in [0, 1] or its
        clipped normal quantile, in x's float dtype (NaN stays NaN)."""
        q, r = self.quantiles_, self.references_
        x = np.array(_as_float(x), copy=True)
        normal = self.output_distribution == "normal"
        with np.errstate(invalid="ignore"):
            if normal:
                lower = x - BOUNDS_THRESHOLD < q[0]
                upper = x + BOUNDS_THRESHOLD > q[-1]
            else:
                lower = x == q[0]
                upper = x == q[-1]
        finite = ~np.isnan(x)
        xf = x[finite]
        x[finite] = 0.5 * (np.interp(xf, q, r)
                           - np.interp(-xf, -q[::-1], -r[::-1]))
        x[upper] = 1
        x[lower] = 0
        if normal:
            from scipy import stats

            with np.errstate(invalid="ignore"):
                x[...] = np.clip(
                    stats.norm.ppf(x),
                    stats.norm.ppf(BOUNDS_THRESHOLD - np.spacing(1)),
                    stats.norm.ppf(1 - (BOUNDS_THRESHOLD - np.spacing(1))))
        return x


class PowerTransformer:
    def __init__(self, method="yeo-johnson", *, standardize=True,
                 copy=True):
        if method not in ("yeo-johnson", "box-cox"):
            raise ValueError(f"method must be 'yeo-johnson' or 'box-cox', "
                             f"got {method!r}")
        self.method, self.standardize = method, bool(standardize)
        self.lambda_ = None
        self._scaler = None

    def _check_positive(self, x):
        if self.method == "box-cox" and np.nanmin(x) <= 0:
            raise ValueError("The Box-Cox transformation can only be "
                             "applied to strictly positive data")

    def _transform_function(self):
        from scipy import special, stats

        return (stats.yeojohnson if self.method == "yeo-johnson"
                else special.boxcox)

    def fit(self, x):
        from scipy import stats

        x = np.array(_as_float(x).reshape(-1), copy=True)
        self._check_positive(x)
        n = x.shape[0]
        mean = np.mean(x, dtype=np.float64)
        var = np.var(x, dtype=np.float64)
        # lambda in x's dtype, as sklearn's lambdas_
        lmbda = np.empty(1, dtype=x.dtype)
        with np.errstate(invalid="ignore"):
            if (self.method == "yeo-johnson"
                    and _is_constant_feature(var, mean, n)):
                lmbda[0] = 1.0  # the identity: x is left as it is
            else:
                finite = x[~np.isnan(x)]
                if self.method == "box-cox" and not finite.size:
                    raise ValueError("Column must not be all nan.")
                fit = (stats.yeojohnson if self.method == "yeo-johnson"
                       else stats.boxcox)
                lmbda[0] = fit(finite, lmbda=None)[1]
                if self.standardize:
                    x[:] = self._transform_function()(x, lmbda[0])
        self.lambda_ = lmbda[0]
        if self.standardize:
            self._scaler = StandardScaler().fit(x)
        return self

    def transform(self, x):
        x = np.array(_as_float(x), copy=True)
        self._check_positive(x)
        with np.errstate(invalid="ignore"):
            x[...] = self._transform_function()(x.reshape(-1), self.lambda_
                                               ).reshape(x.shape)
        if self.standardize:
            # sklearn's StandardScaler.transform: two in-place ops in x's
            # dtype
            x -= np.asarray(self._scaler.center, x.dtype)
            x /= np.asarray(self._scaler.scale, x.dtype)
        return x


class Normalizer:
    def __init__(self, norm="l2", *, copy=True):
        if norm not in ("l1", "l2", "max"):
            raise ValueError(f"norm must be 'l1', 'l2' or 'max', got "
                             f"{norm!r}")
        self.norm = norm

    def fit(self, x):
        _check_finite(x, "Normalizer")
        return self

    def transform(self, x):
        """sklearn's normalize() of each (1-element) row: x / |x| by the
        chosen norm, 0 where x is 0."""
        _check_finite(x, "Normalizer")
        col = np.array(_as_float(x), copy=True).reshape(-1, 1)
        if self.norm == "l1":
            norms = np.sum(np.abs(col), axis=1)
        elif self.norm == "l2":
            norms = np.sqrt(np.einsum("ij,ij->i", col, col))
        else:
            norms = np.max(np.abs(col), axis=1)
        col /= _handle_zeros_in_scale(norms)[:, None]
        return col.reshape(np.shape(x))


class Binarizer:
    def __init__(self, *, threshold=0.0, copy=True):
        self.threshold = threshold

    def fit(self, x):
        _check_finite(x, "Binarizer")
        return self

    def transform(self, x):
        _check_finite(x, "Binarizer")
        x = np.array(x, copy=True)
        cond = _as_float(x) > self.threshold
        x[cond] = 1
        x[~cond] = 0
        return x


def _identity(x):
    return x


class FunctionTransformer:
    def __init__(self, func=None, inverse_func=None, *, validate=False,
                 accept_sparse=False, check_inverse=True,
                 feature_names_out=None, kw_args=None, inv_kw_args=None):
        for name, f in (("func", func), ("inverse_func", inverse_func)):
            if f is not None and not callable(f):
                raise TypeError(f"FunctionTransformer: {name} must be a "
                                f"callable or None, got {f!r}")
        self.func, self.inverse_func = func, inverse_func
        self.validate, self.check_inverse = bool(validate), bool(check_inverse)
        self.kw_args, self.inv_kw_args = kw_args, inv_kw_args

    def _apply(self, func, kw_args, col):
        if self.validate:
            _check_finite(col, "FunctionTransformer(validate=True)")
        return (func or _identity)(col, **(kw_args or {}))

    def fit(self, x):
        """sklearn's fit: with both functions given, warn when they are
        not each other's inverse on every 1/100th sample."""
        col = np.asarray(x).reshape(-1, 1)
        if self.check_inverse and not (self.func is None
                                       or self.inverse_func is None):
            picked = col[::max(1, col.shape[0] // 100)]
            round_trip = self._apply(self.inverse_func, self.inv_kw_args,
                                     self._apply(self.func, self.kw_args,
                                                 picked))
            if not np.allclose(picked, round_trip, rtol=1e-7, atol=1e-9):
                warnings.warn("The provided functions are not strictly "
                              "inverse of each other. If you are sure you "
                              "want to proceed regardless, set "
                              "'check_inverse=False'.", UserWarning)
        return self

    def transform(self, x):
        """func applied to the (n, 1) column, as the JAX package calls it."""
        out = self._apply(self.func, self.kw_args,
                          np.asarray(x).reshape(-1, 1))
        return np.asarray(out).reshape(np.shape(x))


def _unseen(values, known):
    """The values of `values` not in the sorted `known` (NaN matches NaN),
    and the mask of the values that are known."""
    if not len(known):
        return np.unique(values).tolist(), np.zeros(values.shape, bool)
    idx = np.clip(np.searchsorted(known, values), 0, len(known) - 1)
    found = known[idx]
    mask = (found == values) | (np.isnan(found) & np.isnan(values)
                                if values.dtype.kind == "f" else False)
    return np.unique(values[~mask]).tolist(), mask


class LabelEncoder:
    def __init__(self):
        self.classes_ = None

    def fit(self, x):
        self.classes_ = np.unique(np.asarray(x).reshape(-1))
        return self

    def transform(self, x):
        """Each value's index in the sorted classes; ValueError on a value
        the fit did not see."""
        values = np.asarray(x, dtype=self.classes_.dtype)
        diff, _ = _unseen(values.reshape(-1), self.classes_)
        if diff:
            raise ValueError(f"y contains previously unseen labels: {diff}")
        return np.searchsorted(self.classes_, values)


class OrdinalEncoder:
    def __init__(self, *, categories="auto", dtype=np.float64,
                 handle_unknown="error", unknown_value=None,
                 encoded_missing_value=np.nan, min_frequency=None,
                 max_categories=None):
        _refuse("OrdinalEncoder", categories=(categories, "auto"),
                min_frequency=(min_frequency, None),
                max_categories=(max_categories, None))
        if handle_unknown not in ("error", "use_encoded_value"):
            raise ValueError(f"handle_unknown must be 'error' or "
                             f"'use_encoded_value', got {handle_unknown!r}")
        if handle_unknown == "use_encoded_value":
            if _is_nan(unknown_value):
                if np.dtype(dtype).kind != "f":
                    raise ValueError(
                        "When unknown_value is np.nan, the dtype parameter "
                        f"should be a float dtype. Got {dtype}.")
            elif not isinstance(unknown_value, numbers.Integral):
                raise TypeError(
                    "unknown_value should be an integer or np.nan when "
                    f"handle_unknown is 'use_encoded_value', got "
                    f"{unknown_value}.")
        elif unknown_value is not None:
            raise TypeError(
                "unknown_value should only be set when handle_unknown is "
                f"'use_encoded_value', got {unknown_value}.")
        self.dtype, self.handle_unknown = dtype, handle_unknown
        self.unknown_value = unknown_value
        self.encoded_missing_value = encoded_missing_value
        self.categories_ = None

    def fit(self, x):
        cats = np.unique(np.asarray(x).reshape(-1))
        self.categories_ = cats
        self._missing = cats.dtype.kind == "f" and cats.size and np.isnan(
            cats[-1])
        cardinality = len(cats) - int(bool(self._missing))
        if (self.handle_unknown == "use_encoded_value"
                and 0 <= self.unknown_value < cardinality):
            raise ValueError(
                f"The used value for unknown_value {self.unknown_value} is "
                f"one of the values already used for encoding the seen "
                f"categories.")
        if self._missing:
            if (np.dtype(self.dtype).kind != "f"
                    and _is_nan(self.encoded_missing_value)):
                raise ValueError(
                    "There are missing values in features [0]. For "
                    "OrdinalEncoder to encode missing values with dtype: "
                    f"{self.dtype}, set encoded_missing_value to a non-nan "
                    "value, or set dtype to a float")
            if (not _is_nan(self.encoded_missing_value)
                    and 0 <= self.encoded_missing_value < cardinality):
                raise ValueError(
                    f"encoded_missing_value ({self.encoded_missing_value}) "
                    "is already used to encode a known category in "
                    "features: [0]")
        return self

    def transform(self, x):
        values = np.asarray(x).reshape(-1)
        cats = self.categories_
        diff, known = _unseen(values, cats)
        if diff and self.handle_unknown == "error":
            raise ValueError(f"Found unknown categories {diff} in column 0 "
                             f"during transform")
        codes = np.searchsorted(cats, np.where(known, values, cats[0]))
        out = codes.astype(self.dtype)
        if self._missing:
            out[codes == len(cats) - 1] = self.encoded_missing_value
        if self.handle_unknown == "use_encoded_value":
            out[~known] = self.unknown_value
        return out.reshape(np.shape(x))


def _is_nan(value):
    return isinstance(value, numbers.Real) and np.isnan(value)


CHANNELS = {cls.__name__: cls for cls in (
    StandardScaler, MinMaxScaler, MaxAbsScaler, RobustScaler,
    QuantileTransformer, PowerTransformer, Normalizer, Binarizer,
    FunctionTransformer, LabelEncoder, OrdinalEncoder)}
AFFINE_SCALERS = ("StandardScaler", "MinMaxScaler", "MaxAbsScaler",
                  "RobustScaler")
SCALERS = tuple(CHANNELS)


def assert_scaler(scaler):
    """True if the port implements the scaler `scaler` names (the JAX
    package accepts any sklearn.preprocessing class name)."""
    return str(scaler) in CHANNELS


def get_scaler(scaler, *args, ignore_less_eq=None, **kwargs):
    """A MultiChannelScaler of the sklearn class `scaler` names, built per
    channel with `args` and `kwargs`, as the JAX package's get_scaler."""
    return MultiChannelScaler(str(scaler), *args,
                              ignore_less_eq=ignore_less_eq, **kwargs)


def apply_scaling(X, scaler, ignore_less_eq=None):
    """Fit a fresh scaler to X and return the transformed volume."""
    return get_scaler(scaler, ignore_less_eq=ignore_less_eq).fit_transform(X)


class MultiChannelScaler:
    """Fits one scaler per channel of a rank-4 (X, Y, Z, C) volume,
    optionally ignoring samples <= ignore_less_eq (per channel)."""

    def __init__(self, scaler_name, *args, ignore_less_eq=None, **kwargs):
        if scaler_name in REFUSED:
            raise UnsupportedScalerError(
                f"Scaler '{scaler_name}' {REFUSED[scaler_name]}; the JAX "
                f"package cannot fit it on a volume either")
        if scaler_name not in CHANNELS:
            raise UnsupportedScalerError(
                f"Scaler '{scaler_name}' is not available in the PyTorch "
                f"port (supported: {', '.join(SCALERS)} or Null)")
        cls = CHANNELS[scaler_name]
        cls(*args, **kwargs)  # the constructor's errors, before any fit
        self.scaler_args, self.scaler_kwargs = args, kwargs
        self.scaler_name = scaler_name
        self.ignore_less_eq = ignore_less_eq
        self.channels = []
        self.n_channels = None

    @property
    def is_affine(self):
        return self.scaler_name in AFFINE_SCALERS

    def __str__(self):
        return (f"MultiChannelScaler(scaler_class='{self.scaler_name}', "
                f"ignore_less_eq={self.ignore_less_eq})")

    __repr__ = __str__

    def fit(self, X):
        if X.ndim != 4:
            raise ValueError(f"Expected rank-4 (X,Y,Z,C) volume, got "
                             f"{X.shape}")
        self.n_channels = X.shape[-1]
        ile = self.ignore_less_eq
        if ile is not None and not isinstance(ile, (list, tuple, np.ndarray)):
            ile = [ile] * self.n_channels
        if ile is not None and len(ile) != self.n_channels:
            raise ValueError(
                f"ignore_less_eq must have one entry per channel, got {ile}")
        self.ignore_less_eq = ile
        self.channels = []
        for c in range(self.n_channels):
            xc = X[..., c]
            if ile is not None:
                xc = xc[xc > ile[c]]
            channel = CHANNELS[self.scaler_name](*self.scaler_args,
                                                 **self.scaler_kwargs)
            if not xc.size and not isinstance(channel, (LabelEncoder,
                                                        FunctionTransformer)):
                # sklearn's check_array(ensure_min_samples=1)
                raise ValueError(f"Found array with 0 sample(s) (shape=(0, "
                                 f"1)) while a minimum of 1 is required by "
                                 f"{self.scaler_name}.")
            self.channels.append(channel.fit(xc.reshape(-1)))
        return self

    def transform(self, X):
        if X.shape[-1] != self.n_channels:
            raise ValueError(f"Input has {X.shape[-1]} channels, scaler fit "
                             f"to {self.n_channels}")
        center, scale = self.affine_params()
        if center is not None:
            return ((X - center) / scale).astype(X.dtype, copy=False)
        out = np.empty_like(X)
        for c, channel in enumerate(self.channels):
            out[..., c] = channel.transform(X[..., c])
        return out

    def fit_transform(self, X):
        return self.fit(X).transform(X)

    def affine_params(self):
        """Per-channel (center, scale) float32 vectors, or (None, None)
        for a scaler that is not an affine transform."""
        if not self.is_affine or not self.channels:
            return None, None
        return tuple(np.asarray([getattr(ch, k) for ch in self.channels],
                                np.float32) for k in ("center", "scale"))


class NoOpScaler:
    """Stand-in used when `scaler: Null` is configured."""

    n_channels = None

    def fit(self, X):
        self.n_channels = X.shape[-1]
        return self

    def transform(self, X):
        return X

    def fit_transform(self, X):
        return self.fit(X).transform(X)

    def affine_params(self):
        n = self.n_channels or 1
        return np.zeros(n, np.float32), np.ones(n, np.float32)

    def __str__(self):
        return "NoOpScaler()"

    __repr__ = __str__
