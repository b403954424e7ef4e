"""Per-channel volume normalization, in numpy.

Port of `multiplanarunet_tpu/preprocessing/scaling.py` without sklearn:
the four affine scalers the JAX package takes from sklearn
(StandardScaler, MinMaxScaler, MaxAbsScaler, RobustScaler) are fitted
here with the statistics sklearn computes at its defaults, so a channel
transforms as x -> (x - center) / scale with the same (center, scale).
QuantileTransformer is sklearn's at its defaults (1000 quantiles, a
uniform output, a subsample of 10,000 drawn from numpy's global random
stream): the same quantiles, the same transform, and the global stream
left as sklearn leaves it. Other sklearn scaler names raise
`UnsupportedScalerError`.
"""

from __future__ import annotations

import numpy as np

AFFINE_SCALERS = ("StandardScaler", "MinMaxScaler", "MaxAbsScaler",
                  "RobustScaler")
SCALERS = AFFINE_SCALERS + ("QuantileTransformer",)
# sklearn.preprocessing.QuantileTransformer's defaults
N_QUANTILES, QUANTILE_SUBSAMPLE = 1000, 10_000


class UnsupportedScalerError(ValueError):
    """A scaler name the port does not implement."""


def _handle_zeros_in_scale(scale, constant_mask=None):
    """sklearn's rule: scales that are (near) zero become 1."""
    scale = np.array(scale, copy=True)
    if constant_mask is None:
        constant_mask = scale < 10 * np.finfo(scale.dtype).eps
    scale[constant_mask] = 1.0
    return scale


def _fit_center_scale(name, x):
    """(center, scale) float64 of one channel's samples x (1-D), as the
    named sklearn scaler fits them at its defaults."""
    if name == "StandardScaler":
        n = x.shape[0]
        mean = np.nansum(x, dtype=np.float64) / n
        temp = x - mean
        correction = np.nansum(temp)
        var = (np.nansum(temp ** 2) - correction ** 2 / n) / n
        eps = np.finfo(np.float64).eps
        constant = var <= n * eps * var + (n * mean * eps) ** 2
        scale = _handle_zeros_in_scale(np.sqrt(np.atleast_1d(var)),
                                       np.atleast_1d(constant))[0]
        return float(mean), float(scale)
    if name == "RobustScaler":
        center = np.nanmedian(x)
        q = np.nanpercentile(x, (25.0, 75.0))
        scale = _handle_zeros_in_scale(np.atleast_1d(q[1] - q[0]))[0]
        return float(center), float(scale)
    if name == "MinMaxScaler":
        data_min, data_max = np.nanmin(x), np.nanmax(x)
        scale_ = (1 - 0) / _handle_zeros_in_scale(
            np.atleast_1d(data_max - data_min))[0]
        min_ = 0 - data_min * scale_
        return -float(min_) / float(scale_), 1.0 / float(scale_)
    max_abs = np.nanmax(np.abs(x))  # MaxAbsScaler
    return 0.0, float(_handle_zeros_in_scale(np.atleast_1d(max_abs))[0])


def _as_float(x):
    """sklearn's input check: float16/32/64 kept, anything else float64."""
    x = np.asarray(x)
    if x.dtype in (np.float64, np.float32, np.float16):
        return x
    return x.astype(np.float64)


class QuantileChannel:
    """sklearn's QuantileTransformer() on one channel (a 1-D sample)."""

    def __init__(self):
        self.quantiles_ = None
        self.references_ = None

    def fit(self, x):
        x = _as_float(x).reshape(-1, 1)
        n = x.shape[0]
        if n < 1:
            raise ValueError("QuantileTransformer: a channel has no "
                             "samples to fit")
        self.references_ = np.linspace(0, 1, max(1, min(N_QUANTILES, n)),
                                       endpoint=True)
        if QUANTILE_SUBSAMPLE < n:
            # sklearn.utils.resample(replace=False) on the global stream
            idx = np.arange(n)
            np.random.shuffle(idx)
            x = x[idx[:QUANTILE_SUBSAMPLE]]
        self.quantiles_ = np.nanpercentile(x, self.references_ * 100,
                                           axis=0)[:, 0]
        return self

    def transform(self, x):
        """Uniform output in [0, 1] of an array of any shape, in x's
        float dtype (NaN stays NaN)."""
        q, r = self.quantiles_, self.references_
        x = np.array(_as_float(x), copy=True)
        lower = x == q[0]
        upper = x == q[-1]
        finite = ~np.isnan(x)
        xf = x[finite]
        x[finite] = 0.5 * (np.interp(xf, q, r)
                           - np.interp(-xf, -q[::-1], -r[::-1]))
        x[upper] = 1
        x[lower] = 0
        return x


def assert_scaler(scaler):
    """True if the port implements the scaler `scaler` names (the JAX
    package accepts any sklearn.preprocessing class name)."""
    return str(scaler) in SCALERS


def get_scaler(scaler, ignore_less_eq=None):
    return MultiChannelScaler(str(scaler), ignore_less_eq=ignore_less_eq)


def apply_scaling(X, scaler, ignore_less_eq=None):
    """Fit a fresh scaler to X and return the transformed volume."""
    return get_scaler(scaler, ignore_less_eq=ignore_less_eq).fit_transform(X)


class MultiChannelScaler:
    """Fits one scaler per channel of a rank-4 (X, Y, Z, C) volume,
    optionally ignoring samples <= ignore_less_eq (per channel)."""

    def __init__(self, scaler_name, ignore_less_eq=None):
        if not assert_scaler(scaler_name):
            raise UnsupportedScalerError(
                f"Scaler '{scaler_name}' is not available in the PyTorch "
                f"port (supported: {', '.join(SCALERS)} or Null)")
        self.scaler_name = scaler_name
        self.ignore_less_eq = ignore_less_eq
        self.centers = None
        self.scales = None
        self.quantile_channels = None
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
        channels = []
        for c in range(self.n_channels):
            xc = X[..., c]
            if ile is not None:
                xc = xc[xc > ile[c]]
            if self.is_affine:
                channels.append(_fit_center_scale(self.scaler_name,
                                                  xc.reshape(-1)))
            else:
                channels.append(QuantileChannel().fit(xc))
        if self.is_affine:
            self.centers, self.scales = (np.asarray(v, np.float32)
                                         for v in zip(*channels))
        else:
            self.quantile_channels = channels
        return self

    def transform(self, X):
        if X.shape[-1] != self.n_channels:
            raise ValueError(f"Input has {X.shape[-1]} channels, scaler fit "
                             f"to {self.n_channels}")
        if self.is_affine:
            return ((X - self.centers) / self.scales).astype(X.dtype,
                                                             copy=False)
        out = np.empty_like(X)
        for c, channel in enumerate(self.quantile_channels):
            out[..., c] = channel.transform(X[..., c])
        return out

    def fit_transform(self, X):
        return self.fit(X).transform(X)

    def affine_params(self):
        """Per-channel (center, scale) float32 vectors, or (None, None)
        for the QuantileTransformer (not an affine transform)."""
        return self.centers, self.scales


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
