"""Pure-numpy NIfTI-1 reader/writer.

A copy of `multiplanarunet_tpu/io/nifti.py` (numpy, gzip and struct only),
so the port reads and writes volumes without importing the JAX package;
tests/test_torch_cli.py holds the two to reading each other's files bit
for bit. It covers:

  * `.nii` and `.nii.gz` single-file images (magic ``n+1``),
  * header parsing of shape / datatype / pixdim / scl slope+inter,
  * affine resolution with the standard priority: sform > qform > base affine,
  * lazy data access: `load()` reads only the 348-byte header; voxel data is
    read (and scaled) on the first `get_fdata()` call,
  * writing float/int volumes with an sform affine.

Format reference: the public NIfTI-1 specification (nifti.nimh.nih.gov).
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

HDR_SIZE = 348

# NIfTI-1 datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

# Tolerance for 1 - |quaternion|^2 slightly below zero (the reference relaxes
# nibabel's threshold for the same reason, mpunet/image/image_pair.py:24)
QUATERNION_THRESHOLD = -1e-6


class NiftiHeader:
    """Parsed NIfTI-1 header with dict-style access to the raw fields."""

    __slots__ = ("_fields",)

    def __init__(self, fields):
        self._fields = fields

    def __getitem__(self, key):
        return self._fields[key]

    def __contains__(self, key):
        return key in self._fields

    def keys(self):
        return self._fields.keys()

    @property
    def shape(self):
        ndim = int(self["dim"][0])
        return tuple(int(d) for d in self["dim"][1 : 1 + ndim])

    @property
    def pixdim(self):
        """Voxel sizes along the three spatial axes."""
        return np.asarray(self["pixdim"][1:4], dtype=np.float32)

    def get_data_dtype(self):
        code = int(self["datatype"])
        if code not in _DTYPES:
            raise ValueError(f"Unsupported NIfTI datatype code {code}")
        return np.dtype(_DTYPES[code])

    # ------------------------------------------------------------------ affine
    def get_sform(self):
        return np.vstack(
            [
                np.asarray(self["srow_x"], dtype=np.float64),
                np.asarray(self["srow_y"], dtype=np.float64),
                np.asarray(self["srow_z"], dtype=np.float64),
                [0.0, 0.0, 0.0, 1.0],
            ]
        )

    def get_qform(self):
        b, c, d = (float(self[k]) for k in ("quatern_b", "quatern_c", "quatern_d"))
        w2 = 1.0 - (b * b + c * c + d * d)
        if w2 < 0:
            if w2 < QUATERNION_THRESHOLD:
                raise ValueError(f"Invalid quaternion in qform (1-|q|^2 = {w2:g})")
            w2 = 0.0
        a = np.sqrt(w2)
        R = np.array(
            [
                [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
                [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
            ]
        )
        pixdim = self.pixdim.astype(np.float64).copy()
        qfac = float(self["pixdim"][0])
        if qfac == 0:
            qfac = 1.0
        pixdim[2] *= np.sign(qfac)
        aff = np.eye(4)
        aff[:3, :3] = R * pixdim
        aff[:3, 3] = [float(self["qoffset_x"]), float(self["qoffset_y"]), float(self["qoffset_z"])]
        return aff

    def get_base_affine(self):
        """Fallback affine: scale by pixdim, origin at the volume center."""
        pixdim = self.pixdim.astype(np.float64)
        shape = np.array(self.shape[:3] + (1,) * (3 - min(3, len(self.shape))))[:3]
        aff = np.diag(list(pixdim) + [1.0])
        aff[:3, 3] = -pixdim * (shape - 1) / 2.0
        return aff

    def get_best_affine(self):
        if int(self["sform_code"]) > 0:
            return self.get_sform()
        if int(self["qform_code"]) > 0:
            return self.get_qform()
        return self.get_base_affine()


_HDR_STRUCT = [
    # (name, offset, fmt)
    ("sizeof_hdr", 0, "<i"),
    ("dim_info", 39, "<B"),
    ("dim", 40, "<8h"),
    ("intent_code", 68, "<h"),
    ("datatype", 70, "<h"),
    ("bitpix", 72, "<h"),
    ("slice_start", 74, "<h"),
    ("pixdim", 76, "<8f"),
    ("vox_offset", 108, "<f"),
    ("scl_slope", 112, "<f"),
    ("scl_inter", 116, "<f"),
    ("cal_max", 124, "<f"),
    ("cal_min", 128, "<f"),
    ("qform_code", 252, "<h"),
    ("sform_code", 254, "<h"),
    ("quatern_b", 256, "<f"),
    ("quatern_c", 260, "<f"),
    ("quatern_d", 264, "<f"),
    ("qoffset_x", 268, "<f"),
    ("qoffset_y", 272, "<f"),
    ("qoffset_z", 276, "<f"),
    ("srow_x", 280, "<4f"),
    ("srow_y", 296, "<4f"),
    ("srow_z", 312, "<4f"),
    ("magic", 344, "4s"),
]


def _parse_header(raw: bytes) -> NiftiHeader:
    if len(raw) < HDR_SIZE:
        raise ValueError("File too short to contain a NIfTI-1 header")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != HDR_SIZE:
        raise ValueError(f"Not a (little-endian) NIfTI-1 file: sizeof_hdr={sizeof_hdr}")
    fields = {}
    for name, offset, fmt in _HDR_STRUCT:
        vals = struct.unpack_from(fmt, raw, offset)
        fields[name] = vals[0] if len(vals) == 1 else vals
    magic = fields["magic"]
    if magic not in (b"n+1\x00", b"ni1\x00"):
        raise ValueError(f"Bad NIfTI magic: {magic!r}")
    return NiftiHeader(fields)


def _is_gz(path: Path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


class NiftiImage:
    """A (lazily loaded) NIfTI-1 image: header + affine + voxel data.

    Mirrors the subset of the nibabel `Nifti1Image` API the framework needs
    (`shape`, `affine`, `header`, `get_fdata`, `get_data_dtype`).
    """

    def __init__(self, dataobj, affine, header=None, path=None):
        self._data = dataobj  # ndarray or None (lazy)
        self._affine = np.asarray(affine, dtype=np.float64) if affine is not None else None
        self._header = header
        self._path = Path(path) if path is not None else None
        self._fdata_cache = None

    # ---------------------------------------------------------------- metadata
    @property
    def header(self) -> NiftiHeader:
        return self._header

    @property
    def affine(self) -> np.ndarray:
        return self._affine

    @property
    def shape(self):
        if self._data is not None:
            return tuple(self._data.shape)
        return self._header.shape

    @property
    def ndim(self):
        return len(self.shape)

    def get_data_dtype(self):
        if self._header is not None:
            return self._header.get_data_dtype()
        return self._data.dtype

    # -------------------------------------------------------------------- data
    def _read_raw(self) -> np.ndarray:
        hdr = self._header
        if _is_gz(self._path):
            with gzip.open(self._path, "rb") as f:
                raw = f.read()
        else:
            with open(self._path, "rb") as f:
                raw = f.read()
        offset = int(hdr["vox_offset"])
        dtype = hdr.get_data_dtype()
        shape = hdr.shape
        count = int(np.prod(shape))
        arr = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
        # NIfTI stores data Fortran-ordered (x fastest)
        return arr.reshape(shape, order="F")

    def get_fdata(self, caching="unchanged", dtype=np.float32) -> np.ndarray:
        """Return voxel data as floating point with scl slope/inter applied.

        ``caching='unchanged'`` mirrors nibabel semantics as used by the
        reference (`mpunet/image/image_pair.py:172`): the image object does not
        pin a cached copy, so the caller owns the array's lifetime.
        """
        if self._fdata_cache is not None and caching == "fill":
            return self._fdata_cache
        if self._data is not None:
            raw = self._data
        else:
            raw = self._read_raw()
        out = np.asarray(raw, dtype=dtype)
        if self._header is not None:
            slope = float(self._header["scl_slope"])
            inter = float(self._header["scl_inter"])
            if slope not in (0.0, 1.0) or (slope != 0.0 and inter != 0.0):
                out = out * slope + inter
        if out is raw:
            out = out.copy()
        if caching == "fill":
            self._fdata_cache = out
        return out

    def get_raw_data(self) -> np.ndarray:
        """Voxel data in the on-disk dtype, without slope/inter scaling."""
        if self._data is not None:
            return self._data
        return self._read_raw()

    def uncache(self):
        self._fdata_cache = None


def load(path) -> NiftiImage:
    """Open a .nii / .nii.gz file, reading only the header (lazy data)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(str(path))
    if _is_gz(path):
        # Read only the first deflate blocks needed for the header
        with gzip.open(path, "rb") as f:
            raw = f.read(HDR_SIZE)
    else:
        with open(path, "rb") as f:
            raw = f.read(HDR_SIZE)
    hdr = _parse_header(raw)
    return NiftiImage(None, hdr.get_best_affine(), header=hdr, path=path)


def _build_header_bytes(arr: np.ndarray, affine: np.ndarray) -> bytes:
    hdr = bytearray(HDR_SIZE)
    struct.pack_into("<i", hdr, 0, HDR_SIZE)
    ndim = arr.ndim
    dim = [ndim] + list(arr.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    dtype = np.dtype(arr.dtype)
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"Cannot write dtype {dtype} to NIfTI-1")
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[dtype])
    struct.pack_into("<h", hdr, 72, dtype.itemsize * 8)
    # pixdim from the affine column norms; qfac (pixdim[0]) = 1
    pixdim = np.linalg.norm(np.asarray(affine)[:3, :3], axis=0)
    struct.pack_into("<8f", hdr, 76, 1.0, *pixdim, *([1.0] * (7 - len(pixdim))))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code = NIFTI_XFORM_SCANNER_ANAT
    aff = np.asarray(affine, dtype=np.float64)
    struct.pack_into("<4f", hdr, 280, *aff[0])
    struct.pack_into("<4f", hdr, 296, *aff[1])
    struct.pack_into("<4f", hdr, 312, *aff[2])
    struct.pack_into("4s", hdr, 344, b"n+1\x00")
    return bytes(hdr)


def save(img, path, affine=None):
    """Write a NiftiImage or (array, affine) to .nii / .nii.gz."""
    if isinstance(img, NiftiImage):
        arr = img.get_raw_data()
        affine = img.affine if affine is None else affine
    else:
        arr = np.asarray(img)
        if affine is None:
            raise ValueError("affine required when saving a bare array")
    path = Path(path)
    payload = _build_header_bytes(arr, affine) + b"\x00\x00\x00\x00" + arr.tobytes(order="F")
    if path.name.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


class Nifti1Image(NiftiImage):
    """nibabel-compatible constructor alias: Nifti1Image(data, affine)."""

    def __init__(self, dataobj, affine, header=None):
        super().__init__(np.asarray(dataobj), affine, header=header)
