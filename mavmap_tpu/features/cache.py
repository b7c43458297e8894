"""On-disk feature cache with parameter-change invalidation.

Counterpart of reference src/base2d/feature_cache.{h,cc}: the
reference writes `<name>-keypoints.bin` / `-descriptors.bin` raw dumps plus
a `-params.ini` that auto-invalidates the cache whenever any detection
option changes (feature_cache.cc:53-110,126-162) and a `-metadata.ini` with
image dims. Here: one `<name>.npz` per image holding keypoints/descriptors/
dims, and a JSON params fingerprint checked on every query; extract-on-miss
via a pluggable detector callback.
"""

import hashlib
import json
import os

import numpy as np

from .provider import Features


class FeatureCache:
    def __init__(self, cache_path, params: dict, detector=None, capacity=4096):
        """detector: callable(image_idx) -> (keypoints (N,2), descriptors (N,D)).

        `params` is the full detection-parameter dict; any change invalidates
        previously cached entries (matching reference semantics).
        """
        self.cache_path = cache_path
        self.detector = detector
        self.capacity = capacity
        os.makedirs(cache_path, exist_ok=True)
        blob = json.dumps(params, sort_keys=True).encode()
        self.fingerprint = hashlib.sha256(blob).hexdigest()[:16]
        self._dims_cache = {}

    def _file(self, name):
        return os.path.join(self.cache_path, f"{name}.npz")

    def query(self, image_idx, name):
        """Features for image `name` — read-on-hit, extract-on-miss."""
        path = self._file(name)
        if os.path.exists(path):
            with np.load(path) as data:
                if str(data.get("fingerprint")) == self.fingerprint:
                    return Features.from_arrays(
                        data["keypoints"], data["descriptors"], self.capacity
                    )
        if self.detector is None:
            raise FileNotFoundError(
                f"no cached features for {name} and no detector configured"
            )
        out = self.detector(image_idx)
        kp, desc = out[0], out[1]
        dims = out[2] if len(out) > 2 else (0, 0)
        np.savez(
            path,
            keypoints=np.asarray(kp, np.float32),
            descriptors=np.asarray(desc, np.float32),
            dims=np.asarray(dims, np.int32),
            fingerprint=self.fingerprint,
        )
        return Features.from_arrays(kp, desc, self.capacity)

    def query_dimensions(self, image_idx, name):
        """(rows, cols, diagonal) of an image WITHOUT decoding it —
        reference FeatureCache::query_dimensions
        (feature_cache.cc:168-195,222-243): dims are persisted alongside
        the features at extraction time. Returns (0, 0, 0.0) when unknown
        (pre-dims cache entries or array providers)."""
        if name in self._dims_cache:
            return self._dims_cache[name]
        path = self._file(name)
        if not os.path.exists(path):
            self.query(image_idx, name)
        with np.load(path) as data:
            if "dims" not in data:
                out = (0, 0, 0.0)
            else:
                rows, cols = (int(v) for v in data["dims"])
                out = (rows, cols, float(np.hypot(rows, cols)))
        self._dims_cache[name] = out
        return out

    def clear(self):
        for f in os.listdir(self.cache_path):
            if f.endswith(".npz"):
                os.remove(os.path.join(self.cache_path, f))


# cv::KeyPoint memory layout (x, y, size, angle, response all float32;
# octave, class_id int32) — 28 bytes, written raw by the reference
# (feature_cache.cc:126-131).
_CV_KEYPOINT = np.dtype([
    ("x", "<f4"), ("y", "<f4"), ("size", "<f4"), ("angle", "<f4"),
    ("response", "<f4"), ("octave", "<i4"), ("class_id", "<i4"),
])
# cv::Mat type codes the reference can emit for descriptors.
_CV_DTYPES = {0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16,
              4: np.int32, 5: np.float32, 6: np.float64}


def read_reference_features(kp_path, desc_path):
    """Parse one image's features from the reference mavmap's binary cache
    dumps (`<name>-keypoints.bin` / `<name>-descriptors.bin`,
    feature_cache.cc:125-142 write / :145-163 read).

    Returns (keypoints (N, 2) f32, descriptors (N, D) f32,
    responses (N,) f32). Descriptors are L2-normalized rows as OpenCV SURF
    emits them; integer descriptor types are converted to f32 unscaled."""
    with open(kp_path, "rb") as f:
        (n_bytes,) = np.frombuffer(f.read(8), "<u8")
        raw = np.frombuffer(f.read(int(n_bytes)), _CV_KEYPOINT)
    with open(desc_path, "rb") as f:
        hdr = f.read(8 * 3 + 4)
        n_bytes = int(np.frombuffer(hdr[0:8], "<u8")[0])
        rows = int(np.frombuffer(hdr[8:16], "<u8")[0])
        cols = int(np.frombuffer(hdr[16:24], "<u8")[0])
        cv_type = int(np.frombuffer(hdr[24:28], "<i4")[0])
        depth, channels = cv_type & 7, (cv_type >> 3) + 1
        dt = _CV_DTYPES[depth]
        desc = np.frombuffer(f.read(n_bytes), dt).reshape(rows,
                                                          cols * channels)
    if rows != len(raw):
        raise ValueError(
            f"keypoint/descriptor count mismatch: {len(raw)} vs {rows}")
    kp = np.stack([raw["x"], raw["y"]], axis=-1).astype(np.float32)
    return kp, desc.astype(np.float32), raw["response"].astype(np.float32)


class ReferenceCacheProvider:
    """FeatureProvider over a directory of the reference mavmap's feature
    cache (cross-validation path: consume REAL mavmap-extracted SURF
    features — the honest substitute for the unbuildable OpenCV-nonfree
    SURF). Over-capacity images keep the strongest-response keypoints,
    like the reference's detector budget keeps its strongest maxima."""

    def __init__(self, cache_path, names, capacity=1024):
        self.cache_path = cache_path
        self.names = list(names)
        self.capacity = capacity
        self.descriptor_dim = None
        self._cache = {}

    def get(self, image_idx):
        if image_idx in self._cache:
            return self._cache[image_idx]
        name = self.names[image_idx]
        kp, desc, resp = read_reference_features(
            os.path.join(self.cache_path, f"{name}-keypoints.bin"),
            os.path.join(self.cache_path, f"{name}-descriptors.bin"))
        if len(kp) > self.capacity:
            keep = np.argsort(-resp)[: self.capacity]
            keep.sort()  # preserve spatial ordering
            kp, desc = kp[keep], desc[keep]
        self.descriptor_dim = desc.shape[1]
        feats = Features.from_arrays(kp, desc, self.capacity)
        self._cache[image_idx] = feats
        return feats
