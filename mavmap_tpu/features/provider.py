"""Feature providers: fixed-capacity (keypoints, descriptors, mask) per image.

The device pipeline wants every image's features in identical static shapes
(capacity F, descriptor dim D) with a validity mask — the struct-of-arrays
+ masks convention from SURVEY §7. A provider abstracts where features come
from: the on-device detector (features/detector.py), the disk cache
(features/cache.py, counterpart of reference base2d/feature_cache.cc), or
synthetic projection (utils/synthetic.py) for tests and benchmarks.
"""

from dataclasses import dataclass
from typing import Protocol

import numpy as np


@dataclass
class Features:
    """One image's features, padded to capacity.

    keypoints: (F, 2) float32 pixel coords; descriptors: (F, D) float32;
    mask: (F,) bool valid rows; num: actual count.
    """

    keypoints: np.ndarray
    descriptors: np.ndarray
    mask: np.ndarray

    @property
    def num(self):
        return int(self.mask.sum())

    @staticmethod
    def from_arrays(keypoints, descriptors, capacity):
        n = len(keypoints)
        assert n <= capacity, f"{n} features > capacity {capacity}"
        d = descriptors.shape[1]
        kp = np.zeros((capacity, 2), np.float32)
        de = np.zeros((capacity, d), np.float32)
        mask = np.zeros((capacity,), bool)
        kp[:n] = keypoints
        de[:n] = descriptors
        mask[:n] = True
        return Features(kp, de, mask)


class FeatureProvider(Protocol):
    capacity: int
    descriptor_dim: int

    def get(self, image_idx: int) -> Features: ...


class ArrayFeatureProvider:
    """Provider over in-memory per-image feature arrays."""

    def __init__(self, feats_list, capacity=None):
        if capacity is None:
            capacity = max((len(k) for k, _ in feats_list), default=1)
        self.capacity = capacity
        self.descriptor_dim = feats_list[0][1].shape[1] if feats_list else 128
        self._feats = [
            Features.from_arrays(k, d, capacity) for k, d in feats_list
        ]

    def get(self, image_idx):
        return self._feats[image_idx]
