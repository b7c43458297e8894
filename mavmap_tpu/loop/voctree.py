"""Vocabulary tree: hierarchical k-means quantization, fully batched.

Counterpart of reference src/loop/voc_tree.{h,cc}. The reference
descends a pointer-based tree per descriptor (voc_tree.cc:95-131) loaded
from a pre-computed binary (training is outside the repo). This rebuild:

  - the tree is a complete K^L array — `centers[level]` has K^level * K
    rows — so descent is index arithmetic + batched argmin, no pointers:
    one (N, K, D) gather + distance per level for ALL descriptors at once;
  - training (hierarchical k-means) is included, so no external binary is
    required (`train_voc_tree`); save/load as npz.

Descriptors are L2-normalized float32; distances are squared L2 computed
via the matmul identity (one dense product).
"""

import numpy as np

import jax
import jax.numpy as jnp


class VocTree:
    def __init__(self, centers_per_level, branching, depth):
        """centers_per_level: list of (K^(l+1), D) arrays, l = 0..depth-1."""
        self.branching = branching
        self.depth = depth
        self.centers = [jnp.asarray(c, jnp.float32) for c in centers_per_level]
        self.num_words = branching**depth
        self.descriptor_dim = centers_per_level[0].shape[1]

    def quantize(self, descriptors, mask=None):
        """(N, D) descriptors -> (N,) int32 visual-word ids.

        Batched tree descent (reference voc_tree.cc:95-131 does this one
        descriptor at a time).
        """
        return _quantize(
            tuple(self.centers), self.branching, self.depth,
            jnp.asarray(descriptors, jnp.float32),
            None if mask is None else jnp.asarray(mask),
        )

    def save(self, path):
        np.savez(
            path,
            branching=self.branching,
            depth=self.depth,
            **{f"level_{i}": np.asarray(c) for i, c in enumerate(self.centers)},
        )

    @staticmethod
    def load(path):
        data = np.load(path)
        depth = int(data["depth"])
        centers = [data[f"level_{i}"] for i in range(depth)]
        return VocTree(centers, int(data["branching"]), depth)

    @staticmethod
    def load_reference_binary(path):
        """Load a voc-tree binary in the reference's format (--voc-tree-path,
        voc_tree.cc:28-82): int32 header (visualwords, levels, splits,
        nrcenters), nrcenters x 128 uint8 centroids in breadth-first
        complete-tree order, nrcenters uint8 cellinfo.

        uint8 centroids are mapped back to the float range the detector
        produces with the inverse of the reference's descriptor conversion
        (detection.cc:107-110: floor(d * 127 + 127)); an affine map leaves
        all nearest-center decisions unchanged. Only complete trees are
        supported (cellinfo early-termination flags, which published trees
        don't use, are ignored).
        """
        with open(path, "rb") as f:
            visualwords, levels, splits, nrcenters = (
                int(v) for v in np.fromfile(f, np.int32, 4)
            )
            if not (0 < levels <= 10 and 1 < splits <= 100000):
                raise ValueError("corrupt voc-tree binary (header sanity)")
            expected = sum(splits ** (l + 1) for l in range(levels))
            if nrcenters != expected:
                raise ValueError(
                    f"corrupt voc-tree binary: nrcenters={nrcenters}, "
                    f"expected {expected} for a complete {splits}^{levels} tree"
                )
            voc = np.fromfile(f, np.uint8, nrcenters * 128)
            if voc.size != nrcenters * 128:
                raise ValueError("corrupt voc-tree binary (truncated centers)")
        voc = voc.reshape(nrcenters, 128).astype(np.float32)
        voc = (voc - 127.0) / 127.0
        centers = []
        pos = 0
        for l in range(int(levels)):
            n = int(splits) ** (l + 1)
            centers.append(voc[pos: pos + n])
            pos += n
        if pos != int(nrcenters):
            raise ValueError("voc-tree binary size mismatch (incomplete tree?)")
        return VocTree(centers, int(splits), int(levels))

    def save_reference_binary(self, path):
        """Write the reference's binary format (inverse of
        load_reference_binary; centers clipped to the uint8 range)."""
        flat = np.concatenate([np.asarray(c) for c in self.centers])
        voc = np.clip(np.floor(flat * 127.0 + 127.0), 0, 255).astype(np.uint8)
        n = voc.shape[0]
        with open(path, "wb") as f:
            np.asarray(
                [self.num_words, self.depth, self.branching, n], np.int32
            ).tofile(f)
            voc.tofile(f)
            np.zeros((n,), np.uint8).tofile(f)  # cellinfo: complete tree


from functools import partial


@partial(jax.jit, static_argnames=("branching", "depth"))
def _quantize(centers, branching, depth, descriptors, mask):
    N = descriptors.shape[0]
    node = jnp.zeros((N,), jnp.int32)  # index within current level
    for l in range(depth):
        C = centers[l]  # (K^(l+1), D)
        base = node * branching
        child_ids = base[:, None] + jnp.arange(branching)[None, :]  # (N, K)
        cc = C[child_ids]  # (N, K, D)
        d = (
            jnp.sum(cc * cc, axis=-1)
            - 2.0 * jnp.einsum("nd,nkd->nk", descriptors, cc)
        )
        node = base + jnp.argmin(d, axis=-1).astype(jnp.int32)
    if mask is not None:
        node = jnp.where(mask, node, -1)
    return node


def train_voc_tree(descriptors, branching=8, depth=3, iters=8, seed=0):
    """Hierarchical k-means on (M, D) training descriptors -> VocTree.

    Level-parallel Lloyd iterations: all nodes of a level are refined in one
    batched pass (assignments via the current partial quantization).
    """
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, np.float32)
    M, D = desc.shape

    centers_per_level = []
    # assignment of each training descriptor to a node index at current level
    assign = np.zeros(M, np.int64)
    num_nodes = 1
    for l in range(depth):
        K = branching
        new_centers = np.zeros((num_nodes * K, D), np.float32)
        for node in range(num_nodes):
            sel = desc[assign == node]
            if len(sel) == 0:
                new_centers[node * K : (node + 1) * K] = rng.normal(
                    size=(K, D)
                ).astype(np.float32)
                continue
            # k-means init: random distinct samples.
            init_idx = rng.choice(len(sel), size=min(K, len(sel)), replace=False)
            C = np.zeros((K, D), np.float32)
            C[: len(init_idx)] = sel[init_idx]
            if len(init_idx) < K:
                C[len(init_idx):] = sel[rng.integers(0, len(sel), K - len(init_idx))]
            for _ in range(iters):
                d = (
                    np.sum(C * C, axis=1)[None, :]
                    - 2.0 * sel @ C.T
                )
                a = np.argmin(d, axis=1)
                for k in range(K):
                    pts = sel[a == k]
                    if len(pts):
                        C[k] = pts.mean(axis=0)
            new_centers[node * K : (node + 1) * K] = C
        centers_per_level.append(new_centers)
        # Re-assign all descriptors one level deeper.
        child = np.zeros(M, np.int64)
        for node in range(num_nodes):
            m = assign == node
            if not m.any():
                continue
            C = new_centers[node * K : (node + 1) * K]
            d = np.sum(C * C, axis=1)[None, :] - 2.0 * desc[m] @ C.T
            child[m] = node * K + np.argmin(d, axis=1)
        assign = child
        num_nodes *= K

    return VocTree(centers_per_level, branching, depth)
