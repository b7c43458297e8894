"""Batched 5-point essential-matrix solver + pose recovery.

Counterpart of reference src/base3d/essential_matrix.{h,cc}.

The reference implements Nister's solver with ~250 lines of machine-
generated polynomial coefficients and a Gauss-Jordan elimination
(essential_matrix_poly.h, essential_matrix.cc:24-124). This rebuild uses a
different, batch-first formulation — the *hidden-variable resultant* (cf.
Kukelova et al., "Polynomial eigenvalue solutions to the 5-pt and 6-pt
relative pose problems", BMVC 2008):

  1. nullspace of the 5x9 epipolar constraint matrix -> E = xE1+yE2+zE3+E4
  2. the 10 cubic constraints (det E = 0 and 2 E E^T E - tr(E E^T) E = 0)
     are assembled *numerically* via precomputed monomial multiplication
     tables (no machine-generated algebra) into A(z) m(x, y) = 0, where
     m = [x^3, x^2 y, x y^2, y^3, x^2, x y, y^2, x, y, 1] and A(z) is a
     10x10 cubic matrix polynomial in the hidden variable z
  3. det A(z) is a degree-10 polynomial, recovered by *interpolation*:
     batched slogdet at Chebyshev nodes + a precomputed Chebyshev fit
  4. roots via the batched Durand-Kerner iteration (ops/polynomial.py)
  5. for each (near-)real root, the nullvector of A(z) (batched SVD) gives
     (x, y) and hence E.

Every step is a fixed-shape batched tensor op: SVDs, matmuls, slogdet,
fori_loop — no data-dependent control flow, so thousands of RANSAC
hypotheses JIT into a single program.

Residual: first-order Sampson distance, signed exactly like the reference
(essential_matrix.cc:131-162); callers threshold its absolute value.
"""

import numpy as np

import jax
import jax.numpy as jnp

# ----------------------------------------------------------------------------
# Static monomial tables (built once in numpy at import time).
# Monomials are exponent triples (ex, ey, ez) over (x, y, z) with implicit
# substitution w = 1 (degree <= k).
# ----------------------------------------------------------------------------


def _monomials_upto(deg):
    out = []
    for total in range(deg, -1, -1):
        for ex in range(total, -1, -1):
            for ey in range(total - ex, -1, -1):
                ez = total - ex - ey
                out.append((ex, ey, ez))
    return out


_M1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # x, y, z, 1
_M2 = _monomials_upto(2)  # 10 monomials
_M3 = _monomials_upto(3)  # 20 monomials
_M2_IDX = {m: i for i, m in enumerate(_M2)}
_M3_IDX = {m: i for i, m in enumerate(_M3)}


def _mul_table(basis_a, basis_b, basis_out):
    idx_out = {m: i for i, m in enumerate(basis_out)}
    T = np.zeros((len(basis_a), len(basis_b), len(basis_out)), np.float32)
    for i, a in enumerate(basis_a):
        for j, b in enumerate(basis_b):
            m = (a[0] + b[0], a[1] + b[1], a[2] + b[2])
            T[i, j, idx_out[m]] = 1.0
    return T


_T11_2 = jnp.asarray(_mul_table(_M1, _M1, _M2))  # (4, 4, 10)
_T21_3 = jnp.asarray(_mul_table(_M2, _M1, _M3))  # (10, 4, 20)

# --- Nister elimination layout -------------------------------------------
# Partition the 20 deg-3 monomials into 10 "high" ((x,y)-degree >= 2) and 10
# "low" ((x,y)-degree <= 1) monomials, ordered as in Nister's paper.
_HIGH = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0),
    (2, 0, 1), (2, 0, 0), (0, 2, 1), (0, 2, 0),
    (1, 1, 1), (1, 1, 0),
]
_LOW = [
    (1, 0, 2), (1, 0, 1), (1, 0, 0),
    (0, 1, 2), (0, 1, 1), (0, 1, 0),
    (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_HIGH_IDX = np.array([_M3_IDX[m] for m in _HIGH])
_LOW_IDX = np.array([_M3_IDX[m] for m in _LOW])
# Rows of the reduced system used to build the 3x3 B(z):
# e = x^2 z, f = x^2, g = y^2 z, h = y^2, i = xyz, j = xy (indices in _HIGH).
_ROW_E, _ROW_F, _ROW_G, _ROW_H, _ROW_I, _ROW_J = 4, 5, 6, 7, 8, 9

# Hidden-variable layout: columns of A(z) = monomials in (x, y); each deg-3
# monomial (ex, ey, ez) maps to column (ex, ey) with z-degree ez.
_XY_COLS = [
    (3, 0), (2, 1), (1, 2), (0, 3),
    (2, 0), (1, 1), (0, 2),
    (1, 0), (0, 1), (0, 0),
]
_XY_IDX = {c: i for i, c in enumerate(_XY_COLS)}

# Scatter matrix: (20, 10, 4) mapping deg-3 monomial coeffs -> (col, zdeg).
_SCATTER = np.zeros((20, 10, 4), np.float32)
for _i, (_ex, _ey, _ez) in enumerate(_M3):
    _SCATTER[_i, _XY_IDX[(_ex, _ey)], _ez] = 1.0
_SCATTER_J = jnp.asarray(_SCATTER)

_COL_X = _XY_IDX[(1, 0)]
_COL_Y = _XY_IDX[(0, 1)]
_COL_1 = _XY_IDX[(0, 0)]

# Chebyshev interpolation setup for det A(z), degree 10 -> 16 nodes
# (least-squares fit in the Chebyshev basis, converted to monomial coeffs).
_DET_DEG = 10
_NUM_NODES = 16
_NODE_SCALE = 2.0  # z-range covered by the nodes; fit is exact for any z


def _build_cheb():
    k = np.arange(_NUM_NODES)
    nodes = np.cos((2 * k + 1) * np.pi / (2 * _NUM_NODES))  # Chebyshev pts
    z = _NODE_SCALE * nodes
    # Chebyshev-basis design matrix at the nodes (argument = nodes in [-1,1]).
    C = np.polynomial.chebyshev.chebvander(nodes, _DET_DEG)  # (N, 11)
    fit = np.linalg.pinv(C)  # (11, N) least-squares fit, well conditioned
    # Chebyshev coeffs (in scaled variable u = z / S) -> monomial coeffs in z.
    cheb2mono_u = np.zeros((_DET_DEG + 1, _DET_DEG + 1))
    for d in range(_DET_DEG + 1):
        e = np.zeros(_DET_DEG + 1)
        e[d] = 1.0
        mono = np.polynomial.chebyshev.cheb2poly(e)
        cheb2mono_u[: len(mono), d] = mono
    # account for u = z / S: coeff of z^k gets S^{-k}
    scale = np.power(1.0 / _NODE_SCALE, np.arange(_DET_DEG + 1))
    cheb2mono = cheb2mono_u * scale[:, None]
    mono_fit = cheb2mono @ fit  # (11, N): node values -> monomial coeffs of z
    return z.astype(np.float32), mono_fit.astype(np.float32)


_Z_NODES_NP, _MONO_FIT_NP = _build_cheb()
_Z_NODES = jnp.asarray(_Z_NODES_NP)
_MONO_FIT = jnp.asarray(_MONO_FIT_NP)


# ----------------------------------------------------------------------------
# Solver
# ----------------------------------------------------------------------------


def _epipolar_design(points1, points2):
    """(N, 2), (N, 2) normalized coords -> (N, 9) rows of x2^T E x1 = 0.

    Row layout matches E flattened row-major: [E00, E01, ..., E22] with
    x2^T E x1 = sum_ij x2_i * E_ij * x1_j.
    """
    x1 = jnp.concatenate([points1, jnp.ones_like(points1[..., :1])], axis=-1)
    x2 = jnp.concatenate([points2, jnp.ones_like(points2[..., :1])], axis=-1)
    return (x2[..., :, None] * x1[..., None, :]).reshape(points1.shape[:-1] + (9,))


def _poly2(a, b):
    """Product of two linear forms (coeff vectors over _M1) -> (10,)."""
    return jnp.einsum("i,j,ijm->m", a, b, _T11_2)


def _poly3(p2, c):
    """deg2 (10,) * deg1 (4,) -> deg3 (20,)."""
    return jnp.einsum("p,i,pim->m", p2, c, _T21_3)


def _build_constraints(C):
    """C: (3, 3, 4) linear-form coeffs of E entries -> (10, 20) cubic coeffs.

    Equations: [det(E); 2 E E^T E - tr(E E^T) E] (10 rows).
    """
    # trace(E E^T) = sum_ij E_ij^2
    tr = jnp.zeros((10,), C.dtype)
    for i in range(3):
        for j in range(3):
            tr = tr + _poly2(C[i, j], C[i, j])

    eqs = []
    # det via cofactor expansion along row 0.
    m01 = _poly2(C[1, 1], C[2, 2]) - _poly2(C[1, 2], C[2, 1])
    m11 = _poly2(C[1, 0], C[2, 2]) - _poly2(C[1, 2], C[2, 0])
    m21 = _poly2(C[1, 0], C[2, 1]) - _poly2(C[1, 1], C[2, 0])
    det = _poly3(m01, C[0, 0]) - _poly3(m11, C[0, 1]) + _poly3(m21, C[0, 2])
    eqs.append(det)

    # (E E^T)_il = sum_k E_ik E_lk  (deg 2), then (E E^T E)_ij = sum_l (EE^T)_il E_lj
    EEt = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for l in range(3):
            acc = jnp.zeros((10,), C.dtype)
            for k in range(3):
                acc = acc + _poly2(C[i, k], C[l, k])
            EEt[i][l] = acc
    for i in range(3):
        for j in range(3):
            acc = jnp.zeros((20,), C.dtype)
            for l in range(3):
                acc = acc + _poly3(EEt[i][l], C[l, j])
            acc = 2.0 * acc - _poly3(tr, C[i, j])
            eqs.append(acc)
    return jnp.stack(eqs, axis=0)  # (10, 20)


def _action_matrix_coeffs(eq_coeffs):
    """(10, 20) cubic coeffs -> A_k stack (4, 10, 10): A(z) = sum_k A_k z^k."""
    # einsum over static scatter: (eq, mono) x (mono, col, zdeg) -> (zdeg, eq, col)
    return jnp.einsum("em,mcz->zec", eq_coeffs, _SCATTER_J)


def _det_poly(Az):
    """A_k (4, 10, 10) -> degree-10 monomial coeffs (11,) of det A(z).

    Batched slogdet at Chebyshev nodes, stabilized by subtracting the max
    log-magnitude (roots are scale-invariant), then the precomputed fit.
    """
    z = _Z_NODES.astype(Az.dtype)  # (N,)
    powers = jnp.stack([jnp.ones_like(z), z, z * z, z * z * z], axis=-1)  # (N, 4)
    A = jnp.einsum("nk,kij->nij", powers, Az)  # (N, 10, 10)
    sign, logabs = jnp.linalg.slogdet(A)
    logabs = jnp.nan_to_num(logabs, neginf=-100.0, posinf=100.0)
    vals = sign * jnp.exp(logabs - jnp.max(logabs))
    return _MONO_FIT.astype(Az.dtype) @ vals  # (11,)


# Exponent table of the 20 deg-3 monomials for the Gauss-Newton polish.
_M3_EXP = np.array(_M3, np.float32)  # (20, 3)
_M3_EXP_J = jnp.asarray(_M3_EXP)


def _monomials3(x, y, z):
    """(...,) x, y, z -> (..., 20) monomial vector over _M3."""
    v = jnp.stack([x, y, z], axis=-1)[..., None, :]  # (..., 1, 3)
    # x^ex y^ey z^ez with 0^0 = 1.
    base = jnp.where(_M3_EXP_J == 0, 1.0, v ** _M3_EXP_J)
    return jnp.prod(base, axis=-1)


def _monomials3_jac(x, y, z):
    """d(monomials)/d(x,y,z): (..., 20, 3)."""
    v = jnp.stack([x, y, z], axis=-1)[..., None, :]  # (..., 1, 3)
    e = _M3_EXP_J
    cols = []
    for k in range(3):
        ek = e.at[:, k].add(-1.0)
        ek = jnp.maximum(ek, 0.0)
        base = jnp.where(ek == 0, 1.0, v ** ek)
        cols.append(e[:, k] * jnp.prod(base, axis=-1))
    return jnp.stack(cols, axis=-1)


def _polish_xyz(eq, x, y, z, num_iters=3, damping=1e-10):
    """Gauss-Newton refinement of candidate roots on the 10 cubic constraints.

    The degree-10 resultant polynomial amplifies f32 coefficient noise by
    ~|z|^10, so Durand-Kerner roots carry O(1e-2) error; the original
    constraint coefficients `eq` (pure products of the nullspace basis) are
    accurate to ~1e-7, and a few GN steps against them recover that
    accuracy. Batched over the candidate axis.
    """

    def step(_, xyz):
        x, y, z = xyz
        F = eq @ _monomials3(x, y, z)[..., :, None]  # (..., 10, 1)
        Jm = _monomials3_jac(x, y, z)  # (..., 20, 3)
        J = eq @ Jm  # (..., 10, 3)
        JtJ = jnp.swapaxes(J, -1, -2) @ J + damping * jnp.eye(3, dtype=x.dtype)
        JtF = jnp.swapaxes(J, -1, -2) @ F
        delta = jnp.linalg.solve(JtJ, JtF)[..., 0]
        return (x - delta[..., 0], y - delta[..., 1], z - delta[..., 2])

    return jax.lax.fori_loop(0, num_iters, step, (x, y, z))


def _shift_z(p):
    """Multiply a z-polynomial (ascending coeffs) by z: prepend a zero."""
    return jnp.concatenate([jnp.zeros_like(p[..., :1]), p], axis=-1)


def _conv(p, q):
    """Product of two ascending-coefficient polynomials (static sizes)."""
    return jnp.convolve(p, q)


def solve_essential_5pt(points1, points2, num_dk_iters=60, imag_tol=1e-2):
    """5-point minimal solver. points1/2: (S>=5, 2) normalized coords.

    Returns (models (10, 3, 3), mask (10,)): up to 10 essential-matrix
    candidates with x2^T E x1 = 0, unit Frobenius norm; mask marks valid
    (real-root, finite) candidates. vmap over a leading trial axis for
    RANSAC.

    Follows Nister's elimination scheme (re-derived — the cubic constraint
    coefficients come from the generic monomial tables above rather than
    machine-generated code): Gauss-Jordan on the 10x20 system reduces the
    10 constraints to three z-polynomial equations B(z) [x, y, 1]^T = 0;
    det B(z) (an exact degree-10 polynomial assembled by convolution) is
    solved by batched Durand-Kerner, and each real root's nullvector gives
    a candidate E. Every step is a fixed-shape batched op (one 10x10 solve,
    static convolutions, 3x3 SVDs).
    """
    dtype = points1.dtype
    D = _epipolar_design(points1, points2)  # (S, 9)
    # Nullspace: right singular vectors of the 4 smallest singular values.
    # Full SVD of the 5x9 design (not eigh of D^T D, which squares the
    # condition number — decisive in f32).
    _, _, Vt = jnp.linalg.svd(D, full_matrices=True)
    basis = Vt[-4:].reshape(4, 3, 3)  # E1..E4

    # Linear-form coefficients: E_ij = sum_b basis[b, i, j] * var_b,
    # vars = (x, y, z, 1) with E4 as the inhomogeneous part.
    C = jnp.moveaxis(basis, 0, -1)  # (3, 3, 4)

    eq = _build_constraints(C)  # (10, 20)
    A1 = eq[:, _HIGH_IDX]  # (10, 10) high-monomial block
    A2 = eq[:, _LOW_IDX]  # (10, 10) low-monomial block
    X = jnp.linalg.solve(A1, A2)  # reduced tails: high_i + X[i] . low = 0

    def row_polys(i):
        """Tail of reduced row i as (a(z), b(z), c(z)) over (x, y, 1)."""
        r = X[i]
        a = jnp.stack([r[2], r[1], r[0]])        # x z^0, z^1, z^2 (ascending)
        b = jnp.stack([r[5], r[4], r[3]])
        c = jnp.stack([r[9], r[8], r[7], r[6]])  # 1, z, z^2, z^3
        return a, b, c

    ea, eb, ec = row_polys(_ROW_E)
    fa, fb, fc = row_polys(_ROW_F)
    ga, gb, gc = row_polys(_ROW_G)
    ha, hb, hc = row_polys(_ROW_H)
    ia, ib, ic = row_polys(_ROW_I)
    ja, jb, jc = row_polys(_ROW_J)

    def pad(p, n):
        return jnp.concatenate([p, jnp.zeros((n - p.shape[0],), dtype)])

    # <k> = <e> - z<f>, <l> = <g> - z<h>, <m> = <i> - z<j>: the x^2 z / x^2
    # (etc.) leading monomials cancel, leaving 3 equations linear in (x, y).
    B = []
    for (pa, pb, pc), (qa, qb, qc) in (((ea, eb, ec), (fa, fb, fc)),
                                       ((ga, gb, gc), (ha, hb, hc)),
                                       ((ia, ib, ic), (ja, jb, jc))):
        a = pad(pa, 4) - _shift_z(qa)           # deg <= 3
        b = pad(pb, 4) - _shift_z(qb)
        c = pad(pc, 5) - _shift_z(qc)           # deg <= 4
        B.append((a, b, c))
    (a1, b1, c1), (a2, b2, c2), (a3, b3, c3) = B

    # det B(z) by cofactor expansion — exact static convolutions, degree 10.
    p1 = _conv(b2, c3) - _conv(b3, c2)          # deg <= 7 (8 coeffs)
    p2 = _conv(a3, c2) - _conv(a2, c3)
    p3 = _conv(a2, b3) - _conv(a3, b2)          # deg <= 6 (7 coeffs)
    det_coeffs = _conv(a1, p1)[:11] + _conv(b1, p2)[:11] + pad(_conv(c1, p3), 11)

    from .polynomial import roots_durand_kerner

    roots_re, roots_im = roots_durand_kerner(det_coeffs, num_iters=num_dk_iters)
    mag = jnp.sqrt(roots_re**2 + roots_im**2)
    real_mask = jnp.abs(roots_im) <= imag_tol * jnp.maximum(mag, 1.0)
    z = roots_re.astype(dtype)  # (10,)

    # x, y for each root from the nullvector of the full hidden-variable
    # matrix A(z) over the 10 (x, y)-monomials [x^3, x^2 y, x y^2, y^3, x^2,
    # x y, y^2, x, y, 1]. The extraction is a degree-consistent ratio least
    # squares (x times lower-degree components ~ higher-degree components),
    # dominated by the LARGEST monomials — robust when |x|, |y| >> 1, where
    # reading m[x]/m[1] (tiny components) or an inhomogeneous B(z) solve
    # biases toward small (x, y) and strands the polish in a wrong basin.
    Az = _action_matrix_coeffs(eq)  # (4, 10, 10)
    zpow = jnp.stack([jnp.ones_like(z), z, z**2, z**3], axis=-1)  # (10, 4)
    A = jnp.einsum("rk,kij->rij", zpow, Az)  # (10, 10, 10) per root
    _, _, VtA = jnp.linalg.svd(A)
    m = VtA[..., -1, :]  # (10, 10) nullvectors over _XY_COLS monomials

    # x-ratios: x * [x^2, x, xy, y, y^2] = [x^3, x^2, x^2 y, x y, x y^2]
    x_den = jnp.stack([m[:, 4], m[:, 7], m[:, 5], m[:, 8], m[:, 6]], axis=-1)
    x_num = jnp.stack([m[:, 0], m[:, 4], m[:, 1], m[:, 5], m[:, 2]], axis=-1)
    x = jnp.sum(x_num * x_den, axis=-1) / jnp.maximum(
        jnp.sum(x_den * x_den, axis=-1), 1e-20
    )
    # y-ratios: y * [y^2, y, xy, x, x^2] = [y^3, y^2, x y^2, x y, x^2 y]
    y_den = jnp.stack([m[:, 6], m[:, 8], m[:, 5], m[:, 7], m[:, 4]], axis=-1)
    y_num = jnp.stack([m[:, 3], m[:, 6], m[:, 2], m[:, 5], m[:, 1]], axis=-1)
    y = jnp.sum(y_num * y_den, axis=-1) / jnp.maximum(
        jnp.sum(y_den * y_den, axis=-1), 1e-20
    )

    # Keep all candidates (even roots DK left with an imaginary part — the
    # polish below pulls near-real ones onto a real solution; genuinely
    # spurious candidates are eliminated by RANSAC scoring over all points).
    del real_mask
    ok = jnp.isfinite(x) & jnp.isfinite(y)

    # Polish all candidates against the original cubic system.
    x, y, z = _polish_xyz(eq, x, y, z, num_iters=8)
    ok = ok & jnp.isfinite(x) & jnp.isfinite(y) & jnp.isfinite(z)

    E = (
        x[:, None, None] * basis[0]
        + y[:, None, None] * basis[1]
        + z[:, None, None] * basis[2]
        + basis[3]
    )
    norm = jnp.linalg.norm(E.reshape(10, 9), axis=-1, keepdims=True)
    E = E / jnp.maximum(norm, 1e-20)[..., None]
    ok = ok & jnp.isfinite(E).all(axis=(1, 2))
    return E, ok


def solve_essential_8pt(points1, points2, weights=None):
    """Linear 8-point solver with rank-2 projection — the fast path.

    Returns ((1, 3, 3), (1,)). With >= 8 points the linear estimate followed
    by SVD projection onto the essential manifold is accurate and an order
    of magnitude cheaper than the 5-point resultant; useful as a RANSAC
    pre-pass and for non-minimal inlier refits (`weights` masks/weights the
    constraint rows — zeroing a ROW removes that correspondence, unlike
    zeroing its coordinates).
    """
    D = _epipolar_design(points1, points2)
    if weights is not None:
        D = D * weights[:, None]
    G = D.T @ D
    _, V = jnp.linalg.eigh(G)
    E = V[:, 0].reshape(3, 3)
    U, s, Vt = jnp.linalg.svd(E)
    sbar = (s[0] + s[1]) / 2.0
    E = U @ jnp.diag(jnp.stack([sbar, sbar, jnp.zeros_like(sbar)])) @ Vt
    E = E / jnp.maximum(jnp.linalg.norm(E), 1e-20)
    return E[None], jnp.isfinite(E).all()[None]


def sampson_residuals(points1, points2, E):
    """Signed first-order Sampson distance per correspondence (N,).

    Matches reference essential_matrix.cc:131-162; threshold on abs().
    """
    x1 = jnp.concatenate([points1, jnp.ones_like(points1[..., :1])], axis=-1)
    x2 = jnp.concatenate([points2, jnp.ones_like(points2[..., :1])], axis=-1)
    Ex1 = x1 @ E.T  # (N, 3)
    Etx2 = x2 @ E  # (N, 3)
    x2tEx1 = jnp.sum(x2 * Ex1, axis=-1)
    denom = jnp.sqrt(
        Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    )
    return x2tEx1 / jnp.maximum(denom, 1e-20)


def abs_sampson_residuals(points1, points2, E):
    return jnp.abs(sampson_residuals(points1, points2, E))


def decompose_essential_matrix(E):
    """E -> (R1, R2, t) candidate decomposition (reference :165-191)."""
    U, _, Vt = jnp.linalg.svd(E)
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return R1, R2, t


def pose_from_essential_matrix(E, points1, points2, inlier_mask, max_depth=100.0):
    """Cheirality test: pick (R, t) of the 4 candidates maximizing points with
    positive bounded depth in both views (reference :194-269).

    Returns (R (3,3), t (3,), num_good). First camera is [I | 0].
    """
    from .triangulation import triangulate_points
    from .projection import calc_depth

    R1, R2, t = decompose_essential_matrix(E)
    eye = jnp.eye(3, dtype=E.dtype)
    proj1 = jnp.concatenate([eye, jnp.zeros((3, 1), E.dtype)], axis=1)

    def count_good(R, tv):
        proj2 = jnp.concatenate([R, tv[:, None]], axis=1)
        X = triangulate_points(proj1, proj2, points1, points2)
        d1 = calc_depth(proj1, X)
        d2 = calc_depth(proj2, X)
        good = (
            (d1 > 0) & (d1 < max_depth) & (d2 > 0) & (d2 < max_depth) & inlier_mask
        )
        return jnp.sum(good), X

    cands = [(R1, t), (R2, t), (R1, -t), (R2, -t)]
    counts = []
    for R, tv in cands:
        n, _ = count_good(R, tv)
        counts.append(n)
    counts = jnp.stack(counts)
    best = jnp.argmax(counts)
    Rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    return Rs[best], ts[best], counts[best]
