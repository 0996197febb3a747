"""rpe_tpu_torch's 5-point solver against rpe_tpu on the CPU: constraint
coefficients, the plain version of K4 against the reference's XLA branch,
and the root contract against the reference's fused kernel in interpret
mode (tests/test_pallas_kernels.py:143-184)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpe_tpu.geometry import five_point as jfp
from rpe_tpu.ops.five_point_pallas import solve_roots_polished
from rpe_tpu_torch.geometry import five_point as tfp
from rpe_tpu_torch.utils.synthetic import rotation_from_axis_angle


def _minimal_problems(seed, b, noise=0.0):
    """b noise-free (or noisy) minimal problems: (b, 5, 2) point pairs."""
    g = np.random.default_rng(seed)
    p1s, p2s = [], []
    for _ in range(b):
        w = g.normal(size=3)
        R = rotation_from_axis_angle(
            w / np.linalg.norm(w) * np.deg2rad(g.uniform(2, 30)))
        t = g.normal(size=3)
        t /= np.linalg.norm(t)
        X = g.uniform([-2, -2, 3], [2, 2, 10], size=(5, 3))
        X2 = X @ R.T + t
        p1s.append((X / X[:, 2:3])[:, :2] + noise * g.normal(size=(5, 2)))
        p2s.append((X2 / X2[:, 2:3])[:, :2] + noise * g.normal(size=(5, 2)))
    return (np.stack(p1s).astype(np.float32), np.stack(p2s).astype(np.float32))


def _jax_coeffs(p1, p2):
    from rpe_tpu.geometry.epipolar import _build_epipolar_rows

    A = _build_epipolar_rows(jnp.asarray(p1), jnp.asarray(p2))
    c = jfp._build_constraint_coeffs(jfp._householder_null4(A))
    return np.asarray(c / jnp.sqrt(jnp.sum(c * c, -1, keepdims=True) + 1e-20))


def _residual_ok(c, x, y, r, flip):
    cc = c @ jfp._flip_table().astype(np.float64) if flip else c
    m = np.array([x ** a * y ** b * r ** k for (a, b, k) in jfp._M3])
    scale = max(1.0, abs(x), abs(y), abs(r)) ** 3
    return np.abs(cc @ m).max() < 2e-4 * scale


def _z(r, flip):
    return np.where(flip, 1.0 / np.where(np.abs(r) > 1e-12, r, 1.0), r)


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_five_point_plain_matches_reference_xla(noise):
    p1, p2 = _minimal_problems(1, 48, noise)
    _, c_t = tfp.constraint_coeffs(torch.from_numpy(p1), torch.from_numpy(p2))
    np.testing.assert_allclose(c_t.numpy(), _jax_coeffs(p1, p2), atol=2e-5)
    E_j, v_j = (np.asarray(a) for a in jfp.five_point_essential(
        jnp.asarray(p1), jnp.asarray(p2)))
    E_t, v_t = (a.numpy() for a in tfp.five_point_essential(
        torch.from_numpy(p1), torch.from_numpy(p2)))
    assert v_j.sum() >= 3 * len(p1)
    assert (v_j == v_t).mean() >= 0.99
    both = v_j & v_t
    a = E_j[both].reshape(-1, 9).astype(np.float64)
    b = E_t[both].reshape(-1, 9).astype(np.float64)
    b = b * np.sign((a * b).sum(-1, keepdims=True))
    close = np.abs(a - b).max(-1) < 1e-3
    assert close.mean() >= 0.98, close.mean()


def test_root_contract_against_fused_reference_kernel():
    """At B = 9 the reference kernel (interpret mode) finds roots that all
    solve the cubic system; the port's plain version finds the same roots
    (same z to polish tolerance), and every root it converges on is one of
    the kernel's."""
    p1, p2 = _minimal_problems(5, 9)
    c = _jax_coeffs(p1, p2)
    kx, ky, kr, kf, kh = (np.asarray(a, np.float64) for a in
                          solve_roots_polished(jnp.asarray(c),
                                               interpret=True))
    kf, kh = kf > 0.5, kh > 0.5
    px, py, pr, pf, ph = (a.numpy().astype(np.float64) for a in
                          tfp.solve_roots_plain(torch.from_numpy(c)))
    pf, ph = pf > 0.5, ph > 0.5
    c64 = c.astype(np.float64)
    zk, zp = _z(kr, kf), _z(pr, pf)
    n_k = 0
    for b, r in zip(*np.nonzero(kh)):
        assert _residual_ok(c64[b], kx[b, r], ky[b, r], kr[b, r], kf[b, r])
        assert np.abs(zk[b, r]) < 1.2e3
        tol = 1e-3 * max(1.0, abs(zk[b, r]))
        assert (ph[b] & (np.abs(zp[b] - zk[b, r]) <= tol)).any(), (b, r)
        n_k += 1
    assert n_k >= 3 * len(c)
    for b, r in zip(*np.nonzero(ph)):
        if _residual_ok(c64[b], px[b, r], py[b, r], pr[b, r], pf[b, r]):
            tol = 1e-3 * max(1.0, abs(zp[b, r]))
            assert (kh[b] & (np.abs(zk[b] - zp[b, r]) <= tol)).any(), (b, r)



def _grid_brackets(c):
    """The grid stage of `find_root_brackets_plain`, as it computes it:
    (t_lo, t_hi, det M at t_lo, has_root), each (B, MAX_ROOTS)."""
    from rpe_tpu_torch.ops.orb import top_k_stable

    b = c.shape[0]
    t = torch.from_numpy(tfp._tan_grid())
    d = tfp._detM_at(c[:, None], torch.tan(t).expand(b, tfp.GRID))
    change = (torch.sign(d[:, :-1]) * torch.sign(d[:, 1:])) < 0
    score = torch.where(change, -torch.arange(tfp.GRID - 1,
                                              dtype=torch.float32), -torch.inf)
    _, idx = top_k_stable(score, tfp.MAX_ROOTS)
    return t[idx], t[idx + 1], torch.gather(d, -1, idx), \
        torch.gather(change, -1, idx)


def _bisect_tree(c, lo, hi, d_lo, has, levels=None):
    """The kernel's bisection rounds in float32: per hypothesis and round,
    2^L - 1 lanes per bracket evaluate the nodes of an L-level tree (heap
    order; each node's midpoint from the 0.5 * (a + b) sequence that
    reaches it), then each bracket walks the tree with the nodes' signs. L
    as the kernel picks it from the bracket count, or `levels` for every
    round. Signs as `find_root_brackets_plain` takes them (det M of the
    (B, MAX_ROOTS) midpoints, one call per node index)."""
    n = has.sum(-1)
    L0 = (torch.full_like(n, levels) if levels else torch.where(
        n == 1, 5, torch.where(n == 2, 4, torch.where(n <= 4, 3, 2))))
    sa = torch.sign(d_lo)
    done = torch.zeros_like(n)
    while bool((has.any(-1) & (done < tfp.BISECT_ITERS)).any()):
        L = torch.minimum(L0, tfp.BISECT_ITERS - done)[:, None]
        sign = torch.zeros((32,) + lo.shape)
        for node in range(1, 32):
            a, b = lo.clone(), hi.clone()
            for lv in range(node.bit_length() - 2, -1, -1):
                m = 0.5 * (a + b)
                a, b = ((m, b) if (node >> lv) & 1 else (a, m))
            sign[node] = torch.sign(tfp._detM_at(c[:, None],
                                                 torch.tan(0.5 * (a + b))))
        at = torch.ones_like(lo, dtype=torch.int64)
        for lv in range(5):
            go = has & (lv < L)
            m = 0.5 * (lo + hi)
            s = torch.gather(sign, 0, at[None])[0]
            same = s * sa >= 0
            lo = torch.where(go & same, m, lo)
            sa = torch.where(go & same, s, sa)
            hi = torch.where(go & ~same, m, hi)
            at = torch.where(same, 2 * at + 1, 2 * at).clamp(max=31)
        done = done + L[:, 0]
    return torch.where(has, lo, 0.0), torch.where(has, hi, 0.0)


@pytest.mark.parametrize("seed,b", [(5, 9), (11, 256)],
                         ids=["reference-9", "seeded-256"])
def test_bisection_tree_gives_the_sequential_endpoints(seed, b):
    """K4/K5 bisect L levels per round (csrc/five_point_roots.cu): the
    nodes of an L-level tree are evaluated together and the bracket then
    walks it. In float32, with the signs `find_root_brackets_plain` sees,
    that gives exactly its sequential endpoints, for the kernel's choice of
    L and for every L from 1 to 5."""
    p1, p2 = _minimal_problems(seed, b)
    _, c = tfp.constraint_coeffs(torch.from_numpy(p1), torch.from_numpy(p2))
    lo, hi, has = tfp.find_root_brackets_plain(c)
    assert int(has.sum()) >= 3 * b
    grid = _grid_brackets(c)
    assert torch.equal(grid[3], has)
    for levels in (None, 1, 2, 3, 4, 5):
        tlo, thi = _bisect_tree(c, *grid, levels)
        assert torch.equal(tlo, lo) and torch.equal(thi, hi), levels
