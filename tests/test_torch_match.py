"""rpe_tpu_torch matching against rpe_tpu on the CPU: the Hamming and
squared-L2 distance matrices, cross-check and Lowe-ratio selection with
ties, and the plain versions of K3 (Hamming mutual nearest neighbours), K7
(L2 mutual nearest neighbours) and K6 (row top-2, both norms) against the
reference's XLA formulation and its fused kernels in interpret mode.

Hamming results are exact and held bit for bit. L2 results agree up to
float32 reassociation of the dot products, so a match may resolve to the
other side of a near-tie: such rows are counted and each must be a tie
within 1e-5 in the reference's own distances. The L2 kernels' split-TF32
products, which cannot run here, are emulated (`_tf32_gram`) and held to
that contract too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpe_tpu.ops import match as jmatch
from rpe_tpu.ops import match_pallas as jfused
from rpe_tpu.ops.match_pallas import mutual_nn_hamming as j_mutual_nn
from rpe_tpu_torch.ops import match as tmatch
from rpe_tpu_torch.utils.synthetic import float_descriptors

_BIG = 3.0e38


def _descriptors(seed, n1, n2, flip=0.1, few_bits=False):
    """{0,1} descriptors; few_bits=True draws from 8 live bits so Hamming
    distances tie constantly (the lowest-index tie rule decides)."""
    g = np.random.default_rng(seed)
    d = 8 if few_bits else 256
    b1 = np.zeros((n1, 256), np.uint8)
    b1[:, :d] = g.uniform(size=(n1, d)) < 0.5
    b2 = np.zeros((n2, 256), np.uint8)
    src = b1[g.integers(0, n1, n2)]
    b2[:] = np.where(g.uniform(size=src.shape) < flip, 1 - src, src)
    b2[:, d:] = 0
    v1 = g.uniform(size=n1) < 0.9
    v2 = g.uniform(size=n2) < 0.9
    return b1, b2, v1, v2


@pytest.mark.parametrize("few_bits", [False, True])
def test_hamming_matrix_and_cross_check_identical(few_bits):
    b1, b2, v1, v2 = _descriptors(1 + few_bits, 256, 384, few_bits=few_bits)
    D_j = np.asarray(jmatch.hamming_distance_matrix(jnp.asarray(b1),
                                                    jnp.asarray(b2)))
    D_t = tmatch.hamming_distance_matrix(torch.from_numpy(b1),
                                         torch.from_numpy(b2))
    np.testing.assert_array_equal(D_j, D_t.numpy())
    ref = jmatch.cross_check_match(jnp.asarray(D_j), jnp.asarray(v1),
                                   jnp.asarray(v2), max_matches=128)
    got = tmatch.cross_check_match(torch.from_numpy(D_j.copy()),
                                   torch.from_numpy(v1), torch.from_numpy(v2),
                                   max_matches=128)
    for k in ("idx1", "idx2", "dist", "valid"):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy(),
                                      err_msg=k)
    # the batched K3 path (plain on CPU) + selection gives the same matches
    m = tmatch.match_hamming(torch.from_numpy(b1[None]),
                             torch.from_numpy(b2[None]),
                             torch.from_numpy(v1[None]),
                             torch.from_numpy(v2[None]), max_matches=128)
    for k in ("idx1", "idx2", "dist", "valid"):
        np.testing.assert_array_equal(np.asarray(ref[k]), m[k][0].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("case", ["ties", "all_invalid_cols"])
def test_mutual_nn_plain_matches_fused_reference(case):
    """K3's plain version against the reference's fused matcher (its TPU
    kernel in interpret mode): identical best_d, nn12, nn21, including
    the canonical outputs of invalid rows and columns."""
    b1, b2, v1, v2 = _descriptors(7, 256, 256, few_bits=case == "ties")
    if case == "all_invalid_cols":
        v2[:] = False
        v1[:5] = False
    ref = [np.asarray(a) for a in j_mutual_nn(
        jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(v1), jnp.asarray(v2),
        interpret=True)]
    got = tmatch.mutual_nn_hamming(
        torch.from_numpy(b1[None]), torch.from_numpy(b2[None]),
        torch.from_numpy(v1[None]), torch.from_numpy(v2[None]))
    for name, a, b in zip(("best_d", "nn12", "nn21"), ref, got):
        np.testing.assert_array_equal(a, b[0].numpy(), err_msg=name)
    assert got[1].dtype == torch.int32 and got[0].dtype == torch.float32


def _float_descriptors(seed, n1, n2, dup=False):
    """One pair of SIFT-like descriptor sets (utils/synthetic.py)."""
    return [a[0] for a in float_descriptors(seed, n1, n2, dup=dup)]


def _t(*arrays, pair=True):
    return [torch.from_numpy(a[None] if pair else a) for a in arrays]


def _assert_same_up_to_near_ties(ref, got, D, tol=tmatch.NEAR_TIE_TOL):
    """Equal match sets, except rows whose two candidate partners are within
    tol of each other in the reference's distance matrix D. Returns the
    number of such rows."""
    def pairs(m):
        return {int(i): int(j) for i, j, v in
                zip(np.asarray(m["idx1"]).reshape(-1),
                    np.asarray(m["idx2"]).reshape(-1),
                    np.asarray(m["valid"]).reshape(-1)) if v}
    r, g = pairs(ref), pairs(got)
    diff = [i for i in r.keys() | g.keys() if r.get(i) != g.get(i)]
    for i in diff:
        cands = [j for j in (r.get(i), g.get(i)) if j is not None]
        best = D[i].min()
        assert all(D[i, j] - best <= tol for j in cands), (i, cands)
    assert len(diff) <= max(2, len(r) // 50), diff
    return len(diff)


@pytest.mark.parametrize("dup", [False, True])
def test_l2_matrix_and_cross_check(dup):
    d1, d2, v1, v2 = _float_descriptors(3 + dup, 256, 320, dup=dup)
    D_j = np.asarray(jmatch.l2sq_distance_matrix(jnp.asarray(d1),
                                                 jnp.asarray(d2)))
    D_t = tmatch.l2sq_distance_matrix(*_t(d1, d2, pair=False)).numpy()
    assert D_t.min() >= 0.0
    np.testing.assert_allclose(D_t, D_j, atol=1e-5, rtol=0)
    ref = jmatch.cross_check_match(jnp.asarray(D_j), jnp.asarray(v1),
                                   jnp.asarray(v2), max_matches=128)
    same = tmatch.cross_check_match(*_t(D_j.copy(), v1, v2, pair=False),
                                    max_matches=128)
    for k in ("idx1", "idx2", "dist", "valid"):
        np.testing.assert_array_equal(np.asarray(ref[k]), same[k].numpy(),
                                      err_msg=k)
    # K7's plain version + selection, from the descriptors
    got = tmatch.match_l2(*_t(d1, d2, v1, v2), max_matches=128)
    assert int(np.asarray(ref["valid"]).sum()) > 100
    _assert_same_up_to_near_ties(ref, {k: v[0] for k, v in got.items()},
                                 np.where(v2[None], D_j, _BIG))


@pytest.mark.parametrize("few_bits", [False, True])
def test_ratio_hamming_identical(few_bits):
    b1, b2, v1, v2 = _descriptors(11 + few_bits, 256, 384, flip=0.08,
                                  few_bits=few_bits)
    D = np.asarray(jmatch.hamming_distance_matrix(jnp.asarray(b1),
                                                  jnp.asarray(b2)))
    ref = jmatch.ratio_test_match(jnp.asarray(D), jnp.asarray(v1),
                                  jnp.asarray(v2), ratio=0.75,
                                  max_matches=128)
    same = tmatch.ratio_test_match(*_t(D.copy(), v1, v2, pair=False),
                                   ratio=0.75, max_matches=128)
    got = tmatch.match_ratio(*_t(b1, b2, v1, v2), ratio=0.75,
                             max_matches=128, norm="hamming")
    assert int(np.asarray(ref["valid"]).sum()) > (0 if few_bits else 50)
    for k in ("idx1", "idx2", "dist", "valid"):
        np.testing.assert_array_equal(np.asarray(ref[k]), same[k].numpy(),
                                      err_msg=k)
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k][0].numpy(),
                                      err_msg=k)


def test_ratio_l2_sets():
    d1, d2, v1, v2 = _float_descriptors(13, 256, 256)
    D = np.asarray(jmatch.l2sq_distance_matrix(jnp.asarray(d1),
                                               jnp.asarray(d2)))
    ref = jmatch.ratio_test_match(jnp.asarray(D), jnp.asarray(v1),
                                  jnp.asarray(v2), ratio=0.8 ** 2,
                                  max_matches=128)
    got = tmatch.match_ratio(*_t(d1, d2, v1, v2), ratio=0.8 ** 2,
                             max_matches=128, norm="l2")
    assert int(np.asarray(ref["valid"]).sum()) > 50
    _assert_same_up_to_near_ties(ref, {k: v[0] for k, v in got.items()},
                                 np.where(v2[None], D, _BIG))
    m = np.asarray(ref["valid"])
    np.testing.assert_allclose(got["dist"][0].numpy()[m],
                               np.asarray(ref["dist"])[m], atol=1e-5)


@pytest.mark.parametrize("case", ["l2_cross", "l2_ratio", "hamming_ratio"])
def test_plain_versions_match_fused_reference(case):
    """K7's and K6's plain versions (+ selection) against the reference's
    fused matchers, their TPU kernels run in interpret mode."""
    if case == "hamming_ratio":
        d1, d2, v1, v2 = _descriptors(21, 256, 384, flip=0.08)
    else:
        d1, d2, v1, v2 = _float_descriptors(22, 256, 384)
    args = [jnp.asarray(a) for a in (d1, d2, v1, v2)]
    if case == "l2_cross":
        ref = jfused.cross_check_match_fused(*args, max_matches=128,
                                             norm="l2", interpret=True)
        got = tmatch.match_l2(*_t(d1, d2, v1, v2), max_matches=128)
        pieces = jfused.mutual_nn_l2sq(*args, interpret=True)
        mine = tmatch.mutual_nn_l2(*_t(d1, d2, v1, v2))
        np.testing.assert_allclose(mine[0][0].numpy(), np.asarray(pieces[0]),
                                   atol=1e-5, rtol=0)
        D = torch.from_numpy(np.array(jmatch.l2sq_distance_matrix(
            args[0], args[1])))[None]
        D = torch.where(torch.from_numpy(v1[:, None] & v2[None])[None], D,
                        torch.tensor(_BIG))
        for dim, idx, v in ((-1, 1, v1), (-2, 2, v2)):
            m = tmatch.argmin_mismatches(
                D, mine[idx], torch.from_numpy(np.array(pieces[idx]))[None],
                torch.from_numpy(v)[None], dim)
            print(f"nn{idx}{3 - idx}: {m[0]} of {m[1]} differ, largest gap "
                  f"{m[2]:.3e}")
            assert tmatch.near_tie_ok(m), m
    else:
        norm = case.split("_")[0]
        ratio = 0.75 if norm == "hamming" else 0.8 ** 2
        ref = jfused.ratio_match_fused(*args, ratio=ratio, max_matches=128,
                                       norm=norm, interpret=True)
        got = tmatch.match_ratio(*_t(d1, d2, v1, v2), ratio=ratio,
                                 max_matches=128, norm=norm)
    assert int(np.asarray(ref["valid"]).sum()) > 50
    got = {k: v[0].numpy() for k, v in got.items()}
    if case == "hamming_ratio":
        for k in ("idx1", "idx2", "dist", "valid"):
            np.testing.assert_array_equal(np.asarray(ref[k]), got[k],
                                          err_msg=k)
    else:
        D = np.asarray(jmatch.l2sq_distance_matrix(args[0], args[1]))
        _assert_same_up_to_near_ties(ref, got, np.where(v2[None], D, _BIG))


@pytest.mark.parametrize("norm", ["hamming", "l2"])
def test_row_top2_ties_and_dead_rows(norm):
    """K6's plain version: the second best is the minimum over every other
    column, so a best tied at another index gives d2 == d1 and the lowest
    index; invalid rows and rows without valid columns give (_BIG, 0,
    _BIG); a single valid column leaves d2 = _BIG."""
    if norm == "hamming":
        d2 = np.zeros((5, 256), np.uint8)
        d2[:, :5] = np.eye(5, dtype=np.uint8)
        d2[3] = d2[1]                                 # column 3 ties column 1
        d1 = d2[[1, 0, 2, 4]].copy()
    else:
        d2 = np.eye(5, 128, dtype=np.float32)
        d2[3] = d2[1]
        d1 = d2[[1, 0, 2, 4]].copy()
    v1 = np.array([True, False, True, True])
    v2 = np.array([True, True, True, True, False])
    d_1, a_1, d_2 = (x[0].numpy() for x in tmatch.row_top2(
        *_t(d1, d2, v1, v2), norm=norm))
    assert a_1.dtype == np.int32
    assert a_1[0] == 1 and d_1[0] == d_2[0] == 0.0      # tie: d2 == d1
    assert (d_1[1], a_1[1], d_2[1]) == (_BIG, 0, np.float32(_BIG))
    assert a_1[2] == 2 and d_1[2] == 0.0 and d_2[2] > 0.0
    # row 3's own column is invalid: best among the others
    assert d_1[3] > 0.0 and a_1[3] == 0 and d_2[3] == d_1[3]
    v2[:] = False
    v2[2] = True
    d_1, a_1, d_2 = (x[0].numpy() for x in tmatch.row_top2(
        *_t(d1, d2, v1, v2), norm=norm))
    assert (a_1[v1] == 2).all() and (d_2[v1] == np.float32(_BIG)).all()
    v2[:] = False
    d_1, a_1, d_2 = (x[0].numpy() for x in tmatch.row_top2(
        *_t(d1, d2, v1, v2), norm=norm))
    assert (d_1 == np.float32(_BIG)).all() and not a_1.any()
    assert (d_2 == np.float32(_BIG)).all()


def test_near_tie_contract():
    """argmin_mismatches counts index differences where valid and reports
    the largest gap between the two candidates' distances; near_tie_ok
    holds that to the float kernels' contract."""
    D = torch.tensor([[[0.0, 5e-6, 1.0],
                       [2.0, 0.5, 0.5],
                       [0.3, 0.9, 0.1]]])
    want = torch.tensor([[0, 1, 2]])
    valid = torch.tensor([[True, True, True]])
    same = tmatch.argmin_mismatches(D, want, want, valid, -1)
    assert same == (0, 3, 0.0) and tmatch.near_tie_ok(same)
    tie = tmatch.argmin_mismatches(D, torch.tensor([[1, 2, 2]]), want,
                                   valid, -1)
    assert tie[:2] == (2, 3) and abs(tie[2] - 5e-6) < 1e-9
    assert tmatch.near_tie_ok(tie, frac=1.0)
    assert not tmatch.near_tie_ok(tie)                 # 2 of 3 rows differ
    far = tmatch.argmin_mismatches(D, torch.tensor([[0, 1, 0]]), want,
                                   valid, -1)
    assert not tmatch.near_tie_ok(far, frac=1.0)       # gap 0.2 > 1e-5
    masked = tmatch.argmin_mismatches(D, torch.tensor([[0, 1, 0]]), want,
                                      torch.tensor([[True, True, False]]), -1)
    assert masked == (0, 2, 0.0)
    cols = tmatch.argmin_mismatches(D, torch.tensor([[0, 1, 1]]),
                                    torch.tensor([[0, 1, 2]]), valid, -2)
    assert cols[0] == 1 and abs(cols[2] - 0.4) < 1e-6


def test_hamming_kernels_refuse_wide_indices():
    """K3/K6-Hamming keep an index in 21 bits of a 32-bit key: a side of
    2^21 descriptors or more is refused before any launch, anything below
    passes."""
    n = tmatch.HAMMING_MAX_N
    assert n == 1 << 21
    for n1, n2 in ((n - 1, 4), (4, n - 1), (0, 0)):
        tmatch.check_hamming_n("k", n1, n2)
    for n1, n2 in ((n, 4), (4, n)):
        with pytest.raises(ValueError, match="k: at most 2097151"):
            tmatch.check_hamming_n("k", n1, n2)


def test_l2_kernels_refuse_wide_shapes():
    """K7/K6-L2 index slots with 32-bit ints and put the pair on the grid's
    y axis: more than 65535 pairs, or 2^31 slots or more on a side over all
    pairs, is refused before any launch; anything below passes."""
    assert tmatch.L2_MAX_PAIRS == 65535 and tmatch.L2_MAX_SLOTS == 2**31 - 1
    for p, n1, n2 in ((65535, 4, 4), (1, 2**31 - 1, 4), (2, 4, 2**30 - 1),
                      (0, 0, 0)):
        tmatch.check_l2_shape("k", p, n1, n2)
    for p, n1, n2 in ((65536, 4, 4), (2, 2**30, 4), (1, 4, 2**31)):
        with pytest.raises(ValueError, match="k: at most 65535 pairs"):
            tmatch.check_l2_shape("k", p, n1, n2)


def _tf32(x, rounded=True):
    """float32 -> TF32 values held in float32: round to nearest, ties away
    from zero (`cvt.rna.tf32.f32`), or the tensor cores' own reading of an
    operand, which drops its low 13 bits."""
    u = x.contiguous().view(torch.int32)
    if rounded:
        u = u + 0x1000
    return (u & -0x2000).view(torch.float32)


def _add_rz(acc, part):
    """float32 acc + part (float64), rounded toward zero: how the tensor
    cores round each k-step's sum (measured on the card)."""
    t = acc.double() + part
    r = t.float()
    return torch.where(r.double().abs() > t.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def _tf32_gram(a, b, split):
    """a (N1, 128) . b (N2, 128)^T as csrc/match_l2.cu computes it: each
    operand read as the tensor cores read it (low 13 bits dropped); per
    32-dimension stage, 8-dimension k-steps (exact products) summed in
    float32 with truncation, cross products first; each stage's sum added
    to the float32 result with rounding to nearest. split=True: the
    kernel's hi + lo split of both operands (both parts rounded to nearest)
    and hi.lo + lo.hi + hi.hi; split=False: one product of the rounded
    operands (plain TF32)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if split:
        prods = [(a_hi, _tf32(b - b_hi)), (_tf32(a - a_hi), b_hi),
                 (a_hi, b_hi)]
    else:
        prods = [(a_hi, b_hi)]
    dot = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 32):
        acc = torch.zeros_like(dot)
        for x, y in prods:
            for k in range(k0, k0 + 32, 8):
                acc = _add_rz(acc, _tf32(x[:, k:k + 8], False).double()
                              @ _tf32(y[:, k:k + 8], False).double().T)
        dot = dot + acc
    return dot


@pytest.mark.parametrize("split", [True, False], ids=["tf32x3", "tf32x1"])
def test_split_tf32_products_hold_the_l2_contract(split):
    """K7's and K6-L2's products emulated on the CPU (`_tf32_gram`), with
    the kernel's norms (float64 sums rounded once) and distance
    max((|a|^2 + |b|^2) - 2 a.b, 0), against their plain versions on
    SIFT-like unit-norm descriptors with duplicates: the 3xTF32 split holds
    the contract (index differences only on near-ties within 1e-5,
    distances within 1e-5); one TF32 product breaks it."""
    d1, d2, v1, v2 = (torch.from_numpy(a) for a in float_descriptors(
        31, 384, 512, pairs=2, dup=True))

    def sq(x):
        return (x.double() ** 2).sum(-1).float()

    D_emu = torch.stack([torch.clamp_min(
        (sq(a)[:, None] + sq(b)[None, :]) - 2.0 * _tf32_gram(a, b, split),
        0.0) for a, b in zip(d1, d2)])
    D = torch.where(v1[..., :, None] & v2[..., None, :],
                    tmatch.l2sq_distance_matrix(d1, d2), torch.tensor(_BIG))
    got = tmatch.mutual_nn_from_matrix(D_emu, v1, v2)
    want = tmatch.mutual_nn_l2_plain(d1, d2, v1, v2)
    top2 = tmatch.row_top2_from_matrix(D_emu, v1, v2)
    top2_want = tmatch.row_top2_plain(d1, d2, v1, v2, norm="l2")
    err = max(float((got[0] - want[0])[v1].abs().max()),
              float((top2[2] - top2_want[2])[v1].abs().max()))
    ok = [tmatch.near_tie_ok(tmatch.argmin_mismatches(D, got[1], want[1],
                                                      v1, -1)),
          tmatch.near_tie_ok(tmatch.argmin_mismatches(D, got[2], want[2],
                                                      v2, -2)),
          tmatch.near_tie_ok(tmatch.argmin_mismatches(D, top2[1],
                                                      top2_want[1], v1, -1))]
    print(f"split={split}: distance error {err:.3e}, index contract {ok}")
    if split:
        assert err <= tmatch.NEAR_TIE_TOL and all(ok)
    else:
        assert err > tmatch.NEAR_TIE_TOL
