"""rpe_tpu_torch.rng against jax.random on the seeds and draws the VP slice
needs: PRNGKey on any Python int (JAX takes it modulo 2^32), randint
bit-equal to `jax.random.randint` on keys split from PRNGKey(uint32 seed)
as rpe_tpu/geometry/vp_refine.py:404-408 draws them, and the pair keys of a
BatchProcessor whose seed + pair index passes 2^31 equal to the reference's
(rpe_tpu/pipeline/batch.py:151-152)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpe_tpu_torch import convert, rng
from rpe_tpu_torch.pipeline import batch as tbatch

SEEDS = [2 ** 31, 2 ** 32 - 1, 2 ** 32 + 3, -1, 0, 2 ** 31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_takes_any_int_as_jax_does(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    np.testing.assert_array_equal(rng.PRNGKey(seed).numpy(), want)
    np.testing.assert_array_equal(
        rng.split(rng.PRNGKey(seed)).numpy(),
        np.asarray(jax.random.split(jax.random.PRNGKey(seed))).astype(
            np.int64))


# (shape, minval, maxval): the VP sampler's (3000,) draws over 2..120 live
# lines, and spans past 2^16 where JAX's multiplier wraps in uint32
RANDINT_CASES = [((3000,), 0, 2), ((3000,), 0, 3), ((3000,), 0, 77),
                 ((3000,), 0, 120), ((7, 5), -4, 9), ((64,), 0, 1),
                 ((64,), 5, 5), ((256,), 0, 70000), ((256,), 0, 2 ** 31 - 1),
                 ((256,), -(2 ** 31), 2 ** 31 - 1)]


@pytest.mark.parametrize("shape,lo,hi", RANDINT_CASES)
@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 + 5])
def test_randint_bit_equal(seed, shape, lo, hi):
    key = jax.random.PRNGKey(jnp.asarray(seed % 2 ** 32, jnp.uint32))
    ka, kb = jax.random.split(key)
    kt = rng.split(rng.PRNGKey(seed))
    for kj, k in ((ka, kt[0]), (kb, kt[1])):
        want = np.asarray(jax.random.randint(kj, shape, lo, jnp.int32(hi)))
        got = rng.randint(k, shape, lo, hi)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_randint_batched_keys_with_bound_per_key():
    """The VP device twin's call: one key and one traced maxval per frame
    (vmapped in the reference)."""
    seeds = jnp.arange(8, dtype=jnp.uint32)
    hi = jnp.asarray([2, 3, 77, 120, 119, 10, 2, 100], jnp.int32)

    def draw(s, m):
        ka, _ = jax.random.split(jax.random.PRNGKey(s))
        return jax.random.randint(ka, (3000,), 0, m)

    want = np.asarray(jax.vmap(draw)(seeds, hi))
    keys = torch.stack([rng.PRNGKey(s) for s in range(8)])
    got = rng.randint(rng.split(keys)[:, 0], (3000,), 0,
                      torch.as_tensor(np.array(hi), dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_batch_processor_keys_past_int32(monkeypatch, tmp_path):
    """seed = 2^31 - 1 over two pairs: the second pair's key is
    PRNGKey(2^31), which the port refused before; the keys equal the
    reference's PRNGKey over the uint32 seeds."""
    from rpe_tpu_torch.pipeline.estimator import PoseEstimator

    seed = 2 ** 31 - 1
    seen = {}

    def capture(imgs, K, keys, cfg, device=None):
        seen["keys"] = keys.cpu()
        n = keys.shape[0]
        return {"R": torch.eye(3).expand(n, 3, 3), "t": torch.zeros(n, 3),
                "valid": torch.ones(n, dtype=torch.bool),
                "num_matches": torch.full((n,), 100),
                "num_inliers": torch.full((n,), 100)}

    monkeypatch.setattr(tbatch, "estimate_sequence_batched", capture)
    proc = tbatch.BatchProcessor(
        tmp_path, PoseEstimator(np.eye(3), device="cpu"), None, chunk=2,
        seed=seed)
    frames = np.zeros((3, 8, 8), np.float32)
    proc.estimate_relative_poses([0, 1, 2], frames)
    want = jax.vmap(jax.random.PRNGKey)(
        jnp.asarray([seed + s for s in range(2)], dtype=jnp.uint32))
    np.testing.assert_array_equal(seen["keys"].numpy(),
                                  convert.keys_from_numpy(
                                      np.asarray(want)).numpy())
    assert seen["keys"][1].tolist() == [0, 2 ** 31]
